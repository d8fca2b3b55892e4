"""Batched array union-find: the wrappers of the port's CUDA union kernel.

Port of ``gelly_streaming_tpu/ops/unionfind.py``.  A summary is a dense ``parent: int32[C]``
forest, ``parent[r] == r`` marking a root; a batch of edges merges the
components of its endpoints and compresses, so that every vertex points at
its root.  The fixed point is the JAX package's: a merged component ends
at the smallest of the roots it came in with (after ``init_parent`` and
unions, its smallest vertex id), and every vertex points at it.

Unlike the JAX functions, these update ``parent`` (and ``seen``) IN PLACE
and return the same tensors: a caller that keeps an old state clones it
first.  On CUDA tensors ``union_edges``, ``union_edges_with_seen``,
``merge_parents`` and ``compress`` are one C call each
(``csrc/unionfind.cu: uf_union_launch``: the compress pass unless the
state is known flat, then the union kernel, which first runs the doubling
rounds where the pass left a node short of its root, or for an empty batch
the compress rounds kernel; each runs its rounds on the device with no host
sync); the parity union of the bipartiteness check on the
doubled space ``parent2: int32[2C]`` is ``uf_parity_union_launch``, the
same kernels with the doubled edges formed inside the union kernel.
``LAUNCHES`` counts the calls that ran each kernel (``compress_kernel``:
the pass and its rounds).  On CPU
tensors they run the plain twins (``*_plain``): the JAX algorithm written
as PyTorch ops (scatter-min hooks, ``p = p[p]`` doubling, a host loop
until converged), which return new tensors and never launch anything.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import _cuda, indexing

_SOURCE = "unionfind.cu"
_MAX_INT32 = (1 << 31) - 1

# kernel launches made by uf_union_launch since the last reset_launches()
# (only calls on CUDA tensors count, never the plain twins)
LAUNCHES: Dict[str, int] = {"union_kernel": 0, "compress_kernel": 0, "parity_union_kernel": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def init_parent(capacity: int, device: DeviceLike = None) -> torch.Tensor:
    """Every vertex its own singleton root."""
    return torch.arange(capacity, dtype=torch.int32, device=resolve_device(device))


# ---------------------------------------------------------------------------
# plain twins (the JAX algorithm; new tensors out, inputs untouched)


def compress_plain(parent: torch.Tensor) -> torch.Tensor:
    """Pointer doubling ``p = p[p]`` until no entry changes."""
    p = parent
    while True:
        p2 = p[p.long()]
        if torch.equal(p2, p):
            return p2
        p = p2


def union_edges_plain(
    parent: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Until every edge's endpoints share a root: hook each larger endpoint
    root under the smallest root it meets (scatter-min), then compress.
    Masked rows become (0, 0) self-loops; an id outside [0, C) reads the
    entry JAX's gather reads (below 0 counts from the end, then clamps)."""
    if mask is not None:
        src = torch.where(mask, src, 0)
        dst = torch.where(mask, dst, 0)
    s, d = indexing.gather_index(src, parent.shape[0]), indexing.gather_index(dst, parent.shape[0])
    p = compress_plain(parent)
    while True:
        rs, rd = p[s], p[d]
        if torch.equal(rs, rd):
            return p
        lo = torch.minimum(rs, rd)
        hi = torch.maximum(rs, rd)
        p = compress_plain(p.scatter_reduce(0, hi.long(), lo, "amin"))


def merge_parents_plain(parent_a: torch.Tensor, parent_b: torch.Tensor) -> torch.Tensor:
    """b's pointers as edges (v, parent_b[v]) applied to a."""
    v = torch.arange(parent_a.shape[0], dtype=torch.int32, device=parent_a.device)
    return union_edges_plain(parent_a, v, parent_b)


def _mark_seen(seen, src, dst, mask) -> torch.Tensor:
    """A new seen vector: every valid endpoint marked by JAX's scatter
    rule (below 0 counts from the end, past the end is dropped)."""
    live = slice(None) if mask is None else mask
    seen = indexing.scatter_true_(seen.clone(), src[live])
    return indexing.scatter_true_(seen, dst[live])


def union_edges_with_seen_plain(
    parent: torch.Tensor,
    seen: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    p = union_edges_plain(parent, src, dst, mask)
    return p, _mark_seen(seen, src, dst, mask)


# ---------------------------------------------------------------------------
# wrappers: the kernel on CUDA tensors, the twin on CPU tensors


def _check_vector(t: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")


def _check_args(parent, seen, src, dst, mask) -> None:
    _check_vector(parent, torch.int32, "parent")
    if parent.shape[0] > _MAX_INT32:
        raise ValueError("capacity must fit int32")
    if seen is not None:
        _check_vector(seen, torch.bool, "seen")
        if seen.shape != parent.shape:
            raise ValueError("seen and parent must have the same shape")
    _check_vector(dst, torch.int32, "dst")
    if dst.shape[0] > _MAX_INT32:
        raise ValueError("an edge batch must hold fewer than 2^31 edges")
    for t, name in ((src, "src"), (mask, "mask")):
        if t is not None:
            _check_vector(t, torch.bool if name == "mask" else torch.int32, name)
            if t.shape != dst.shape:
                raise ValueError(f"{name} and dst must have the same shape")
    for t in (seen, src, dst, mask):
        if t is not None and t.device != parent.device:
            raise ValueError("all tensors must be on parent's device")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


# The flat-state flag: a union call leaves ``parent`` flat, and the wrapper
# records the tensor's version counter on it.  PyTorch bumps that counter on
# every in-place write through any view (``copy_``, indexing, ``add_``), so a
# tensor whose counter still matches was written by nothing but this
# module's kernels since, and is flat: its call skips the compress kernel.
# A new tensor (``init_parent``, a clone, a caller's own) has no mark and is
# compressed first.
_FLAT_MARK = "_uf_flat_version"

# the scratch of the last CUDA call, whose header holds its round counts
_last_scratch: Optional[torch.Tensor] = None


def _known_flat(parent: torch.Tensor) -> bool:
    return getattr(parent, _FLAT_MARK, None) == parent._version


def mark_flat(parent: torch.Tensor) -> torch.Tensor:
    """Declare ``parent`` flat (e.g. a copy of a state a union call left
    flat), so the next call skips the compress kernel; returns it."""
    setattr(parent, _FLAT_MARK, parent._version)
    return parent


def last_rounds() -> Dict[str, int]:
    """The round counts of the last CUDA call (hook, doubling and compress
    rounds; compress is 1 for the pass plus its doubling rounds, 0 when
    the state was known flat).  Synchronizes."""
    if _last_scratch is None:
        raise RuntimeError("no union-find kernel call yet")
    hook, doubling, comp = _last_scratch[40:52].view(torch.int32).tolist()
    return {"hook": hook, "doubling": doubling, "compress": comp}


@_cuda.on_device_of("parent")
def _launch(parent, seen, src, dst, mask, n: int, parity: bool = False) -> None:
    """One ``uf_union_launch`` (``uf_parity_union_launch`` with ``parity``)
    on the current stream: compress unless ``parent`` is known flat, then
    the union of n edges (none for compress alone)."""
    global _last_scratch
    if parent.device.type != "cuda":
        raise ValueError(f"no uf_union_launch kernel for device {parent.device}")
    lib = _cuda.library(_SOURCE)
    items = 2 * n if parity else n
    if items > _MAX_INT32:
        raise ValueError("a parity batch must hold fewer than 2^30 edges")
    nbytes = lib.uf_scratch_bytes(items, parent.shape[0])
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=parent.device)
    flat = _known_flat(parent)
    entry = lib.uf_parity_union_launch if parity else lib.uf_union_launch
    err = entry(
        parent.data_ptr(), _ptr(seen), _ptr(src), _ptr(dst), _ptr(mask), n,
        parent.shape[0] // 2 if parity else parent.shape[0], int(flat), scratch.data_ptr(), nbytes,
        torch.cuda.current_stream(parent.device).cuda_stream,
    )
    _cuda.check(err, "uf_parity_union_launch" if parity else "uf_union_launch")
    mark_flat(parent)
    _last_scratch = scratch
    if n > 0:
        LAUNCHES["parity_union_kernel" if parity else "union_kernel"] += 1
    if not flat:
        LAUNCHES["compress_kernel"] += 1


def compress(parent: torch.Tensor) -> torch.Tensor:
    """Point every entry at its root, in place; returns ``parent``.  A
    tensor known flat is returned as it is, with no call."""
    _check_vector(parent, torch.int32, "parent")
    if parent.device.type == "cpu":
        return parent.copy_(compress_plain(parent))
    if not _known_flat(parent):
        _launch(parent, None, None, None, None, 0)
    return parent


def clone(t: torch.Tensor) -> torch.Tensor:
    """``t.clone()``, marked flat where ``t`` is known flat."""
    return mark_flat(t.clone()) if _known_flat(t) else t.clone()


def compressed(parent: torch.Tensor) -> torch.Tensor:
    """``parent`` with every entry at its root, ``parent`` unchanged: the
    tensor itself where it is known flat (a readout after a union launches
    nothing), else a compressed copy.  Do not write to the result."""
    return parent if _known_flat(parent) else compress(parent.clone())


def find_roots(parent: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
    """Roots of ``vertices`` (``parent`` is not changed)."""
    return compressed(parent)[indexing.gather_index(vertices, parent.shape[0])]


def union_edges(
    parent: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Merge the components of every valid (src, dst) edge, in place;
    returns ``parent``, compressed."""
    _check_args(parent, None, src, dst, mask)
    if parent.device.type == "cpu":
        return parent.copy_(union_edges_plain(parent, src, dst, mask))
    _launch(parent, None, src, dst, mask, dst.shape[0])
    return parent


def merge_parents(parent_a: torch.Tensor, parent_b: torch.Tensor) -> torch.Tensor:
    """Combine two summaries over the same vertex space: b's pointers
    (v, parent_b[v]) are unioned into ``parent_a`` in place; returns it."""
    _check_args(parent_a, None, None, parent_b, None)
    if parent_b.shape != parent_a.shape:
        raise ValueError("merge_parents needs two parents of the same shape")
    if parent_a.device.type == "cpu":
        return parent_a.copy_(merge_parents_plain(parent_a, parent_b))
    _launch(parent_a, None, None, parent_b, None, parent_b.shape[0])
    return parent_a


def union_edges_with_seen(
    parent: torch.Tensor,
    seen: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``union_edges`` plus marking every valid endpoint in ``seen``, both
    in place; returns ``(parent, seen)``."""
    _check_args(parent, seen, src, dst, mask)
    if parent.device.type == "cpu":
        p, s = union_edges_with_seen_plain(parent, seen, src, dst, mask)
        return parent.copy_(p), seen.copy_(s)
    _launch(parent, seen, src, dst, mask, dst.shape[0])
    return parent, seen


# ---------------------------------------------------------------------------
# the parity (signed) union-find of the bipartiteness check: vertex v becomes
# nodes 2v ("v on side A") and 2v + 1 ("v on side B"); an edge (u, w) asserts
# opposite sides, union(2u, 2w + 1) and union(2u + 1, 2w); the graph is not
# bipartite iff some seen vertex's two nodes share a component


def init_parity_parent(capacity: int, device: DeviceLike = None) -> torch.Tensor:
    return init_parent(2 * capacity, device)


def parity_union_edges_plain(
    parent2: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The JAX function: both doubled edges of every row concatenated, then
    one union; masked rows become (0, 0) self-unions."""
    a1, b1, a2, b2 = 2 * src, 2 * dst + 1, 2 * src + 1, 2 * dst
    if mask is not None:
        a1, b1, a2, b2 = (torch.where(mask, x, 0) for x in (a1, b1, a2, b2))
    return union_edges_plain(parent2, torch.cat([a1, a2]), torch.cat([b1, b2]))


def parity_union_edges_with_seen_plain(
    parent2: torch.Tensor,
    seen: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    p = parity_union_edges_plain(parent2, src, dst, mask)
    return p, _mark_seen(seen, src, dst, mask)


def _check_parity(parent2, seen, src, dst, mask) -> None:
    _check_args(parent2, None, src, dst, mask)
    if parent2.shape[0] % 2:
        raise ValueError("parent2 must have an even length (two nodes a vertex)")
    if seen is not None:
        _check_vector(seen, torch.bool, "seen")
        if 2 * seen.shape[0] != parent2.shape[0] or seen.device != parent2.device:
            raise ValueError("seen must hold one flag a vertex, on parent2's device")


def parity_union_edges(
    parent2: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply the opposite-side constraints of every valid row to the
    doubled space, in place; returns ``parent2``, compressed."""
    _check_parity(parent2, None, src, dst, mask)
    if parent2.device.type == "cpu":
        return parent2.copy_(parity_union_edges_plain(parent2, src, dst, mask))
    _launch(parent2, None, src, dst, mask, dst.shape[0], parity=True)
    return parent2


def parity_union_edges_with_seen(
    parent2: torch.Tensor,
    seen: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``parity_union_edges`` plus marking every valid endpoint in ``seen``
    (original space), both in place, in one kernel call on CUDA."""
    _check_parity(parent2, seen, src, dst, mask)
    if parent2.device.type == "cpu":
        p, s = parity_union_edges_with_seen_plain(parent2, seen, src, dst, mask)
        return parent2.copy_(p), seen.copy_(s)
    _launch(parent2, seen, src, dst, mask, dst.shape[0], parity=True)
    return parent2, seen


def parity_conflicts(parent2: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """True where a seen vertex's two sides collapsed (an odd cycle
    through it); ``parent2`` must be compressed, as the unions leave it."""
    return seen & (parent2[0::2] == parent2[1::2])


def is_bipartite(parent2: torch.Tensor, seen: torch.Tensor) -> torch.Tensor:
    """A bool scalar tensor: no seen vertex has collapsed sides."""
    return ~parity_conflicts(parent2, seen).any()
