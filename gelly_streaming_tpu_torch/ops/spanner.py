"""The spanner's batch admission: the wrapper of ``csrc/spanner.cu`` and its
plain twin.

Replaces ``_admit_batch`` of ``gelly_streaming_tpu/library/spanner.py``
(``:90-144``): a ``lax.map`` pre-filter over 256-edge chunks
(``_within_k_prefilter``, ``:63-87``) followed by a ``while_loop`` over
the surviving candidates, each step an exact distance test
(``within_two``, ``within_k_balls`` or ``bounded_bfs``) and then
``add_undirected_edge``.  The pre-filter tests every edge of the batch
against the table as it was before the batch: the capped ball of radius
ceil(k/2) around u against the one of radius k - ceil(k/2) around v
(``summaries/adjacency.expand_balls``: each round appends the rows of
every entry, then keeps the first ``cap``); an edge whose balls meet is
within k and dies.  The rest, in arrival order, are resolved one after
another against the table as the batch has changed it.

On CUDA tensors ``spanner_admit`` is one C call a batch: a pre-pass
kernel (a warp an edge) that runs, against the table as it was before the
batch, the capped test as the JAX package computes it (so the candidates
are the same) and then, on a candidate, the walk's own exact test; then
one block that walks the survivors of both in arrival order (the body's
exact test on the table as the batch has changed it, then one thread's
insert).  The table only grows, and each body's answer only turns from
"not within" to "within" as it grows, so an edge within k before the
batch is rejected by the walk whatever comes before it: the walk sees
only the edges the pre-batch table cannot decide.  Its device counters
(``stats``) sum the calls, the candidates, the survivors and the
admissions.  On CPU tensors it runs the twin, which copies the JAX
functions; ``spanner_admit_model`` is the plain form of the kernel's two
phases (``exact_prepass_plain``, then the walk over its survivors).  All
update ``nbrs`` and ``deg`` in place and return them.  Ids: the capped
test expands a ball entry below 0 to -1s and one at or past C as row
C - 1; the exact tests clamp ids below 0 to 0 (``jnp.maximum``), and then
gathers clamp and scatters drop (JAX's rules).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gelly_streaming_tpu_torch.ops import _cuda
from gelly_streaming_tpu_torch.summaries import adjacency

_SOURCE = "spanner.cu"
BODIES = ("within_two", "balls", "bfs")  # the C call's body codes, in order
PREFILTER_CHUNK = 256  # the JAX package's lax.map chunk (the twin's, smaller for wide balls)
SCRATCH_CACHE = 8
STATS = ("calls", "candidates", "admitted", "max_candidates", "survivors", "max_survivors")  # the C call's order
MODEL_ELEMENTS = 1 << 22  # entries the model's vectorized pre-pass holds at once

# C calls since the last reset_launches() (CUDA tensors only), and the
# wrapper's twin calls (CPU tensors only)
LAUNCHES: Dict[str, int] = {"spanner_admit": 0}
TWIN_CALLS: Dict[str, int] = {"spanner_admit": 0}
_scratch: Dict[tuple, torch.Tensor] = {}
_stats: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


def stats(device) -> Dict[str, int]:
    """The CUDA calls' counters on ``device`` since the last reset_stats():
    calls, candidates that passed the capped test, edges admitted, the
    most candidates in one call, survivors of the exact pre-pass (the
    edges the walk tests), the most survivors in one call (synchronizes)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _stats.get(dev)
    vals = [0] * len(STATS) if t is None else t.tolist()
    return dict(zip(STATS, vals))


def reset_stats() -> None:
    for t in _stats.values():
        t.zero_()


def _check(nbrs, deg, src, dst, mask, k: int, cap: int, body: str) -> None:
    if nbrs.dtype != torch.int32 or nbrs.dim() != 2 or not nbrs.is_contiguous():
        raise ValueError("nbrs must be a contiguous int32 [C, D] tensor")
    capacity, max_degree = nbrs.shape
    dev = nbrs.device
    if deg.dtype != torch.int32 or tuple(deg.shape) != (capacity,) or not deg.is_contiguous() or deg.device != dev:
        raise ValueError(f"deg must be a contiguous int32 [C] tensor on {dev}")
    for t, name in ((src, "src"), (dst, "dst")):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != src.shape or t.device != dev:
            raise ValueError(f"{name} must be a 1-D int32 tensor on {dev} with src's length")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != src.shape or mask.device != dev):
        raise ValueError(f"mask must be a bool tensor of src's shape on {dev}, or None")
    if capacity < 1 or max_degree < 1 or capacity * max_degree >= 1 << 31:
        raise ValueError("the table needs C, D >= 1 and C * D < 2^31 slots")
    if k < 0 or cap < 0:
        raise ValueError(f"k and cap must be >= 0, got {k}, {cap}")
    if body not in BODIES:
        raise ValueError(f"body must be one of {BODIES}, got {body!r}")


# ---------------------------------------------------------------------------
# plain twin


def ball_size(radius: int, cap: int, max_degree: int) -> int:
    """Entries of a ball expanded ``radius`` rounds under ``cap``: 1, then
    min(cap, n (D + 1)) a round."""
    n = 1
    for _ in range(radius):
        n = min(cap, n * (max_degree + 1))
    return n


def prefilter_plain(nbrs: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, k: int, cap: int) -> torch.Tensor:
    """bool[B]: True only where dist(src, dst) <= k on ``nbrs`` for sure
    (the JAX ``_within_k_prefilter``, chunk by chunk; each edge's answer
    is its own, so the chunk only bounds the twin's memory)."""
    a = (k + 1) // 2
    max_degree = nbrs.shape[1]
    pairs = ball_size(a, cap, max_degree) * ball_size(k - a, cap, max_degree)
    chunk = max(1, min(PREFILTER_CHUNK, (1 << 24) // max(pairs, 1)))
    out = torch.zeros(src.shape, dtype=torch.bool, device=src.device)
    for lo in range(0, src.shape[0], chunk):
        u = src[lo : lo + chunk]
        v = dst[lo : lo + chunk]
        ball_u = adjacency.expand_balls(nbrs, u, a, cap)
        ball_v = adjacency.expand_balls(nbrs, v, k - a, cap)
        hit = (ball_u[:, :, None] == ball_v[:, None, :]) & (ball_u >= 0)[:, :, None] & (ball_v >= 0)[:, None, :]
        out[lo : lo + chunk] = hit.flatten(1).any(1)
    return out


def spanner_admit_plain(
    nbrs: torch.Tensor, deg: torch.Tensor, src, dst, mask, k: int, cap: int, body: str
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``_admit_batch`` with the body ``body`` ("within_two",
    "balls" or "bfs"), in place: returns (nbrs, deg)."""
    within_pre = prefilter_plain(nbrs, src, dst, k, cap)
    cand = ~within_pre if mask is None else mask & ~within_pre
    idx = torch.nonzero(cand).flatten()
    cu = src[idx].clamp_min(0).tolist()
    cv = dst[idx].clamp_min(0).tolist()
    for u, v in zip(cu, cv):
        if body == "within_two":
            within = adjacency.within_two(nbrs, u, v)
        elif body == "balls":
            within = adjacency.within_k_balls(nbrs, u, v, k)
        else:
            within = adjacency.bounded_bfs(nbrs, u, v, k)
        adjacency.add_undirected_edge_(nbrs, deg, u, v, enabled=not within)
    return nbrs, deg


# ---------------------------------------------------------------------------
# the plain form of the kernel's two phases


def _rows_isin(values: torch.Tensor, sets: torch.Tensor) -> torch.Tensor:
    """bool [B, N]: values[b, i] among sets[b, :] (row by row)."""
    ordered = sets.sort(dim=1).values
    at = torch.searchsorted(ordered, values.contiguous()).clamp_max(ordered.shape[1] - 1)
    return ordered.gather(1, at) == values


def _within_chunk(nbrs: torch.Tensor, u: torch.Tensor, v: torch.Tensor, k: int, body: str) -> torch.Tensor:
    capacity, max_degree = nbrs.shape
    if body == "within_two":
        ru = nbrs[u.clamp_max(capacity - 1).long()]
        rv = nbrs[v.clamp_max(capacity - 1).long()]
        direct = (u == v) | (ru == v[:, None]).any(1)
        return direct | ((ru >= 0) & _rows_isin(ru, torch.where(rv >= 0, rv, -2))).any(1)
    if body == "balls":
        a = (k + 1) // 2
        probe = adjacency.expand_balls(nbrs, u, a, adjacency._exact_ball_size(max_degree, a))
        small = adjacency.expand_balls(nbrs, v, k - a, adjacency._exact_ball_size(max_degree, k - a))
        return ((probe >= 0) & _rows_isin(probe, small)).any(1)
    # bfs: k rounds of reached @ A over the ids in [0, C) of each reached row (0/1 sums: exact in f32)
    rows = torch.arange(capacity, device=nbrs.device).repeat_interleave(max_degree)
    flat = nbrs.reshape(-1).long()
    ok = (flat >= 0) & (flat < capacity)
    adj = torch.zeros((capacity, capacity), dtype=torch.float32, device=nbrs.device)
    adj[rows[ok], flat[ok]] = 1.0
    reached = torch.zeros((u.shape[0], capacity), dtype=torch.float32, device=nbrs.device)
    inside = u < capacity
    reached[torch.nonzero(inside).flatten(), u[inside].long()] = 1.0
    for _ in range(k):
        reached = ((reached + reached @ adj) > 0).to(torch.float32)
    return reached.gather(1, v.clamp_max(capacity - 1).long()[:, None])[:, 0] > 0


def exact_prepass_plain(nbrs: torch.Tensor, src, dst, cand: torch.Tensor, k: int, body: str) -> torch.Tensor:
    """bool[B]: the survivors of the kernel's exact pre-pass, the
    candidates ``cand`` whose body test (``within_two``, the "exact" balls
    of ``within_k_balls`` or ``bounded_bfs``) on ``nbrs`` as it stands, on
    the ids clamped below at 0, says "not within".  The table does not
    change here, so the tests run over the whole batch at once (in chunks
    of rows)."""
    out = torch.zeros(src.shape, dtype=torch.bool, device=src.device)
    idx = torch.nonzero(cand).flatten()
    if idx.numel() == 0:
        return out
    capacity, max_degree = nbrs.shape
    a = (k + 1) // 2
    width = {"within_two": max_degree * max_degree, "bfs": capacity,
             "balls": adjacency._exact_ball_size(max_degree, a) + adjacency._exact_ball_size(max_degree, k - a)}[body]
    chunk = max(1, MODEL_ELEMENTS // max(width, 1))
    for lo in range(0, idx.numel(), chunk):
        at = idx[lo : lo + chunk]
        u = src[at].clamp_min(0).to(torch.int32)
        v = dst[at].clamp_min(0).to(torch.int32)
        out[at] = ~_within_chunk(nbrs, u, v, k, body)
    return out


def walk_plain(nbrs: torch.Tensor, deg: torch.Tensor, src, dst, survivors: torch.Tensor, k: int, body: str) -> int:
    """The kernel's walk: each survivor in arrival order, the body's exact
    test on the table as the walk has changed it, then
    ``add_undirected_edge``, in place; returns the edges admitted."""
    idx = torch.nonzero(survivors).flatten()
    admitted = 0
    for u, v in zip(src[idx].clamp_min(0).tolist(), dst[idx].clamp_min(0).tolist()):
        if body == "within_two":
            within = adjacency.within_two(nbrs, u, v)
        elif body == "balls":
            within = adjacency.within_k_balls(nbrs, u, v, k)
        else:
            within = adjacency.bounded_bfs(nbrs, u, v, k)
        admitted += adjacency.add_undirected_edge_(nbrs, deg, u, v, enabled=not within)
    return admitted


def spanner_admit_model(nbrs: torch.Tensor, deg: torch.Tensor, src, dst, mask, k: int, cap: int, body: str):
    """The kernel's admission in plain form, in place: the capped test and
    the exact pre-pass against the table before the batch, then the walk
    over the survivors.  Returns (nbrs, deg, candidates, survivors)."""
    within_pre = prefilter_plain(nbrs, src, dst, k, cap)
    cand = ~within_pre if mask is None else mask & ~within_pre
    survivors = exact_prepass_plain(nbrs, src, dst, cand, k, body)
    walk_plain(nbrs, deg, src, dst, survivors, k, body)
    return nbrs, deg, int(cand.sum()), int(survivors.sum())


# ---------------------------------------------------------------------------
# the CUDA call


def _call_buffers(nbrs: torch.Tensor, n: int, k: int, cap: int, code: int):
    dev = nbrs.device
    capacity, max_degree = nbrs.shape
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream, n, capacity, max_degree, k, cap, code)
    buf = _scratch.get(key)
    if buf is None:
        nbytes = int(_cuda.library(_SOURCE).spanner_scratch_bytes(n, capacity, max_degree, k, cap, code))
        if nbytes < 0:
            raise ValueError(f"no spanner admission for k = {k}, cap = {cap} at D = {max_degree}: its balls "
                             "pass the kernel's scratch")
        if len(_scratch) >= SCRATCH_CACHE:
            _scratch.clear()
        buf = _scratch[key] = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    st = _stats.get(dev)
    if st is None:
        st = _stats[dev] = torch.zeros((len(STATS),), dtype=torch.int32, device=dev)
    return buf, st


@_cuda.on_device_of("nbrs")
def spanner_admit(
    nbrs: torch.Tensor,
    deg: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor],
    k: int,
    cap: int,
    body: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Admit the batch's edges into the spanner table (nbrs int32 [C, D],
    deg int32 [C]) in place; ``mask`` None admits every row.  ``body``
    names the exact test ("within_two", "balls" or "bfs"); every body is
    exact, and on the JAX package's ``body="auto"`` it is
    ``library/spanner.auto_body``'s pick."""
    _check(nbrs, deg, src, dst, mask, k, cap, body)
    if nbrs.device.type != "cuda":
        TWIN_CALLS["spanner_admit"] += 1
        return spanner_admit_plain(nbrs, deg, src, dst, mask, k, cap, body)
    n = src.shape[0]
    code = BODIES.index(body)
    lib = _cuda.library(_SOURCE)
    buf, st = _call_buffers(nbrs, n, k, cap, code)
    src_c, dst_c = src.contiguous(), dst.contiguous()
    mask_c = None if mask is None else mask.contiguous()
    err = lib.spanner_admit_launch(
        nbrs.data_ptr(), deg.data_ptr(), nbrs.shape[0], nbrs.shape[1], src_c.data_ptr(), dst_c.data_ptr(),
        None if mask_c is None else mask_c.data_ptr(), n, k, cap, code, buf.data_ptr(), buf.numel(),
        st.data_ptr(), torch.cuda.current_stream(nbrs.device).cuda_stream,
    )
    _cuda.check(err, "spanner_admit_launch")
    LAUNCHES["spanner_admit"] += 1
    return nbrs, deg
