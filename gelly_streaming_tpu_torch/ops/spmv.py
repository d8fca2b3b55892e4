"""The masked-semiring SpMV core with push/pull direction optimization.

Port of ``gelly_streaming_tpu/ops/spmv.py`` (GraphBLAST's formulation,
Yang et al., arXiv:1908.01407): a graph pane is a sparse matrix, one
propagation round is y = A^T x over an (add, mul) semiring restricted by
an edge mask, and an algorithm is a semiring, an initial vector and a
fixpoint policy.  The library's iterative vertex programs (sssp, pagerank,
k-core, iterative CC) are built on it.

Two lowerings serve every product:

* **pull (SpMV)**: a gather over the pane's dst-STABLE-sorted copy and a
  sorted segment reduction;
* **push (SpMSpV)**: the frontier's rows of the src-sorted CSR, combined
  into the target.

``fixpoint`` picks a lowering each iteration by the frontier's density
(|frontier| / |active vertices|) against a threshold (Beamer's direction
optimization); "push"/"pull" force one.  The answer is the same in every
mode: for an idempotent semiring a dominated candidate stays dominated, so
relaxing only the frontier's rows equals relaxing all of them.

On the GPU the loops are hand-written CUDA kernels (``csrc/spmv.cu``,
``csrc/kcore.cu``), one C call a loop or a bucket:

* ``fixpoint`` on CUDA tensors is ``spmv_fixpoint_launch``: the whole
  while loop, its per-iteration direction, counters and density histogram
  in one cooperative launch, each iteration's product balanced over the
  edges (the pull over the merge path of segment ends and edges, the push
  over a queue of the frontier's rows).  The JAX package's host loop
  escalates through frontier-capacity buckets (``frontier_caps``), an XLA
  shape device; its largest bucket holds every frontier and no bucket
  changes an iteration, so the kernel needs none and its iterations,
  counters, ``x`` and frontier equal the JAX package's exactly.  Its
  scratch (the header, the queue, the pull tiles) is sized by
  ``spmv_fixpoint_scratch_bytes``.
* ``pagerank_fixpoint`` is ``pagerank_fixpoint_launch``: the damped
  iteration in one cooperative launch.  Both directions take the segment
  sum over the dst-stable copy (the per-destination order of the JAX
  push's arrival-order scatter), balanced over the edges as the min
  products' pull is: merge-path tiles of segment ends and edges, each
  segment's pieces combined in an order that the tiles alone fix (a scan
  within a tile, carries across tiles added by the destination's owner).
  Every reduction adds in an order that depends on the data alone, never
  on the grid, so push, pull and a second run give the same bits.  Its
  three sums (each destination's spread, the dangling mass, the L1 delta)
  accumulate in f64 and round to f32 once, as the twin's do: an f32 sum
  over a hub's 10^5 in-edges depends on its order by ~1e-5 relative, the
  f64 one is the exact sum's rounding in any order.  Its scratch (the
  header, the contributions, the partials, the tiles and their carries)
  is sized by ``pagerank_scratch_bytes``.
* ``_kcore_fixpoint`` (the h-index fixed point of ``library/kcore.py``;
  private, because the card caps each row's values at the h-index of the
  starting estimates, which holds only for rows of distinct neighbours:
  its one caller, ``pane_cores``, builds them from deduplicated edges) is
  ``kcore_fixpoint_launch``: every round of a pane, every bucket of each
  round, in one cooperative launch, whose header (rounds, converged) the
  host reads once.  ``kcore_round`` (one bucket, one round) is
  ``kcore_round_launch``, the same row code, with no cap.
* ``spmv_dense`` and ``spmsv_frontier`` run one iteration's product code
  of the same source (``spmv_product_launch``; a min semiring's in one
  cooperative launch, as the fixpoint plans it).
* ``cc_fixpoint`` is the union-find fold, ``ops/unionfind.
  union_edges_with_seen`` (``csrc/unionfind.cu``'s ``union_kernel``): the
  JAX package defines it as that array fixed point.

On CPU tensors each wrapper runs its plain twin (``fixpoint_plain``,
``pagerank_fixpoint_plain``, ``kcore_round_plain``, ``kcore_fixpoint_plain``,
``product_plain``):
the JAX algorithm written as PyTorch ops with a host loop.  A CUDA tensor
launches the kernel or raises.  ``LAUNCHES`` counts the C calls on CUDA
tensors (never the twins).

Index rules: each lowering follows the JAX lowering it replaces for ids of
masked rows outside [0, C) (a gather counts below 0 from the end once and
clamps; a push's scatter drops a target still outside; a pull segment
exists only for a destination in [0, C)).  ``pagerank_fixpoint`` takes
ids in [0, C): the JAX package's two PageRank lowerings disagree outside
it.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import _cuda, indexing
from gelly_streaming_tpu_torch.ops import unionfind as uf
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils.envswitch import resolve_choice

# Frontier density (|frontier| / |active vertices|) above which "auto"
# switches from the sparse push to the dense pull lowering (the JAX
# package's default).
DEFAULT_DIRECTION_THRESHOLD = 0.05

DIRECTIONS = ("auto", "push", "pull")

_HIST_BINS = metrics.SPMV_DENSITY_BINS
_SOURCE = "spmv.cu"
_KCORE_SOURCE = "kcore.cu"
_MAX_INT32 = (1 << 31) - 1

# spmv_fixpoint_launch's header: the first int32 slots of its scratch
# (csrc/spmv.cu, FixSlot)
_FIX_HEADER_INTS = 24
_FIX_ITERS = 3  # then push, pull, switches, the histogram
FIX_BLOCKS = 22  # the launch's blocks
_RANK_ITERS = 1  # pagerank_fixpoint_launch's header slots
RANK_BLOCKS = 2  # the launch's blocks
_CORE_HEADER_INTS = 8  # kcore_fixpoint_launch's (csrc/kcore.cu, CoreSlot)

# C calls on CUDA tensors since the last reset_launches() (spmv_product:
# the one-shot spmv_dense / spmsv_frontier products; kcore_fixpoint: one a
# pane)
LAUNCHES: Dict[str, int] = {
    "spmv_fixpoint": 0, "pagerank_fixpoint": 0, "kcore_fixpoint": 0, "kcore_round": 0, "spmv_product": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# semiring descriptors


# scatters follow JAX's mode="drop": below 0 counts from the end once, an
# index still outside [0, size) is dropped


def _scatter_min(target, idx, vals):
    j, kept = indexing.scatter_index(idx, target.shape[0])
    return target.scatter_reduce(0, j[kept], vals[kept].to(target.dtype), "amin")


def _scatter_add(target, idx, vals):
    j, kept = indexing.scatter_index(idx, target.shape[0])
    return target.index_add(0, j[kept], vals[kept].to(target.dtype))


def _segment_min(vals, seg, num_segments):
    # an empty segment holds the type's largest value, as jax.ops.segment_min
    empty = float("inf") if vals.dtype.is_floating_point else torch.iinfo(vals.dtype).max
    return _scatter_min(torch.full((num_segments,), empty, dtype=vals.dtype, device=vals.device), seg, vals)


def _segment_sum(vals, seg, num_segments):
    return _scatter_add(torch.zeros((num_segments,), dtype=vals.dtype, device=vals.device), seg, vals)


class Semiring(NamedTuple):
    """An (add, mul) pair with the reductions it admits.

    ``identity`` is add's neutral element (the empty-row value);
    ``idempotent`` marks add(a, a) == a, which makes frontier-restricted
    (push) iteration state-identical to full relaxation, and hence which
    semirings ``fixpoint`` accepts.  ``scatter`` combines candidates into
    an existing [C] target at given rows (rows outside [0, C) after JAX's
    negative wrap drop); ``segment`` reduces a dst-sorted candidate vector
    segment-wise.  ``dtype`` is the type of x and y; ``code`` the kernels'
    name for the semiring."""

    name: str
    identity: float
    idempotent: bool
    mul: Callable
    combine: Callable
    scatter: Callable
    segment: Callable
    dtype: torch.dtype
    code: int


#: min-plus: shortest-path relaxation (sssp).
MIN_PLUS = Semiring(
    "min_plus", 1e30, True, lambda x, w: x + w, torch.minimum, _scatter_min, _segment_min, torch.float32, 0,
)
#: plus-times: mass spreading (pagerank's damped transition).
PLUS_TIMES = Semiring(
    "plus_times", 0.0, False, lambda x, w: x * w, torch.add, _scatter_add, _segment_sum, torch.float32, 1,
)
#: min-min: label propagation (iterative CC's hooking step).
MIN_MIN = Semiring(
    "min_min", 2**31 - 1, True, lambda x, w: torch.minimum(x, w.to(x.dtype)), torch.minimum, _scatter_min,
    _segment_min, torch.int32, 2,
)
#: plus-one: degree / incidence counting (k-core's estimate init).
PLUS_ONE = Semiring(
    "plus_one", 0, False, lambda x, w: torch.ones_like(x), torch.add, _scatter_add, _segment_sum, torch.int32, 3,
)


def _full(sem: Semiring, n: int, device) -> torch.Tensor:
    return torch.full((n,), sem.identity, dtype=sem.dtype, device=device)


# ---------------------------------------------------------------------------
# pane operator: one pane's edges in the layouts the lowerings need


class PaneOperator(NamedTuple):
    """One pane's (padded) edge list as a masked sparse matrix, in the two
    layouts the products read: src-sorted CSR (push; ``off`` [C + 1]) and
    dst-STABLE-sorted (pull; ``d_off`` [C + 1], the port's segment offsets,
    which the JAX package expresses as segment ids).  Masked-out rows sort
    past every segment, so no mask is kept.  ``n_active`` (an int32 scalar
    tensor) counts the vertices incident to any masked edge: the density's
    denominator."""

    capacity: int
    e_pad: int
    s_dst: torch.Tensor
    s_w: torch.Tensor
    off: torch.Tensor
    d_src: torch.Tensor
    d_w: torch.Tensor
    n_active: torch.Tensor
    d_off: torch.Tensor


_NUMPY = {torch.int32: np.int32, torch.float32: np.float32, torch.bool: np.bool_}


def _tensor(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, dtype=_NUMPY[dtype])).to(device)


def prepare_pane(src, dst, w, msk, capacity: int, device: DeviceLike = None) -> PaneOperator:
    """Sort one padded pane into a :class:`PaneOperator` on ``device``
    (default cuda; ``w=None`` means unit weights): two stable sorts, two
    ``searchsorted`` and the active count, as PyTorch ops.  Masked-out rows
    sort past every real key, so the CSR offsets and segments never see
    them."""
    dev = resolve_device(device)
    if not 0 < capacity <= _MAX_INT32 - 1:
        raise ValueError(f"capacity {capacity} outside [1, 2^31 - 1)")
    src = _tensor(src, torch.int32, dev)
    dst = _tensor(dst, torch.int32, dev)
    msk = _tensor(msk, torch.bool, dev)
    e_pad = int(src.shape[0])
    if src.dim() != 1 or dst.shape != src.shape or msk.shape != src.shape:
        raise ValueError("src, dst and msk must be 1-D of one length")
    w = torch.ones((e_pad,), dtype=torch.float32, device=dev) if w is None else _tensor(w, torch.float32, dev)
    if w.shape != src.shape:
        raise ValueError("w must have src's length")
    keys = torch.arange(capacity + 1, dtype=torch.int32, device=dev)
    key_s = torch.where(msk, src, capacity)
    o = torch.sort(key_s, stable=True).indices
    off = torch.searchsorted(key_s[o], keys).to(torch.int32)
    key_d = torch.where(msk, dst, capacity)
    o2 = torch.sort(key_d, stable=True).indices  # stable: arrival order kept per dst
    d_off = torch.searchsorted(key_d[o2], keys).to(torch.int32)
    act = torch.zeros((capacity,), dtype=torch.bool, device=dev)
    indexing.scatter_true_(act, src[msk])
    indexing.scatter_true_(act, dst[msk])
    return PaneOperator(capacity, e_pad, dst[o], w[o], off, src[o2], w[o2], act.sum(dtype=torch.int32), d_off)


def _segment_ids(op: PaneOperator) -> torch.Tensor:
    """The destination of each edge of the segments [d_off[0], d_off[C])."""
    deg = (op.d_off[1:] - op.d_off[:-1]).long()
    return torch.repeat_interleave(torch.arange(op.capacity, device=op.d_off.device), deg)


def frontier_caps(e_pad: int) -> tuple:
    """The pow2 frontier-capacity buckets the JAX package's host loop
    escalates through (kept for ``spmsv_frontier``'s ``f_cap``; the port's
    fixpoint needs no buckets)."""
    return tuple(
        sorted({
            min(e_pad, max(256, e_pad >> 4)),
            min(e_pad, max(256, e_pad >> 2)),
            e_pad,
        })
    )


# ---------------------------------------------------------------------------
# plain twins of the products (PyTorch ops; new tensors out)


def _push_plain(sem: Semiring, op: PaneOperator, x: torch.Tensor, fm: torch.Tensor) -> torch.Tensor:
    """The JAX push lowering: the frontier's CSR rows (v in [0, C)), their
    candidates scattered in slot order into an identity-filled vector."""
    c = op.capacity
    lo, hi = int(op.off[0]), int(op.off[c])
    deg = (op.off[1:] - op.off[:-1]).long()
    v = torch.repeat_interleave(torch.arange(c, device=x.device), deg)
    live = fm[v]
    cand = sem.mul(x[v[live]], op.s_w[lo:hi][live])
    return sem.scatter(_full(sem, c, x.device), op.s_dst[lo:hi][live], cand)


def _pull_plain(sem: Semiring, op: PaneOperator, x: torch.Tensor, fm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX pull lowering: the dst-sorted segments of [0, C) reduced in
    order, combined with the identity; with ``fm``, only edges whose source
    is a frontier vertex in [0, C) (the card's push of a sum semiring)."""
    c = op.capacity
    lo, hi = int(op.d_off[0]), int(op.d_off[c])
    s, d, w = op.d_src[lo:hi], _segment_ids(op), op.d_w[lo:hi]
    if fm is not None:
        keep = (s >= 0) & (s < c)
        keep &= fm[s.clamp(0, c - 1).long()]
        s, d, w = s[keep], d[keep], w[keep]
    cand = sem.mul(x[indexing.gather_index(s, c)], w)
    return sem.combine(_full(sem, c, x.device), sem.segment(cand, d, c))


def product_plain(sem: Semiring, op: PaneOperator, x: torch.Tensor, frontier: Optional[torch.Tensor] = None):
    """One product: pull over every destination (``frontier`` None) or the
    push lowering restricted to ``frontier``."""
    if frontier is None:
        return _pull_plain(sem, op, x)
    if sem.idempotent:
        return _push_plain(sem, op, x, frontier)
    return _pull_plain(sem, op, x, frontier)


# ---------------------------------------------------------------------------
# one-shot products


def _check_x(sem: Semiring, op: PaneOperator, x) -> torch.Tensor:
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    x = x.to(op.off.device)
    if x.dtype != sem.dtype or x.shape != (op.capacity,):
        raise ValueError(f"{sem.name} takes x as {sem.dtype} [{op.capacity}]; got {x.dtype} {tuple(x.shape)}")
    return x.contiguous()


def _check_frontier(op: PaneOperator, frontier) -> torch.Tensor:
    fm = frontier if isinstance(frontier, torch.Tensor) else torch.as_tensor(np.asarray(frontier))
    fm = fm.to(device=op.off.device, dtype=torch.bool).contiguous()
    if fm.shape != (op.capacity,):
        raise ValueError(f"frontier must be bool [{op.capacity}]")
    return fm


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _plan_scratch(lib, op: PaneOperator) -> torch.Tensor:
    """The scratch of one balanced product or fixpoint over ``op``: the
    header (its first int32 slots), the frontier queue and the pull tiles."""
    nbytes = lib.spmv_fixpoint_scratch_bytes(op.capacity, op.e_pad)
    return torch.empty(((nbytes + 3) // 4,), dtype=torch.int32, device=op.off.device)


@_cuda.on_device_of("x")
def _product_launch(sem: Semiring, op: PaneOperator, x: torch.Tensor, fm: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"no spmv_product_launch kernel for device {x.device}")
    lib = _cuda.library(_SOURCE)
    y = torch.empty_like(x)
    scratch = _plan_scratch(lib, op) if sem.idempotent else None
    _cuda.check(
        lib.spmv_product_launch(
            sem.code, int(fm is not None), op.off.data_ptr(), op.s_dst.data_ptr(), op.s_w.data_ptr(),
            op.d_off.data_ptr(), op.d_src.data_ptr(), op.d_w.data_ptr(), x.data_ptr(),
            None if fm is None else fm.data_ptr(), y.data_ptr(), op.capacity, op.e_pad,
            None if scratch is None else scratch.data_ptr(), 0 if scratch is None else scratch.numel() * 4,
            _stream(x),
        ),
        "spmv_product_launch",
    )
    LAUNCHES["spmv_product"] += 1
    return y


def spmv_dense(sem: Semiring, op: PaneOperator, x) -> torch.Tensor:
    """One masked semiring SpMV (dense-mask pull lowering):
    ``y[d] = add over masked edges (s, d, w) of mul(x[s], w)``, identity
    where no edge lands."""
    x = _check_x(sem, op, x)
    if x.device.type == "cpu":
        return product_plain(sem, op, x)
    return _product_launch(sem, op, x, None)


def spmsv_frontier(sem: Semiring, op: PaneOperator, x, frontier, f_cap: Optional[int] = None) -> torch.Tensor:
    """One masked semiring SpMSpV (sparse-frontier push lowering): the
    same product restricted to edges whose source is in ``frontier``.
    Refuses loudly when the frontier's edge count exceeds ``f_cap``
    (silent truncation would be a wrong answer, not a slow one)."""
    e_pad = op.e_pad
    if f_cap is None:
        f_cap = e_pad
    if not 1 <= f_cap <= e_pad:
        raise ValueError(f"f_cap {f_cap} outside [1, {e_pad}]")
    x = _check_x(sem, op, x)
    fm = _check_frontier(op, frontier)
    deg = op.off[1:] - op.off[:-1]
    fe = int(torch.where(fm, deg, 0).sum())
    if fe > f_cap:
        raise ValueError(
            f"frontier touches {fe} edges > f_cap {f_cap}; use a bigger "
            "bucket (frontier_caps) or the dense lowering"
        )
    if x.device.type == "cpu":
        return product_plain(sem, op, x, fm)
    return _product_launch(sem, op, x, fm)


def scatter_into(sem: Semiring, capacity: int, idx, vals, msk, device: DeviceLike = None) -> torch.Tensor:
    """One-shot masked scatter-combine into an identity-filled [capacity]
    vector: the degenerate SpMV every degree/count init is (k-core seeds
    estimates with a PLUS_ONE scatter over the pane's src column).  One
    ``scatter_reduce``/``index_add`` (numpy inputs go to ``device``,
    default cuda)."""
    dev = idx.device if isinstance(idx, torch.Tensor) else resolve_device(device)
    idx = _tensor(idx, torch.int32, dev)
    vals = vals.to(dev) if isinstance(vals, torch.Tensor) else torch.as_tensor(np.asarray(vals)).to(dev)
    msk = _tensor(msk, torch.bool, dev)
    return sem.scatter(
        torch.full((capacity,), sem.identity, dtype=vals.dtype, device=dev), idx[msk], vals[msk]
    )


# ---------------------------------------------------------------------------
# direction-optimized fixpoint


class FixpointResult(NamedTuple):
    x: torch.Tensor
    frontier: torch.Tensor
    iters: int
    push_iters: int
    pull_iters: int
    switches: int


class _Run(NamedTuple):
    x: torch.Tensor
    frontier: torch.Tensor
    iters: int
    push_iters: int
    pull_iters: int
    switches: int
    hist: List[int]


def fixpoint_plain(sem: Semiring, op: PaneOperator, x0: torch.Tensor, fm0: torch.Tensor, thr: float,
                   max_iters: int, log: Optional[list] = None) -> _Run:
    """The JAX loop as PyTorch ops and a host loop: each iteration, the
    frontier's density in f32 against ``thr`` picks pull or push; x =
    combine(x, y); the frontier = the entries that changed.  ``log``, when
    given, gets (pull, frontier size, frontier edges) an iteration."""
    x, fm = x0.clone(), fm0.clone()
    deg = op.off[1:] - op.off[:-1]
    denom = np.float32(max(int(op.n_active), 1))
    thr32 = np.float32(thr)
    it = push_i = pull_i = switches = 0
    last = -1
    hist = [0] * _HIST_BINS
    while it < max_iters:
        cnt = int(fm.sum())
        if cnt == 0:
            break
        dens = np.float32(cnt) / denom
        use_pull = bool(dens > thr32)
        if log is not None:
            log.append((use_pull, cnt, int(torch.where(fm, deg, 0).sum())))
        y = _pull_plain(sem, op, x) if use_pull else _push_plain(sem, op, x, fm)
        xn = sem.combine(x, y)
        d = int(use_pull)
        switches += int(last >= 0 and d != last)
        last = d
        pull_i += d
        push_i += 1 - d
        hist[min(int(dens * np.float32(_HIST_BINS)), _HIST_BINS - 1)] += 1
        fm = xn != x
        x = xn
        it += 1
    return _Run(x, fm, it, push_i, pull_i, switches, hist)


@_cuda.on_device_of("x0")
def fixpoint_launch(sem: Semiring, op: PaneOperator, x0: torch.Tensor, fm0: torch.Tensor, thr: float,
                    max_iters: int):
    """Enqueue one ``spmv_fixpoint_launch`` with no host sync; returns
    (x buffers [2, C] (the result in row 0), frontier, header int32[24]: a
    view of the scratch; slot ``FIX_BLOCKS`` holds the launch's blocks)."""
    if x0.device.type != "cuda":
        raise ValueError(f"no spmv_fixpoint_launch kernel for device {x0.device}")
    lib = _cuda.library(_SOURCE)
    c = op.capacity
    xs = torch.empty((2, c), dtype=x0.dtype, device=x0.device)
    fm = torch.empty((c,), dtype=torch.bool, device=x0.device)
    scratch = _plan_scratch(lib, op)
    _cuda.check(
        lib.spmv_fixpoint_launch(
            sem.code, op.off.data_ptr(), op.s_dst.data_ptr(), op.s_w.data_ptr(), op.d_off.data_ptr(),
            op.d_src.data_ptr(), op.d_w.data_ptr(), op.n_active.data_ptr(), c, op.e_pad, x0.data_ptr(),
            fm0.data_ptr(), xs.data_ptr(), fm.data_ptr(), float(thr), int(max_iters), scratch.data_ptr(),
            scratch.numel() * 4, _stream(x0),
        ),
        "spmv_fixpoint_launch",
    )
    LAUNCHES["spmv_fixpoint"] += 1
    return xs, fm, scratch[:_FIX_HEADER_INTS]


def _fixpoint_cuda(sem, op, x0, fm0, thr, max_iters) -> _Run:
    xs, fm, hdr = fixpoint_launch(sem, op, x0, fm0, thr, max_iters)
    h = hdr.tolist()  # the one read back a fixpoint, as the JAX host loop's int(it)
    it, push_i, pull_i, switches = h[_FIX_ITERS : _FIX_ITERS + 4]
    return _Run(xs[0], fm, it, push_i, pull_i, switches, h[_FIX_ITERS + 4 : _FIX_ITERS + 4 + _HIST_BINS])


def _threshold(direction: str, threshold: Optional[float]) -> float:
    if direction not in DIRECTIONS:
        raise ValueError(f"direction {direction!r} is not one of {'/'.join(DIRECTIONS)}")
    if threshold is None:
        threshold = DEFAULT_DIRECTION_THRESHOLD
    return {"push": 2.0, "pull": -1.0}.get(direction, float(threshold))


def fixpoint(
    sem: Semiring,
    op: PaneOperator,
    x0,
    *,
    max_iters: int,
    direction: str = "auto",
    threshold: Optional[float] = None,
    frontier=None,
) -> FixpointResult:
    """Iterate ``x = combine(x, A^T x)`` to a fixed point (or the
    iteration bound) with per-iteration push/pull direction optimization.

    Idempotent semirings only: frontier-restricted push relaxation equals
    full relaxation per iteration exactly when a dominated candidate stays
    dominated.  ``direction`` forces one lowering by folding into the
    threshold (2.0 is never exceeded: always push; -1.0 always is: always
    pull); ``threshold`` is the auto-mode density cut, defaulting to
    :data:`DEFAULT_DIRECTION_THRESHOLD`.  The initial frontier defaults to
    the non-identity entries of ``x0``.  Bumps the ``metrics.spmv_*``
    counters as the JAX package does."""
    if not sem.idempotent:
        raise ValueError(
            f"fixpoint needs an idempotent semiring (frontier relaxation "
            f"must be dominance-stable); {sem.name} is not"
        )
    thr = _threshold(direction, threshold)
    x = _check_x(sem, op, x0)
    fm = x != sem.identity if frontier is None else _check_frontier(op, frontier)
    if x.device.type == "cpu":
        run = fixpoint_plain(sem, op, x, fm, thr, int(max_iters))
    else:
        run = _fixpoint_cuda(sem, op, x, fm.contiguous(), thr, int(max_iters))
    metrics.spmv_add("spmv_fixpoints", 1)
    metrics.spmv_add("spmv_push_iters", run.push_iters)
    metrics.spmv_add("spmv_pull_iters", run.pull_iters)
    metrics.spmv_add("spmv_direction_switches", run.switches)
    for b in range(_HIST_BINS):
        if run.hist[b]:
            metrics.spmv_add(f"spmv_density_hist_{b}", run.hist[b])
    return FixpointResult(run.x, run.frontier, run.iters, run.push_iters, run.pull_iters, run.switches)


# ---------------------------------------------------------------------------
# PageRank


def pagerank_fixpoint_plain(op: PaneOperator, *, damping: float, tol: float, max_iters: int):
    """The JAX loop as PyTorch ops and a host loop: (r, in_window, iters).
    The spread, the dangling mass and the delta are f64 sums of the f32
    terms rounded to f32 once, as in the kernel."""
    c, dev = op.capacity, op.off.device
    f32 = torch.float32
    out_deg = (op.off[1:] - op.off[:-1]).to(f32)
    in_window = (out_deg > 0) | (op.d_off[1:] > op.d_off[:-1])
    n = in_window.sum().to(f32).clamp_min(1.0)
    damp = torch.tensor(damping, dtype=f32, device=dev)
    dangling = in_window & (out_deg == 0)
    zero = torch.zeros((), dtype=f32, device=dev)
    base = torch.where(in_window, (1.0 - damp) / n, zero)
    safe_deg = out_deg.clamp_min(1.0)
    lo, hi = int(op.d_off[0]), int(op.d_off[c])
    s, d = op.d_src[lo:hi].long(), _segment_ids(op)
    r = torch.where(in_window, torch.ones((), dtype=f32, device=dev) / n, zero)
    tol32 = np.float32(tol)
    it = 0
    delta = np.float32(np.inf)
    f64 = torch.float64
    while delta > tol32 and it < max_iters:
        spread = torch.zeros((c,), dtype=f64, device=dev).index_add_(0, d, (r / safe_deg)[s].to(f64)).to(f32)
        dangling_mass = torch.where(dangling, r, zero).sum(dtype=f64).to(f32) / n
        r_new = base + damp * (spread + torch.where(in_window, dangling_mass, zero))
        delta = np.float32((r_new - r).abs().sum(dtype=f64).item())
        r = r_new
        it += 1
    return r, in_window, it


def pagerank_launch(op: PaneOperator, *, damping: float, tol: float, max_iters: int):
    """Enqueue one ``pagerank_fixpoint_launch`` with no host sync; returns
    (ranks [2, C] (the result in row 0), in_window, scratch: int32 slot 1
    the iterations, slot ``RANK_BLOCKS`` the launch's blocks)."""
    dev = op.off.device
    if dev.type != "cuda":
        raise ValueError(f"no pagerank_fixpoint_launch kernel for device {dev}")
    lib = _cuda.library(_SOURCE)
    c = op.capacity
    nbytes = lib.pagerank_scratch_bytes(c, op.e_pad)
    rs = torch.empty((2, c), dtype=torch.float32, device=dev)
    in_w = torch.empty((c,), dtype=torch.bool, device=dev)
    scratch = torch.empty(((nbytes + 3) // 4,), dtype=torch.int32, device=dev)
    with _cuda.device_guard(dev):
        _cuda.check(
            lib.pagerank_fixpoint_launch(
                op.off.data_ptr(), op.d_off.data_ptr(), op.d_src.data_ptr(), c, op.e_pad, float(damping),
                float(tol), int(max_iters), rs.data_ptr(), in_w.data_ptr(), scratch.data_ptr(),
                scratch.numel() * 4, _stream(rs),
            ),
            "pagerank_fixpoint_launch",
        )
    LAUNCHES["pagerank_fixpoint"] += 1
    return rs, in_w, scratch


def pagerank_fixpoint(
    op: PaneOperator, *, damping: float, tol: float, max_iters: int, use_pull: bool = False,
):
    """The damped power iteration over one pane: (r, in_window, iters).
    Vertices are the endpoints of masked edges; uniform teleport over
    them; dangling mass (no out-edge) redistributes uniformly; iterate
    while the L1 delta exceeds ``tol`` and fewer than ``max_iters``
    iterations ran.  ``use_pull`` picks the lowering the JAX package
    counts; on the card both take the same ordered sum and give the same
    bits.  Ids of masked edges must lie in [0, C)."""
    if op.off.device.type == "cpu":
        r, in_w, iters = pagerank_fixpoint_plain(op, damping=damping, tol=tol, max_iters=max_iters)
    else:
        rs, in_w, scratch = pagerank_launch(op, damping=damping, tol=tol, max_iters=max_iters)
        r, iters = rs[0], int(scratch[_RANK_ITERS])
    metrics.spmv_add("spmv_fixpoints", 1)
    metrics.spmv_add("spmv_pull_iters" if use_pull else "spmv_push_iters", iters)
    return r, in_w, iters


# ---------------------------------------------------------------------------
# iterative CC and the k-core round


def cc_fixpoint(parent, seen, src, dst, mask):
    """Connected-components hooking on the min-min semiring to the array
    fixed point parent[v] = min vertex id of v's component, fully
    compressed: ``ops/unionfind.union_edges_with_seen`` (the CUDA
    ``union_kernel`` on the card).  Updates ``parent`` and ``seen`` IN
    PLACE (the inputs are consumed) and returns them."""
    return uf.union_edges_with_seen(parent, seen, src, dst, mask)


def kcore_round_plain(c: torch.Tensor, keys: torch.Tensor, nbrs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One h-index update of one bucket (the JAX step): each row's h-index
    of ``c[nbrs]`` over its valid entries (the largest h with at least h
    entries >= h), scatter-min at the keys.  A new tensor."""
    n = c.shape[0]
    if keys.shape[0] == 0:
        return c.clone()
    vals = torch.where(valid, c[indexing.gather_index(nbrs, n)], 0)
    s = torch.sort(vals, dim=1, descending=True).values
    ranks = torch.arange(1, s.shape[1] + 1, dtype=s.dtype, device=s.device)
    h = torch.where(s >= ranks, ranks, 0).amax(dim=1).to(torch.int32)
    return MIN_MIN.scatter(c, keys, h)


@_cuda.on_device_of("c")
def kcore_round(c: torch.Tensor, keys: torch.Tensor, nbrs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One h-index round of a bucket ``(keys [K], nbrs [K, D], valid
    [K, D])``, D a power of two, into the estimates ``c`` IN PLACE;
    returns ``c``.  Every row reads the estimates as they stood before the
    bucket.  One ``kcore_round_launch`` on CUDA tensors."""
    _check_estimates(c)
    keys, nbrs, valid = keys.contiguous(), nbrs.contiguous(), valid.contiguous()
    _check_bucket(c, keys, nbrs, valid)
    k, d = nbrs.shape
    if c.device.type == "cpu":
        return c.copy_(kcore_round_plain(c, keys, nbrs, valid))
    if c.device.type != "cuda":
        raise ValueError(f"no kcore_round_launch kernel for device {c.device}")
    if k == 0:
        return c
    lib = _cuda.library(_KCORE_SOURCE)
    h = torch.empty((k,), dtype=torch.int32, device=c.device)
    _cuda.check(
        lib.kcore_round_launch(
            c.data_ptr(), c.shape[0], keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, h.data_ptr(),
            _stream(c),
        ),
        "kcore_round_launch",
    )
    LAUNCHES["kcore_round"] += 1
    return c


def _check_estimates(c: torch.Tensor) -> None:
    if c.dtype != torch.int32 or c.dim() != 1 or not c.is_contiguous():
        raise ValueError("c must be a contiguous 1-D int32 tensor")


def _check_bucket(c: torch.Tensor, keys, nbrs, valid) -> None:
    for t, dtype, name in ((keys, torch.int32, "keys"), (nbrs, torch.int32, "nbrs"), (valid, torch.bool, "valid")):
        if t.dtype != dtype or t.device != c.device:
            raise ValueError(f"{name} must be a {dtype} tensor on c's device")
    if nbrs.dim() != 2 or nbrs.shape[0] != keys.shape[0] or valid.shape != nbrs.shape:
        raise ValueError("nbrs and valid must be [K, D] with K = len(keys)")
    d = nbrs.shape[1]
    if d <= 0 or d & (d - 1):
        raise ValueError(f"the bucket width {d} must be a power of two")


def kcore_fixpoint_plain(c: torch.Tensor, buckets, max_rounds: int, round_fn=None) -> tuple:
    """The JAX host loop: a round updates every bucket in order with
    ``round_fn(c, keys, nbrs, valid)`` (in place; default the twin,
    ``kcore_round_plain``), until a round changes nothing or ``max_rounds``
    ran.  Updates ``c`` in place; returns (rounds run, whether the last
    changed nothing)."""
    for rounds in range(1, max_rounds + 1):
        prev = c.clone()
        for keys, nbrs, valid in buckets:
            if round_fn is None:
                c.copy_(kcore_round_plain(c, keys, nbrs, valid))
            else:
                round_fn(c, keys, nbrs, valid)
        if torch.equal(c, prev):
            return rounds, True
    return max_rounds, False


def _kcore_table(buckets, device) -> torch.Tensor:
    """The buckets ``[(keys, nbrs, valid), ...]`` as ``kcore_fixpoint_launch``
    reads them: int64 [B, 4] on ``device``, a row (keys, nbrs, valid as
    pointers, k | d << 32).  The tensors must stay alive while it is used."""
    rows = [[keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), keys.shape[0] | nbrs.shape[1] << 32]
            for keys, nbrs, valid in buckets]
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 4).to(device)


@_cuda.on_device_of("table")
def _kcore_fixpoint_launch(c: torch.Tensor, table: torch.Tensor, max_rounds: int) -> torch.Tensor:
    """Enqueue one ``kcore_fixpoint_launch`` over a ``_kcore_table`` with no
    host sync; returns its header (int32: rounds run, converged, H or -1
    for no cap, the blocks it ran).  Rows must hold distinct neighbours (a
    simple graph's buckets): values are capped at the h-index of the
    starting estimates, and nothing checks it."""
    if c.device.type != "cuda":
        raise ValueError(f"no kcore_fixpoint_launch kernel for device {c.device}")
    lib = _cuda.library(_KCORE_SOURCE)
    nbytes = lib.kcore_fixpoint_scratch_bytes(c.shape[0])
    if nbytes < 0:
        raise RuntimeError("kcore_fixpoint_scratch_bytes: the occupancy query failed")
    scratch = torch.empty(((nbytes + 3) // 4,), dtype=torch.int32, device=c.device)
    _cuda.check(
        lib.kcore_fixpoint_launch(
            c.data_ptr(), c.shape[0], table.data_ptr(), table.shape[0], int(max_rounds), scratch.data_ptr(),
            scratch.numel() * 4, _stream(c),
        ),
        "kcore_fixpoint_launch",
    )
    LAUNCHES["kcore_fixpoint"] += 1
    return scratch[:_CORE_HEADER_INTS]


def _kcore_fixpoint(c: torch.Tensor, buckets, max_rounds: int) -> tuple:
    """The k-core h-index fixed point over a pane's buckets ``[(keys [K],
    nbrs [K, D], valid [K, D]), ...]`` (D powers of two), taken in the
    given order, into the estimates ``c`` IN PLACE: Jacobi within a bucket,
    Gauss-Seidel across buckets, rounds until one changes nothing or
    ``max_rounds`` ran.  Returns (rounds run, whether the last changed
    nothing).  One ``kcore_fixpoint_launch`` on CUDA tensors and one read
    of its header; the twin's loop on CPU tensors.  Every row's neighbours
    must be distinct ids in [0, C): the card caps values at the h-index of
    the starting estimates, which a repeated neighbour can exceed, and the
    twin does not, so the two would differ.  ``library/kcore.pane_cores``,
    the one caller, guarantees it."""
    _check_estimates(c)
    buckets = [(keys.contiguous(), nbrs.contiguous(), valid.contiguous()) for keys, nbrs, valid in buckets]
    for keys, nbrs, valid in buckets:
        _check_bucket(c, keys, nbrs, valid)
    if c.device.type == "cpu":
        return kcore_fixpoint_plain(c, buckets, int(max_rounds))
    rounds, converged = _kcore_fixpoint_launch(c, _kcore_table(buckets, c.device), max_rounds)[:2].tolist()
    return rounds, bool(converged)


# ---------------------------------------------------------------------------
# config/env resolution (the shared tri-state contract, utils/envswitch.py)


def resolve_direction(cfg) -> str:
    """cfg.spmv_direction ("" defers) > GELLY_SPMV_DIRECTION > auto;
    unrecognized spellings refuse loudly."""
    return resolve_choice(cfg.spmv_direction, "GELLY_SPMV_DIRECTION", DIRECTIONS, "auto")


def resolve_threshold(cfg) -> float:
    """cfg.direction_threshold (-1 defers) > GELLY_DIRECTION_THRESHOLD >
    :data:`DEFAULT_DIRECTION_THRESHOLD`; non-density env values refuse
    loudly."""
    if cfg.direction_threshold != -1.0:
        return float(cfg.direction_threshold)
    env = os.environ.get("GELLY_DIRECTION_THRESHOLD")
    if env is None:
        return DEFAULT_DIRECTION_THRESHOLD
    try:
        val = float(env.strip())
    except ValueError:
        raise ValueError(f"GELLY_DIRECTION_THRESHOLD={env!r} is not a float density") from None
    if not 0.0 <= val <= 1.0:
        raise ValueError(f"GELLY_DIRECTION_THRESHOLD={env!r} must be in [0, 1]")
    return val
