"""The streaming exact triangle fold: the wrappers of ``csrc/exact_triangles.cu``
and their plain twins.

Replaces the two XLA loops of ``gelly_streaming_tpu/library/triangles.py``
that fold an edge batch into the insertion-only triangle state (an
undirected neighbor table over the whole stream, per-vertex counters and
the global count; reference example/ExactTriangleCount.java:74-134):

* ``triangle_update`` (``:450-501``): a ``lax.scan`` over the batch, one
  edge a step.  A duplicate (already in lo's row, or lo == hi) is
  ignored; otherwise c = |N(lo) & N(hi)| over the table so far (with
  multiplicity), local[lo] and local[hi] += c, local[w] += 1 for every
  slot w of lo's row that has a match, global += c, and the edge is
  inserted in both directions.  It also returns the per-edge trace
  (local[lo], local[hi]) [B, 2] and the running global [B].
* ``triangle_update_block`` (``:504-622``): the same fold in chunks of
  ``r = min(chunk, B)`` edges: old-old terms over the endpoints' rows,
  old-new terms (one wedge edge earlier in the chunk, the other in the
  table) and new-new terms (both earlier in the chunk), then the chunk's
  insert.  Rows that overflow make the table a multiset and asymmetric,
  so the two modes reach different states once a row is full.

On CUDA tensors each wrapper is one C call a batch: the batch is folded
in parallel against arrival-stamped rows (its entries radix-sorted by row,
the repeats' fixed point by segmented scans, the slots written, then every
edge counted alone against its rows as its chunk found them; the trace by
a sort and scan of the counters' moves), spread over the card's SMs.  A
batch with an id outside [0, C) on an edge that counts, or an odd
pre-batch row, takes the one-block chunk walk instead, chosen on the
device (``stats`` counts the batches of each path and the fixed point's
passes).  A call's scratch, of the bytes the C library's
``exact_scratch_bytes`` gives, is allocated once a shape and reused.
``LAUNCHES`` counts the C calls, ``TWIN_CALLS`` the wrappers'
calls of a twin.  On CPU tensors the wrappers run the plain twins, which
copy the JAX functions step by step (on a clone of the state, updated in
place chunk by chunk).  Ids outside [0, C) follow JAX's index rules
(``ops/indexing.py``) in both.

Both wrappers update the state's tensors in place and return the state.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from gelly_streaming_tpu_torch.ops import _cuda, indexing, segments
from gelly_streaming_tpu_torch.ops import neighbors as nbr_ops

_SOURCE = "exact_triangles.cu"
MAX_CHUNK = 256  # the kernels' chunk bound (a chunk in one block's shared memory)
SCRATCH_CACHE = 8  # scratch buffers kept (one a shape and stream)

# C calls since the last reset_launches() (CUDA tensors only), and the
# wrappers' twin calls (CPU tensors only)
LAUNCHES: Dict[str, int] = {"triangle_block": 0, "triangle_trace": 0}
TWIN_CALLS: Dict[str, int] = {"triangle_block": 0, "triangle_trace": 0}
_scratch: Dict[tuple, torch.Tensor] = {}
_stats: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


def stats(device) -> Dict[str, int]:
    """The CUDA calls' counters on ``device`` since the last reset_stats():
    batches folded in parallel, batches the chain kernel took, the fixed
    point's passes summed and the most in one batch (synchronizes)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _stats.get(dev)
    vals = [0, 0, 0, 0] if t is None else t.tolist()
    return dict(zip(("parallel", "chain", "passes", "max_passes"), vals))


def reset_stats() -> None:
    for t in _stats.values():
        t.zero_()


def _call_buffers(src: torch.Tensor, n: int, capacity: int, max_degree: int, r: int, trace: bool):
    """(scratch, its bytes, stats) of a C call: the scratch kept for its
    shape and stream, the counters for its device."""
    dev = src.device
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream, n, capacity, max_degree, r, trace)
    buf = _scratch.get(key)
    if buf is None:
        nbytes = int(_cuda.library(_SOURCE).exact_scratch_bytes(n, capacity, max_degree, r, int(trace)))
        if nbytes <= 0:
            raise ValueError(f"no triangle fold for {n} edges at D = {max_degree} (its items pass 2^31)")
        if len(_scratch) >= SCRATCH_CACHE:
            _scratch.clear()
        buf = _scratch[key] = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    st = _stats.get(dev)
    if st is None:
        st = _stats[dev] = torch.zeros((4,), dtype=torch.int32, device=dev)
    return buf, buf.numel(), st


class TriangleCountState(NamedTuple):
    table: nbr_ops.NeighborTable  # undirected adjacency over the whole stream
    local: torch.Tensor  # int32[C] per-vertex triangle counts
    global_count: torch.Tensor  # int32[]


def clone_state(state: TriangleCountState) -> TriangleCountState:
    return TriangleCountState(
        nbr_ops.NeighborTable(*(t.clone() for t in state.table)), state.local.clone(), state.global_count.clone()
    )


def _copy_into(state: TriangleCountState, new: TriangleCountState) -> TriangleCountState:
    for dst, src in zip((*state.table, state.local, state.global_count), (*new.table, new.local, new.global_count)):
        dst.copy_(src)
    return state


def _check(state: TriangleCountState, src, dst, mask) -> None:
    nbrs, deg, dropped = state.table
    dev = nbrs.device
    if nbrs.dtype != torch.int32 or nbrs.dim() != 2 or not nbrs.is_contiguous():
        raise ValueError("table.nbrs must be a contiguous int32 [C, D] tensor")
    capacity, max_degree = nbrs.shape
    for t, name, shape in ((deg, "table.deg", (capacity,)), (dropped, "table.dropped", ()),
                           (state.local, "local", (capacity,)), (state.global_count, "global_count", ())):
        if t.dtype != torch.int32 or tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int32 tensor of shape {shape} on {dev}")
    for t, name, dtype in ((src, "src", torch.int32), (dst, "dst", torch.int32), (mask, "mask", torch.bool)):
        if t.dtype != dtype or t.dim() != 1 or t.shape != src.shape or t.device != dev:
            raise ValueError(f"{name} must be a 1-D {dtype} tensor on {dev} with src's length")
    if capacity < 1 or max_degree < 1 or capacity * max_degree >= 1 << 31:
        raise ValueError("the table needs C, D >= 1 and C * D < 2^31 slots (JAX's int32 slot index)")


def _scatter_add(local: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> None:
    indexing.scatter_add_(local, idx.reshape(-1), values.reshape(-1).to(torch.int32))


# ---------------------------------------------------------------------------
# plain twins
#
# Each twin clones the state once, holds the table as a flat buffer with a
# sink slot (``neighbors.insert_flat_``) and runs one in-place step an edge
# or a chunk.  A step waits on nothing (no data-dependent shape, its index
# a device counter), so on CUDA tensors it is replayed from one captured
# CUDA graph: the same ops, without the host's cost of launching each
# (tens of small ops a step; eager, a 2^16-edge batch takes seconds).


def _steps(step, n: int, device: torch.device) -> None:
    """Run ``step`` ``n`` times: on the CPU eagerly; on CUDA the first
    call eagerly on a side stream, the rest as replays of one CUDA graph
    of it."""
    if device.type != "cuda" or n <= 1:
        for _ in range(n):
            step()
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    for _ in range(n - 1):
        graph.replay()


def _twin_buffers(state: TriangleCountState):
    capacity, max_degree = state.table.nbrs.shape
    flat = nbr_ops.flat_with_sink(state.table.nbrs)
    table = nbr_ops.NeighborTable(flat[: capacity * max_degree].view(capacity, max_degree),
                                  state.table.deg.clone(), state.table.dropped.clone())
    return flat, table, state.local.clone(), state.global_count.clone()


def triangle_update_plain(
    state: TriangleCountState, src, dst, mask
) -> Tuple[TriangleCountState, torch.Tensor, torch.Tensor]:
    """The JAX ``triangle_update``, edge by edge: (new state, local trace
    int32 [B, 2], global trace int32 [B])."""
    dev = src.device
    flat, table, local, glob = _twin_buffers(state)
    capacity, max_degree = table.nbrs.shape
    b = src.shape[0]
    local_trace = torch.empty((b, 2), dtype=torch.int32, device=dev)
    global_trace = torch.empty((b,), dtype=torch.int32, device=dev)
    slots = torch.arange(max_degree, device=dev)
    e = torch.zeros((1,), dtype=torch.int64, device=dev)

    def step():
        u, v, ok = src.index_select(0, e), dst.index_select(0, e), mask.index_select(0, e)  # [1] each
        lo = torch.minimum(u, v)
        hi = torch.maximum(u, v)
        dup = nbr_ops.contains_batch(table, lo, hi) | (lo == hi)
        ok = ok & ~dup
        glo, ghi = indexing.gather_index(lo, capacity), indexing.gather_index(hi, capacity)
        row_u, row_v = table.nbrs[glo][0], table.nbrs[ghi][0]
        valid_u = slots < table.deg[glo]
        valid_v = slots < table.deg[ghi]
        eq = (row_u[:, None] == row_v[None, :]) & valid_u[:, None] & valid_v[None, :]
        c = torch.where(ok, eq.sum(dtype=torch.int32), 0)  # [1]
        common = eq.any(dim=1) & ok  # [D] over row_u slots
        _scatter_add(local, torch.where(common, row_u, 0), common)
        _scatter_add(local, lo, c)
        _scatter_add(local, hi, c)
        glob.add_(c[0])
        nbr_ops.insert_flat_(flat, table.deg, table.dropped, max_degree, torch.cat([lo, hi]), torch.cat([hi, lo]),
                             torch.cat([ok, ok]))
        local_trace.index_copy_(0, e, local[indexing.gather_index(torch.cat([lo, hi]), capacity)][None])
        global_trace.index_copy_(0, e, glob.reshape(1))
        e.add_(1)

    _steps(step, b, dev)
    return TriangleCountState(table, local, glob), local_trace, global_trace


def _chunk_rows(b: int, chunk: int) -> Tuple[int, int]:
    """(r, padded length): the JAX function's chunk and its padding."""
    r = min(chunk, b)
    return r, b + (-b) % r


def triangle_update_block_plain(state: TriangleCountState, src, dst, mask, chunk: int = 64) -> TriangleCountState:
    """The JAX ``triangle_update_block``, chunk by chunk: the new state."""
    dev = src.device
    flat, table, local, glob = _twin_buffers(state)
    capacity, max_degree = table.nbrs.shape
    b = src.shape[0]
    r, padded = _chunk_rows(b, chunk)
    pad = padded - b
    if pad:
        zeros = torch.zeros((pad,), dtype=src.dtype, device=dev)
        src, dst = torch.cat([src, zeros]), torch.cat([dst, zeros])
        mask = torch.cat([mask, torch.zeros((pad,), dtype=torch.bool, device=dev)])
    lo_all = torch.minimum(src, dst).reshape(-1, r)
    hi_all = torch.maximum(src, dst).reshape(-1, r)
    ok_all = (mask & (torch.minimum(src, dst) != torch.maximum(src, dst))).reshape(-1, r)
    lower = torch.tril(torch.ones((r, r), dtype=torch.bool, device=dev), -1)  # [j, i]: i < j
    k = torch.zeros((1,), dtype=torch.int64, device=dev)

    def step():
        lo, hi, ok = (t.index_select(0, k)[0] for t in (lo_all, hi_all, ok_all))
        ok = ok & ~nbr_ops.contains_batch(table, lo, hi) & segments.first_occurrence_mask_pairs(lo, hi, ok)
        row_lo, valid_lo = nbr_ops.gather_rows(table, lo)  # [r, D]
        row_hi, valid_hi = nbr_ops.gather_rows(table, hi)

        # old-old: [r, D, D]
        eq = (row_lo[:, :, None] == row_hi[:, None, :]) & valid_lo[:, :, None] & valid_hi[:, None, :]
        c1 = torch.where(ok, eq.sum(dim=(1, 2), dtype=torch.int32), 0)
        common1 = eq.any(dim=2) & ok[:, None]  # marks on row_lo slots

        # pair geometry among chunk edges: does e_i touch e_j's endpoints?
        pair_ok = lower & ok[:, None] & ok[None, :]  # [j, i]
        i_lo, i_hi = lo[None, :], hi[None, :]
        shares_lo = (i_lo == lo[:, None]) | (i_hi == lo[:, None])
        shares_hi = (i_lo == hi[:, None]) | (i_hi == hi[:, None])
        w_lo = torch.where(i_lo == lo[:, None], i_hi, i_lo)  # other end of e_i
        w_hi = torch.where(i_lo == hi[:, None], i_hi, i_lo)

        def member(rows, valid, w):  # [j, D] rows vs [j, i] queries
            return ((rows[:, None, :] == w[:, :, None]) & valid[:, None, :]).any(dim=2)

        # old-new: wedge edge e_i in the chunk (earlier), its mate in the table
        c2a = pair_ok & shares_lo & member(row_hi, valid_hi, w_lo)
        c2b = pair_ok & shares_hi & member(row_lo, valid_lo, w_hi)
        c2 = c2a.sum(dim=1, dtype=torch.int32) + c2b.sum(dim=1, dtype=torch.int32)

        # new-new: e_i (with lo_j) and e_k (with hi_j), both earlier, meeting at w
        a3 = pair_ok & shares_lo
        b3 = pair_ok & shares_hi
        cond3 = a3[:, :, None] & b3[:, None, :] & (w_lo[:, :, None] == w_hi[:, None, :])
        c3 = cond3.sum(dim=(1, 2), dtype=torch.int32)
        w3_weight = cond3.sum(dim=2, dtype=torch.int32)  # per (j, i): marks on w_lo[j, i]

        c = c1 + c2 + c3
        _scatter_add(local, torch.where(common1, row_lo, 0), common1)
        _scatter_add(local, torch.where(c2a, w_lo, 0), c2a)
        _scatter_add(local, torch.where(c2b, w_hi, 0), c2b)
        _scatter_add(local, torch.where(w3_weight > 0, w_lo, 0), w3_weight)
        _scatter_add(local, torch.where(ok, lo, 0), torch.where(ok, c, 0))
        _scatter_add(local, torch.where(ok, hi, 0), torch.where(ok, c, 0))
        glob.add_(c.sum(dtype=torch.int32))
        nbr_ops.insert_flat_(flat, table.deg, table.dropped, max_degree, torch.cat([lo, hi]), torch.cat([hi, lo]),
                             torch.cat([ok, ok]))
        k.add_(1)

    _steps(step, padded // r, dev)
    return TriangleCountState(table, local, glob)


# ---------------------------------------------------------------------------
# wrappers


def _launch_args(state: TriangleCountState, src, dst, mask) -> tuple:
    """The C calls' leading arguments (src, dst, mask contiguous)."""
    nbrs, deg, dropped = state.table
    capacity, max_degree = nbrs.shape
    return (nbrs.data_ptr(), deg.data_ptr(), dropped.data_ptr(), state.local.data_ptr(),
            state.global_count.data_ptr(), src.data_ptr(), dst.data_ptr(), mask.data_ptr(), src.shape[0],
            capacity, max_degree)


def _require_cuda(t: torch.Tensor, kernel: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {t.device}")


@_cuda.on_device_of("src")
def triangle_update(
    state: TriangleCountState, src, dst, mask
) -> Tuple[TriangleCountState, torch.Tensor, torch.Tensor]:
    """Fold an edge batch edge by edge; returns (state, local trace int32
    [B, 2], global trace int32 [B]), the state updated in place."""
    _check(state, src, dst, mask)
    if src.device.type == "cpu":
        new, local_trace, global_trace = triangle_update_plain(state, src, dst, mask)
        TWIN_CALLS["triangle_trace"] += 1
        return _copy_into(state, new), local_trace, global_trace
    _require_cuda(src, "triangle_trace")
    b = src.shape[0]
    local_trace = torch.empty((b, 2), dtype=torch.int32, device=src.device)
    global_trace = torch.empty((b,), dtype=torch.int32, device=src.device)
    if b:
        src, dst, mask = src.contiguous(), dst.contiguous(), mask.contiguous()
        scratch, nbytes, counters = _call_buffers(src, b, *state.table.nbrs.shape, 1, True)
        _cuda.check(_cuda.library(_SOURCE).triangle_trace_launch(
            *_launch_args(state, src, dst, mask), local_trace.data_ptr(), global_trace.data_ptr(),
            scratch.data_ptr(), nbytes, counters.data_ptr(), torch.cuda.current_stream(src.device).cuda_stream),
            "triangle_trace")
        LAUNCHES["triangle_trace"] += 1
    return state, local_trace, global_trace


@_cuda.on_device_of("src")
def triangle_update_block(state: TriangleCountState, src, dst, mask, chunk: int = 64) -> TriangleCountState:
    """Fold an edge batch in chunks of ``min(chunk, B)`` edges (the same
    final state as ``triangle_update`` while no row overflows); returns
    the state, updated in place."""
    _check(state, src, dst, mask)
    if chunk < 1:
        raise ValueError("chunk must be positive")
    r, _ = _chunk_rows(src.shape[0], chunk)
    if src.device.type == "cpu":
        TWIN_CALLS["triangle_block"] += 1
        return _copy_into(state, triangle_update_block_plain(state, src, dst, mask, chunk))
    _require_cuda(src, "triangle_block")
    if r > MAX_CHUNK:
        raise ValueError(f"the triangle_block kernel takes chunks of at most {MAX_CHUNK} edges")
    src, dst, mask = src.contiguous(), dst.contiguous(), mask.contiguous()
    scratch, nbytes, counters = _call_buffers(src, src.shape[0], *state.table.nbrs.shape, r, False)
    _cuda.check(_cuda.library(_SOURCE).triangle_block_launch(
        *_launch_args(state, src, dst, mask), r, scratch.data_ptr(), nbytes, counters.data_ptr(),
        torch.cuda.current_stream(src.device).cuda_stream), "triangle_block")
    LAUNCHES["triangle_block"] += 1
    return state
