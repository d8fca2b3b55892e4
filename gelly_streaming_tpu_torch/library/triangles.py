"""Windowed exact triangle count.

Port of the windowed half of ``gelly_streaming_tpu/library/triangles.py``
(reference example/WindowTriangles.java:50-65).  Per closed pane:

* panes whose (compacted) vertex count fits ``_dense_pane_bound`` ship as
  4 B/edge packed words and are counted by the two CUDA kernels of
  ``ops/dense_triangles.py`` (bitset adjacency, then sum(A * A^2) / 6);
* larger panes take the CSR path: for every deduped canonical edge
  (u, v), |N(u) & N(v)|, summed and divided by 3, by the CUDA kernel of
  ``ops/csr_triangles.py`` (whose plain twin is the JAX package's padded
  table and [E, D, D] masked equality reduction).

Three planes, as in the JAX package: the synchronous loop (one pane in
flight ahead of the readback), the asynchronous window pipeline
(``cfg.async_windows`` or ``GELLY_ASYNC_WINDOWS`` > 0: ``core/async_exec.
pipelined``, panes prepared and uploaded on the prefetcher's threads, up
to that many counts in flight), and the superbatch plane (``cfg.superbatch``
> 1: up to K panes' canonical edges counted by one ``csr_triangles``
launch).

Streaming variant (insertion-only; reference
example/ExactTriangleCount.java:43-134): ``ExactTriangleCount`` folds each
batch into a device neighbor table plus per-vertex and global counters by
the kernels of ``ops/exact_triangles.py`` (``csrc/exact_triangles.cu``):
in chunks of 64 edges by default (``mode="block"``, one record block a
batch of the counters it touched, then the global under key -1), or one
edge a step with the reference's per-edge trace (``mode="trace"``).
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch

from gelly_streaming_tpu_torch.core import async_exec
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.output import OutputStream, RecordBlock
from gelly_streaming_tpu_torch.core.windows import group_panes, pow2, row_mask, stack_rows, validate_slide, windowed_panes
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.io.prefetch import Prefetcher, upload
from gelly_streaming_tpu_torch.ops import csr_triangles, dense_triangles
from gelly_streaming_tpu_torch.ops import neighbors as nbr_ops
from gelly_streaming_tpu_torch.ops.exact_triangles import (
    TriangleCountState,
    triangle_update,
    triangle_update_block,
)


# Panes whose compacted vertex count fits this bound take the dense CUDA
# kernels; the bitset adjacency is K^2/8 bytes (8 MB at 8192).  On the CPU
# the plain twins unpack to a float64 [K, K] matmul, so the dense path is
# kept small there (the same split as the JAX package's TPU / interpreter
# bounds, which the CPU parity tests rely on).
DENSE_PANE_MAX_VERTICES = 8192
DENSE_PANE_MAX_VERTICES_CPU = 512


def _dense_pane_bound(device: torch.device) -> int:
    return (
        DENSE_PANE_MAX_VERTICES
        if device.type == "cuda"
        else DENSE_PANE_MAX_VERTICES_CPU
    )


def _unique_pairs(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """``np.unique(np.stack([lo, hi], 1), axis=0)`` (the same rows in the
    same order, int64), by a 1-D unique of one int64 key a pair, which
    sorts ~20x faster than the row-wise unique at 2^17 pairs."""
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    if len(lo) == 0:
        return np.zeros((0, 2), np.int64)
    lmin, hmin = int(lo.min()), int(hi.min())
    span = int(hi.max()) - hmin + 1
    if (int(lo.max()) - lmin + 1) * span >= 1 << 62:
        return np.unique(np.stack([lo, hi], axis=1), axis=0)
    key = np.unique((lo - lmin) * span + (hi - hmin))
    return np.stack([key // span + lmin, key % span + hmin], axis=1)


def _pane_prepare(pane, device: torch.device):
    """Host side of a pane submission: classify + pack, no device calls.

    Returns ``(meta, host_arrays)``: dense-eligible panes ship the packed
    words (``("packed", num_vertices)``, (int32 words, int32[1] n)); sparse
    id spaces are compacted here; panes past the dense bound ship their
    canonical compacted edges for the CSR path
    (``("csr", num_vertices, max_degree)``, (u, v))."""
    src, dst = pane
    if len(src) == 0:
        return ("const", 0), None
    bound = _dense_pane_bound(device)
    max_id = int(max(src.max(), dst.max()))
    if max_id < bound:
        # ids already fit the dense kernels: ship packed words and let the
        # device scatter canonicalize/dedup (no host unique)
        w, n = dense_triangles.pack_pane(src.astype(np.int32), dst.astype(np.int32))
        return ("packed", max_id + 1), dense_triangles.packed_host_arrays(w, n)
    # sparse id space: compact vertices on the host first
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    pairs = _unique_pairs(lo[keep], hi[keep])
    if len(pairs) == 0:
        return ("const", 0), None
    u, v = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    verts, inv = np.unique(np.concatenate([u, v]), return_inverse=True)
    cu, cv = inv[: len(u)].astype(np.int32), inv[len(u) :].astype(np.int32)
    k_n = len(verts)
    if k_n <= bound:
        w, n = dense_triangles.pack_pane(cu, cv)
        return ("packed", k_n), dense_triangles.packed_host_arrays(w, n)
    deg = np.bincount(np.concatenate([cu, cv]), minlength=k_n)
    return ("csr", k_n, int(deg.max())), (cu, cv)


def _pane_dispatch(meta, arrays):
    """Device side: dispatch a prepared pane (arrays already on the device),
    returning a handle for ``_pane_triangle_finish``."""
    if meta[0] == "const":
        return ("const", meta[1])
    if meta[0] == "packed":
        w, n = arrays
        return (
            "total",
            dense_triangles.pane_triangles_submit_packed(w, n, meta[1]),
        )
    _, k_n, d_max = meta
    cu, cv = arrays
    return (
        "scalar",
        dense_triangles.start_readback(_count_kernel_impl(cu, cv, k_n, d_max)),
    )


def _pane_triangle_submit(src: np.ndarray, dst: np.ndarray, device: torch.device):
    """Prepare, upload and dispatch a pane's count without waiting."""
    meta, arrays = _pane_prepare((src, dst), device)
    return _pane_dispatch(meta, upload(arrays, device))


def _pane_triangle_finish(handle) -> int:
    """Blocking fetch of a submitted pane count."""
    kind, payload = handle
    if kind == "const":
        return payload
    if kind == "total":
        return dense_triangles.triangles_from_total(payload)
    return dense_triangles.read_count(payload)


def _pane_triangle_count(src: np.ndarray, dst: np.ndarray, device: DeviceLike = None) -> int:
    """Exact triangles among a pane's edges (host orchestration, device count)."""
    return _pane_triangle_finish(
        _pane_triangle_submit(src, dst, resolve_device(device))
    )


def pipelined_pane_counts(
    panes,
    recorder=None,
    warmup: int = 0,
    depth: int = 2,
    device_recorder=None,
    device: DeviceLike = None,
):
    """Triangle counts for a sequence of (src, dst) panes with up to
    ``depth`` panes in flight: host packing and the upload run on the
    Prefetcher's two threads, so pane k+1's upload and compute overlap
    pane k's readback.  Returns the counts in pane order.

    ``recorder`` (a WindowLatencyRecorder) gets, per pane, the interval
    from the pane entering the pipeline to its count being on the host;
    ``device_recorder`` the interval to the device having produced it.
    Panes with index < ``warmup`` are not recorded.  With panes arriving
    back to back the intervals include queueing in the bounded prefetch
    queues: they are saturated-pipeline latencies and grow with ``depth``.
    """
    dev = resolve_device(device)
    counts = []
    pending = []  # (index, t_close, handle)
    enter_t = {}

    def stamped():
        for k, p in enumerate(panes):
            enter_t[k] = time.perf_counter()
            yield p

    def drain_one():
        k, t_close, handle = pending.pop(0)
        if device_recorder is not None and handle[0] != "const":
            dense_triangles.wait_device(handle[1])
            if k >= warmup:
                device_recorder.record((time.perf_counter() - t_close) * 1e3)
        counts.append(_pane_triangle_finish(handle))
        if recorder is not None and k >= warmup:
            recorder.record((time.perf_counter() - t_close) * 1e3)

    def prepare(pane):
        return _pane_prepare(pane, dev)

    with Prefetcher(stamped(), prepare, dev, depth=max(depth, 2)) as pf:
        for k, (meta, arrays) in enumerate(pf):
            t_close = enter_t.pop(k)
            pending.append((k, t_close, _pane_dispatch(meta, arrays)))
            if len(pending) >= depth:
                drain_one()
    while pending:
        drain_one()
    return counts


def _count_kernel_impl(
    u: torch.Tensor, v: torch.Tensor, num_vertices: int, max_deg: int
) -> torch.Tensor:
    """One pane's sum over edges |N(u) & N(v)| / 3 (int64 [], on u's
    device); ``u``/``v`` are the pane's deduped canonical edges.  The
    ``csr_triangles`` kernel over a single pane, its plain twin on CPU
    tensors."""
    ok = torch.ones((1, u.shape[0]), dtype=torch.bool, device=u.device)
    return csr_triangles.csr_triangles(u.reshape(1, -1), v.reshape(1, -1), ok, num_vertices, max_deg)[0]


def _superpane_canonical(pane_edges):
    """One pane's edges for the masked-CSR count: deduped undirected
    (lo, hi) pairs, self-loops dropped, ids compacted to the pane's vertex
    set (the host prep of ``_pane_prepare``'s CSR path): ``(cu, cv,
    num_vertices, max_degree)``, or None for a pane with no such edge."""
    src, dst = pane_edges
    if len(src) == 0:
        return None
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    keep = lo != hi
    pairs = _unique_pairs(lo[keep], hi[keep])
    if len(pairs) == 0:
        return None
    u, v = pairs[:, 0].astype(np.int32), pairs[:, 1].astype(np.int32)
    verts, inv = np.unique(np.concatenate([u, v]), return_inverse=True)
    cu = inv[: len(u)].astype(np.int32)
    cv = inv[len(u) :].astype(np.int32)
    deg = np.bincount(np.concatenate([cu, cv]), minlength=len(verts))
    return cu, cv, len(verts), int(deg.max())


def _superpane_rows(prepped):
    """A group's ``csr_triangles`` layout from its live panes'
    ``_superpane_canonical`` outputs: numpy (u, v, ok) [rows, E_pad] and
    (num_vertices, max_deg), rows, edges, vertex ids and degree bound each
    bucketed to a power of two as the JAX package shares its compiled
    shapes; rows past the live panes are fully masked."""
    e_pad = pow2(max(len(p[0]) for p in prepped))
    rows = pow2(len(prepped))
    u = stack_rows([p[0] for p in prepped], rows, e_pad, np.int32)
    v = stack_rows([p[1] for p in prepped], rows, e_pad, np.int32)
    ok = row_mask([len(p[0]) for p in prepped], rows, e_pad)
    return (u, v, ok), (pow2(max(p[2] for p in prepped)), pow2(max(p[3] for p in prepped)))


def _superbatched_window_counts(panes, k: int, device: torch.device):
    """(count, max_timestamp) per pane, up to ``k`` panes a ``csr_triangles``
    launch (``_superpane_rows``)."""
    # keep_empty: a pane with no edges still emits (0, max_timestamp)
    for group in group_panes(iter(panes), k, keep_empty=True):
        prepped = [_superpane_canonical((p.src, p.dst)) for p in group]
        live = [i for i, pr in enumerate(prepped) if pr is not None]
        counts = [0] * len(group)
        if live:
            arrays, (n_v, d_max) = _superpane_rows([prepped[i] for i in live])
            out = csr_triangles.csr_triangles(*upload(arrays, device), n_v, d_max).tolist()
            for row, i in enumerate(live):
                counts[i] = out[row]
        for i, pane in enumerate(group):
            yield counts[i], pane.max_timestamp


def window_triangles(
    stream, window_ms: int, slide_ms: Optional[int] = None
) -> OutputStream:
    """(triangle_count, window_max_timestamp) per closed pane, counted on
    the stream's device.

    Panes pipeline one deep: pane k+1 is uploaded and dispatched before
    pane k's count is fetched; the async and superbatch planes (module
    docstring) take over when the config asks for them.  ``slide_ms`` (a
    divisor of ``window_ms``) counts sliding windows by pane-sharing
    (core/windows.sliding_panes).
    """
    validate_slide(window_ms, slide_ms)
    device = stream.device
    depth = async_exec.resolve_depth(stream.cfg)
    if depth > 0 and stream.cfg.superbatch <= 1:
        # the asynchronous window pipeline: pane preparation on the pack
        # thread, uploads on the transfer thread, counts dispatched without
        # waiting and read back through the completion queue in window order
        def records_async() -> Iterator[tuple]:
            def prepare(pane):
                meta, arrays = _pane_prepare((pane.src, pane.dst), device)
                return (pane.max_timestamp, meta), arrays

            def dispatch(meta, arrays):
                return _pane_dispatch(meta[1], arrays)

            def finish(meta, handle):
                return (_pane_triangle_finish(handle), meta[0])

            yield from async_exec.pipelined(
                windowed_panes(stream, window_ms, slide_ms), prepare, dispatch, finish, depth, device,
                prefetch_depth=max(2, depth),
            )

        return OutputStream(records_async)

    if stream.cfg.superbatch > 1:
        # up to K panes counted by one masked-CSR launch
        def records_sb() -> Iterator[tuple]:
            yield from _superbatched_window_counts(
                windowed_panes(stream, window_ms, slide_ms), stream.cfg.superbatch, device
            )

        return OutputStream(records_sb)

    def records() -> Iterator[tuple]:
        pending = None  # (handle, timestamp) of the previous pane
        for pane in windowed_panes(stream, window_ms, slide_ms):
            try:
                handle = _pane_triangle_submit(pane.src, pane.dst, device)
            except BaseException:
                # pane k's count is already computed: deliver it before
                # propagating pane k+1's failure
                if pending is not None:
                    yield (_pane_triangle_finish(pending[0]), pending[1])
                    pending = None
                raise
            if pending is not None:
                yield (_pane_triangle_finish(pending[0]), pending[1])
            pending = (handle, pane.max_timestamp)
        if pending is not None:
            yield (_pane_triangle_finish(pending[0]), pending[1])

    return OutputStream(records)


# ---------------------------------------------------------------------------
# Streaming exact count (insertion-only)

GLOBAL_KEY = -1  # the reference routes the global counter under key -1
# (ExactTriangleCount.java:108-110)


def init_triangle_state(cfg: StreamConfig, device: DeviceLike = None) -> TriangleCountState:
    """An empty state on ``device``: the [C, D] neighbor table of
    ``cfg.vertex_capacity`` x ``cfg.max_degree``, zero counters."""
    dev = resolve_device(device)
    return TriangleCountState(
        table=nbr_ops.init_table(cfg.vertex_capacity, cfg.max_degree, dev),
        local=torch.zeros((cfg.vertex_capacity,), dtype=torch.int32, device=dev),
        global_count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def touched_block(state: TriangleCountState, prev_local: torch.Tensor, batch) -> RecordBlock:
    """One batch's records in block mode: (touched ascending, their
    counts), then (-1, global), int64 columns.  Touched are the batch's
    valid endpoints (raw ids) and every vertex whose counter moved since
    ``prev_local``, formed on the device; only the block is read back.  An
    id at or past C, or below -C, raises ``IndexError`` as the JAX
    package's host indexing does; one in [-C, 0) reads from the end."""
    local = state.local
    capacity = local.shape[0]
    m = batch.mask
    touched = torch.unique(torch.cat([
        batch.src[m].to(torch.int64), batch.dst[m].to(torch.int64),
        (local != prev_local).nonzero().squeeze(1),
    ]))
    bad = (touched >= capacity) | (touched < -capacity)
    if bool(bad.any()):
        first = int(touched[bad][0])
        raise IndexError(f"index {first} is out of bounds for axis 0 with size {capacity}")
    counts = local[torch.where(touched < 0, touched + capacity, touched)]
    keys = torch.cat([touched, torch.full((1,), GLOBAL_KEY, dtype=torch.int64, device=local.device)])
    counts = torch.cat([counts.to(torch.int64), state.global_count.reshape(1).to(torch.int64)])
    return RecordBlock((keys.cpu().numpy(), counts.cpu().numpy()))


class ExactTriangleCount:
    """Continuous (key, count) updates, key -1 the global count
    (reference example/ExactTriangleCount.java:40-207).

    ``mode="block"`` (default) folds each batch in chunks
    (``triangle_update_block``) and emits one block a batch: the running
    counts of the vertices it touched, ascending, then the global.
    ``mode="trace"`` folds one edge a step (``triangle_update``) and emits
    the reference's per-edge records (u, local_u), (v, local_v), (-1,
    global) for every valid edge, u < v.  The state lives on the stream's
    device; ``final_state`` holds it after a run."""

    def __init__(self, cfg: Optional[StreamConfig] = None, mode: str = "block"):
        if mode not in ("trace", "block"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode

    def run(self, stream) -> OutputStream:
        if self.mode == "block":
            return self._run_blocks(stream)

        def records():
            state = init_triangle_state(stream.cfg, stream.device)
            for batch in stream.batches():
                state, local_trace, global_trace = triangle_update(state, batch.src, batch.dst, batch.mask)
                l_h = local_trace.cpu().numpy()
                g_h = global_trace.cpu().numpy()
                m_h = batch.mask.cpu().numpy()
                s_h = batch.src.cpu().numpy()
                d_h = batch.dst.cpu().numpy()
                for i in np.nonzero(m_h)[0]:
                    u, v = int(min(s_h[i], d_h[i])), int(max(s_h[i], d_h[i]))
                    yield (u, int(l_h[i, 0]))
                    yield (v, int(l_h[i, 1]))
                    yield (GLOBAL_KEY, int(g_h[i]))
            self.final_state = state

        return OutputStream(records)

    def _run_blocks(self, stream) -> OutputStream:
        def blocks():
            state = init_triangle_state(stream.cfg, stream.device)
            prev_local = state.local.clone()
            for batch in stream.batches():
                state = triangle_update_block(state, batch.src, batch.dst, batch.mask)
                block = touched_block(state, prev_local, batch)
                prev_local.copy_(state.local)
                yield block
            self.final_state = state

        return OutputStream(blocks_fn=blocks)
