"""Windowed exact triangle count.

Port of the windowed half of ``gelly_streaming_tpu/library/triangles.py``
(reference example/WindowTriangles.java:50-65).  Per closed pane:

* panes whose (compacted) vertex count fits ``_dense_pane_bound`` ship as
  4 B/edge packed words and are counted by the two CUDA kernels of
  ``ops/dense_triangles.py`` (bitset adjacency, then sum(A * A^2) / 6);
* larger panes take the padded-CSR path: a neighbor table of the deduped
  undirected edges and, for every canonical edge (u, v), |N(u) & N(v)|
  from one [E, D, D] masked equality reduction; the sum / 3 is the count.

The ``cfg.async_windows > 0`` and ``cfg.superbatch > 1`` planes and the
streaming ``ExactTriangleCount`` are not ported yet and raise
``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Iterator, Optional

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.output import OutputStream
from gelly_streaming_tpu_torch.core.windows import validate_slide, windowed_panes
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.io.prefetch import Prefetcher, upload
from gelly_streaming_tpu_torch.ops import dense_triangles
from gelly_streaming_tpu_torch.ops import neighbors as nbr_ops


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
    pairs = np.unique(np.stack([lo[keep], hi[keep]], axis=1), axis=0)
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
    """sum over edges |N(u) & N(v)| / 3 with a padded-CSR equality
    reduction; ``u``/``v`` are the pane's deduped canonical edges."""
    e = u.shape[0]
    table = nbr_ops.init_table(num_vertices, max_deg, u.device)
    both_src = torch.cat([u, v])
    both_dst = torch.cat([v, u])
    table = nbr_ops.insert_batch(
        table,
        both_src,
        both_dst,
        torch.ones((2 * e,), dtype=torch.bool, device=u.device),
    )
    rows_u, valid_u = nbr_ops.gather_rows(table, u)  # [E, D]
    rows_v, valid_v = nbr_ops.gather_rows(table, v)
    eq = (
        (rows_u[:, :, None] == rows_v[:, None, :])
        & valid_u[:, :, None]
        & valid_v[:, None, :]
    )
    return eq.sum(dtype=torch.int64) // 3


def window_triangles(
    stream, window_ms: int, slide_ms: Optional[int] = None
) -> OutputStream:
    """(triangle_count, window_max_timestamp) per closed pane, counted on
    the stream's device.

    Panes pipeline one deep: pane k+1 is uploaded and dispatched before
    pane k's count is fetched.  ``slide_ms`` (a divisor of ``window_ms``)
    counts sliding windows by pane-sharing (core/windows.sliding_panes).
    """
    validate_slide(window_ms, slide_ms)
    if stream.cfg.async_windows > 0:
        raise NotImplementedError(
            "window_triangles: the asynchronous window pipeline "
            "(cfg.async_windows > 0) is not ported yet"
        )
    if stream.cfg.superbatch > 1:
        raise NotImplementedError(
            "window_triangles: superbatch dispatch (cfg.superbatch > 1) is "
            "not ported yet"
        )
    device = stream.device

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
