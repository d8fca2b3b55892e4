"""Edge sources: edge-list files, batched host arrays and generated streams.

Port of the parts of ``gelly_streaming_tpu/io/sources.py`` the ported
slices use.  ``parse_edge_file`` takes the native parser of the port's
host library (``utils/native.py``) when it loads, across the ingest pool
(io/ingest.py) when asked for more than one worker, else the numpy
fallback; all three return the same arrays.  ``file_stream`` parses across
the pool by default, as the JAX package's does.  The network source is not
ported.
"""

from __future__ import annotations

import itertools
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream
from gelly_streaming_tpu_torch.core.types import EdgeBatch
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.io.interning import IdentityInterner, VertexInterner
from gelly_streaming_tpu_torch.utils import native


def parse_edge_file(path: str, workers: int = 1):
    """Parse an edge-list file into host arrays.

    Returns (src i64, dst i64, val f64 | None, time i64 | None, sign i32 |
    None).  Format per line: ``src dst [value|+|-] [timestamp]`` with
    space/tab/comma separators and #/% comments.

    ``workers`` > 1 (or 0 = auto: GELLY_INGEST_WORKERS, else the usable
    cores) shards the file into byte ranges parsed concurrently by the
    ingest pool (io/ingest.py); the arrays are the same.  One worker takes
    the native parser when the library loads, else the numpy fallback.
    """
    from gelly_streaming_tpu_torch.io import ingest

    if workers != 1:
        return ingest.parse_edge_file_parallel(path, workers)
    lib = native.load_ingest_lib()
    if lib is not None:
        n = lib.count_rows(path.encode())
        if n < 0:
            raise FileNotFoundError(path)
        src = np.empty(n, np.int64)
        dst = np.empty(n, np.int64)
        val = np.empty(n, np.float64)
        tim = np.empty(n, np.int64)
        sign = np.empty(n, np.int32)
        ncols = np.zeros(1, np.int32)
        rows = lib.fill_edges(path.encode(), src.ctypes.data, dst.ctypes.data, val.ctypes.data, tim.ctypes.data,
                              sign.ctypes.data, n, ncols.ctypes.data)
        if rows < 0:
            raise IOError(f"failed to parse {path}")
        nc = int(ncols[0])
        has_sign = bool(nc & 0x100)
        nc &= 0xFF
        return (
            src[:rows],
            dst[:rows],
            val[:rows] if (nc >= 3 and not has_sign) else None,
            tim[:rows] if nc >= 4 else None,
            sign[:rows] if has_sign else None,
        )
    parts = []
    with open(path) as f:
        while True:
            chunk = list(itertools.islice(f, ingest.FALLBACK_CHUNK_LINES))
            if not chunk:
                break
            parts.append(ingest._parse_chunk_lines(chunk))
    if not parts:
        parts = [ingest._parse_chunk_lines([])]
    return ingest._merge_parsed(parts)


def _batched(
    src, dst, val, tim, sign, batch_size: int, device: DeviceLike = None
) -> Callable[[], Iterator[EdgeBatch]]:
    """Re-runnable factory of padded batches over host arrays."""
    dev = resolve_device(device)

    def factory():
        for i in range(0, len(src), batch_size):
            j = min(i + batch_size, len(src))
            yield EdgeBatch.from_arrays(
                src[i:j],
                dst[i:j],
                val=None if val is None else val[i:j],
                time=None if tim is None else tim[i:j],
                sign=None if sign is None else sign[i:j],
                pad_to=batch_size,
                device=dev,
            )

    return factory


def file_stream(
    path: str,
    cfg: StreamConfig,
    interner=None,
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[EdgeStream, object]:
    """EdgeStream over an edge-list file; returns (stream, interner).

    With no interner given, ids are checked-identity (dense ints) unless
    any id falls outside [0, capacity), in which case a VertexInterner is
    built.  Value-less untimed files become array-backed streams (the
    aggregation wire path); the rest batch sources."""
    src, dst, val, tim, sign = parse_edge_file(path, workers=cfg.ingest_workers)
    if interner is None:
        if len(src) and (
            min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= cfg.vertex_capacity
        ):
            interner = VertexInterner(cfg.vertex_capacity)
        else:
            interner = IdentityInterner(cfg.vertex_capacity)
    src_i = interner.intern_ints(src)
    dst_i = interner.intern_ints(dst)
    bs = batch_size or cfg.batch_size
    if val is None and tim is None and sign is None:
        return EdgeStream.from_arrays(src_i, dst_i, cfg, batch_size=bs, device=device), interner
    stream = EdgeStream.from_batches(
        _batched(src_i, dst_i, val, tim, sign, bs, device), cfg, device=device
    )
    return stream, interner


def generated_stream(
    cfg: StreamConfig,
    num_edges: int,
    num_vertices: Optional[int] = None,
    seed: int = 0,
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
) -> EdgeStream:
    """Uniform random edge stream (the examples' generated-input fallback);
    the same edges as the JAX package's for the same seed."""
    n_v = num_vertices or cfg.vertex_capacity
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, num_edges).astype(np.int32)
    dst = rng.integers(0, n_v, num_edges).astype(np.int32)
    return EdgeStream.from_arrays(src, dst, cfg, batch_size=batch_size, device=device)


def unbounded_generated_stream(
    cfg: StreamConfig,
    num_vertices: Optional[int] = None,
    seed: int = 0,
    max_batches: Optional[int] = None,
    device: DeviceLike = None,
) -> EdgeStream:
    """Unbounded uniform random untimed edge stream of ``cfg.batch_size``
    batches (pair it with ``cfg.ingest_window_edges`` for running
    emissions); ``max_batches`` bounds it, None streams forever.  The
    same edges as the JAX package's for the same seed."""
    n_v = num_vertices or cfg.vertex_capacity
    dev = resolve_device(device)

    def factory():
        rng = np.random.default_rng(seed)
        k = 0
        while max_batches is None or k < max_batches:
            src = rng.integers(0, n_v, cfg.batch_size).astype(np.int32)
            dst = rng.integers(0, n_v, cfg.batch_size).astype(np.int32)
            yield EdgeBatch.from_arrays(src, dst, device=dev)
            k += 1

    return EdgeStream.from_batches(factory, cfg, device=dev)
