"""Edge sources: edge-list files, batched host arrays and generated streams.

Port of the parts of ``gelly_streaming_tpu/io/sources.py`` the ported
slices use.  ``parse_edge_file`` is the pure-numpy parser (the JAX
package's fallback when its C++ ingest parser is not built); it returns
the same arrays.  The C++ parser and the network source are not ported.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream
from gelly_streaming_tpu_torch.core.types import EdgeBatch
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.io.interning import IdentityInterner, VertexInterner


def parse_edge_file(path: str):
    """Parse an edge-list file into host arrays.

    Returns (src i64, dst i64, val f64 | None, time i64 | None, sign i32 |
    None).  Format per line: ``src dst [value|+|-] [timestamp]`` with
    space/tab/comma separators and #/% comments.
    """
    src, dst, val, tim, sign = [], [], [], [], []
    ncols = 2
    has_sign = False
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line[0] in "#%":
                continue
            parts = line.replace(",", " ").replace("\t", " ").split()
            if len(parts) < 2:
                continue
            src.append(int(parts[0]))
            dst.append(int(parts[1]))
            v, t, sg = 0.0, 0, 1
            if len(parts) > 2:
                if parts[2] in ("+", "-"):
                    sg = -1 if parts[2] == "-" else 1
                    has_sign = True
                else:
                    v = float(parts[2])
                ncols = max(ncols, 3)
            if len(parts) > 3:
                t = int(float(parts[3]))
                ncols = 4
            val.append(v)
            tim.append(t)
            sign.append(sg)
    return (
        np.array(src, np.int64),
        np.array(dst, np.int64),
        np.array(val, np.float64) if (ncols >= 3 and not has_sign) else None,
        np.array(tim, np.int64) if ncols >= 4 else None,
        np.array(sign, np.int32) if has_sign else None,
    )


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
    src, dst, val, tim, sign = parse_edge_file(path)
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
