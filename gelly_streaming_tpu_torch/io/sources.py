"""Edge sources: edge-list files, batched host arrays and generated streams.

Port of the parts of ``gelly_streaming_tpu/io/sources.py`` the windowed
triangle path uses.  ``parse_edge_file`` is the pure-numpy parser (the
JAX package's fallback when its C++ ingest parser is not built); it
returns the same arrays.  The C++ parser is not ported.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional

import numpy as np

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream
from gelly_streaming_tpu_torch.core.types import EdgeBatch
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device


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
