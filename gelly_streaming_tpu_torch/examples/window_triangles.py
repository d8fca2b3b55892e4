"""Windowed exact triangle count example
(reference: example/WindowTriangles.java:43-171).

Usage: window_triangles [--slide=MS] [--device=cuda|cpu]
                        [input-path [output-path [window-ms]]]
Input lines are ``src dst timestamp`` (event time); emits
(triangle-count, window-max-timestamp) per window.  ``--slide=MS`` (must
divide window-ms) counts sliding windows.  Runs on the GPU unless
``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.window_triangles in.txt out.csv 400
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from gelly_streaming_tpu_torch.core.stream import EdgeStream
from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import (
    DEFAULT_CFG,
    emit,
    extract_flags,
    flag_value,
    parse_argv,
)
from gelly_streaming_tpu_torch.io.interning import VertexInterner
from gelly_streaming_tpu_torch.io.sources import (
    _batched,
    generated_stream,
    parse_edge_file,
)
from gelly_streaming_tpu_torch.library.triangles import window_triangles

USAGE = (
    "window_triangles [--slide=MS] [--device=cuda|cpu] "
    "[input-path [output-path [window-ms]]]"
)


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("slide", "device"))
    slide = flag_value(flags, "slide", USAGE)
    slide_ms = int(slide) if slide else None
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 3)
    window_ms = int(args[2]) if len(args) > 2 else 400
    cfg = DEFAULT_CFG
    if args:
        src, dst, val, tim, sign = parse_edge_file(args[0])
        # third column is the event timestamp (WindowTriangles reads
        # (src, trg, time) tuples)
        time_col = tim if tim is not None else (
            None if val is None else val.astype(np.int64)
        )
        if time_col is None:
            time_col = np.zeros(len(src), np.int64)
        interner = VertexInterner(cfg.vertex_capacity)
        src = interner.intern_ints(src)
        dst = interner.intern_ints(dst)
        bs = max(1, min(cfg.batch_size, len(src)))
        stream = EdgeStream.from_batches(
            _batched(src, dst, None, time_col, None, bs, device), cfg, device=device
        )
    else:
        stream = generated_stream(cfg, 1000, num_vertices=100, device=device)
    output = args[1] if len(args) > 1 else None
    emit(window_triangles(stream, window_ms, slide_ms=slide_ms), output)


if __name__ == "__main__":
    main()
