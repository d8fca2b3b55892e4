"""Windowed single-source shortest paths example (port of
``gelly_streaming_tpu/examples/sssp.py``).

Usage: sssp [--device=cuda|cpu] [--source=V] [--slide=MS] [input-path [output-path [window-ms]]]
Input lines are ``src dst [weight] [timestamp]``; valueless input counts
hops.  Emits (vertex, distance) per closed window for reached vertices.
Runs on the GPU unless ``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.sssp --source=1 edges.txt out.csv
"""

from __future__ import annotations

from typing import List, Optional

from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import (
    DEFAULT_CFG,
    emit,
    extract_flags,
    flag_value,
    input_stream,
    parse_argv,
)
from gelly_streaming_tpu_torch.library.sssp import windowed_sssp

USAGE = "sssp [--device=cuda|cpu] [--source=V] [--slide=MS] [input-path [output-path [window-ms]]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device", "source", "slide"))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 3)
    window_ms = int(args[2]) if len(args) > 2 else 1000
    src_flag = flag_value(flags, "source", USAGE)
    source = int(src_flag) if src_flag else 0
    slide = flag_value(flags, "slide", USAGE)
    slide_ms = int(slide) if slide else None
    stream, output = input_stream(args, DEFAULT_CFG, device=device)
    emit(windowed_sssp(stream, source, window_ms, slide_ms=slide_ms), output)


if __name__ == "__main__":
    main()
