"""Windowed PageRank example (port of
``gelly_streaming_tpu/examples/pagerank.py``).

Usage: pagerank [--device=cuda|cpu] [--slide=MS] [--damping=F] [input-path [output-path [window-ms]]]
Input lines are ``src dst [timestamp]``; untimed input ranks the whole
stream as one window.  Emits (vertex, rank) per closed window; with
``--slide`` every sliding window of size window-ms is ranked every MS.
Runs on the GPU unless ``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.pagerank edges.txt out.csv
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
from gelly_streaming_tpu_torch.library.pagerank import windowed_pagerank

USAGE = "pagerank [--device=cuda|cpu] [--slide=MS] [--damping=F] [input-path [output-path [window-ms]]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device", "slide", "damping"))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 3)
    window_ms = int(args[2]) if len(args) > 2 else 1000
    slide = flag_value(flags, "slide", USAGE)
    slide_ms = int(slide) if slide else None
    damp = flag_value(flags, "damping", USAGE)
    damping = float(damp) if damp else 0.85
    stream, output = input_stream(args, DEFAULT_CFG, device=device)
    emit(windowed_pagerank(stream, window_ms, slide_ms=slide_ms, damping=damping), output)


if __name__ == "__main__":
    main()
