"""Insertion-only exact triangle count example
(reference: example/ExactTriangleCount.java:40-207).

Usage: exact_triangle_count [--device=cuda|cpu] [input-path [output-path]]
Emits continuous (vertexId, localCount) updates; key -1 carries the
global count.  Runs on the GPU unless ``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.exact_triangle_count edges.txt out.csv
"""

from __future__ import annotations

from typing import List, Optional

from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import emit, extract_flags, flag_value, input_stream, parse_argv
from gelly_streaming_tpu_torch.library.triangles import ExactTriangleCount

USAGE = "exact_triangle_count [--device=cuda|cpu] [input-path [output-path]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device",))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 2)
    stream, output = input_stream(args, device=device)
    emit(ExactTriangleCount().run(stream), output)


if __name__ == "__main__":
    main()
