"""Broadcast sampling triangle-count estimate example
(reference: example/BroadcastTriangleCount.java:38-270).

Usage: broadcast_triangle_count [--device=cuda|cpu] [input-path [output-path [samples]]]
Emits the running triangle-count estimate after each micro-batch.  Runs on
the GPU unless ``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.broadcast_triangle_count edges.txt out.csv 1000
"""

from __future__ import annotations

from typing import List, Optional

from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import emit, extract_flags, flag_value, input_stream, parse_argv
from gelly_streaming_tpu_torch.library.sampled_triangles import BroadcastTriangleCount

USAGE = "broadcast_triangle_count [--device=cuda|cpu] [input-path [output-path [samples]]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device",))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 3)
    samples = int(args[2]) if len(args) > 2 else 1000
    stream, output = input_stream(args, device=device)
    emit(BroadcastTriangleCount(num_samplers=samples).run(stream), output)


if __name__ == "__main__":
    main()
