"""k-Spanner example (reference: example/SpannerExample.java:40-165).

Usage: spanner [--device=cuda|cpu] [input-path [output-path [window-ms [k]]]]
Emits the spanner's edge set per merge window (flatten-and-print analog,
SpannerExample.java:61-67).  Runs on the GPU unless ``--device=cpu`` is
given.

    python -m gelly_streaming_tpu_torch.examples.spanner edges.txt out.csv 1000 3
"""

from __future__ import annotations

from typing import List, Optional

from gelly_streaming_tpu_torch.core.output import OutputStream
from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import emit, extract_flags, flag_value, input_stream, parse_argv
from gelly_streaming_tpu_torch.library.spanner import Spanner

USAGE = "spanner [--device=cuda|cpu] [input-path [output-path [window-ms [k]]]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device",))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 4)
    window_ms = int(args[2]) if len(args) > 2 else 1000
    k = int(args[3]) if len(args) > 3 else 3
    stream, output = input_stream(args, device=device)
    results = stream.aggregate(Spanner(window_ms, k))

    def records():
        for (g,) in results:
            for u, v in sorted(g.edges()):
                yield (u, v)

    emit(OutputStream(records), output)


if __name__ == "__main__":
    main()
