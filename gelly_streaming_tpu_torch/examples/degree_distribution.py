"""Fully-dynamic degree distribution example
(reference: example/DegreeDistribution.java:43-193).

Usage: degree_distribution [--device=cuda|cpu] [input-path [output-path]]
Input lines are ``src dst +`` / ``src dst -`` (edge additions/deletions);
emits continuous (degree, count) histogram updates.  Runs on the GPU
unless ``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.degree_distribution events.txt out.csv
"""

from __future__ import annotations

from typing import List, Optional

from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import (
    DEFAULT_CFG,
    emit,
    extract_flags,
    flag_value,
    parse_argv,
)
from gelly_streaming_tpu_torch.io.sources import file_stream, generated_stream
from gelly_streaming_tpu_torch.library.degree_distribution import DegreeDistribution

USAGE = "degree_distribution [--device=cuda|cpu] [input-path [output-path]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device",))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 2)
    if args:
        stream, _ = file_stream(args[0], DEFAULT_CFG, batch_size=64, device=device)
    else:
        stream = generated_stream(DEFAULT_CFG, 1000, num_vertices=100, device=device)
    output = args[1] if len(args) > 1 else None
    emit(DegreeDistribution().run(stream), output)


if __name__ == "__main__":
    main()
