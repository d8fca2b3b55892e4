"""Iterative (label-propagation) connected components example (port of
``gelly_streaming_tpu/examples/iterative_connected_components.py``;
reference: example/IterativeConnectedComponents.java:45-229, whose
streaming feedback loop is replaced by the on-device fixed point).

Usage: iterative_connected_components [--device=cuda|cpu] [input-path [output-path]]
Emits a continuous (vertex, componentId) stream.  Runs on the GPU unless
``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.iterative_connected_components edges.txt out.csv
"""

from __future__ import annotations

from typing import List, Optional

from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import emit, extract_flags, flag_value, input_stream, parse_argv
from gelly_streaming_tpu_torch.library.iterative_cc import IterativeConnectedComponents

USAGE = "iterative_connected_components [--device=cuda|cpu] [input-path [output-path]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device",))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 2)
    stream, output = input_stream(args, device=device)
    emit(IterativeConnectedComponents().run(stream), output)


if __name__ == "__main__":
    main()
