"""Incidence-sampling triangle-count estimate example
(reference: example/IncidenceSamplingTriangleCount.java:37-336; seeded RNG
0xDEADBEEF, :61).

Usage: incidence_sampling_triangle_count [--device=cuda|cpu] [input-path [output-path [samples]]]
Runs on the GPU unless ``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.incidence_sampling_triangle_count edges.txt out.csv 1000
"""

from __future__ import annotations

from typing import List, Optional

from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import emit, extract_flags, flag_value, input_stream, parse_argv
from gelly_streaming_tpu_torch.library.sampled_triangles import IncidenceSamplingTriangleCount

USAGE = "incidence_sampling_triangle_count [--device=cuda|cpu] [input-path [output-path [samples]]]"


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device",))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 3)
    samples = int(args[2]) if len(args) > 2 else 1000
    stream, output = input_stream(args, device=device)
    # the single-device estimator always: the JAX example's routed mesh
    # branch (MeshSampledTriangleCount on more than one device) is ROADMAP
    # queue A.7, not ported yet
    emit(IncidenceSamplingTriangleCount(num_samplers=samples).run(stream), output)


if __name__ == "__main__":
    main()
