"""Greedy streaming weighted matching example
(reference: example/CentralizedWeightedMatching.java:36-113; reads a weighted
edge list — the reference hardcodes movielens_10k_sorted.txt — and prints
ADD/REMOVE MatchingEvents plus the net runtime, :62-64).

Usage: centralized_weighted_matching [--device=cuda|cpu] [input-path [output-path]]
Runs on the GPU unless ``--device=cpu`` is given.

    python -m gelly_streaming_tpu_torch.examples.centralized_weighted_matching ratings.txt out.csv
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from gelly_streaming_tpu_torch.core.stream import EdgeStream
from gelly_streaming_tpu_torch.core.types import EdgeBatch
from gelly_streaming_tpu_torch.device import resolve_device
from gelly_streaming_tpu_torch.examples._cli import DEFAULT_CFG, emit, extract_flags, flag_value, parse_argv
from gelly_streaming_tpu_torch.io.sources import file_stream
from gelly_streaming_tpu_torch.library.matching import CentralizedWeightedMatching

USAGE = "centralized_weighted_matching [--device=cuda|cpu] [input-path [output-path]]"


def _generated_weighted(cfg, device, num_edges=1000, num_vertices=100, seed=0):
    """The JAX example's built-in stream: the same edges and weights."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, num_edges).astype(np.int32)
    dst = rng.integers(0, num_vertices, num_edges).astype(np.int32)
    w = rng.integers(1, 100, num_edges).astype(np.float32)

    def factory():
        bs = cfg.batch_size
        for i in range(0, num_edges, bs):
            j = min(i + bs, num_edges)
            yield EdgeBatch.from_arrays(src[i:j], dst[i:j], val=w[i:j], pad_to=bs, device=device)

    return EdgeStream.from_batches(factory, cfg, device=device)


def main(argv: Optional[List[str]] = None) -> None:
    raw, flags = extract_flags(argv, USAGE, ("device",))
    device = resolve_device(flag_value(flags, "device", USAGE))
    args = parse_argv(raw, USAGE, 2)
    if args:
        stream, _ = file_stream(args[0], DEFAULT_CFG, device=device)
    else:
        stream = _generated_weighted(DEFAULT_CFG, device)
    output = args[1] if len(args) > 1 else None
    t0 = time.perf_counter()
    emit(CentralizedWeightedMatching().run(stream), output)
    print(f"Runtime: {int((time.perf_counter() - t0) * 1000)}")


if __name__ == "__main__":
    main()
