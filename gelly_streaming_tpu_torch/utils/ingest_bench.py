"""The shared wire-ingest measurement harness.

Port of ``gelly_streaming_tpu/utils/ingest_bench.py``: one implementation
of the warm-up -> prefetched upload -> fold -> meter pattern the
measurement programs use, so changes to the ingest path (wire encodings,
prefetch policy) land in one place.  The port runs eagerly: the warm-up
batch builds the kernels and warms the allocator, where the JAX harness
compiles its fold.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

from gelly_streaming_tpu_torch.core.types import tree_map
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device, synchronize
from gelly_streaming_tpu_torch.io import wire
from gelly_streaming_tpu_torch.io.prefetch import WirePrefetcher, upload
from gelly_streaming_tpu_torch.utils.metrics import ThroughputMeter


def wire_stream_fold(
    src: np.ndarray,
    dst: np.ndarray,
    capacity: int,
    batch: int,
    make_fold: Callable,
    init_state: Callable[[], object],
    device: DeviceLike = None,
    depth: int = 8,
) -> Tuple[float, int, object]:
    """Stream (src, dst) through the wire ingest path into a fold.

    ``make_fold(batch, width)`` returns ``fold(state, wire_buf) -> state``,
    ``wire_buf`` a uint8 tensor on ``device``; ``init_state()`` builds the
    initial state (a tensor or a tuple of them), moved to ``device``.
    The first batch is an unmetered warm-up, so ``batch`` shrinks where
    needed to keep at least two batches; only full batches fold.  Returns (edges_per_sec,
    edges_folded, final_state)."""
    num_edges = src.shape[0]
    if num_edges < 2:
        raise ValueError("need at least 2 edges (one warmup + one metered batch)")
    batch = min(batch, num_edges // 2)
    dev = resolve_device(device)
    width = wire.width_for_capacity(capacity)
    fold = make_fold(batch, width)
    state = tree_map(lambda t: t.to(dev), init_state())

    n_batches = num_edges // batch  # >= 2 by construction
    (w0,) = upload((wire.pack_edges(src[:batch], dst[:batch], width),), dev)
    state = fold(state, w0)
    synchronize(dev)

    def batches():
        for i in range(1, n_batches):
            yield src[i * batch : (i + 1) * batch], dst[i * batch : (i + 1) * batch]

    meter = ThroughputMeter()
    meter.start()
    with WirePrefetcher(batches(), width, dev, depth=depth) as pf:
        for buf, n in pf:
            state = fold(state, buf)
            meter.record_batch(n)
    synchronize(dev)
    meter.stop()
    return meter.edges_per_sec, n_batches * batch, state
