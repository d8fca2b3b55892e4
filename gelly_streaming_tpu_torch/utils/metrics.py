"""Latency recording for the windowed planes.

Port of ``WindowLatencyRecorder`` from ``gelly_streaming_tpu/utils/metrics.py``:
close-to-emission samples in milliseconds, with nearest-rank percentiles.
"""

from __future__ import annotations

import collections
import math


def nearest_rank(sorted_xs, p: float) -> float:
    """The p-th percentile of an ascending sequence by nearest rank: the
    value at 1-based rank ``ceil(p/100 * N)``, floored at rank 1."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    rank = max(1, math.ceil(p / 100.0 * n))
    return sorted_xs[min(rank, n) - 1]


class WindowLatencyRecorder:
    """Wall-clock latency from a window's close to its emitted result.

    Keeps the most recent ``max_samples`` raw samples; ``percentile`` is
    exact while nothing has been evicted.
    """

    def __init__(self, max_samples: int = 4096):
        self.latencies_ms = collections.deque(maxlen=max_samples)

    def record(self, ms: float) -> None:
        self.latencies_ms.append(ms)

    def percentile(self, p: float) -> float:
        return nearest_rank(sorted(self.latencies_ms), p)
