"""Bounded latency histograms.

Port of ``LatencyHistogram`` from ``gelly_streaming_tpu/utils/tracing.py``:
a fixed-size log-bucketed histogram in milliseconds whose quantiles are
the nearest-rank bucket's lower bound.  ``utils/metrics.py`` keeps the
named registry of them (``hist_record``, ``hist_snapshot``).  The span
tracing of the JAX module is not ported yet (queue A.8 of ROADMAP.md).
"""

from __future__ import annotations

import math
import threading


class LatencyHistogram:
    """Fixed-size log-bucketed latency histogram (milliseconds).

    Bucket ``i`` covers ``[LO_MS * 2**(i/PER_OCTAVE), LO_MS *
    2**((i+1)/PER_OCTAVE))``; with ``LO_MS = 2**-10`` (~1 µs) and 240
    buckets the range tops out around 17 minutes, and values beyond clamp
    into the edge buckets.  Reported quantiles are the NEAREST-RANK
    bucket's lower bound — an underestimate by at most one bucket width
    (2^(1/8)-1 ≈ 9%) — which makes quantiles exact for values recorded
    precisely on bucket boundaries (the exact-value tests use this).

    Thread-safe: ``record`` takes one lock per sample; samples are
    per-window/per-request events, not per-edge, so this is the same cost
    class as the existing pipeline counters.
    """

    LO_MS = 2.0 ** -10  # ~0.98 µs: bucket boundaries land on powers of 2
    PER_OCTAVE = 8
    BUCKETS = 240

    __slots__ = ("_lock", "_counts", "_count", "_sum_ms", "_min_ms", "_max_ms")

    def __init__(self):
        self._lock = threading.Lock()
        self._counts = [0] * self.BUCKETS  # guarded-by: _lock
        self._count = 0  # guarded-by: _lock
        self._sum_ms = 0.0  # guarded-by: _lock
        self._min_ms = math.inf  # guarded-by: _lock
        self._max_ms = 0.0  # guarded-by: _lock

    @classmethod
    def bucket_index(cls, ms: float) -> int:
        if ms <= cls.LO_MS:
            return 0
        # the epsilon keeps values recorded exactly ON a boundary in the
        # bucket whose lower bound they are (float log2 may land a hair
        # under the integer)
        i = int(cls.PER_OCTAVE * math.log2(ms / cls.LO_MS) + 1e-9)
        return min(i, cls.BUCKETS - 1)

    @classmethod
    def bucket_lower(cls, i: int) -> float:
        return cls.LO_MS * 2.0 ** (i / cls.PER_OCTAVE)

    def record(self, ms: float) -> None:
        ms = float(ms)
        i = self.bucket_index(ms)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum_ms += ms
            if ms < self._min_ms:
                self._min_ms = ms
            if ms > self._max_ms:
                self._max_ms = ms

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def quantile(self, p: float) -> float:
        """Nearest-rank quantile over the buckets: the lower bound of the
        bucket holding the value at 1-based rank ``ceil(p/100 * N)``."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
        return self._quantile_of(counts, total, p)

    def snapshot(self) -> dict:
        """JSON-ready summary: count/sum/min/max, p50/p90/p99, and the
        non-empty buckets as ``[bucket lower bound ms, count]`` pairs."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
            sum_ms = self._sum_ms
            min_ms = self._min_ms
            max_ms = self._max_ms
        out = {
            "count": total,
            "sum_ms": round(sum_ms, 3),
            "min_ms": round(min_ms, 6) if total else 0.0,
            "max_ms": round(max_ms, 6),
        }
        for p, key in ((50, "p50_ms"), (90, "p90_ms"), (99, "p99_ms")):
            out[key] = round(self._quantile_of(counts, total, p), 6)
        out["buckets"] = [
            [round(self.bucket_lower(i), 6), c]
            for i, c in enumerate(counts)
            if c
        ]
        return out

    @classmethod
    def _quantile_of(cls, counts, total, p) -> float:
        if total == 0:
            return 0.0
        rank = max(1, math.ceil(p / 100.0 * total))
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return cls.bucket_lower(i)
        return cls.bucket_lower(cls.BUCKETS - 1)
