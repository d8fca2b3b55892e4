"""Latency recording and pipeline counters for the windowed planes.

Port of ``WindowLatencyRecorder`` the async pipeline's counters
(``pipeline_add``, ``pipeline_high_water``, ``pipeline_stats``,
``reset_pipeline_stats``) and the masked-SpMV kernel core's counters
(``SPMV_DENSITY_BINS``, ``spmv_add``, ``spmv_stats``, ``reset_spmv_stats``)
from ``gelly_streaming_tpu/utils/metrics.py``: close-to-emission samples in
milliseconds with nearest-rank percentiles, the occupancy of
``core/async_exec``'s stages, and the push/pull split of ``ops/spmv``'s
fixpoints.
"""

from __future__ import annotations

import collections
import math
import threading


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


# ---------------------------------------------------------------------------
# Async window pipeline occupancy (port of the JAX package's pipeline
# counters, ``gelly_streaming_tpu/utils/metrics.py:155-190``): bumped from
# the pack, transfer, dispatch and drain threads at once, so every update
# holds the lock.


def _pipeline_zero() -> dict:
    return {
        # deepest completion queue seen (windows dispatched, not drained)
        "pipeline_inflight_high_water": 0,
        # seconds the pack / transfer threads waited on a full queue
        "pipeline_pack_stall_s": 0.0,
        "pipeline_transfer_stall_s": 0.0,
        # seconds the dispatch thread waited for its next window, and of
        # them the snapshot plane's build_buckets calls (their host read of
        # the bucket counts blocks the dispatch thread)
        "pipeline_dispatch_stall_s": 0.0,
        "pipeline_dispatch_build_s": 0.0,
        # seconds the completion-queue drain waited on the device
        "pipeline_drain_stall_s": 0.0,
        # deepest configured prefetch queue seen
        "pipeline_prefetch_depth": 0,
        "pipeline_windows_dispatched": 0,
        "pipeline_windows_drained": 0,
    }


_PIPE_LOCK = threading.Lock()
_PIPELINE = _pipeline_zero()  # guarded-by: _PIPE_LOCK


def pipeline_add(key: str, amount: float) -> None:
    """Accumulate a pipeline counter (thread-safe)."""
    with _PIPE_LOCK:
        _PIPELINE[key] += amount


def pipeline_high_water(key: str, value: float) -> None:
    """Raise a pipeline high-water mark to ``value`` if it is higher."""
    with _PIPE_LOCK:
        if value > _PIPELINE[key]:
            _PIPELINE[key] = value


def pipeline_stats() -> dict:
    """The process-wide pipeline counters: in-flight high-water mark, stall
    seconds by stage, prefetch depth, windows dispatched and drained.
    Seconds are rounded to 0.1 ms."""
    with _PIPE_LOCK:
        out = dict(_PIPELINE)
    for key in out:
        if key.endswith("_s"):
            out[key] = round(out[key], 4)
    return out


def reset_pipeline_stats() -> None:
    """Zero the pipeline counters (before a measurement window)."""
    global _PIPELINE
    with _PIPE_LOCK:
        _PIPELINE = _pipeline_zero()


# ---------------------------------------------------------------------------
# Masked-SpMV kernel core accounting (ops/spmv.py direction optimization;
# port of ``gelly_streaming_tpu/utils/metrics.py:1001-1059``).  Fixpoints run
# on whatever thread drives the window loop while stats drain from other
# threads, so every update holds the lock.


_SPMV_LOCK = threading.Lock()

# frontier-density histogram bins: bin b counts iterations whose density
# landed in [b/8, (b+1)/8) — 8 scalar keys, not a nested dict
SPMV_DENSITY_BINS = 8


def _spmv_zero() -> dict:
    d = {
        # direction-optimized fixpoints driven to completion
        "spmv_fixpoints": 0,
        # iterations lowered as sparse push (SpMSpV) / dense pull (SpMV)
        "spmv_push_iters": 0,
        "spmv_pull_iters": 0,
        # push<->pull flips within a fixpoint
        "spmv_direction_switches": 0,
    }
    for b in range(SPMV_DENSITY_BINS):
        d[f"spmv_density_hist_{b}"] = 0
    return d


_SPMV = _spmv_zero()  # guarded-by: _SPMV_LOCK


def spmv_add(key: str, amount: int = 1) -> None:
    """Accumulate a kernel-core counter (thread-safe)."""
    with _SPMV_LOCK:
        _SPMV[key] += amount


def spmv_stats() -> dict:
    """Process-wide masked-SpMV direction-optimization counters: push vs
    pull iterations, direction switches, the frontier-density histogram,
    and the derived ``spmv_iters_total`` and ``spmv_push_fraction``."""
    with _SPMV_LOCK:
        out = dict(_SPMV)
    total = out["spmv_push_iters"] + out["spmv_pull_iters"]
    out["spmv_iters_total"] = total
    out["spmv_push_fraction"] = (
        round(out["spmv_push_iters"] / total, 4) if total else 0.0
    )
    return out


def reset_spmv_stats() -> None:
    """Zero the kernel-core counters (call before a measurement window,
    read ``spmv_stats`` after)."""
    global _SPMV
    with _SPMV_LOCK:
        _SPMV = _spmv_zero()
