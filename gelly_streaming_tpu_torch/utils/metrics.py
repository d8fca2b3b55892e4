"""Latency recording and pipeline counters for the windowed planes.

Port of ``WindowLatencyRecorder``, the async pipeline's counters
(``pipeline_add``, ``pipeline_high_water``, ``pipeline_stats``,
``reset_pipeline_stats``), the masked-SpMV kernel core's counters
(``SPMV_DENSITY_BINS``, ``spmv_add``, ``spmv_stats``, ``reset_spmv_stats``)
and the wire path's (``wire_record_batch``, ``wire_high_water``,
``wire_stats``, ``reset_wire_stats``), ``ThroughputMeter`` and the named
latency-histogram registry (``set_hist_job``, ``hist_record``,
``hist_snapshot``, ``reset_histograms``) from
``gelly_streaming_tpu/utils/metrics.py``: close-to-emission samples in
milliseconds with nearest-rank percentiles, the occupancy of
``core/async_exec``'s stages, the push/pull split of ``ops/spmv``'s
fixpoints, the bytes an edge the wire path ships, edges a second over a
run, bounded histograms such as the network source's
``push_to_fold_ms``, and the mesh plane's comms counters (``comms_add``,
``comms_high_water``, ``comms_stats``, ``reset_comms_stats``).  The port's own
snapshot counters (``checkpoint_record``, ``checkpoint_stats``) time the
aggregation planes' checkpoint writes.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Optional

from gelly_streaming_tpu_torch.utils.tracing import LatencyHistogram


def nearest_rank(sorted_xs, p: float) -> float:
    """The p-th percentile of an ascending sequence by nearest rank: the
    value at 1-based rank ``ceil(p/100 * N)``, floored at rank 1."""
    n = len(sorted_xs)
    if n == 0:
        return 0.0
    rank = max(1, math.ceil(p / 100.0 * n))
    return sorted_xs[min(rank, n) - 1]


class ThroughputMeter:
    """Edges a second over a processing run (count what the device saw).

    ``record_batch`` may be driven from any pipeline stage's thread, so the
    counters are lock-guarded (an unguarded ``+=`` loses updates under
    contention)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.edges = 0  # guarded-by: _lock
        self.batches = 0  # guarded-by: _lock
        self._start: Optional[float] = None
        self._stop: Optional[float] = None

    def start(self) -> None:
        self._start = time.perf_counter()

    def record_batch(self, num_edges: int) -> None:
        if self._start is None:
            self.start()
        with self._lock:
            self.edges += int(num_edges)
            self.batches += 1

    def stop(self) -> None:
        self._stop = time.perf_counter()

    @property
    def elapsed(self) -> float:
        if self._start is None:
            return 0.0
        end = self._stop if self._stop is not None else time.perf_counter()
        return end - self._start

    @property
    def edges_per_sec(self) -> float:
        with self._lock:
            edges = self.edges
        return edges / self.elapsed if self.elapsed > 0 else 0.0


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


# ---------------------------------------------------------------------------
# Wire-path counters (port of ``gelly_streaming_tpu/utils/metrics.py:283-
# 343``): bumped from the pack thread and the ingest pool's workers at once.

_WIRE_LOCK = threading.Lock()


def _wire_zero() -> dict:
    return {
        # wire buffers / arenas shipped to the device (padding included)
        "wire_bytes_total": 0,
        # what the same edges would cost as raw int32 pairs (8 B/edge)
        "wire_raw_bytes_total": 0,
        # edges those buffers carried
        "wire_edges_total": 0,
        # micro-batches shipped (superbatch groups count their members)
        "wire_batches": 0,
        # longest single destination bin (equal-dst run) seen by the binning
        # pass: the propagation-blocking skew indicator
        "wire_bin_occupancy_hwm": 0,
    }


_WIRE = _wire_zero()  # guarded-by: _WIRE_LOCK


def wire_high_water(key: str, value: float) -> None:
    """Raise a wire-path high-water mark to ``value`` if it is higher."""
    with _WIRE_LOCK:
        if value > _WIRE[key]:
            _WIRE[key] = value


def wire_record_batch(batches: int, edges: int, nbytes: int) -> None:
    """Account one shipped wire buffer/arena under one lock acquisition."""
    with _WIRE_LOCK:
        _WIRE["wire_batches"] += int(batches)
        _WIRE["wire_edges_total"] += int(edges)
        _WIRE["wire_raw_bytes_total"] += 8 * int(edges)
        _WIRE["wire_bytes_total"] += int(nbytes)


def wire_stats() -> dict:
    """Process-wide wire-path counters plus the derived per-edge figures:
    ``wire_bytes_per_edge`` (shipped bytes / edges) and
    ``wire_compress_ratio`` (raw int32-pair bytes / shipped bytes)."""
    with _WIRE_LOCK:
        out = dict(_WIRE)
    edges = max(out["wire_edges_total"], 1)
    out["wire_bytes_per_edge"] = round(out["wire_bytes_total"] / edges, 3)
    out["wire_compress_ratio"] = round(out["wire_raw_bytes_total"] / max(out["wire_bytes_total"], 1), 3)
    return out


def reset_wire_stats() -> None:
    """Zero the wire-path counters (call before a measurement window,
    read ``wire_stats`` after)."""
    global _WIRE
    with _WIRE_LOCK:
        _WIRE = _wire_zero()


# ---------------------------------------------------------------------------
# Mesh comms counters: the owner-sharded summary plane's exchanges and
# gathers.  Byte figures are static per-call buffer sizes times the round
# counts the exchanges report, so they measure what crossed the mesh.
# The replicated plane (sharded_state=0) leaves every counter at zero.

_COMMS_LOCK = threading.Lock()


def _comms_zero() -> dict:
    return {
        # device dispatches that fed the mesh data plane
        "comms_dispatches": 0,
        # bytes shipped by delta/slab exchange passes
        "comms_bytes_exchange": 0.0,
        # bytes shipped reassembling the full view at emit/snapshot boundaries
        "comms_bytes_gather": 0.0,
        # exchange passes executed (spills and chains retry)
        "comms_exchange_rounds": 0,
        # max per-owner changed-row demand seen before capping
        "comms_delta_occupancy_hwm": 0,
        # delta rows deferred past a full buffer (retried, never dropped)
        "comms_delta_spilled": 0,
    }


_COMMS = _comms_zero()  # guarded-by: _COMMS_LOCK


def comms_add(key: str, amount: float) -> None:
    """Accumulate a mesh-comms counter."""
    with _COMMS_LOCK:
        _COMMS[key] += amount


def comms_high_water(key: str, value: float) -> None:
    """Raise a mesh-comms high-water mark to ``value`` if it is higher."""
    with _COMMS_LOCK:
        if value > _COMMS[key]:
            _COMMS[key] = value


def comms_stats() -> dict:
    """The mesh-comms counters, with the byte total and bytes a dispatch."""
    with _COMMS_LOCK:
        out = dict(_COMMS)
    out["comms_bytes_total"] = round(out["comms_bytes_exchange"] + out["comms_bytes_gather"], 1)
    out["comms_bytes_exchange"] = round(out["comms_bytes_exchange"], 1)
    out["comms_bytes_gather"] = round(out["comms_bytes_gather"], 1)
    n = max(out["comms_dispatches"], 1)
    out["comms_bytes_per_dispatch"] = round(out["comms_bytes_total"] / n, 1)
    return out


def reset_comms_stats() -> None:
    """Zero the mesh-comms counters."""
    global _COMMS
    with _COMMS_LOCK:
        _COMMS = _comms_zero()


# ---------------------------------------------------------------------------
# Snapshot counters: the aggregation planes' checkpoint writes (the wire
# path's writer thread and the windowed planes' saves).

_CKPT_LOCK = threading.Lock()


def _checkpoint_zero() -> dict:
    return {
        # snapshots written
        "snapshots": 0,
        # seconds the wire path's writer waited for a snapshot's download
        "snapshot_wait_s": 0.0,
        # seconds spent in save_state (host copy, npz write, rename)
        "snapshot_save_s": 0.0,
    }


_CKPT = _checkpoint_zero()  # guarded-by: _CKPT_LOCK


def checkpoint_record(wait_s: float, save_s: float) -> None:
    """Account one written snapshot."""
    with _CKPT_LOCK:
        _CKPT["snapshots"] += 1
        _CKPT["snapshot_wait_s"] += wait_s
        _CKPT["snapshot_save_s"] += save_s


def checkpoint_stats() -> dict:
    with _CKPT_LOCK:
        return dict(_CKPT)


def reset_checkpoint_stats() -> None:
    global _CKPT
    with _CKPT_LOCK:
        _CKPT = _checkpoint_zero()


# ---------------------------------------------------------------------------
# Bounded latency histograms (port of the JAX package's registry,
# ``gelly_streaming_tpu/utils/metrics.py:818-930``): named log-bucketed
# histograms per scope, process-global and per job.  A thread-local job tag
# (``set_hist_job``) scopes the samples recorded on that thread, so code
# deep inside a merge loop records into its job's rows without knowing the
# job.  ``push_to_fold_ms`` is the network source's queue residency.

_HIST_LOCK = threading.Lock()
# (kind, scope id, histogram name) -> LatencyHistogram; kind in
# {"global", "job"}, scope id "" for global
_HISTS: dict = {}  # guarded-by: _HIST_LOCK

_HIST_TL = threading.local()  # per-thread current-job tag (no lock needed)


def set_hist_job(job_id: "str | None") -> "str | None":
    """Tag this thread's later ``hist_record`` calls with a job scope (None
    clears it); returns the previous tag so callers can restore it."""
    old = getattr(_HIST_TL, "job", None)
    _HIST_TL.job = job_id
    return old


def _hist(kind: str, scope: str, name: str) -> LatencyHistogram:
    key = (kind, scope, name)
    with _HIST_LOCK:
        h = _HISTS.get(key)
        if h is None:
            h = _HISTS[key] = LatencyHistogram()
        return h


def hist_record(name: str, ms: float, job: "str | None" = None) -> None:
    """Record one latency sample into the global histogram and into the job
    scope (explicit, or this thread's ``set_hist_job`` tag)."""
    _hist("global", "", name).record(ms)
    job = job if job is not None else getattr(_HIST_TL, "job", None)
    if job:
        _hist("job", job, name).record(ms)


def hist_snapshot() -> dict:
    """Every registered histogram, grouped by scope: ``{"global": {name:
    snap}, "jobs": {id: {name: snap}}}``, each snap with count, sum,
    min/max, p50/p90/p99 and the non-empty buckets."""
    with _HIST_LOCK:
        items = list(_HISTS.items())
    out: dict = {"global": {}, "jobs": {}}
    for (kind, scope, name), h in items:
        if kind == "global":
            out["global"][name] = h.snapshot()
        else:
            out["jobs"].setdefault(scope, {})[name] = h.snapshot()
    return out


def reset_histograms() -> None:
    """Drop every registered histogram (call before a measurement window,
    read ``hist_snapshot`` after)."""
    with _HIST_LOCK:
        _HISTS.clear()
