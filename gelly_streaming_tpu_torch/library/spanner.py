"""Continuous k-spanner (library/Spanner.java:40-118).

Port of ``gelly_streaming_tpu/library/spanner.py``.  Reference semantics:
per edge, a k-bounded BFS between the endpoints on the current spanner;
the edge is admitted only if their distance exceeds k (:71-77).  The
combine re-inserts the smaller spanner's edges into the larger under the
same test (:92-116).

Admission is two-phase, as in the JAX package: a pre-filter tests the
whole batch against the pre-batch spanner (distances only shrink, so an
edge already within k dies whatever the batch admits before it; capped
balls can only miss a rejection), and the surviving candidates are
resolved in arrival order with an exact test.  The final spanner equals
the sequential fold's.  On the GPU both phases are one C call a batch
(``ops/spanner.spanner_admit``, ``csrc/spanner.cu``); on the CPU its twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.ops import spanner as spanner_ops
from gelly_streaming_tpu_torch.summaries import adjacency
from gelly_streaming_tpu_torch.summaries.adjacency import AdjacencyListGraph


class SpannerState(NamedTuple):
    nbrs: torch.Tensor  # int32[C, D]
    deg: torch.Tensor  # int32[C]


def auto_body(capacity: int, max_degree: int, k: int) -> str:
    """The per-candidate distance body ``body="auto"`` runs for (k, C, D):
    "within_two" (k=2 O(D^2) row intersection), "balls" (exact
    meet-in-the-middle, cost independent of C), or "bfs" (dense k*C*D
    sweep)."""
    if k == 2:
        return "within_two"
    if adjacency.ball_cost(max_degree, k) < k * capacity * max_degree:
        return "balls"
    return "bfs"


def _within_k_prefilter(nbrs, src, dst, k: int, cap: int):
    """bool[B]: True only where dist(src, dst) <= k on ``nbrs`` for sure."""
    return spanner_ops.prefilter_plain(nbrs, src, dst, k, cap)


def _admit_batch(nbrs, deg, src, dst, mask, k: int, cap: int, body_kind: str = "auto"):
    """Two-phase spanner admission, in place; returns (nbrs, deg).
    ``body_kind`` "auto" picks the body by ``auto_body``; "balls"/"bfs"
    force one (every body is exact; the forced modes exist for the
    calibration measurement)."""
    capacity, max_degree = nbrs.shape
    picked = auto_body(capacity, max_degree, k) if body_kind == "auto" else body_kind
    return spanner_ops.spanner_admit(nbrs, deg, src, dst, mask, k, cap, picked)


class Spanner(SummaryBulkAggregation):
    """aggregate(Spanner(window_ms, k)) -> stream of AdjacencyListGraph views.

    ``filter_cap`` bounds the pre-filter's ball width; caps of at least
    ``max_degree + 1`` keep the k=2 filter exact (a ball of radius 1 is the
    vertex plus its full neighbor row).  ``update`` and ``combine`` change
    their first state in place.
    """

    def __init__(self, window_ms: int, k: int, filter_cap: int = 128, body: str = "auto"):
        super().__init__(window_ms)
        if body not in ("auto", "balls", "bfs"):
            raise ValueError(f"body must be auto/balls/bfs, got {body!r}")
        self.k = k
        self.filter_cap = filter_cap
        self.body = body

    def initial_state(self, cfg: StreamConfig, device: torch.device) -> SpannerState:
        return SpannerState(*adjacency.init_table(cfg.vertex_capacity, cfg.max_degree, device))

    def update(self, state: SpannerState, src, dst, val, mask) -> SpannerState:
        nbrs, deg = _admit_batch(state.nbrs, state.deg, src, dst, mask, self.k, self.filter_cap, self.body)
        return SpannerState(nbrs, deg)

    def combine(self, a: SpannerState, b: SpannerState) -> SpannerState:
        """Re-insert the smaller spanner's edges into the larger
        (CombineSpanners, Spanner.java:92-116); on a tie ``a`` is the
        larger.  The smaller's edges are its canonical (v, nbr) slot pairs,
        admitted through the same two-phase batch path as the fold."""
        size_a = int((a.deg > 0).sum())
        size_b = int((b.deg > 0).sum())
        big, small = (a, b) if size_a >= size_b else (b, a)
        capacity, max_degree = small.nbrs.shape
        dev = small.nbrs.device
        vs = torch.arange(capacity, dtype=torch.int32, device=dev).repeat_interleave(max_degree)
        ns = small.nbrs.reshape(-1)
        slot_ok = (ns >= 0) & (vs < ns)  # canonical: each edge once
        nbrs, deg = _admit_batch(big.nbrs, big.deg, vs, ns.clamp_min(0), slot_ok, self.k, self.filter_cap,
                                 self.body)
        return SpannerState(nbrs, deg)

    def transform(self, state: SpannerState) -> AdjacencyListGraph:
        return AdjacencyListGraph.from_state(state.nbrs, state.deg)
