"""Fully-dynamic degree distribution over add/delete edge events.

Port of the single-device part of
``gelly_streaming_tpu/library/degree_distribution.py`` (reference:
example/DegreeDistribution.java:54-132, a 3-stage keyed pipeline: per edge
a +/-1 change for each endpoint; a per-vertex stage emitting (new degree,
+1) / (old degree, -1) and removing vertices at degree 0; a per-degree
stage keeping the histogram and emitting (degree, count) updates).

State is the dense ``deg[C]`` and ``hist[C]`` pair; each event produces up
to four (degree, count) records in the reference's per-event order, by
``ops/degrees.degree_dist_scan`` (``csrc/degrees.cu`` on the GPU).
``DegreeDistributionSummary`` is the windowed add-only summary form: the
per-vertex degree vector, folded by ``ops/degrees.degree_fold``.  Its
owner-sharded mesh state waits for ``parallel/`` on NCCL.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.output import OutputStream, RecordBlock
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import degrees


class DegreeDistState(NamedTuple):
    deg: torch.Tensor  # int32[C]
    hist: torch.Tensor  # int32[C]: vertices with each nonzero degree


def init_state(cfg: StreamConfig, device: DeviceLike = None) -> DegreeDistState:
    dev = resolve_device(device)
    return DegreeDistState(
        deg=torch.zeros((cfg.vertex_capacity,), dtype=torch.int32, device=dev),
        hist=torch.zeros((cfg.vertex_capacity,), dtype=torch.int32, device=dev),
    )


def degree_dist_update(state: DegreeDistState, src, dst, sign, mask):
    """Returns (state, records int32[B, 4, 2], record mask bool[B, 4]); the
    state is updated in place.  Per event the slots are [src new-degree,
    src old-degree, dst new-degree, dst old-degree] (degree, count) records,
    masked off where not emitted; ``sign`` None means all additions."""
    recs, rmask = degrees.degree_dist_scan(state.deg, state.hist, src, dst, sign, mask)
    return state, recs, rmask


# ---------------------------------------------------------------------------
# the windowed summary form: the per-vertex degree vector


class DegreeSummaryState(NamedTuple):
    deg: torch.Tensor  # int32[C]


def degree_histogram(deg) -> dict:
    """{degree: vertex count} over vertices with nonzero degree."""
    d = deg.cpu().numpy() if isinstance(deg, torch.Tensor) else np.asarray(deg)
    d = d[d > 0]
    vals, counts = np.unique(d, return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


class DegreeDistributionSummary(SummaryBulkAggregation):
    """Dense per-vertex degree fold: update adds 1 to each endpoint's degree
    (in place), combine is elementwise +, transform emits the bare deg
    vector (``degree_histogram`` derives the (degree, count) view).
    Deletions belong to ``DegreeDistribution``."""

    # addition commutes: legal on the sorted EF40 multiset wire encoding
    order_free = True

    def initial_state(self, cfg: StreamConfig, device: torch.device) -> DegreeSummaryState:
        return DegreeSummaryState(deg=torch.zeros((cfg.vertex_capacity,), dtype=torch.int32, device=device))

    def update(self, state, src, dst, val, mask) -> DegreeSummaryState:
        return DegreeSummaryState(deg=degrees.degree_fold(state.deg, src, dst, mask))

    def combine(self, a, b) -> DegreeSummaryState:
        return DegreeSummaryState(deg=a.deg.add_(b.deg))

    def transform(self, state):
        # the bare vector: a NamedTuple would be splatted into the record
        return state.deg


class DegreeDistribution:
    """Continuous (degree, count) histogram-update stream."""

    def run(self, stream) -> OutputStream:
        def blocks():
            state = init_state(stream.cfg, stream.device)
            for batch in stream.batches():
                state, recs, rmask = degree_dist_update(
                    state, batch.src, batch.dst, batch.sign, batch.mask
                )
                # [B, 4, 2] record slots -> one compacted block a batch, in
                # the reference's order (per edge: u-new, u-old, v-new, v-old)
                r_h = recs.cpu().numpy().reshape(-1, 2)
                idx = np.nonzero(rmask.cpu().numpy().reshape(-1))[0]
                if len(idx):
                    yield RecordBlock((r_h[idx, 0].astype(np.int64), r_h[idx, 1].astype(np.int64)))
            self.final_state = state

        return OutputStream(blocks_fn=blocks)
