"""Streaming bipartiteness (2-colorability) check.

Port of the single-device part of
``gelly_streaming_tpu/library/bipartiteness.py`` (reference:
library/BipartitenessCheck.java:39-130, a SummaryBulkAggregation over
Candidates).  The summary is the parity union-find on the doubled vertex
space (``ops/unionfind.py``): an odd cycle is exactly a vertex whose two
side nodes share a component.  The fold is one ``uf_parity_union_launch``
a batch on the GPU (``csrc/unionfind.cu``), the combine the union kernel's
``merge_parents`` on the doubled space.  On the mesh plane the combine is
CC's pmin-round fixed point on the doubled space
(``mesh_combine_states``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.ops import unionfind as uf
from gelly_streaming_tpu_torch.summaries.candidates import Candidates


class BPState(NamedTuple):
    parent2: torch.Tensor  # int32[2C] doubled-space union-find
    seen: torch.Tensor  # bool[C]


class BipartitenessCheck(SummaryBulkAggregation):
    """aggregate(BipartitenessCheck(window_ms)) -> stream of Candidates.
    ``update`` and ``combine`` fold into their first state in place."""

    # the parity union-find reaches the same fixed point in any edge order:
    # legal on the sorted EF40 multiset wire encoding
    order_free = True

    def initial_state(self, cfg: StreamConfig, device: torch.device) -> BPState:
        return BPState(
            parent2=uf.init_parity_parent(cfg.vertex_capacity, device),
            seen=torch.zeros((cfg.vertex_capacity,), dtype=torch.bool, device=device),
        )

    def update(self, state: BPState, src, dst, val, mask) -> BPState:
        return BPState(*uf.parity_union_edges_with_seen(state.parent2, state.seen, src, dst, mask))

    def combine(self, a: BPState, b: BPState) -> BPState:
        return BPState(uf.merge_parents(a.parent2, b.parent2), a.seen.logical_or_(b.seen))

    def transform(self, state: BPState) -> Candidates:
        return Candidates(state.parent2, state.seen)

    def mesh_combine_states(self, cfg: StreamConfig):
        """The collective cross-shard combine on the doubled space: CC's
        pmin-round fixed point (each shard's parent2 pointers are its local
        parity constraints), the form of Candidates' partition merge
        (BipartitenessCheck.java:128-130)."""
        from gelly_streaming_tpu_torch.library.connected_components import collective_parent_seen_combine

        def combine(mesh, states, has_data) -> BPState:
            return BPState(*collective_parent_seen_combine(
                mesh, [st.parent2 for st in states], [st.seen for st in states]
            ))

        return combine
