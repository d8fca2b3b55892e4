"""Streaming Connected Components (bulk and tree combine).

Port of the single-device part of
``gelly_streaming_tpu/library/connected_components.py`` (reference:
library/ConnectedComponents.java:41-124 and
ConnectedComponentsTree.java:26-36).  The summary is the dense
``(parent, seen)`` tensor pair; both the per-batch fold and the combine are
the batched union-find of ``ops/unionfind.py``, which on the GPU is the
hand-written CUDA kernel of ``csrc/unionfind.cu``.  The fold is order-free,
so CC rides the sorted EF40/BDV wire encodings.  The mesh and owner-sharded
variants wait for ``parallel/`` on NCCL.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gelly_streaming_tpu_torch.core.aggregation import (
    SummaryBulkAggregation,
    SummaryTreeAggregation,
)
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.ops import unionfind as uf
from gelly_streaming_tpu_torch.summaries.disjoint_set import DisjointSet


class CCState(NamedTuple):
    parent: torch.Tensor  # int32[C]
    seen: torch.Tensor  # bool[C]


class _CCMixin:
    """Shared descriptor hooks for both combine strategies.  ``update`` and
    ``combine`` fold into their first state in place."""

    order_free = True

    def initial_state(self, cfg: StreamConfig, device: torch.device) -> CCState:
        return CCState(
            parent=uf.init_parent(cfg.vertex_capacity, device),
            seen=torch.zeros((cfg.vertex_capacity,), dtype=torch.bool, device=device),
        )

    def update(self, state: CCState, src, dst, val, mask) -> CCState:
        # UpdateCC.foldEdges == ds.union(src, trg) (ConnectedComponents.java:83-86)
        return CCState(*uf.union_edges_with_seen(state.parent, state.seen, src, dst, mask))

    def combine(self, a: CCState, b: CCState) -> CCState:
        # CombineCC.reduce == DisjointSet.merge (ConnectedComponents.java:116-124)
        return CCState(uf.merge_parents(a.parent, b.parent), a.seen.logical_or_(b.seen))

    def transform(self, state: CCState) -> DisjointSet:
        return DisjointSet(
            capacity=int(state.parent.shape[0]), parent=state.parent, seen=state.seen
        )


class ConnectedComponents(_CCMixin, SummaryBulkAggregation):
    """Flat-combine streaming CC (library/ConnectedComponents.java:41-56)."""


class ConnectedComponentsTree(_CCMixin, SummaryTreeAggregation):
    """Tree-combine streaming CC (library/ConnectedComponentsTree.java:26-36)."""
