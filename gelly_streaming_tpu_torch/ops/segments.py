"""Batched key-grouping primitives (port of ``gelly_streaming_tpu/ops/segments.py``,
the parts the neighbor tables use).

Keys are sorted and ranked inside a micro-batch; padding rows sort next
to, but never inside, a valid group.
"""

from __future__ import annotations

from typing import Optional

import torch


def _grouping_key(keys: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Composite key where padding rows never join a valid group: valid
    keys map to even space (k*2), padding rows to odd space (k*2+1)."""
    k = keys.to(torch.int64) * 2
    if mask is None:
        return k
    return k + (~mask).to(torch.int64)


def segment_boundaries(sorted_keys: torch.Tensor) -> torch.Tensor:
    """Boundary mask over sorted grouping keys (True at each new group start)."""
    head = torch.ones((1,), dtype=torch.bool, device=sorted_keys.device)
    return torch.cat([head, sorted_keys[1:] != sorted_keys[:-1]])


def _rank_from_grouping(order: torch.Tensor, boundary: torch.Tensor) -> torch.Tensor:
    """Within-group rank (0-based, original order) from a stable grouping
    ``order`` and the group-start ``boundary`` mask over the sorted keys."""
    n = order.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=order.device)
    seg_start = torch.cummax(torch.where(boundary, pos, 0), dim=0).values
    rank = torch.empty((n,), dtype=torch.int64, device=order.device)
    rank[order] = pos - seg_start
    return rank.to(torch.int32)


def occurrence_rank(
    keys: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """rank[i] = number of earlier valid rows j < i with keys[j] == keys[i]."""
    if keys.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=keys.device)
    k = _grouping_key(keys, mask)
    sorted_k, order = torch.sort(k, stable=True)
    return _rank_from_grouping(order, segment_boundaries(sorted_k))
