"""Batched key-grouping primitives (port of ``gelly_streaming_tpu/ops/segments.py``).

Keys are sorted and ranked inside a micro-batch; padding rows sort next
to, but never inside, a valid group.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gelly_streaming_tpu_torch.ops import indexing


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


def first_occurrence_mask(keys: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """True for the first valid occurrence of each key within the batch."""
    first = occurrence_rank(keys, mask) == 0
    if mask is not None:
        first = first & mask
    return first


def segment_sum(
    values: torch.Tensor, keys: torch.Tensor, num_groups: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Sum of ``values`` per key as a dense [num_groups] tensor; masked
    rows add zero to group 0."""
    if mask is not None:
        values = torch.where(mask, values, torch.zeros_like(values))
        keys = torch.where(mask, keys, 0)
    out = torch.zeros((num_groups,), dtype=values.dtype, device=values.device)
    return indexing.scatter_add_(out, keys, values)


def group_counts(keys: torch.Tensor, num_groups: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Number of valid rows per key, as a dense int32 [num_groups] tensor."""
    ones = torch.ones(keys.shape, dtype=torch.int32, device=keys.device)
    return segment_sum(ones, keys, num_groups, mask)


def _multi_order(
    src: torch.Tensor, cols: Tuple[torch.Tensor, ...], mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable order grouping equal (src, *cols) composites; returns
    (order, boundary).  A lexsort: stable sorts by the last column first,
    then the others, then the padding-safe grouping key of ``src``."""
    ks = _grouping_key(src, mask)
    cols32 = tuple(c.to(torch.int32) for c in cols)
    order = torch.arange(src.shape[0], dtype=torch.int64, device=src.device)
    for key in tuple(reversed(cols32)) + (ks,):
        order = order[torch.sort(key[order], stable=True).indices]
    boundary = segment_boundaries(ks[order])
    for c in cols32:
        boundary = boundary | segment_boundaries(c[order])
    return order, boundary


def _pair_order(
    src: torch.Tensor, dst: torch.Tensor, mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable order grouping equal (src, dst) pairs; returns (order, boundary)."""
    return _multi_order(src, (dst,), mask)


def occurrence_rank_pairs(
    src: torch.Tensor, dst: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """occurrence_rank over composite (src, dst) keys."""
    if src.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=src.device)
    return _rank_from_grouping(*_pair_order(src, dst, mask))


def first_occurrence_mask_pairs(
    src: torch.Tensor, dst: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """True for the first valid occurrence of each (src, dst) pair in the batch."""
    first = occurrence_rank_pairs(src, dst, mask) == 0
    if mask is not None:
        first = first & mask
    return first


def sort_by_key(
    keys: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable grouping order; returns (order, sorted grouping keys)."""
    k = _grouping_key(keys, mask)
    sorted_k, order = torch.sort(k, stable=True)
    return order, sorted_k


def first_occurrence_mask_triples(
    src: torch.Tensor, dst: torch.Tensor, third: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """True for the first valid occurrence of each (src, dst, third) triple
    (whole-edge dedup: ``third`` is e.g. the edge values' int32 bits)."""
    if src.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=src.device)
    order, boundary = _multi_order(src, (dst, third), mask)
    first = _rank_from_grouping(order, boundary) == 0
    if mask is not None:
        first = first & mask
    return first
