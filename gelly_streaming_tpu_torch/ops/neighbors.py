"""Capacity-bounded neighbor tables (port of ``gelly_streaming_tpu/ops/neighbors.py``).

State is a dense table ``nbrs: int32[C, D]`` (-1 = empty slot) plus
``deg: int32[C]`` and an overflow counter, updated for a whole batch in
one vectorized pass: rank rows within their source group, scatter to
``deg[src] + rank``.  Functions return new tables and leave their inputs
unchanged, as the JAX versions do.  The windowed triangle count's CSR
fallback and the ``distinct`` stage are built on these.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gelly_streaming_tpu_torch.ops import indexing, segments


class NeighborTable(NamedTuple):
    """Padded adjacency rows + row occupancy + overflow counter."""

    nbrs: torch.Tensor  # int32[C, D], -1 = empty
    deg: torch.Tensor  # int32[C]
    dropped: torch.Tensor  # int32[] rows lost to capacity overflow


def init_table(capacity: int, max_degree: int, device: torch.device) -> NeighborTable:
    return NeighborTable(
        nbrs=torch.full((capacity, max_degree), -1, dtype=torch.int32, device=device),
        deg=torch.zeros((capacity,), dtype=torch.int32, device=device),
        dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def contains_batch(
    table: NeighborTable, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """For each row i: is dst[i] already in N(src[i])?  [B, D] compare."""
    rows = table.nbrs[indexing.gather_index(src, table.nbrs.shape[0])]
    return (rows == dst[:, None]).any(dim=1)


def insert_flat_(
    flat: torch.Tensor,
    deg: torch.Tensor,
    dropped: torch.Tensor,
    max_degree: int,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
) -> None:
    """``insert_batch`` in place on a table held as one flat buffer: its
    C * D slots row-major, then one sink slot.  No step waits on the
    device (no data-dependent shape), so a caller may capture it in a CUDA
    graph."""
    capacity = deg.shape[0]
    rank = segments.occurrence_rank(src, mask)
    pos = deg[indexing.gather_index(src, capacity)] + rank
    ok = mask & (pos < max_degree)
    # the flat index in JAX's int32 arithmetic and scatter rule (an id below
    # 0 lands in the last rows, one past the end is dropped); masked,
    # overflow and dropped rows land in the sink slot
    sink = capacity * max_degree
    flat_idx, kept = indexing.scatter_index(src * max_degree + pos, sink)
    flat[torch.where(ok & kept, flat_idx, sink)] = torch.where(ok, dst, -1).to(torch.int32)
    indexing.scatter_add_(deg, torch.where(ok, src, 0), ok.to(torch.int32))
    dropped.add_((mask & ~ok).sum(dtype=torch.int32))


def flat_with_sink(nbrs: torch.Tensor) -> torch.Tensor:
    """A copy of ``nbrs`` [C, D] as ``insert_flat_``'s buffer (the sink -1)."""
    return torch.cat([nbrs.reshape(-1), torch.full((1,), -1, dtype=torch.int32, device=nbrs.device)])


def insert_batch(
    table: NeighborTable,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: torch.Tensor,
) -> NeighborTable:
    """Append dst[i] to N(src[i]) for every masked row, in one pass.

    The caller dedups; this appends unconditionally.  Rows past a row's
    capacity D are dropped and counted in ``dropped``.
    """
    capacity, max_degree = table.nbrs.shape
    flat = flat_with_sink(table.nbrs)
    deg, dropped = table.deg.clone(), table.dropped.clone()
    insert_flat_(flat, deg, dropped, max_degree, src, dst, mask)
    return NeighborTable(nbrs=flat[: capacity * max_degree].view(capacity, max_degree), deg=deg, dropped=dropped)


def gather_rows(
    table: NeighborTable, vertices: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neighbors [B, D], valid [B, D]) for a batch of vertices."""
    v = indexing.gather_index(vertices, table.nbrs.shape[0])
    rows = table.nbrs[v]
    slots = torch.arange(table.nbrs.shape[1], device=rows.device)
    valid = slots[None, :] < table.deg[v][:, None]
    return rows, valid


def insert_unique_batch(
    table: NeighborTable,
    src: torch.Tensor,
    dst: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[NeighborTable, torch.Tensor]:
    """Insert only rows not already present (in the table or earlier in the
    batch); returns (new table, is_new), the analog of the reference's
    ``HashSet.add`` returning true (SimpleEdgeStream.java:313-320).

    A new row past its source's capacity D is dropped from the table and
    counted in ``dropped`` but still reported ``is_new``, so a later
    duplicate of it is new again: the JAX overflow semantics."""
    if mask is None:
        mask = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    present = contains_batch(table, src, dst)
    first = segments.first_occurrence_mask_pairs(src, dst, mask)
    is_new = mask & ~present & first
    return insert_batch(table, src, dst, is_new), is_new


def insert_unique_valued_batch(
    table: NeighborTable,
    vtable: NeighborTable,
    src: torch.Tensor,
    dst: torch.Tensor,
    val_bits: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[NeighborTable, NeighborTable, torch.Tensor]:
    """Whole-edge distinct: a row is new iff its (src, dst, value bits)
    triple is.  ``table`` holds the dst ids and ``vtable`` the values'
    int32 bits in the same slots (one insert mask drives both), so
    presence is a same-slot conjunction."""
    if mask is None:
        mask = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    rows_d, valid = gather_rows(table, src)
    rows_v = vtable.nbrs[indexing.gather_index(src, vtable.nbrs.shape[0])]
    present = ((rows_d == dst[:, None]) & (rows_v == val_bits[:, None]) & valid).any(dim=1)
    first = segments.first_occurrence_mask_triples(src, dst, val_bits, mask)
    is_new = mask & ~present & first
    return (
        insert_batch(table, src, dst, is_new),
        insert_batch(vtable, src, val_bits, is_new),
        is_new,
    )
