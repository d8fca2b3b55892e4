"""JAX's index rules for ids outside [0, size), in PyTorch ops.

Streams that validate nothing (``EdgeStream.from_collection``,
``from_batches``) can carry vertex ids outside [0, C).  The JAX package
indexes its state with them as XLA does, and the port follows the same
rules so both give the same records:

* an index below 0 counts from the end once (``i + size``);
* a gather then clamps into [0, size);
* a scatter (``.at[i].add/max/set``) drops an index still outside
  [0, size) after that.

PyTorch's own indexing raises on an index past the end, so the twins go
through these helpers; the CUDA kernels apply the same rules
(``jax_index`` and ``clamp_index`` in ``csrc/degrees.cu`` and
``csrc/unionfind.cu``).
"""

from __future__ import annotations

from typing import Tuple

import torch


def normalize(i: torch.Tensor, size: int) -> torch.Tensor:
    """Below 0 counts from the end once."""
    return torch.where(i < 0, i + size, i)


def gather_index(i: torch.Tensor, size: int) -> torch.Tensor:
    """The int64 index a JAX gather reads: normalized, then clamped."""
    return normalize(i.long(), size).clamp(0, size - 1)


def scatter_index(i: torch.Tensor, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64 index, kept): where a JAX scatter writes, and which rows it
    keeps (the rest are dropped; their index is 0)."""
    j = normalize(i.long(), size)
    kept = (j >= 0) & (j < size)
    return torch.where(kept, j, 0), kept


def scatter_add_(out: torch.Tensor, i: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out.at[i].add(values)`` in place; returns ``out``."""
    j, kept = scatter_index(i, out.shape[0])
    return out.index_add_(0, j, torch.where(kept, values, torch.zeros_like(values)))


def scatter_true_(out: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``out.at[i].set(True)`` (equally ``.max(True)``) on a bool vector,
    in place; returns ``out``."""
    j, kept = scatter_index(i, out.shape[0])
    out[j[kept]] = True
    return out
