"""Carry state across from the JAX package, through plain Python and numpy.

Nothing here imports the JAX package: a caller that has one exports its
state (``dataclasses.asdict`` of a ``StreamConfig``, ``np.asarray`` of a
``NeighborTable``'s fields) and hands the plain values over.  Packed pane
words (``pack_pane``) are already a shared numpy format.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops.neighbors import NeighborTable

_CONFIG_FIELDS = tuple(f.name for f in dataclasses.fields(StreamConfig))


def config_from_dict(d: Mapping) -> StreamConfig:
    """The port's ``StreamConfig`` from a config dict (e.g. the JAX
    package's ``dataclasses.asdict(cfg)``).  Fields the port's config has
    are taken and validated; the others are ones this slice never reads
    and are dropped."""
    return StreamConfig(**{k: d[k] for k in _CONFIG_FIELDS if k in d})


def neighbor_table_from_numpy(
    nbrs, deg, dropped, device: DeviceLike = None
) -> NeighborTable:
    """A ``NeighborTable`` on ``device`` from host arrays: ``nbrs`` int32
    [C, D] (-1 = empty), ``deg`` int32 [C], ``dropped`` a scalar."""
    nbrs = np.asarray(nbrs, np.int32)
    deg = np.asarray(deg, np.int32)
    if nbrs.ndim != 2 or deg.shape != (nbrs.shape[0],):
        raise ValueError(
            f"expected nbrs [C, D] and deg [C], got {nbrs.shape} and {deg.shape}"
        )
    dev = resolve_device(device)
    return NeighborTable(
        nbrs=torch.from_numpy(nbrs.copy()).to(dev),
        deg=torch.from_numpy(deg.copy()).to(dev),
        dropped=torch.tensor(int(np.asarray(dropped)), dtype=torch.int32, device=dev),
    )
