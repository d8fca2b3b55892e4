"""Carry state across from the JAX package, through plain Python and numpy.

Nothing here imports the JAX package: a caller that has one exports its
state (``dataclasses.asdict`` of a ``StreamConfig``, ``np.asarray`` of a
``NeighborTable``'s or a ``CCState``'s fields) and hands the plain values
over (``DegreeDistState``, ``DegreeSummaryState`` and ``BPState`` likewise,
so that both packages can start from the same mid-stream state; the
GraphSAGE weights through ``sage_params_from_numpy``, a training state
with its optax Adam moments through ``sage_train_state_from_numpy``).  Packed
pane words (``pack_pane``) and wire buffers (``io/wire.py``)
are already a shared numpy format.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.library.bipartiteness import BPState
from gelly_streaming_tpu_torch.library.connected_components import CCState
from gelly_streaming_tpu_torch.library.degree_distribution import DegreeDistState, DegreeSummaryState
from gelly_streaming_tpu_torch.library.graphsage import SageParams, SageTrainState, _train_state
from gelly_streaming_tpu_torch.ops.neighbors import NeighborTable
from gelly_streaming_tpu_torch.summaries.disjoint_set import DisjointSet

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


def cc_state_from_numpy(parent, seen, device: DeviceLike = None) -> CCState:
    """A ``CCState`` on ``device`` from host arrays: ``parent`` int32 [C]
    (a forest over [0, C)), ``seen`` bool [C]."""
    parent = np.asarray(parent, np.int32)
    seen = np.asarray(seen, bool)
    if parent.ndim != 1 or seen.shape != parent.shape:
        raise ValueError(f"expected parent [C] and seen [C], got {parent.shape} and {seen.shape}")
    if len(parent) and (parent.min() < 0 or parent.max() >= len(parent)):
        raise ValueError("parent entries must be vertex ids in [0, C)")
    dev = resolve_device(device)
    return CCState(
        parent=torch.from_numpy(parent.copy()).to(dev), seen=torch.from_numpy(seen.copy()).to(dev)
    )


def disjoint_set_from_numpy(parent, seen, device: DeviceLike = None) -> DisjointSet:
    """A ``DisjointSet`` on ``device`` from host ``parent``/``seen`` arrays."""
    state = cc_state_from_numpy(parent, seen, device)
    return DisjointSet(len(state.parent), parent=state.parent, seen=state.seen)


def _int32_vector(x, name: str) -> np.ndarray:
    a = np.asarray(x, np.int32)
    if a.ndim != 1:
        raise ValueError(f"expected {name} [C], got shape {a.shape}")
    return a


def degree_dist_state_from_numpy(deg, hist, device: DeviceLike = None) -> DegreeDistState:
    """A ``DegreeDistState`` on ``device`` from host ``deg`` and ``hist``
    int32 [C] arrays."""
    deg, hist = _int32_vector(deg, "deg"), _int32_vector(hist, "hist")
    if hist.shape != deg.shape:
        raise ValueError(f"deg and hist differ in shape: {deg.shape} and {hist.shape}")
    dev = resolve_device(device)
    return DegreeDistState(deg=torch.from_numpy(deg.copy()).to(dev), hist=torch.from_numpy(hist.copy()).to(dev))


def degree_summary_state_from_numpy(deg, device: DeviceLike = None) -> DegreeSummaryState:
    """A ``DegreeSummaryState`` on ``device`` from a host int32 [C] ``deg``."""
    return DegreeSummaryState(deg=torch.from_numpy(_int32_vector(deg, "deg").copy()).to(resolve_device(device)))


def bp_state_from_numpy(parent2, seen, device: DeviceLike = None) -> BPState:
    """A ``BPState`` on ``device`` from host arrays: ``parent2`` int32 [2C]
    (a forest over the doubled space), ``seen`` bool [C]."""
    parent2 = _int32_vector(parent2, "parent2")
    seen = np.asarray(seen, bool)
    if seen.ndim != 1 or parent2.shape != (2 * seen.shape[0],):
        raise ValueError(f"expected parent2 [2C] and seen [C], got {parent2.shape} and {seen.shape}")
    if len(parent2) and (parent2.min() < 0 or parent2.max() >= len(parent2)):
        raise ValueError("parent2 entries must be node ids in [0, 2C)")
    dev = resolve_device(device)
    return BPState(parent2=torch.from_numpy(parent2.copy()).to(dev), seen=torch.from_numpy(seen.copy()).to(dev))


def _sage_arrays(w_self, w_nbr, bias):
    w_self, w_nbr, bias = (np.asarray(a, np.float32) for a in (w_self, w_nbr, bias))
    if w_self.ndim != 2 or w_nbr.shape != w_self.shape or bias.shape != (w_self.shape[1],):
        raise ValueError(
            f"expected w_self and w_nbr [F_in, F_out] and bias [F_out], got {w_self.shape}, "
            f"{w_nbr.shape} and {bias.shape}"
        )
    return w_self, w_nbr, bias


def sage_params_from_numpy(w_self, w_nbr, bias, device: DeviceLike = None) -> SageParams:
    """``SageParams`` on ``device`` from host arrays, e.g. ``np.asarray`` of
    the JAX package's bf16 parameters (``ml_dtypes.bfloat16``): ``w_self``
    and ``w_nbr`` [F_in, F_out], ``bias`` [F_out].  They pass through
    float32, which holds every bf16 value exactly."""
    dev = resolve_device(device)
    return SageParams(*(torch.from_numpy(a.copy()).to(device=dev, dtype=torch.bfloat16)
                        for a in _sage_arrays(w_self, w_nbr, bias)))


def sage_train_state_from_numpy(w_self, w_nbr, bias, *, lr: float, mu=None, nu=None, count=None,
                                device: DeviceLike = None) -> SageTrainState:
    """A ``SageTrainState`` on ``device`` from the JAX package's training
    state as host arrays: the f32 masters (``np.asarray`` of
    ``state.params``' leaves) and Adam at learning rate ``lr``.  Given
    optax's ``ScaleByAdamState`` (``state.opt_state[0]`` of ``optax.adam``:
    ``mu`` and ``nu``, each three arrays in ``SageParams`` order, and
    ``count``), its moments and step count fill ``torch.optim.Adam``'s
    ``exp_avg``, ``exp_avg_sq`` and ``step``: both packages then take the
    same next step (the same update, lr * m_hat / (sqrt(v_hat) + 1e-8),
    betas (0.9, 0.999))."""
    masters = _sage_arrays(w_self, w_nbr, bias)
    given = [x is not None for x in (mu, nu, count)]
    if any(given) and not all(given):
        raise ValueError("mu, nu and count come together (optax's ScaleByAdamState)")
    dev = resolve_device(device)
    state = _train_state(SageParams(*(torch.from_numpy(a.copy()).to(dev) for a in masters)), lr)
    if not any(given):
        return state
    mu, nu = [_sage_arrays(*m) for m in (mu, nu)]
    if any(a.shape != m.shape for moments in (mu, nu) for a, m in zip(moments, masters)):
        raise ValueError("mu and nu must be shaped like the parameters")
    steps = int(np.asarray(count))
    for p, m, v in zip(state.params, mu, nu):
        state.opt.state[p] = {
            "step": torch.tensor(float(steps), dtype=torch.float32),
            "exp_avg": torch.from_numpy(m.copy()).to(dev),
            "exp_avg_sq": torch.from_numpy(v.copy()).to(dev),
        }
    return state
