"""Carry state across from the JAX package, through plain Python and numpy.

Nothing here imports the JAX package: a caller that has one exports its
state (``dataclasses.asdict`` of a ``StreamConfig``, ``np.asarray`` of a
``NeighborTable``'s or a ``CCState``'s fields) and hands the plain values
over (``DegreeDistState``, ``DegreeSummaryState`` and ``BPState`` likewise,
so that both packages can start from the same mid-stream state, and
``ExactTriangleCount``'s ``TriangleCountState`` through
``triangle_state_from_numpy``; the GraphSAGE weights through ``sage_params_from_numpy``, a training state
with its optax Adam moments through ``sage_train_state_from_numpy``; the
spanner's, the matching's and the samplers' states through
``spanner_state_from_numpy``, ``matching_state_from_numpy`` and
``sampler_state_from_numpy``, the samplers' key as the uint32 key data of
``jax.random.key_data``; the three sketch states through
``sketch_state_from_numpy``; a whole snapshot written by the JAX
package's ``utils/checkpoint.save_state`` through ``snapshot_from_jax``,
the owner-sharded mesh plane's ``[S, C/S]`` host blocks onto a mesh's
shard devices through ``cc_blocks_from_numpy`` and
``degree_blocks_from_numpy``).
Packed
pane words (``pack_pane``) and wire buffers (``io/wire.py``)
are already a shared numpy format.  ``config_from_dict`` carries every
field the port's config has, among them the SpMV core's direction knobs
``spmv_direction`` and ``direction_threshold`` (``ops/spmv.py``).
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
from gelly_streaming_tpu_torch.library.matching import MatchingState
from gelly_streaming_tpu_torch.library.sketches import CountMinState, HLLDegreeState, TriangleSketchState
from gelly_streaming_tpu_torch.library.spanner import SpannerState
from gelly_streaming_tpu_torch.ops.exact_triangles import TriangleCountState
from gelly_streaming_tpu_torch.ops.neighbors import NeighborTable
from gelly_streaming_tpu_torch.ops.sampled_triangles import SamplerState
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


def triangle_state_from_numpy(
    nbrs, deg, dropped, local, global_count, device: DeviceLike = None
) -> TriangleCountState:
    """A ``TriangleCountState`` on ``device`` from host arrays (``np.asarray``
    of the JAX package's state: the table's ``nbrs`` int32 [C, D], ``deg``
    int32 [C] and ``dropped``, ``local`` int32 [C], ``global_count`` a
    scalar)."""
    table = neighbor_table_from_numpy(nbrs, deg, dropped, device)
    local = _int32_vector(local, "local")
    if local.shape != table.deg.shape:
        raise ValueError(f"expected local [C] with C = {table.deg.shape[0]}, got {local.shape}")
    dev = table.deg.device
    return TriangleCountState(
        table=table,
        local=torch.from_numpy(local.copy()).to(dev),
        global_count=torch.tensor(int(np.asarray(global_count)), dtype=torch.int32, device=dev),
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


def spanner_state_from_numpy(nbrs, deg, device: DeviceLike = None) -> SpannerState:
    """A ``SpannerState`` on ``device`` from host arrays: ``nbrs`` int32
    [C, D] (-1 = empty), ``deg`` int32 [C]."""
    nbrs = np.asarray(nbrs, np.int32)
    deg = np.asarray(deg, np.int32)
    if nbrs.ndim != 2 or deg.shape != (nbrs.shape[0],):
        raise ValueError(f"expected nbrs [C, D] and deg [C], got {nbrs.shape} and {deg.shape}")
    dev = resolve_device(device)
    return SpannerState(nbrs=torch.from_numpy(nbrs.copy()).to(dev), deg=torch.from_numpy(deg.copy()).to(dev))


def matching_state_from_numpy(partner, weight, device: DeviceLike = None) -> MatchingState:
    """A ``MatchingState`` on ``device`` from host arrays: ``partner``
    int32 [C] (-1 = unmatched), ``weight`` float32 [C]."""
    partner = _int32_vector(partner, "partner")
    weight = np.asarray(weight, np.float32)
    if weight.shape != partner.shape:
        raise ValueError(f"partner and weight differ in shape: {partner.shape} and {weight.shape}")
    dev = resolve_device(device)
    return MatchingState(partner=torch.from_numpy(partner.copy()).to(dev),
                         weight=torch.from_numpy(weight.copy()).to(dev))


def sampler_state_from_numpy(key, edge, third, closed_a, closed_b, edges_seen, seen,
                             device: DeviceLike = None) -> SamplerState:
    """A ``SamplerState`` on ``device`` from host arrays: ``key`` the uint32
    [2] key data (``np.asarray(jax.random.key_data(state.key))``, or of a
    raw ``PRNGKey``), ``edge`` int32 [S, 2], ``third`` int32 [S],
    ``closed_a`` and ``closed_b`` bool [S], ``edges_seen`` a scalar,
    ``seen`` bool [C]."""
    key = np.asarray(key, np.uint32)
    edge = np.asarray(edge, np.int32)
    third = _int32_vector(third, "third")
    closed_a, closed_b, seen = (np.asarray(x, bool) for x in (closed_a, closed_b, seen))
    s = third.shape[0]
    if key.shape != (2,) or edge.shape != (s, 2) or closed_a.shape != (s,) or closed_b.shape != (s,) \
            or seen.ndim != 1:
        raise ValueError(f"expected key [2], edge [S, 2], third, closed_a, closed_b [S] and seen [C], got "
                         f"{key.shape}, {edge.shape}, {third.shape}, {closed_a.shape}, {closed_b.shape}, "
                         f"{seen.shape}")
    dev = resolve_device(device)
    return SamplerState(
        key=torch.from_numpy(key.copy()).to(dev),
        edge=torch.from_numpy(edge.copy()).to(dev),
        third=torch.from_numpy(third.copy()).to(dev),
        closed_a=torch.from_numpy(closed_a.copy()).to(dev),
        closed_b=torch.from_numpy(closed_b.copy()).to(dev),
        edges_seen=torch.tensor(int(np.asarray(edges_seen)), dtype=torch.int32, device=dev),
        seen=torch.from_numpy(seen.copy()).to(dev),
    )


def _registers(x, name: str) -> np.ndarray:
    a = _int32_vector(x, name)
    if len(a) < 1 or len(a) & (len(a) - 1) or (a < 0).any():
        raise ValueError(f"{name} must be non-negative int32 registers of a power-of-two length, got {a.shape}")
    return a


def sketch_state_from_numpy(arrays: Mapping, device: DeviceLike = None):
    """A sketch state on ``device`` from host arrays keyed by the JAX
    state's field names (``{f: np.asarray(v) for f, v in
    state._asdict().items()}``): ``eh`` uint32 [R], ``elo``, ``ehi``
    int32 [R] and ``regs`` int32 [M] give a ``TriangleSketchState`` (its
    ``eh`` as int64 lanes of the u32 hashes); ``verts`` and ``edges``
    int32 [M] an ``HLLDegreeState``; ``grid`` int32 [d * w] a
    ``CountMinState``."""
    fields = set(arrays)
    dev = resolve_device(device)

    def put(a):
        return torch.from_numpy(np.array(a)).to(dev)

    if fields == set(TriangleSketchState._fields):
        eh = np.asarray(arrays["eh"])
        if eh.dtype != np.uint32 or eh.ndim != 1 or len(eh) < 1 or len(eh) & (len(eh) - 1):
            raise ValueError(f"eh must be uint32 hashes of a power-of-two length, got {eh.dtype} {eh.shape}")
        elo, ehi = _int32_vector(arrays["elo"], "elo"), _int32_vector(arrays["ehi"], "ehi")
        if elo.shape != eh.shape or ehi.shape != eh.shape:
            raise ValueError(f"eh, elo and ehi differ in shape: {eh.shape}, {elo.shape}, {ehi.shape}")
        return TriangleSketchState(eh=put(eh.astype(np.int64)), elo=put(elo), ehi=put(ehi),
                                   regs=put(_registers(arrays["regs"], "regs")))
    if fields == set(HLLDegreeState._fields):
        verts, edges = _registers(arrays["verts"], "verts"), _registers(arrays["edges"], "edges")
        if verts.shape != edges.shape:
            raise ValueError(f"verts and edges differ in shape: {verts.shape} and {edges.shape}")
        return HLLDegreeState(verts=put(verts), edges=put(edges))
    if fields == set(CountMinState._fields):
        return CountMinState(grid=put(_int32_vector(arrays["grid"], "grid")))
    raise ValueError(f"no sketch state has the fields {sorted(fields)}")


def snapshot_from_jax(path: str, like):
    """A snapshot the JAX package wrote (``utils/checkpoint.save_state``'s
    ``.npz``: ``leaf_i`` arrays in its leaf order) as the port's state of
    ``like``'s structure, so that a stream checkpointed there resumes here
    (pass the result's file to ``aggregate(..., checkpoint_path=...)``
    after ``utils.checkpoint.save_state``, or use the state directly).

    The port flattens in the JAX package's leaf order (NamedTuple fields and
    tuples in order, dict keys sorted), so leaf i maps onto ``like``'s leaf
    i; the count, shapes and dtypes must agree (``ValueError`` otherwise).
    The JAX structure text (``__treedef__``) is not read.  Tensor leaves
    land on the device and dtype of ``like``'s, numpy leaves stay numpy."""
    from gelly_streaming_tpu_torch.utils import checkpoint

    like_leaves, _ = checkpoint.flatten(like)
    with np.load(checkpoint._normalize(path)) as data:
        names = [k for k in data.files if k.startswith("leaf_")]
        if len(names) != len(like_leaves):
            raise ValueError(f"the snapshot holds {len(names)} leaves, the state {len(like_leaves)}")
        stored = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
    for i, (a, l) in enumerate(zip(stored, like_leaves)):
        want_shape = list(l.shape) if isinstance(l, torch.Tensor) else list(np.shape(l))
        if list(a.shape) != want_shape or str(a.dtype) != checkpoint.dtype_name(l):
            raise ValueError(
                f"leaf {i}: the snapshot holds {a.dtype}{list(a.shape)}, the state "
                f"{checkpoint.dtype_name(l)}{want_shape}"
            )
    return checkpoint.unflatten_like(like, checkpoint.restore_leaves(stored, like_leaves))


def _blocks(x, name: str, dtype, mesh) -> list:
    a = np.asarray(x)
    if a.ndim != 2 or a.shape[0] != mesh.size:
        raise ValueError(f"{name} must be [S, C/S] blocks for {mesh.size} shards, got {list(a.shape)}")
    return [torch.from_numpy(np.array(a[s], dtype=dtype)).to(d) for s, d in enumerate(mesh.devices)]


def cc_blocks_from_numpy(label, seen, mesh) -> list:
    """The JAX package's ``CCBlocks`` host arrays (``label`` int32[S, C/S],
    ``seen`` bool[S, C/S]) as the port's per-shard ``CCBlocks`` on
    ``mesh``'s shard devices (``parallel/mesh.Mesh``)."""
    from gelly_streaming_tpu_torch.library.connected_components import CCBlocks

    return [CCBlocks(lb, sn) for lb, sn in zip(_blocks(label, "label", np.int32, mesh),
                                                _blocks(seen, "seen", bool, mesh))]


def degree_blocks_from_numpy(deg, mesh) -> list:
    """The JAX package's ``DegreeBlocks`` host array (int32[S, C/S]) as the
    port's per-shard ``DegreeBlocks`` on ``mesh``'s shard devices."""
    from gelly_streaming_tpu_torch.library.degree_distribution import DegreeBlocks

    return [DegreeBlocks(d) for d in _blocks(deg, "deg", np.int32, mesh)]
