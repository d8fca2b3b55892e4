"""GraphSAGE-style message passing over sliced windows: serving and
training.

Port of ``gelly_streaming_tpu/library/graphsage.py`` on one device.  Per
closed window each keyed vertex aggregates its neighbors' feature rows
(the masked mean over its degree bucket's row) and projects through
bfloat16 weights:

    h_v = relu(x_v @ W_self + mean_{u in N(v)}(x_u) @ W_nbr + b)

The whole layer is ``ops/sage.sage_layer`` (``csrc/sage.cu`` on the GPU:
one kernel a bucket, the gather, the mean, one product with the stacked
``[W_self; W_nbr]`` on the tensor cores, the bias and ReLU; the
``[x_v | mean]`` rows stay in shared memory).  ``GraphSAGEWindows`` keeps
a bf16 copy of the feature table on its device, made once (the JAX kernel
casts every gathered row to bf16, and rounding commutes with the gather),
and the stacked weights of each layer; each bucket writes its rows into
one [K_window, F_out] buffer a window at its row offset.

Training (``sample_pairs``, ``sage_loss``, ``sage_init_train``,
``sage_train_step``) is the JAX package's unsupervised loss, skip-gram
with negative sampling over one bucket: each keyed row's embedding z_u
scored against the context ``relu(x_v @ W_self + b)`` of one sampled
valid neighbor (positive) and one uniform vertex (negative).  Both the
embeddings and the contexts are ``ops/sage.SageLayerFn``: the contexts
are the same layer over an empty neighborhood (``nbrs`` [2K, 0], so the
mean is 0 and the stacked product is ``x @ W_self`` exactly), positives
and negatives in one launch.  Its backward is the weight-gradient kernel
(``sage_layer_backward``).  The optimizer is ``torch.optim.Adam`` over f32
master parameters (the JAX package's optax Adam: the same update and
defaults; ``interop.sage_train_state_from_numpy`` carries an optax state
across).  ``sample_pairs`` draws from a ``torch.Generator``, not JAX's
random bits.  A bucket from ``build_buckets`` holds its real rows only, so
no padding row enters the loss.

Not ported yet: the sharded plane (``_run_sharded``, ``sage_kernel_ring``,
``sage_loss_mesh``, ``sage_train_step_mesh``; ROADMAP queue A, item 8).
"""

from __future__ import annotations

import itertools
from typing import Iterator, NamedTuple, Tuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.output import OutputStream, RecordBlock
from gelly_streaming_tpu_torch.core.snapshot import SnapshotStream
from gelly_streaming_tpu_torch.core.types import EdgeDirection
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import sage as sage_ops

_SHARDED_MSG = "the sharded GraphSAGE plane (cfg.num_shards > 1 with that many GPUs) is not ported yet (ROADMAP queue A, item 8)"
_MESH_TRAIN_MSG = "GraphSAGE training over a mesh is not ported yet (ROADMAP queue A, item 8)"


class SageParams(NamedTuple):
    w_self: torch.Tensor  # [F_in, F_out] bf16
    w_nbr: torch.Tensor  # [F_in, F_out] bf16
    bias: torch.Tensor  # [F_out] bf16


def init_params(
    in_features: int, out_features: int, *, generator: torch.Generator, device: DeviceLike = None
) -> SageParams:
    """Random layer weights, normal / sqrt(in_features), and a zero bias, all
    bf16 on ``device``, drawn from ``generator`` (not the JAX package's
    numbers: ``interop.sage_params_from_numpy`` carries those across)."""
    dev = resolve_device(device)
    scale = 1.0 / np.sqrt(in_features)

    def normal():
        w = torch.randn((in_features, out_features), generator=generator, device=generator.device) * scale
        return w.to(device=dev, dtype=torch.bfloat16)

    w_self = normal()
    w_nbr = normal()
    return SageParams(w_self, w_nbr, torch.zeros((out_features,), dtype=torch.bfloat16, device=dev))


def sage_kernel(params: SageParams, features, keys, nbrs, valid) -> torch.Tensor:
    """[K] keys + [K, D] neighborhoods -> [K, F_out] bf16 embeddings.
    ``features`` is the [C, F_in] table (cast to bf16 here unless it is)."""
    table = features if features.dtype == torch.bfloat16 else features.to(torch.bfloat16)
    return sage_ops.sage_layer(table.contiguous(), keys, nbrs, valid, _stacked(params), params.bias)


def _stacked(params: SageParams) -> torch.Tensor:
    """[W_self; W_nbr], bf16 [2 F_in, F_out]: one product for both
    projections, so the bias and both products are summed in f32 and
    rounded to bf16 once (two products would round the partial sum too,
    which at 2^20 keys passes the embeddings' bound)."""
    return torch.cat([params.w_self, params.w_nbr], 0).contiguous()


def sage_kernel_ring(*args, **kwargs):
    """The sharded-feature layer of the JAX package's mesh plane."""
    raise NotImplementedError(_SHARDED_MSG)


def _to_host(keys: torch.Tensor, emb: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """(int32 keys, float32 embeddings) as host arrays; from the GPU through
    pinned buffers (torch's caching host allocator reuses them once the
    arrays are dropped)."""
    emb = emb.float()
    if emb.device.type == "cpu":
        return keys.numpy(), emb.numpy()
    keys_h = torch.empty(keys.shape, dtype=keys.dtype, pin_memory=True)
    emb_h = torch.empty(emb.shape, dtype=emb.dtype, pin_memory=True)
    keys_h.copy_(keys, non_blocking=True)
    emb_h.copy_(emb, non_blocking=True)
    torch.cuda.current_stream(emb.device).synchronize()
    return keys_h.numpy(), emb_h.numpy()


class GraphSAGEWindows:
    """Per-window vertex embeddings over a sliced edge stream."""

    def __init__(self, params, features, device: DeviceLike = None):
        # a single SageParams (1 layer) or a sequence (stacked layers: layer
        # l+1 aggregates layer l's window embeddings).  SageParams is itself
        # a (Named)tuple: test for it first.
        layers = [params] if isinstance(params, SageParams) else list(params)
        if not layers or not all(isinstance(p, SageParams) for p in layers):
            raise TypeError("params must be a SageParams or a non-empty sequence of them")
        self.device = resolve_device(device)
        self.layers = [SageParams(*(t.to(device=self.device, dtype=torch.bfloat16) for t in p)) for p in layers]
        self.params = self.layers[0]
        self._weights = [_stacked(p) for p in self.layers]
        feats = features if isinstance(features, torch.Tensor) else torch.from_numpy(np.asarray(features))
        if feats.dtype == torch.float64:
            feats = feats.float()  # the JAX package's 32-bit default, before the bf16 cast
        # the bf16 table every layer-1 gather reads: the only copy on the device
        self._table = feats.to(self.device).to(torch.bfloat16).contiguous()

    def _layer_device(self, layer: int, feats, hoods) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sage layer ``layer`` over a window's buckets: (keys [K], emb [K,
        F_out] bf16) on the device, buckets in order, each bucket's rows
        written into one buffer at its offset."""
        table = feats if feats.dtype == torch.bfloat16 else feats.to(torch.bfloat16).contiguous()
        params, w = self.layers[layer], self._weights[layer]
        hoods = list(hoods)
        keys = torch.cat([hood.keys for hood in hoods])
        emb = torch.empty((keys.shape[0], w.shape[1]), dtype=torch.bfloat16, device=table.device)
        row0 = 0
        for hood in hoods:
            sage_ops.sage_layer(table, hood.keys, hood.nbrs, hood.valid, w, params.bias, out=emb, row0=row0)
            row0 += hood.keys.shape[0]
        return keys, emb

    def _layer_over_buckets(self, feats, hoods):
        """The first sage layer over a window's buckets: (keys [K], emb [K,
        F_out]) host arrays for the window's real rows."""
        return _to_host(*self._layer_device(0, feats, hoods))

    def _hidden(self, keys: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """The window's [C, F_l] bf16 buffer for the next layer: rows for the
        window's keys, zeros elsewhere (the JAX package's ``h[keys] = emb``
        in numpy: a key past the table raises IndexError, and of repeated
        keys, which only key 0 can be, the last row wins)."""
        c = self._table.shape[0]
        if keys.numel() and int(keys.max()) >= c:
            raise IndexError(f"a window key lies past the feature table's {c} rows")
        h = torch.zeros((c + 1, emb.shape[1]), dtype=torch.bfloat16, device=emb.device)
        zero = keys == 0
        last_zero = zero & (torch.cumsum(zero, 0) == zero.sum())
        h.index_copy_(0, torch.where(zero & ~last_zero, c, keys.long()), emb)  # earlier repeats go to row c
        return h[:c]

    def _stack_layers(self, hoods):
        """Run the layer stack over one window's buckets; returns host
        (keys, emb).  Hidden layers read a per-window [C, F_l] buffer built
        on the device: rows for the window's keyed vertices, zeros
        elsewhere."""
        keys = emb = None
        for li in range(len(self.layers)):
            table = self._table if li == 0 else self._hidden(keys, emb)
            keys, emb = self._layer_device(li, table, hoods)
        return _to_host(keys, emb)

    def run(self, snapshot: SnapshotStream) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (keys [K], embeddings [K, F_out]) host arrays per closed
        window, the rows bucket by bucket as the snapshot builds them.

        Stacked layers (a params sequence): layer 1 reads the feature
        table, each deeper layer the previous layer's window embeddings."""
        self._check_direction(snapshot)
        if snapshot._use_mesh():
            raise NotImplementedError(_SHARDED_MSG)
        if snapshot._stream.device != self.device:
            raise ValueError(f"the snapshot's stream lies on {snapshot._stream.device}, the features on {self.device}")
        grouped = itertools.groupby(snapshot._neighborhood_panes(), key=lambda h: h.pane.window_id)
        if len(self.layers) == 1:
            for _, hoods in grouped:
                yield self._layer_over_buckets(self._table, hoods)
            return
        for _, hoods in grouped:
            yield self._stack_layers(list(hoods))

    def _check_direction(self, snapshot: SnapshotStream) -> None:
        """Stacked layers need every in-window vertex keyed so hidden rows
        exist for every neighbor; only slice(ALL) guarantees that."""
        if len(self.layers) > 1 and snapshot.direction != EdgeDirection.ALL:
            raise ValueError("stacked GraphSAGE layers require slice(..., EdgeDirection.ALL)")

    def _run_sharded(self, snapshot: SnapshotStream):
        raise NotImplementedError(_SHARDED_MSG)

    def output(self, snapshot: SnapshotStream) -> OutputStream:
        """(vertex, embedding-norm) records: a compact observable stream."""

        def blocks():
            for keys, emb in self.run(snapshot):
                yield RecordBlock((keys.astype(np.int64), np.linalg.norm(emb, axis=1)))

        return OutputStream(blocks_fn=blocks)


# Objective: skip-gram with negative sampling over the window graph (the
# GraphSAGE paper's unsupervised loss, eq. 1): loss = mean softplus(-z .
# c_pos) over the rows with a positive + mean softplus(z . c_neg).


class SageTrainState(NamedTuple):
    params: SageParams  # float32 masters, leaves that require grad
    opt: torch.optim.Adam  # over the masters; sage_train_step steps it in place


def _as_bf16(params: SageParams) -> SageParams:
    return SageParams(*(p.to(torch.bfloat16) for p in params))


def sample_pairs(generator: torch.Generator, nbrs, valid, capacity: int):
    """One (positive neighbor, negative vertex) pair per keyed row, drawn
    from ``generator`` (on the nbrs' device).

    Returns (pos_ids [K] int32, has_pos [K] bool, neg_ids [K] int32): pos
    a uniformly sampled VALID neighbor (argmax of uniform scores over the
    valid slots, -1 elsewhere; a row with no valid neighbor gets
    ``nbrs[:, 0]`` and has_pos False, contributing no positive term), neg
    a uniform vertex id in [0, capacity)."""
    if generator.device != nbrs.device:
        raise ValueError(f"the generator lies on {generator.device}, nbrs on {nbrs.device}")
    if nbrs.dim() != 2 or nbrs.shape[1] == 0 or valid.shape != nbrs.shape:
        raise ValueError("nbrs and valid must be [K, D] with D >= 1")
    scores = torch.where(valid, torch.rand(valid.shape, generator=generator, device=nbrs.device), -1.0)
    pos_ids = torch.gather(nbrs, 1, scores.argmax(1, keepdim=True))[:, 0]
    neg_ids = torch.randint(0, capacity, (nbrs.shape[0],), generator=generator, device=nbrs.device,
                            dtype=torch.int32)
    return pos_ids, valid.any(1), neg_ids


def _pair_terms(z, c_pos, c_neg, has_pos):
    """(pos_loss_sum, pos_n, neg_loss_sum) float32 scalars and neg_n, the
    row count, a Python float (no copy to the device a step)."""
    pos_s = (z * c_pos).sum(-1)
    neg_s = (z * c_neg).sum(-1)
    w = has_pos.float()
    softplus = torch.nn.functional.softplus
    return (softplus(-pos_s) * w).sum(), w.sum(), softplus(neg_s).sum(), float(z.shape[0])


def _context(layer, params_b: SageParams, w, table, ids):
    """f32 [N, F_out] ``relu(table[ids] @ W_self + b)``: ``layer`` over an
    empty neighborhood."""
    n = ids.shape[0]
    return layer(table, ids, ids.new_empty((n, 0)), torch.empty((n, 0), dtype=torch.bool, device=ids.device), w,
                 params_b.bias).float()


def _loss(layer, params, features, keys, nbrs, valid, pos_ids, has_pos, neg_ids):
    """sage_loss with ``layer`` (``SageLayerFn.apply`` or a plain twin that
    autograd differentiates) computing each layer."""
    table = features if features.dtype == torch.bfloat16 else features.to(torch.bfloat16)
    table = table.contiguous()
    p = _as_bf16(params)
    w = _stacked(p)
    z = layer(table, keys, nbrs, valid, w, p.bias).float()
    k = keys.shape[0]
    c = _context(layer, p, w, table, torch.cat([pos_ids.to(torch.int32), neg_ids.to(torch.int32)]))
    t = _pair_terms(z, c[:k], c[k:], has_pos)
    return t[0] / t[1].clamp(min=1.0) + t[2] / max(t[3], 1.0)


def sage_loss(params: SageParams, features, keys, nbrs, valid, pos_ids, has_pos, neg_ids) -> torch.Tensor:
    """Scalar unsupervised loss on one neighborhood bucket (f32 params in,
    bf16 compute inside: the layer kernels).  ``features`` is the [C,
    F_in] table; pass its bf16 copy, or it is cast on every call."""
    return _loss(sage_ops.SageLayerFn.apply, params, features, keys, nbrs, valid, pos_ids, has_pos, neg_ids)


def _train_state(params: SageParams, lr: float) -> SageTrainState:
    masters = SageParams(*(p.detach().float().clone().requires_grad_() for p in params))
    return SageTrainState(masters, torch.optim.Adam(list(masters), lr=lr, betas=(0.9, 0.999), eps=1e-8))


def sage_init_train(in_features: int, out_features: int, *, lr: float, generator: torch.Generator,
                    device: DeviceLike = None) -> SageTrainState:
    """Float32 master params (``init_params``' draw) and an Adam optimizer
    over them (learning rate ``lr``, optax's defaults)."""
    return _train_state(init_params(in_features, out_features, generator=generator, device=device), lr)


def sage_train_step(state: SageTrainState, features, keys, nbrs, valid, pos_ids, has_pos, neg_ids):
    """One optimizer step; returns (state, loss).  The masters and the
    optimizer are updated in place: the returned state is ``state``."""
    state.opt.zero_grad(set_to_none=True)
    loss = sage_loss(state.params, features, keys, nbrs, valid, pos_ids, has_pos, neg_ids)
    loss.backward()
    state.opt.step()
    return state, loss.detach()


def sage_loss_mesh(*args, **kwargs):
    """The JAX package's loss with rows and features sharded over a mesh."""
    raise NotImplementedError(_MESH_TRAIN_MSG)


def sage_train_step_mesh(*args, **kwargs):
    """The JAX package's optimizer step over a mesh."""
    raise NotImplementedError(_MESH_TRAIN_MSG)
