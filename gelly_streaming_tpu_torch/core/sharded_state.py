"""Owner-sharded summary state: the SummaryAggregation sharded-state protocol.

Port of ``gelly_streaming_tpu/core/sharded_state.py``.  On the mesh plane
the persistent summary is modulo block-sharded: vertex g's row lives only
on shard g % S at block row g // S, so a shard holds O(C/S) state.
Dispatches fold edges into a per-shard transient full-[C] scratch with the
descriptor's ordinary ``update``; at emission and snapshot boundaries the
scratch reconciles into the owner blocks through the spec's ``exchange``
(dense slabs, or fixed-capacity pow2-bucketed delta buffers of changed
rows: ``parallel/routing.py``), and the full view is gathered only there
(``gather_state``).

Descriptors opt in by returning a ``ShardedStateSpec`` from
``sharded_state_spec(cfg)``; the replicated combine stays the fallback and
the equivalence oracle.  Protocol contract: the initial blocks are the
combine identity, and ``combine(a, update(initial, e)) == update(a, e)``.

The port's hooks take per-shard lists (one process drives every shard,
``parallel/mesh.py``) and run eagerly: an exchange is a host loop that
reads one small counter buffer a device a round (the JAX package's
``while_loop`` + ``pmax``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from gelly_streaming_tpu_torch.parallel.mesh import SHARD_AXIS
from gelly_streaming_tpu_torch.utils import checkpoint
from gelly_streaming_tpu_torch.utils.envswitch import resolve_switch


def reshard_summary(blocks, cfg, old_num_shards: int, new_num_shards: int, rows=None):
    """Re-route owner-sharded host blocks (every leaf ``[old_S, C/old_S,
    ...]``, vertex g at ``(g % S, g // S)``) into the ``[new_S, C/new_S,
    ...]`` geometry: each leaf unsharded through its full ``[C, ...]`` view
    and re-blocked by the same rule, so ``reshard_summary(
    spec.shard_summary(x, cfg, a), cfg, a, b) == spec.shard_summary(x, cfg,
    b)`` leaf for leaf.  ``rows``: None requires every leaf to be
    vertex-keyed (``cfg.vertex_capacity`` rows); "auto" takes each leaf's
    own row count."""
    old_s, new_s = int(old_num_shards), int(new_num_shards)
    cap = cfg.vertex_capacity
    for name, s in (("old", old_s), ("new", new_s)):
        if s <= 0:
            raise ValueError(f"{name} shard count must be positive, got {s}")
        if rows is None and cap % s:
            raise ValueError(
                f"vertex_capacity ({cap}) must be divisible by the {name} shard count ({s}) for even re-sharding"
            )

    def leaf(a):
        a = np.asarray(a)
        if a.ndim < 2 or a.shape[0] != old_s:
            raise ValueError(
                f"block leaf shape {a.shape} does not match the [{old_s}, rows/{old_s}, ...] owner-block layout"
            )
        total = a.shape[0] * a.shape[1]
        if rows is None and total != cap:
            raise ValueError(
                f"block leaf shape {a.shape} does not match the [{old_s}, {cap // old_s}, ...] owner-block layout"
            )
        if total % new_s:
            raise ValueError(
                f"leaf row count ({total}) must be divisible by the new shard count ({new_s}) for even re-sharding"
            )
        full = np.ascontiguousarray(np.swapaxes(a, 0, 1)).reshape((total,) + a.shape[2:])
        return np.ascontiguousarray(np.swapaxes(full.reshape((total // new_s, new_s) + a.shape[2:]), 0, 1))

    return checkpoint.tree_map_leaves(leaf, blocks)


def resolve_sharded_state(cfg) -> bool:
    """Effective sharded-state switch: config > GELLY_SHARDED_STATE > on."""
    return resolve_switch(getattr(cfg, "sharded_state", -1), "GELLY_SHARDED_STATE", default=True)


class ShardContext(NamedTuple):
    """Static per-exchange facts handed to the spec's hooks."""

    cfg: object
    num_shards: int
    axis_name: str = SHARD_AXIS
    #: pow2-bucketed per-(sender, receiver) delta-buffer capacity
    delta_cap: int = 1
    #: the shard mesh (``parallel/mesh.Mesh``) the hooks' collectives run on
    mesh: object = None


class ExchangeStats(NamedTuple):
    """An exchange's counters.  ``rounds`` is a host int (the host loop
    counts it); ``delta_hwm`` and ``spilled`` are ints or lists of int32
    scalar tensors on the shards' devices, reduced (max, sum) when read
    (``resolve``), so the download can lag the pipeline.  ``regime`` is the
    exchange the spec took, as it names it (e.g. ``"delta (delta_cap
    4096)"``); the JAX package's stats have no such field."""

    rounds: object
    delta_hwm: object
    spilled: object
    regime: str = ""

    def resolve(self) -> "ExchangeStats":
        def red(x, fn):
            if isinstance(x, (list, tuple)):
                return fn([int(t) for t in x]) if len(x) else 0
            return int(x)

        return ExchangeStats(int(self.rounds), red(self.delta_hwm, max), red(self.spilled, sum), self.regime)


def regime_name(ctx: ShardContext, dense: bool) -> str:
    """The ``ExchangeStats.regime`` of an exchange over ``ctx``: whole slabs
    (dense) or ``(row, value)`` pairs (delta), with the delta capacity."""
    return f"{'dense' if dense else 'delta'} (delta_cap {ctx.delta_cap})"


def place_blocks(host_blocks, mesh) -> List:
    """``[S, ...]`` host blocks -> per-shard trees of tensors, shard s's on
    its device."""
    return [
        checkpoint.tree_map_leaves(lambda a, s=s, d=d: torch.from_numpy(np.array(np.asarray(a)[s])).to(d),
                                   host_blocks)
        for s, d in enumerate(mesh.devices)
    ]


def stack_blocks(blocks: List):
    """Per-shard trees of tensors -> one tree of ``[S, ...]`` host arrays."""
    leaves = [checkpoint.flatten(b)[0] for b in blocks]
    stacked = [np.stack([checkpoint.host_array(lv[j]) for lv in leaves]) for j in range(len(leaves[0]))]
    return checkpoint.unflatten_like(blocks[0], stacked)


class ShardedStateSpec:
    """Descriptor hooks for the owner-sharded summary plane.

    The local fold is not part of the spec: dispatches fold with the
    descriptor's ordinary ``initial_state``/``update`` into a transient
    full-[C] scratch, so the sharded and replicated planes share one
    updateFun."""

    #: optional host_route key ("src"/"dst"): when set, the mesh runner's
    #: pane prepare buckets edges by owner on the prefetcher's pack thread;
    #: None keeps round-robin panes
    route_key: Optional[str] = None

    def __init__(self, agg):
        self.agg = agg

    # -- host-side hooks ------------------------------------------------------

    def initial_shard_state(self, cfg, num_shards: int):
        """``[S, ...]``-stacked host blocks; MUST be the combine identity."""
        raise NotImplementedError

    def shard_summary(self, summary, cfg, num_shards: int):
        """Host: a full summary -> ``[S, ...]`` owner blocks (the inverse of
        ``gather_state``; seeds blocks from a restored snapshot)."""
        raise NotImplementedError

    def delta_bound(self, cfg, n_edges: int) -> int:
        """Rows that can change in one exchange interval of ``n_edges``
        folded edges (sizes the delta buffers; clamped at C/S)."""
        return 2 * max(int(n_edges), 1)

    def comm_profile(self, cfg, ctx: ShardContext) -> dict:
        """Static per-shard byte costs: ``round_nbytes`` (one exchange pass)
        and ``gather_nbytes`` (one full-view reassembly)."""
        raise NotImplementedError

    # -- device hooks (per-shard lists) ---------------------------------------

    def exchange(self, local_states: List, blocks: List, ctx: ShardContext):
        """Reconcile every shard's local partial (folded since the last
        exchange) into the owner blocks; returns ``(blocks', ExchangeStats)``.
        The blocks are updated in place; the caller resets the scratch."""
        raise NotImplementedError

    def gather_state(self, blocks: List, ctx: ShardContext):
        """Owner blocks -> the full summary on the mesh's home device (emit
        and snapshot boundaries only)."""
        raise NotImplementedError
