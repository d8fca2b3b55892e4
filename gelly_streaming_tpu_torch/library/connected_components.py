"""Streaming Connected Components (bulk and tree combine, and the mesh plane).

Port of ``gelly_streaming_tpu/library/connected_components.py`` (reference:
library/ConnectedComponents.java:41-124 and
ConnectedComponentsTree.java:26-36).  The summary is the dense
``(parent, seen)`` tensor pair; both the per-batch fold and the combine are
the batched union-find of ``ops/unionfind.py``, which on the GPU is the
hand-written CUDA kernel of ``csrc/unionfind.cu``.  The fold is order-free,
so CC rides the sorted EF40/BDV wire encodings.

On the mesh plane (``core/aggregation.MeshAggregationRunner``) the
replicated combine is ``collective_parent_seen_combine`` (rounds of local
unions, ``pmin`` and compress to a fixed point) and the owner-sharded
state is ``CCShardedState`` (O(C/S) label and seen blocks a shard, dense
slab or root-delta exchanges, the full view gathered at emission).  The
ring-based ``BlockShardedCC`` and its rounds are not ported yet (ROADMAP
queue A.7).
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.aggregation import (
    SummaryBulkAggregation,
    SummaryTreeAggregation,
)
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.sharded_state import ExchangeStats, ShardedStateSpec, regime_name
from gelly_streaming_tpu_torch.ops import routing as rk
from gelly_streaming_tpu_torch.ops import unionfind as uf
from gelly_streaming_tpu_torch.parallel import routing
from gelly_streaming_tpu_torch.parallel.mesh import block_rows, per_device, pmax, pmin, read_flags, read_host
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

    def mesh_combine_states(self, cfg: StreamConfig):
        """The collective cross-shard combine: ``(mesh, states, has_data) ->
        state`` on the mesh's home device, by the pmin-round fixed point
        (``collective_parent_seen_combine``); ``has_data`` is not read (the
        initial state is the combine identity)."""

        def combine(mesh, states, has_data) -> CCState:
            return CCState(*collective_parent_seen_combine(
                mesh, [st.parent for st in states], [st.seen for st in states]
            ))

        return combine

    def sharded_state_spec(self, cfg: StreamConfig):
        """Owner-sharded summary state: O(C/S) label and seen blocks a
        shard, root-delta exchanges, the full view gathered at emission."""
        return CCShardedState(self)


class ConnectedComponents(_CCMixin, SummaryBulkAggregation):
    """Flat-combine streaming CC (library/ConnectedComponents.java:41-56)."""


class ConnectedComponentsTree(_CCMixin, SummaryTreeAggregation):
    """Tree-combine streaming CC (library/ConnectedComponentsTree.java:26-36)."""


# ---------------------------------------------------------------------------
# owner-sharded summary state (core/sharded_state.py protocol)

_INT32_MAX = (1 << 31) - 1


class CCBlocks(NamedTuple):
    """One shard's owner block of the CC summary: O(C/S) rows."""

    label: torch.Tensor  # int32[C/S]: the forest rows this shard owns
    seen: torch.Tensor  # bool[C/S]


def _accs(mesh):
    """``{device: int32[3]}`` zeroed ``owner_pack`` accumulators."""
    return per_device(mesh, lambda d: torch.zeros((3,), dtype=torch.int32, device=d))


def _read(accs) -> List[List[int]]:
    """Every device's accumulator on the host (one read a device)."""
    return read_host(accs)


def _aranges(mesh, n: int):
    return per_device(mesh, lambda d: torch.arange(n, dtype=torch.int32, device=d))


class CCShardedState(ShardedStateSpec):
    """Block-sharded streaming CC state (vertex g's forest row at (g % S,
    g // S)).  Edges fold where they arrive; an exchange reconciles every
    shard's local partial into the blocks:

      * dense (the delta capacity clamps at C/S, e.g. one exchange over a
        whole wire stream): rounds of {gather the forest, merge the local
        constraints, ship whole per-owner slabs, min-fold them into the
        blocks (``slab_fold``)} until no block changes; then the seen
        slabs, max-folded once;
      * delta: rounds of {gather, compress, merge the local constraints,
        ship only the OLD ROOT rows that remapped (``owner_pack`` into
        ``[S, cap]`` buffers), min-fold them into their owners' rows
        (``block_delta_fold``)} until no root remaps; then the seen rows
        not yet marked, in retried delta passes.

    Hooking old root rows only keeps every non-root chain intact, so a
    spilled row re-derives next round.  The fixed point is the replicated
    combine's, so the gathered emission equals the oracle's min labels.
    """

    route_key = None  # edges stay where they arrive: labels travel, not edges

    def initial_shard_state(self, cfg, num_shards: int):
        return CCBlocks(
            label=init_label_blocks(cfg.vertex_capacity, num_shards),
            seen=np.zeros((num_shards, block_rows(cfg.vertex_capacity, num_shards)), bool),
        )

    def shard_summary(self, summary, cfg, num_shards: int):
        """A (parent [C], seen [C]) summary -> [S, C/S] host blocks."""
        from gelly_streaming_tpu_torch.utils.checkpoint import host_array

        parent = host_array(summary["parent"] if isinstance(summary, dict) else summary.parent)
        seen = host_array(summary["seen"] if isinstance(summary, dict) else summary.seen)
        return CCBlocks(
            label=np.ascontiguousarray(parent.reshape(-1, num_shards).T),
            seen=np.ascontiguousarray(seen.reshape(-1, num_shards).T),
        )

    def delta_bound(self, cfg, n_edges: int) -> int:
        # one merge (one remapped root) a union; both endpoints' seen rows
        return 2 * max(int(n_edges), 1)

    @staticmethod
    def _dense(cfg, ctx) -> bool:
        """True once the delta capacity clamps at C/S: whole slabs cost less
        than (row, value) pairs there, and converge in fewer rounds."""
        return ctx.delta_cap >= cfg.vertex_capacity // ctx.num_shards

    def comm_profile(self, cfg, ctx) -> dict:
        c = cfg.vertex_capacity
        if self._dense(cfg, ctx):
            return {
                "round_nbytes": 2 * routing.gather_blocks_nbytes(c, 4),
                "gather_nbytes": routing.gather_blocks_nbytes(c, 4) + 2 * routing.gather_blocks_nbytes(c, 1),
            }
        return {
            "round_nbytes": routing.gather_blocks_nbytes(c, 4)
            + routing.delta_exchange_nbytes(ctx.num_shards, ctx.delta_cap, 4),
            "gather_nbytes": routing.gather_blocks_nbytes(c, 4)
            + routing.gather_blocks_nbytes(c, 1)
            + routing.delta_exchange_nbytes(ctx.num_shards, ctx.delta_cap, 4),
        }

    def _exchange_dense(self, local_states, blocks, ctx):
        mesh, n = ctx.mesh, ctx.num_shards
        labels = [b.label for b in blocks]
        vs = _aranges(mesh, local_states[0].parent.shape[0])
        occ = _accs(mesh)
        flags = per_device(mesh, lambda d: torch.zeros((1,), dtype=torch.int32, device=d))
        rounds, last = 0, 0
        while True:
            full = routing.gather_blocks(mesh, labels)
            props = []
            for s, d in enumerate(mesh.devices):
                # union_edges works in place: merge into a copy, keep full
                p2 = uf.union_edges(full[s].clone(), vs[d], local_states[s].parent)
                rk.owner_pack(p2 != full[s], None, None, None, n, 0, acc=occ[d])  # rows changed, by owner
                props.append(p2)
            recv = routing.slab_exchange(mesh, props)
            for r, d in enumerate(mesh.devices):
                rk.slab_fold(labels[r], recv[r], "min", flags[d])
            rounds += 1
            now = read_flags(flags)
            if now == last:
                break
            last = now
        seen_recv = routing.slab_exchange(mesh, [ls.seen.to(torch.int32) for ls in local_states])
        out = []
        for r, b in enumerate(blocks):
            sb = b.seen.to(torch.int32)
            rk.slab_fold(sb, seen_recv[r], "max")
            out.append(CCBlocks(labels[r], sb.bool()))
        return out, ExchangeStats(rounds, [a[0] for a in occ.values()], 0, regime_name(ctx, True))

    def exchange(self, local_states, blocks, ctx):
        if self._dense(ctx.cfg, ctx):
            return self._exchange_dense(local_states, blocks, ctx)
        mesh, n, cap = ctx.mesh, ctx.num_shards, ctx.delta_cap
        labels = [b.label for b in blocks]
        vs = _aranges(mesh, local_states[0].parent.shape[0])
        acc = _accs(mesh)
        rounds, total = 0, 0
        while True:
            full = routing.gather_blocks(mesh, labels)
            base = {d: uf.compress(full[ix[0]].clone()) for d, ix in mesh.groups}
            changed, props = [], []
            for s, d in enumerate(mesh.devices):
                p2 = uf.union_edges(uf.clone(base[d]), vs[d], local_states[s].parent)
                # the delta: OLD ROOT rows that remapped
                changed.append((base[d] == vs[d]) & (p2 != vs[d]))
                props.append(p2)
            recv_rows, recv_vals, _ = routing.exchange_slab_deltas(
                mesh, changed, props, n, cap, fill=_INT32_MAX, accs=acc
            )
            for r in range(mesh.size):
                rk.block_delta_fold(labels[r], recv_rows[r], recv_vals[r], "min")
            rounds += 1
            now = sum(a[2] for a in _read(acc))
            if now == total:
                break
            total = now
        # seen: retried delta passes (max == or) of the rows not yet marked;
        # a pass with nothing pending sends nothing and changes nothing
        seen_full = routing.gather_blocks(mesh, [b.seen for b in blocks])
        pending = [local_states[s].seen & ~seen_full[s] for s in range(mesh.size)]
        sb = [b.seen.to(torch.int32) for b in blocks]
        sacc = _accs(mesh)
        spilled = 0
        while True:
            recv_rows, recv_vals, sent = routing.exchange_slab_deltas(
                mesh, pending, [p.to(torch.int32) for p in pending], n, cap, fill=0, accs=sacc, want_sent=True
            )
            for r in range(mesh.size):
                rk.block_delta_fold(sb[r], recv_rows[r], recv_vals[r], "max")
            pending = [p & ~st for p, st in zip(pending, sent)]
            now = sum(a[1] for a in _read(sacc))
            if now == spilled:
                break
            spilled = now
        # rounds meters LABEL rounds only (the seen passes' swap is in
        # gather_nbytes), and their spills do not count
        stats = ExchangeStats(
            rounds, [a[0] for a in acc.values()] + [a[0] for a in sacc.values()], [a[1] for a in acc.values()],
            regime_name(ctx, False),
        )
        return [CCBlocks(labels[r], sb[r].bool()) for r in range(mesh.size)], stats

    def gather_state(self, blocks, ctx):
        home = ctx.mesh.home
        full = routing.gather_full([b.label for b in blocks], home)
        seen = routing.gather_full([b.seen for b in blocks], home)
        # fully compress so the emitted labels are the oracle's min labels
        return CCState(parent=uf.compress(full), seen=seen)


# ---------------------------------------------------------------------------
# the replicated mesh combine


def collective_parent_seen_combine(mesh, parents, seens):
    """Combine per-shard (parent, seen) union-find partials with the mesh's
    collectives (CC's and bipartiteness' ``mesh_combine_states``): each
    partial's pointers are its local constraints (v ~ parent[v]);
    ``sharded_cc_fixpoint`` iterates {apply own constraints, pmin,
    compress} to the closure of every shard's relations, and ``seen`` is
    one ``pmax``.  Returns (parent, seen) on the mesh's home device."""
    vs = _aranges(mesh, parents[0].shape[0])
    combined = sharded_cc_fixpoint(mesh, parents, [vs[d] for d in mesh.devices], parents, None)
    seen_all = pmax(mesh, [sn.to(torch.int32) for sn in seens])[0].bool()
    return combined[0].to(mesh.home), seen_all


def sharded_cc_round(mesh, parents, srcs, dsts, masks=None):
    """One mesh round: every shard's local batched union on a copy of its
    ``parents[s]``, the ``pmin`` over the mesh, compress.  Returns the
    result for each shard (one tensor a device)."""
    q = [
        uf.union_edges(parents[s].clone(), srcs[s], dsts[s], None if masks is None else masks[s])
        for s in range(mesh.size)
    ]
    m = pmin(mesh, q)
    for d, ix in mesh.groups:
        uf.compress(m[ix[0]])
    return m


def sharded_cc_fixpoint(mesh, parents, srcs, dsts, masks=None):
    """Iterate ``sharded_cc_round`` until no shard's labels change (the
    JAX ``while_loop`` + ``pmax`` as a host loop reading one counter a
    device a round).  Each shard's labels start at its ``parents[s]``; the
    round's result is never above them (min-rooted forests), so a
    ``slab_fold`` min of it into each shard's labels both carries it and
    counts whether that shard changed.  Returns each shard's labels."""
    carry = [p.clone() for p in parents]
    flags = per_device(mesh, lambda d: torch.zeros((1,), dtype=torch.int32, device=d))
    last = 0
    while True:
        m = sharded_cc_round(mesh, carry, srcs, dsts, masks)
        for s, d in enumerate(mesh.devices):
            rk.slab_fold(carry[s], [m[s]], "min", flags[d])
        now = read_flags(flags)
        if now == last:
            return carry
        last = now


def init_label_blocks(capacity: int, num_shards: int) -> np.ndarray:
    """[S, C/S] modulo-ownership label blocks, each vertex labeled itself."""
    if capacity % num_shards:
        raise ValueError(f"vertex capacity {capacity} must divide over {num_shards} shards")
    return np.arange(capacity, dtype=np.int32).reshape(-1, num_shards).T.copy()


def unshard_labels(blocks) -> np.ndarray:
    """[S, C/S] modulo blocks -> [C] labels (labels[v] = blocks[v%S, v//S])."""
    return np.asarray(blocks).T.reshape(-1)
