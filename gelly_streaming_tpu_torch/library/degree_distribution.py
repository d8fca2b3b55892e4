"""Fully-dynamic degree distribution over add/delete edge events.

Port of the single-device part of
``gelly_streaming_tpu/library/degree_distribution.py`` (reference:
example/DegreeDistribution.java:54-132, a 3-stage keyed pipeline: per edge
a +/-1 change for each endpoint; a per-vertex stage emitting (new degree,
+1) / (old degree, -1) and removing vertices at degree 0; a per-degree
stage keeping the histogram and emitting (degree, count) updates).

State is the dense ``deg[C]`` and ``hist[C]`` pair; each event produces up
to four (degree, count) records in the reference's per-event order, by
``ops/degrees.degree_dist_scan`` (``csrc/degrees.cu`` on the GPU).
``DegreeDistributionSummary`` is the windowed add-only summary form: the
per-vertex degree vector, folded by ``ops/degrees.degree_fold``; on the
mesh plane its owner-sharded state is ``DegreeShardedState`` (O(C/S)
degree blocks, dense slab or additive delta exchanges).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.output import OutputStream, RecordBlock
from gelly_streaming_tpu_torch.core.sharded_state import ExchangeStats, ShardedStateSpec, regime_name
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import degrees
from gelly_streaming_tpu_torch.ops import routing as rk
from gelly_streaming_tpu_torch.parallel import routing
from gelly_streaming_tpu_torch.parallel.mesh import block_rows, per_device, read_host


class DegreeDistState(NamedTuple):
    deg: torch.Tensor  # int32[C]
    hist: torch.Tensor  # int32[C]: vertices with each nonzero degree


def init_state(cfg: StreamConfig, device: DeviceLike = None) -> DegreeDistState:
    dev = resolve_device(device)
    return DegreeDistState(
        deg=torch.zeros((cfg.vertex_capacity,), dtype=torch.int32, device=dev),
        hist=torch.zeros((cfg.vertex_capacity,), dtype=torch.int32, device=dev),
    )


def degree_dist_update(state: DegreeDistState, src, dst, sign, mask):
    """Returns (state, records int32[B, 4, 2], record mask bool[B, 4]); the
    state is updated in place.  Per event the slots are [src new-degree,
    src old-degree, dst new-degree, dst old-degree] (degree, count) records,
    masked off where not emitted; ``sign`` None means all additions."""
    recs, rmask = degrees.degree_dist_scan(state.deg, state.hist, src, dst, sign, mask)
    return state, recs, rmask


# ---------------------------------------------------------------------------
# the windowed summary form: the per-vertex degree vector


class DegreeSummaryState(NamedTuple):
    deg: torch.Tensor  # int32[C]


def degree_histogram(deg) -> dict:
    """{degree: vertex count} over vertices with nonzero degree."""
    d = deg.cpu().numpy() if isinstance(deg, torch.Tensor) else np.asarray(deg)
    d = d[d > 0]
    vals, counts = np.unique(d, return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


class DegreeShardedState(ShardedStateSpec):
    """Owner-sharded degree state: O(C/S) deg blocks, additive exchange.

    The local fold accumulates degree deltas since the last exchange in a
    transient dense scratch.  Dense (the delta capacity clamps at C/S): the
    whole per-owner slabs, add-folded once (``slab_fold``).  Delta: only
    the nonzero rows, in retried passes of pow2-bucketed buffers
    (``owner_pack``, ``block_delta_fold``) until nothing is pending; no
    gather is needed to reconcile (addition has no cross-row
    transitivity)."""

    route_key = "src"  # host keyBy on the pack thread localizes src updates

    def initial_shard_state(self, cfg, num_shards: int):
        return DegreeBlocks(deg=np.zeros((num_shards, block_rows(cfg.vertex_capacity, num_shards)), np.int32))

    def shard_summary(self, summary, cfg, num_shards: int):
        from gelly_streaming_tpu_torch.utils.checkpoint import host_array

        deg = host_array(summary["deg"] if isinstance(summary, dict) else summary.deg)
        return DegreeBlocks(deg=np.ascontiguousarray(deg.reshape(-1, num_shards).T))

    def delta_bound(self, cfg, n_edges: int) -> int:
        return 2 * max(int(n_edges), 1)

    @staticmethod
    def _dense(cfg, ctx) -> bool:
        return ctx.delta_cap >= cfg.vertex_capacity // ctx.num_shards

    def comm_profile(self, cfg, ctx) -> dict:
        gather = routing.gather_blocks_nbytes(cfg.vertex_capacity, 4)
        if self._dense(cfg, ctx):
            return {"round_nbytes": routing.slab_exchange_nbytes(cfg.vertex_capacity, 4), "gather_nbytes": gather}
        return {"round_nbytes": routing.delta_exchange_nbytes(ctx.num_shards, ctx.delta_cap, 4),
                "gather_nbytes": gather}

    def exchange(self, local_states, blocks, ctx):
        mesh, n, cap = ctx.mesh, ctx.num_shards, ctx.delta_cap
        local = [ls.deg for ls in local_states]
        acc = per_device(mesh, lambda d: torch.zeros((3,), dtype=torch.int32, device=d))
        if self._dense(ctx.cfg, ctx):
            recv = routing.slab_exchange(mesh, local)
            for s, d in enumerate(mesh.devices):
                rk.owner_pack(local[s] != 0, None, None, None, n, 0, acc=acc[d])  # nonzero rows, by owner
            for r in range(mesh.size):
                rk.slab_fold(blocks[r].deg, recv[r], "add")
            return blocks, ExchangeStats(1, [a[0] for a in acc.values()], 0, regime_name(ctx, True))
        pending = [v != 0 for v in local]
        rounds = total = spilled = 0
        while True:
            recv_rows, recv_vals, sent = routing.exchange_slab_deltas(
                mesh, pending, local, n, cap, fill=0, accs=acc, want_sent=True
            )
            for r in range(mesh.size):
                rk.block_delta_fold(blocks[r].deg, recv_rows[r], recv_vals[r], "add")
            pending = [p & ~st for p, st in zip(pending, sent)]
            now = read_host(acc)
            t, sp = sum(a[2] for a in now), sum(a[1] for a in now)
            if t == total:  # nothing was pending: not a round
                break
            rounds += 1
            total = t
            if sp == spilled:  # every pending row landed
                break
            spilled = sp
        return blocks, ExchangeStats(rounds, [a[0] for a in acc.values()], [a[1] for a in acc.values()],
                                     regime_name(ctx, False))

    def gather_state(self, blocks, ctx):
        return DegreeSummaryState(deg=routing.gather_full([b.deg for b in blocks], ctx.mesh.home))


class DegreeBlocks(NamedTuple):
    deg: torch.Tensor  # int32[C/S]: this shard's owned degree rows


class DegreeDistributionSummary(SummaryBulkAggregation):
    """Dense per-vertex degree fold: update adds 1 to each endpoint's degree
    (in place), combine is elementwise +, transform emits the bare deg
    vector (``degree_histogram`` derives the (degree, count) view).
    Deletions belong to ``DegreeDistribution``."""

    # addition commutes: legal on the sorted EF40 multiset wire encoding
    order_free = True

    def initial_state(self, cfg: StreamConfig, device: torch.device) -> DegreeSummaryState:
        return DegreeSummaryState(deg=torch.zeros((cfg.vertex_capacity,), dtype=torch.int32, device=device))

    def update(self, state, src, dst, val, mask) -> DegreeSummaryState:
        return DegreeSummaryState(deg=degrees.degree_fold(state.deg, src, dst, mask))

    def combine(self, a, b) -> DegreeSummaryState:
        return DegreeSummaryState(deg=a.deg.add_(b.deg))

    def transform(self, state):
        # the bare vector: a NamedTuple would be splatted into the record
        return state.deg

    def sharded_state_spec(self, cfg: StreamConfig):
        return DegreeShardedState(self)


class DegreeDistribution:
    """Continuous (degree, count) histogram-update stream."""

    def run(self, stream) -> OutputStream:
        def blocks():
            state = init_state(stream.cfg, stream.device)
            for batch in stream.batches():
                state, recs, rmask = degree_dist_update(
                    state, batch.src, batch.dst, batch.sign, batch.mask
                )
                # [B, 4, 2] record slots -> one compacted block a batch, in
                # the reference's order (per edge: u-new, u-old, v-new, v-old)
                r_h = recs.cpu().numpy().reshape(-1, 2)
                idx = np.nonzero(rmask.cpu().numpy().reshape(-1))[0]
                if len(idx):
                    yield RecordBlock((r_h[idx, 0].astype(np.int64), r_h[idx, 1].astype(np.int64)))
            self.final_state = state

        return OutputStream(blocks_fn=blocks)
