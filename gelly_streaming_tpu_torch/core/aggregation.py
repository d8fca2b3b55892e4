"""The aggregation runtime: per-batch device fold, partial combine, running merge.

Port of ``gelly_streaming_tpu/core/aggregation.py``'s single-device paths:
the descriptor (``SummaryAggregation``: initial_state / update / combine /
transform, ``transient_state``, ``order_free``), its two combine strategies
(``SummaryBulkAggregation``'s flat fold, ``SummaryTreeAggregation``'s
rounds of ``degree``-ary groups) and ``run()``'s routing:

* **the wire path** (array-backed or ``from_wire`` streams folded by one
  partition, no wall-clock panes): every wire buffer is uploaded by
  ``io/prefetch.Prefetcher`` (pinned memory, a side stream, an event),
  unpacked, run through the stream's stages and folded into the running
  state on the device, batch after
  batch, with no host sync; the running state is emitted every
  ``ingest_window_edges / batch`` batches and at stream end.  With
  ``superbatch > 1`` a group of buffers travels as one transfer and its
  rows are folded one after another, which is the per-batch fold by
  construction.
* **the synchronous windowed path** (timed and batch-source streams, or
  ``num_shards > 1``): each closed pane is folded per round-robin
  partition and the partials combined, then merged into the running
  summary, which is emitted once per window.
* **the asynchronous window pipeline** (``cfg.async_windows`` or
  ``GELLY_ASYNC_WINDOWS`` > 0, ``core/async_exec.py``): panes padded to a
  power of two on the prefetcher's pack thread into pinned arenas,
  uploaded on its second thread, folded without waiting, and their
  records drained in window order.
* **the windowed superbatch plane** (``cfg.superbatch`` > 1): up to K
  closed panes travel as one [rows, E_pad] transfer and fold one row a
  pane, each on a fresh initial state, with no host sync between the
  rows; the Merger then merges and emits per window, so the records are
  the per-pane path's.  With ``async_windows`` too, the rows are
  assembled and uploaded on the prefetcher's threads.

Descriptors here may update their state IN PLACE (``update`` its first
argument, ``combine`` its first argument): the runtime owns the running
state and clones it before every emission that a later fold could change.
Checkpoints and the binned/compressed ingest are not ported yet (ROADMAP
queue A), so ``_maybe_bin_pane`` has no counterpart here; the mesh runner
waits for ``parallel/`` on NCCL, so ``num_shards > 1`` folds its
partitions one after another on one device.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np
import torch

from gelly_streaming_tpu_torch.core import async_exec
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.output import OutputStream
from gelly_streaming_tpu_torch.core.stream import plan_superbatch_groups
from gelly_streaming_tpu_torch.core.types import EdgeBatch, _tree_unflatten_like, tree_leaves, tree_map
from gelly_streaming_tpu_torch.core.windows import (
    WindowPane,
    group_panes,
    pad_pane_edges,
    pad_rows,
    pow2,
    row_mask,
    stack_rows,
    stream_panes,
)
from gelly_streaming_tpu_torch.io import wire
from gelly_streaming_tpu_torch.io.prefetch import Prefetcher, upload
from gelly_streaming_tpu_torch.ops import unionfind as uf

_ROADMAP = "not ported yet (ROADMAP.md, queue A item 6)"


def clone_state(state):
    """A copy of a state pytree (a tensor, or a tuple/NamedTuple/list/dict
    of them) that later in-place folds cannot change.  A union-find parent
    known flat stays known flat in the copy, so an emitted record's
    readouts launch no compress."""
    if hasattr(state, "_fields"):  # NamedTuple
        return type(state)(*(clone_state(s) for s in state))
    return tree_map(lambda t: uf.clone(t) if isinstance(t, torch.Tensor) else t, state)


def _as_record(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class SummaryAggregation:
    """Abstract aggregation descriptor (SummaryAggregation.java:22-48).

    Subclasses define:
      initial_state(cfg, device) -> S
      update(state, src, dst, val, mask) -> S   fold an edge batch (``mask``
                                        None = every row; may update state)
      combine(a, b) -> S               merge partials (may update a)
      transform(state) -> T            the emitted record
    ``transient_state`` resets the running summary after each emission.
    ``order_free`` marks folds whose result does not depend on edge order;
    only they may take the sorted EF40/BDV wire encodings.
    """

    transient_state: bool = False
    order_free: bool = False

    def __init__(self, window_ms: Optional[int] = None):
        self.window_ms = window_ms

    # -- descriptor hooks -----------------------------------------------------

    def initial_state(self, cfg: StreamConfig, device: torch.device):
        raise NotImplementedError

    def update(self, state, src, dst, val, mask):
        raise NotImplementedError

    def combine(self, a, b):
        raise NotImplementedError

    def transform(self, state):
        return state

    # -- combine strategies ---------------------------------------------------

    def _num_partitions(self, cfg: StreamConfig) -> int:
        return cfg.num_shards

    def _fold_partials(self, items, combine2, fanin: int = 2):
        """Flat left fold over partials (timeWindowAll.reduce analog,
        SummaryBulkAggregation.java:81-83); the tree strategy overrides it."""
        acc = items[0]
        for it in items[1:]:
            acc = combine2(acc, it)
        return acc

    def _tree_fanin(self, cfg: StreamConfig) -> int:
        """Combine-tree fan-in (SummaryTreeReduce's ``degree``, :53-64)."""
        return max(2, cfg.tree_degree)

    def _combine_partials(self, partials, cfg: StreamConfig):
        return self._fold_partials(partials, self.combine, self._tree_fanin(cfg))

    # -- the wire path --------------------------------------------------------

    def _wire_emit_every(self, cfg: StreamConfig, batch: int) -> int:
        """Full batches per running emission on the wire path: 0 = at stream
        end only, -1 = not representable there (an ingest window that does
        not fall on batch boundaries, or a transient summary)."""
        k = cfg.ingest_window_edges
        if not k:
            return 0
        if k % batch or self.transient_state:
            return -1
        return k // batch

    def _wire_eligible(self, stream) -> bool:
        cfg = stream.cfg
        if (
            stream._wire_arrays is None and stream._wire_packed is None
        ) or self._num_partitions(cfg) != 1:
            return False
        if cfg.ingest_window_ms:
            return False  # wall-clock panes need the windowed time plane
        packed = stream._wire_packed
        batch = packed[1] if packed is not None else stream._wire_arrays[2]
        return self._wire_emit_every(cfg, batch) >= 0

    def _wire_width(self, cfg: StreamConfig, batch: Optional[int] = None):
        """The wire encoding for this descriptor and config: "auto" takes
        EF40 when the fold is order-free, ids fit 20 bits, it ships fewer
        bytes at this batch size and the host has two or more cores to
        sort on; else the fixed width."""
        enc = cfg.wire_encoding
        if enc == "auto":
            try:
                cores = len(os.sched_getaffinity(0))
            except AttributeError:
                cores = os.cpu_count() or 1
            width = wire.replay_width(
                cfg.vertex_capacity, batch if batch is not None else cfg.batch_size, self.order_free
            )
            enc = "ef40" if (cores >= 2 and isinstance(width, tuple)) else "plain"
        if enc == "ef40":
            if not self.order_free:
                raise ValueError(
                    "wire_encoding='ef40' ships a sorted multiset; this "
                    "aggregation is not order-free"
                )
            if cfg.vertex_capacity > 1 << 20:
                raise ValueError("ef40 wire encoding needs vertex_capacity <= 2^20")
            return (wire.EF40, cfg.vertex_capacity)
        return wire.width_for_capacity(cfg.vertex_capacity)

    def _wire_records(self, stream) -> Iterator[tuple]:
        """Fold every wire buffer into the running state on the device;
        emit at ingest-window boundaries and at stream end."""
        cfg = stream.cfg
        dev = stream.device
        packed = stream._wire_packed
        if packed is not None:
            bufs, batch, width, tail_pair = packed
            n_full = len(bufs)
            total_edges = n_full * batch + (len(tail_pair[0]) if tail_pair else 0)
        else:
            src, dst, batch = stream._wire_arrays
            batch = min(batch, max(len(src), 1))
            width = self._wire_width(cfg, batch)
            n_full = len(src) // batch
            tail_pair = (src[n_full * batch :], dst[n_full * batch :]) if len(src) > n_full * batch else None
            total_edges = len(src)
        emit_every = max(0, self._wire_emit_every(cfg, batch))
        groups = plan_superbatch_groups(
            n_full, max(1, cfg.superbatch), [(emit_every, 0)] if emit_every else []
        )
        offsets = []
        o = 0
        for g in groups:
            offsets.append((o, g))
            o += g

        def prep(item):
            """(group size, (uint8 buffer,)): one batch's buffer, or a group's
            buffers stacked into one [g, nbytes] arena (variable-size BDV
            buffers pad to the group's widest; trailing zeros are never
            decoded)."""
            o, g = item
            if packed is not None:
                rows = bufs[o : o + g]
            else:
                rows = [
                    wire.pack_edges(src[i * batch : (i + 1) * batch], dst[i * batch : (i + 1) * batch], width)
                    for i in range(o, o + g)
                ]
            if g == 1:
                return 1, (rows[0],)
            widest = max(r.nbytes for r in rows)
            arena = np.zeros((g, widest), np.uint8)
            for j, r in enumerate(rows):
                arena[j, : r.nbytes] = r
            return g, (arena,)

        state = self.initial_state(cfg, dev)
        # the stream's stages run on each unpacked batch before the fold
        stage_states = stream._init_stage_states()
        ones = torch.ones((batch,), dtype=torch.bool, device=dev) if stream._stages else None

        def fold(state, s, d, m):
            if not stream._stages:
                return self.update(state, s, d, None, m)
            b = stream._apply_stages(stage_states, EdgeBatch(src=s, dst=d, mask=ones if m is None else m))
            return self.update(state, b.src, b.dst, b.val, b.mask)

        pending_final = True
        pos = 0
        with Prefetcher(offsets, prep, dev, depth=cfg.prefetch_depth) as pf:
            for g, (buf,) in pf:
                for row in [buf] if g == 1 else buf.unbind(0):
                    s, d = wire.unpack_edges(row, batch, width)
                    state = fold(state, s, d, None)
                pos += g
                if emit_every and pos % emit_every == 0:
                    # the running state IS the merged summary; clone it,
                    # because the next fold updates it in place
                    yield _as_record(self.transform(clone_state(state)))
                    pending_final = pos != n_full or tail_pair is not None
        if tail_pair is not None:
            rem = len(tail_pair[0])
            pad_s = np.zeros((batch,), np.int32)
            pad_d = np.zeros((batch,), np.int32)
            mask = np.zeros((batch,), bool)
            pad_s[:rem] = tail_pair[0]
            pad_d[:rem] = tail_pair[1]
            mask[:rem] = True
            s, d, m = upload((pad_s, pad_d, mask), dev)
            state = fold(state, s, d, m)
        if total_edges and pending_final:
            yield _as_record(self.transform(state))

    # -- the windowed paths ----------------------------------------------------

    def _merge_loop(self, cfg: StreamConfig, panes: Iterator, fold_pane, unwrap: bool = False,
                    release=None) -> Iterator[tuple]:
        """The Merger (SummaryAggregation.java:93-119): fold each pane, merge
        it into the running summary, emit one record a window.  With
        ``unwrap`` the iterator yields ``(pane, payload)`` pairs and
        ``fold_pane`` gets the payload.  With an async depth (``cfg.
        async_windows`` or ``GELLY_ASYNC_WINDOWS``) it runs as
        ``async_exec.async_merge_loop``, whose drain calls ``release(payload)``
        once the window's fold is complete."""
        depth = async_exec.resolve_depth(cfg)
        if depth > 0:
            yield from async_exec.async_merge_loop(
                self, panes, fold_pane, clone_state, unwrap=unwrap, depth=depth, release=release
            )
            return
        running = None
        for item in panes:
            _pane, payload = item if unwrap else (item, item)
            pane_summary = fold_pane(payload)
            if pane_summary is None:
                continue
            if running is None or self.transient_state:
                running = pane_summary
            else:
                running = self.combine(running, pane_summary)
            yield _as_record(self.transform(running if self.transient_state else clone_state(running)))
            if self.transient_state:
                running = None

    def _async_pane_records(self, stream, window_ms: int) -> Iterator[tuple]:
        """The single-partition windowed plane on the async pipeline: each
        pane padded to its pow2 bucket on the prefetcher's pack thread, into
        arenas from an ``ArenaPool`` (pinned on CUDA, so the upload makes no
        second host copy), uploaded on its transfer thread, folded here
        without waiting (``update`` on a fresh initial state, with the
        padding masked), and recycled at drain once its fold is complete."""
        cfg = stream.cfg
        dev = stream.device
        depth = async_exec.resolve_depth(cfg)
        # the retention cap covers the pipeline's own in-flight bound (three
        # arenas a pane across the prefetch and completion queues), so the
        # steady state recycles instead of allocating
        pool = async_exec.ArenaPool(per_shape=2 * depth + 6, pin=dev.type == "cuda")

        def prepare(pane: WindowPane):
            n = pane.num_edges
            if n == 0:
                return (pane, None, None), None
            padded = pow2(n)
            arenas = tuple(pool.acquire((padded,), dt) for dt in (torch.int32, torch.int32, torch.bool))
            pad_pane_edges(pane, out=tuple(a.numpy() for a in arenas))
            val = tree_map(lambda a: pad_rows(a, padded), pane.val)
            return (pane, arenas, val), (*arenas, *tree_leaves(val))

        def fold_prepared(item):
            (_pane, arenas, val_proto), arrays = item
            if arenas is None:
                return None
            src, dst, mask, *leaves = arrays
            val = None if val_proto is None else _tree_unflatten_like(val_proto, leaves)
            return self.update(self.initial_state(cfg, dev), src, dst, val, mask)

        def release(item):
            (_pane, arenas, _val), _arrays = item
            if arenas is not None:
                pool.release(*arenas)

        with Prefetcher(stream_panes(stream, window_ms), prepare, dev, depth=depth + 1, count_stalls=True) as pf:
            yield from self._merge_loop(
                cfg, ((meta[0], (meta, arrays)) for meta, arrays in pf), fold_prepared, unwrap=True, release=release
            )

    def _assemble_superpane_rows(self, panes):
        """Host assembly of a pane group's [rows, E_pad] fold layout:
        numpy ``(src_k, dst_k, val_k | None, mask_k)``, one row a pane, rows
        and E_pad padded to powers of two (the JAX package's shape buckets),
        the padding masked."""
        rows = pow2(len(panes))
        e_pad = pow2(max(p.num_edges for p in panes))
        src_k = stack_rows([p.src for p in panes], rows, e_pad, np.int32)
        dst_k = stack_rows([p.dst for p in panes], rows, e_pad, np.int32)
        mask_k = row_mask([p.num_edges for p in panes], rows, e_pad)
        val_k = None
        if any(p.val is not None for p in panes):
            proto = next(p.val for p in panes if p.val is not None)
            val_k = tree_map(lambda a: np.zeros((rows, e_pad) + a.shape[1:], a.dtype), proto)
            for i, pane in enumerate(panes):
                if pane.val is not None:
                    tree_map(lambda buf, a, i=i: buf.__setitem__((i, slice(0, len(a))), a), val_k, pane.val)
        return src_k, dst_k, val_k, mask_k

    def _fold_rows(self, cfg: StreamConfig, dev: torch.device, panes, val_proto, arrays):
        """(pane, partial) for each pane of a group whose row layout is on
        the device: one ``update`` a real row on a fresh initial state (the
        JAX package's vmap over rows), every row enqueued before any partial
        is handed on, so no host sync falls between them."""
        src_k, dst_k, mask_k, *leaves = arrays
        val_k = None if val_proto is None else _tree_unflatten_like(val_proto, leaves)
        partials = [
            self.update(
                self.initial_state(cfg, dev), src_k[i], dst_k[i],
                None if val_k is None else tree_map(lambda a, i=i: a[i], val_k), mask_k[i],
            )
            for i in range(len(panes))
        ]
        return zip(panes, partials)

    def _superpane_folds(self, stream, window_ms: int):
        """(pane, partial summary) pairs with up to ``cfg.superbatch``
        consecutive non-empty panes uploaded and folded together.  Each
        partial equals the per-pane fold: the update sees that window's
        edges in arrival order, the padding masked.  With an async depth the
        row assembly and upload run on the prefetcher's threads and the
        folds are enqueued here without waiting."""
        cfg = stream.cfg
        dev = stream.device
        groups = group_panes(stream_panes(stream, window_ms), cfg.superbatch)
        depth = async_exec.resolve_depth(cfg)
        if depth > 0:

            def prep(panes):
                src_k, dst_k, val_k, mask_k = self._assemble_superpane_rows(panes)
                return (tuple(panes), val_k), (src_k, dst_k, mask_k, *tree_leaves(val_k))

            with Prefetcher(groups, prep, dev, depth=depth + 1, count_stalls=True) as pf:
                for (panes, val_proto), arrays in pf:
                    yield from self._fold_rows(cfg, dev, panes, val_proto, arrays)
            return
        for panes in groups:
            src_k, dst_k, val_k, mask_k = self._assemble_superpane_rows(panes)
            arrays = upload((src_k, dst_k, mask_k, *tree_leaves(val_k)), dev)
            yield from self._fold_rows(cfg, dev, panes, val_k, arrays)

    def run(self, stream, checkpoint_path: Optional[str] = None) -> OutputStream:
        """Execute over an EdgeStream (GraphStream.aggregate): the wire path
        for array-backed and replayed streams folded by one partition, else
        the windowed planes (superbatch, async, or synchronous)."""
        cfg = stream.cfg
        if checkpoint_path:
            raise NotImplementedError(f"aggregation checkpoints are {_ROADMAP}")
        if cfg.binned_ingest == 1 or cfg.wire_compress == 1:
            raise NotImplementedError(f"binned_ingest / wire_compress are {_ROADMAP}")
        packed = stream._wire_packed
        if packed is not None and isinstance(packed[2], tuple) and not self.order_free:
            raise ValueError(
                f"{packed[2][0]} replay buffers carry a sorted multiset; "
                "this aggregation is not order-free"
            )
        if self._wire_eligible(stream):
            return OutputStream(lambda: self._wire_records(stream))
        n_parts = self._num_partitions(cfg)
        window_ms = self.window_ms or cfg.window_ms
        dev = stream.device
        if cfg.superbatch > 1 and n_parts == 1:
            return OutputStream(
                lambda: self._merge_loop(
                    cfg, self._superpane_folds(stream, window_ms), lambda partial: partial, unwrap=True
                )
            )
        if async_exec.resolve_depth(cfg) > 0 and n_parts == 1:
            return OutputStream(lambda: self._async_pane_records(stream, window_ms))

        def fold_pane(pane: WindowPane):
            partials = []
            for part in range(n_parts):
                # round-robin partitions stand in for the reference's
                # source-subtask tagging (SummaryBulkAggregation.java:93-106)
                sel = np.arange(len(pane.src)) % n_parts == part
                if not sel.any():
                    continue
                src, dst = upload((pane.src[sel].astype(np.int32), pane.dst[sel].astype(np.int32)), dev)
                val = None if pane.val is None else tree_map(
                    lambda a: torch.from_numpy(np.ascontiguousarray(a[sel])).to(dev), pane.val
                )
                partials.append(self.update(self.initial_state(cfg, dev), src, dst, val, None))
            if not partials:
                return None
            return self._combine_partials(partials, cfg)

        return OutputStream(lambda: self._merge_loop(cfg, stream_panes(stream, window_ms), fold_pane))


class SummaryBulkAggregation(SummaryAggregation):
    """Flat combine strategy (SummaryBulkAggregation.java:51-90)."""


class SummaryTreeAggregation(SummaryAggregation):
    """Log-depth combine tree (SummaryTreeReduce.java:47-123): partials merge
    in rounds of ``degree``-ary groups; ``degree`` defaults to
    ``cfg.tree_degree``."""

    def __init__(self, window_ms: Optional[int] = None, degree: Optional[int] = None):
        super().__init__(window_ms)
        self.degree = degree

    def _tree_fanin(self, cfg: StreamConfig) -> int:
        return max(2, self.degree or cfg.tree_degree)

    def _fold_partials(self, items, combine2, fanin: int = 2):
        level = list(items)
        while len(level) > 1:
            nxt = []
            for i in range(0, len(level), fanin):
                group = level[i : i + fanin]
                acc = group[0]
                for it in group[1:]:
                    acc = combine2(acc, it)
                nxt.append(acc)
            level = nxt
        return level[0]
