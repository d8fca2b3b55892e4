"""The aggregation runtime: per-batch device fold, partial combine, running merge.

Port of ``gelly_streaming_tpu/core/aggregation.py``'s single-device paths:
the descriptor (``SummaryAggregation``: initial_state / update / combine /
transform, ``transient_state``, ``order_free``), its two combine strategies
(``SummaryBulkAggregation``'s flat fold, ``SummaryTreeAggregation``'s
rounds of ``degree``-ary groups) and ``run()``'s routing:

* **the wire path** (array-backed or ``from_wire`` streams folded by one
  partition, no wall-clock panes): every wire buffer is packed on the
  prefetcher's pack thread (``io/prefetch.Prefetcher``; superbatch groups
  across the ingest pool, io/ingest.py), uploaded (pinned memory, a side
  stream, an event), unpacked, run through the stream's stages and folded
  into the running state on the device, batch after batch, with no host
  sync; the running state is emitted every ``ingest_window_edges / batch``
  batches and at stream end.  With ``superbatch > 1`` a group of buffers
  travels as one transfer and its rows are folded one after another, which
  is the per-batch fold by construction.  Binned ingest sorts each batch
  by (dst, src) before it is packed; compressed ingest ships it as BDV,
  decoded on the card by the ``bdv_decode`` kernel (ops/wire_decode.py).
  With a checkpoint path the whole fold carry (stage states and summary)
  and the position in full batches are snapshot every
  ``cfg.wire_checkpoint_batches`` batches and at stream end,
  asynchronously: the carry is cloned on the compute stream, copied to
  pinned host memory on a side stream, and a writer thread saves it; the
  fold never waits on the download.
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

Every windowed plane snapshots the running summary and the last folded
window id after each window's record is consumed, restores them on start
and skips the panes folded before the snapshot (the superbatch and async
planes before packing them); ``_maybe_bin_pane`` bins each closed pane
when binned ingest resolves on.  Summary state is exactly-once across
restarts (``utils/recovery.run_supervised``), emissions at-least-once; a
snapshot holds the same leaves as the JAX package's at the same position.

With ``1 < num_shards <=`` the local devices (``parallel/mesh.
local_devices``: the GPUs, or the CPU shards ``set_host_device_count``
allows) the stream runs on the mesh plane, ``MeshAggregationRunner``: the
wire-backed streaming fold (``wire_records``, per-shard rows folded into
per-shard carries, one cross-shard combine or exchange at snapshots and
stream end) and the windowed plane (``run``, round-robin or keyBy-routed
panes folded per shard), each replicated (every shard's partial combined
over the mesh) or owner-sharded (``core/sharded_state.py``, the default
for descriptors with a spec).  With fewer devices ``num_shards > 1`` folds
its partitions one after another on one device.

Descriptors here may update their state IN PLACE (``update`` its first
argument, ``combine`` its first argument): the runtime owns the running
state and clones it before every emission or snapshot that a later fold
could change.
"""

from __future__ import annotations

import os
import queue
import threading
import time
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
    stream_panes,
)
from gelly_streaming_tpu_torch.io import ingest, wire
from gelly_streaming_tpu_torch.io.prefetch import Prefetcher, upload
from gelly_streaming_tpu_torch.ops import unionfind as uf
from gelly_streaming_tpu_torch.utils import checkpoint, metrics


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


def _snapshot_clone(leaf):
    """A leaf's copy for a snapshot: a tensor cloned on its device (on the
    current stream, so before any later in-place fold), the rest as is."""
    return leaf.clone() if isinstance(leaf, torch.Tensor) else leaf


class _SnapshotWriter:
    """The wire path's asynchronous snapshots.  ``put`` clones the carry on
    the compute stream, starts its copy to pinned host memory on a side
    stream that waits for the clone (``async_exec.start_host_fetch``: one
    event after the copies), and hands it to a writer thread that waits on
    that event and saves it atomically.
    A queue of one gives backpressure: a slow disk delays the next
    snapshot, not the fold.  A writer error is raised on the fold thread at
    the next ``put`` or at ``finish``."""

    def __init__(self, path: str, batch: int, device: torch.device):
        self.path = path
        self.batch = batch
        self.device = device
        self.side = torch.cuda.Stream(device=device) if device.type == "cuda" else None
        self.q: "queue.Queue" = queue.Queue(maxsize=1)
        self.err: list = []
        self.thread: Optional[threading.Thread] = None

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            pos, done, (host, ready) = item
            try:
                t0 = time.perf_counter()
                if ready is not None:
                    ready.synchronize()
                t1 = time.perf_counter()
                checkpoint.save_state(self.path, {
                    "summary": host[1],
                    "stages": host[0],
                    "next_batch": np.full((), pos, np.int64),
                    "batch": np.full((), self.batch, np.int64),
                    "done": np.full((), done, bool),
                })
                metrics.checkpoint_record(t1 - t0, time.perf_counter() - t1)
            except BaseException as e:  # raised again on the fold thread
                self.err.append(e)
                return

    def _put_item(self, item) -> bool:
        """A bounded put that cannot deadlock against a writer that died
        while this thread waits on a full queue."""
        while not self.err:
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def put(self, pos: int, done: bool, carry) -> None:
        if self.err:
            raise self.err[0]
        copy = checkpoint.tree_map_leaves(_snapshot_clone, carry)
        if self.side is None:
            fetch = async_exec.HostFetch(copy, None)
        else:
            self.side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self.side):
                fetch = async_exec.start_host_fetch(copy)
            # the clones were made on the compute stream: keep the allocator
            # from reusing them before the side stream's copies have run
            for leaf in checkpoint.flatten(copy)[0]:
                if isinstance(leaf, torch.Tensor):
                    leaf.record_stream(self.side)
        if self.thread is None:
            self.thread = threading.Thread(target=self._run, daemon=True)
            self.thread.start()
        if not self._put_item((pos, done, fetch)):
            raise self.err[0]

    def finish(self, raise_err: bool = True) -> None:
        """Drain the writer; on a dead writer drop what is queued."""
        if self.thread is not None:
            if self._put_item(None):
                self.thread.join()
            else:
                while True:
                    try:
                        self.q.get_nowait()
                    except queue.Empty:
                        break
        if raise_err and self.err:
            raise self.err[0]


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

    def mesh_combine_states(self, cfg: StreamConfig):
        """Optional collective cross-shard combine for the mesh plane:
        ``(mesh, states, has_data) -> state`` reducing every shard's partial
        (``states[s]`` on shard s's device; ``has_data[s]``: its bucket was
        non-empty) into one state on the mesh's home device with the mesh
        collectives; None takes the gather-and-combine fold with empty
        shards masked out."""
        return None

    def sharded_state_spec(self, cfg: StreamConfig):
        """Optional owner-sharded summary state (``core/sharded_state.
        ShardedStateSpec``): O(C/S) owner blocks and delta exchanges, the
        mesh plane's default when supplied and ``cfg.sharded_state`` allows;
        None keeps the replicated combine."""
        return None

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

    def _binned_modes(self, cfg: StreamConfig):
        """The binned and compressed ingest switches for this descriptor:
        ``(binned, compress)``.

        Both reorder a batch into a (dst, src)-sorted multiset, so they are
        legal for order-free folds only: an explicit ``binned_ingest=1`` /
        ``wire_compress=1`` on an order-sensitive descriptor refuses loudly,
        while the ambient env switches quietly keep the arrival order.
        Compression further needs ids in 2^28 (the BDV varint bound) and
        yields to an explicit ``wire_encoding='ef40'``."""
        compress = wire.resolve_wire_compress(cfg)
        binned = wire.resolve_binned_ingest(cfg)
        if not (binned or compress):
            return False, False
        forced = cfg.binned_ingest == 1 or cfg.wire_compress == 1
        if not self.order_free:
            if forced:
                raise ValueError(
                    "binned/compressed ingest ships a (dst, src)-sorted "
                    "multiset; this aggregation is not order-free"
                )
            return False, False
        if compress and cfg.vertex_capacity > 1 << wire.BDV_MAX_ID_BITS:
            if cfg.wire_compress == 1:
                raise ValueError("wire_compress needs vertex_capacity <= 2^28 (BDV varints)")
            compress = False
        if compress and cfg.wire_encoding == "ef40":
            if cfg.wire_compress == 1:
                raise ValueError(
                    "wire_compress and wire_encoding='ef40' are mutually "
                    "exclusive wire formats; pick one"
                )
            compress = False
        return binned, compress

    def _maybe_bin_pane(self, cfg: StreamConfig, pane: WindowPane, width=None) -> WindowPane:
        """A closed pane with its edges (dst, src)-sorted when binned ingest
        resolves on: the same multiset, so order-free folds emit the same
        records.  Valued and timed panes pass through, as do descriptors
        that are not order-free (loudly when forced, ``_binned_modes``),
        and panes packed at an EF40 ``width`` (which regroups by src)."""
        if pane.val is not None or pane.time is not None or pane.num_edges <= 1:
            return pane
        if isinstance(width, tuple):
            return pane
        binned, _compress = self._binned_modes(cfg)
        if not binned:
            return pane
        s, d = wire.sort_edges_binned(pane.src, pane.dst, cfg.vertex_capacity, record_stats=True)
        return pane._replace(src=s, dst=d)

    def _wire_checkpoint_like(self, stream):
        """The wire path's snapshot layout: the whole fold carry (stage
        states and summary) and the position in full batches, with the
        batch size it counts in."""
        cfg = stream.cfg
        return {
            "summary": self.initial_state(cfg, stream.device),
            "stages": tuple(stream._init_stage_states()),
            "next_batch": np.zeros((), np.int64),
            # a resume under another batch size would skip or refold the
            # wrong edges: the stored size makes that an error
            "batch": np.zeros((), np.int64),
            "done": np.zeros((), bool),
        }

    def _wire_restore(self, stream, checkpoint_path: Optional[str], batch: int):
        """A wire-path snapshot as a resume plan: ``(start_batch,
        (stages, summary) | None, done_summary | None)``.  Legacy layouts: a
        windowed snapshot whose global pane finished re-emits its summary;
        any other legacy form (windowed not done, or a bare summary) refolds
        from the start, since window positions do not map to batches."""
        cfg = stream.cfg
        if not checkpoint_path or not checkpoint.checkpoint_exists(checkpoint_path):
            return 0, None, None
        try:
            snap = checkpoint.load_state(checkpoint_path, self._wire_checkpoint_like(stream))
        except ValueError:  # a windowed-layout snapshot
            try:
                legacy = checkpoint.load_state(checkpoint_path, self._checkpoint_like(cfg, stream.device))
            except ValueError:
                return 0, None, None  # a bare summary: no position
            if bool(legacy["global_done"]) and bool(legacy["has_summary"]):
                return 0, None, legacy["summary"]
            return 0, None, None
        if int(snap["batch"]) != batch:
            raise ValueError(
                f"wire checkpoint was written with batch_size "
                f"{int(snap['batch'])}; resuming with {batch} would "
                "misalign the stream position"
            )
        if bool(snap["done"]):
            return 0, None, snap["summary"]
        return int(snap["next_batch"]), (list(snap["stages"]), snap["summary"]), None

    def _wire_records(self, stream, checkpoint_path: Optional[str] = None, restore: bool = True) -> Iterator[tuple]:
        """Fold every wire buffer into the running state on the device;
        emit at ingest-window boundaries and at stream end.  With
        ``checkpoint_path``, snapshot the carry and the batch position every
        ``cfg.wire_checkpoint_batches`` full batches and at stream end; on
        restore the source replays from the start and the folded batches
        are skipped by position, unpacked.  State is exactly-once, the final
        emission at-least-once."""
        cfg = stream.cfg
        dev = stream.device
        packed = stream._wire_packed
        binned = compress = False
        if packed is not None:
            # replayed buffers: the producer chose the encoding
            bufs, batch, width, tail_pair = packed
            src = dst = None
            n_full = len(bufs)
            total_edges = n_full * batch + (len(tail_pair[0]) if tail_pair else 0)
        else:
            src, dst, batch = stream._wire_arrays
            batch = min(batch, max(len(src), 1))
            binned, compress = self._binned_modes(cfg)
            if compress:
                width = (wire.BDV, cfg.vertex_capacity)
            else:
                width = self._wire_width(cfg, batch)
                if binned and isinstance(width, tuple):
                    binned = False  # EF40 regroups each batch by src itself
            n_full = len(src) // batch
            tail_pair = (src[n_full * batch :], dst[n_full * batch :]) if len(src) > n_full * batch else None
            total_edges = len(src)
        start_batch, carry_host, done_summary = self._wire_restore(
            stream, checkpoint_path if restore else None, batch
        )
        if done_summary is not None:
            # the stream was folded whole before: re-emit, do not refold
            yield _as_record(self.transform(done_summary))
            return
        every = cfg.wire_checkpoint_batches
        emit_every = max(0, self._wire_emit_every(cfg, batch))
        # groups never cross an emission or a snapshot boundary, so the
        # records and the snapshots are the per-batch path's
        boundaries = []
        if emit_every:
            boundaries.append((emit_every, start_batch))
        if checkpoint_path and every:
            boundaries.append((every, 0))
        groups = plan_superbatch_groups(n_full - start_batch, max(1, cfg.superbatch), boundaries)
        offsets = []
        o = 0
        for g in groups:
            offsets.append((o, g))
            o += g
        workers = ingest.resolve_workers(cfg.ingest_workers)

        def batch_of(i: int):
            return src[i * batch : (i + 1) * batch], dst[i * batch : (i + 1) * batch]

        def stack(rows):
            """One [g, widest] arena (variable-size BDV buffers pad to the
            group's widest; trailing zeros decode as dropped empty varint
            groups)."""
            widest = max(r.nbytes for r in rows)
            arena = np.zeros((len(rows), widest), np.uint8)
            for j, r in enumerate(rows):
                arena[j, : r.nbytes] = r
            return arena

        def prep(item):
            """(group size, (uint8 buffer,)): one batch's buffer, or a
            group's rows as one [g, nbytes] arena, on the pack thread."""
            o, g = item
            i0 = start_batch + o
            if packed is not None:
                buf = bufs[i0] if g == 1 else stack(bufs[i0 : i0 + g])
            elif compress:
                if g == 1:
                    buf = wire.pack_edges_bdv(*batch_of(i0), cfg.vertex_capacity, record_stats=True)
                else:
                    buf = ingest.pack_bdv_group(src, dst, i0, g, batch, cfg.vertex_capacity, workers)
            elif g == 1:
                s_b, d_b = batch_of(i0)
                if binned:
                    s_b, d_b = wire.sort_edges_binned(s_b, d_b, cfg.vertex_capacity, record_stats=True)
                buf = wire.pack_edges(s_b, d_b, width)
            else:
                # packed straight into the transfer arena, across the pool
                buf = np.empty((g, wire.wire_nbytes(batch, width)), np.uint8)
                if binned:
                    ingest.pack_binned_rows_into(src, dst, i0, g, batch, width, cfg.vertex_capacity, buf, workers)
                else:
                    ingest.pack_rows_into(src, dst, i0, g, batch, width, buf, workers)
            metrics.wire_record_batch(g, g * batch, buf.nbytes)
            return g, (buf,)

        if carry_host is not None:
            stage_states, state = carry_host
        else:
            stage_states, state = stream._init_stage_states(), self.initial_state(cfg, dev)
        # the stream's stages run on each unpacked batch before the fold
        ones = torch.ones((batch,), dtype=torch.bool, device=dev) if stream._stages else None

        def fold(state, s, d, m):
            if not stream._stages:
                return self.update(state, s, d, None, m)
            b = stream._apply_stages(stage_states, EdgeBatch(src=s, dst=d, mask=ones if m is None else m))
            return self.update(state, b.src, b.dst, b.val, b.mask)

        writer = _SnapshotWriter(checkpoint_path, batch, dev) if checkpoint_path else None
        pending_final = True
        pos = start_batch
        since_snap = 0
        try:
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
                    since_snap += g
                    if writer is not None and every and since_snap >= every:
                        # cloned on the compute stream before the next fold
                        writer.put(pos, False, (tuple(stage_states), state))
                        since_snap = 0
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
            if total_edges == 0:
                return
            if pending_final:
                # emitted BEFORE the final snapshot: a crash between the two
                # re-emits on recovery instead of dropping the record
                yield _as_record(self.transform(clone_state(state) if writer is not None else state))
            if writer is not None:
                writer.put(n_full, True, (tuple(stage_states), state))
        except BaseException:
            # GeneratorExit from a consumer that stops early included: shut
            # the writer down without masking the exception in flight
            if writer is not None:
                writer.finish(raise_err=False)
            raise
        if writer is not None:
            writer.finish()

    # -- the windowed paths ----------------------------------------------------

    def _checkpoint_like(self, cfg: StreamConfig, device: torch.device):
        """The windowed planes' snapshot layout: the summary, whether there
        is one, and the stream position (the last folded window id;
        ``global_done`` marks the untimed global pane, id -1, as folded)."""
        return {
            "summary": self.initial_state(cfg, device),
            "has_summary": np.zeros((), bool),
            "last_window": np.full((), -1, np.int64),
            "global_done": np.zeros((), bool),
        }

    def _windowed_snapshot(self, cfg: StreamConfig, device: torch.device, checkpoint_path, restore: bool):
        """The windowed snapshot to restore: the loaded dict, "legacy" for
        a snapshot of another layout, or None when there is none to read."""
        if not (checkpoint_path and restore and checkpoint.checkpoint_exists(checkpoint_path)):
            return None
        try:
            return checkpoint.load_state(checkpoint_path, self._checkpoint_like(cfg, device))
        except ValueError:
            return "legacy"

    def _restore_merge(self, cfg: StreamConfig, device: torch.device, checkpoint_path, restore: bool):
        """(running summary | None, last folded window id, global pane
        done) from a windowed snapshot; (None, -1, False) with none.  A
        legacy bare-summary snapshot restores its summary with no
        position."""
        snap = self._windowed_snapshot(cfg, device, checkpoint_path, restore)
        if snap is None:
            return None, -1, False
        if isinstance(snap, str):  # "legacy"
            return checkpoint.load_state(checkpoint_path, self.initial_state(cfg, device)), -1, False
        running = snap["summary"] if bool(snap["has_summary"]) else None
        return running, int(snap["last_window"]), bool(snap["global_done"])

    def _save_merge(self, checkpoint_path: str, summary, last_window: int, global_done: bool) -> None:
        """One windowed snapshot (transient summaries reset after each
        emission, so they restore with no running summary)."""
        t0 = time.perf_counter()
        checkpoint.save_state(checkpoint_path, {
            "summary": summary,
            "has_summary": np.full((), not self.transient_state, bool),
            "last_window": np.full((), last_window, np.int64),
            "global_done": np.full((), global_done, bool),
        })
        metrics.checkpoint_record(0.0, time.perf_counter() - t0)

    def _merge_loop(self, cfg: StreamConfig, device: torch.device, panes: Iterator, fold_pane,
                    checkpoint_path: Optional[str] = None, restore: bool = True, unwrap: bool = False,
                    release=None, restored: Optional[tuple] = None,
                    fold_is_running: bool = False) -> Iterator[tuple]:
        """The Merger (SummaryAggregation.java:93-135): fold each pane, merge
        it into the running summary, emit one record a window, then snapshot
        the summary and the position when ``checkpoint_path`` is set.  A
        restored position skips the panes folded before the snapshot;
        ``restored`` is ``_restore_merge``'s result when the caller already
        loaded it (to skip panes before packing them).  With
        ``unwrap`` the iterator yields ``(pane, payload)`` pairs and
        ``fold_pane`` gets the payload.  With an async depth (``cfg.
        async_windows`` or ``GELLY_ASYNC_WINDOWS``) it runs as
        ``async_exec.async_merge_loop``, whose drain calls ``release(payload)``
        once the window's fold is complete.  ``fold_is_running`` (the
        owner-sharded mesh plane): ``fold_pane`` folds into persistent
        cross-window state and returns the running summary itself, which
        replaces the last one instead of being combined into it."""
        if restored is None:
            restored = self._restore_merge(cfg, device, checkpoint_path, restore)
        depth = async_exec.resolve_depth(cfg)
        if depth > 0:
            yield from async_exec.async_merge_loop(
                self, cfg, device, panes, fold_pane, clone_state, checkpoint_path, restored, unwrap=unwrap,
                depth=depth, release=release, fold_is_running=fold_is_running,
            )
            return
        running, start_after, global_done = restored
        for item in panes:
            pane, payload = item if unwrap else (item, item)
            if (0 <= pane.window_id <= start_after) or (pane.window_id == -1 and global_done):
                continue  # folded before the snapshot
            pane_summary = fold_pane(payload)
            if pane_summary is None:
                continue
            if running is None or self.transient_state or fold_is_running:
                running = pane_summary
            else:
                running = self.combine(running, pane_summary)
            # emitted BEFORE the snapshot: a crash between the two re-emits
            # this window on recovery instead of dropping it
            yield _as_record(self.transform(running if self.transient_state else clone_state(running)))
            start_after = max(pane.window_id, start_after)
            global_done = global_done or pane.window_id == -1
            if checkpoint_path:
                self._save_merge(checkpoint_path, running, start_after, global_done)
            if self.transient_state:
                running = None

    def _async_pane_records(self, stream, window_ms: int, checkpoint_path: Optional[str] = None,
                            restore: bool = True) -> Iterator[tuple]:
        """The single-partition windowed plane on the async pipeline: each
        pane padded to its pow2 bucket on the prefetcher's pack thread, into
        arenas from an ``ArenaPool`` (pinned on CUDA, so the upload makes no
        second host copy), uploaded on its transfer thread, folded here
        without waiting (``update`` on a fresh initial state, with the
        padding masked), and recycled at drain once its fold is complete.  Panes a restored
        snapshot already folded are skipped before padding."""
        cfg = stream.cfg
        dev = stream.device
        depth = async_exec.resolve_depth(cfg)
        restored = self._restore_merge(cfg, dev, checkpoint_path, restore)
        _running, skip_through, skip_global = restored
        # the retention cap covers the pipeline's own in-flight bound (three
        # arenas a pane across the prefetch and completion queues), so the
        # steady state recycles instead of allocating
        pool = async_exec.ArenaPool(per_shape=2 * depth + 6, pin=dev.type == "cuda")

        def prepare(pane: WindowPane):
            n = pane.num_edges
            if n == 0 or (0 <= pane.window_id <= skip_through) or (pane.window_id == -1 and skip_global):
                return (pane, None, None), None
            # binning rides this pack thread too (order-free folds only)
            pane = self._maybe_bin_pane(cfg, pane)
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
                cfg, dev, ((meta[0], (meta, arrays)) for meta, arrays in pf), fold_prepared, checkpoint_path,
                restore, unwrap=True, release=release, restored=restored,
            )

    def _assemble_superpane_rows(self, panes):
        """Host assembly of a pane group's [rows, E_pad] fold layout:
        numpy ``(src_k, dst_k, val_k | None, mask_k)``, one row a pane, rows
        and E_pad padded to powers of two (the JAX package's shape buckets),
        the padding masked.  The rows fill in place across the ingest pool
        (``io/ingest.fill_pane_rows_into``)."""
        rows = pow2(len(panes))
        e_pad = pow2(max(p.num_edges for p in panes))
        src_k = np.zeros((rows, e_pad), np.int32)
        dst_k = np.zeros((rows, e_pad), np.int32)
        mask_k = np.zeros((rows, e_pad), bool)
        ingest.fill_pane_rows_into(panes, src_k, dst_k, mask_k)
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

    def _superpane_folds(self, stream, window_ms: int, skip_through: int = -1, skip_global: bool = False):
        """(pane, partial summary) pairs with up to ``cfg.superbatch``
        consecutive non-empty panes uploaded and folded together.  Each
        partial equals the per-pane fold: the update sees that window's
        edges in arrival order (binned when binned ingest resolves on), the
        padding masked.  With an async depth the row assembly and upload run
        on the prefetcher's threads and the folds are enqueued here without
        waiting.  ``skip_through`` / ``skip_global``: panes a restored
        snapshot already folded, dropped here before any packing."""
        cfg = stream.cfg
        dev = stream.device
        live = (
            self._maybe_bin_pane(cfg, p)
            for p in stream_panes(stream, window_ms)
            if not ((0 <= p.window_id <= skip_through) or (p.window_id == -1 and skip_global))
        )
        groups = group_panes(live, cfg.superbatch)
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

    def _use_mesh(self, stream) -> bool:
        """The mesh plane: ``1 < num_shards <=`` the stream's local devices."""
        from gelly_streaming_tpu_torch.parallel.mesh import local_devices

        return 1 < stream.cfg.num_shards <= len(local_devices(stream.device))

    def _mesh_wire_eligible(self, stream) -> bool:
        """A wire-backed stream on a real mesh with no ingestion panes: the
        sharded streaming fold (``MeshAggregationRunner.wire_records``)."""
        cfg = stream.cfg
        return (
            (stream._wire_arrays is not None or stream._wire_packed is not None)
            and self._use_mesh(stream)
            and not (cfg.ingest_window_edges or cfg.ingest_window_ms)
        )

    def _mesh_runner(self, stream) -> "MeshAggregationRunner":
        """The runner over ``cfg.num_shards`` of the stream's local devices
        (cached for the descriptor)."""
        from gelly_streaming_tpu_torch.parallel.mesh import local_devices, make_mesh

        key = (stream.cfg.num_shards, stream.device.type)
        runner = getattr(self, "_mesh_runner_cache", None)
        if runner is None or runner[0] != key:
            runner = (key, MeshAggregationRunner(
                self, make_mesh(stream.cfg.num_shards, local_devices(stream.device))
            ))
            self._mesh_runner_cache = runner
        return runner[1]

    def run(self, stream, checkpoint_path: Optional[str] = None, restore: bool = True) -> OutputStream:
        """Execute over an EdgeStream (GraphStream.aggregate): the wire path
        for array-backed and replayed streams folded by one partition, the
        mesh plane when ``num_shards > 1`` has as many local devices, else
        the windowed planes (superbatch, async, or synchronous).

        With ``checkpoint_path`` the running summary and the stream position
        are snapshot as the stream folds and restored on start (``restore``
        False starts fresh), on every plane; the source may replay from the
        beginning.  State is exactly-once, emissions after the last snapshot
        are re-emitted (at-least-once)."""
        cfg = stream.cfg
        if checkpoint_path and cfg.ingest_window_ms:
            raise ValueError(
                "wall-clock ingestion panes (ingest_window_ms) are not "
                "replay-deterministic: a resume would skip panes by id that "
                "cover different edges than the crashed run's; use "
                "ingest_window_edges for checkpointed runs"
            )
        packed = stream._wire_packed
        if packed is not None and isinstance(packed[2], tuple) and not self.order_free:
            raise ValueError(
                f"{packed[2][0]} replay buffers carry a sorted multiset; "
                "this aggregation is not order-free"
            )
        if self._wire_eligible(stream):
            return OutputStream(lambda: self._wire_records(stream, checkpoint_path, restore))
        if self._use_mesh(stream):
            runner = self._mesh_runner(stream)
            if self._mesh_wire_eligible(stream):
                return OutputStream(lambda: runner.wire_records(stream, checkpoint_path, restore))
            return runner.run(stream, checkpoint_path=checkpoint_path, restore=restore)
        n_parts = self._num_partitions(cfg)
        window_ms = self.window_ms or cfg.window_ms
        dev = stream.device
        if cfg.superbatch > 1 and n_parts == 1:

            def records_sb() -> Iterator[tuple]:
                restored = self._restore_merge(cfg, dev, checkpoint_path, restore)
                return self._merge_loop(
                    cfg, dev, self._superpane_folds(stream, window_ms, *restored[1:]),
                    lambda partial: partial, checkpoint_path, restore, unwrap=True, restored=restored,
                )

            return OutputStream(records_sb)
        if async_exec.resolve_depth(cfg) > 0 and n_parts == 1:
            return OutputStream(lambda: self._async_pane_records(stream, window_ms, checkpoint_path, restore))

        def fold_pane(pane: WindowPane):
            # destination-bin the pane first (order-free folds only): the
            # round-robin strided slices of a sorted pane stay sorted
            pane = self._maybe_bin_pane(cfg, pane)
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

        return OutputStream(
            lambda: self._merge_loop(cfg, dev, stream_panes(stream, window_ms), fold_pane, checkpoint_path, restore)
        )


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


# ---------------------------------------------------------------------------
# the mesh plane


def _state_to(state, device: torch.device):
    """A copy of a state tree with every tensor on ``device``."""
    return checkpoint.tree_map_leaves(
        lambda t: t.to(device, copy=True) if isinstance(t, torch.Tensor) else t, state
    )


class _LaggedStats:
    """An exchange's counters on their way to the host: the device values
    copied to pinned memory behind one event, read when the comms counters
    take them (a few panes later on the windowed plane)."""

    def __init__(self, stats, home: torch.device):
        from gelly_streaming_tpu_torch.core.sharded_state import ExchangeStats

        self.ready = None
        fields = []
        for f in (stats.delta_hwm, stats.spilled):
            if isinstance(f, list) and f and home.type == "cuda":
                v = torch.stack([t.to(home) for t in f])
                host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host.copy_(v, non_blocking=True)
                fields.append(list(host))
            else:
                fields.append(f)
        if home.type == "cuda":
            self.ready = torch.cuda.Event()
            self.ready.record(torch.cuda.current_stream(home))
        self.stats = ExchangeStats(stats.rounds, *fields, stats.regime)

    def resolve(self):
        if self.ready is not None:
            self.ready.synchronize()
        return self.stats.resolve()


class MeshAggregationRunner:
    """Execute a SummaryAggregation over a shard mesh (port of the JAX
    package's single-process ``MeshAggregationRunner``).

    Each shard folds its share of the edges on its own device with the
    descriptor's ``update``; the partials then meet over the mesh:

    * replicated (``cfg.sharded_state`` 0, or no spec): the descriptor's
      collective ``mesh_combine_states`` (CC, bipartiteness: the pmin-round
      fixed point), else every partial gathered to the home device and
      folded by the descriptor's combine strategy with empty shards masked
      out;
    * owner-sharded (the descriptor's ``ShardedStateSpec``): the partials
      exchange into O(C/S) owner blocks, and the full summary is gathered
      only to emit.

    ``wire_records`` is the streaming fold of a wire-backed stream: groups
    of S packed rows, one a shard, folded into per-shard carries, with the
    combine (or exchange) at snapshots and stream end; its positional
    snapshots hold the carry (or the blocks) and the group position.
    ``run`` is the windowed plane: each closed pane round-robin bucketed
    (or keyBy-routed by the spec's ``route_key``) and packed on the
    prefetcher's pack thread, each shard's rows uploaded to its device,
    folded and combined (or exchanged and gathered) a pane, merged and
    snapshot by the shared Merger loop.  Shards that share a device run one
    after another on its stream; shards on distinct GPUs overlap, the host
    reading one counter a device a round only inside an exchange.

    ``exchange_regimes`` counts the owner-sharded exchanges by the regime
    each took (``ExchangeStats.regime``), as their stats are read.
    """

    def __init__(self, agg: SummaryAggregation, mesh=None):
        import collections

        from gelly_streaming_tpu_torch.parallel import mesh as mesh_mod

        self.agg = agg
        self.mesh = mesh if mesh is not None else mesh_mod.make_mesh()
        self.exchange_regimes = collections.Counter()

    @property
    def num_shards(self) -> int:
        return self.mesh.size

    # -- the replicated combine -------------------------------------------------

    def _combine_over_mesh(self, cfg: StreamConfig):
        """``(mesh, states, has_data) -> state`` on the home device: the
        descriptor's collective combine, else the masked gather-combine."""
        agg = self.agg
        collective = agg.mesh_combine_states(cfg)
        if collective is not None:
            return collective

        def masked_combine(a, b):
            (sa, va), (sb, vb) = a, b
            if va and vb:
                return agg.combine(sa, sb), True
            return (sa, va) if va else (sb, vb)

        def gather_combine(mesh, states, has_data):
            parts = [(_state_to(st, mesh.home), bool(h)) for st, h in zip(states, has_data)]
            acc, _ = agg._fold_partials(parts, masked_combine, agg._tree_fanin(cfg))
            return acc

        return gather_combine

    def _fold_shards(self, cfg: StreamConfig, srcs, dsts, vals, masks):
        """Every shard's bucket folded into a fresh partial on its device."""
        agg = self.agg
        return [
            agg.update(agg.initial_state(cfg, d), srcs[s], dsts[s], None if vals is None else vals[s], masks[s])
            for s, d in enumerate(self.mesh.devices)
        ]

    def _unpack_rows(self, rows, counts, cap: int, width):
        """Each shard's packed row unpacked on its device, with the mask of
        its first ``counts[s]`` edges (None: all of them)."""
        srcs, dsts, masks = [], [], []
        for s, d in enumerate(self.mesh.devices):
            src, dst = wire.unpack_edges(rows[s], cap, width)
            k = int(counts[s])
            srcs.append(src)
            dsts.append(dst)
            masks.append(None if k == cap else torch.arange(cap, device=d) < k)
        return srcs, dsts, masks

    def _raw_shards(self, arrays, val_proto):
        """(srcs, dsts, vals, masks) per shard from uploaded bucket arrays."""
        src, dst, mask, *leaves = arrays
        vals = None
        if val_proto is not None:
            vals = [_tree_unflatten_like(val_proto, [leaf[s] for leaf in leaves]) for s in range(self.num_shards)]
        return src, dst, vals, mask

    # -- the sharded streaming wire fold ----------------------------------------

    @staticmethod
    def _pack_padded_row(s, d, row_len: int, width):
        """Pack a (possibly short) edge row to ``row_len``: (buffer, fill
        count).  Fixed widths keep position; EF40 sorts, so its pads are
        the maximal id pair and sort to the end."""
        k = len(s)
        if k == row_len:
            return wire.pack_edges(s, d, width), k
        pad_id = width[1] - 1 if isinstance(width, tuple) else 0
        ps = np.full((row_len,), pad_id, np.int32)
        pd = np.full((row_len,), pad_id, np.int32)
        ps[:k] = s
        pd[:k] = d
        return wire.pack_edges(ps, pd, width), k

    def _wire_mesh_plan(self, stream):
        """(row(i), n_rows, row_len, width, total edges): the stream as a
        sequence of per-shard rows, grouped S at a time.  Replay buffers are
        rows as they are; arrays split contiguously at batch / S."""
        cfg = stream.cfg
        S = self.num_shards
        packed = stream._wire_packed
        if packed is not None:
            bufs, batch, width, tail_pair = packed
            n_rows = len(bufs) + (1 if tail_pair else 0)
            total = len(bufs) * batch + (len(tail_pair[0]) if tail_pair else 0)

            def row(i):
                if i < len(bufs):
                    return bufs[i], batch
                return self._pack_padded_row(np.ascontiguousarray(tail_pair[0], np.int32),
                                             np.ascontiguousarray(tail_pair[1], np.int32), batch, width)

            return row, n_rows, batch, width, total
        src, dst, batch = stream._wire_arrays
        total = len(src)
        row_len = max(1, min(batch, max(total, 1)) // S)
        width = self.agg._wire_width(cfg, row_len)
        n_rows = -(-total // row_len) if total else 0
        binned, _compress = self.agg._binned_modes(cfg)
        if binned and isinstance(width, tuple):
            binned = False  # EF40 regroups by src itself

        def row(i):
            s_b = src[i * row_len : (i + 1) * row_len]
            d_b = dst[i * row_len : (i + 1) * row_len]
            if binned:
                s_b, d_b = wire.sort_edges_binned(s_b, d_b, cfg.vertex_capacity, record_stats=True)
            return self._pack_padded_row(s_b, d_b, row_len, width)

        return row, n_rows, row_len, width, total

    def _wire_mesh_checkpoint_like(self, stream, row_len: int):
        """The replicated wire snapshot's layout: every shard's carry
        stacked ``[S, ...]`` (summary, stage states, touched) and the group
        position."""
        from gelly_streaming_tpu_torch.core.sharded_state import stack_blocks

        cfg, S = stream.cfg, self.num_shards
        cpu = torch.device("cpu")
        return {
            "summary": stack_blocks([self.agg.initial_state(cfg, cpu)] * S),
            "stages": self._stack_stages(stream, [[st.init(cfg, cpu) for st in stream._stages]] * S),
            "touched": np.zeros((S,), bool),
            "next_group": np.zeros((), np.int64),
            "row_len": np.zeros((), np.int64),
            "shards": np.zeros((), np.int64),
            "done": np.zeros((), bool),
        }

    def _wire_sharded_checkpoint_like(self, stream, spec, row_len: int):
        """The owner-sharded wire snapshot's layout: the O(C/S) blocks
        instead of the summary and touched."""
        like = self._wire_mesh_checkpoint_like(stream, row_len)
        del like["summary"], like["touched"]
        like["blocks"] = spec.initial_shard_state(stream.cfg, self.num_shards)
        return like

    @staticmethod
    def _stack_stages(stream, stage_states):
        from gelly_streaming_tpu_torch.core.sharded_state import stack_blocks

        if not stream._stages:
            return ()
        return stack_blocks([tuple(st) for st in stage_states])

    def _place_stages(self, stream, host):
        from gelly_streaming_tpu_torch.core.sharded_state import place_blocks

        if not stream._stages:
            return [[] for _ in range(self.num_shards)]
        return [list(st) for st in place_blocks(host, self.mesh)]

    def _check_geometry(self, snap, row_len: int) -> None:
        if int(snap["row_len"]) != row_len or int(snap["shards"]) != self.num_shards:
            raise ValueError(
                f"mesh wire checkpoint was written at row_len {int(snap['row_len'])} x {int(snap['shards'])} "
                f"shards; resuming with {row_len} x {self.num_shards} would misalign the stream position"
            )

    def _load_wire(self, checkpoint_path, restore: bool, like):
        if not (checkpoint_path and restore and checkpoint.checkpoint_exists(checkpoint_path)):
            return None
        try:
            return checkpoint.load_state(checkpoint_path, like)
        except ValueError:
            return None  # another layout: start afresh

    def _wire_prepare(self, row, n_rows: int, row_len: int, width):
        """The pack-thread step: group g's S rows (empty rows past the
        stream's end) in one ``[S, nbytes]`` arena, with their fill counts."""
        S = self.num_shards
        empty = np.empty((0,), np.int32)

        def prepare(g: int):
            # zeros: BDV replay rows are variable-size payloads padded into
            # the widest arena (trailing zeros decode as empty varint groups)
            rows = np.zeros((S, wire.wire_nbytes(row_len, width)), np.uint8)
            counts = np.zeros((S,), np.int32)
            for s in range(S):
                i = g * S + s
                if i < n_rows:
                    buf, counts[s] = row(i)
                else:
                    buf, _ = self._pack_padded_row(empty, empty, row_len, width)
                rows[s, : buf.nbytes] = buf
            metrics.wire_record_batch(S, int(counts.sum()), rows.nbytes)
            return (g, counts), (rows,)

        return prepare

    def _wire_step(self, stream, carry, rows, counts, row_len: int, width) -> None:
        """Fold one group: each shard unpacks its row on its device and runs
        the stages and ``update`` into its carry (stage states, summary,
        touched), with no host sync."""
        agg = self.agg
        for s, d in enumerate(self.mesh.devices):
            k = int(counts[s])
            stages, summary, touched = carry[s]
            if k == 0 and not stream._stages:
                continue  # an empty row folds nothing
            src, dst = wire.unpack_edges(rows[s], row_len, width)
            mask = None if k == row_len else torch.arange(row_len, device=d) < k
            if stream._stages:
                ones = mask if mask is not None else torch.ones((row_len,), dtype=torch.bool, device=d)
                b = stream._apply_stages(stages, EdgeBatch(src=src, dst=dst, mask=ones))
                summary = agg.update(summary, b.src, b.dst, b.val, b.mask)
                touched = b.mask.any() | touched
            else:
                summary = agg.update(summary, src, dst, None, mask)
                touched = True
            carry[s] = (stages, summary, touched)

    def _fresh_carry(self, stream, stages=None):
        cfg = stream.cfg
        return [
            ([st.init(cfg, d) for st in stream._stages] if stages is None else stages[s],
             self.agg.initial_state(cfg, d), False)
            for s, d in enumerate(self.mesh.devices)
        ]

    def _sharded_spec(self, cfg: StreamConfig):
        """The descriptor's ShardedStateSpec when the owner-sharded plane is
        on (``cfg.sharded_state`` / GELLY_SHARDED_STATE), else None."""
        from gelly_streaming_tpu_torch.core.sharded_state import resolve_sharded_state

        if not resolve_sharded_state(cfg):
            return None
        return self.agg.sharded_state_spec(cfg)

    def _shard_ctx(self, cfg: StreamConfig, spec, interval_edges: int):
        """The exchange context; the delta capacity pow2-buckets the spec's
        changed-row bound for one exchange interval."""
        from gelly_streaming_tpu_torch.core.sharded_state import ShardContext
        from gelly_streaming_tpu_torch.parallel import routing
        from gelly_streaming_tpu_torch.parallel.mesh import SHARD_AXIS

        cap = routing.delta_capacity(cfg.vertex_capacity, self.num_shards, spec.delta_bound(cfg, interval_edges))
        return ShardContext(cfg=cfg, num_shards=self.num_shards, axis_name=SHARD_AXIS, delta_cap=cap,
                            mesh=self.mesh)

    def _record_exchange_stats(self, profile: dict, stats) -> None:
        """Fold one exchange's counters into the process comms metrics, and
        its regime into ``exchange_regimes``."""
        stats = stats.resolve()
        self.exchange_regimes[stats.regime] += 1
        metrics.comms_add("comms_exchange_rounds", stats.rounds)
        metrics.comms_high_water("comms_delta_occupancy_hwm", stats.delta_hwm)
        metrics.comms_add("comms_delta_spilled", stats.spilled)
        metrics.comms_add("comms_bytes_exchange", stats.rounds * profile["round_nbytes"])

    def _initial_blocks(self, spec, cfg: StreamConfig):
        from gelly_streaming_tpu_torch.core.sharded_state import place_blocks

        return place_blocks(spec.initial_shard_state(cfg, self.num_shards), self.mesh)

    def _wire_records_sharded(self, stream, spec, checkpoint_path: Optional[str], restore: bool) -> Iterator[tuple]:
        """Owner-sharded ``wire_records``: the same per-shard streaming fold;
        at snapshot boundaries and stream end the local partials exchange
        into the O(C/S) blocks and the scratch resets; the full view is
        gathered only to emit.  Snapshots hold the blocks."""
        from gelly_streaming_tpu_torch.core.sharded_state import place_blocks, stack_blocks

        cfg, agg, S = stream.cfg, self.agg, self.num_shards
        row, n_rows, row_len, width, total_edges = self._wire_mesh_plan(stream)
        n_groups = -(-n_rows // S) if n_rows else 0
        every_groups = max(1, cfg.wire_checkpoint_batches // S) if cfg.wire_checkpoint_batches else 0
        # exchanges happen only at snapshot boundaries, so without a
        # checkpoint path the buffers are sized for the whole stream
        interval_edges = (every_groups if checkpoint_path and every_groups else max(n_groups, 1)) * S * row_len
        ctx = self._shard_ctx(cfg, spec, interval_edges)
        profile = spec.comm_profile(cfg, ctx)

        start_group, blocks, carry_stages = 0, None, None
        snap = self._load_wire(checkpoint_path, restore, self._wire_sharded_checkpoint_like(stream, spec, row_len))
        if snap is not None:
            self._check_geometry(snap, row_len)
            if bool(snap["done"]):
                # folded whole before the crash: re-emit from the blocks
                metrics.comms_add("comms_bytes_gather", profile["gather_nbytes"])
                out = agg.transform(spec.gather_state(place_blocks(snap["blocks"], self.mesh), ctx))
                yield _as_record(out)
                return
            start_group = int(snap["next_group"])
            blocks = place_blocks(snap["blocks"], self.mesh)
            carry_stages = self._place_stages(stream, snap["stages"])
        if blocks is None:
            blocks = self._initial_blocks(spec, cfg)
        carry = self._fresh_carry(stream, carry_stages)

        def exchange():
            nonlocal blocks
            new_blocks, stats = spec.exchange([c[1] for c in carry], blocks, ctx)
            blocks = new_blocks
            for s, d in enumerate(self.mesh.devices):
                carry[s] = (carry[s][0], agg.initial_state(cfg, d), carry[s][2])
            self._record_exchange_stats(profile, stats)

        def save(pos: int, done: bool) -> None:
            t0 = time.perf_counter()
            checkpoint.save_state(checkpoint_path, {
                "blocks": stack_blocks(blocks),
                "stages": self._stack_stages(stream, [c[0] for c in carry]),
                "next_group": np.full((), pos, np.int64),
                "row_len": np.full((), row_len, np.int64),
                "shards": np.full((), S, np.int64),
                "done": np.full((), done, bool),
            })
            metrics.checkpoint_record(0.0, time.perf_counter() - t0)

        since_snap = 0
        prepare = self._wire_prepare(row, n_rows, row_len, width)
        with Prefetcher(range(start_group, n_groups), prepare, self.mesh, depth=cfg.prefetch_depth) as pf:
            for (g, counts), (rows,) in pf:
                self._wire_step(stream, carry, rows, counts, row_len, width)
                metrics.comms_add("comms_dispatches", 1)
                since_snap += 1
                if checkpoint_path and every_groups and since_snap >= every_groups:
                    exchange()
                    save(g + 1, False)
                    since_snap = 0
        if total_edges == 0:
            return
        exchange()
        metrics.comms_add("comms_bytes_gather", profile["gather_nbytes"])
        out = agg.transform(spec.gather_state(blocks, ctx))
        # emitted BEFORE the final snapshot (at-least-once emission)
        yield _as_record(out)
        if checkpoint_path:
            save(n_groups, True)

    def wire_records(self, stream, checkpoint_path: Optional[str] = None, restore: bool = True) -> Iterator[tuple]:
        """The sharded streaming fold over a wire-backed (untimed) stream:
        group after group, S packed rows go to their shards' devices on the
        prefetcher's threads and fold into per-shard carries; the
        cross-shard combine runs once, at stream end (the owner-sharded
        plane exchanges at snapshots too).  Positional snapshots every
        ``cfg.wire_checkpoint_batches`` rows hold the whole ``[S, ...]``
        carry and the group position; a resume skips the groups before it
        unpacked."""
        from gelly_streaming_tpu_torch.core.sharded_state import place_blocks, stack_blocks

        cfg = stream.cfg
        spec = self._sharded_spec(cfg)
        if spec is not None:
            yield from self._wire_records_sharded(stream, spec, checkpoint_path, restore)
            return
        agg, S, mesh = self.agg, self.num_shards, self.mesh
        row, n_rows, row_len, width, total_edges = self._wire_mesh_plan(stream)
        n_groups = -(-n_rows // S) if n_rows else 0
        combine = self._combine_over_mesh(cfg)

        def finish(carry):
            return combine(mesh, [c[1] for c in carry], [bool(c[2]) for c in carry])

        start_group, carry = 0, None
        snap = self._load_wire(checkpoint_path, restore, self._wire_mesh_checkpoint_like(stream, row_len))
        if snap is not None:
            self._check_geometry(snap, row_len)
            restored = list(zip(self._place_stages(stream, snap["stages"]), place_blocks(snap["summary"], mesh),
                                [bool(t) for t in snap["touched"]]))
            if bool(snap["done"]):
                # folded whole before the crash: combine again and re-emit
                yield _as_record(agg.transform(finish(restored)))
                return
            start_group, carry = int(snap["next_group"]), restored
        if carry is None:
            carry = self._fresh_carry(stream)
        every_groups = max(1, cfg.wire_checkpoint_batches // S) if cfg.wire_checkpoint_batches else 0

        def save(pos: int, done: bool) -> None:
            t0 = time.perf_counter()
            checkpoint.save_state(checkpoint_path, {
                "summary": stack_blocks([c[1] for c in carry]),
                "stages": self._stack_stages(stream, [c[0] for c in carry]),
                "touched": np.array([bool(c[2]) for c in carry], bool),
                "next_group": np.full((), pos, np.int64),
                "row_len": np.full((), row_len, np.int64),
                "shards": np.full((), S, np.int64),
                "done": np.full((), done, bool),
            })
            metrics.checkpoint_record(0.0, time.perf_counter() - t0)

        since_snap = 0
        prepare = self._wire_prepare(row, n_rows, row_len, width)
        with Prefetcher(range(start_group, n_groups), prepare, mesh, depth=cfg.prefetch_depth) as pf:
            for (g, counts), (rows,) in pf:
                self._wire_step(stream, carry, rows, counts, row_len, width)
                since_snap += 1
                if checkpoint_path and every_groups and since_snap >= every_groups:
                    save(g + 1, False)
                    since_snap = 0
        if total_edges == 0:
            return
        out = agg.transform(finish(carry))
        # emitted BEFORE the final snapshot (at-least-once emission)
        yield _as_record(out)
        if checkpoint_path:
            save(n_groups, True)

    # -- the windowed plane --------------------------------------------------

    def _pane_cap(self, total: int) -> int:
        from gelly_streaming_tpu_torch.parallel.routing import pow2_bucket

        return pow2_bucket(-(-max(total, 1) // self.num_shards))

    def _bucket_pane(self, pane: WindowPane):
        """Round-robin the pane's edges into ``[S, cap]`` host arrays."""
        n = self.num_shards
        total = len(pane.src)
        cap = self._pane_cap(total)
        src = np.zeros((n, cap), np.int32)
        dst = np.zeros((n, cap), np.int32)
        mask = np.zeros((n, cap), bool)
        val = tree_map(lambda a: np.zeros((n, cap) + a.shape[1:], a.dtype), pane.val)
        for shard in range(n):
            idx = np.arange(shard, total, n)
            k = len(idx)
            src[shard, :k] = pane.src[idx]
            dst[shard, :k] = pane.dst[idx]
            mask[shard, :k] = True
            if val is not None:
                tree_map(lambda buf, a: buf.__setitem__((shard, slice(0, k)), a[idx]), val, pane.val)
        return src, dst, val, mask

    def _pack_pane_wire(self, pane: WindowPane, width):
        """Round-robin + pack the pane into per-shard wire rows: ``([S,
        nbytes] rows, [S] fill counts, cap)``; EF40 pads with the maximal id
        pair so a count prefix selects the real edges."""
        n = self.num_shards
        total = len(pane.src)
        cap = self._pane_cap(total)
        rows = np.zeros((n, wire.wire_nbytes(cap, width)), np.uint8)
        counts = np.zeros((n,), np.int32)
        s = np.zeros((cap,), np.int32)
        d = np.zeros((cap,), np.int32)
        pad_id = width[1] - 1 if isinstance(width, tuple) else 0
        for shard in range(n):
            idx = np.arange(shard, total, n)
            k = len(idx)
            s[:k] = pane.src[idx]
            d[:k] = pane.dst[idx]
            s[k:] = pad_id
            d[k:] = pad_id
            wire.pack_edges_into(s, d, width, rows[shard])
            counts[shard] = k
        return rows, counts, cap

    def _fold_pane(self, cfg: StreamConfig, kind: str, cap: int, counts, val_proto, arrays, width):
        """Every shard's partial of one prepared pane."""
        if kind == "wire":
            srcs, dsts, masks = self._unpack_rows(arrays[0], counts, cap, width)
            return self._fold_shards(cfg, srcs, dsts, None, masks)
        src, dst, vals, mask = self._raw_shards(arrays, val_proto)
        return self._fold_shards(cfg, src, dst, vals, mask)

    def _run_sharded(self, stream, spec, window_ms: int, checkpoint_path: Optional[str], restore: bool,
                     panes=None) -> OutputStream:
        """The windowed plane over owner-sharded state: each closed pane
        routed on the pack thread (host keyBy by ``spec.route_key`` through
        ``parallel/routing.host_route``, or ``io/ingest.parallel_host_route``
        with binned ingest on; else round robin), folded per shard,
        exchanged into the persistent blocks and gathered; the gathered
        running summary rides the Merger loop (``fold_is_running``), so
        emissions and snapshots are the replicated plane's."""
        from gelly_streaming_tpu_torch.core.sharded_state import place_blocks
        from gelly_streaming_tpu_torch.parallel.routing import host_route

        cfg, agg, S, mesh = stream.cfg, self.agg, self.num_shards, self.mesh
        width = agg._wire_width(cfg)
        binned_on, _ = agg._binned_modes(cfg)

        def prepare_with(skip_through: int, skip_global: bool):
            def prepare(pane: WindowPane):
                already = (0 <= pane.window_id <= skip_through) or (pane.window_id == -1 and skip_global)
                if already or len(pane.src) == 0:
                    return (pane, None, 0, None, None), None
                pane = agg._maybe_bin_pane(cfg, pane, width)
                src, dst = pane.src.astype(np.int32), pane.dst.astype(np.int32)
                if pane.val is None:
                    if spec.route_key:
                        if binned_on:
                            routed = ingest.parallel_host_route(src, dst, S, key=spec.route_key,
                                                                workers=cfg.ingest_workers)
                        else:
                            routed = host_route(src, dst, S, key=spec.route_key)
                        counts = routed.mask.sum(axis=1).astype(np.int32)
                        rows = wire.pack_bucket_rows(routed.src, routed.dst, counts, width)
                        return (pane, "wire", routed.src.shape[1], counts, None), (rows,)
                    rows, counts, cap = self._pack_pane_wire(pane, width)
                    return (pane, "wire", cap, counts, None), (rows,)
                if spec.route_key:
                    r = host_route(src, dst, S, key=spec.route_key, val=pane.val)
                    return (pane, "raw", r.src.shape[1], None, r.val), (r.src, r.dst, r.mask, *tree_leaves(r.val))
                b_src, b_dst, b_val, b_mask = self._bucket_pane(pane)
                return (pane, "raw", b_src.shape[1], None, b_val), (b_src, b_dst, b_mask, *tree_leaves(b_val))

            return prepare

        def records() -> Iterator[tuple]:
            import collections

            restored = agg._restore_merge(cfg, mesh.home, checkpoint_path, restore)
            running, skip_through, skip_global = restored
            if running is not None:
                blocks = place_blocks(spec.shard_summary(running, cfg, S), mesh)
            else:
                blocks = self._initial_blocks(spec, cfg)
            initial = spec.initial_shard_state(cfg, S) if agg.transient_state else None
            pending_stats = collections.deque()
            profiles = {}

            def drain_stats(limit: int) -> None:
                while len(pending_stats) > limit:
                    stats, profile = pending_stats.popleft()
                    self._record_exchange_stats(profile, stats)

            def fold_prepared(item):
                nonlocal blocks
                (pane, kind, cap, counts, val_proto), arrays = item
                if kind is None:
                    return None
                ctx = self._shard_ctx(cfg, spec, S * cap)
                profile = profiles.get(ctx.delta_cap)
                if profile is None:
                    profile = profiles[ctx.delta_cap] = spec.comm_profile(cfg, ctx)
                if initial is not None:
                    blocks = place_blocks(initial, mesh)  # transient descriptors reset a window
                local = self._fold_pane(cfg, kind, cap, counts, val_proto, arrays, width)
                blocks, stats = spec.exchange(local, blocks, ctx)
                summary = spec.gather_state(blocks, ctx)
                metrics.comms_add("comms_dispatches", 1)
                metrics.comms_add("comms_bytes_gather", profile["gather_nbytes"])
                # the counters' download lags the pipeline depth
                pending_stats.append((_LaggedStats(stats, mesh.home), profile))
                drain_stats(max(2, cfg.prefetch_depth))
                return summary

            pane_iter = panes() if panes is not None else stream_panes(stream, window_ms)
            try:
                with Prefetcher(pane_iter, prepare_with(skip_through, skip_global), mesh,
                                depth=cfg.prefetch_depth) as pf:
                    yield from agg._merge_loop(
                        cfg, mesh.home, ((meta[0], (meta, dev)) for meta, dev in pf), fold_prepared,
                        checkpoint_path, restore, unwrap=True, restored=restored, fold_is_running=True,
                    )
            finally:
                drain_stats(0)

        return OutputStream(records)

    def run(self, stream, window_ms: Optional[int] = None, checkpoint_path: Optional[str] = None,
            restore: bool = True, panes=None) -> OutputStream:
        """``(transform(running summary),)`` a closed window, through the
        shared Merger loop (positional snapshots and kill-and-resume as on
        one device).  ``panes``: a zero-argument callable returning a
        WindowPane iterator in place of the stream's own panes."""
        cfg, agg, mesh = stream.cfg, self.agg, self.mesh
        window_ms = window_ms or agg.window_ms or cfg.window_ms
        spec = self._sharded_spec(cfg)
        if spec is not None:
            return self._run_sharded(stream, spec, window_ms, checkpoint_path, restore, panes)
        width = agg._wire_width(cfg)
        combine = self._combine_over_mesh(cfg)

        def prepare_with(skip_through: int, skip_global: bool):
            def prepare(pane: WindowPane):
                already = (0 <= pane.window_id <= skip_through) or (pane.window_id == -1 and skip_global)
                if already or len(pane.src) == 0:
                    return (pane, None, 0, None, None), None
                pane = agg._maybe_bin_pane(cfg, pane, width)
                if pane.val is None:
                    rows, counts, cap = self._pack_pane_wire(pane, width)
                    return (pane, "wire", cap, counts, None), (rows,)
                src, dst, val, mask = self._bucket_pane(pane)
                return (pane, "raw", src.shape[1], mask.any(axis=1), val), (src, dst, mask, *tree_leaves(val))

            return prepare

        def fold_prepared(item):
            (pane, kind, cap, counts, val_proto), arrays = item
            if kind is None:
                return None
            states = self._fold_pane(cfg, kind, cap, counts, val_proto, arrays, width)
            has = counts > 0 if kind == "wire" else counts
            return combine(mesh, states, list(has))

        def records() -> Iterator[tuple]:
            restored = agg._restore_merge(cfg, mesh.home, checkpoint_path, restore)
            pane_iter = panes() if panes is not None else stream_panes(stream, window_ms)
            with Prefetcher(pane_iter, prepare_with(*restored[1:]), mesh, depth=cfg.prefetch_depth) as pf:
                yield from agg._merge_loop(
                    cfg, mesh.home, ((meta[0], (meta, dev)) for meta, dev in pf), fold_prepared,
                    checkpoint_path, restore, unwrap=True, restored=restored,
                )

        return OutputStream(records)
