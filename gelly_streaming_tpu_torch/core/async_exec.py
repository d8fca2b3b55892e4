"""Asynchronous window pipeline: pack, upload, fold and drain overlapped.

Port of ``gelly_streaming_tpu/core/async_exec.py``.  The synchronous
windowed loop pays one host round trip a closed window: the pane is padded
on the dispatch thread, folded, and its emission handed over before the
next pane is even padded, while the device idles.  Here a bounded number
of windows is in flight end to end:

* **pack**: pane padding runs on the prefetcher's pack thread
  (``io/prefetch.Prefetcher``), into reusable arenas (``ArenaPool``),
  pinned on CUDA so that the upload needs no second host copy;
* **transfer**: the non-blocking upload on the prefetcher's second thread
  and side stream, so packing window k + 1 overlaps uploading window k;
* **dispatch**: the consumer thread enqueues each fold without waiting;
  a window's record enters a completion queue with an event recorded after
  its fold (``record_ready``), or with its outputs' copies to pinned host
  memory started (``start_host_fetch``);
* **drain**: the queue resolves in window order, so the records are the
  synchronous path's, in its order.  An arena is released at drain, after
  the event of the fold that consumed it: the fold ran after the upload
  from the arena, so the arena is no longer read.

``cfg.async_windows`` (or the ``GELLY_ASYNC_WINDOWS`` environment variable
when the config leaves it at 0) sets the depth; 0 keeps the synchronous
loop.  The counters land in ``utils/metrics.pipeline_stats``.  The port's
states are tensors that some folds update in place: each record is a clone
of the running state taken when it is dispatched (enqueued on the same
stream before any later combine), so it keeps its own window's values
while it waits in the queue.  With a checkpoint path ``async_merge_loop``
restores the running summary and the position as the synchronous loop
does, and writes each window's snapshot right after its record is
consumed, from a second clone whose download starts when the window is
dispatched.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Iterable, Iterator, NamedTuple, Optional

import torch

from gelly_streaming_tpu_torch.core.types import tree_leaves
from gelly_streaming_tpu_torch.utils import checkpoint, metrics


def resolve_depth(cfg) -> int:
    """Effective async-window depth: explicit config > env var > 0 (sync).

    ``cfg.async_windows`` wins when set; a config left at 0 defers to
    ``GELLY_ASYNC_WINDOWS`` (a non-integer value counts as 0)."""
    n = getattr(cfg, "async_windows", 0)
    if n:
        return max(0, int(n))
    env = os.environ.get("GELLY_ASYNC_WINDOWS")
    if env:
        try:
            return max(0, int(env))
        except ValueError:
            pass
    return 0


class HostFetch(NamedTuple):
    """A tree on its way to the host: ``host`` holds the tree with each CUDA
    tensor leaf replaced by its pinned host copy (CPU leaves as they are),
    ``done`` the event recorded after those copies (None: nothing to wait
    for)."""

    host: object
    done: Optional["torch.cuda.Event"]


def _cuda_device(tree):
    """The device of the first CUDA tensor leaf of ``tree`` (tuples and
    NamedTuples, lists and dicts of tensors), or None."""
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            return leaf.device
    return None


def start_host_fetch(tree) -> HostFetch:
    """Start the device-to-host copy of every CUDA tensor leaf of ``tree``
    (a tensor, or NamedTuples, tuples, lists and dicts of them): a
    non-blocking copy into a pinned host tensor on the current stream, then
    one event after them.  Leaves already on the host need no copy."""
    dev = _cuda_device(tree)
    if dev is None:
        return HostFetch(tree, None)

    def copy(t):
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    host = checkpoint.tree_map_leaves(copy, tree)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return HostFetch(host, done)


def record_ready(tree) -> HostFetch:
    """An event recorded after the work enqueued so far that produces
    ``tree`` (a fold's output), without copying it: ``wait_ready`` on it
    proves that work, and the uploads it read, complete."""
    dev = _cuda_device(tree)
    if dev is None:
        return HostFetch(tree, None)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return HostFetch(tree, done)


def wait_ready(fetch: HostFetch):
    """Block until ``fetch``'s event has completed; returns its host tree.

    The completion-queue drain's synchronization point, the one place the
    pipeline waits on the device; the wait counts as drain stall."""
    t0 = time.perf_counter()
    if fetch.done is not None:
        fetch.done.synchronize()
    metrics.pipeline_add("pipeline_drain_stall_s", time.perf_counter() - t0)
    return fetch.host


class ArenaPool:
    """Reusable host transfer arenas with donation-safe ownership.

    ``acquire(shape, dtype)`` hands out a zeroed CPU tensor (pinned when
    the pool is made with ``pin``), recycled when one is free, freshly
    allocated otherwise; ``release`` returns tensors for reuse, keeping at
    most ``per_shape`` per (shape, dtype) class.  The pool never blocks:
    the number of panes holding arenas is bounded by the prefetcher's
    queues and the completion queue's depth, and a blocking pool could
    deadlock the pack thread against the drain that would release its
    arenas.  Callers release an arena only after the fold that consumed it
    is known complete (``wait_ready`` on its ``record_ready``): on the CPU
    the upload is zero-copy, and on CUDA the non-blocking copy reads the
    pinned arena until it has run."""

    def __init__(self, per_shape: int = 8, pin: bool = False):
        self._per_shape = max(1, per_shape)
        self._pin = pin
        # (shape, dtype) -> free tensors; the pack thread acquires while
        # the drain releases
        self._free: dict = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def acquire(self, shape, dtype: torch.dtype) -> torch.Tensor:
        key = (tuple(shape), dtype)
        with self._lock:
            free = self._free.get(key)
            buf = free.pop() if free else None
        if buf is None:
            return torch.zeros(tuple(shape), dtype=dtype, pin_memory=self._pin)
        buf.zero_()
        return buf

    def release(self, *bufs) -> None:
        with self._lock:
            for buf in bufs:
                if buf is None:
                    continue
                free = self._free.setdefault((tuple(buf.shape), buf.dtype), [])
                if len(free) < self._per_shape:
                    free.append(buf)


def pipelined(
    items: Iterable,
    prepare: Callable,
    dispatch: Callable,
    finish: Callable,
    depth: int,
    device: torch.device,
    prefetch_depth: int = 4,
) -> Iterator:
    """Run items through pack -> upload -> dispatch -> drain with up to
    ``depth`` dispatched, undrained items in flight.

    ``prepare(item) -> (meta, host_arrays)`` runs on the prefetcher's pack
    thread and the upload on its transfer thread; ``dispatch(meta,
    device_arrays) -> handle`` on the caller's thread (it enqueues and must
    not wait); ``finish(meta, handle) -> result`` resolves an item at drain
    time.  Results yield in item order.  On an upstream failure the items
    already dispatched are drained and yielded before it propagates, as
    the sequential loop would have delivered them; on ``GeneratorExit`` the
    queue drains without yielding."""
    from gelly_streaming_tpu_torch.io.prefetch import Prefetcher

    depth = max(1, depth)
    metrics.pipeline_high_water("pipeline_prefetch_depth", prefetch_depth)
    pending: "collections.deque" = collections.deque()

    def drain_one():
        meta, handle = pending.popleft()
        t0 = time.perf_counter()
        out = finish(meta, handle)
        metrics.pipeline_add("pipeline_drain_stall_s", time.perf_counter() - t0)
        metrics.pipeline_add("pipeline_windows_drained", 1)
        return out

    with Prefetcher(items, prepare, device, depth=prefetch_depth, count_stalls=True) as pf:
        it = iter(pf)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    meta, dev = next(it)
                except StopIteration:
                    break
                metrics.pipeline_add("pipeline_dispatch_stall_s", time.perf_counter() - t0)
                pending.append((meta, dispatch(meta, dev)))
                metrics.pipeline_add("pipeline_windows_dispatched", 1)
                metrics.pipeline_high_water("pipeline_inflight_high_water", len(pending))
                while len(pending) > depth:
                    yield drain_one()
        except GeneratorExit:
            # the consumer closed: no yield is legal, but dispatched items
            # still own their uploads; resolve them, discarding results
            while pending:
                drain_one()
            raise
        except BaseException:
            while pending:
                yield drain_one()
            raise
    while pending:
        yield drain_one()


def _as_record(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def async_merge_loop(
    agg,
    cfg,
    device: torch.device,
    panes: Iterator,
    fold_pane: Callable,
    clone: Callable,
    checkpoint_path: Optional[str] = None,
    restored: tuple = (None, -1, False),
    unwrap: bool = False,
    depth: int = 2,
    release: Optional[Callable] = None,
    fold_is_running: bool = False,
) -> Iterator[tuple]:
    """The Merger with a non-blocking completion queue: the asynchronous
    form of ``SummaryAggregation._merge_loop`` (same restore, merge,
    emission order and at-least-once semantics).

    Each window's fold and combine are enqueued without waiting, and its
    record (``transform`` of a ``clone`` of the running state, so that
    later in-place combines cannot reach it) enters the queue; records
    yield in window order once more than ``depth`` are queued.  With
    ``checkpoint_path`` a second clone of the running state starts its
    download when the window is dispatched, and the window's snapshot is
    saved right after its record is consumed: the synchronous loop's
    emit-before-snapshot order, so a crash at any drain point leaves the
    same snapshot and emission frontier.  ``restored``: the caller's
    ``_restore_merge`` result (running summary | None, last folded window
    id, global pane done); the panes folded before it are skipped.  With ``unwrap`` the iterator yields ``(pane,
    payload)`` pairs and ``fold_pane`` gets the payload.
    ``release(payload)`` (optional) recycles a window's transfer arenas at
    drain, after ``wait_ready`` on the event recorded right after its fold
    (the fold output, not the record, is the wait target: the record may be
    a host wrapper such as CC's DisjointSet).  ``fold_is_running``: the
    fold returns the running summary itself (the owner-sharded mesh plane),
    so it is not combined into the last one."""
    running, start_after, global_done = restored
    # (window id, record, snapshot fetch or None, payload or None, the
    # fold's ready handle or None) in window order
    pending: "collections.deque" = collections.deque()
    drained_through, drained_global = start_after, global_done

    def drain_one():
        wid, rec, ck, payload, ready = pending.popleft()
        metrics.pipeline_add("pipeline_windows_drained", 1)
        if release is not None and payload is not None:
            wait_ready(ready)
            release(payload)
        return wid, rec, ck

    def save(wid, ck) -> None:
        """The drained window's snapshot, after its record was consumed."""
        nonlocal drained_through, drained_global
        drained_through = max(wid, drained_through)
        drained_global = drained_global or wid == -1
        if ck is not None:
            t0 = time.perf_counter()
            agg._save_merge(checkpoint_path, wait_ready(ck), drained_through, drained_global)
            metrics.pipeline_add("pipeline_drain_stall_s", time.perf_counter() - t0)

    panes_it = iter(panes)
    try:
        while True:
            t_pull = time.perf_counter()
            try:
                item = next(panes_it)
            except StopIteration:
                break
            metrics.pipeline_add("pipeline_dispatch_stall_s", time.perf_counter() - t_pull)
            pane, payload = item if unwrap else (item, item)
            if (0 <= pane.window_id <= start_after) or (pane.window_id == -1 and global_done):
                continue  # folded before the snapshot
            pane_summary = fold_pane(payload)
            if pane_summary is None:
                continue
            ready = record_ready(pane_summary) if release is not None else None
            if running is None or agg.transient_state or fold_is_running:
                running = pane_summary
            else:
                running = agg.combine(running, pane_summary)
            rec = _as_record(agg.transform(running if agg.transient_state else clone(running)))
            ck = None
            if checkpoint_path:
                ck = start_host_fetch(running if agg.transient_state else clone(running))
            pending.append((pane.window_id, rec, ck, payload if release is not None else None, ready))
            metrics.pipeline_add("pipeline_windows_dispatched", 1)
            metrics.pipeline_high_water("pipeline_inflight_high_water", len(pending))
            start_after = max(pane.window_id, start_after)
            global_done = global_done or pane.window_id == -1
            if agg.transient_state:
                running = None
            while len(pending) > depth:
                wid, rec_d, ck_d = drain_one()
                yield rec_d
                save(wid, ck_d)
    except GeneratorExit:
        # the consumer closed (an abandoned run): resolve the queue through
        # the normal drain, which waits on each fold and recycles its
        # arenas, discarding the records
        while pending:
            drain_one()
        raise
    except BaseException:
        # deliver the windows whose folds were already dispatched (the
        # synchronous loop emitted them before reaching the failure)
        while pending:
            wid, rec_d, ck_d = drain_one()
            yield rec_d
            save(wid, ck_d)
        raise
    while pending:
        wid, rec_d, ck_d = drain_one()
        yield rec_d
        save(wid, ck_d)
