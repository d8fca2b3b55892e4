"""Move items to the device ahead of its consumer, and results back.

Port of ``Prefetcher``, ``WirePrefetcher`` and ``prefetch_to_host`` from
``gelly_streaming_tpu/io/wire.py``.  One
thread runs ``prepare(item) -> (meta, host_arrays)`` (host packing); a
second uploads ``host_arrays`` (a tuple of numpy arrays, or None) so that
packing item k+1 overlaps uploading item k.  On CUDA the upload copies
from pinned host memory with ``non_blocking=True`` on a side stream and
records an event; the consumer's stream waits on that event when the item
is handed over, and the tensors are marked as used by that stream so the
caching allocator cannot recycle them early.  Given a shard mesh
(``parallel/mesh.Mesh``) instead of a device, every array's row s goes to
shard s's device (one copy a device, a side stream and an event each) and
the consumer gets a tuple of per-shard row lists.  ``prefetch_to_host`` is the
mirror for the emission plane: device outputs go to pinned host buffers by
non-blocking copies on a side stream, one event a batch, a bounded number
of batches in flight.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.utils import metrics


def upload(host_arrays, device: torch.device, stream=None):
    """Copy a tuple of numpy arrays (or CPU tensors) to ``device``.

    CPU: zero-copy tensors over the arrays.  CUDA: pinned staging (none for
    a tensor that is already pinned) and non-blocking copies on ``stream``
    (the current stream when None); the caller orders later work after them
    (same stream, or an event)."""
    if host_arrays is None:
        return None
    tensors = tuple(
        a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a)) for a in host_arrays
    )
    if device.type == "cpu":
        return tensors
    with torch.cuda.stream(stream or torch.cuda.current_stream(device)):
        # a pinned arena (core/async_exec.ArenaPool) uploads as it is
        return tuple((t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True) for t in tensors)


class Prefetcher:
    """Yields ``(meta, device_arrays)`` in order with up to ``depth``
    results in flight per stage.  ``close()`` (or the context manager)
    stops both threads and drops queued buffers if the consumer stops
    early; exhausting the iterator closes implicitly.  A failure on either
    thread is raised on the consumer's thread.  With ``count_stalls`` (the
    async window pipeline's prefetchers) the pack and transfer threads add
    their waits to the pipeline counters (utils/metrics.pipeline_stats)."""

    _SENTINEL = object()

    def __init__(
        self, items: Iterable, prepare, device: torch.device, depth: int = 4, count_stalls: bool = False
    ):
        self._prepare = prepare
        self._count_stalls = count_stalls
        # a shard mesh (parallel/mesh.Mesh): each array's row s goes to
        # shard s's device, a side stream and an event a device
        self._mesh = device if hasattr(device, "groups") else None
        self._device = device
        groups = self._mesh.groups if self._mesh is not None else ((device, ()),)
        self._sides = {d: torch.cuda.Stream(device=d) for d, _ in groups if d.type == "cuda"}
        self._midq: "queue.Queue" = queue.Queue(maxsize=depth)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._run_pack, args=(iter(items),), daemon=True),
            threading.Thread(target=self._run_put, daemon=True),
        ]
        for t in self._threads:
            t.start()

    def _put(self, q: "queue.Queue", item) -> bool:
        """Bounded put that gives up when the consumer has closed."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: "queue.Queue"):
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return self._SENTINEL

    def _run_pack(self, it: Iterator):
        try:
            for item in it:
                if self._stop.is_set():
                    return
                prepared = self._prepare(item)
                t0 = time.perf_counter()
                ok = self._put(self._midq, prepared)
                if self._count_stalls:  # pack stall: the transfer stage held the packed item back
                    metrics.pipeline_add("pipeline_pack_stall_s", time.perf_counter() - t0)
                if not ok:
                    return
        except BaseException as e:  # raised again on the consumer thread
            if self._error is None:
                self._error = e
        finally:
            self._put(self._midq, self._SENTINEL)

    def _run_put(self):
        try:
            while True:
                t0 = time.perf_counter()
                got = self._get(self._midq)
                if self._count_stalls:  # transfer stall: the transfer thread waited for the pack stage
                    metrics.pipeline_add("pipeline_transfer_stall_s", time.perf_counter() - t0)
                if got is self._SENTINEL:
                    return
                meta, host = got
                if not self._put(self._q, (meta, *self._upload(host))):
                    return
        except BaseException as e:
            if self._error is None:
                self._error = e
        finally:
            self._put(self._q, self._SENTINEL)

    def _upload(self, host):
        """(device arrays, [(device, event, tensors)]) of one prepared item:
        on a mesh, a tuple over the arrays of per-shard rows."""
        if host is None:
            return None, []
        if self._mesh is None:
            side = self._sides.get(self._device)
            dev = upload(host, self._device, side)
            if side is None:
                return dev, []
            ready = torch.cuda.Event()
            ready.record(side)
            return dev, [(self._device, ready, dev)]
        mesh = self._mesh
        rows = [[None] * mesh.size for _ in host]
        readies = []
        for d, ix in mesh.groups:
            part = tuple(a if len(ix) == mesh.size else np.ascontiguousarray(np.asarray(a)[list(ix)]) for a in host)
            side = self._sides.get(d)
            dev = upload(part, d, side)
            for k, t in enumerate(dev):
                for j, s in enumerate(ix):
                    rows[k][s] = t[j]
            if side is not None:
                ready = torch.cuda.Event()
                ready.record(side)
                readies.append((d, ready, dev))
        return tuple(rows), readies

    def close(self):
        """Stop the producers and drop queued buffers (idempotent).  Joins
        before draining so no in-flight put can refill a queue."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)
        for q in (self._midq, self._q):
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[Tuple[object, Optional[tuple]]]:
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    if self._error is not None:
                        raise self._error
                    return
                meta, dev, readies = item
                for d, ready, tensors in readies:
                    consumer = torch.cuda.current_stream(d)
                    consumer.wait_event(ready)
                    for t in tensors:
                        t.record_stream(consumer)
                yield meta, dev
        finally:
            self.close()


class WirePrefetcher(Prefetcher):
    """Pack ``(src, dst)`` numpy batches at ``width`` on the pack thread and
    upload them; yields ``(device wire buffer, batch length)`` in order."""

    def __init__(
        self,
        batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        width,
        device: torch.device,
        depth: int = 4,
    ):
        from gelly_streaming_tpu_torch.io import wire

        def prepare(item):
            src, dst = item
            return src.shape[0], (wire.pack_edges(src, dst, width),)

        super().__init__(batches, prepare, device, depth=depth)

    def __iter__(self):
        for n, (buf,) in super().__iter__():
            yield buf, n


def _host_leaves(outs, fn):
    """``outs`` (a tensor, or a tuple of them) with ``fn`` applied to each."""
    if isinstance(outs, tuple):
        return tuple(fn(t) for t in outs)
    return fn(outs)


def prefetch_to_host(device_iter, device: torch.device, depth: int = 4):
    """Yield each item of ``device_iter`` (a tensor or a tuple of tensors
    on ``device``) as numpy arrays, in order, with up to ``depth`` downloads
    in flight ahead of the consumer.

    On CUDA every output is copied into a fresh pinned host tensor by a
    non-blocking copy on a side stream that first waits for the producing
    stream; one event is recorded after a batch's copies, and the consumer
    waits on that event alone, never on the whole device.  On the CPU the
    outputs are already on the host."""
    if device.type != "cuda":
        for outs in device_iter:
            yield _host_leaves(outs, lambda t: t.numpy())
        return
    side = torch.cuda.Stream(device=device)
    pending = collections.deque()

    def start(outs):
        side.wait_stream(torch.cuda.current_stream(device))

        def copy(t):
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            with torch.cuda.stream(side):
                host.copy_(t, non_blocking=True)
            t.record_stream(side)
            return host

        host = _host_leaves(outs, copy)
        done = torch.cuda.Event()
        done.record(side)
        return host, done

    def finish(item):
        host, done = item
        done.synchronize()
        return _host_leaves(host, lambda t: t.numpy())

    for outs in device_iter:
        pending.append(start(outs))
        if len(pending) > depth:
            yield finish(pending.popleft())
    while pending:
        yield finish(pending.popleft())
