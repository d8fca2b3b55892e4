"""Edge sources: edge-list files, batched host arrays and generated streams.

Port of the parts of ``gelly_streaming_tpu/io/sources.py`` the ported
slices use.  ``parse_edge_file`` takes the native parser of the port's
host library (``utils/native.py``) when it loads, across the ingest pool
(io/ingest.py) when asked for more than one worker, else the numpy
fallback; all three return the same arrays.  ``file_stream`` parses across
the pool by default, as the JAX package's does.  ``NetworkEdgeSource`` is
the serving plane's push API: pushing threads hand it validated wire
buffers (or decoded rows), a job's stream pulls them as host-plane batches
through a bounded queue, with JAX's positional accounting, resume cursors
and refusals (``SourceQuiesced``, ``PushOutOfSync``).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from gelly_streaming_tpu_torch.core import async_exec
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream, validate_wire_buffer, validate_wire_width
from gelly_streaming_tpu_torch.core.types import EdgeBatch
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.io.interning import IdentityInterner, VertexInterner
from gelly_streaming_tpu_torch.utils import metrics, native


def parse_edge_file(path: str, workers: int = 1):
    """Parse an edge-list file into host arrays.

    Returns (src i64, dst i64, val f64 | None, time i64 | None, sign i32 |
    None).  Format per line: ``src dst [value|+|-] [timestamp]`` with
    space/tab/comma separators and #/% comments.

    ``workers`` > 1 (or 0 = auto: GELLY_INGEST_WORKERS, else the usable
    cores) shards the file into byte ranges parsed concurrently by the
    ingest pool (io/ingest.py); the arrays are the same.  One worker takes
    the native parser when the library loads, else the numpy fallback.
    """
    from gelly_streaming_tpu_torch.io import ingest

    if workers != 1:
        return ingest.parse_edge_file_parallel(path, workers)
    lib = native.load_ingest_lib()
    if lib is not None:
        n = lib.count_rows(path.encode())
        if n < 0:
            raise FileNotFoundError(path)
        src = np.empty(n, np.int64)
        dst = np.empty(n, np.int64)
        val = np.empty(n, np.float64)
        tim = np.empty(n, np.int64)
        sign = np.empty(n, np.int32)
        ncols = np.zeros(1, np.int32)
        rows = lib.fill_edges(path.encode(), src.ctypes.data, dst.ctypes.data, val.ctypes.data, tim.ctypes.data,
                              sign.ctypes.data, n, ncols.ctypes.data)
        if rows < 0:
            raise IOError(f"failed to parse {path}")
        nc = int(ncols[0])
        has_sign = bool(nc & 0x100)
        nc &= 0xFF
        return (
            src[:rows],
            dst[:rows],
            val[:rows] if (nc >= 3 and not has_sign) else None,
            tim[:rows] if nc >= 4 else None,
            sign[:rows] if has_sign else None,
        )
    parts = []
    with open(path) as f:
        while True:
            chunk = list(itertools.islice(f, ingest.FALLBACK_CHUNK_LINES))
            if not chunk:
                break
            parts.append(ingest._parse_chunk_lines(chunk))
    if not parts:
        parts = [ingest._parse_chunk_lines([])]
    return ingest._merge_parsed(parts)


def _batched(
    src, dst, val, tim, sign, batch_size: int, device: DeviceLike = None
) -> Callable[[], Iterator[EdgeBatch]]:
    """Re-runnable factory of padded batches over host arrays."""
    dev = resolve_device(device)

    def factory():
        for i in range(0, len(src), batch_size):
            j = min(i + batch_size, len(src))
            yield EdgeBatch.from_arrays(
                src[i:j],
                dst[i:j],
                val=None if val is None else val[i:j],
                time=None if tim is None else tim[i:j],
                sign=None if sign is None else sign[i:j],
                pad_to=batch_size,
                device=dev,
            )

    return factory


def file_stream(
    path: str,
    cfg: StreamConfig,
    interner=None,
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[EdgeStream, object]:
    """EdgeStream over an edge-list file; returns (stream, interner).

    With no interner given, ids are checked-identity (dense ints) unless
    any id falls outside [0, capacity), in which case a VertexInterner is
    built.  Value-less untimed files become array-backed streams (the
    aggregation wire path); the rest batch sources."""
    src, dst, val, tim, sign = parse_edge_file(path, workers=cfg.ingest_workers)
    if interner is None:
        if len(src) and (
            min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= cfg.vertex_capacity
        ):
            interner = VertexInterner(cfg.vertex_capacity)
        else:
            interner = IdentityInterner(cfg.vertex_capacity)
    src_i = interner.intern_ints(src)
    dst_i = interner.intern_ints(dst)
    bs = batch_size or cfg.batch_size
    if val is None and tim is None and sign is None:
        return EdgeStream.from_arrays(src_i, dst_i, cfg, batch_size=bs, device=device), interner
    stream = EdgeStream.from_batches(
        _batched(src_i, dst_i, val, tim, sign, bs, device), cfg, device=device
    )
    return stream, interner


def generated_stream(
    cfg: StreamConfig,
    num_edges: int,
    num_vertices: Optional[int] = None,
    seed: int = 0,
    batch_size: Optional[int] = None,
    device: DeviceLike = None,
) -> EdgeStream:
    """Uniform random edge stream (the examples' generated-input fallback);
    the same edges as the JAX package's for the same seed."""
    n_v = num_vertices or cfg.vertex_capacity
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, num_edges).astype(np.int32)
    dst = rng.integers(0, n_v, num_edges).astype(np.int32)
    return EdgeStream.from_arrays(src, dst, cfg, batch_size=batch_size, device=device)


class SourceQuiesced(RuntimeError):
    """Push refused because the source is draining (or already closed).

    Explicit by contract: a drain in progress must refuse further ingest
    loudly, so the client knows exactly which edges the server will never
    fold (everything past the drain cursor is the client's to re-push after
    the restart), never absorb them silently."""


class PushOutOfSync(RuntimeError):
    """Push refused because its declared stream offset does not match the
    source's position.

    A pipelined push written before the client learned of a drain or a
    rescale can reach the server after the job's new source is installed:
    at face value a valid push, but positionally it belongs to the old
    stream, and accepting it at the new source's cursor would shift every
    replayed pane boundary.  Clients that stamp each frame with its global
    edge offset get exact positional verification; a mismatch is this
    refusal, and re-pushing from the advertised cursor is the recovery.
    ``expected`` / ``declared`` carry the two positions, so a reconnecting
    client can re-declare its position without a second round trip."""

    def __init__(self, message: str, expected: int = None, declared: int = None):
        super().__init__(message)
        self.expected = expected
        self.declared = declared


class NetworkEdgeSource:
    """Feed a running job's record source from client-pushed wire batches.

    The serving plane's ingest boundary: pushing threads ``push_wire`` /
    ``push_tail`` validated wire buffers in, the job's stream factory pulls
    host-plane ``EdgeBatch``es out, and a bounded queue between them isolates
    both sides:

    * a full queue blocks the pushing thread (backpressure onto that
      client) and never the consumer;
    * an empty queue never blocks the scheduler: ``ready()`` says whether
      an undelivered ingest window is closable from the queued edges (exact
      positional accounting, see its docstring), and a scheduler skips the
      job's round otherwise.

    Every pushed buffer passes the ``from_wire`` guards
    (``core/stream.validate_wire_buffer``) with the id-range decode check:
    a socket peer is untrusted, and the host decode is the unpack the
    windowed planes need anyway.

    Resume cursors: ``resume_edges`` (a multiple of the config's ingest
    window, the windows a job's positional checkpoint covers) makes the
    factory yield that many filler edges first, so the replayed pane ids
    line up with the checkpoint and the merge loop skips them without
    device work; the client re-pushes from the cursor, and the resumed fold
    equals the clean one.

    ``device`` is the stream's (default ``cuda``); the batches themselves
    are host tensors, which the windowed planes cut into panes on the host.
    """

    def __init__(
        self,
        cfg: StreamConfig,
        batch_size: Optional[int] = None,
        resume_edges: int = 0,
        max_queued_batches: int = 64,
        on_data: Optional[Callable[[], None]] = None,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch = int(batch_size or cfg.batch_size)
        if self.batch <= 0:
            raise ValueError("batch_size must be positive")
        if cfg.ingest_window_edges and self.batch > cfg.ingest_window_edges:
            # one batch must close at most one window, so each pull delivers
            # at most one record and ready()'s accounting stays exact
            raise ValueError(
                f"batch_size ({self.batch}) must be <= ingest_window_edges "
                f"({cfg.ingest_window_edges}) for network-fed jobs"
            )
        # pipelined planes consume ahead of the records they deliver: the
        # async window pipeline dispatches depth + 1 panes before its first
        # yield, and superbatch grouping buffers up to K panes a dispatch, so
        # a pull is only sure not to block when that many windows are
        # closable beyond the consumer's position
        self._headroom = async_exec.resolve_depth(cfg) + (cfg.superbatch if cfg.superbatch > 1 else 0)
        resume_edges = int(resume_edges)
        if resume_edges < 0:
            raise ValueError("resume_edges must be >= 0")
        w = cfg.ingest_window_edges
        if resume_edges and (not w or resume_edges % w):
            raise ValueError(
                f"resume_edges ({resume_edges}) must be a multiple of "
                f"ingest_window_edges ({w}): checkpoint positions are whole "
                "closed windows, so a misaligned cursor would shift every "
                "replayed pane boundary"
            )
        self._resume_edges = resume_edges
        # decoded (src, dst, enqueue time, release) tuples between the
        # pushing threads and the job's stream factory
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, max_queued_batches))
        # a leaf of any caller's lock order: the wake callback (on_data) runs
        # with it released, and the queue's own mutex is only ever taken in
        # sequence with it (progress()), never nested
        self._lock = threading.Lock()
        self._edges_in = resume_edges  # guarded-by: _lock (filler counts as accepted)
        self._edges_out = 0  # guarded-by: _lock (handed to the consumer, filler included)
        self._closed = False  # guarded-by: _lock
        self._quiesced = False  # guarded-by: _lock
        # called after every accepted push and at close, so a scheduler
        # re-checks ready() promptly; optional
        self.on_data = on_data

    # -- producer side (pushing threads) -------------------------------------

    def _refuse_if_not_open(self) -> None:
        with self._lock:
            if self._quiesced and not self._closed:
                raise SourceQuiesced("source is draining: re-push everything past the drain cursor after the restart")
            if self._closed:
                raise SourceQuiesced("source is closed (end-of-stream seen)")

    def check_open(self) -> None:
        """Raise ``SourceQuiesced`` unless pushes are accepted now: a decode
        pool's pre-flight, so a quiesced or closed source refuses before a
        decode is spent on the buffer (``push_wire`` checks first too)."""
        self._refuse_if_not_open()

    def push_wire(self, buf, width, timeout: Optional[float] = None, offset: Optional[int] = None) -> int:
        """Validate + decode one full wire buffer and queue its batch.

        ``width`` is an io/wire encoding (a fixed width, PAIR40, or the
        ``(EF40, capacity)`` / ``(BDV, capacity)`` tuples); the buffer holds
        exactly ``self.batch`` edges.  Blocks while the queue is full;
        raises ``queue.Full`` only when ``timeout`` elapses, ``ValueError``
        on a buffer failing the ``from_wire`` guards, ``SourceQuiesced``
        during or after a drain, ``PushOutOfSync`` when ``offset`` (the
        batch's declared global edge position, resume filler included) is
        not the source's accepted-edge count.  Returns the edges accepted.
        """
        self._refuse_if_not_open()
        validate_wire_width(width, self.cfg.vertex_capacity)
        s, d = validate_wire_buffer(buf, self.batch, width, self.cfg.vertex_capacity, decode_ids=True)
        self._accept(s, d, timeout, offset)
        return len(s)

    def push_tail(self, src, dst, timeout: Optional[float] = None, offset: Optional[int] = None) -> int:
        """Queue a raw partial batch (the remainder shorter than one wire
        buffer): ``from_wire``'s tail guards, ``push_wire``'s offset guard."""
        self._refuse_if_not_open()
        src = np.asarray(src)
        dst = np.asarray(dst)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("tail must be matching 1-d (src, dst) arrays")
        if len(src) == 0 or len(src) > self.batch:
            raise ValueError(f"tail must hold 1..{self.batch} edges, got {len(src)}")
        cap = self.cfg.vertex_capacity
        # bounds before the int32 cast: a cast-first check would let 64-bit
        # ids wrap into range
        if min(src.min(), dst.min()) < 0 or max(src.max(), dst.max()) >= cap:
            raise ValueError(
                f"tail vertex ids must be in [0, vertex_capacity={cap}); intern ids first (io.interning.VertexInterner)"
            )
        s = np.ascontiguousarray(src, dtype=np.int32)
        d = np.ascontiguousarray(dst, dtype=np.int32)
        self._accept(s, d, timeout, offset)
        return len(s)

    def push_decoded(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        timeout: Optional[float] = None,
        offset: Optional[int] = None,
        release: Optional[Callable[[], None]] = None,
    ) -> int:
        """Queue one already-validated full batch (a decode pool's landing
        path): ``src``/``dst`` are int32[batch] rows that passed the whole
        ``validate_wire_buffer`` guard set elsewhere.  ``release`` travels
        with the batch: the stream factory calls it after copying the rows
        out, handing their buffer back to its owner.  ``push_wire``'s
        backpressure and refusals otherwise."""
        self._refuse_if_not_open()
        if len(src) != self.batch or len(dst) != self.batch:
            raise ValueError(f"decoded push must hold exactly {self.batch} edges, got {len(src)}/{len(dst)}")
        self._accept(src, dst, timeout, offset, release)
        return len(src)

    def _check_offset(self, offset: Optional[int]) -> None:
        if offset is None:
            return
        with self._lock:
            expect = self._edges_in
        if int(offset) != expect:
            raise PushOutOfSync(
                f"push declares edge offset {int(offset)} but this source "
                f"is at {expect} accepted edges (resume filler included): "
                "the batch belongs to a stream position this source does "
                "not hold — re-push from the advertised resume cursor",
                expected=expect,
                declared=int(offset),
            )

    def _accept(self, s, d, timeout: Optional[float], offset=None, release=None) -> None:
        # the positional guard first: a stale frame must refuse, not wait on
        # (or land in) a queue it has no position in.  One pusher a source
        # keeps the window between the check and the put harmless.
        self._check_offset(offset)
        # the enqueue time: the consumer records queue residency as the
        # push_to_fold_ms histogram
        self._q.put((s, d, time.perf_counter(), release), timeout=timeout)
        with self._lock:
            self._edges_in += len(s)
        wake = self.on_data
        if wake is not None:
            wake()

    @property
    def draining(self) -> bool:
        """True while the source is quiesced for a drain (pushes refused
        ``SourceQuiesced``); False when open or closed normally."""
        with self._lock:
            return self._quiesced and not self._closed

    def resume_pushes(self) -> None:
        """Reopen a quiesced (not closed) source: a drain that did not
        complete leaves the job running, and its clients must be able to
        keep pushing."""
        with self._lock:
            self._quiesced = False

    def close(self) -> None:
        """Mark end-of-stream: queued batches drain, then the job's source
        ends normally (final pane flush, final checkpoint)."""
        with self._lock:
            self._closed = True
        wake = self.on_data
        if wake is not None:
            wake()

    def quiesce(self) -> None:
        """Drain step 1: stop accepting pushes and stop new windows
        (``ready()`` goes False).  Queued but unfolded edges past the last
        closed window are abandoned: the client re-pushes them from the
        drain cursor."""
        with self._lock:
            self._quiesced = True

    # -- scheduler side -------------------------------------------------------

    def ready(self) -> bool:
        """True when one pull is sure not to block on the network: the
        source is closed (everything left is queued), or at least one
        undelivered ingest window is closable from the queued edges.

        Exact positional accounting: batches arrive contiguously, so window
        ``k`` is closable once edge ``(k+1)*W`` has been accepted (the pane
        cutter closes a window when the first edge of the next one
        arrives), and the windows already pulled through are ``(edges_out -
        1) // W``.  Filler windows never emit, so the floor is the resume
        cursor's window count."""
        with self._lock:
            if self._quiesced:
                return False
            if self._closed:
                return True
            w = self.cfg.ingest_window_edges
            if not w:
                # a single global pane only emits at end-of-stream
                return False
            closable = (self._edges_in - 1) // w if self._edges_in else 0
            pulled = (self._edges_out - 1) // w if self._edges_out else 0
            floor = max(pulled, self._resume_edges // w)
            return closable > floor + self._headroom

    @property
    def queued_batches(self) -> int:
        """Current ingest-queue occupancy (approximate, lock-free)."""
        return self._q.qsize()

    def progress(self) -> dict:
        """A snapshot of the positional accounting for a health sampler.

        ``backlog_age_s`` is the age of the oldest queued push while a
        closable window sits undelivered; ``closable_windows`` /
        ``delivered_windows`` are ``ready()``'s accounting, their gap the
        job's lag in ingest windows.  Host counter reads under the two
        locks, taken in sequence, never nested."""
        now = time.perf_counter()
        with self._q.mutex:  # qsize()'s own lock; the peek needs it too
            depth = len(self._q.queue)
            oldest_t = self._q.queue[0][2] if depth else None
            cap_batches = self._q.maxsize
        with self._lock:
            edges_in = self._edges_in
            edges_out = self._edges_out
        w = self.cfg.ingest_window_edges
        closable = (edges_in - 1) // w if (w and edges_in) else 0
        delivered = (edges_out - 1) // w if (w and edges_out) else 0
        if w:
            # ready()'s resume floor: the checkpoint-covered filler windows
            # replay-skip, so they are not lag
            delivered = max(delivered, self._resume_edges // w)
        # a tail the pane cutter holds for its window to fill is the stream
        # trickling, not the job falling behind: it does not age
        lagging = closable > delivered and oldest_t is not None
        return {
            "edges_in": edges_in,
            "edges_out": edges_out,
            "backlog_batches": depth,
            "backlog_edges": depth * self.batch,
            "backlog_age_s": (now - oldest_t) if lagging else 0.0,
            "queue_capacity_edges": cap_batches * self.batch,
            "closable_windows": closable,
            "delivered_windows": delivered,
        }

    @property
    def edges_accepted(self) -> int:
        """Total edges accepted, resume filler included."""
        with self._lock:
            return self._edges_in

    def stream(self) -> EdgeStream:
        """The job-facing EdgeStream (one consumer: the job built over it),
        a ``from_batches`` stream on the source's device: the windowed
        ingestion-pane planes (sync, async or superbatch by config), with
        per-window running emission and positional checkpoints."""
        return EdgeStream.from_batches(self._factory, self.cfg, device=self.device)

    def _factory(self) -> Iterator[EdgeBatch]:
        # resume filler: the checkpoint-covered region, so pane ids line up;
        # the merge loop skips these panes before any fold
        left = self._resume_edges
        while left > 0:
            n = min(left, self.batch)
            zeros = np.zeros((n,), np.int32)
            with self._lock:
                self._edges_out += n
            left -= n
            yield EdgeBatch.from_host_arrays(zeros, zeros, pad_to=self.batch)
        while True:
            # once closed the queue can only drain, so a non-blocking get is
            # exact and the end costs no poll slice
            with self._lock:
                closed = self._closed
            try:
                if closed:
                    s, d, t_pushed, release = self._q.get_nowait()
                else:
                    s, d, t_pushed, release = self._q.get(timeout=0.05)
            except queue.Empty:
                with self._lock:
                    if self._closed and self._q.empty():
                        return
                continue
            # queue residency = push-to-fold latency; the pull runs on the
            # consumer's thread, so a set_hist_job tag scopes it too
            metrics.hist_record("push_to_fold_ms", (time.perf_counter() - t_pushed) * 1e3)
            with self._lock:
                self._edges_out += len(s)
            if release is not None:
                # the rows alias the caller's buffer: copy them out before
                # it is handed back
                s, d = np.array(s), np.array(d)
                release()
            yield EdgeBatch.from_host_arrays(s, d, pad_to=self.batch)


def unbounded_generated_stream(
    cfg: StreamConfig,
    num_vertices: Optional[int] = None,
    seed: int = 0,
    max_batches: Optional[int] = None,
    device: DeviceLike = None,
) -> EdgeStream:
    """Unbounded uniform random untimed edge stream of ``cfg.batch_size``
    batches (pair it with ``cfg.ingest_window_edges`` for running
    emissions); ``max_batches`` bounds it, None streams forever.  The
    same edges as the JAX package's for the same seed."""
    n_v = num_vertices or cfg.vertex_capacity
    dev = resolve_device(device)

    def factory():
        rng = np.random.default_rng(seed)
        k = 0
        while max_batches is None or k < max_batches:
            src = rng.integers(0, n_v, cfg.batch_size).astype(np.int32)
            dst = rng.integers(0, n_v, cfg.batch_size).astype(np.int32)
            yield EdgeBatch.from_arrays(src, dst, device=dev)
            k += 1

    return EdgeStream.from_batches(factory, cfg, device=dev)
