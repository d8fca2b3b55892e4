"""Host-side window discretization: the time plane of the port.

Port of ``gelly_streaming_tpu/core/windows.py`` (pane assembly, event-time
tumbling windows with a bounded-out-of-orderness watermark and late sink,
ingestion-time panes, pane-shared sliding windows, and the superbatch
grouping and pow2 padding: ``group_panes``, ``pad_pane_edges``).  The
host owns time:
batches are read back to numpy here, so panes are numpy arrays whatever
device the stream's batches live on, and pane contents are identical to
the JAX package's.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np

from gelly_streaming_tpu_torch.core.types import EdgeBatch, tree_map


class WindowPane(NamedTuple):
    """A closed tumbling window's edges, materialized as host arrays."""

    window_id: int
    max_timestamp: int  # inclusive window end (end_ms - 1); -1 for global pane
    src: np.ndarray
    dst: np.ndarray
    val: Optional[object]  # np array or tuple/dict of np arrays, aligned with src
    time: Optional[np.ndarray]

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def _batch_to_host(batch: EdgeBatch):
    mask = _host(batch.mask)
    idx = np.nonzero(mask)[0]
    src = _host(batch.src)[idx]
    dst = _host(batch.dst)[idx]
    val = tree_map(lambda a: _host(a)[idx], batch.val)
    time = None if batch.time is None else _host(batch.time)[idx]
    return src, dst, val, time


class PaneAssembler:
    """Accumulates per-window edge parts and assembles closed panes."""

    def __init__(self, window_ms: int, val_proto=None, has_time: bool = False):
        """``val_proto``/``has_time`` declare the stream's record structure
        up front (zero-length arrays); otherwise it is inferred from the
        first batch, so empty panes carry the same structure as full ones."""
        self.window_ms = window_ms
        self._open = {}  # window_id -> list of (src, dst, val, time)
        self._val_proto = val_proto
        self._has_time = has_time

    def _remember_structure(self, val, time) -> None:
        if val is not None and self._val_proto is None:
            self._val_proto = tree_map(lambda a: a[:0], val)
        self._has_time = self._has_time or time is not None

    def add(self, src, dst, val, time, wids) -> None:
        self._remember_structure(val, time)
        for wid in np.unique(wids):
            sel = wids == wid
            self._open.setdefault(int(wid), []).append(
                (
                    src[sel],
                    dst[sel],
                    tree_map(lambda a: a[sel], val),
                    None if time is None else time[sel],
                )
            )

    def add_untimed(self, src, dst, val) -> None:
        """Single global pane (ingestion-time finite stream)."""
        self._remember_structure(val, None)
        self._open.setdefault(-1, []).append((src, dst, val, None))

    def open_ids(self):
        return sorted(self._open)

    def close(self, wid: int) -> WindowPane:
        """Assemble pane ``wid``; an id with no edges yields an empty pane
        whose val/time carry the stream's structure (zero-length arrays)."""
        max_ts = (wid + 1) * self.window_ms - 1 if wid >= 0 else -1
        parts = self._open.pop(wid, None)
        if parts is None:
            empty = np.empty((0,), np.int32)
            return WindowPane(
                wid,
                max_ts,
                empty,
                empty.copy(),
                self._val_proto,
                np.empty((0,), np.int64) if self._has_time else None,
            )
        src = np.concatenate([p[0] for p in parts])
        dst = np.concatenate([p[1] for p in parts])
        val = None
        if parts[0][2] is not None:
            val = tree_map(
                lambda *leaves: np.concatenate(leaves), *[p[2] for p in parts]
            )
        time = (
            None if parts[0][3] is None else np.concatenate([p[3] for p in parts])
        )
        return WindowPane(wid, max_ts, src, dst, val, time)


def assign_tumbling_windows(
    batches: Iterator[EdgeBatch],
    window_ms: int,
    out_of_orderness_ms: int = 0,
    late_sink=None,
) -> Iterator[WindowPane]:
    """Group a timed batch stream into closed tumbling panes.

    With ``out_of_orderness_ms=0`` timestamps are assumed ascending.  A
    positive bound trails the watermark behind the max seen timestamp;
    window ``w`` closes once the watermark passes its end, and records
    whose window already closed go to ``late_sink(src, dst, val, time)``
    (dropped when None).  Pane emission is ascending either way, which
    sliding_panes relies on.  Untimed batches form one global pane flushed
    at end of stream.
    """
    panes = PaneAssembler(window_ms)
    watermark = None  # max event time seen - bound

    for batch in batches:
        src, dst, val, time = _batch_to_host(batch)
        if len(src) == 0:
            continue
        if time is None:
            panes.add_untimed(src, dst, val)
            continue
        wids = time // window_ms
        if watermark is not None:
            # a record is late iff its window already fired: the watermark
            # has passed the window's maxTimestamp (end - 1)
            late = (wids + 1) * window_ms - 1 <= watermark
            if late.any():
                if late_sink is not None:
                    sel = np.nonzero(late)[0]
                    late_sink(
                        src[sel],
                        dst[sel],
                        tree_map(lambda a: a[sel], val),
                        time[sel],
                    )
                keep = ~late
                src, dst = src[keep], dst[keep]
                time, wids = time[keep], wids[keep]
                val = tree_map(lambda a: a[keep], val)
                if len(src) == 0:
                    continue
        panes.add(src, dst, val, time, wids)
        new_watermark = int(time.max()) - out_of_orderness_ms
        if watermark is None or new_watermark > watermark:
            watermark = new_watermark
            # fire at watermark >= maxTimestamp = end - 1
            for wid in [
                w
                for w in panes.open_ids()
                if 0 <= w and (w + 1) * window_ms - 1 <= watermark
            ]:
                yield panes.close(wid)

    for wid in panes.open_ids():
        yield panes.close(wid)


def assign_ingestion_windows(
    batches: Iterator[EdgeBatch],
    every_edges: int = 0,
    every_ms: int = 0,
    clock=None,
) -> Iterator[WindowPane]:
    """Tumbling panes for untimed streams, cut every ``every_edges``
    arrivals or by wall clock (``every_ms``) at batch boundaries.  Panes
    carry ascending synthetic window ids and ``max_timestamp=-1``; any
    timestamps the batches carry are ignored."""
    import time as _time

    if bool(every_edges) == bool(every_ms):
        raise ValueError("set exactly one of every_edges / every_ms")
    clock = clock or _time.monotonic
    panes = PaneAssembler(0)  # window_ms=0 -> max_timestamp=-1 on close
    count = 0
    t0 = None

    for batch in batches:
        src, dst, val, _time_ignored = _batch_to_host(batch)
        if len(src) == 0:
            continue
        if every_edges:
            wids = (count + np.arange(len(src), dtype=np.int64)) // every_edges
            count += len(src)
        else:
            now = clock()
            if t0 is None:
                t0 = now
            wid = int((now - t0) * 1000.0 // every_ms)
            wids = np.full((len(src),), wid, np.int64)
        panes.add(src, dst, val, None, wids)
        newest = int(wids.max())
        for wid in [w for w in panes.open_ids() if 0 <= w < newest]:
            yield panes.close(wid)

    for wid in panes.open_ids():
        yield panes.close(wid)


def sliding_panes(
    panes: Iterator[WindowPane], k: int, slide_ms: int
) -> Iterator[WindowPane]:
    """Sliding windows by pane-sharing: window ``w`` merges the ``k``
    consecutive ``slide_ms``-wide panes ``[w-k+1, w]`` and is emitted when
    pane ``w`` closes.  Early windows are partial, windows with no edges do
    not fire, and the trailing ``k-1`` windows flush at end of stream.  An
    untimed stream's global pane (``window_id=-1``) passes through."""
    if k <= 1:
        yield from panes
        return

    cache = {}  # pane id -> WindowPane (the k most recent)
    last = None  # newest window id emitted

    def emit(wid: int) -> Optional[WindowPane]:
        parts = [cache[i] for i in range(wid - k + 1, wid + 1) if i in cache]
        if not parts or all(p.num_edges == 0 for p in parts):
            return None
        timed = any(p.max_timestamp >= 0 for p in parts)
        src = np.concatenate([p.src for p in parts])
        dst = np.concatenate([p.dst for p in parts])
        val = None
        if parts[0].val is not None:
            val = tree_map(
                lambda *leaves: np.concatenate(leaves), *[p.val for p in parts]
            )
        time = (
            None
            if parts[0].time is None
            else np.concatenate([p.time for p in parts])
        )
        max_ts = (wid + 1) * slide_ms - 1 if timed else -1
        return WindowPane(wid, max_ts, src, dst, val, time)

    def evict(wid: int) -> None:
        for old in [i for i in cache if i <= wid + 1 - k]:
            del cache[old]

    for pane in panes:
        if pane.window_id < 0:  # untimed global pane: degenerate window
            yield pane
            continue
        w = pane.window_id
        cache[w] = pane
        # windows in (last+k-1, w) hold no cached pane, so a timestamp gap
        # costs O(k) work, not O(gap/slide) empty emit() calls
        if last is None:
            candidates = [w]
        else:
            candidates = [*range(last + 1, min(last + k, w)), w]
        for wid in candidates:
            out = emit(wid)
            if out is not None:
                yield out
            evict(wid)
        last = w

    if last is not None:
        for wid in range(last + 1, last + k):
            if not cache:
                break
            out = emit(wid)
            if out is not None:
                yield out
            evict(wid)


def validate_slide(window_ms: int, slide_ms: Optional[int]) -> None:
    """Eager check of a sliding-window spec."""
    if slide_ms is None:
        return
    if not 0 < slide_ms <= window_ms:
        raise ValueError(f"slide_ms must be in (0, window_ms]; got {slide_ms}")
    if window_ms % slide_ms:
        raise ValueError(
            "window_ms must be a multiple of slide_ms for pane-shared "
            f"sliding windows; got {window_ms} % {slide_ms}"
        )


def windowed_panes(
    stream, window_ms: int, slide_ms: Optional[int] = None
) -> Iterator[WindowPane]:
    """Validated window-pane source: tumbling panes, or pane-shared sliding
    windows when ``slide_ms`` (a divisor of ``window_ms``) is given."""
    validate_slide(window_ms, slide_ms)
    if slide_ms and slide_ms != window_ms:
        cfg = stream.cfg
        if cfg.ingest_window_edges or cfg.ingest_window_ms:
            raise ValueError(
                "sliding windows apply to event-time slices; this stream "
                "cuts ingestion-time panes (ingest_window_edges/_ms)"
            )
        return sliding_panes(
            stream_panes(stream, slide_ms), window_ms // slide_ms, slide_ms
        )
    return stream_panes(stream, window_ms)


def _array_backed_panes(
    src: np.ndarray, dst: np.ndarray, every_edges: int
) -> Iterator[WindowPane]:
    """Count-cut ingestion panes sliced straight off an array-backed
    stream's host arrays: the same edges in the same order as routing the
    stream's padded micro-batches through ``assign_ingestion_windows``,
    without the per-batch device round trip.  Yields views of the arrays."""
    n = len(src)
    for wid in range((n + every_edges - 1) // every_edges):
        lo = wid * every_edges
        yield WindowPane(
            wid,
            -1,
            src[lo : lo + every_edges],
            dst[lo : lo + every_edges],
            None,
            None,
        )


def stream_panes(stream, window_ms: int) -> Iterator[WindowPane]:
    """The pane source over ``stream``: ingestion-time panes when the
    config asks for them, else event-time tumbling windows (untimed
    streams degrade to the single global pane there)."""
    cfg = stream.cfg
    if cfg.ingest_window_edges or cfg.ingest_window_ms:
        arrays = getattr(stream, "_wire_arrays", None)
        if cfg.ingest_window_edges and arrays is not None and not getattr(stream, "_stages", ()):
            # stages change the edges: transformed streams take the batches
            return _array_backed_panes(arrays[0], arrays[1], cfg.ingest_window_edges)
        return assign_ingestion_windows(
            stream.batches(),
            cfg.ingest_window_edges,
            cfg.ingest_window_ms,
        )
    return assign_tumbling_windows(
        stream.batches(),
        window_ms,
        out_of_orderness_ms=cfg.out_of_orderness_ms,
        late_sink=getattr(stream, "late_sink", None),
    )


def group_panes(panes: Iterator[WindowPane], k: int, keep_empty: bool = False):
    """Groups of up to ``k`` consecutive closed panes (as lists).

    The grouping under superbatch dispatch: the aggregation's [K, E] fold
    rows and the triangles' K-pane count iterate it directly.  Panes with
    no edges are dropped unless ``keep_empty`` (window triangles emit a
    record for every pane)."""
    k = max(1, k)
    buf = []
    for pane in panes:
        if pane.num_edges == 0 and not keep_empty:
            continue
        buf.append(pane)
        if len(buf) == k:
            yield buf
            buf = []
    if buf:
        yield buf


def pow2(n: int) -> int:
    """The power-of-two bucket of ``n`` items (1 for none): the shape
    policy of per-pane device work, as the JAX package shares compiled
    shapes."""
    return max(1, 1 << (n - 1).bit_length())


def pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    """``a`` zero-padded along its first axis to ``rows`` (``a`` itself
    when it already has that many)."""
    if len(a) == rows:
        return a
    out = np.zeros((rows,) + a.shape[1:], a.dtype)
    out[: len(a)] = a
    return out


def pad_pane_edges(pane: WindowPane, out=None):
    """(src, dst, mask) int32/bool arrays padded to ``pow2(num_edges)``:
    the shared pane -> fixed-shape policy of per-pane device work.  ``out``,
    when given, is three zeroed arrays of that length (a pool's arenas)
    that are filled and returned in place of new ones; without it an int32
    ``src``/``dst`` already of the padded length is returned as it is."""
    e = pane.num_edges
    if out is None:
        e_pad = pow2(e)
        mask = np.zeros((e_pad,), bool)
        mask[:e] = True
        return pad_rows(np.asarray(pane.src, np.int32), e_pad), pad_rows(np.asarray(pane.dst, np.int32), e_pad), mask
    src, dst, mask = out
    src[:e], dst[:e], mask[:e] = pane.src, pane.dst, True
    return out


def stack_rows(arrays, rows: int, width: int, dtype=None) -> np.ndarray:
    """[rows, width, ...] zeros with ``arrays[i]`` in the head of row i:
    a pane group's fold or count layout, one row a pane."""
    first = np.asarray(arrays[0])
    out = np.zeros((rows, width) + first.shape[1:], dtype or first.dtype)
    for i, a in enumerate(arrays):
        out[i, : len(a)] = a
    return out


def row_mask(lengths, rows: int, width: int) -> np.ndarray:
    """bool [rows, width]: the first ``lengths[i]`` slots of row i."""
    n = np.zeros((rows,), np.int64)
    n[: len(lengths)] = lengths
    return np.arange(width)[None, :] < n[:, None]
