"""EdgeStream: the graph-stream API, as far as the ported slices use it.

Port of the ``EdgeStream`` subset of ``gelly_streaming_tpu/core/stream.py``
that ``window_triangles`` and the streaming aggregations read: the
constructors ``from_collection``, ``from_batches``, ``from_arrays`` (with
its vertex-id bounds check) and ``from_wire`` (a replay of buffers already
in the wire format, with its guards), ``batches()``, ``cfg``,
``num_edges_hint``, ``aggregate``, the late-record sink, and the backing
host arrays that feed the aggregation wire path and let count-cut panes
slice straight off an array-backed stream.  A stream also carries the
torch device its batches are built on.  Transformation stages
(map/filter/distinct/...) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.types import EdgeBatch
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.io import wire as _wire


def plan_superbatch_groups(n: int, k: int, boundaries=()) -> List[int]:
    """Split ``n`` sequential unit batches into groups whose sizes are
    powers of two <= ``k`` and that never cross a boundary: each
    ``(modulus, offset)`` in ``boundaries`` marks batch indices ``i`` with
    ``(i + offset) % modulus == 0`` that must START a group (emission
    points).  ``k <= 1`` is one batch a group."""
    if k <= 1 or n <= 0:
        return [1] * max(n, 0)
    groups: List[int] = []
    i = 0
    while i < n:
        limit = min(n - i, k)
        for mod, off in boundaries:
            if mod:
                limit = min(limit, mod - ((i + off) % mod))
        g = 1 << (max(limit, 1).bit_length() - 1)  # largest pow2 <= limit
        groups.append(g)
        i += g
    return groups


def validate_wire_width(width, capacity: int) -> None:
    """The encoding must be a supported one, and a tuple width's capacity
    must not exceed the stream's (decoded ids could reach or pass it)."""
    if width not in (2, 3, 4, _wire.PAIR40) and not (
        isinstance(width, tuple) and len(width) == 2 and width[0] in (_wire.EF40, _wire.BDV)
    ):
        raise ValueError(f"unsupported wire width {width}")
    if isinstance(width, tuple) and width[1] > capacity:
        raise ValueError(
            f"{width[0].upper()} width capacity {width[1]} exceeds "
            f"cfg.vertex_capacity {capacity}: decoded ids could reach or "
            "pass it and silently corrupt device state; "
            "intern ids first (io.interning.VertexInterner)"
        )


def validate_wire_buffer(
    buf, batch_size: int, width, capacity: int, index: int = 0, decode_ids: bool = False
):
    """One buffer's ``from_wire`` guards: dtype, size (exact for fixed
    widths, between the floor and the worst case for BDV) and, with
    ``decode_ids``, a host decode with both ends of the id range checked.
    Returns the decoded ``(src, dst)`` when ``decode_ids``, else None."""
    b = np.asarray(buf)
    if b.dtype != np.uint8:
        raise ValueError(f"wire buffer {index} has dtype {b.dtype}, not uint8")
    expect = _wire.wire_nbytes(batch_size, width)
    if isinstance(width, tuple) and width[0] == _wire.BDV:
        bdv_min = (2 * batch_size + 3) // 4 + 2 * batch_size
        if b.nbytes > expect:
            raise ValueError(
                f"BDV wire buffer {index} holds {b.nbytes} bytes; "
                f"batch_size={batch_size} caps at {expect}"
            )
        if b.nbytes < bdv_min:
            raise ValueError(
                f"BDV wire buffer {index} holds {b.nbytes} bytes, "
                f"truncated below the {bdv_min}-byte minimum for "
                f"batch_size={batch_size}"
            )
    elif b.nbytes != expect:
        raise ValueError(
            f"wire buffer {index} holds {b.nbytes} bytes; "
            f"batch_size={batch_size} at width {width} needs {expect}"
        )
    if not decode_ids:
        return None
    s, d = _wire.unpack_edges_host(b, batch_size, width)
    if len(s) and (int(min(s.min(), d.min())) < 0 or int(max(s.max(), d.max())) >= capacity):
        raise ValueError(
            f"wire buffer {index} decodes vertex ids outside "
            f"[0, vertex_capacity {capacity}); intern ids first "
            "(io.interning.VertexInterner)"
        )
    return s, d


class EdgeStream:
    """A (possibly infinite) stream of graph edges over a dense vertex space.

    Construction:
      EdgeStream.from_collection(edges, cfg)      finite host collection
      EdgeStream.from_batches(factory, cfg)       any re-runnable batch source
      EdgeStream.from_arrays(src, dst, cfg)       value-less untimed id arrays
      EdgeStream.from_wire(bufs, batch, width)    replay of packed wire buffers
    """

    def __init__(
        self,
        source_factory: Callable[[], Iterator[EdgeBatch]],
        cfg: StreamConfig,
        device: DeviceLike = None,
        wire_arrays: Optional[Tuple[np.ndarray, np.ndarray, int]] = None,
        wire_packed: Optional[tuple] = None,
    ):
        self._source_factory = source_factory
        self.cfg = cfg
        self.device = resolve_device(device)
        # (src, dst, batch_size) host arrays backing an array-built stream
        # (the aggregation wire path packs them; core/windows.stream_panes
        # slices count-cut panes off them)
        self._wire_arrays = wire_arrays
        # (bufs, batch_size, width, tail) of a from_wire replay: buffers
        # already in the wire format, uploaded as they are
        self._wire_packed = wire_packed
        self._late_holder = {"sink": None}

    @property
    def late_sink(self):
        """callable(src, dst, val, time) for later-than-bound records
        (None = drop)."""
        return self._late_holder["sink"]

    def on_late(self, sink) -> "EdgeStream":
        """Route later-than-bound event-time records to ``sink(src, dst,
        val, time)`` instead of dropping them (used with
        ``cfg.out_of_orderness_ms`` > 0)."""
        self._late_holder["sink"] = sink
        return self

    def num_edges_hint(self) -> Optional[int]:
        """Total edge count when the source knows it (array- or
        wire-backed streams), else None."""
        if self._wire_arrays is not None:
            return len(self._wire_arrays[0])
        if self._wire_packed is not None:
            bufs, batch_size, _width, tail = self._wire_packed
            return len(bufs) * batch_size + (len(tail[0]) if tail else 0)
        return None

    # ---- construction -------------------------------------------------------

    @staticmethod
    def from_collection(
        edges: Sequence[tuple],
        cfg: StreamConfig = StreamConfig(),
        batch_size: Optional[int] = None,
        with_time: bool = False,
        device: DeviceLike = None,
    ) -> "EdgeStream":
        """Finite in-memory stream.  ``with_time`` reads a 4th tuple element
        as the event timestamp; otherwise arrival order is time."""
        edges = list(edges)
        bs = batch_size or (len(edges) if edges else 1)
        dev = resolve_device(device)

        def factory():
            for i in range(0, max(len(edges), 1), bs):
                chunk = edges[i : i + bs]
                if not chunk:
                    return
                yield EdgeBatch.from_edges(
                    chunk, pad_to=bs, with_time=with_time, device=dev
                )

        return EdgeStream(factory, cfg, device=dev)

    @staticmethod
    def from_batches(
        factory: Callable[[], Iterator[EdgeBatch]],
        cfg: StreamConfig = StreamConfig(),
        device: DeviceLike = None,
    ) -> "EdgeStream":
        return EdgeStream(factory, cfg, device=device)

    @staticmethod
    def from_arrays(
        src: np.ndarray,
        dst: np.ndarray,
        cfg: StreamConfig = StreamConfig(),
        batch_size: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "EdgeStream":
        """Value-less, untimed stream over host id arrays."""
        src = np.asarray(src)
        dst = np.asarray(dst)
        if src.shape != dst.shape:
            raise ValueError("src/dst length mismatch")
        if len(src) and (
            min(src.min(), dst.min()) < 0
            or max(src.max(), dst.max()) >= cfg.vertex_capacity
        ):
            # check BEFORE the int32 cast: a cast-first check would let
            # 64-bit ids wrap into range
            raise ValueError(
                "vertex ids must be in [0, vertex_capacity); intern ids first "
                "(io.interning.VertexInterner)"
            )
        src = np.ascontiguousarray(src, dtype=np.int32)
        dst = np.ascontiguousarray(dst, dtype=np.int32)
        bs = batch_size or cfg.batch_size
        dev = resolve_device(device)

        def factory():
            for i in range(0, max(len(src), 1), bs):
                chunk_s = src[i : i + bs]
                if len(chunk_s) == 0:
                    return
                yield EdgeBatch.from_arrays(
                    chunk_s, dst[i : i + bs], pad_to=bs, device=dev
                )

        return EdgeStream(factory, cfg, device=dev, wire_arrays=(src, dst, bs))

    @staticmethod
    def from_wire(
        bufs: Sequence[np.ndarray],
        batch_size: int,
        width,
        cfg: StreamConfig = StreamConfig(),
        tail: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device: DeviceLike = None,
    ) -> "EdgeStream":
        """Replay source: ``bufs`` are per-batch uint8 wire buffers
        (``io.wire.pack_stream`` makes them), each holding ``batch_size``
        edges at ``width``, plus an optional raw ``(src, dst)`` remainder.
        ``aggregate()`` uploads them as they are and unpacks them on the
        device; every other consumer sees ordinary EdgeBatches through the
        host decode.  EF40/BDV buffers carry a sorted multiset, so only
        order-free aggregations take them.

        Guards: every buffer's size; for encodings that can express ids
        at or past ``cfg.vertex_capacity``, the FIRST buffer is decoded
        and its ids checked (validating every buffer is the producer's
        contract); the tail's ids are always checked."""
        bufs = list(bufs)
        cap = cfg.vertex_capacity
        validate_wire_width(width, cap)
        for i, b in enumerate(bufs):
            validate_wire_buffer(b, batch_size, width, cap, index=i)
        if bufs:
            is_bdv = isinstance(width, tuple) and width[0] == _wire.BDV
            fixed = not isinstance(width, tuple)
            id_bound = (1 << 20) if width == _wire.PAIR40 else (1 << (8 * width)) if fixed else 0
            if is_bdv or (fixed and id_bound > cap):
                validate_wire_buffer(bufs[0], batch_size, width, cap, index=0, decode_ids=True)
        if tail is not None:
            t_src0 = np.asarray(tail[0])
            t_dst0 = np.asarray(tail[1])
            # bounds BEFORE the int32 cast (a cast-first check would let
            # 64-bit ids wrap into range)
            if len(t_src0) and (
                min(t_src0.min(), t_dst0.min()) < 0 or max(t_src0.max(), t_dst0.max()) >= cap
            ):
                raise ValueError(
                    f"tail vertex ids must be in [0, vertex_capacity={cap}); "
                    "intern ids first (io.interning.VertexInterner)"
                )
            t_src = np.ascontiguousarray(t_src0, dtype=np.int32)
            t_dst = np.ascontiguousarray(t_dst0, dtype=np.int32)
            if t_src.shape != t_dst.shape or len(t_src) >= batch_size:
                raise ValueError("tail must be a (src, dst) pair shorter than one batch")
            tail = (t_src, t_dst) if len(t_src) else None
        dev = resolve_device(device)

        def factory():
            for b in bufs:
                s, d = _wire.unpack_edges_host(b, batch_size, width)
                yield EdgeBatch.from_arrays(s, d, pad_to=batch_size, device=dev)
            if tail is not None:
                yield EdgeBatch.from_arrays(tail[0], tail[1], pad_to=batch_size, device=dev)

        return EdgeStream(factory, cfg, device=dev, wire_packed=(bufs, batch_size, width, tail))

    # ---- execution ----------------------------------------------------------

    def batches(self) -> Iterator[EdgeBatch]:
        """The stream's micro-batches."""
        return self._source_factory()

    def aggregate(self, summary_aggregation, checkpoint_path: Optional[str] = None):
        """Run a summary aggregation over this stream
        (core/aggregation.SummaryAggregation.run); returns its
        OutputStream.  Checkpoints are not ported yet: a
        ``checkpoint_path`` raises NotImplementedError."""
        return summary_aggregation.run(self, checkpoint_path=checkpoint_path)
