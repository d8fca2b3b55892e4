"""EdgeStream: the graph-stream API, as far as the windowed triangle path
uses it.

Port of the ``EdgeStream`` subset of ``gelly_streaming_tpu/core/stream.py``
that ``window_triangles`` reads: the constructors ``from_collection``,
``from_batches`` and ``from_arrays`` (with its vertex-id bounds check),
``batches()``, ``cfg``, the late-record sink, and the backing host arrays
that let count-cut panes slice straight off an array-backed stream.  A
stream also carries the torch device its batches are built on.
Transformation stages (map/filter/distinct/...) are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.types import EdgeBatch
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device


class EdgeStream:
    """A (possibly infinite) stream of graph edges over a dense vertex space.

    Construction:
      EdgeStream.from_collection(edges, cfg)      finite host collection
      EdgeStream.from_batches(factory, cfg)       any re-runnable batch source
      EdgeStream.from_arrays(src, dst, cfg)       value-less untimed id arrays
    """

    def __init__(
        self,
        source_factory: Callable[[], Iterator[EdgeBatch]],
        cfg: StreamConfig,
        device: DeviceLike = None,
        wire_arrays: Optional[Tuple[np.ndarray, np.ndarray, int]] = None,
    ):
        self._source_factory = source_factory
        self.cfg = cfg
        self.device = resolve_device(device)
        # (src, dst, batch_size) host arrays backing an array-built stream
        # (core/windows.stream_panes slices count-cut panes off them)
        self._wire_arrays = wire_arrays
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

    # ---- execution ----------------------------------------------------------

    def batches(self) -> Iterator[EdgeBatch]:
        """The stream's micro-batches."""
        return self._source_factory()
