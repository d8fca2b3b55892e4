"""Typed configuration for the port's stream pipelines.

The port's own copy of ``gelly_streaming_tpu/core/config.py``'s
``StreamConfig``, cut to the fields the ported slice reads, with the same
defaults and the same validation for each.  ``interop.config_from_dict``
carries a JAX-package config across.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static-shape and windowing knobs for a stream pipeline.

    Attributes:
      vertex_capacity: dense vertex-id space size C; ids are interned to
        [0, C) and checked against it at the sources.
      max_degree: per-vertex neighbor-table capacity D (ops/neighbors.py).
      batch_size: edges per micro-batch (padded).
      out_of_orderness_ms: bounded event-time out-of-orderness.  0 keeps
        the ascending-timestamp contract; positive values trail the
        watermark behind the max seen time by the bound and route
        later-than-bound records to the late sink
        (core/windows.assign_tumbling_windows).
      ingest_window_edges / ingest_window_ms: ingestion-time pane cut
        (close a pane every N arrivals, or by wall clock at batch
        boundaries).  When set, event timestamps are ignored.
      superbatch: panes coalesced per device dispatch.  0/1 = off; the
        port's window_triangles does not implement > 1 yet.
      async_windows: closed windows kept in flight by the asynchronous
        window pipeline.  0 = synchronous; the port's window_triangles
        does not implement > 0 yet.
    """

    vertex_capacity: int = 1 << 16
    max_degree: int = 64
    batch_size: int = 1 << 10
    out_of_orderness_ms: int = 0
    ingest_window_edges: int = 0
    ingest_window_ms: int = 0
    superbatch: int = 0
    async_windows: int = 0

    def __post_init__(self):
        if self.out_of_orderness_ms < 0:
            raise ValueError("out_of_orderness_ms must be >= 0")
        if self.out_of_orderness_ms and (
            self.ingest_window_edges or self.ingest_window_ms
        ):
            raise ValueError(
                "out_of_orderness_ms applies to event-time windows only; "
                "ingestion-time panes window by arrival order"
            )
        if self.ingest_window_edges < 0 or self.ingest_window_ms < 0:
            raise ValueError("ingest window knobs must be >= 0")
        if self.ingest_window_edges and self.ingest_window_ms:
            raise ValueError(
                "set only one of ingest_window_edges / ingest_window_ms"
            )
        if self.superbatch < 0:
            raise ValueError("superbatch must be >= 0")
        if self.async_windows < 0:
            raise ValueError("async_windows must be >= 0")
        if self.vertex_capacity <= 0:
            raise ValueError("vertex_capacity must be positive")

