"""Typed configuration for the port's stream pipelines.

The port's own copy of ``gelly_streaming_tpu/core/config.py``'s
``StreamConfig``, cut to the fields the ported slices read, with the same
defaults and the same validation for each.  ``interop.config_from_dict``
carries a JAX-package config across.
"""

from __future__ import annotations

import dataclasses

# BDV ids are bounded at 2^28 (io/wire.py; repeated here so the config
# imports nothing of the port's io)
BDV_MAX_ID_BITS = 28


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static-shape and windowing knobs for a stream pipeline.

    Attributes:
      vertex_capacity: dense vertex-id space size C; ids are interned to
        [0, C) and checked against it at the sources.
      max_degree: per-vertex neighbor-table capacity D (ops/neighbors.py).
      batch_size: edges per micro-batch (padded).
      num_shards: number of mesh shards the vertex space is partitioned
        over.  With that many local devices (``parallel/mesh.local_devices``:
        the GPUs, or ``set_host_device_count`` CPU shards) the aggregation
        runs the mesh plane (``core/aggregation.MeshAggregationRunner``);
        otherwise a pane's round-robin partitions fold one after another on
        one device and their partials are combined.
      window_ms: default tumbling-window length of an aggregation.
      tree_degree: fan-in of the tree combine (SummaryTreeAggregation).
      prefetch_depth: wire buffers kept in flight ahead of the device
        fold (io/prefetch.Prefetcher).
      wire_encoding: wire format of the fold's fast path over array-backed
        streams: "plain" ships arrival order at the narrowest fixed width,
        "ef40" the sorted Elias-Fano multiset (order-free folds, capacity
        <= 2^20), "auto" picks ef40 when it is legal, smaller, and the
        host has at least two cores to sort on.
      wire_checkpoint_batches: full batches between positional snapshots
        on the wire path (0 = a snapshot at stream end only).  Each
        snapshot copies the fold state off the card, so the interval trades
        recovery granularity against ingest rate.
      out_of_orderness_ms: bounded event-time out-of-orderness.  0 keeps
        the ascending-timestamp contract; positive values trail the
        watermark behind the max seen time by the bound and route
        later-than-bound records to the late sink
        (core/windows.assign_tumbling_windows).
      ingest_window_edges / ingest_window_ms: ingestion-time pane cut
        (close a pane every N arrivals, or by wall clock at batch
        boundaries).  When set, event timestamps are ignored.
      superbatch: wire buffers (or panes) coalesced per transfer.  0/1 =
        off.  The wire path folds a group's rows one after another, the
        windowed plane one row a pane.
      ingest_workers: host threads that parse files and pack superbatch
        groups (io/ingest.py).  0 = the GELLY_INGEST_WORKERS env var when
        set, else the process's usable cores; 1 = one thread.
      async_windows: closed windows kept in flight by the asynchronous
        window pipeline.  0 = synchronous; the port's window_triangles
        does not implement > 0 yet.
      sharded_state: owner-sharded summary state on the mesh plane
        (``core/sharded_state.py``): O(C/S) owner blocks a shard, reconciled
        by delta exchanges at emission and snapshot boundaries.  1 = on,
        0 = off (the replicated combine, the equivalence oracle), -1 =
        the GELLY_SHARDED_STATE env var when set, else on for descriptors
        that supply a ``ShardedStateSpec``.
      binned_ingest / wire_compress: destination-binned and BDV-compressed
        ingest of array-backed streams and closed panes (order-free folds
        only); 1 forces on, 0 off, -1 (default) defers to the
        GELLY_BINNED_INGEST / GELLY_WIRE_COMPRESS env vars (default off).
      spmv_direction: push/pull direction of the masked-SpMV fixpoints
        (ops/spmv.py: sssp, pagerank): "push"/"pull" force one lowering for
        every iteration; "auto" switches on frontier density; "" (default)
        defers to the GELLY_SPMV_DIRECTION env var (default auto).  Results
        are identical in every mode; this is a performance knob only.
      direction_threshold: the frontier density (|frontier| / |active
        vertices|) above which "auto" pulls.  -1.0 (default) defers to
        GELLY_DIRECTION_THRESHOLD, then ops/spmv.DEFAULT_DIRECTION_THRESHOLD.
    """

    vertex_capacity: int = 1 << 16
    max_degree: int = 64
    batch_size: int = 1 << 10
    num_shards: int = 1
    window_ms: int = 1000
    tree_degree: int = 2
    prefetch_depth: int = 8
    wire_encoding: str = "auto"
    wire_checkpoint_batches: int = 64
    out_of_orderness_ms: int = 0
    ingest_window_edges: int = 0
    ingest_window_ms: int = 0
    superbatch: int = 0
    ingest_workers: int = 0
    async_windows: int = 0
    sharded_state: int = -1
    binned_ingest: int = -1
    wire_compress: int = -1
    spmv_direction: str = ""
    direction_threshold: float = -1.0

    def __post_init__(self):
        if self.wire_encoding not in ("auto", "plain", "ef40"):
            raise ValueError(f"unknown wire_encoding {self.wire_encoding!r}")
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
        if self.wire_checkpoint_batches < 0:
            raise ValueError("wire_checkpoint_batches must be >= 0")
        if self.superbatch < 0:
            raise ValueError("superbatch must be >= 0")
        if self.ingest_workers < 0:
            raise ValueError("ingest_workers must be >= 0")
        if self.async_windows < 0:
            raise ValueError("async_windows must be >= 0")
        if self.sharded_state not in (-1, 0, 1):
            raise ValueError("sharded_state must be -1 (auto), 0, or 1")
        if self.binned_ingest not in (-1, 0, 1):
            raise ValueError("binned_ingest must be -1 (auto), 0, or 1")
        if self.wire_compress not in (-1, 0, 1):
            raise ValueError("wire_compress must be -1 (auto), 0, or 1")
        if self.spmv_direction not in ("", "auto", "push", "pull"):
            raise ValueError(
                "spmv_direction must be ''/auto/push/pull "
                "('' defers to GELLY_SPMV_DIRECTION)"
            )
        if self.direction_threshold != -1.0 and not (
            0.0 <= self.direction_threshold <= 1.0
        ):
            raise ValueError(
                "direction_threshold must be -1 (defer) or a density in [0, 1]"
            )
        if self.wire_compress == 1 and self.binned_ingest == 0:
            raise ValueError(
                "wire_compress=1 needs binned batches (delta encoding rides "
                "the sorted bins); don't force binned_ingest=0 with it"
            )
        if self.wire_compress == 1 and self.vertex_capacity > 1 << BDV_MAX_ID_BITS:
            raise ValueError(
                f"wire_compress needs vertex_capacity <= 2^{BDV_MAX_ID_BITS} (BDV varints)"
            )
        if self.vertex_capacity <= 0:
            raise ValueError("vertex_capacity must be positive")
        if self.num_shards <= 0:
            raise ValueError("num_shards must be positive")
        if self.vertex_capacity % self.num_shards != 0:
            raise ValueError(
                f"vertex_capacity ({self.vertex_capacity}) must be divisible by "
                f"num_shards ({self.num_shards}) for even sharding"
            )

