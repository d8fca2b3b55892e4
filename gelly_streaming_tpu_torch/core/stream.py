"""EdgeStream: the graph-stream API (reference: GraphStream.java + SimpleEdgeStream.java).

Port of ``gelly_streaming_tpu/core/stream.py``'s ``EdgeStream``.  A stream is a lazy
pipeline of stages over padded COO micro-batches; each stage is a
``(state, batch) -> (state, batch)`` function run eagerly on the stream's
torch device (the JAX package composes and jits them; there is no jit
here), and its state (dense per-vertex tensors) threads through the run.

API parity map (reference file:line):
  map_edges            SimpleEdgeStream.java:217   (value transform per edge)
  filter_edges         SimpleEdgeStream.java:290
  filter_vertices      SimpleEdgeStream.java:257-281 (predicate on both endpoints)
  distinct             SimpleEdgeStream.java:301-323 (stateful seen-table)
  reverse              SimpleEdgeStream.java:328
  undirected           SimpleEdgeStream.java:350-361 (emit edge + reverse)
  union                SimpleEdgeStream.java:343
  get_vertices         SimpleEdgeStream.java:116-129 (first-occurrence emission)
  get_degrees/in/out   SimpleEdgeStream.java:413-478 (running degree trace)
  number_of_vertices   SimpleEdgeStream.java:366-383 (running distinct count)
  number_of_edges      SimpleEdgeStream.java:388-404 (running edge count)
  keyed_aggregate      SimpleEdgeStream.java:489-494 (flatMap -> keyBy -> stateful map)
  global_aggregate     SimpleEdgeStream.java:505-519 (parallelism-1 aggregate, emit on change)
  build_neighborhood   SimpleEdgeStream.java:531-560 (continuous adjacency)
  slice                SimpleEdgeStream.java:135-167 -> core/snapshot.py
  aggregate            SimpleEdgeStream.java:100-102 -> core/aggregation.py

The property streams run their kernel after the stages on the device and
download each batch's outputs through ``io/prefetch.prefetch_to_host``;
array-backed streams upload packed wire buffers and unpack them on the
device first.  The degree trace's kernel is ``ops/degrees.degree_trace``
(``csrc/degrees.cu`` on the GPU); the vertex and edge counters are PyTorch
ops on the device, as are the keyed and global aggregates (the caller's
callables, on tensors) and ``build_neighborhood`` (``ops/neighbors``).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.output import NULL, OutputStream, RecordBlock
from gelly_streaming_tpu_torch.core.types import EdgeBatch, EdgeDirection, tree_leaves
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.io import wire as _wire
from gelly_streaming_tpu_torch.io.prefetch import WirePrefetcher, prefetch_to_host
from gelly_streaming_tpu_torch.ops import degrees, indexing, neighbors, segments


# ---------------------------------------------------------------------------
# pipeline stages


class Stage:
    """A pipeline stage: ``init`` builds its state on a device, ``apply``
    maps (state, batch) to (state, batch)."""

    def init(self, cfg: StreamConfig, device: torch.device):
        return ()

    def apply(self, state, batch: EdgeBatch):
        raise NotImplementedError


class _Stateless(Stage):
    def __init__(self, fn: Callable[[EdgeBatch], EdgeBatch]):
        self.fn = fn

    def apply(self, state, batch):
        return state, self.fn(batch)


def _value_bits(val) -> torch.Tensor:
    """Lossless int32 view of a per-edge scalar value for whole-edge dedup.

    Values of <= 32 bits are bit-cast (floats) or cast (integers, bools)
    without collision; multi-leaf or wider values have no sound dense form
    (a hash could collide and drop distinct edges) and are refused."""
    leaves = tree_leaves(val)
    if len(leaves) != 1 or leaves[0].dim() != 1:
        raise ValueError(
            "whole-edge distinct needs a single scalar value per edge; "
            "use distinct(by='endpoints') or map the values into one "
            "<=32-bit scalar first (map_edges)"
        )
    leaf = leaves[0]
    size = leaf.element_size()
    if size > 4:
        raise ValueError(
            f"whole-edge distinct supports values of <= 32 bits (got {leaf.dtype}); "
            "use distinct(by='endpoints') or narrow the values (map_edges)"
        )
    if leaf.dtype.is_floating_point:
        # a bit-cast: a cast would truncate (1.5 and 1.0 both -> 1)
        width_int = {1: torch.int8, 2: torch.int16, 4: torch.int32}[size]
        return leaf.view(width_int).to(torch.int32)
    if not leaf.dtype.is_complex:
        return leaf.to(torch.int32)
    raise ValueError(
        f"whole-edge distinct cannot form exact bits for dtype {leaf.dtype}; "
        "use distinct(by='endpoints') or map the values (map_edges)"
    )


class _DistinctStage(Stage):
    """Stateful distinct with the reference's per-key HashSet semantics
    (SimpleEdgeStream.java:309-323) in device neighbor tables.  ``edge``
    mode dedupes (src, dst, value) triples through two slot-aligned tables
    (value-less batches carry the value bits 0); ``endpoints`` mode dedupes
    (src, dst) pairs in one table, the first value winning."""

    def __init__(self, mode: str):
        assert mode in ("edge", "endpoints"), mode
        self.mode = mode

    def init(self, cfg, device):
        table = neighbors.init_table(cfg.vertex_capacity, cfg.max_degree, device)
        if self.mode == "endpoints":
            return table
        return (table, neighbors.init_table(cfg.vertex_capacity, cfg.max_degree, device))

    def apply(self, state, batch):
        if self.mode == "endpoints":
            table, is_new = neighbors.insert_unique_batch(state, batch.src, batch.dst, batch.mask)
            return table, batch.replace(mask=is_new)
        table, vtable = state
        bits = (
            torch.zeros(batch.src.shape, dtype=torch.int32, device=batch.src.device)
            if batch.val is None
            else _value_bits(batch.val)
        )
        table, vtable, is_new = neighbors.insert_unique_valued_batch(
            table, vtable, batch.src, batch.dst, bits, batch.mask
        )
        return (table, vtable), batch.replace(mask=is_new)


class _FanoutLateHolder:
    """Late-sink holder of ``union()``: one logical sink over the unioned
    chain and both input chains.  Reads fall through to the parents;
    writes fan out to them."""

    def __init__(self, *parents):
        self._parents = parents
        self._own = {"sink": None}

    def __getitem__(self, key):
        if self._own[key] is not None:
            return self._own[key]
        for parent in self._parents:
            value = parent[key]
            if value is not None:
                return value
        return None

    def __setitem__(self, key, value):
        self._own[key] = value
        for parent in self._parents:
            parent[key] = value


def _interleave_endpoints(batch: EdgeBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge (src, dst) emission order, flattened to [2B] (EmitSrcAndTarget
    / DegreeTypeSeparator order, SimpleEdgeStream.java:181-188,450-458)."""
    v = torch.stack([batch.src, batch.dst], dim=1).reshape(-1)
    m = torch.stack([batch.mask, batch.mask], dim=1).reshape(-1)
    return v, m


def _sorted_dicts(x):
    """``x`` with every dict rebuilt in sorted key order (the order JAX's
    pytrees give a dict's leaves and unflatten it in)."""
    if isinstance(x, dict):
        return {k: _sorted_dicts(x[k]) for k in sorted(x)}
    if isinstance(x, (tuple, list)) and not hasattr(x, "_fields"):
        return type(x)(_sorted_dicts(v) for v in x)
    return x


def _round_robin(iterators: List[Iterator]) -> Iterator:
    iterators = list(iterators)
    while iterators:
        nxt = []
        for it in iterators:
            try:
                yield next(it)
                nxt.append(it)
            except StopIteration:
                pass
        iterators = nxt


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
        stages: Tuple[Stage, ...] = (),
        valued: Optional[bool] = None,
    ):
        self._source_factory = source_factory
        self.cfg = cfg
        self.device = resolve_device(device)
        self._stages = stages
        # does the stream carry edge values: True / False when the source
        # knows, None for opaque batch sources (distinct's auto mode reads it)
        self._valued = valued
        # (src, dst, batch_size) host arrays backing an array-built stream
        # (the aggregation wire path and the property streams pack them;
        # core/windows.stream_panes slices count-cut panes off them); kept
        # through stages, which run after the device unpack
        self._wire_arrays = wire_arrays
        # (bufs, batch_size, width, tail) of a from_wire replay: buffers
        # already in the wire format, uploaded as they are
        self._wire_packed = wire_packed
        # shared by every stream derived with _with: on_late() anywhere in a
        # transform chain is seen by the whole chain
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

        return EdgeStream(factory, cfg, device=dev, valued=bool(edges) and len(edges[0]) >= 3)

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

        return EdgeStream(factory, cfg, device=dev, wire_arrays=(src, dst, bs), valued=False)

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

        return EdgeStream(
            factory, cfg, device=dev, wire_packed=(bufs, batch_size, width, tail), valued=False
        )

    def _with(self, stage: Stage, valued: Optional[bool] = None) -> "EdgeStream":
        out = EdgeStream(
            self._source_factory,
            self.cfg,
            device=self.device,
            wire_arrays=self._wire_arrays,
            wire_packed=self._wire_packed,
            stages=self._stages + (stage,),
            valued=self._valued if valued is None else valued,
        )
        out._late_holder = self._late_holder  # alias: one sink per chain
        return out

    # ---- transformations (lazy) --------------------------------------------

    def map_edges(self, fn: Callable) -> "EdgeStream":
        """Transform each edge's value: ``fn(src, dst, val) -> new val`` on
        the batch's tensors (a tuple of tensors is a tuple value)
        (SimpleEdgeStream.java:217)."""

        def tx(batch: EdgeBatch) -> EdgeBatch:
            return batch.replace(val=fn(batch.src, batch.dst, batch.val))

        return self._with(_Stateless(tx), valued=True)

    def filter_edges(self, pred: Callable) -> "EdgeStream":
        """Keep edges where ``pred(src, dst, val)`` is True (SimpleEdgeStream.java:290)."""

        def tx(batch: EdgeBatch) -> EdgeBatch:
            return batch.replace(mask=batch.mask & pred(batch.src, batch.dst, batch.val))

        return self._with(_Stateless(tx))

    def filter_vertices(self, pred: Callable) -> "EdgeStream":
        """Keep edges whose BOTH endpoints satisfy ``pred(vertex_ids)``
        (SimpleEdgeStream.java:264-281)."""

        def tx(batch: EdgeBatch) -> EdgeBatch:
            return batch.replace(mask=batch.mask & pred(batch.src) & pred(batch.dst))

        return self._with(_Stateless(tx))

    def reverse(self) -> "EdgeStream":
        """Swap src/dst (SimpleEdgeStream.java:328)."""
        return self._with(_Stateless(lambda b: b.reversed()))

    def undirected(self) -> "EdgeStream":
        """Emit each edge in both directions (SimpleEdgeStream.java:350-361).
        Doubles the static batch size."""
        return self._with(_Stateless(lambda b: b.concat(b.reversed())))

    def distinct(self, by: str = "auto") -> "EdgeStream":
        """Drop duplicate edges (SimpleEdgeStream.java:301-323).  ``auto``
        dedupes whole edges (value included) unless the source is known to
        be value-less, where endpoint pairs are the same thing at half the
        state; ``edge`` and ``endpoints`` force either mode.  A new edge
        past its source's ``cfg.max_degree`` table slots is emitted but not
        remembered, so a later duplicate of it passes again."""
        if by not in ("auto", "edge", "endpoints"):
            raise ValueError(f"unknown distinct mode {by!r}")
        if by == "auto":
            by = "endpoints" if self._valued is False else "edge"
        return self._with(_DistinctStage(by))

    def union(self, other: "EdgeStream") -> "EdgeStream":
        """Merge two edge streams (SimpleEdgeStream.java:343); batches of
        both (fully transformed) streams interleave round robin."""
        if other.cfg.vertex_capacity != self.cfg.vertex_capacity:
            raise ValueError("union requires matching vertex_capacity")
        if other.device != self.device:
            raise ValueError("union requires both streams on one device")
        left, right = self, other

        def factory():
            yield from _round_robin([left.batches(), right.batches()])

        if left._valued is None or right._valued is None:
            merged_valued = True if (left._valued or right._valued) else None
        else:
            merged_valued = left._valued or right._valued
        out = EdgeStream(factory, self.cfg, device=self.device, valued=merged_valued)
        out._late_holder = _FanoutLateHolder(left._late_holder, right._late_holder)
        return out

    # ---- execution ----------------------------------------------------------

    def _init_stage_states(self) -> list:
        return [stage.init(self.cfg, self.device) for stage in self._stages]

    def _apply_stages(self, states: list, batch: EdgeBatch) -> EdgeBatch:
        """Run the stage chain over one batch, updating ``states``."""
        for k, stage in enumerate(self._stages):
            states[k], batch = stage.apply(states[k], batch)
        return batch

    def batches(self) -> Iterator[EdgeBatch]:
        """The stream's micro-batches, through the stage chain."""
        if not self._stages:
            return self._source_factory()

        def run():
            states = self._init_stage_states()
            for batch in self._source_factory():
                yield self._apply_stages(states, batch)

        return run()

    def _kernel_stream(self, init_fn, kernel) -> Iterator:
        """Run a terminal op's kernel after the stages, batch by batch.

        ``kernel(op_state, batch) -> (op_state, outs)``, ``outs`` a tensor
        or a tuple of tensors; ``init_fn(cfg, device)`` builds the op
        state.  Yields each batch's ``outs`` as numpy arrays, downloaded
        ahead of the consumer (io/prefetch.prefetch_to_host)."""
        yield from prefetch_to_host(
            self._kernel_stream_device(init_fn, kernel), self.device, depth=self.cfg.prefetch_depth
        )

    def _kernel_stream_device(self, init_fn, kernel) -> Iterator:
        """``_kernel_stream``'s device plane: yields per-batch device outs.
        An array-backed stream packs its batches at the fixed width of its
        capacity on the prefetcher's thread, uploads them and unpacks them
        on the device (the remainder is one padded batch); any other source
        is read as EdgeBatches."""
        cfg, dev = self.cfg, self.device
        states = self._init_stage_states()
        op_state = init_fn(cfg, dev)

        def step(batch):
            nonlocal op_state
            op_state, outs = kernel(op_state, self._apply_stages(states, batch))
            return outs

        if self._wire_arrays is None:
            for batch in self._source_factory():
                yield step(batch)
            return
        src, dst, batch_size = self._wire_arrays
        bs = min(batch_size, max(len(src), 1))
        n_full = len(src) // bs
        width = _wire.width_for_capacity(cfg.vertex_capacity)
        full = ((src[i * bs : (i + 1) * bs], dst[i * bs : (i + 1) * bs]) for i in range(n_full))
        ones = torch.ones((bs,), dtype=torch.bool, device=dev)
        with WirePrefetcher(full, width, dev, depth=cfg.prefetch_depth) as pf:
            for buf, _ in pf:
                s, d = _wire.unpack_edges(buf, bs, width)
                yield step(EdgeBatch(src=s, dst=d, mask=ones))
        if len(src) > n_full * bs:
            yield step(EdgeBatch.from_arrays(src[n_full * bs :], dst[n_full * bs :], pad_to=bs, device=dev))

    def collect_edges(self) -> List[tuple]:
        out: List[tuple] = []
        for b in self.batches():
            out.extend(b.to_tuples())
        return out

    def edges_csv_lines(self) -> List[str]:
        return OutputStream(lambda: iter(self.collect_edges())).lines()

    # ---- continuous property streams ---------------------------------------

    def get_vertices(self) -> OutputStream:
        """(vertex, NullValue) on each vertex's first appearance
        (SimpleEdgeStream.java:116-129: EmitSrcAndTarget + FilterDistinctVertices)."""

        def init(cfg, dev):
            return torch.zeros((cfg.vertex_capacity,), dtype=torch.bool, device=dev)

        def kernel(seen, batch):
            v, m = _interleave_endpoints(batch)
            new = segments.first_occurrence_mask(v, m) & ~seen[indexing.gather_index(v, seen.shape[0])] & m
            return indexing.scatter_true_(seen, v[m]), (v, new)

        def blocks():
            for v, new in self._kernel_stream(init, kernel):
                yield RecordBlock((v[np.nonzero(new)[0]], NULL))

        return OutputStream(blocks_fn=blocks)

    def get_degrees(self) -> OutputStream:
        """Running (vertex, degree) trace over both endpoints
        (SimpleEdgeStream.java:413-415, DegreeTypeSeparator both flags true)."""
        return self._degree_stream(EdgeDirection.ALL)

    def get_in_degrees(self) -> OutputStream:
        return self._degree_stream(EdgeDirection.IN)

    def get_out_degrees(self) -> OutputStream:
        return self._degree_stream(EdgeDirection.OUT)

    def _degree_stream(self, direction: EdgeDirection) -> OutputStream:
        """The continuous degree property stream: the k-th valid occurrence
        of vertex v in a batch emits ``counts[v] + k + 1`` (DegreeMapFunction's
        per-record HashMap update, SimpleEdgeStream.java:461-478), by
        ``ops/degrees.degree_trace``.  Vertex spaces up to 2^20 download
        records packed (48 bits and a mask bit a row, degrees clipped at
        2^28 - 1); wider ones download raw int32 columns and a bool mask."""
        packed = self.cfg.vertex_capacity <= 1 << 20

        def init(cfg, dev):
            return torch.zeros((cfg.vertex_capacity,), dtype=torch.int32, device=dev)

        def kernel(counts, batch):
            if direction == EdgeDirection.ALL:
                v, m = _interleave_endpoints(batch)
            elif direction == EdgeDirection.OUT:
                v, m = batch.src, batch.mask
            else:
                v, m = batch.dst, batch.mask
            return counts, degrees.degree_trace(counts, v.contiguous(), m.contiguous(), packed)

        def blocks():
            for outs in self._kernel_stream(init, kernel):
                if packed:
                    records, maskbits = outs
                    ids, vals, m = _wire.unpack_records48(records, maskbits, len(records) // 6)
                else:
                    ids, vals, m = outs
                if m.all():  # every row valid: the compaction would copy
                    yield RecordBlock((ids, vals))
                else:
                    idx = np.nonzero(m)[0]
                    yield RecordBlock((ids[idx], vals[idx]))

        return OutputStream(blocks_fn=blocks)

    def number_of_vertices(self) -> OutputStream:
        """Running distinct-vertex count, emitted on change
        (SimpleEdgeStream.java:366-383 via GlobalAggregateMapper :562-576)."""

        def init(cfg, dev):
            return torch.zeros((cfg.vertex_capacity,), dtype=torch.bool, device=dev)

        def kernel(seen, batch):
            v, m = _interleave_endpoints(batch)
            new = segments.first_occurrence_mask(v, m) & ~seen[indexing.gather_index(v, seen.shape[0])] & m
            running = seen.sum(dtype=torch.int32) + torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32)
            return indexing.scatter_true_(seen, v[m]), (running, new)

        def blocks():
            for running, new in self._kernel_stream(init, kernel):
                yield RecordBlock((running[np.nonzero(new)[0]],))

        return OutputStream(blocks_fn=blocks)

    def number_of_edges(self) -> OutputStream:
        """Running edge count, one record per arriving edge
        (parallelism-1 counter, SimpleEdgeStream.java:388-404)."""

        def init(cfg, dev):
            return torch.zeros((), dtype=torch.int32, device=dev)

        def kernel(total, batch):
            running = total + torch.cumsum(batch.mask.to(torch.int32), 0, dtype=torch.int32)
            return total + batch.num_valid(), (running, batch.mask)

        def blocks():
            for running, m in self._kernel_stream(init, kernel):
                yield RecordBlock((running[np.nonzero(m)[0]],))

        return OutputStream(blocks_fn=blocks)

    def get_edges(self) -> OutputStream:
        """The edge stream itself as records (GraphStream.getEdges)."""

        def records():
            for batch in self.batches():
                yield from batch.to_tuples()

        return OutputStream(records)

    def keyed_aggregate(
        self,
        edge_expand: Callable,
        state_init: Callable,
        vertex_update: Callable,
    ) -> OutputStream:
        """Generic keyed aggregation, the reference's ``aggregate(edgeMapper,
        vertexMapper)`` (SimpleEdgeStream.java:489-494), on tensors:

          edge_expand(src, dst, val) -> (keys [M, B], vals pytree of [M, B]):
              M records an edge;
          state_init(cfg) -> dense per-key state pytree (tensors over
              [0, C)), moved to the stream's device;
          vertex_update(state, keys [N], vals [N], mask [N])
              -> (state, out pytree of [N], out_mask [N]).

        Returns the (key, out...) records, one RecordBlock of compacted
        columns a batch; an output that is not a single tensor or a flat
        tuple of them (a dict, nested tuples) becomes one object column of
        per-record values of its structure, dicts with their keys sorted
        as the JAX package's pytrees order them."""
        spec = []  # the output's structure, set by the kernel

        def init(cfg, dev):
            return pytree.tree_map(lambda t: torch.as_tensor(t).to(dev), state_init(cfg))

        def kernel(state, batch):
            keys, vals = edge_expand(batch.src, batch.dst, batch.val)
            m = keys.shape[0]
            flat_vals = pytree.tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])), vals)
            state, out, out_mask = vertex_update(state, keys.reshape(-1), flat_vals, batch.mask.repeat(m))
            leaves, treespec = pytree.tree_flatten(out)
            spec[:] = [treespec]
            return state, (keys.reshape(-1), out_mask, *leaves)

        def is_flat(treespec) -> bool:
            """A flat tuple of leaves or a single leaf: the block's columns
            are the record tuples."""
            n = treespec.num_leaves
            return treespec in (pytree.tree_structure(tuple(range(n))), pytree.tree_structure(0))

        def blocks():
            for k_h, m_h, *cols in self._kernel_stream(init, kernel):
                sel = np.nonzero(m_h)[0]
                if len(sel) == 0:
                    continue
                k_h = k_h[sel]
                cols = [c[sel] for c in cols]
                if is_flat(spec[0]):
                    yield RecordBlock((k_h, *cols))
                    continue
                recs = np.empty((len(k_h),), object)
                for i in range(len(k_h)):
                    recs[i] = _sorted_dicts(pytree.tree_unflatten([c[i].item() for c in cols], spec[0]))
                yield RecordBlock((k_h, recs))

        return OutputStream(blocks_fn=blocks)

    def global_aggregate(
        self,
        update: Callable,
        initial_state: Callable,
        result: Callable,
        emit_on_change: bool = True,
    ) -> OutputStream:
        """Centralized (parallelism-1) aggregation with change dedup
        (SimpleEdgeStream.java:505-519, GlobalAggregateMapper :562-576):
        ``update(state, batch) -> state`` on the device, ``result(state)``
        a host value; a record a batch whose result changed (every batch
        when ``emit_on_change`` is False).  ``initial_state(cfg)``'s
        tensors are moved to the stream's device."""
        cfg, dev = self.cfg, self.device

        def records():
            state = pytree.tree_map(lambda t: torch.as_tensor(t).to(dev), initial_state(cfg))
            prev = None
            for batch in self.batches():
                state = update(state, batch)
                res = result(state)
                if not emit_on_change or res != prev:
                    yield res if isinstance(res, tuple) else (res,)
                    prev = res

        return OutputStream(records)

    def build_neighborhood(self, directed: bool = False, mode: str = "block") -> OutputStream:
        """Continuous adjacency stream (SimpleEdgeStream.java:531-560): per
        arriving edge, its source's neighbors as of the end of its batch
        (the reference's per-edge TreeSet trace at batch_size=1).

        ``directed=False`` makes the stream undirected first, so each edge
        adds both directions.  ``mode="block"`` emits RecordBlocks of (src,
        dst, the source's row sorted on the device with -1 past its degree
        ([D] int32), degree); ``mode="trace"`` emits (src, dst,
        sorted-neighbor-tuple) records."""
        if mode not in ("block", "trace"):
            raise ValueError(f"unknown mode {mode!r}")
        base = self if directed else self.undirected()
        big = torch.iinfo(torch.int32).max

        def init(cfg, dev):
            return neighbors.init_table(cfg.vertex_capacity, cfg.max_degree, dev)

        def kernel(table, batch):
            table, _ = neighbors.insert_unique_batch(table, batch.src, batch.dst, batch.mask)
            rows, valid = neighbors.gather_rows(table, batch.src)
            # each row sorted on the device, empty slots last as -1: the
            # reference's TreeSet order without host work
            rows_sorted = torch.sort(torch.where(valid, rows, big), dim=1).values
            deg = valid.sum(dim=1, dtype=torch.int32)
            slots = torch.arange(rows.shape[1], device=rows.device)
            rows_sorted = torch.where(slots[None, :] < deg[:, None], rows_sorted, -1)
            return table, (batch.src, batch.dst, batch.mask, rows_sorted, deg)

        def blocks():
            for s_h, d_h, m_h, rows_h, deg_h in base._kernel_stream(init, kernel):
                sel = np.nonzero(m_h)[0]
                if len(sel):
                    yield RecordBlock((s_h[sel], d_h[sel], rows_h[sel], deg_h[sel]))

        if mode == "block":
            return OutputStream(blocks_fn=blocks)

        def records():
            for blk in blocks():
                s_c, d_c, rows_c, deg_c = blk.columns
                for i in range(blk.num_records):
                    yield (int(s_c[i]), int(d_c[i]), tuple(int(x) for x in rows_c[i][: deg_c[i]]))

        return OutputStream(records)

    # ---- windows -------------------------------------------------------------

    def slice(
        self,
        window_ms: Optional[int] = None,
        direction: EdgeDirection = EdgeDirection.OUT,
        slide_ms: Optional[int] = None,
    ):
        """Windowed snapshot stream (SimpleEdgeStream.java:135-167).

        Tumbling by default; pass ``slide_ms`` (must divide ``window_ms``)
        for sliding windows of size ``window_ms`` emitted every ``slide_ms``,
        by pane-sharing (core/windows.sliding_panes)."""
        from gelly_streaming_tpu_torch.core.snapshot import SnapshotStream

        return SnapshotStream(self, window_ms or self.cfg.window_ms, direction, slide_ms)

    def aggregate(self, summary_aggregation, checkpoint_path: Optional[str] = None, restore: bool = True):
        """Run a summary aggregation over this stream
        (GraphStream.java:139-140 -> core/aggregation.SummaryAggregation.run);
        returns its OutputStream.

        With ``checkpoint_path`` the running summary and the stream position
        are snapshot as the stream folds and restored on start (``restore``
        False starts afresh), on every plane the port runs, the wire path
        included (an ``.npz`` whose leaves are the JAX package's at the same
        position); ``utils/recovery.run_supervised`` rebuilds a crashed
        pipeline from it."""
        return summary_aggregation.run(self, checkpoint_path=checkpoint_path, restore=restore)
