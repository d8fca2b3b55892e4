"""Sketch summary descriptors: (eps, delta)-bounded state in KB, not O(C) MB.

Port of ``gelly_streaming_tpu/library/sketches.py``: three approximate
summaries on the order-free monoid kernels of ``summaries/sketches.py``,
each an ordinary ``SummaryBulkAggregation`` that rides the aggregation
runtime's wire and windowed paths:

  * ``SketchTriangleCount``: a streaming triangle estimate from an R-row
    min-hash edge sample and a distinct-edge HLL bank (arXiv:1308.2166's
    neighborhood sampling in order-free form); EXACT when the sample
    covers every distinct edge.
  * ``HLLDegreeSummary``: distinct-vertex and distinct-edge cardinalities
    from two HLL register banks (max-merge).
  * ``CountMinHeavyHitters``: the top-k degree heavy hitters from a d x w
    count-min grid (add-merge), the heap built only at emission.

Each ``update`` is one C call a batch on the GPU (``ops/sketches.py``):
``tri_fold`` with the edge registers, ``hll_degree_fold``,
``cm_degree_fold``.  ``update`` and ``combine`` change their first state in
place; the runtime clones the running state before an emission.  Register
shapes are functions of (eps, delta) alone.  Not ported yet (ROADMAP queue
A.7): the owner-sharded state (``SketchShardedState``), so on the mesh
plane with ``sharded_state`` on ``sharded_state_spec`` raises
``NotImplementedError`` (with ``sharded_state=0`` the replicated combine
runs); and ``cache_token`` and ``emission_scratch``, whose consumers are
the JAX runtime's executable cache, fused dispatch and admission pricing.
Without a mesh, ``num_shards > 1`` folds round-robin partitions on one
device and combines them, bit for bit the replicated result.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation
from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.ops import sketches as sk_ops
from gelly_streaming_tpu_torch.summaries import sketches as sk

#: the catalog of sketch summary kinds
SKETCH_KINDS = ("sketch_triangles", "hll_degree", "cm_heavy_hitters")


class SketchParamError(ValueError):
    """Invalid (eps, delta) contract, raised when a descriptor is built."""


def _check_eps_delta(eps: float, delta: float) -> tuple:
    try:
        eps = float(eps)
        delta = float(delta)
    except (TypeError, ValueError):
        raise SketchParamError(f"eps/delta must be numbers, got eps={eps!r} delta={delta!r}")
    if not (0.0 < eps < 1.0):
        raise SketchParamError(f"eps must be in (0, 1), got {eps}")
    if not (0.0 < delta < 1.0):
        raise SketchParamError(f"delta must be in (0, 1), got {delta}")
    return eps, delta


class _SketchSummary(SummaryBulkAggregation):
    """The shared sketch-descriptor surface: the kind and the contract."""

    #: the catalog's kind string (SKETCH_KINDS); subclasses set it
    kind: str = ""
    # register folds commute: legal on the sorted EF40 multiset wire encoding
    order_free = True

    def __init__(self, eps: float, delta: float, window_ms=None):
        super().__init__(window_ms)
        self.eps, self.delta = _check_eps_delta(eps, delta)

    def error_contract(self) -> dict:
        """The declared (eps, delta) bound."""
        return {"kind": self.kind, "eps": self.eps, "delta": self.delta}

    def sharded_state_spec(self, cfg: StreamConfig):
        raise NotImplementedError(
            "the sketches' owner-sharded state (SketchShardedState) is not ported yet (ROADMAP queue A.7); "
            "set sharded_state=0 for the replicated mesh combine"
        )


class TriangleSketchState(NamedTuple):
    eh: torch.Tensor  # int64[R] per-bucket min sample hash, a u32 value (EMPTY_HASH = none)
    elo: torch.Tensor  # int32[R] sampled edge lo endpoint (-1 = none)
    ehi: torch.Tensor  # int32[R] sampled edge hi endpoint (-1 = none)
    regs: torch.Tensor  # int32[M] distinct-edge HLL registers


class SketchTriangleCount(_SketchSummary):
    """Streaming triangle estimate from R min-hash-sampled edges.

    Emits ``(estimate, sampled_rows, distinct_edges)``: the closed wedges
    found within the sample, scaled by the cube of the per-edge inclusion
    probability (occupied rows / distinct edges from the HLL bank); see
    ``summaries.sketches.tri_estimate``."""

    kind = "sketch_triangles"

    def __init__(self, eps=0.1, delta=0.05, window_ms=None):
        super().__init__(eps, delta, window_ms)
        self.rows = sk.tri_rows(self.eps, self.delta)
        self.hll_m = sk.hll_num_registers(max(self.eps / 2.0, 0.01))

    def initial_state(self, cfg: StreamConfig, device: torch.device) -> TriangleSketchState:
        eh, elo, ehi = sk.tri_init(self.rows, device)
        return TriangleSketchState(eh=eh, elo=elo, ehi=ehi, regs=sk.hll_init(self.hll_m, device))

    def update(self, state, src, dst, val, mask) -> TriangleSketchState:
        # the sample and the edge registers (under mask & lo != hi): one C call
        sk_ops.tri_fold(state.eh, state.elo, state.ehi, src, dst, mask, state.regs)
        return state

    def combine(self, a, b) -> TriangleSketchState:
        eh, elo, ehi = sk.tri_merge((a.eh, a.elo, a.ehi), (b.eh, b.elo, b.ehi))
        return TriangleSketchState(eh=eh, elo=elo, ehi=ehi, regs=torch.maximum(a.regs, b.regs, out=a.regs))

    def transform(self, state):
        return sk.tri_estimate((state.eh, state.elo, state.ehi), state.regs)


class HLLDegreeState(NamedTuple):
    verts: torch.Tensor  # int32[M] distinct-vertex registers
    edges: torch.Tensor  # int32[M] distinct-edge registers


class HLLDegreeSummary(_SketchSummary):
    """Distinct-vertex / distinct-edge cardinalities (max-merge registers).

    Emits ``(distinct_vertices, distinct_edges)`` float32 estimates."""

    kind = "hll_degree"

    def __init__(self, eps=0.05, delta=0.05, window_ms=None):
        super().__init__(eps, delta, window_ms)
        self.hll_m = sk.hll_num_registers(self.eps)

    def initial_state(self, cfg: StreamConfig, device: torch.device) -> HLLDegreeState:
        return HLLDegreeState(verts=sk.hll_init(self.hll_m, device), edges=sk.hll_init(self.hll_m, device))

    def update(self, state, src, dst, val, mask) -> HLLDegreeState:
        # src and dst vertex hashes, the edge hash (self-loops included): one C call
        sk_ops.hll_degree_fold(state.verts, state.edges, src, dst, mask)
        return state

    def combine(self, a, b) -> HLLDegreeState:
        return HLLDegreeState(verts=torch.maximum(a.verts, b.verts, out=a.verts),
                              edges=torch.maximum(a.edges, b.edges, out=a.edges))

    def transform(self, state):
        return sk.hll_estimate(state.verts), sk.hll_estimate(state.edges)


class CountMinState(NamedTuple):
    grid: torch.Tensor  # int32[d * w] counter grid, stored flat


class CountMinHeavyHitters(_SketchSummary):
    """Top-k degree heavy hitters from a count-min grid (add-merge).

    Each edge adds 1 to both endpoints' counters in all d rows;
    ``transform`` queries every vertex id < capacity (min over the rows)
    and takes the top k, the lower id first among equal estimates (as
    ``jax.lax.top_k``).  Emits ``(vertex_ids[k], degree_estimates[k])``."""

    kind = "cm_heavy_hitters"

    def __init__(self, eps=0.01, delta=0.02, top_k=16, window_ms=None):
        super().__init__(eps, delta, window_ms)
        self.top_k = int(top_k)
        if self.top_k <= 0:
            raise SketchParamError(f"top_k must be positive, got {self.top_k}")
        self.depth, self.width = sk.cm_dims(self.eps, self.delta)
        # transform needs the candidate-id range; bound at initial_state
        self._capacity = None

    def error_contract(self) -> dict:
        out = super().error_contract()
        out["top_k"] = self.top_k
        return out

    def initial_state(self, cfg: StreamConfig, device: torch.device) -> CountMinState:
        self._capacity = cfg.vertex_capacity
        return CountMinState(grid=sk.cm_init(self.depth, self.width, device))

    def update(self, state, src, dst, val, mask) -> CountMinState:
        # 1 for src, then 1 for dst, in every row: one C call
        sk_ops.cm_degree_fold(state.grid, self.depth, self.width, src, dst, mask)
        return state

    def combine(self, a, b) -> CountMinState:
        return CountMinState(grid=a.grid.add_(b.grid))

    def transform(self, state):
        if self._capacity is None:
            raise RuntimeError(
                "CountMinHeavyHitters.transform before initial_state: the candidate-id range is bound per StreamConfig"
            )
        ids = torch.arange(self._capacity, dtype=torch.int32, device=state.grid.device)
        est = sk.cm_query(state.grid, self.depth, self.width, ids)
        # a stable descending sort: the lower id first among equal estimates
        vals, idx = torch.sort(est, descending=True, stable=True)
        k = min(self.top_k, self._capacity)
        return idx[:k].to(torch.int32), vals[:k]


def make_sketch(kind: str, eps=None, delta=None, top_k=None, window_ms=None):
    """A sketch descriptor from its catalog kind; unknown kinds and
    malformed knobs raise ``SketchParamError``."""
    if kind not in SKETCH_KINDS:
        raise SketchParamError(f"unknown sketch kind {kind!r} (expected one of {'/'.join(SKETCH_KINDS)})")
    kwargs = {"window_ms": window_ms}
    if eps is not None:
        kwargs["eps"] = eps
    if delta is not None:
        kwargs["delta"] = delta
    if kind == "sketch_triangles":
        return SketchTriangleCount(**kwargs)
    if kind == "hll_degree":
        return HLLDegreeSummary(**kwargs)
    if top_k is not None:
        kwargs["top_k"] = top_k
    return CountMinHeavyHitters(**kwargs)
