"""Capacity-bounded adjacency summary with level-bounded BFS (spanner support).

Port of ``gelly_streaming_tpu/summaries/adjacency.py`` (reference:
summaries/AdjacencyListGraph.java): an undirected neighbor table
``nbrs: int32[C, D]`` (-1 = empty) plus ``deg: int32[C]``, an idempotent
both-rows insert, and the three exact distance tests the spanner's
admission picks from: ``within_two`` (k = 2, a row intersection),
``within_k_balls`` (meet-in-the-middle balls) and ``bounded_bfs`` (k dense
frontier sweeps of the table).  These are plain tensor ops: the spanner's
hot path runs them inside ``csrc/spanner.cu``, and the twin of that
kernel (``ops/spanner.py``) calls them.  Ids outside [0, C) follow JAX's
index rules (``ops/indexing.py``): a gather clamps, a scatter drops.
"""

from __future__ import annotations

from typing import Dict, Set, Tuple, Union

import numpy as np
import torch

from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import indexing

Index = Union[int, torch.Tensor]


def init_table(capacity: int, max_degree: int, device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = resolve_device(device)
    nbrs = torch.full((capacity, max_degree), -1, dtype=torch.int32, device=dev)
    deg = torch.zeros((capacity,), dtype=torch.int32, device=dev)
    return nbrs, deg


def _gather_row(size: int, i: int) -> int:
    """The row a JAX gather at scalar ``i`` reads: normalized, clamped."""
    i = i + size if i < 0 else i
    return min(max(i, 0), size - 1)


def _scatter_row(size: int, i: int):
    """The row a JAX scatter at scalar ``i`` writes, or None (dropped)."""
    i = i + size if i < 0 else i
    return i if 0 <= i < size else None


def contains_edge(nbrs: torch.Tensor, u: Index, v: Index) -> torch.Tensor:
    """Vectorized membership: is v in N(u)?  u, v scalars or [B]."""
    u = torch.as_tensor(u, device=nbrs.device)
    v = torch.as_tensor(v, device=nbrs.device)
    row = nbrs[indexing.gather_index(u, nbrs.shape[0])]
    return torch.any(row == v[..., None] if v.dim() else row == v, dim=-1)


def add_undirected_edge_(nbrs: torch.Tensor, deg: torch.Tensor, u: int, v: int, enabled: bool = True) -> bool:
    """Idempotently insert u-v in both rows, in place (AdjacencyListGraph.
    java:46-68); returns whether it inserted.

    Presence in either row counts (an earlier overflow may have left half
    an edge); both rows need room or neither is written (the summary stays
    symmetric under overflow); u == v is never inserted.
    """
    capacity, max_degree = nbrs.shape
    u, v = int(u), int(v)
    gu, gv = _gather_row(capacity, u), _gather_row(capacity, v)
    present = u == v or bool((nbrs[gu] == v).any()) or bool((nbrs[gv] == u).any())
    du, dv = int(deg[gu]), int(deg[gv])
    if not enabled or present or du >= max_degree or dv >= max_degree:
        return False
    su, sv = _scatter_row(capacity, u), _scatter_row(capacity, v)
    if su is not None:
        nbrs[su, du] = v
    if sv is not None:
        nbrs[sv, dv] = u
    for s in (su, sv):
        if s is not None:
            deg[s] += 1
    return True


def add_undirected_edge(
    nbrs: torch.Tensor, deg: torch.Tensor, u: int, v: int, enabled: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``add_undirected_edge_`` on copies: the JAX function's (nbrs, deg)."""
    nbrs, deg = nbrs.clone(), deg.clone()
    add_undirected_edge_(nbrs, deg, u, v, enabled)
    return nbrs, deg


def within_two(nbrs: torch.Tensor, u: int, v: int) -> bool:
    """True iff dist(u, v) <= 2, via neighbor-row intersection: u == v,
    v in N(u), or N(u) and N(v) share a vertex (O(D^2), independent of C)."""
    capacity = nbrs.shape[0]
    u, v = int(u), int(v)
    ru = nbrs[_gather_row(capacity, u)]
    rv = nbrs[_gather_row(capacity, v)]
    if u == v or bool((ru == v).any()):
        return True
    common = (ru[:, None] == rv[None, :]) & (ru >= 0)[:, None] & (rv >= 0)[None, :]
    return bool(common.any())


def expand_balls(nbrs: torch.Tensor, starts: torch.Tensor, radius: int, cap: int) -> torch.Tensor:
    """[W] start ids -> [W, F <= cap] ids within ``radius`` hops (-1 padding).

    Each round appends the neighbor rows of every entry of the current ball
    (an entry below 0 expands to D entries of -1; one at or past C reads
    row C - 1, as a JAX gather clamps), then keeps the first ``cap``
    entries.  A truncated ball under-covers: a filter built on it stays
    conservative, never wrong.
    """
    capacity = nbrs.shape[0]
    ball = starts.to(torch.int32)[:, None]
    for _ in range(radius):
        ext = nbrs[ball.long().clamp(0, capacity - 1)]
        ext = torch.where((ball >= 0)[:, :, None], ext, -1).reshape(ball.shape[0], -1)
        ball = torch.cat([ball, ext], dim=1)
        if ball.shape[1] > cap:
            ball = ball[:, :cap]
    return ball


def _exact_ball_size(max_degree: int, radius: int) -> int:
    return sum(max_degree**i for i in range(radius + 1))


def _full_ball(nbrs: torch.Tensor, start: int, radius: int) -> torch.Tensor:
    """Ids within ``radius`` hops of scalar ``start`` (-1 padding), expanded
    under the cap sum_{i <= radius} D^i (the JAX package's "exact" ball)."""
    cap = _exact_ball_size(nbrs.shape[1], radius)
    starts = torch.tensor([int(start)], dtype=torch.int32, device=nbrs.device)
    return expand_balls(nbrs, starts, radius, cap)[0]


def ball_cost(max_degree: int, k: int) -> int:
    """Approximate element ops of the meet-in-the-middle test for ``k``."""
    a = (k + 1) // 2
    n = _exact_ball_size(max_degree, a) + _exact_ball_size(max_degree, k - a)
    return n * max(1, n.bit_length())  # sort + searchsorted


def within_k_balls(nbrs: torch.Tensor, u: int, v: int, k: int) -> bool:
    """True iff the ball of radius ceil(k/2) around u meets the ball of
    radius floor(k/2) around v (a path of length <= k has such a
    midpoint).  The JAX package sorts the smaller ball and probes it with
    ``searchsorted``; a probe hits exactly when it is >= 0 and among the
    smaller ball's ids, which ``isin`` computes."""
    a = (k + 1) // 2
    small = _full_ball(nbrs, v, k - a)
    probe = _full_ball(nbrs, u, a)
    return bool(((probe >= 0) & torch.isin(probe, small)).any())


def bounded_bfs(nbrs: torch.Tensor, src: int, trg: int, k: int) -> bool:
    """True iff trg is reachable from src within k hops
    (AdjacencyListGraph.java:79-117): k dense frontier steps, each
    scattering the rows of every reached vertex."""
    capacity = nbrs.shape[0]
    reached = torch.zeros((capacity,), dtype=torch.bool, device=nbrs.device)
    s = _scatter_row(capacity, int(src))
    if s is not None:
        reached[s] = True
    for _ in range(k):
        flat = torch.where(reached[:, None], nbrs, -1).reshape(-1)
        hit = flat[(flat >= 0) & (flat < capacity)]
        reached[hit.long()] = True
    return bool(reached[_gather_row(capacity, int(trg))])


class AdjacencyListGraph:
    """Host-facing wrapper with the reference's object API (for tests and
    the spanner's records)."""

    def __init__(self, capacity: int = 1 << 10, max_degree: int = 64, device: DeviceLike = None):
        self.capacity = capacity
        self.max_degree = max_degree
        self.nbrs, self.deg = init_table(capacity, max_degree, device)

    @classmethod
    def from_state(cls, nbrs: torch.Tensor, deg: torch.Tensor) -> "AdjacencyListGraph":
        """Wrap existing (nbrs, deg) tensors (e.g. a Spanner summary) as a view."""
        g = cls.__new__(cls)
        g.capacity = int(nbrs.shape[0])
        g.max_degree = int(nbrs.shape[1])
        g.nbrs = nbrs
        g.deg = deg
        return g

    def reset(self) -> None:
        self.nbrs, self.deg = init_table(self.capacity, self.max_degree, self.nbrs.device)

    def add_edge(self, u: int, v: int) -> None:
        self.nbrs, self.deg = add_undirected_edge(self.nbrs, self.deg, u, v)

    def bounded_bfs(self, src: int, trg: int, k: int) -> bool:
        return bounded_bfs(self.nbrs, src, trg, k)

    def adjacency_map(self) -> Dict[int, Set[int]]:
        """Materialize as the reference's Map<K, HashSet<K>> view."""
        nbrs = self.nbrs.cpu().numpy()
        deg = self.deg.cpu().numpy()
        out: Dict[int, Set[int]] = {}
        for v in np.nonzero(deg > 0)[0]:
            out[int(v)] = set(int(x) for x in nbrs[v, : deg[v]])
        return out

    def edges(self) -> Set[Tuple[int, int]]:
        """Canonical (min, max) undirected edge set currently stored."""
        out = set()
        for v, ns in self.adjacency_map().items():
            for n in ns:
                out.add((min(v, n), max(v, n)))
        return out

    def __str__(self) -> str:
        m = self.adjacency_map()
        parts = [f"{v}={sorted(ns)}" for v, ns in sorted(m.items())]
        return "{" + ", ".join(parts) + "}"
