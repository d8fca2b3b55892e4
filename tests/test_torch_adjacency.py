"""Port parity: the adjacency summary (``summaries/adjacency.py``) of the
PyTorch port against the JAX package on the CPU.

The AdjacencyListGraph sequences of ``tests/test_adjacency.py`` (the
reference's AdjacencyListGraphTest) run on both packages; the three exact
distance tests the spanner's admission picks from (``within_two``,
``within_k_balls``, ``bounded_bfs``), ``expand_balls``, ``contains_edge``
and ``add_undirected_edge`` are held against the JAX functions on seeded
random tables, rows that overflow and ids -1 and C among them.
Tolerance: none, every answer and table bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.summaries import adjacency as jadj
from gelly_streaming_tpu_torch.summaries import adjacency as tadj

CPU = "cpu"


def _graphs(capacity=32, max_degree=8):
    return jadj.AdjacencyListGraph(capacity, max_degree), tadj.AdjacencyListGraph(capacity, max_degree, device=CPU)


def _same(jg, tg):
    assert np.array_equal(np.asarray(jg.nbrs), tg.nbrs.numpy())
    assert np.array_equal(np.asarray(jg.deg), tg.deg.numpy())
    assert jg.adjacency_map() == tg.adjacency_map()
    assert jg.edges() == tg.edges()
    assert str(jg) == str(tg)


def test_add_edge_sequence():
    jg, tg = _graphs()
    for u, v in [(1, 2), (1, 3), (3, 1), (1, 2)]:
        jg.add_edge(u, v)
        tg.add_edge(u, v)
        _same(jg, tg)
    m = tg.adjacency_map()
    assert len(m) == 3 and len(m[1]) == 2 and len(m[2]) == 1 and len(m[3]) == 1


def test_bounded_bfs_sequence():
    jg, tg = _graphs()
    for u, v in [(1, 4), (4, 5), (5, 6), (4, 7), (7, 8)]:
        jg.add_edge(u, v)
        tg.add_edge(u, v)
    for src, trg, want, add in [(2, 3, False, True), (3, 4, False, True), (3, 6, True, False),
                                (8, 9, False, True), (8, 6, False, True), (5, 9, True, False)]:
        assert tg.bounded_bfs(src, trg, 3) is want
        assert jg.bounded_bfs(src, trg, 3) is want
        if add:
            jg.add_edge(src, trg)
            tg.add_edge(src, trg)
    _same(jg, tg)


def test_overflow_and_odd_ids_insert_like_jax():
    """Rows that fill (D = 2), self-loops, ids -1, C and C + 3: the port's
    insert follows JAX's index rules (gathers clamp, scatters drop)."""
    rng = np.random.default_rng(3)
    jg, tg = _graphs(capacity=12, max_degree=2)
    for _ in range(80):
        u, v = (int(x) for x in rng.integers(-2, 15, 2))
        jg.add_edge(u, v)
        tg.add_edge(u, v)
        assert np.array_equal(np.asarray(jg.nbrs), tg.nbrs.numpy()), (u, v)
        assert np.array_equal(np.asarray(jg.deg), tg.deg.numpy()), (u, v)


def _random_table(seed, capacity, max_degree, edges, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    hi = capacity if hi is None else hi
    nbrs, deg = jadj.init_table(capacity, max_degree)
    add = jax.jit(jadj.add_undirected_edge)
    for _ in range(edges):
        u, v = rng.integers(lo, hi, 2)
        nbrs, deg = add(nbrs, deg, jnp.int32(u), jnp.int32(v))
    return nbrs, deg, torch.from_numpy(np.asarray(nbrs).copy()), torch.from_numpy(np.asarray(deg).copy())


@pytest.mark.parametrize("seed,capacity,max_degree,edges", [(0, 64, 8, 60), (1, 40, 4, 200), (2, 16, 3, 40)])
def test_distance_tests_match_jax(seed, capacity, max_degree, edges):
    jn, _jd, tn, _td = _random_table(seed, capacity, max_degree, edges)
    w2 = jax.jit(jadj.within_two)
    balls = jax.jit(jadj.within_k_balls, static_argnames="k")
    bfs = jax.jit(jadj.bounded_bfs, static_argnames="k")
    rng = np.random.default_rng(seed + 100)
    for _ in range(60):
        a, b = (int(x) for x in rng.integers(0, capacity + 2, 2))  # ids at and past C too
        ja, jb = jnp.int32(a), jnp.int32(b)
        assert tadj.within_two(tn, a, b) == bool(w2(jn, ja, jb)), (a, b)
        for k in (1, 2, 3, 4):
            assert tadj.within_k_balls(tn, a, b, k) == bool(balls(jn, ja, jb, k=k)), (a, b, k)
            assert tadj.bounded_bfs(tn, a, b, k) == bool(bfs(jn, ja, jb, k=k)), (a, b, k)


@pytest.mark.parametrize("radius,cap", [(0, 4), (1, 4), (1, 128), (2, 7), (2, 128), (3, 40)])
def test_expand_balls_match_jax(radius, cap):
    jn, _jd, tn, _td = _random_table(5, 24, 4, 70, lo=-1, hi=25)
    starts = np.array([-1, 0, 3, 23, 24, 26], np.int32)
    want = np.asarray(jadj.expand_balls(jn, jnp.asarray(starts), radius, cap))
    got = tadj.expand_balls(tn, torch.from_numpy(starts), radius, cap).numpy()
    assert np.array_equal(got, want)


def test_contains_edge_and_functional_insert_match_jax():
    jn, jd, tn, td = _random_table(7, 20, 4, 30)
    u = np.array([0, 1, 5, 19, -1, 21], np.int32)
    v = np.array([1, 0, 7, 3, 2, 4], np.int32)
    want = np.asarray(jadj.contains_edge(jn, jnp.asarray(u), jnp.asarray(v)))
    assert np.array_equal(tadj.contains_edge(tn, torch.from_numpy(u), torch.from_numpy(v)).numpy(), want)
    for a, b in [(2, 9), (9, 2), (4, 4), (-1, 3), (20, 5)]:
        jn2, jd2 = jadj.add_undirected_edge(jn, jd, jnp.int32(a), jnp.int32(b))
        tn2, td2 = tadj.add_undirected_edge(tn, td, a, b)
        assert np.array_equal(np.asarray(jn2), tn2.numpy()) and np.array_equal(np.asarray(jd2), td2.numpy())
    assert tadj.ball_cost(64, 3) == jadj.ball_cost(64, 3)
    assert tadj._exact_ball_size(8, 2) == jadj._exact_ball_size(8, 2)


def test_from_state_is_a_view():
    tn, td = tadj.init_table(8, 2, CPU)
    g = tadj.AdjacencyListGraph.from_state(tn, td)
    assert g.capacity == 8 and g.max_degree == 2 and g.nbrs is tn
    g.reset()
    assert g.edges() == set() and str(g) == "{}"
