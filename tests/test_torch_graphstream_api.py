"""Port parity: the rest of the GraphStream surface of the PyTorch port
(get_edges, build_neighborhood, keyed_aggregate, global_aggregate;
GraphStream.java:43-140 / SimpleEdgeStream.java:489-560) against the JAX
package on the CPU.

Each case of tests/test_graphstream_api.py runs through both packages,
the callables written in jnp for JAX and in torch for the port, on the
same edges; records, block columns and their dtypes must be equal
exactly.  Streams made from numpy seeds add masks, duplicates, self-loops
and rows past ``max_degree``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.ops import segments as jseg
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.ops import segments as tseg

from fixtures import LONG_LONG_EDGES

CPU = "cpu"


def _streams(edges, batch_size=None, vertex_capacity=16, max_degree=16):
    j = JStream.from_collection(edges, JConfig(vertex_capacity=vertex_capacity, max_degree=max_degree),
                                batch_size=batch_size)
    t = TStream.from_collection(edges, TConfig(vertex_capacity=vertex_capacity, max_degree=max_degree),
                                batch_size=batch_size, device=CPU)
    return j, t


def _long_long(batch_size=None):
    return (JStream.from_collection(LONG_LONG_EDGES, JConfig(vertex_capacity=16, max_degree=16, batch_size=4),
                                    batch_size=batch_size),
            TStream.from_collection(LONG_LONG_EDGES, TConfig(vertex_capacity=16, max_degree=16, batch_size=4),
                                    batch_size=batch_size, device=CPU))


def _same_blocks(j_out, t_out):
    jb, tb = list(j_out.blocks()), list(t_out.blocks())
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert len(a.columns) == len(b.columns)
        for x, y in zip(a.columns, b.columns):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            if x.dtype == object:
                assert list(x) == list(y)
            else:
                np.testing.assert_array_equal(x, y)


def test_get_edges():
    j, t = _long_long()
    assert t.get_edges().collect() == j.get_edges().collect()


@pytest.mark.parametrize("directed", [False, True])
def test_build_neighborhood_trace(directed):
    # batch_size=1: the reference's exact per-edge TreeSet trace
    j, t = _streams([(1, 2), (1, 3), (2, 3)], batch_size=1)
    want = j.build_neighborhood(directed=directed, mode="trace").collect()
    assert t.build_neighborhood(directed=directed, mode="trace").collect() == want
    if not directed:
        assert want[0] == (1, 2, (2,)) and want[-1] == (3, 2, (1, 2))


def test_build_neighborhood_block_columns():
    j, t = _streams([(1, 2), (1, 3), (2, 3), (3, 4)], batch_size=2)
    _same_blocks(j.build_neighborhood(directed=False), t.build_neighborhood(directed=False))
    assert (t.build_neighborhood(directed=False, mode="trace").collect()
            == j.build_neighborhood(directed=False, mode="trace").collect())


@pytest.mark.parametrize("batch_size,directed", [(1, False), (3, False), (4, True)])
def test_build_neighborhood_overflowing_row(batch_size, directed):
    """Vertex 0 gains 5 neighbors, duplicates among them, at max_degree 2:
    its row stops at 2 and the later duplicates of dropped edges are new
    again (the JAX overflow semantics)."""
    edges = [(0, 1), (0, 2), (0, 1), (0, 3), (0, 4), (0, 3), (0, 5), (2, 0), (1, 1)]
    j, t = _streams(edges, batch_size=batch_size, max_degree=2)
    _same_blocks(j.build_neighborhood(directed=directed), t.build_neighborhood(directed=directed))
    assert (t.build_neighborhood(directed=directed, mode="trace").collect()
            == j.build_neighborhood(directed=directed, mode="trace").collect())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_neighborhood_seeded(seed):
    rng = np.random.default_rng(seed)
    n = 60
    edges = list(zip(rng.integers(0, 12, n).tolist(), rng.integers(0, 12, n).tolist()))
    j, t = _streams(edges, batch_size=7, max_degree=6)
    for directed in (False, True):
        _same_blocks(j.build_neighborhood(directed=directed), t.build_neighborhood(directed=directed))


# ---------------------------------------------------------------------------
# keyed_aggregate


def _expand_j(src, dst, val):
    keys = jnp.stack([src, dst])  # [2, B]
    return keys, jnp.ones_like(keys)


def _expand_t(src, dst, val):
    keys = torch.stack([src, dst])
    return keys, torch.ones_like(keys)


def _degree_update_j(counts, keys, vals, mask):
    rank = jseg.occurrence_rank(keys, mask)
    emitted = counts[keys] + rank + 1
    counts = counts.at[jnp.where(mask, keys, 0)].add(mask.astype(jnp.int32))
    return counts, emitted, mask


def _degree_update_t(counts, keys, vals, mask):
    rank = tseg.occurrence_rank(keys, mask)
    emitted = counts[keys.long()] + rank + 1
    counts = counts.index_add(0, torch.where(mask, keys, 0).long(), mask.to(torch.int32))
    return counts, emitted, mask


def test_keyed_aggregate_degree_equivalent():
    # the degree stream through the generic keyed aggregation (the
    # reference's getDegrees, SimpleEdgeStream.java:413-415 via aggregate())
    j, t = _long_long()
    j_out = j.keyed_aggregate(_expand_j, lambda cfg: jnp.zeros((cfg.vertex_capacity,), jnp.int32), _degree_update_j)
    t_out = t.keyed_aggregate(_expand_t, lambda cfg: torch.zeros((cfg.vertex_capacity,), dtype=torch.int32),
                              _degree_update_t)
    assert sorted(t_out.lines()) == sorted(
        "1,1\n1,2\n1,3\n2,1\n2,2\n3,1\n3,2\n3,3\n3,4\n4,1\n4,2\n5,1\n5,2\n5,3".split("\n"))
    _same_blocks(j_out, t_out)


def _pair_update_j(counts, keys, vals, mask):
    counts, emitted, mask = _degree_update_j(counts, keys, vals, mask)
    return counts, (emitted, keys * 2), mask & (keys % 2 == 1)


def _pair_update_t(counts, keys, vals, mask):
    counts, emitted, mask = _degree_update_t(counts, keys, vals, mask)
    return counts, (emitted, keys * 2), mask & (keys % 2 == 1)


def _nested_update_j(counts, keys, vals, mask):
    counts, emitted, mask = _degree_update_j(counts, keys, vals, mask)
    return counts, {"deg": emitted, "key": (keys, keys + 100)}, mask


def _nested_update_t(counts, keys, vals, mask):
    counts, emitted, mask = _degree_update_t(counts, keys, vals, mask)
    return counts, {"key": (keys, keys + 100), "deg": emitted}, mask


@pytest.mark.parametrize("which", ["pair", "nested"])
@pytest.mark.parametrize("batch_size", [3, 5])
def test_keyed_aggregate_outputs(which, batch_size):
    """A flat tuple output is columns; a nested one (a dict holding a
    tuple) is one object column, its dicts in sorted key order."""
    rng = np.random.default_rng(batch_size)
    edges = list(zip(rng.integers(0, 10, 23).tolist(), rng.integers(0, 10, 23).tolist()))
    j, t = _streams(edges, batch_size=batch_size)
    j_up, t_up = {"pair": (_pair_update_j, _pair_update_t), "nested": (_nested_update_j, _nested_update_t)}[which]
    j_out = j.keyed_aggregate(_expand_j, lambda cfg: jnp.zeros((cfg.vertex_capacity,), jnp.int32), j_up)
    t_out = t.keyed_aggregate(_expand_t, lambda cfg: torch.zeros((cfg.vertex_capacity,), dtype=torch.int32), t_up)
    _same_blocks(j_out, t_out)
    assert t_out.lines() == j_out.lines()


# ---------------------------------------------------------------------------
# global_aggregate


def test_global_aggregate_edge_count():
    # numberOfEdges through the centralized aggregation (SimpleEdgeStream.java:388-404)
    j, t = _long_long(batch_size=2)
    want = j.global_aggregate(lambda total, b: total + b.num_valid(), lambda cfg: jnp.zeros((), jnp.int32),
                              lambda s: int(s)).collect()
    got = t.global_aggregate(lambda total, b: total + b.num_valid(), lambda cfg: torch.zeros((), dtype=torch.int32),
                             lambda s: int(s)).collect()
    assert got == want == [(2,), (4,), (6,), (7,)]


@pytest.mark.parametrize("emit_on_change", [True, False])
def test_global_aggregate_change_dedup(emit_on_change):
    # a constant result emits once; every batch without the dedup
    j, t = _long_long(batch_size=2)
    want = j.global_aggregate(lambda s, b: s, lambda cfg: jnp.zeros((), jnp.int32), lambda s: int(s),
                              emit_on_change=emit_on_change).collect()
    got = t.global_aggregate(lambda s, b: s, lambda cfg: torch.zeros((), dtype=torch.int32), lambda s: int(s),
                             emit_on_change=emit_on_change).collect()
    assert got == want == ([(0,)] if emit_on_change else [(0,)] * 4)


def test_global_aggregate_tuple_result():
    """A (max id, edges) result over a seeded stream, emitted on change."""
    rng = np.random.default_rng(7)
    edges = list(zip(rng.integers(0, 16, 30).tolist(), rng.integers(0, 16, 30).tolist()))
    j, t = _streams(edges, batch_size=4)
    want = j.global_aggregate(
        lambda s, b: (jnp.maximum(s[0], jnp.max(jnp.where(b.mask, b.src, 0))), s[1] + b.num_valid()),
        lambda cfg: (jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)),
        lambda s: (int(s[0]), int(s[1]) // 8)).collect()
    got = t.global_aggregate(
        lambda s, b: (torch.maximum(s[0], torch.where(b.mask, b.src, 0).max()), s[1] + b.num_valid()),
        lambda cfg: (torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32)),
        lambda s: (int(s[0]), int(s[1]) // 8)).collect()
    assert got == want
