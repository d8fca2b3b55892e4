"""Port parity: windowed k-core of the PyTorch port against the JAX
package on the CPU.

The same edge lists go to ``windowed_kcore`` of both packages; core
numbers are integers and must be equal exactly.  Each round's estimates
are held equal too: the port's ``kcore_round`` (a bucket's h-index into a
buffer, then the scatter-min) against the JAX bucket step on one seeded
pane, round by round, so a ``max_rounds`` bound runs out at the same
round in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.library import kcore as jkcore
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.core.windows import WindowPane
from gelly_streaming_tpu_torch.library import core_numbers_windows as t_windows
from gelly_streaming_tpu_torch.library import kcore as tkcore
from gelly_streaming_tpu_torch.library import windowed_kcore as t_kcore
from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
from gelly_streaming_tpu_torch.ops import spmv as tspmv

CPU = "cpu"
JCFG = JConfig(vertex_capacity=32, max_degree=16, batch_size=8)
TCFG = TConfig(vertex_capacity=32, max_degree=16, batch_size=8)


def _streams(edges, jcfg=JCFG, tcfg=TCFG, **kw):
    return JStream.from_collection(edges, jcfg, **kw), TStream.from_collection(edges, tcfg, device=CPU, **kw)


def _records(out):
    return [(int(v), int(c)) for v, c in out.collect()]


def _both(edges, **kw):
    js, ts = _streams(edges, **kw)
    got = _records(t_kcore(ts, 1000))
    assert got == _records(jkcore.windowed_kcore(js, 1000))
    return dict(got)


def test_clique_and_pendant():
    assert _both([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (3, 4)]) == {0: 3, 1: 3, 2: 3, 3: 3, 4: 1}


def test_cycle_is_two_core():
    assert _both([(0, 1), (1, 2), (2, 3), (3, 0)]) == {0: 2, 1: 2, 2: 2, 3: 2}


def test_tree_is_one_core():
    assert _both([(0, 1), (0, 2), (1, 3), (1, 4)]) == {v: 1 for v in range(5)}


def test_duplicates_and_self_loops_ignored():
    assert _both([(0, 1), (1, 0), (0, 1), (2, 2), (1, 2), (2, 0)]) == {0: 2, 1: 2, 2: 2}


def test_only_self_loops_emit_nothing():
    js, ts = _streams([(3, 3), (4, 4)])
    assert _records(t_kcore(ts, 1000)) == _records(jkcore.windowed_kcore(js, 1000)) == []


@pytest.mark.parametrize("seed", range(6))
def test_random_graphs_match_jax(seed):
    rng = np.random.default_rng(seed)
    n_edges = 60 if seed < 4 else 200
    edges = [(int(rng.integers(0, 24)), int(rng.integers(0, 24))) for _ in range(n_edges)]
    _both(edges)


def test_sliding_windows_match_jax():
    timed = [(0, 1, 0, 100), (1, 2, 0, 200), (2, 0, 0, 300), (3, 4, 0, 1100)]
    js, ts = _streams(timed, batch_size=2, with_time=True)
    want = [(v.tolist(), c.tolist()) for v, c in jkcore.core_numbers_windows(js, 2000, slide_ms=1000)]
    got = [(v.tolist(), c.tolist()) for v, c in t_windows(ts, 2000, slide_ms=1000)]
    assert got == want
    assert [dict(zip(*w)) for w in got] == [{0: 2, 1: 2, 2: 2}, {0: 2, 1: 2, 2: 2, 3: 1, 4: 1}, {3: 1, 4: 1}]


def test_long_path_converges_exactly():
    jcfg = JConfig(vertex_capacity=1024, max_degree=8, batch_size=512)
    tcfg = TConfig(vertex_capacity=1024, max_degree=8, batch_size=512)
    edges = [(i, i + 1) for i in range(599)]
    js, ts = _streams(edges, jcfg, tcfg)
    got = _records(t_kcore(ts, 1000))
    assert got == _records(jkcore.windowed_kcore(js, 1000))
    assert dict(got) == {v: 1 for v in range(600)}


def test_exhausted_max_rounds_raises():
    tcfg = TConfig(vertex_capacity=1024, max_degree=8, batch_size=512)
    ts = TStream.from_collection([(i, i + 1) for i in range(399)], tcfg, device=CPU)
    with pytest.raises(RuntimeError, match="converge"):
        list(t_windows(ts, 1000, max_rounds=3))


def _jax_rounds(src, dst, msk, capacity, rounds):
    buckets = jkcore._build_buckets_j(jnp.asarray(src), jnp.asarray(dst), None, jnp.asarray(msk))
    buckets = [b for b in buckets if int(b.num_keys) > 0]
    c = jkcore.spmv.scatter_into(jkcore.spmv.PLUS_ONE, capacity, src, np.ones((len(src),), np.int32), msk)
    out = [np.asarray(c)]
    for _ in range(rounds):
        for b in buckets:
            c = jkcore._bucket_round(c, b.keys, b.nbrs, b.valid, b.num_keys)
        out.append(np.asarray(c))
    return out


def test_each_round_matches_jax():
    rng = np.random.default_rng(7)
    capacity = 64
    src = rng.integers(0, 48, 300).astype(np.int32)
    dst = np.where(rng.random(300) < 0.3, 0, rng.integers(0, 48, 300)).astype(np.int32)  # a hub at 0
    pane = WindowPane(0, -1, src, dst, None, None)
    s, d, m = tkcore.simple_pane_edges(pane, capacity)
    want = _jax_rounds(s, d, m, capacity, 16)
    # the round whose sweep changes nothing: where the JAX loop stops
    stop = next(r for r in range(1, len(want)) if np.array_equal(want[r], want[r - 1]))
    buckets = [b for b in nbh.build_buckets(*(torch.from_numpy(a) for a in (s, d)), None, torch.from_numpy(m))
               if b.num_keys > 0]
    c = tspmv.scatter_into(tspmv.PLUS_ONE, capacity, s, np.ones((len(s),), np.int32), m, device=CPU)
    np.testing.assert_array_equal(c.numpy(), want[0])
    for r in range(1, len(want)):
        for b in buckets:
            c = tspmv.kcore_round(c, b.keys, b.nbrs, b.valid)
        np.testing.assert_array_equal(c.numpy(), want[r], err_msg=f"round {r}")
    assert len({b.nbrs.shape[1] for b in buckets}) > 2  # several bucket widths
    cores, rounds = tkcore.pane_cores(s, d, m, capacity, CPU)
    assert rounds == stop > 2 and torch.equal(cores, c)
    with pytest.raises(RuntimeError, match="converge"):
        tkcore.pane_cores(s, d, m, capacity, CPU, max_rounds=stop - 1)


def test_kcore_round_plain_h_index():
    """Each row's h-index of its valid entries, scatter-min at the keys."""
    c = torch.tensor([5, 3, 3, 1, 0, 7, 2, 2], dtype=torch.int32)
    keys = torch.tensor([5, 0, 2], dtype=torch.int32)
    nbrs = torch.tensor([[0, 1, 2, 3], [5, 1, 2, 6], [7, 0, 0, 0]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0], [1, 0, 0, 0]], dtype=torch.bool)
    # row 0: [5, 3, 3, 1] -> 3; row 1: [7, 3, 3] -> 3; row 2: [2] -> 1
    got = tspmv.kcore_round(c.clone(), keys, nbrs, valid)
    assert got.tolist() == [3, 3, 1, 1, 0, 3, 2, 2]
    with pytest.raises(ValueError, match="power of two"):
        tspmv.kcore_round(c.clone(), keys, nbrs[:, :3], valid[:, :3])
