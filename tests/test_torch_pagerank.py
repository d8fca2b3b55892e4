"""Port parity: windowed PageRank and ``pagerank_fixpoint`` of the PyTorch
port against the JAX package on the CPU.

Inputs come from numpy seeds (those of tests/test_pagerank.py, and
tests/test_spmv.py's seed-14 skewed pane) and go to both.  ``in_window``
and the iteration count must be equal; ranks within rtol 1e-5 / atol 1e-9,
because the dangling-mass and delta sums reduce in another order than
XLA's (the JAX package's own jitted oracle differs from its
``pagerank_fixpoint`` by ~1-2 f32 ulps on the seed-14 pane).  The port's
push and pull give the same bits, and emit the same records.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.examples import pagerank as j_example
from gelly_streaming_tpu.library.pagerank import pagerank_windows as j_windows
from gelly_streaming_tpu.library.pagerank import windowed_pagerank as j_pagerank
from gelly_streaming_tpu.ops import spmv as jspmv
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.examples import pagerank as t_example
from gelly_streaming_tpu_torch.library import pagerank_windows as t_windows
from gelly_streaming_tpu_torch.library import windowed_pagerank as t_pagerank
from gelly_streaming_tpu_torch.ops import spmv as tspmv

CPU = "cpu"
C = 64
RTOL, ATOL = 1e-5, 1e-9
JCFG = JConfig(vertex_capacity=32, max_degree=16, batch_size=8)
TCFG = TConfig(vertex_capacity=32, max_degree=16, batch_size=8)


def _streams(edges, jcfg=JCFG, tcfg=TCFG, **kw):
    return JStream.from_collection(edges, jcfg, **kw), TStream.from_collection(edges, tcfg, device=CPU, **kw)


def _records(out):
    return [(int(v), float(r)) for v, r in out.collect()]


def _assert_records_close(got, want):
    assert [v for v, _ in got] == [v for v, _ in want]
    np.testing.assert_allclose([r for _, r in got], [r for _, r in want], rtol=RTOL, atol=ATOL)


def _skewed_pane(seed):
    """tests/test_spmv.py's _rand_pane(rng, 256, skew=True) draws."""
    rng = np.random.default_rng(seed)
    src = ((rng.zipf(1.3, 256) - 1) % C).astype(np.int32)
    dst = rng.integers(0, C, 256).astype(np.int32)
    src[0], dst[0] = C - 1, C - 1
    rng.integers(1, 8, 256)  # the weights, unused here
    return src, dst, rng.random(256) < 0.8


@pytest.mark.parametrize("seed", [14, 0, 1])
def test_pagerank_fixpoint_matches_jax(seed):
    src, dst, msk = _skewed_pane(seed)
    jop = jspmv.prepare_pane(src, dst, None, msk, C)
    top = tspmv.prepare_pane(src, dst, None, msk, C, device=CPU)
    want_r, want_in, want_it = jspmv.pagerank_fixpoint(jop, damping=0.85, tol=1e-6, max_iters=100)
    runs = [tspmv.pagerank_fixpoint(top, damping=0.85, tol=1e-6, max_iters=100, use_pull=p) for p in (False, True)]
    for r, in_w, iters in runs:
        np.testing.assert_array_equal(in_w.numpy(), np.asarray(want_in))
        assert iters == int(want_it)
        np.testing.assert_allclose(r.numpy(), np.asarray(want_r), rtol=RTOL, atol=ATOL)
        assert r.dtype == torch.float32
    # push and pull: the same bits
    assert torch.equal(runs[0][0], runs[1][0])


def test_pagerank_fixpoint_bounded_iterations():
    src, dst, msk = _skewed_pane(3)
    jop = jspmv.prepare_pane(src, dst, None, msk, C)
    top = tspmv.prepare_pane(src, dst, None, msk, C, device=CPU)
    for max_iters in (0, 1, 5):
        want_r, _, want_it = jspmv.pagerank_fixpoint(jop, damping=0.5, tol=1e-6, max_iters=max_iters)
        r, _, iters = tspmv.pagerank_fixpoint(top, damping=0.5, tol=1e-6, max_iters=max_iters)
        assert iters == int(want_it) == max_iters
        np.testing.assert_allclose(r.numpy(), np.asarray(want_r), rtol=RTOL, atol=ATOL)


def test_single_window_matches_jax():
    edges = [(1, 2), (2, 3), (3, 1), (3, 4), (4, 1), (5, 1)]
    js, ts = _streams(edges)
    got = _records(t_pagerank(ts, 1000, tol=1e-10))
    _assert_records_close(got, _records(j_pagerank(js, 1000, tol=1e-10)))
    assert abs(sum(r for _, r in got) - 1.0) < 1e-5


def test_dangling_vertices_keep_total_mass():
    js, ts = _streams([(1, 2), (2, 3)])
    got = _records(t_pagerank(ts, 1000, tol=1e-10))
    _assert_records_close(got, _records(j_pagerank(js, 1000, tol=1e-10)))
    assert abs(sum(r for _, r in got) - 1.0) < 1e-5


def test_rank_ordering_follows_structure():
    js, ts = _streams([(2, 1), (3, 1), (4, 1), (1, 2)])
    got = dict(_records(t_pagerank(ts, 1000)))
    assert got[1] == max(got.values())
    _assert_records_close(sorted(got.items()), sorted(_records(j_pagerank(js, 1000))))


def test_sliding_windows_match_jax():
    timed = [(1, 2, 0.0, 100), (2, 1, 0.0, 200), (3, 4, 0.0, 1100), (4, 3, 0.0, 1200)]
    js, ts = _streams(timed, batch_size=2, with_time=True)
    want = list(j_windows(js, 2000, slide_ms=1000, tol=1e-10))
    got = list(t_windows(ts, 2000, slide_ms=1000, tol=1e-10))
    assert [v.tolist() for v, _ in got] == [v.tolist() for v, _ in want] == [[1, 2], [1, 2, 3, 4], [3, 4]]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL)
        assert abs(g.sum() - 1.0) < 1e-5


def test_windows_are_independent():
    timed = [(1, 2, 0.0, 100), (2, 1, 0.0, 200), (1, 2, 0.0, 1100), (2, 1, 0.0, 1200)]
    _, ts = _streams(timed, batch_size=2, with_time=True)
    wins = list(t_windows(ts, 1000, tol=1e-10))
    assert len(wins) == 2
    np.testing.assert_array_equal(wins[0][1], wins[1][1])


@pytest.mark.parametrize("seed", [0, 1])
def test_random_graph_matches_jax(seed):
    rng = np.random.default_rng(seed)
    edges = list({(int(rng.integers(0, 20)), int(rng.integers(0, 20))) for _ in range(40)})
    edges = [e for e in edges if e[0] != e[1]]
    js, ts = _streams(edges)
    got = _records(t_pagerank(ts, 1000, tol=1e-12, max_iters=300))
    _assert_records_close(got, _records(j_pagerank(js, 1000, tol=1e-12, max_iters=300)))


def test_emissions_identical_across_modes():
    edges = [(0, 1), (1, 2), (2, 0), (2, 3), (3, 0), (1, 3)]
    js, ts = _streams(edges)
    want = _records(j_pagerank(js, 1000))
    base = _records(t_pagerank(ts, 1000))
    _assert_records_close(base, want)
    for mode in ("push", "pull", "auto"):
        _, ts = _streams(edges, tcfg=dataclasses.replace(TCFG, spmv_direction=mode))
        assert _records(t_pagerank(ts, 1000)) == base, mode


def test_example_csv_matches_jax(tmp_path):
    path = tmp_path / "edges.txt"
    path.write_text("1 2 100\n2 3 200\n3 1 300\n3 4 1200\n4 1 1300\n")
    j_example.main([str(path), str(tmp_path / "j.csv"), "1000"])
    t_example.main(["--device=cpu", str(path), str(tmp_path / "t.csv"), "1000"])
    want = [line.split(",") for line in (tmp_path / "j.csv").read_text().splitlines()]
    got = [line.split(",") for line in (tmp_path / "t.csv").read_text().splitlines()]
    assert [g[0] for g in got] == [w[0] for w in want]
    np.testing.assert_allclose([float(g[1]) for g in got], [float(w[1]) for w in want], rtol=RTOL, atol=ATOL)
