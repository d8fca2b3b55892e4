"""Port parity: windowed SSSP of the PyTorch port against the JAX package
on the CPU.

The same edge lists (numpy seeds, those of tests/test_sssp.py and wider
ones) go to ``windowed_sssp`` of both packages; the records (vertex,
distance) must be equal exactly, in every direction mode and at several
thresholds: min-plus relaxation is exact in f32.  The refusals (source
range, a multi-leaf value, a negative weight) are the JAX package's.
"""

import dataclasses

import numpy as np
import pytest

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.examples import sssp as j_example
from gelly_streaming_tpu.library.sssp import sssp_windows as j_windows
from gelly_streaming_tpu.library.sssp import windowed_sssp as j_sssp
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.examples import sssp as t_example
from gelly_streaming_tpu_torch.library import sssp_windows as t_windows
from gelly_streaming_tpu_torch.library import windowed_sssp as t_sssp

CPU = "cpu"
JCFG = JConfig(vertex_capacity=32, max_degree=16, batch_size=8)
TCFG = TConfig(vertex_capacity=32, max_degree=16, batch_size=8)


def _streams(edges, jcfg=JCFG, tcfg=TCFG, **kw):
    return JStream.from_collection(edges, jcfg, **kw), TStream.from_collection(edges, tcfg, device=CPU, **kw)


def _records(out):
    return [(int(v), float(d)) for v, d in out.collect()]


def test_weighted_matches_jax():
    edges = [(0, 1, 4.0), (0, 2, 1.0), (2, 1, 2.0), (1, 3, 1.0), (2, 3, 5.0)]
    js, ts = _streams(edges)
    got = _records(t_sssp(ts, 0, 1000))
    assert got == _records(j_sssp(js, 0, 1000))
    assert dict(got)[1] == 3.0 and dict(got)[3] == 4.0


def test_valueless_stream_counts_hops():
    edges = [(0, 1), (1, 2), (2, 3), (0, 3)]
    js, ts = _streams(edges)
    got = _records(t_sssp(ts, 0, 1000))
    assert got == _records(j_sssp(js, 0, 1000))
    assert dict(got) == {0: 0.0, 1: 1.0, 2: 2.0, 3: 1.0}


def test_unreached_vertices_emit_nothing():
    js, ts = _streams([(0, 1, 1.0), (5, 6, 1.0)])
    got = _records(t_sssp(ts, 0, 1000))
    assert got == _records(j_sssp(js, 0, 1000)) == [(0, 0.0), (1, 1.0)]


def test_sliding_windows_match_jax():
    timed = [(0, 1, 1.0, 100), (1, 2, 1.0, 1100), (2, 3, 1.0, 2100)]
    js, ts = _streams(timed, batch_size=1, with_time=True)
    want = [(v.tolist(), d.tolist()) for v, d in j_windows(js, 0, 2000, slide_ms=1000)]
    got = [(v.tolist(), d.tolist()) for v, d in t_windows(ts, 0, 2000, slide_ms=1000)]
    assert got == want
    assert [dict(zip(*w)) for w in got] == [{0: 0.0, 1: 1.0}, {0: 0.0, 1: 1.0, 2: 2.0}, {0: 0.0}, {0: 0.0}]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_graph_matches_jax_in_every_mode(seed):
    rng = np.random.default_rng(seed)
    edges = [
        (int(rng.integers(0, 20)), int(rng.integers(0, 20)), float(rng.integers(1, 10)))
        for _ in range(50 + 30 * seed)
    ]
    js, _ = _streams(edges)
    want = _records(j_sssp(js, 0, 1000))
    for mode, thr in (("auto", -1.0), ("push", -1.0), ("pull", -1.0), ("auto", 0.0), ("auto", 0.5), ("auto", 1.0)):
        _, ts = _streams(edges, tcfg=dataclasses.replace(TCFG, spmv_direction=mode, direction_threshold=thr))
        assert _records(t_sssp(ts, 0, 1000)) == want, (mode, thr)


def test_fractional_weights_and_timed_windows_match_jax():
    rng = np.random.default_rng(5)
    n = 120
    t = np.sort(rng.integers(0, 3000, n))
    edges = [(int(rng.integers(0, 30)), int(rng.integers(0, 30)), float(np.float32(rng.random())), int(t[i]))
             for i in range(n)]
    js, ts = _streams(edges, batch_size=16, with_time=True)
    for source in (0, 7):
        assert _records(t_sssp(ts, source, 1000)) == _records(j_sssp(js, source, 1000))
        assert _records(t_sssp(ts, source, 1000, slide_ms=500)) == _records(j_sssp(js, source, 1000, slide_ms=500))


def test_out_of_range_source_rejected():
    _, ts = _streams([(0, 1)])
    with pytest.raises(ValueError, match="outside"):
        list(t_windows(ts, 40, 1000))
    with pytest.raises(ValueError, match="outside"):
        list(t_windows(ts, -1, 1000))


def test_multi_leaf_values_rejected():
    _, ts = _streams([(0, 1, 2.0)])
    ts = ts.map_edges(lambda s, d, v: {"a": v, "b": v})
    with pytest.raises(ValueError, match="single scalar"):
        list(t_windows(ts, 0, 1000))


def test_negative_weights_rejected():
    _, ts = _streams([(0, 1, -1.0)])
    with pytest.raises(ValueError, match="non-negative"):
        list(t_windows(ts, 0, 1000))


@pytest.mark.parametrize("max_iters", [0, 1, 2, 3])
def test_bounded_hop_semantics_match_jax(max_iters):
    edges = [(0, 1, 1.0), (1, 2, 1.0), (2, 3, 1.0), (0, 3, 5.0)]
    js, ts = _streams(edges)
    got = _records(t_sssp(ts, 0, 1000, max_iters=max_iters))
    assert got == _records(j_sssp(js, 0, 1000, max_iters=max_iters))
    if max_iters == 2:
        assert dict(got) == {0: 0.0, 1: 1.0, 2: 2.0, 3: 5.0}


def test_example_csv_matches_jax(tmp_path):
    path = tmp_path / "edges.txt"
    path.write_text("1 2 4.0\n1 3 1.0\n3 2 2.0\n2 4 1.0\n3 4 5.0\n4 5 0.5\n")
    j_example.main(["--source=1", str(path), str(tmp_path / "j.csv")])
    t_example.main(["--device=cpu", "--source=1", str(path), str(tmp_path / "t.csv")])
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert (tmp_path / "t.csv").read_text()
