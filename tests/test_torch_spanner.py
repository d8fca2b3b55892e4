"""Port parity: the k-spanner of the PyTorch port against the JAX package
on the CPU.

The same seeded timed edge lists go through ``aggregate(Spanner(...))`` of
both packages: three tumbling windows, so every window after the first
folds its pane into a fresh table and ``combine`` re-inserts the smaller
spanner into the larger.  After each window ``nbrs`` and ``deg`` must be
equal bit for bit, for k in {1, 2, 3, 4}, each body (auto, balls, bfs),
``filter_cap`` in {4, 128}, rows that overflow (D = 3) and ids -1 and C
in the stream.  Also: the array-backed wire path, ``combine`` alone (a
tie keeps its first argument as the larger), the twin of the batch
admission against the JAX ``_admit_batch``, and the example CLI.
Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.examples import spanner as jex
from gelly_streaming_tpu.library import spanner as jsp
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.examples import spanner as tex
from gelly_streaming_tpu_torch.library import spanner as tsp
from gelly_streaming_tpu_torch.ops import spanner as sp_ops

CPU = "cpu"
C, D = 24, 3


def _timed_edges(seed, n=150, lo=-1, hi=C + 1, span_ms=3000):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, span_ms, n))
    return [(int(a), int(b), 0, int(x)) for a, b, x in zip(rng.integers(lo, hi, n), rng.integers(lo, hi, n), t)]


def _tables(records):
    return [(g.nbrs.numpy() if isinstance(g.nbrs, torch.Tensor) else np.asarray(g.nbrs),
             g.deg.numpy() if isinstance(g.deg, torch.Tensor) else np.asarray(g.deg)) for (g,) in records]


def _both_windowed(edges, k, cap, body, max_degree=D, batch=16):
    agg = dict(k=k, filter_cap=cap, body=body)
    js = JStream.from_collection(edges, JConfig(vertex_capacity=C, max_degree=max_degree), batch_size=batch,
                                 with_time=True)
    ts = TStream.from_collection(edges, TConfig(vertex_capacity=C, max_degree=max_degree), batch_size=batch,
                                 with_time=True, device=CPU)
    want = _tables(js.aggregate(jsp.Spanner(1000, **agg)).collect())
    got = _tables(ts.aggregate(tsp.Spanner(1000, **agg)).collect())
    assert len(got) == len(want) == 3
    for w, ((gn, gd), (wn, wd)) in enumerate(zip(got, want)):
        assert np.array_equal(gn, wn), w
        assert np.array_equal(gd, wd), w
    return got


@pytest.mark.parametrize("cap", [4, 128])
@pytest.mark.parametrize("body", ["auto", "balls", "bfs"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_windowed_spanner_matches_jax(k, body, cap):
    _both_windowed(_timed_edges(k * 10 + len(body) + cap), k, cap, body)


def test_wide_rows_in_range_ids_match_jax():
    """D = 8 and ids in [0, C): rows rarely fill, so the bodies agree."""
    edges = _timed_edges(77, n=200, lo=0, hi=C)
    tables = [_both_windowed(edges, 3, 128, body, max_degree=8) for body in ("auto", "balls", "bfs")]
    for other in tables[1:]:
        assert all(np.array_equal(a[0], b[0]) for a, b in zip(tables[0], other))


def test_admission_sequence_matches_reference():
    """The AdjacencyListGraphTest.testBoundedBFS sequence as a stream: with
    k = 3, edges (3, 6) and (5, 9) are dropped."""
    edges = [(1, 4), (4, 5), (5, 6), (4, 7), (7, 8), (2, 3), (3, 4), (3, 6), (8, 9), (8, 6), (5, 9)]
    cfg = TConfig(vertex_capacity=32, max_degree=8)
    g = TStream.from_collection(edges, cfg, device=CPU).aggregate(tsp.Spanner(1000, 3)).collect()[-1][0]
    assert g.edges() == {(1, 4), (4, 5), (5, 6), (4, 7), (7, 8), (2, 3), (3, 4), (8, 9), (6, 8)}


@pytest.mark.parametrize("k", [2, 3])
def test_wire_path_matches_jax(k):
    rng = np.random.default_rng(k)
    src = rng.integers(0, 64, 600).astype(np.int32)
    dst = rng.integers(0, 64, 600).astype(np.int32)
    want = JStream.from_arrays(src, dst, JConfig(vertex_capacity=64, max_degree=6, batch_size=128)).aggregate(
        jsp.Spanner(1000, k)).collect()
    got = TStream.from_arrays(src, dst, TConfig(vertex_capacity=64, max_degree=6, batch_size=128),
                              device=CPU).aggregate(tsp.Spanner(1000, k)).collect()
    assert len(got) == len(want) == 1
    assert np.array_equal(got[0][0].nbrs.numpy(), np.asarray(want[0][0].nbrs))
    assert np.array_equal(got[0][0].deg.numpy(), np.asarray(want[0][0].deg))


@pytest.mark.parametrize("sizes", ["a_larger", "b_larger", "tie"])
def test_combine_matches_jax(sizes):
    """The smaller spanner (by vertices with an edge) goes into the larger;
    on a tie the first argument is the larger."""
    rng = np.random.default_rng(len(sizes))
    if sizes == "tie":  # paths over 0..9 and 10..19 plus chords: ten vertices each
        pairs = [(np.r_[np.arange(9), 0, 2], np.r_[np.arange(1, 10), 5, 8]),
                 (np.r_[np.arange(10, 19), 11], np.r_[np.arange(11, 20), 17])]
    else:
        n_a, n_b = (40, 12) if sizes == "a_larger" else (12, 40)
        pairs = [(rng.integers(0, C, n), rng.integers(0, C, n)) for n in (n_a, n_b)]
    states = []
    for s, d in pairs:
        nbrs, deg = jnp.full((C, 4), -1, jnp.int32), jnp.zeros((C,), jnp.int32)
        n = len(s)
        states.append(jsp._admit_batch(nbrs, deg, jnp.asarray(s.astype(np.int32)), jnp.asarray(d.astype(np.int32)),
                                       jnp.ones((n,), bool), 2, 128))
    if sizes == "tie":
        assert int((states[0][1] > 0).sum()) == int((states[1][1] > 0).sum()) == 10
    jagg, tagg = jsp.Spanner(1000, 2), tsp.Spanner(1000, 2)
    want = jagg.combine(jsp.SpannerState(*states[0]), jsp.SpannerState(*states[1]))
    got = tagg.combine(*(interop.spanner_state_from_numpy(np.asarray(n), np.asarray(d), device=CPU)
                         for n, d in states))
    assert np.array_equal(got.nbrs.numpy(), np.asarray(want.nbrs))
    assert np.array_equal(got.deg.numpy(), np.asarray(want.deg))


@pytest.mark.parametrize("k,cap,body", [(2, 128, "within_two"), (3, 4, "balls"), (3, 128, "bfs"), (4, 7, "balls")])
def test_admit_twin_matches_jax_admit_batch(k, cap, body):
    """The twin of the kernel, batch by batch on a carried state, masked
    rows and ids -1 and C included."""
    rng = np.random.default_rng(k + cap)
    jn, jd = jnp.full((C, 4), -1, jnp.int32), jnp.zeros((C,), jnp.int32)
    tn, td = torch.full((C, 4), -1, dtype=torch.int32), torch.zeros((C,), dtype=torch.int32)
    for _ in range(3):
        s = rng.integers(-1, C + 1, 48).astype(np.int32)
        d = rng.integers(-1, C + 1, 48).astype(np.int32)
        m = rng.random(48) < 0.8
        jn, jd = jsp._admit_batch(jn, jd, jnp.asarray(s), jnp.asarray(d), jnp.asarray(m), k, cap,
                                  "auto" if body == "within_two" else body)
        before = sp_ops.TWIN_CALLS["spanner_admit"]
        sp_ops.spanner_admit(tn, td, torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(m), k, cap, body)
        assert sp_ops.TWIN_CALLS["spanner_admit"] == before + 1
        assert np.array_equal(tn.numpy(), np.asarray(jn)) and np.array_equal(td.numpy(), np.asarray(jd))
    pre = sp_ops.prefilter_plain(tn, torch.from_numpy(s), torch.from_numpy(d), k, cap)
    assert np.array_equal(pre.numpy(), np.asarray(jsp._within_k_prefilter(jn, jnp.asarray(s), jnp.asarray(d), k,
                                                                         cap)))


def test_auto_body_matches_jax():
    for c, d, k in [(512, 64, 2), (4096, 64, 3), (512, 32, 4), (64, 64, 5), (1 << 16, 8, 6)]:
        assert tsp.auto_body(c, d, k) == jsp.auto_body(c, d, k)


def test_bad_arguments_raise():
    n, d = torch.full((4, 2), -1, dtype=torch.int32), torch.zeros((4,), dtype=torch.int32)
    s = torch.zeros((3,), dtype=torch.int32)
    with pytest.raises(ValueError):
        sp_ops.spanner_admit(n, d, s, s, None, 2, 128, "nope")
    with pytest.raises(ValueError):
        sp_ops.spanner_admit(n, d.long(), s, s, None, 2, 128, "bfs")
    with pytest.raises(ValueError):
        tsp.Spanner(1000, 2, body="within_two")


def test_example_cli_matches_jax(tmp_path):
    inp = tmp_path / "in.txt"
    inp.write_text("1 2\n2 3\n1 3\n3 4\n4 5\n2 5\n")
    for args in ([], ["1000", "2"], ["1000", "1"]):
        jout, tout = tmp_path / "j.csv", tmp_path / "t.csv"
        jex.main([str(inp), str(jout), *args])
        tex.main(["--device=cpu", str(inp), str(tout), *args])
        assert tout.read_text() == jout.read_text()
    # k = 1 keeps every edge that is not a repeat
    assert (tmp_path / "t.csv").read_text().split() == ["1,2", "1,3", "2,3", "2,5", "3,4", "4,5"]
