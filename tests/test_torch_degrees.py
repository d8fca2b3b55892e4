"""Port parity: the degree kernels' twins, the fully-dynamic degree
distribution and the windowed degree summary of the PyTorch port against
the JAX package on the CPU.

Goldens from util/ExamplesTestData.java DEGREES_DATA/RESULT (:36-46) and
the degree-zero case (:48-67); random signed streams with deletions,
deletions of absent edges, self-loops and degrees past the vertex
capacity; the summary on the EF40 wire path and the windowed path; the
example's CSV bytes; and the interop converters, which start both packages
from one mid-stream state.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.core.types import EdgeBatch as JBatch
from gelly_streaming_tpu.io import sources as jsources
from gelly_streaming_tpu.io import wire as jwire
from gelly_streaming_tpu.library import degree_distribution as jdd
from gelly_streaming_tpu.ops import segments as jseg
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.core.types import EdgeBatch as TBatch
from gelly_streaming_tpu_torch.io import sources as tsources
from gelly_streaming_tpu_torch.io import wire as twire
from gelly_streaming_tpu_torch.library import degree_distribution as tdd
from gelly_streaming_tpu_torch.ops import degrees

# the wire path runs the prefetcher's threads
pytestmark = pytest.mark.timeout_cap(120)

CPU = "cpu"
KW = dict(vertex_capacity=16, max_degree=16)
DEGREES_DATA = [(1, 2, +1), (2, 3, +1), (1, 4, +1), (2, 3, -1), (3, 4, +1), (1, 2, -1)]
DEGREES_RESULT = [
    (1, 1), (1, 2),
    (2, 1), (1, 1), (1, 2),
    (2, 2), (1, 1), (1, 2),
    (1, 3), (2, 1), (1, 2),
    (1, 3), (2, 2), (1, 2),
    (1, 3), (2, 1), (1, 2),
]
DEGREES_DATA_ZERO = DEGREES_DATA + [(2, 3, -1)]
DEGREES_RESULT_ZERO = DEGREES_RESULT + [(1, 1)]


def _signed_pair(events, batch_size=None, **kw):
    """The same signed batch source in both packages."""
    bs = batch_size or len(events)
    kw = {**KW, **kw}
    cols = [np.array([e[k] for e in events]) for k in range(3)]

    def chunks():
        for i in range(0, len(events), bs):
            yield cols[0][i : i + bs], cols[1][i : i + bs], cols[2][i : i + bs]

    def t_factory():
        for s, d, g in chunks():
            yield TBatch.from_arrays(s, d, sign=g, pad_to=bs, device=CPU)

    def j_factory():
        for s, d, g in chunks():
            yield JBatch.from_arrays(s, d, sign=g, pad_to=bs)

    return (
        TStream.from_batches(t_factory, TConfig(**kw), device=CPU),
        JStream.from_batches(j_factory, JConfig(**kw)),
    )


def _events(seed, n, vertices, delete_share=0.3):
    """Signed events: deletions of present and of absent edges, self-loops."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vertices, n)
    dst = rng.integers(0, vertices, n)
    dst[::13] = src[::13]
    sign = np.where(rng.random(n) < delete_share, -1, 1)
    return list(zip(src.tolist(), dst.tolist(), sign.tolist()))


@pytest.mark.parametrize("bs", [None, 1, 2, 7])
def test_degree_distribution_goldens_match_jax(bs):
    for data, golden in ((DEGREES_DATA, DEGREES_RESULT), (DEGREES_DATA_ZERO, DEGREES_RESULT_ZERO)):
        t, j = _signed_pair(data, bs)
        got = tdd.DegreeDistribution().run(t).collect()
        assert got == jdd.DegreeDistribution().run(j).collect() == golden


@pytest.mark.parametrize("capacity,vertices", [(16, 12), (64, 64)])
def test_degree_distribution_random_signed_matches_jax(capacity, vertices):
    """Deletions (some of absent edges), self-loops, and at capacity 16
    degrees that pass the capacity (the histogram's dropped adds and
    clamped reads)."""
    events = _events(capacity, 600, vertices)
    t, j = _signed_pair(events, 64, vertex_capacity=capacity)
    t_dd, j_dd = tdd.DegreeDistribution(), jdd.DegreeDistribution()
    assert t_dd.run(t).collect() == j_dd.run(j).collect()
    np.testing.assert_array_equal(t_dd.final_state.deg.numpy(), np.asarray(j_dd.final_state.deg))
    np.testing.assert_array_equal(t_dd.final_state.hist.numpy(), np.asarray(j_dd.final_state.hist))
    if capacity == 16:
        assert int(t_dd.final_state.deg.max()) >= capacity


def test_degree_dist_update_from_a_shared_mid_stream_state():
    rng = np.random.default_rng(2)
    cfg = JConfig(vertex_capacity=32)
    ev = _events(5, 400, 20, delete_share=0.2)
    s, d, g = (np.array([e[k] for e in ev], dtype) for k, dtype in enumerate((np.int32, np.int32, np.int8)))
    m = rng.random(400) < 0.9
    jstate, _, _ = jdd.degree_dist_update(jdd.init_state(cfg), *map(jnp.asarray, (s[:200], d[:200], g[:200], m[:200])))
    tstate = interop.degree_dist_state_from_numpy(np.asarray(jstate.deg), np.asarray(jstate.hist), device=CPU)
    jstate, j_recs, j_mask = jdd.degree_dist_update(jstate, *map(jnp.asarray, (s[200:], d[200:], g[200:], m[200:])))
    tstate, t_recs, t_mask = tdd.degree_dist_update(tstate, *(torch.from_numpy(a[200:]) for a in (s, d, g, m)))
    np.testing.assert_array_equal(t_recs.numpy(), np.asarray(j_recs))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(tstate.deg.numpy(), np.asarray(jstate.deg))
    np.testing.assert_array_equal(tstate.hist.numpy(), np.asarray(jstate.hist))
    with pytest.raises(ValueError):
        interop.degree_dist_state_from_numpy(np.zeros(4), np.zeros(5), device=CPU)


def _scan_case(name):
    """(deg, hist, src, dst, sign | None, mask) of one adversarial batch."""
    rng = np.random.default_rng(sum(map(ord, name)))
    c, n = 32, 300
    src = rng.integers(0, c, n).astype(np.int32)
    dst = rng.integers(0, c, n).astype(np.int32)
    dst[::11] = src[::11]  # self-loops
    sign = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int8)
    mask = np.ones(n, bool)
    deg = np.zeros(c, np.int32)
    hist = np.zeros(c, np.int32)
    if name == "out_of_range_ids":
        src[rng.random(n) < 0.2] = -1
        dst[rng.random(n) < 0.1] = c
        dst[rng.random(n) < 0.1] = c + 5
        src[rng.random(n) < 0.05] = -c - 2
    elif name == "int8_signs":
        sign = rng.choice(np.array([-128, -3, -1, 0, 1, 2, 127], np.int8), n)
    elif name == "hub":
        src[rng.random(n) < 0.6] = 7
    elif name == "past_capacity":
        src, dst = src % 3, dst % 4  # degrees pass the capacity
        sign = np.where(rng.random(n) < 0.1, -1, 1).astype(np.int8)
    elif name == "masked":
        mask = rng.random(n) < 0.6
    elif name == "all_additions":
        sign = None
    elif name == "wrap":
        deg[5] = (1 << 31) - 3
        src, dst, sign = np.full(5, 5, np.int32), np.full(5, 9, np.int32), np.ones(5, np.int8)
        mask = np.ones(5, bool)
    return deg, hist, src, dst, sign, mask


def _jax_scan(deg, hist, src, dst, sign, mask):
    state = jdd.DegreeDistState(jnp.asarray(deg), jnp.asarray(hist))
    args = (src, dst, None if sign is None else sign, mask)
    state, recs, rmask = jdd.degree_dist_update(state, *(None if a is None else jnp.asarray(a) for a in args))
    return [np.asarray(a) for a in (state.deg, state.hist, recs, rmask)]


def _assert_scan_matches_jax(deg, hist, src, dst, sign, mask):
    """The two-stage twin and degree_dist_update on the CPU, bit for bit
    against JAX's lax.scan in deg, hist, records and record mask."""
    want = _jax_scan(deg, hist, src, dst, sign, mask)
    t = [None if a is None else torch.from_numpy(np.array(a)) for a in (deg, hist, src, dst, sign, mask)]
    for got in (
        degrees.degree_dist_scan_plain(*t),
        (lambda st, r, m: (st.deg, st.hist, r, m))(
            *tdd.degree_dist_update(interop.degree_dist_state_from_numpy(deg, hist, device=CPU), *t[2:])),
    ):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


SCAN_CASES = ["out_of_range_ids", "int8_signs", "hub", "past_capacity", "masked", "all_additions"]


@pytest.mark.parametrize("name", SCAN_CASES)
def test_degree_dist_scan_twin_matches_jax_on_edge_cases(name):
    _assert_scan_matches_jax(*_scan_case(name))


def test_degree_dist_scan_twin_wraps_like_jax_at_int32():
    """deg[v] = 2^31 - 3, then five +1 events on v: JAX's int32 add wraps
    past 2^31 - 1 and clamps to 0, and the twin walks that group in order."""
    deg, hist, src, dst, sign, mask = _scan_case("wrap")
    _assert_scan_matches_jax(deg, hist, src, dst, sign, mask)
    recs = degrees.degree_dist_scan_plain(*(torch.from_numpy(a) for a in (deg, hist, src, dst, sign, mask)))[2]
    assert recs[:, 0, 0].tolist() == [(1 << 31) - 2, (1 << 31) - 1, 0, 1, 2]


def test_degree_dist_scan_twin_matches_jax_from_a_mid_stream_state():
    """Random state from a JAX run, then an adversarial batch: every case
    above, started from interop.degree_dist_state_from_numpy."""
    rng = np.random.default_rng(12)
    c = 32
    ev = _events(4, 500, c, delete_share=0.25)
    s, d, g = (np.array([e[k] for e in ev], dtype) for k, dtype in enumerate((np.int32, np.int32, np.int8)))
    deg0, hist0, _, _ = _jax_scan(np.zeros(c, np.int32), np.zeros(c, np.int32), s, d, g, rng.random(500) < 0.9)
    for name in SCAN_CASES:
        _, _, src, dst, sign, mask = _scan_case(name)
        _assert_scan_matches_jax(deg0, hist0, src, dst, sign, mask)


@pytest.mark.parametrize("packed", [True, False])
def test_degree_trace_twin_matches_jax_kernel(packed):
    """The twin of the degree-trace kernel against JAX's _degree_stream
    kernel body, including the int32 wrap of a count and the clip."""
    rng = np.random.default_rng(8)
    c, n = 64, 500
    v = rng.integers(0, c, n).astype(np.int32)
    m = rng.random(n) < 0.8
    counts = rng.integers(0, 100, c).astype(np.int32)
    counts[3] = (1 << 31) - 2
    counts[4] = (1 << 28) - 3
    t_counts = torch.from_numpy(counts.copy())
    got = degrees.degree_trace(t_counts, torch.from_numpy(v), torch.from_numpy(m), packed)
    jv, jm, jc = jnp.asarray(v), jnp.asarray(m), jnp.asarray(counts)
    emitted = jc[jv] + jseg.occurrence_rank(jv, jm) + 1
    want_counts = jc.at[jnp.where(jm, jv, 0)].add(jm.astype(jnp.int32))
    want = (jwire.pack_records48(jv, emitted), jwire.pack_mask_bits(jm)) if packed else (jv, emitted, jm)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(want_counts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert degrees.LAUNCHES["degree_trace"] == 0  # CPU tensors run the twin


# ---------------------------------------------------------------------------
# the windowed degree summary


def _edges(n, cap, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)


def _assert_same_degs(t_recs, j_recs):
    assert len(t_recs) == len(j_recs) > 0
    for (t,), (j,) in zip(t_recs, j_recs):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert tdd.degree_histogram(t) == jdd.degree_histogram(j)


def test_degree_summary_on_the_ef40_wire_path_matches_jax():
    src, dst = _edges(2100, 1024, 8)
    width = (twire.EF40, 1024)
    bufs, tail = twire.pack_stream(src, dst, 256, width)
    cfg_kw = dict(vertex_capacity=1024, ingest_window_edges=512)
    t = TStream.from_wire(bufs, 256, width, TConfig(**cfg_kw), tail=tail, device=CPU)
    j = JStream.from_wire(bufs, 256, width, JConfig(**cfg_kw), tail=tail)
    agg = tdd.DegreeDistributionSummary()
    assert agg._wire_eligible(t)
    t_recs = t.aggregate(agg).collect()
    _assert_same_degs(t_recs, j.aggregate(jdd.DegreeDistributionSummary()).collect())
    final = np.bincount(src, minlength=1024) + np.bincount(dst, minlength=1024)
    np.testing.assert_array_equal(t_recs[-1][0].numpy(), final)
    # array-backed, packed EF40 on the prefetcher's thread
    kw = dict(vertex_capacity=1024, batch_size=512, wire_encoding="ef40")
    t = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
    assert agg._wire_width(t.cfg, 512) == width
    _assert_same_degs(t.aggregate(agg).collect(),
                      JStream.from_arrays(src, dst, JConfig(**kw)).aggregate(jdd.DegreeDistributionSummary()).collect())


@pytest.mark.parametrize("shards", [1, 2])
def test_degree_summary_windowed_matches_jax(shards):
    rng = np.random.default_rng(shards)
    n = 900
    edges = [(int(s), int(d), 0, int(t)) for s, d, t in
             zip(rng.integers(0, 100, n), rng.integers(0, 100, n), np.sort(rng.integers(0, 300, n)))]
    kw = dict(vertex_capacity=128, num_shards=shards)
    t = TStream.from_collection(edges, TConfig(**kw), batch_size=128, with_time=True, device=CPU)
    j = JStream.from_collection(edges, JConfig(**kw), batch_size=128, with_time=True)
    t_recs = t.aggregate(tdd.DegreeDistributionSummary(window_ms=100)).collect()
    _assert_same_degs(t_recs, j.aggregate(jdd.DegreeDistributionSummary(window_ms=100)).collect())
    assert len(t_recs) == 3


def test_degree_summary_combine_from_a_shared_state():
    src, dst = _edges(300, 64, 3)
    j_agg, t_agg = jdd.DegreeDistributionSummary(), tdd.DegreeDistributionSummary()
    cfg = JConfig(vertex_capacity=64)
    ones = jnp.ones(300, bool)
    ja = j_agg.update(j_agg.initial_state(cfg), jnp.asarray(src), jnp.asarray(dst), None, ones)
    jb = j_agg.update(j_agg.initial_state(cfg), jnp.asarray(dst), jnp.asarray(dst), None, ones)
    ta = interop.degree_summary_state_from_numpy(np.asarray(ja.deg), device=CPU)
    tb = interop.degree_summary_state_from_numpy(np.asarray(jb.deg), device=CPU)
    np.testing.assert_array_equal(t_agg.combine(ta, tb).deg.numpy(), np.asarray(j_agg.combine(ja, jb).deg))


# ---------------------------------------------------------------------------
# the example and its file source


def _write_events(path, events):
    path.write_text("".join(f"{s} {d} {'+' if g > 0 else '-'}\n" for s, d, g in events))


def test_file_stream_carries_signs_like_jax(tmp_path):
    from gelly_streaming_tpu.io.sources import file_stream as j_file_stream

    from gelly_streaming_tpu_torch.io.sources import file_stream as t_file_stream

    p = tmp_path / "events.txt"
    _write_events(p, _events(1, 150, 30))
    t, _ = t_file_stream(str(p), TConfig(vertex_capacity=32), batch_size=64, device=CPU)
    j, _ = j_file_stream(str(p), JConfig(vertex_capacity=32), batch_size=64)
    t_b, j_b = list(t.batches()), list(j.batches())
    assert len(t_b) == len(j_b) == 3
    for a, b in zip(t_b, j_b):
        np.testing.assert_array_equal(a.sign.numpy(), np.asarray(b.sign))
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))


@pytest.mark.parametrize("with_file", [False, True])
def test_degree_distribution_example_matches_jax(tmp_path, capsys, with_file):
    from gelly_streaming_tpu.examples import degree_distribution as j_example

    from gelly_streaming_tpu_torch.examples import degree_distribution as t_example

    args = []
    if with_file:
        p = tmp_path / "events.txt"
        _write_events(p, _events(6, 200, 25))
        args = [str(p)]
    t_out, j_out = tmp_path / "t.csv", tmp_path / "j.csv"
    if with_file:
        t_example.main(["--device=cpu", *args, str(t_out)])
        j_example.main([*args, str(j_out)])
        assert t_out.read_bytes() == j_out.read_bytes() and t_out.stat().st_size > 0
    else:
        t_example.main(["--device=cpu"])
        t_lines = capsys.readouterr().out.splitlines()
        j_example.main([])
        j_lines = capsys.readouterr().out.splitlines()
        assert t_lines[3:] == j_lines[3:] and len(t_lines) > 100


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_degree_trace_twin_follows_jax_index_rules(packed, masked):
    """Ids -1, C, C + 5 and -C - 2 beside C - 1: the gather of counts
    wraps -1 once and clamps, the add wraps -1 and drops the rest, the
    rank groups by the raw id and the record packs the raw id."""
    rng = np.random.default_rng(9)
    c, n = 16, 300
    v = rng.choice(np.array([-1, c, c + 5, -c - 2, c - 1, 0, 3], np.int32), n)
    m = rng.random(n) < 0.7 if masked else np.ones(n, bool)
    counts = rng.integers(0, 50, c).astype(np.int32)
    t_counts = torch.from_numpy(counts.copy())
    got = degrees.degree_trace(t_counts, torch.from_numpy(v), torch.from_numpy(m), packed)
    jv, jm, jc = jnp.asarray(v), jnp.asarray(m), jnp.asarray(counts)
    emitted = jc[jv] + jseg.occurrence_rank(jv, jm) + 1
    want_counts = jc.at[jnp.where(jm, jv, 0)].add(jm.astype(jnp.int32))
    want = (jwire.pack_records48(jv, emitted), jwire.pack_mask_bits(jm)) if packed else (jv, emitted, jm)
    np.testing.assert_array_equal(t_counts.numpy(), np.asarray(want_counts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# the degree summary over ids -1, C and C + 5 at C = 16: deg.at[src].add
OOR_EDGES = [(1, 2), (16, 3), (-1, 4), (21, 1), (5, -1), (15, 16), (3, 21), (-1, -1), (2, 5), (16, 16)]


@pytest.mark.parametrize("source,bs", [("collection", None), ("batches", 3)])
def test_degree_summary_follows_jax_index_rules(source, bs):
    kw = dict(vertex_capacity=16)
    if source == "collection":
        t = TStream.from_collection(OOR_EDGES, TConfig(**kw), device=CPU)
        j = JStream.from_collection(OOR_EDGES, JConfig(**kw))
    else:
        src, dst = (np.array([e[k] for e in OOR_EDGES], np.int32) for k in (0, 1))
        t = TStream.from_batches(tsources._batched(src, dst, None, None, None, bs, CPU), TConfig(**kw), device=CPU)
        j = JStream.from_batches(jsources._batched(src, dst, None, None, None, bs), JConfig(**kw))
    t_recs = t.aggregate(tdd.DegreeDistributionSummary(window_ms=500)).collect()
    _assert_same_degs(t_recs, j.aggregate(jdd.DegreeDistributionSummary(window_ms=500)).collect())
    assert int(t_recs[-1][0][15]) == 5  # -1 counts at C - 1, 16 and 21 are dropped


def _skewed_edges(rng, cap, n):
    """A star from one hub beside Zipf edges, shuffled, with ids -1, C and
    C + 5 on some rows and about a fifth of the rows masked."""
    hub = int(rng.integers(0, cap))
    star = n // 4
    zs, zd = ((rng.zipf(1.3, n - star) - 1) % cap for _ in range(2))
    src = np.concatenate([np.full(star, hub), zs])
    dst = np.concatenate([rng.integers(0, cap, star), zd])
    perm = rng.permutation(n)
    src, dst = src[perm].astype(np.int32), dst[perm].astype(np.int32)
    for k, x in enumerate((-1, cap, cap + 5)):
        src[k::97] = x
        dst[k + 11 :: 89] = x
    return src, dst, rng.random(n) < 0.8


@pytest.mark.parametrize("bs", [64, 1000])
def test_degree_summary_on_a_skewed_masked_stream_matches_jax(bs):
    cap, n = 512, 3000
    src, dst, mask = _skewed_edges(np.random.default_rng(bs), cap, n)

    def chunks():
        for i in range(0, n, bs):
            yield src[i : i + bs], dst[i : i + bs], mask[i : i + bs]

    def t_factory():
        for s, d, m in chunks():
            yield TBatch.from_arrays(s, d, mask=m, pad_to=bs, device=CPU)

    def j_factory():
        for s, d, m in chunks():
            yield JBatch.from_arrays(s, d, mask=m, pad_to=bs)

    kw = dict(vertex_capacity=cap)
    t = TStream.from_batches(t_factory, TConfig(**kw), device=CPU)
    j = JStream.from_batches(j_factory, JConfig(**kw))
    t_recs = t.aggregate(tdd.DegreeDistributionSummary()).collect()
    _assert_same_degs(t_recs, j.aggregate(jdd.DegreeDistributionSummary()).collect())
    # the hub's degree, and -1 counted at C - 1 by JAX's scatter rule
    ok_s = mask & (src < cap) & (src >= -1)
    ok_d = mask & (dst < cap) & (dst >= -1)
    want = np.bincount(src[ok_s] % cap, minlength=cap) + np.bincount(dst[ok_d] % cap, minlength=cap)
    np.testing.assert_array_equal(t_recs[-1][0].numpy(), want)
