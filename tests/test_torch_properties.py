"""Port parity: the GraphStream surface of the PyTorch port against the JAX
package on the CPU.

The edge-transform stages and their chains, the continuous property
streams on both kernel-stream branches (array-backed streams through the
wire upload, other sources as EdgeBatches), ragged tails, packed and raw
records, and the pieces under them (EdgeBatch methods, segments, neighbor
tables, the emission-plane packers) must give the same records as the JAX
package on the same numpy-seeded inputs.  The port runs its kernels' plain
twins here.
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
from gelly_streaming_tpu.ops import neighbors as jnb
from gelly_streaming_tpu.ops import segments as jseg
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.core.stream import _DistinctStage
from gelly_streaming_tpu_torch.core.types import EdgeBatch as TBatch
from gelly_streaming_tpu_torch.core.types import EdgeDirection, EventType
from gelly_streaming_tpu_torch.io import prefetch as tprefetch
from gelly_streaming_tpu_torch.io import sources as tsources
from gelly_streaming_tpu_torch.io import wire as twire
from gelly_streaming_tpu_torch.library import degree_distribution as tdd
from gelly_streaming_tpu_torch.ops import degrees
from gelly_streaming_tpu_torch.ops import neighbors as tnb
from gelly_streaming_tpu_torch.ops import segments as tseg

# the wire branch runs the prefetcher's threads
pytestmark = pytest.mark.timeout_cap(120)

CPU = "cpu"
# GraphStreamTestUtils.getLongLongEdges (test/GraphStreamTestUtils.java:55-68)
EDGES = [(1, 2, 12), (1, 3, 13), (2, 3, 23), (3, 4, 34), (3, 5, 35), (4, 5, 45), (5, 1, 51)]
KW = dict(vertex_capacity=16, max_degree=16, batch_size=4)


def _pair(edges, batch_size=None, **kw):
    """The same collection stream in both packages."""
    kw = {**KW, **kw}
    return (
        TStream.from_collection(edges, TConfig(**kw), batch_size=batch_size, device=CPU),
        JStream.from_collection(edges, JConfig(**kw), batch_size=batch_size),
    )


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# the stages, against the reference goldens (test/operations/*)

STAGES = {
    "map_plus_one": (lambda s: s.map_edges(lambda a, b, v: v + 1), "1,2,13\n1,3,14\n2,3,24\n3,4,35\n3,5,36\n4,5,46\n5,1,52"),
    "map_to_tuple": (lambda s: s.map_edges(lambda a, b, v: (v, v + 1)), "1,2,(12,13)\n1,3,(13,14)\n2,3,(23,24)\n3,4,(34,35)\n3,5,(35,36)\n4,5,(45,46)\n5,1,(51,52)"),
    "map_chained": (lambda s: s.map_edges(lambda a, b, v: v + 1).map_edges(lambda a, b, v: (v, v + 1)), "1,2,(13,14)\n1,3,(14,15)\n2,3,(24,25)\n3,4,(35,36)\n3,5,(36,37)\n4,5,(46,47)\n5,1,(52,53)"),
    "filter_edges": (lambda s: s.filter_edges(lambda a, b, v: v > 20), "2,3,23\n3,4,34\n3,5,35\n4,5,45\n5,1,51"),
    "filter_edges_none": (lambda s: s.filter_edges(lambda a, b, v: v < 0), ""),
    "filter_vertices": (lambda s: s.filter_vertices(lambda v: v > 1), "2,3,23\n3,4,34\n3,5,35\n4,5,45"),
    "reverse": (lambda s: s.reverse(), "2,1,12\n3,1,13\n3,2,23\n4,3,34\n5,3,35\n5,4,45\n1,5,51"),
    "undirected": (lambda s: s.undirected(), "1,2,12\n2,1,12\n1,3,13\n3,1,13\n2,3,23\n3,2,23\n3,4,34\n4,3,34\n3,5,35\n5,3,35\n4,5,45\n5,4,45\n5,1,51\n1,5,51"),
    "undirected_distinct": (lambda s: s.undirected().distinct(), "1,2,12\n2,1,12\n1,3,13\n3,1,13\n2,3,23\n3,2,23\n3,4,34\n4,3,34\n3,5,35\n5,3,35\n4,5,45\n5,4,45\n5,1,51\n1,5,51"),
}


@pytest.mark.parametrize("name", sorted(STAGES))
@pytest.mark.parametrize("bs", [3, 7])
def test_stage_matches_jax_and_golden(name, bs):
    op, golden = STAGES[name]
    t, j = _pair(EDGES, batch_size=bs)
    t_lines = op(t).edges_csv_lines()
    assert t_lines == op(j).edges_csv_lines()
    assert sorted(t_lines) == sorted(x for x in golden.split("\n") if x)


def test_union_and_distinct_match_jax():
    cfg_t, cfg_j = TConfig(**KW), JConfig(**KW)
    t = TStream.from_collection(EDGES[:4], cfg_t, device=CPU).union(TStream.from_collection(EDGES[4:], cfg_t, device=CPU))
    j = JStream.from_collection(EDGES[:4], cfg_j).union(JStream.from_collection(EDGES[4:], cfg_j))
    assert t.edges_csv_lines() == j.edges_csv_lines()
    assert sorted(t.edges_csv_lines()) == sorted(f"{a},{b},{v}" for a, b, v in EDGES)
    t, j = _pair(EDGES + EDGES, batch_size=5)
    assert t.distinct().edges_csv_lines() == j.distinct().edges_csv_lines() == [f"{a},{b},{v}" for a, b, v in EDGES]
    t, j = _pair([(1, 2, 7), (1, 2, 7), (1, 2, 7), (2, 3, 9)])
    assert t.distinct().edges_csv_lines() == j.distinct().edges_csv_lines() == ["1,2,7", "2,3,9"]


def test_distinct_modes_match_jax():
    valued = [(1, 2, 10.0), (1, 2, 20.0), (1, 2, 10.0), (3, 4, 30.0)]
    for bs in (4, 2):
        for by in ("auto", "edge", "endpoints"):
            t, j = _pair(valued, batch_size=bs)
            assert t.distinct(by=by).collect_edges() == j.distinct(by=by).collect_edges()
    t, _ = _pair(valued)
    assert t.distinct().collect_edges() == [(1, 2, 10.0), (1, 2, 20.0), (3, 4, 30.0)]
    assert t.distinct(by="endpoints").collect_edges() == [(1, 2, 10.0), (3, 4, 30.0)]
    with pytest.raises(ValueError, match="unknown distinct mode"):
        t.distinct(by="pair")
    with pytest.raises(ValueError, match="single scalar value"):
        t.map_edges(lambda s, d, v: (v, v)).distinct().collect_edges()
    with pytest.raises(ValueError, match="<= 32 bits"):
        t.map_edges(lambda s, d, v: v.to(torch.float64)).distinct().collect_edges()
    # a known value-less source dedupes endpoint pairs in one table
    arr = TStream.from_arrays(np.array([1, 1, 3]), np.array([2, 2, 4]), TConfig(**KW), device=CPU).distinct()
    assert isinstance(arr._stages[-1], _DistinctStage) and arr._stages[-1].mode == "endpoints"
    assert [e[:2] for e in arr.collect_edges()] == [(1, 2), (3, 4)]
    # bfloat16 values are bit-cast, never truncated: 1.5 and 1.0 stay distinct
    bf = [(1, 2, 1.5), (1, 2, 1.0), (1, 2, 1.5)]
    t, j = _pair(bf)
    t_edges = t.map_edges(lambda s, d, v: v.to(torch.bfloat16)).distinct().collect_edges()
    j_edges = j.map_edges(lambda s, d, v: v.astype(jnp.bfloat16)).distinct().collect_edges()
    assert len(t_edges) == len(j_edges) == 2


def test_distinct_overflow_reports_new_and_forgets():
    """A new edge past its source's max_degree slots is dropped from the
    table but still emitted, so a later duplicate of it passes again."""
    edges = [(0, 1), (0, 2), (0, 3), (0, 3), (0, 1), (0, 3)]
    kw = dict(vertex_capacity=8, max_degree=2)
    t = TStream.from_collection(edges, TConfig(**kw), batch_size=1, device=CPU).distinct()
    j = JStream.from_collection(edges, JConfig(**kw), batch_size=1).distinct()
    assert t.collect_edges() == j.collect_edges() == [(0, 1), (0, 2), (0, 3), (0, 3), (0, 3)]
    # within one batch the overflowing row is new once, its repeat not
    t = TStream.from_collection(edges, TConfig(**kw), device=CPU).distinct()
    j = JStream.from_collection(edges, JConfig(**kw)).distinct()
    assert t.collect_edges() == j.collect_edges() == [(0, 1), (0, 2), (0, 3)]


CHAIN_OPS = [
    ("rev", lambda s: s.reverse()),
    ("und", lambda s: s.undirected()),
    ("dis", lambda s: s.distinct()),
    ("fe_mod", lambda s: s.filter_edges(lambda a, b, v: (a + b) % 3 != 0)),
    ("fv_half", lambda s: s.filter_vertices(lambda v: v < 32)),
    ("fe_ne", lambda s: s.filter_edges(lambda a, b, v: a != b)),
    ("map_sum", lambda s: s.map_edges(lambda a, b, v: a + b)),
]


@pytest.mark.parametrize("seed", range(6))
def test_random_chain_matches_jax_on_both_branches(seed):
    """Random stage chains over array-backed streams (the wire branch) and
    collection streams (the EdgeBatch branch): edges, degree trace and CC
    labels equal to the JAX package's, and both port branches agree."""
    from gelly_streaming_tpu.library.connected_components import ConnectedComponents as JCC

    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents as TCC

    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 160))
    src = rng.integers(0, 64, n).astype(np.int32)
    dst = rng.integers(0, 64, n).astype(np.int32)
    batch = int(rng.choice([16, 32]))
    ops = [CHAIN_OPS[i] for i in rng.choice(len(CHAIN_OPS), rng.integers(1, 4))]
    kw = dict(vertex_capacity=64, batch_size=batch)
    t_arr = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
    t_col = TStream.from_collection(list(zip(src.tolist(), dst.tolist())), TConfig(**kw), batch_size=batch, device=CPU)
    j_arr = JStream.from_arrays(src, dst, JConfig(**kw))
    for _, op in ops:
        t_arr, t_col, j_arr = op(t_arr), op(t_col), op(j_arr)
    names = [name for name, _ in ops]
    assert t_arr.collect_edges() == j_arr.collect_edges(), names
    degs = t_arr.get_degrees().collect()
    assert degs == j_arr.get_degrees().collect() == t_col.get_degrees().collect(), names
    t_cc = t_arr.aggregate(TCC()).collect()[-1][0]
    j_cc = j_arr.aggregate(JCC()).collect()[-1][0]
    assert str(t_cc) == str(j_cc), names
    np.testing.assert_array_equal(t_cc.seen.numpy(), np.asarray(j_cc.seen))


# ---------------------------------------------------------------------------
# the property streams


PROPS = ["get_degrees", "get_in_degrees", "get_out_degrees", "get_vertices", "number_of_vertices", "number_of_edges"]


@pytest.mark.parametrize("source", ["arrays", "collection"])
@pytest.mark.parametrize("cap", [256, (1 << 20) + 4], ids=["packed", "raw"])
def test_property_streams_match_jax(source, cap):
    """Every property stream on both kernel-stream branches, with a ragged
    tail, packed (capacity <= 2^20) and raw-column records."""
    rng = np.random.default_rng(cap)
    n = 600  # 4 full batches of 128 and a tail of 88
    src = rng.integers(0, 200, n).astype(np.int32)
    dst = rng.integers(0, 200, n).astype(np.int32)
    src[:40] = 7  # a hub
    kw = dict(vertex_capacity=cap, batch_size=128)
    if source == "arrays":
        t = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
        j = JStream.from_arrays(src, dst, JConfig(**kw))
        assert t._wire_arrays is not None
    else:
        edges = list(zip(src.tolist(), dst.tolist()))
        t = TStream.from_collection(edges, TConfig(**kw), batch_size=128, device=CPU)
        j = JStream.from_collection(edges, JConfig(**kw), batch_size=128)
    for prop in PROPS:
        t_out, j_out = getattr(t, prop)(), getattr(j, prop)()
        assert t_out.lines() == j_out.lines(), prop
    blocks = [list(zip(*(c.tolist() for c in b.columns))) for b in t.get_degrees().blocks()]
    assert [r for b in blocks for r in b] == t.get_degrees().collect()


# ids outside [0, C) on the streams that validate nothing: -1, C and C + 5
# at C = 16, beside C - 1 (JAX's -1 reads and adds at C - 1 but groups apart)
OOR_C = 16
OOR_EDGES = [(1, 2), (16, 3), (-1, 4), (21, 1), (5, -1), (15, 16), (3, 21), (-1, -1), (2, 5), (16, 16),
             (15, 2), (-1, 15), (21, 21), (4, -1)]
OOR_OPS = {
    **{prop: (lambda s, p=prop: getattr(s, p)().lines()) for prop in PROPS},
    "distinct": lambda s: s.distinct().edges_csv_lines(),
    "undirected_distinct": lambda s: s.undirected().distinct().edges_csv_lines(),
}


def _oor_pair(source, bs):
    """The out-of-range stream in both packages: ``from_collection`` in one
    batch, or ``from_batches`` in padded batches of ``bs``."""
    kw = dict(vertex_capacity=OOR_C, max_degree=4)
    if source == "collection":
        return (TStream.from_collection(OOR_EDGES, TConfig(**kw), device=CPU),
                JStream.from_collection(OOR_EDGES, JConfig(**kw)))
    src, dst = (np.array([e[k] for e in OOR_EDGES], np.int32) for k in (0, 1))
    return (TStream.from_batches(tsources._batched(src, dst, None, None, None, bs, CPU), TConfig(**kw), device=CPU),
            JStream.from_batches(jsources._batched(src, dst, None, None, None, bs), JConfig(**kw)))


@pytest.mark.parametrize("op", sorted(OOR_OPS))
@pytest.mark.parametrize("source,bs", [("collection", None), ("batches", 5)])
def test_out_of_range_ids_follow_jax_index_rules(op, source, bs):
    """Property streams and distinct over ids -1, C and C + 5: the port
    gives the JAX package's records (its negative-wrap, gather-clamp and
    scatter-drop rules), and raises nowhere JAX returns records."""
    t, j = _oor_pair(source, bs)
    want = OOR_OPS[op](j)
    assert want and OOR_OPS[op](t) == want


def test_out_of_range_records_pack_like_jax():
    """-1 packs to the same 48 bits in both packages (1048575, 4095)."""
    t, j = _oor_pair("collection", None)
    assert t.get_degrees().lines() == j.get_degrees().lines()
    assert "1048575,4095" in t.get_degrees().lines()
    for pkg, cfg in ((TStream, TConfig), (JStream, JConfig)):
        with pytest.raises(ValueError):
            pkg.from_arrays(np.array([1, -1]), np.array([2, 3]), cfg(vertex_capacity=OOR_C))
        with pytest.raises(ValueError):
            pkg.from_arrays(np.array([1, OOR_C]), np.array([2, 3]), cfg(vertex_capacity=OOR_C))


def test_property_goldens_and_edges():
    """TestGetDegrees.java, TestGetVertices.java, TestNumberOfEntities.java."""
    t, j = _pair(EDGES, batch_size=3)
    assert sorted(t.get_degrees().lines()) == sorted(
        "1,1 1,2 1,3 2,1 2,2 3,1 3,2 3,3 3,4 4,1 4,2 5,1 5,2 5,3".split())
    assert sorted(t.get_in_degrees().lines()) == sorted("1,1 2,1 3,1 3,2 4,1 5,1 5,2".split())
    assert sorted(t.get_out_degrees().lines()) == sorted("1,1 1,2 2,1 3,1 3,2 4,1 5,1".split())
    assert t.get_vertices().lines() == j.get_vertices().lines() == [f"{v},(null)" for v in (1, 2, 3, 4, 5)]
    assert t.number_of_vertices().lines() == ["1", "2", "3", "4", "5"]
    assert t.number_of_edges().lines() == [str(i) for i in range(1, 8)]
    assert t.get_edges().collect() == j.get_edges().collect()


def test_degree_records_clip_and_wrap_like_jax():
    """Records leave the device packed: ids of 20 bits, degrees clipped to
    [0, 2^28 - 1] (the wrapped int32 counts of a long stream included)."""
    ids = np.array([0, 5, (1 << 20) - 1, 77, 3, 9], np.int32)
    vals = np.array([1, (1 << 28) - 1, 1 << 28, -5, (1 << 31) - 1, 4096], np.int32)
    got = twire.pack_records48(_t(ids), _t(vals)).numpy()
    want = np.asarray(jwire.pack_records48(jnp.asarray(ids), jnp.asarray(vals)))
    np.testing.assert_array_equal(got, want)
    mask = np.array([1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1], bool)
    np.testing.assert_array_equal(twire.pack_mask_bits(_t(mask)).numpy(), np.asarray(jwire.pack_mask_bits(jnp.asarray(mask))))
    t_dec = twire.unpack_records48(got, np.asarray(jwire.pack_mask_bits(jnp.asarray(mask[:6]))), 6)
    for a, b in zip(t_dec, jwire.unpack_records48(want, np.asarray(jwire.pack_mask_bits(jnp.asarray(mask[:6]))), 6)):
        np.testing.assert_array_equal(a, b)


def test_prefetchers_on_cpu():
    rng = np.random.default_rng(1)
    batches = [(rng.integers(0, 1 << 16, 100).astype(np.int32), rng.integers(0, 1 << 16, 100).astype(np.int32))
               for _ in range(5)]
    with tprefetch.WirePrefetcher(iter(batches), 2, torch.device(CPU), depth=2) as pf:
        got = list(pf)
    assert [n for _, n in got] == [100] * 5
    for (buf, _), (s, d) in zip(got, batches):
        np.testing.assert_array_equal(buf.numpy(), jwire.pack_edges(s, d, 2))
    outs = [(torch.arange(i, dtype=torch.int32), torch.ones(i, dtype=torch.bool)) for i in range(6)]
    host = list(tprefetch.prefetch_to_host(iter(outs), torch.device(CPU), depth=2))
    assert len(host) == 6 and all(isinstance(a, np.ndarray) for h in host for a in h)
    assert [h[0].tolist() for h in host] == [list(range(i)) for i in range(6)]


# ---------------------------------------------------------------------------
# the pieces underneath


def test_edge_batch_methods_match_jax():
    assert EventType.EDGE_DELETION.value == -1 and EdgeDirection.ALL.value == "all"
    kw = dict(pad_to=5)
    a_t = TBatch.from_arrays([1, 2, 3], [4, 5, 6], val=np.array([1.5, 2.5, 3.5], np.float32), device=CPU, **kw)
    a_j = JBatch.from_arrays([1, 2, 3], [4, 5, 6], val=np.array([1.5, 2.5, 3.5], np.float32), **kw)
    b_t = TBatch.from_arrays([7], [8], sign=[-1], device=CPU)
    b_j = JBatch.from_arrays([7], [8], sign=[-1])
    for bt, bj in ((a_t.concat(b_t), a_j.concat(b_j)), (b_t.concat(a_t), b_j.concat(a_j))):
        assert bt.to_tuples() == bj.to_tuples()
        np.testing.assert_array_equal(bt.sign.numpy(), np.asarray(bj.sign))
        np.testing.assert_array_equal(bt.val.numpy(), np.asarray(bj.val))
        assert int(bt.num_valid()) == int(bj.num_valid()) == 4
    assert a_t.reversed().to_tuples() == a_j.reversed().to_tuples()
    tup_t = a_t.replace(val=(a_t.src, a_t.dst * 2))
    tup_j = a_j.replace(val=(a_j.src, a_j.dst * 2))
    assert tup_t.to_tuples() == tup_j.to_tuples() == [(1, 4, (1, 8)), (2, 5, (2, 10)), (3, 6, (3, 12))]
    timed = TBatch.from_arrays([1], [2], time=[5], device=CPU)
    with pytest.raises(ValueError, match="only one side has 'time'"):
        timed.concat(b_t)


@pytest.mark.parametrize("seed", range(3))
def test_segments_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 300
    k = rng.integers(0, 20, n).astype(np.int32)
    d = rng.integers(0, 4, n).astype(np.int32)
    third = rng.integers(-2, 2, n).astype(np.int32)
    m = rng.random(n) < 0.8
    vals = rng.integers(-5, 5, n).astype(np.int32)
    tk, td, tt, tm, tv = map(_t, (k, d, third, m, vals))
    jk, jd, jt, jm, jv = map(jnp.asarray, (k, d, third, m, vals))
    pairs = [
        (tseg.first_occurrence_mask(tk, tm), jseg.first_occurrence_mask(jk, jm)),
        (tseg.first_occurrence_mask(tk), jseg.first_occurrence_mask(jk)),
        (tseg.group_counts(tk, 24, tm), jseg.group_counts(jk, 24, jm)),
        (tseg.segment_sum(tv, tk, 24, tm), jseg.segment_sum(jv, jk, 24, jm)),
        (tseg.occurrence_rank_pairs(tk, td, tm), jseg.occurrence_rank_pairs(jk, jd, jm)),
        (tseg.first_occurrence_mask_pairs(tk, td, tm), jseg.first_occurrence_mask_pairs(jk, jd, jm)),
        (tseg.first_occurrence_mask_triples(tk, td, tt, tm), jseg.first_occurrence_mask_triples(jk, jd, jt, jm)),
        (tseg.sort_by_key(tk, tm)[0], jseg.sort_by_key(jk, jm)[0]),
        (tseg.sort_by_key(tk, tm)[1], jseg.sort_by_key(jk, jm)[1]),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_insert_unique_matches_jax_from_a_shared_state():
    rng = np.random.default_rng(4)
    c, dmax, n = 16, 4, 60
    jt = jnb.init_table(c, dmax)
    # a prefill of the same shape as the batch under test: one trace for both
    jt, _ = jnb.insert_unique_batch(jt, jnp.asarray(rng.integers(0, c, n), jnp.int32),
                                    jnp.asarray(rng.integers(0, c, n), jnp.int32),
                                    jnp.asarray(rng.random(n) < 0.3))
    jv = jnb.init_table(c, dmax)
    tt = interop.neighbor_table_from_numpy(*map(np.asarray, jt), device=CPU)
    tv = interop.neighbor_table_from_numpy(*map(np.asarray, jv), device=CPU)
    s, d = rng.integers(0, c, n).astype(np.int32), rng.integers(0, c, n).astype(np.int32)
    bits = rng.integers(0, 3, n).astype(np.int32)
    m = rng.random(n) < 0.9
    got_t, new_t = tnb.insert_unique_batch(tt, _t(s), _t(d), _t(m))
    want_t, new_j = jnb.insert_unique_batch(jt, jnp.asarray(s), jnp.asarray(d), jnp.asarray(m))
    np.testing.assert_array_equal(new_t.numpy(), np.asarray(new_j))
    for a, b in zip(got_t, want_t):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got_t.dropped) > 0  # the overflow case is exercised
    got = tnb.insert_unique_valued_batch(tt, tv, _t(s), _t(d), _t(bits), _t(m))
    want = jnb.insert_unique_valued_batch(jt, jv, *map(jnp.asarray, (s, d, bits, m)))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for tab_t, tab_j in zip(got[:2], want[:2]):
        for a, b in zip(tab_t, tab_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# the fully-dynamic degree distribution, in batches


@pytest.mark.parametrize("seed", range(3))
def test_degree_dist_update_in_batches_matches_jax(seed):
    """Repeated in-place updates of one state, against JAX's scan."""
    rng = np.random.default_rng(seed)
    c, n, bs = 48, 600, 150
    src = rng.integers(-2, c + 3, n).astype(np.int32)
    dst = np.where(rng.random(n) < 0.5, 3, rng.integers(0, c, n)).astype(np.int32)
    sign = rng.choice(np.array([-2, -1, 1, 1, 3], np.int8), n)
    mask = rng.random(n) < 0.85
    jstate = jdd.init_state(JConfig(vertex_capacity=c))
    tstate = tdd.init_state(TConfig(vertex_capacity=c), device=CPU)
    for lo in range(0, n, bs):
        part = [a[lo : lo + bs] for a in (src, dst, sign, mask)]
        jstate, j_recs, j_mask = jdd.degree_dist_update(jstate, *map(jnp.asarray, part))
        tstate, t_recs, t_mask = tdd.degree_dist_update(tstate, *map(_t, part))
        np.testing.assert_array_equal(t_recs.numpy(), np.asarray(j_recs))
        np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(tstate.deg.numpy(), np.asarray(jstate.deg))
    np.testing.assert_array_equal(tstate.hist.numpy(), np.asarray(jstate.hist))
