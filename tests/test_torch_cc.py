"""Port parity: streaming Connected Components of the PyTorch port against
the JAX package on the CPU.

Every path the port routes (the wire path over array-backed and replayed
streams at every width, running emissions, superbatch groups, the windowed
path with bulk and tree combines and round-robin partitions) must emit the
same records as the JAX package: parent and seen bit-identical and the
DisjointSet strings identical.  The port runs its kernel's plain twin here.
"""

import os

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.io import sources as jsources
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.io import sources as tsources
from gelly_streaming_tpu_torch.io import wire as tw
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.ops import unionfind as tuf

# the wire path runs the Prefetcher's threads
pytestmark = pytest.mark.timeout_cap(120)

CPU = "cpu"
CC_EDGES = [(1, 2), (1, 3), (2, 3), (1, 5), (6, 7), (8, 9)]  # ConnectedComponentsTest.java:55-63


def _assert_same_records(t_recs, j_recs):
    assert len(t_recs) == len(j_recs) > 0
    for (t,), (j,) in zip(t_recs, j_recs):
        np.testing.assert_array_equal(t.parent.numpy(), np.asarray(j.parent))
        np.testing.assert_array_equal(t.seen.numpy(), np.asarray(j.seen))
        assert str(t) == str(j)


def _edges(n, cap, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)


@pytest.mark.parametrize("algo", ["ConnectedComponents", "ConnectedComponentsTree"])
def test_golden_matches_jax(algo):
    kw = dict(vertex_capacity=16, max_degree=16)
    t = TStream.from_collection(CC_EDGES, TConfig(**kw), device=CPU).aggregate(getattr(tcc, algo)(window_ms=5))
    j = JStream.from_collection(CC_EDGES, JConfig(**kw)).aggregate(getattr(jcc, algo)(window_ms=5))
    t_recs = t.collect()
    _assert_same_records(t_recs, j.collect())
    assert str(t_recs[-1][0]) == "{1=[1, 2, 3, 5], 6=[6, 7], 8=[8, 9]}"  # ConnectedComponentsTest.java:41


def test_multi_window_merge_matches_jax():
    edges = [(1, 2, 0, 10), (3, 4, 0, 20), (2, 3, 0, 110), (5, 6, 0, 210)]
    kw = dict(vertex_capacity=16, max_degree=16)
    t = TStream.from_collection(edges, TConfig(**kw), batch_size=1, with_time=True, device=CPU)
    j = JStream.from_collection(edges, JConfig(**kw), batch_size=1, with_time=True)
    t_recs = t.aggregate(tcc.ConnectedComponents(window_ms=100)).collect()
    _assert_same_records(t_recs, j.aggregate(jcc.ConnectedComponents(window_ms=100)).collect())
    assert [str(r[0]) for r in t_recs] == [
        "{1=[1, 2], 3=[3, 4]}", "{1=[1, 2, 3, 4]}", "{1=[1, 2, 3, 4], 5=[5, 6]}"
    ]


def _timed_edges(seed, n=1500, cap=200, windows=4):
    rng = np.random.default_rng(seed)
    return [
        (int(s), int(d), 0, int(t))
        for s, d, t in zip(
            rng.integers(0, cap, n), rng.integers(0, cap, n), np.sort(rng.integers(0, windows * 100, n))
        )
    ]


@pytest.mark.parametrize("algo", ["ConnectedComponents", "ConnectedComponentsTree"])
@pytest.mark.parametrize("shards", [1, 2])
def test_windowed_path_with_partitions_matches_jax(algo, shards):
    """Timed windows, folded per round-robin partition and combined (flat
    or tree), merged across windows."""
    edges = _timed_edges(shards)
    kw = dict(vertex_capacity=256, num_shards=shards, tree_degree=3)
    t = TStream.from_collection(edges, TConfig(**kw), batch_size=128, with_time=True, device=CPU)
    j = JStream.from_collection(edges, JConfig(**kw), batch_size=128, with_time=True)
    t_recs = t.aggregate(getattr(tcc, algo)(window_ms=100)).collect()
    _assert_same_records(t_recs, j.aggregate(getattr(jcc, algo)(window_ms=100)).collect())
    assert len(t_recs) == 4


@pytest.mark.parametrize("encoding", ["plain", "ef40"])
@pytest.mark.parametrize("n", [3000, 4096])
def test_from_arrays_wire_path_matches_jax(encoding, n):
    src, dst = _edges(n, 1000, n)
    kw = dict(vertex_capacity=1024, batch_size=512, wire_encoding=encoding)
    t = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
    agg = tcc.ConnectedComponents()
    assert agg._wire_eligible(t)
    assert agg._wire_width(t.cfg, 512) == ((tw.EF40, 1024) if encoding == "ef40" else 2)
    j = JStream.from_arrays(src, dst, JConfig(**kw))
    _assert_same_records(t.aggregate(agg).collect(), j.aggregate(jcc.ConnectedComponents()).collect())


@pytest.mark.parametrize(
    "width",
    [2, 3, 4, tw.PAIR40, (tw.EF40, 1024), (tw.BDV, 1024)],
    ids=["2", "3", "4", "pair40", "ef40", "bdv"],
)
def test_from_wire_with_tail_matches_jax(width):
    src, dst = _edges(2100, 1024, 8)
    bufs, tail = tw.pack_stream(src, dst, 256, width)
    assert tail is not None and len(bufs) == 8
    t = TStream.from_wire(bufs, 256, width, TConfig(vertex_capacity=1024), tail=tail, device=CPU)
    assert tcc.ConnectedComponents()._wire_eligible(t)
    j = JStream.from_wire(bufs, 256, width, JConfig(vertex_capacity=1024), tail=tail)
    _assert_same_records(
        t.aggregate(tcc.ConnectedComponents()).collect(), j.aggregate(jcc.ConnectedComponents()).collect()
    )


@pytest.mark.parametrize("source", ["arrays", "wire-ef40", "wire-bdv"])
@pytest.mark.parametrize("superbatch", [0, 4])
def test_running_emissions_match_jax_record_by_record(source, superbatch):
    """ingest_window_edges on batch boundaries: the wire path emits the
    running summary every window (cloned: later folds must not change an
    emitted record); superbatch groups never cross an emission."""
    src, dst = _edges(5000, 300, 9)  # 9 full batches + a tail
    kw = dict(vertex_capacity=512, batch_size=512, ingest_window_edges=1024, superbatch=superbatch)
    if source == "arrays":
        t = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
        j = JStream.from_arrays(src, dst, JConfig(**kw))
    else:
        width = (tw.EF40, 512) if source == "wire-ef40" else (tw.BDV, 512)
        bufs, tail = tw.pack_stream(src, dst, 512, width)
        t = TStream.from_wire(bufs, 512, width, TConfig(**kw), tail=tail, device=CPU)
        j = JStream.from_wire(bufs, 512, width, JConfig(**kw), tail=tail)
    assert tcc.ConnectedComponents()._wire_eligible(t)
    t_recs = t.aggregate(tcc.ConnectedComponents()).collect()
    _assert_same_records(t_recs, j.aggregate(jcc.ConnectedComponents()).collect())
    assert len(t_recs) == 5
    assert len({str(r[0]) for r in t_recs}) > 1  # earlier records kept their state


def test_superbatch_wire_path_matches_per_batch():
    src, dst = _edges(8192, 1000, 10)
    for width in (tw.PAIR40, (tw.BDV, 1024)):
        bufs, _ = tw.pack_stream(src, dst, 512, width)
        runs = []
        for sb in (0, 4, 8):
            s = TStream.from_wire(bufs, 512, width, TConfig(vertex_capacity=1024, superbatch=sb), device=CPU)
            runs.append(s.aggregate(tcc.ConnectedComponents()).collect()[0][0])
        for r in runs[1:]:
            assert torch.equal(r.parent, runs[0].parent) and torch.equal(r.seen, runs[0].seen)


@pytest.mark.parametrize("algo", ["ConnectedComponents", "ConnectedComponentsTree"])
def test_sharded_windowed_fold_of_an_array_stream_matches_jax(algo):
    """num_shards=2 on an array-backed stream leaves the wire path: the
    port folds both partitions of each ingestion window on one device."""
    src, dst = _edges(3000, 500, 11)
    kw = dict(vertex_capacity=512, batch_size=256, num_shards=2, ingest_window_edges=1000)
    t = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
    assert not tcc.ConnectedComponents()._wire_eligible(t)
    j = JStream.from_arrays(src, dst, JConfig(**kw))
    _assert_same_records(t.aggregate(getattr(tcc, algo)()).collect(), j.aggregate(getattr(jcc, algo)()).collect())


def test_state_carried_across_with_interop_folds_on_like_jax():
    cap = 512
    s1, d1 = _edges(800, cap, 12)
    s2, d2 = _edges(600, cap, 13)
    jagg = jcc.ConnectedComponents()
    jstate = jagg.update(jagg.initial_state(JConfig(vertex_capacity=cap)), s1, d1, None, np.ones(800, bool))
    tstate = interop.cc_state_from_numpy(np.asarray(jstate.parent), np.asarray(jstate.seen), CPU)
    mask = np.random.default_rng(14).random(600) < 0.7
    jstate2 = jagg.update(jstate, s2, d2, None, mask)
    tagg = tcc.ConnectedComponents()
    tstate2 = tagg.update(tstate, torch.from_numpy(s2), torch.from_numpy(d2), None, torch.from_numpy(mask))
    np.testing.assert_array_equal(tstate2.parent.numpy(), np.asarray(jstate2.parent))
    np.testing.assert_array_equal(tstate2.seen.numpy(), np.asarray(jstate2.seen))
    ds = interop.disjoint_set_from_numpy(np.asarray(jstate2.parent), np.asarray(jstate2.seen), CPU)
    assert str(ds) == str(tagg.transform(tstate2)) == str(jagg.transform(jstate2))
    with pytest.raises(ValueError):
        interop.cc_state_from_numpy(np.array([0, 5]), np.zeros(2, bool), CPU)


def test_refuses_unported_planes_and_unordered_replays(tmp_path):
    src, dst = _edges(100, 64, 15)
    # checkpoints and the binned/compressed ingest are ported: the JAX package's records
    j_recs = JStream.from_arrays(src, dst, JConfig(vertex_capacity=64)).aggregate(jcc.ConnectedComponents()).collect()
    t_recs = TStream.from_arrays(src, dst, TConfig(vertex_capacity=64), device=CPU).aggregate(
        tcc.ConnectedComponents(), checkpoint_path=str(tmp_path / "x")
    ).collect()
    _assert_same_records(t_recs, j_recs)
    for kw in ({"binned_ingest": 1}, {"wire_compress": 1}):
        s = TStream.from_arrays(src, dst, TConfig(vertex_capacity=64, **kw), device=CPU)
        _assert_same_records(s.aggregate(tcc.ConnectedComponents()).collect(), j_recs)
    with pytest.raises(ValueError, match="ingest_window_ms"):
        TStream.from_arrays(src, dst, TConfig(vertex_capacity=64, ingest_window_ms=5), device=CPU).aggregate(
            tcc.ConnectedComponents(), checkpoint_path=str(tmp_path / "y")
        )
    # the async and superbatch windowed planes are ported: they emit the JAX package's records
    timed = [(1, 2, 0, 5), (2, 3, 0, 150)]
    for kw in ({"async_windows": 2}, {"superbatch": 4}):
        s = TStream.from_collection(timed, TConfig(vertex_capacity=8, **kw), with_time=True, device=CPU)
        j = JStream.from_collection(timed, JConfig(vertex_capacity=8, **kw), with_time=True)
        _assert_same_records(s.aggregate(tcc.ConnectedComponents(window_ms=100)).collect(),
                             j.aggregate(jcc.ConnectedComponents(window_ms=100)).collect())

    class Ordered(SummaryBulkAggregation):  # an order-sensitive fold
        def initial_state(self, cfg, device):
            return torch.zeros(1, dtype=torch.int32, device=device)

        def update(self, state, src, dst, val, mask):
            return state

    bufs, _ = tw.pack_stream(src, dst, 50, (tw.EF40, 64))
    with pytest.raises(ValueError, match="order-free"):
        TStream.from_wire(bufs, 50, (tw.EF40, 64), TConfig(vertex_capacity=64), device=CPU).aggregate(Ordered())
    with pytest.raises(ValueError, match="order-free"):
        Ordered()._wire_width(TConfig(wire_encoding="ef40"), 64)
    for kw in ({"binned_ingest": 1}, {"wire_compress": 1}):
        with pytest.raises(ValueError, match="order-free"):
            TStream.from_arrays(src, dst, TConfig(vertex_capacity=64, **kw), device=CPU).aggregate(Ordered()).collect()


def test_the_wire_path_launches_nothing_on_cpu():
    before = dict(tuf.LAUNCHES)
    src, dst = _edges(2000, 512, 16)
    TStream.from_arrays(src, dst, TConfig(vertex_capacity=512, batch_size=256), device=CPU).aggregate(
        tcc.ConnectedComponents()
    ).collect()
    assert tuf.LAUNCHES == before


# ---------------------------------------------------------------------------
# the example program


@pytest.mark.parametrize(
    "extra",
    [[], ["1000", "--tree"], ["1000", "--ingest-window=4096"], ["--unbounded=3", "--ingest-window=1024"]],
    ids=["default", "tree", "ingest-window", "unbounded"],
)
def test_example_csv_matches_jax_example(tmp_path, extra):
    from gelly_streaming_tpu.examples import connected_components as jex
    from gelly_streaming_tpu_torch.examples import connected_components as tex

    src, dst = _edges(9000, 3000, 17)
    inp = os.path.join(str(tmp_path), "edges.txt")
    with open(inp, "w") as f:
        f.write("".join(f"{s} {d}\n" for s, d in zip(src, dst)))
    jout = os.path.join(str(tmp_path), "jax.csv")
    tout = os.path.join(str(tmp_path), "torch.csv")
    jex.main([inp, jout, *extra])
    tex.main([inp, tout, *extra, "--device=cpu"])
    with open(jout, "rb") as a, open(tout, "rb") as b:
        want = a.read()
        assert b.read() == want and want


def test_example_generated_input_matches_jax(capsys):
    from gelly_streaming_tpu.examples import connected_components as jex
    from gelly_streaming_tpu_torch.examples import connected_components as tex

    jex.main([])
    want = capsys.readouterr().out.splitlines()
    tex.main(["--device=cpu"])
    got = capsys.readouterr().out.splitlines()
    # the usage banner differs by the port's --device flag; the records not
    assert got[0] == want[0] and "--device=cuda|cpu" in got[2]
    assert got[3:] == want[3:] and len(want) > 3


# ids outside [0, C) on the streams that validate nothing: -1, C and C + 5
# at C = 16.  JAX's gather clamps after a negative wrap, so (16, 3) joins 15
# and 3; seen is a scatter, which drops 16 and 21 and marks -1 as 15.
OOR_EDGES = [(1, 2), (16, 3), (-1, 4), (21, 1), (5, -1), (7, 16), (8, 21), (-1, -1), (9, 10), (16, 16)]


@pytest.mark.parametrize("algo", ["ConnectedComponents", "ConnectedComponentsTree"])
@pytest.mark.parametrize("source,bs", [("collection", None), ("batches", 3)])
def test_out_of_range_ids_follow_jax_index_rules(algo, source, bs):
    kw = dict(vertex_capacity=16, max_degree=16)
    if source == "collection":
        t = TStream.from_collection(OOR_EDGES, TConfig(**kw), device=CPU)
        j = JStream.from_collection(OOR_EDGES, JConfig(**kw))
    else:
        src, dst = (np.array([e[k] for e in OOR_EDGES], np.int32) for k in (0, 1))
        t = TStream.from_batches(tsources._batched(src, dst, None, None, None, bs, CPU), TConfig(**kw), device=CPU)
        j = JStream.from_batches(jsources._batched(src, dst, None, None, None, bs), JConfig(**kw))
    t_recs = t.aggregate(getattr(tcc, algo)(window_ms=500)).collect()
    _assert_same_records(t_recs, j.aggregate(getattr(jcc, algo)(window_ms=500)).collect())
    final = t_recs[-1][0]
    assert int(final.parent[15]) == int(final.parent[3]) == 1  # 16 and 21 read entry 15
    assert bool(final.seen[15]) and not bool(final.seen[6])

