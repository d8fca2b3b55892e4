"""Port parity: the mesh aggregation plane of the PyTorch port against the
JAX package's mesh runner on the CPU.

The JAX package runs its single-process mesh on the 8 CPU devices the test
configuration forces; the port runs its single-controller mesh over 8 CPU
shards (``parallel/mesh.set_host_device_count``).  Every record
``aggregate()`` emits must be bit-identical: ConnectedComponents (flat and
tree), DegreeDistributionSummary and BipartitenessCheck, at 2 and 8 shards,
on the replicated (``sharded_state=0``) and the owner-sharded plane, over
the wire streaming fold (with a tail, and replayed buffers) and the
windowed plane (tumbling, sliding, late records, ingestion panes, valued
panes, the async pipeline), and the comms counters (the exchanges' rounds,
delta high-water and spills) equal after each run.  The port runs its
kernels' plain twins here.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.io import wire as jwire
from gelly_streaming_tpu.library import bipartiteness as jbp
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu.library import degree_distribution as jdd
from gelly_streaming_tpu.utils import metrics as jmetrics
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.io import wire as twire
from gelly_streaming_tpu_torch.library import bipartiteness as tbp
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.library import degree_distribution as tdd
from gelly_streaming_tpu_torch.ops import routing as trk
from gelly_streaming_tpu_torch.parallel import mesh as tmesh
from gelly_streaming_tpu_torch.utils import metrics as tmetrics

pytestmark = pytest.mark.timeout_cap(120)

CPU = "cpu"

ALGOS = {
    "cc": (jcc.ConnectedComponents, tcc.ConnectedComponents),
    "cc_tree": (jcc.ConnectedComponentsTree, tcc.ConnectedComponentsTree),
    "degree": (jdd.DegreeDistributionSummary, tdd.DegreeDistributionSummary),
    "bipartite": (jbp.BipartitenessCheck, tbp.BipartitenessCheck),
}


@pytest.fixture(autouse=True)
def host_shards():
    """8 CPU shards for the port (the JAX package's forced devices)."""
    old = tmesh.set_host_device_count(8)
    jmetrics.reset_comms_stats()
    tmetrics.reset_comms_stats()
    yield
    tmesh.set_host_device_count(old)


def _edges(n, cap, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)


def _timed(n, cap, seed, span_ms=3000):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, span_ms, n))
    s, d = _edges(n, cap, seed)
    return [(int(s[i]), int(d[i]), 0.0, int(t[i])) for i in range(n)]


def _array(x):
    for name in ("parent", "parent2"):
        if hasattr(x, name):
            return getattr(x, name)
    return x


def _as_np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_same(t_recs, j_recs, min_len=1):
    assert len(t_recs) == len(j_recs) >= min_len
    for (t,), (j,) in zip(t_recs, j_recs):
        np.testing.assert_array_equal(_as_np(_array(t)), _as_np(_array(j)))
        if hasattr(j, "seen"):
            np.testing.assert_array_equal(_as_np(t.seen), _as_np(j.seen))
            assert str(t) == str(j)


def assert_same_comms():
    assert tmetrics.comms_stats() == jmetrics.comms_stats()


def _cfgs(**kw):
    return JConfig(**kw), TConfig(**kw)


# (algo, shards, sharded_state): every algorithm on both planes at S = 2
# (bipartiteness has no sharded spec, so its sharded_state=1 case holds it
# to the replicated plane), and both planes at S = 8 for the two sharded
# specs; each case costs a JAX compile of its own
PLANE_CASES = [(algo, 2, sharded) for algo in sorted(ALGOS) for sharded in (0, 1)] + [
    (algo, 8, sharded) for algo in ("cc", "degree") for sharded in (0, 1)]


def _run(algo, jstream, tstream, window_ms=None, **kw):
    jcls, tcls = ALGOS[algo]
    args = {} if window_ms is None else {"window_ms": window_ms}
    j = jstream.aggregate(jcls(**args), **kw).collect()
    t = tstream.aggregate(tcls(**args), **kw).collect()
    return t, j


# ---------------------------------------------------------------------------
# the wire streaming fold


@pytest.mark.parametrize("algo,shards,sharded", PLANE_CASES)
def test_wire_stream_with_tail_matches_jax(shards, sharded, algo):
    src, dst = _edges(1500, 128, 10 + shards)  # 1500 = 5 full rows of 256 + a tail at S = 2
    jc, tc = _cfgs(vertex_capacity=128, batch_size=512, num_shards=shards, sharded_state=sharded)
    t, j = _run(algo, JStream.from_arrays(src, dst, jc), TStream.from_arrays(src, dst, tc, device=CPU))
    assert_same(t, j)
    assert_same_comms()
    if sharded and algo != "bipartite":
        assert tmetrics.comms_stats()["comms_dispatches"] > 0


@pytest.mark.parametrize("sharded", [0, 1])
def test_wire_replay_with_tail_matches_jax(sharded):
    src, dst = _edges(700, 64, 3)
    jc, tc = _cfgs(vertex_capacity=64, batch_size=128, num_shards=4, sharded_state=sharded)
    width = 2
    jbufs, jtail = jwire.pack_stream(src, dst, 128, width)
    tbufs, ttail = twire.pack_stream(src, dst, 128, width)
    t, j = _run("cc", JStream.from_wire(jbufs, 128, width, jc, tail=jtail),
                TStream.from_wire(tbufs, 128, width, tc, tail=ttail, device=CPU))
    assert_same(t, j)
    assert_same_comms()


def test_wire_fewer_edges_than_shards_and_empty_stream():
    for n in (0, 3):
        src, dst = _edges(n, 32, 5)
        jc, tc = _cfgs(vertex_capacity=32, batch_size=16, num_shards=8)
        t, j = _run("cc", JStream.from_arrays(src, dst, jc), TStream.from_arrays(src, dst, tc, device=CPU))
        assert len(t) == len(j)
        if n:
            assert_same(t, j)


def test_wire_ef40_rows_match_jax():
    src, dst = _edges(2000, 1024, 6)
    jc, tc = _cfgs(vertex_capacity=1024, batch_size=1024, num_shards=4, wire_encoding="ef40")
    t, j = _run("cc", JStream.from_arrays(src, dst, jc), TStream.from_arrays(src, dst, tc, device=CPU))
    assert_same(t, j)
    assert_same_comms()


# ---------------------------------------------------------------------------
# the windowed plane


@pytest.mark.parametrize("algo,shards,sharded", PLANE_CASES)
def test_windowed_tumbling_matches_jax(shards, sharded, algo):
    # C = 4096 over few-hundred-edge panes: the owner-sharded plane's
    # exchanges take the delta regime (the capacity stays below C/S)
    edges = _timed(900, 4096 if algo != "bipartite" else 64, 20 + shards)
    jc, tc = _cfgs(vertex_capacity=4096, num_shards=shards, sharded_state=sharded)
    t, j = _run(algo, JStream.from_collection(edges, jc, 64, with_time=True),
                TStream.from_collection(edges, tc, 64, with_time=True, device=CPU), window_ms=500)
    assert_same(t, j, min_len=5)
    assert_same_comms()


@pytest.mark.parametrize("algo", ["cc", "degree"])
def test_windowed_dense_regime_matches_jax(algo):
    # a small id space: the pane's delta bound reaches C/S, dense slabs
    edges = _timed(600, 32, 7)
    jc, tc = _cfgs(vertex_capacity=32, num_shards=4)
    t, j = _run(algo, JStream.from_collection(edges, jc, 32, with_time=True),
                TStream.from_collection(edges, tc, 32, with_time=True, device=CPU), window_ms=500)
    assert_same(t, j, min_len=5)
    assert_same_comms()
    assert tmetrics.comms_stats()["comms_exchange_rounds"] > 0


@pytest.mark.parametrize("sharded", [0, 1])
@pytest.mark.parametrize("algo", ["cc", "degree"])
def test_sliding_windows_match_jax(sharded, algo):
    from gelly_streaming_tpu.core.aggregation import MeshAggregationRunner as JRunner
    from gelly_streaming_tpu.core.windows import windowed_panes as jpanes
    from gelly_streaming_tpu_torch.core.aggregation import MeshAggregationRunner as TRunner
    from gelly_streaming_tpu_torch.core.windows import windowed_panes as tpanes
    from gelly_streaming_tpu.parallel.mesh import make_mesh as jmake

    edges = _timed(300, 256, 8, span_ms=4000)
    jc, tc = _cfgs(vertex_capacity=256, num_shards=8, sharded_state=sharded)
    jcls, tcls = ALGOS[algo]
    js = JStream.from_collection(edges, jc, 16, with_time=True)
    ts = TStream.from_collection(edges, tc, 16, with_time=True, device=CPU)
    j = JRunner(jcls(), jmake(8)).run(js, panes=lambda: jpanes(js, 1000, 500)).collect()
    t = TRunner(tcls(), tmesh.make_mesh(8, tmesh.local_devices(CPU))).run(
        ts, panes=lambda: tpanes(ts, 1000, 500)).collect()
    assert_same(t, j, min_len=4)
    assert_same_comms()


def test_late_records_match_jax():
    edges = _timed(200, 128, 9, span_ms=4000)
    edges[40] = (edges[40][0], edges[40][1], 0.0, edges[39][3] - 900)
    late = edges.pop(30)
    edges.insert(60, late)
    jc, tc = _cfgs(vertex_capacity=128, num_shards=8, out_of_orderness_ms=1000)
    t, j = _run("cc", JStream.from_collection(edges, jc, 8, with_time=True),
                TStream.from_collection(edges, tc, 8, with_time=True, device=CPU), window_ms=1000)
    assert_same(t, j, min_len=3)
    assert_same_comms()


@pytest.mark.parametrize("algo,sharded,binned", [("cc", 0, 0), ("cc", 1, 1), ("degree", 0, 0), ("degree", 1, 0),
                                                 ("degree", 1, 1)])
def test_ingestion_panes_match_jax(algo, sharded, binned):
    # value-less panes ride packed wire rows: round robin for CC, the
    # degree summary's src keyBy (host_route, or parallel_host_route with
    # binned ingest on) on the owner-sharded plane
    src, dst = _edges(600, 128, 11)
    jc, tc = _cfgs(vertex_capacity=128, batch_size=32, num_shards=4, ingest_window_edges=64, sharded_state=sharded,
                   binned_ingest=binned, ingest_workers=2)
    t, j = _run(algo, JStream.from_arrays(src, dst, jc), TStream.from_arrays(src, dst, tc, device=CPU))
    assert_same(t, j, min_len=8)
    assert_same_comms()


@pytest.mark.parametrize("algo", ["cc", "degree"])
def test_untimed_value_less_collection_matches_jax(algo):
    src, dst = _edges(300, 512, 12)
    edges = list(zip(src.tolist(), dst.tolist()))
    jc, tc = _cfgs(vertex_capacity=512, num_shards=8)
    t, j = _run(algo, JStream.from_collection(edges, jc, 32), TStream.from_collection(edges, tc, 32, device=CPU))
    assert_same(t, j)
    assert_same_comms()


def test_async_windows_match_jax_on_sharded_plane():
    edges = _timed(300, 512, 13)
    jc, tc = _cfgs(vertex_capacity=512, num_shards=8, async_windows=3)
    t, j = _run("cc", JStream.from_collection(edges, jc, 16, with_time=True),
                TStream.from_collection(edges, tc, 16, with_time=True, device=CPU), window_ms=300)
    assert_same(t, j, min_len=5)
    assert_same_comms()


@pytest.mark.parametrize("algo", ["cc", "degree"])
def test_spilled_exchanges_match_jax(algo, monkeypatch):
    """A delta bound of one row forces one-slot buffers: the exchanges spill
    and retry, with the rounds, high-water and spills the JAX plane counts."""
    for spec in (jcc.CCShardedState, tcc.CCShardedState, jdd.DegreeShardedState, tdd.DegreeShardedState):
        monkeypatch.setattr(spec, "delta_bound", lambda self, cfg, n: 1)
    edges = _timed(200, 256, 14)
    jc, tc = _cfgs(vertex_capacity=256, num_shards=4)
    t, j = _run(algo, JStream.from_collection(edges, jc, 16, with_time=True),
                TStream.from_collection(edges, tc, 16, with_time=True, device=CPU), window_ms=1000)
    assert_same(t, j, min_len=2)
    assert_same_comms()
    stats = tmetrics.comms_stats()
    assert stats["comms_delta_spilled"] > 0 and stats["comms_exchange_rounds"] > 2


def test_transient_descriptor_resets_blocks_a_window():
    class JTransient(jcc.ConnectedComponents):
        transient_state = True

    class TTransient(tcc.ConnectedComponents):
        transient_state = True

    edges = _timed(150, 128, 15)
    for sharded in (0, 1):
        jc, tc = _cfgs(vertex_capacity=128, num_shards=4, sharded_state=sharded)
        j = JStream.from_collection(edges, jc, 16, with_time=True).aggregate(JTransient(window_ms=500)).collect()
        t = TStream.from_collection(edges, tc, 16, with_time=True, device=CPU).aggregate(
            TTransient(window_ms=500)).collect()
        assert_same(t, j, min_len=4)


# ---------------------------------------------------------------------------
# routing of aggregate()


def test_more_shards_than_devices_takes_the_simulated_path():
    src, dst = _edges(400, 64, 16)
    jc, tc = _cfgs(vertex_capacity=64, batch_size=64, num_shards=16)
    t, j = _run("cc", JStream.from_arrays(src, dst, jc), TStream.from_arrays(src, dst, tc, device=CPU))
    assert_same(t, j)
    assert tmetrics.comms_stats()["comms_dispatches"] == 0
    trk.reset_launches()
    tmesh.set_host_device_count(1)
    t1 = TStream.from_arrays(src, dst, TConfig(vertex_capacity=64, batch_size=64, num_shards=4),
                             device=CPU).aggregate(tcc.ConnectedComponents()).collect()
    assert_same(t1, j)
    assert sum(trk.TWIN_CALLS.values()) == 0  # no mesh collective ran


def test_sketch_on_the_sharded_mesh_raises_and_replicates_when_off():
    from gelly_streaming_tpu.library import sketches as jsk
    from gelly_streaming_tpu_torch.library import sketches as tsk

    src, dst = _edges(500, 256, 17)
    tc = TConfig(vertex_capacity=256, batch_size=128, num_shards=4)
    with pytest.raises(NotImplementedError, match="A.7"):
        TStream.from_arrays(src, dst, tc, device=CPU).aggregate(tsk.HLLDegreeSummary(0.05, 0.01)).collect()
    jc, tc = _cfgs(vertex_capacity=256, batch_size=128, num_shards=4, sharded_state=0)
    j = JStream.from_arrays(src, dst, jc).aggregate(jsk.HLLDegreeSummary(0.05, 0.01)).collect()
    t = TStream.from_arrays(src, dst, tc, device=CPU).aggregate(tsk.HLLDegreeSummary(0.05, 0.01)).collect()
    assert len(t) == len(j) == 1
    for a, b in zip(t[0], j[0]):
        np.testing.assert_array_equal(_as_np(a), np.asarray(b))


def test_host_syncs_are_one_a_device_a_round():
    edges = _timed(300, 4096, 18)
    tc = TConfig(vertex_capacity=4096, num_shards=4)
    tmesh.HOST_SYNCS["reads"] = 0
    TStream.from_collection(edges, tc, 16, with_time=True, device=CPU).aggregate(
        tcc.ConnectedComponents(window_ms=500)).collect()
    stats = tmetrics.comms_stats()
    # every label round reads once (one device), and each exchange adds its
    # seen passes' reads
    assert stats["comms_exchange_rounds"] <= tmesh.HOST_SYNCS["reads"]
    assert tmesh.HOST_SYNCS["reads"] <= stats["comms_exchange_rounds"] + 2 * stats["comms_dispatches"]


def test_config_sharded_state_validation():
    with pytest.raises(ValueError, match="sharded_state"):
        TConfig(sharded_state=2)
    assert dataclasses.replace(TConfig(), sharded_state=0).sharded_state == 0


@pytest.mark.parametrize("capacity,regime", [(4096, "delta"), (32, "dense")])
def test_runner_records_each_exchange_regime(capacity, regime):
    """The runner counts its exchanges by the regime the spec took, with
    the delta capacity: one a pane on the windowed plane."""
    from gelly_streaming_tpu_torch.core.aggregation import MeshAggregationRunner

    edges = _timed(600, capacity, 7)
    cfg = TConfig(vertex_capacity=capacity, num_shards=4)
    runner = MeshAggregationRunner(tcc.ConnectedComponents(window_ms=500), tmesh.make_mesh(4, tmesh.local_devices(CPU)))
    runner.run(TStream.from_collection(edges, cfg, 32, with_time=True, device=CPU)).collect()
    dispatches = tmetrics.comms_stats()["comms_dispatches"]
    assert dispatches >= 5 and sum(runner.exchange_regimes.values()) == dispatches
    assert all(k.startswith(f"{regime} (delta_cap ") for k in runner.exchange_regimes)
    if regime == "dense":
        assert set(runner.exchange_regimes) == {f"dense (delta_cap {capacity // 4})"}
