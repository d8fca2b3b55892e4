"""Port parity: kill and resume on the mesh plane of the PyTorch port against
the JAX package's mesh runner on the CPU (8 forced JAX devices, 8 port CPU
shards).

A windowed run killed after its second record resumes from the same
position and re-emits the same records as the JAX run killed at the same
point, on both planes.  A wire streaming fold killed at its final record
leaves the last mid-stream snapshot: its leaves (owner blocks or the
stacked carry, stage states, group position) equal the JAX snapshot's,
and the resume over a poisoned prefix reaches the full run's labels (the
restored position is used, nothing before it is refolded).  The port also
resumes from the JAX-written snapshot (``interop.snapshot_from_jax``).
"""

import os

import numpy as np
import pytest

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu.library import degree_distribution as jdd
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.library import degree_distribution as tdd
from gelly_streaming_tpu_torch.parallel import mesh as tmesh
from gelly_streaming_tpu_torch.utils import checkpoint as tckpt
from gelly_streaming_tpu_torch.utils import metrics as tmetrics

pytestmark = pytest.mark.timeout_cap(120)

CPU = "cpu"


@pytest.fixture(autouse=True)
def host_shards():
    old = tmesh.set_host_device_count(8)
    yield
    tmesh.set_host_device_count(old)


def _edges(n, cap, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)


def _timed(n, cap, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.integers(0, 3000, n))
    s, d = _edges(n, cap, seed)
    return [(int(s[i]), int(d[i]), 0.0, int(t[i])) for i in range(n)]


def _key(rec):
    x = rec[0]
    return str(x) if hasattr(x, "parent") else np.asarray(x).tolist()


def _kill_after(it_src, k):
    it = iter(it_src)
    out = [_key(next(it)) for _ in range(k)]
    it.close()
    return out


@pytest.mark.parametrize("sharded", [0, 1])
@pytest.mark.parametrize("algo", ["cc", "degree"])
def test_windowed_kill_and_resume_matches_jax(tmp_path, sharded, algo):
    edges = _timed(240, 512, 3)
    kw = dict(vertex_capacity=512, num_shards=8, sharded_state=sharded)
    jcls, tcls = (jcc.ConnectedComponents, tcc.ConnectedComponents) if algo == "cc" else (
        jdd.DegreeDistributionSummary, tdd.DegreeDistributionSummary)
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")

    def jrun():
        return JStream.from_collection(edges, JConfig(**kw), 16, with_time=True).aggregate(
            jcls(window_ms=500), checkpoint_path=jp)

    def trun():
        return TStream.from_collection(edges, TConfig(**kw), 16, with_time=True, device=CPU).aggregate(
            tcls(window_ms=500), checkpoint_path=tp)

    assert _kill_after(trun(), 2) == _kill_after(jrun(), 2)
    j_snap, t_snap = np.load(jp), np.load(tp)
    for name in j_snap.files:
        if name.startswith("leaf_"):
            np.testing.assert_array_equal(t_snap[name], j_snap[name])
    resumed_t = [_key(r) for r in trun().collect()]
    resumed_j = [_key(r) for r in jrun().collect()]
    assert resumed_t == resumed_j and len(resumed_t) >= 4


def _wire_kw(sharded):
    return dict(vertex_capacity=256, batch_size=64, num_shards=4, wire_checkpoint_batches=20, sharded_state=sharded)


def _killed_wire(stream, agg, path):
    it = iter(stream.aggregate(agg, checkpoint_path=path))
    next(it)  # the final record: the final snapshot is never written
    it.close()


@pytest.mark.parametrize("sharded", [0, 1])
def test_wire_kill_and_resume_matches_jax(tmp_path, sharded):
    src, dst = _edges(1000, 256, 4)
    kw = _wire_kw(sharded)
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    full = JStream.from_arrays(src, dst, JConfig(**kw)).aggregate(jcc.ConnectedComponents()).collect()
    _killed_wire(JStream.from_arrays(src, dst, JConfig(**kw)), jcc.ConnectedComponents(), jp)
    _killed_wire(TStream.from_arrays(src, dst, TConfig(**kw), device=CPU), tcc.ConnectedComponents(), tp)
    j_snap, t_snap = np.load(jp), np.load(tp)
    leaves = [n for n in j_snap.files if n.startswith("leaf_")]
    assert sorted(leaves) == sorted(n for n in t_snap.files if n.startswith("leaf_"))
    for name in leaves:
        np.testing.assert_array_equal(t_snap[name], j_snap[name])
    garbled = src.copy()
    garbled[:512] = 0  # poison the folded prefix: a refold would change the labels
    tmetrics.reset_comms_stats()
    resumed = TStream.from_arrays(garbled, dst, TConfig(**kw), device=CPU).aggregate(
        tcc.ConnectedComponents(), checkpoint_path=tp).collect()
    assert str(resumed[-1][0]) == str(full[-1][0])
    if sharded:
        # 1000 edges in rows of 16: 63 rows, 16 groups of 4; a snapshot every
        # 5 groups, the last after group 15, leaves one group to fold
        assert tmetrics.comms_stats()["comms_dispatches"] == 1
    # a done snapshot re-emits from the saved state, at least once
    again = TStream.from_arrays(garbled, dst, TConfig(**kw), device=CPU).aggregate(
        tcc.ConnectedComponents(), checkpoint_path=tp).collect()
    assert str(again[-1][0]) == str(full[-1][0])


@pytest.mark.parametrize("sharded", [0, 1])
def test_port_resumes_from_a_jax_mesh_wire_snapshot(tmp_path, sharded):
    from gelly_streaming_tpu_torch.core.aggregation import MeshAggregationRunner

    src, dst = _edges(1000, 256, 5)
    kw = _wire_kw(sharded)
    jp, tp = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    full = JStream.from_arrays(src, dst, JConfig(**kw)).aggregate(jcc.ConnectedComponents()).collect()
    _killed_wire(JStream.from_arrays(src, dst, JConfig(**kw)), jcc.ConnectedComponents(), jp)
    stream = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
    runner = MeshAggregationRunner(tcc.ConnectedComponents(), tmesh.make_mesh(4, tmesh.local_devices(CPU)))
    row_len = runner._wire_mesh_plan(stream)[2]
    spec = runner._sharded_spec(stream.cfg)
    like = (runner._wire_sharded_checkpoint_like(stream, spec, row_len) if spec is not None
            else runner._wire_mesh_checkpoint_like(stream, row_len))
    state = interop.snapshot_from_jax(jp, like)
    assert int(state["next_group"]) == 15 and not bool(state["done"])  # 16 groups, the last snapshot after 15
    tckpt.save_state(tp, state)
    garbled = src.copy()
    garbled[:512] = 0
    resumed = TStream.from_arrays(garbled, dst, TConfig(**kw), device=CPU).aggregate(
        tcc.ConnectedComponents(), checkpoint_path=tp).collect()
    assert str(resumed[-1][0]) == str(full[-1][0])
    np.testing.assert_array_equal(resumed[-1][0].parent.numpy(), np.asarray(full[-1][0].parent))


def test_wire_checkpoint_geometry_mismatch_raises(tmp_path):
    src, dst = _edges(600, 256, 6)
    tp = str(tmp_path / "t.npz")
    TStream.from_arrays(src, dst, TConfig(**_wire_kw(1)), device=CPU).aggregate(
        tcc.ConnectedComponents(), checkpoint_path=tp).collect()
    other = dict(_wire_kw(1), batch_size=128)
    with pytest.raises(ValueError, match="row_len"):
        TStream.from_arrays(src, dst, TConfig(**other), device=CPU).aggregate(
            tcc.ConnectedComponents(), checkpoint_path=tp).collect()
    assert os.path.exists(tp)
