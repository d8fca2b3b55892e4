"""Port parity: the binned and compressed ingest of the PyTorch port
against the JAX package (the single-device cases of
tests/test_binned_ingest.py).

With ``binned_ingest`` / ``wire_compress`` (or their env switches) the
port bins each batch or closed pane by (dst, src) and ships compressed
batches as BDV, decoded by ``ops/wire_decode.decode_bdv`` (its plain twin
here, on CPU tensors).  Its records must equal the JAX package's with the
same switches, on the wire path, its running emissions and the sync,
superbatch and async pane planes; a compressed checkpoint must hold the
JAX package's leaves; the wire counters must read the same; the refusals
must be the JAX package's.  Tolerance: none.
"""

import os

import numpy as np
import pytest

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.io import wire as jw
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu.library import degree_distribution as jdd
from gelly_streaming_tpu.utils import metrics as jmetrics
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.io import wire as tw
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.library import degree_distribution as tdd
from gelly_streaming_tpu_torch.ops import wire_decode as tdec
from gelly_streaming_tpu_torch.utils import metrics as tmetrics

# the wire path runs the prefetcher's threads
pytestmark = pytest.mark.timeout_cap(120)

CAP = 1 << 12
N = 1 << 12
BATCH = 1 << 9
CPU = "cpu"
AGGS = {"cc": (jcc.ConnectedComponents, tcc.ConnectedComponents),
        "degrees": (jdd.DegreeDistributionSummary, tdd.DegreeDistributionSummary)}


def _edges(seed=0, n=N, cap=CAP):
    """Hub-heavy dsts (long bins) beside a uniform half (sparse ones)."""
    rng = np.random.default_rng(seed)
    half = n // 2
    src = rng.integers(0, cap, n).astype(np.int32)
    dst = np.concatenate([rng.integers(0, cap, half),
                          (cap * rng.random(n - half) ** 4).astype(np.int64) % cap]).astype(np.int32)
    return src, dst


def _leaves(rec):
    out = []
    for x in rec:
        if hasattr(x, "parent"):
            out += [np.asarray(x.parent), np.asarray(x.seen)]
        else:
            out.append(np.asarray(x))
    return out


def _assert_same(t_recs, j_recs):
    assert len(t_recs) == len(j_recs) > 0
    for t, j in zip(t_recs, j_recs):
        lt, lj = _leaves(t), _leaves(j)
        assert len(lt) == len(lj)
        for a, b in zip(lt, lj):
            np.testing.assert_array_equal(a, b)


def _run(agg, src, dst, **kw):
    j_cls, t_cls = AGGS[agg]
    j = list(j_cls().run(JStream.from_arrays(src, dst, JConfig(vertex_capacity=CAP, batch_size=BATCH, **kw))))
    t = list(t_cls().run(TStream.from_arrays(src, dst, TConfig(vertex_capacity=CAP, batch_size=BATCH, **kw),
                                             device=CPU)))
    return t, j


@pytest.mark.parametrize("agg", sorted(AGGS))
@pytest.mark.parametrize("kw", [dict(binned_ingest=1, wire_encoding="plain"), dict(binned_ingest=1),
                                dict(wire_compress=1), dict(wire_compress=1, superbatch=4),
                                dict(binned_ingest=1, wire_encoding="plain", superbatch=4)],
                         ids=["binned", "binned-auto", "compressed", "compressed-superbatch", "binned-superbatch"])
def test_wire_path_records_match_jax(agg, kw):
    src, dst = _edges()
    tdec.reset_launches()
    t, j = _run(agg, src, dst, **kw)
    _assert_same(t, j)
    _assert_same(t, _run(agg, src, dst)[1])  # the arrival-order records
    if kw.get("wire_compress"):  # every batch through the decode's twin
        assert tdec.TWIN_CALLS["bdv_decode"] == N // BATCH and tdec.LAUNCHES["bdv_decode"] == 0


@pytest.mark.parametrize("agg", sorted(AGGS))
def test_running_emissions_match_jax(agg):
    src, dst = _edges(1)
    t, j = _run(agg, src, dst, ingest_window_edges=BATCH, wire_compress=1)
    assert len(t) == N // BATCH
    _assert_same(t, j)


@pytest.mark.parametrize("agg", sorted(AGGS))
@pytest.mark.parametrize("kw", [dict(binned_ingest=1), dict(binned_ingest=1, superbatch=4),
                                dict(binned_ingest=1, async_windows=2)], ids=["sync", "superbatch", "async"])
def test_pane_planes_match_jax(agg, kw):
    rng = np.random.default_rng(2)
    edges = [(int(s), int(d)) for s, d in zip(rng.integers(0, CAP, 2048), rng.integers(0, CAP, 2048))]
    j_cls, t_cls = AGGS[agg]
    base = dict(vertex_capacity=CAP, batch_size=256, ingest_window_edges=512)
    j = list(j_cls().run(JStream.from_collection(edges, JConfig(**base, **kw), batch_size=256)))
    t = list(t_cls().run(TStream.from_collection(edges, TConfig(**base, **kw), batch_size=256, device=CPU)))
    _assert_same(t, j)


def test_compressed_checkpoint_resume_matches_jax(tmp_path):
    src, dst = _edges(4)
    out = {}
    for side in ("jax", "port"):
        path = str(tmp_path / side)

        def run(restore, side=side, path=path):
            kw = dict(vertex_capacity=CAP, batch_size=BATCH, wire_compress=1, wire_checkpoint_batches=2)
            if side == "jax":
                return list(jcc.ConnectedComponents().run(JStream.from_arrays(src, dst, JConfig(**kw)),
                                                          checkpoint_path=path, restore=restore))
            return list(tcc.ConnectedComponents().run(TStream.from_arrays(src, dst, TConfig(**kw), device=CPU),
                                                      checkpoint_path=path, restore=restore))

        out[side] = (run(False), run(True))  # the second re-emits the done snapshot
    _assert_same(out["port"][0], out["jax"][0])
    _assert_same(out["port"][1], out["jax"][1])
    with np.load(str(tmp_path / "jax.npz")) as a, np.load(str(tmp_path / "port.npz")) as b:
        names = sorted(k for k in a.files if k.startswith("leaf_"))
        assert names == sorted(k for k in b.files if k.startswith("leaf_"))
        for k in names:
            np.testing.assert_array_equal(a[k], b[k])


def test_wire_counters_match_jax():
    src, dst = _edges(8)
    jmetrics.reset_wire_stats()
    tmetrics.reset_wire_stats()
    _run("cc", src, dst, wire_compress=1)
    w, jw_ = tmetrics.wire_stats(), jmetrics.wire_stats()
    assert w == jw_
    assert w["wire_edges_total"] == N and w["wire_batches"] == N // BATCH
    assert 0 < w["wire_bytes_total"] < 8 * N and w["wire_bin_occupancy_hwm"] >= 1
    tmetrics.reset_wire_stats()
    assert tmetrics.wire_stats()["wire_bytes_total"] == 0


def test_config_validation_matches_jax():
    for kw in (dict(binned_ingest=2), dict(wire_compress=-2), dict(wire_compress=1, binned_ingest=0),
               dict(wire_compress=1, vertex_capacity=1 << 29), dict(wire_checkpoint_batches=-1)):
        with pytest.raises(ValueError):
            JConfig(**kw)
        with pytest.raises(ValueError):
            TConfig(**kw)
    assert TConfig().wire_checkpoint_batches == JConfig().wire_checkpoint_batches == 64
    assert TConfig().ingest_workers == JConfig().ingest_workers == 0


def test_env_switch_and_bad_spelling_match_jax(monkeypatch):
    cfgs = (TConfig(vertex_capacity=CAP), JConfig(vertex_capacity=CAP))
    monkeypatch.delenv("GELLY_WIRE_COMPRESS", raising=False)
    monkeypatch.delenv("GELLY_BINNED_INGEST", raising=False)
    for env in (None, "1", "0"):
        if env is not None:
            monkeypatch.setenv("GELLY_WIRE_COMPRESS", env)
        assert tw.resolve_wire_compress(cfgs[0]) == jw.resolve_wire_compress(cfgs[1])
        assert tw.resolve_binned_ingest(cfgs[0]) == jw.resolve_binned_ingest(cfgs[1])
    monkeypatch.setenv("GELLY_WIRE_COMPRESS", "1")
    assert tw.resolve_binned_ingest(cfgs[0])  # compression implies binning
    assert not tw.resolve_wire_compress(TConfig(vertex_capacity=CAP, binned_ingest=0))
    monkeypatch.setenv("GELLY_WIRE_COMPRESS", "0")
    assert tw.resolve_wire_compress(TConfig(vertex_capacity=CAP, wire_compress=1))
    monkeypatch.setenv("GELLY_WIRE_COMPRESS", "definitely")
    with pytest.raises(ValueError, match="GELLY_WIRE_COMPRESS"):
        tw.resolve_wire_compress(cfgs[0])


def test_order_sensitive_descriptor_refuses_forced_binning(monkeypatch):
    class JOrdered(jdd.DegreeDistributionSummary):
        order_free = False

    class TOrdered(tdd.DegreeDistributionSummary):
        order_free = False

    src, dst = _edges(9, n=256)
    for kw in (dict(wire_compress=1), dict(binned_ingest=1)):
        with pytest.raises(ValueError, match="order-free"):
            list(TOrdered().run(TStream.from_arrays(src, dst, TConfig(vertex_capacity=CAP, batch_size=128, **kw),
                                                    device=CPU)))
    # the ambient env switch quietly keeps the arrival order
    monkeypatch.setenv("GELLY_WIRE_COMPRESS", "1")
    t = list(TOrdered().run(TStream.from_arrays(src, dst, TConfig(vertex_capacity=CAP, batch_size=128), device=CPU)))
    j = list(JOrdered().run(JStream.from_arrays(src, dst, JConfig(vertex_capacity=CAP, batch_size=128))))
    _assert_same(t, j)
    # compression yields to an explicit ef40 (loudly when both are forced)
    with pytest.raises(ValueError, match="mutually"):
        tcc.ConnectedComponents()._binned_modes(TConfig(vertex_capacity=CAP, wire_compress=1, wire_encoding="ef40"))
    assert tcc.ConnectedComponents()._binned_modes(TConfig(vertex_capacity=CAP, wire_encoding="ef40")) == (True, False)
    assert os.environ["GELLY_WIRE_COMPRESS"] == "1"
