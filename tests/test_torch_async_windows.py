"""Port parity: the asynchronous window pipeline of the PyTorch port against
the JAX package on the CPU.

``cfg.async_windows`` (or ``GELLY_ASYNC_WINDOWS``) puts the windowed planes
on ``core/async_exec.py``: panes packed on the prefetcher's pack thread,
uploads overlapped, folds dispatched without waiting, records drained in
window order.  Every case here runs the port on ``device="cpu"`` with the
pipeline on and holds its records against the JAX package's on the same
numpy-seeded inputs (and against the port's own synchronous path); the
cases mirror tests/test_async_windows.py where they need no checkpoint or
mesh.  Then the engine's units: depth resolution, the arena pool, the
counters, the drain's wait target, and a record's isolation from later
in-place combines.

The threaded tests carry ``timeout_cap`` (tests/conftest.py): a hung
completion queue must fail the test, not wedge the run.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import async_exec as jasync
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.core.types import EdgeBatch as JBatch
from gelly_streaming_tpu.core.types import EdgeDirection as JDir
from gelly_streaming_tpu.library import bipartiteness as jbp
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu.library import degree_distribution as jdd
from gelly_streaming_tpu.library.triangles import window_triangles as jwindow_triangles
from gelly_streaming_tpu_torch.core import async_exec
from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.core.types import EdgeBatch as TBatch
from gelly_streaming_tpu_torch.core.types import EdgeDirection as TDir
from gelly_streaming_tpu_torch.library import bipartiteness as tbp
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.library import degree_distribution as tdd
from gelly_streaming_tpu_torch.library.triangles import window_triangles as twindow_triangles
from gelly_streaming_tpu_torch.utils import metrics

pytestmark = pytest.mark.timeout_cap(300)

CPU = "cpu"
KW = dict(vertex_capacity=64, max_degree=16)
ASYNC = dict(KW, async_windows=3)


@pytest.fixture(autouse=True)
def _no_env_depth(monkeypatch):
    # each case sets its depth by config unless it tests the env var
    monkeypatch.delenv("GELLY_ASYNC_WINDOWS", raising=False)


def _timed_edges(n=240, tmax=2400, seed=0, valued=False):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 64, n)
    dst = rng.integers(0, 64, n)
    t = np.sort(rng.integers(0, tmax, n))
    return [(int(a), int(b), float(a + b) if valued else 0, int(ts)) for a, b, ts in zip(src, dst, t)]


def _streams(edges, kw, batch_size=16):
    return (
        TStream.from_collection(edges, TConfig(**kw), batch_size=batch_size, with_time=True, device=CPU),
        JStream.from_collection(edges, JConfig(**kw), batch_size=batch_size, with_time=True),
    )


def _cc_records(stream, mod, window_ms=100):
    return stream.aggregate(mod.ConnectedComponents(window_ms=window_ms)).collect()


def _assert_same_cc(t_recs, j_recs):
    assert len(t_recs) == len(j_recs) > 0
    for (t,), (j,) in zip(t_recs, j_recs):
        np.testing.assert_array_equal(t.parent.numpy(), np.asarray(j.parent))
        np.testing.assert_array_equal(t.seen.numpy(), np.asarray(j.seen))
        assert str(t) == str(j)


def _cc_parity(edges, kw, window_ms=100, min_windows=1):
    """The port with ``kw`` against the JAX package with ``kw`` and against
    the port's synchronous path."""
    t, j = _streams(edges, kw)
    t_recs = _cc_records(t, tcc, window_ms)
    _assert_same_cc(t_recs, _cc_records(j, jcc, window_ms))
    sync_kw = {k: v for k, v in kw.items() if k not in ("async_windows", "superbatch")}
    sync = _cc_records(_streams(edges, sync_kw)[0], tcc, window_ms)
    assert [str(r[0]) for r in t_recs] == [str(r[0]) for r in sync]
    assert len(t_recs) >= min_windows
    return t_recs


# ---------------------------------------------------------------------------
# records against the JAX package


def test_event_time_windows_match_jax():
    _cc_parity(_timed_edges(), ASYNC, min_windows=10)


def test_ingestion_pane_windows_match_jax():
    untimed = [e[:3] for e in _timed_edges(n=200, seed=1)]
    kw = dict(ASYNC, ingest_window_edges=48)
    t = TStream.from_collection(untimed, TConfig(**kw), batch_size=16, device=CPU)
    j = JStream.from_collection(untimed, JConfig(**kw), batch_size=16)
    t_recs = _cc_records(t, tcc)
    _assert_same_cc(t_recs, _cc_records(j, jcc))
    assert len(t_recs) >= 4


def test_empty_and_partial_windows_match_jax():
    # long gaps leave windows empty; singleton windows take the 1-edge bucket
    edges = [(1, 2, 0, 10), (3, 4, 0, 950), (2, 3, 0, 2000), (5, 6, 0, 2010), (6, 7, 0, 5000)]
    _cc_parity(edges, ASYNC, min_windows=4)


def test_valued_stream_windows_match_jax():
    _cc_parity(_timed_edges(valued=True, seed=3), ASYNC, min_windows=10)


@pytest.mark.parametrize("plane", [dict(async_windows=3), dict(superbatch=4), dict(superbatch=4, async_windows=3)])
def test_superbatch_and_async_planes_match_jax(plane):
    _cc_parity(_timed_edges(seed=4), dict(KW, **plane), min_windows=10)


@pytest.mark.parametrize("plane", [dict(async_windows=2), dict(superbatch=3), dict(superbatch=4, async_windows=2)])
def test_bipartiteness_and_degree_summary_planes_match_jax(plane):
    edges = _timed_edges(n=300, seed=14)
    t, j = _streams(edges, dict(KW, **plane))
    t_recs = t.aggregate(tbp.BipartitenessCheck(window_ms=200)).collect()
    j_recs = j.aggregate(jbp.BipartitenessCheck(window_ms=200)).collect()
    assert len(t_recs) == len(j_recs) >= 10
    for (a,), (b,) in zip(t_recs, j_recs):
        np.testing.assert_array_equal(a.parent2.numpy(), np.asarray(b.parent2))
        assert str(a) == str(b)
    t, j = _streams(edges, dict(KW, **plane))
    t_recs = t.aggregate(tdd.DegreeDistributionSummary(window_ms=200)).collect()
    j_recs = j.aggregate(jdd.DegreeDistributionSummary(window_ms=200)).collect()
    assert len(t_recs) == len(j_recs) >= 10
    for (a,), (b,) in zip(t_recs, j_recs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_round_robin_partitions_with_async_match_jax():
    # num_shards > 1 folds the partitions one after another inside the async Merger
    _cc_parity(_timed_edges(seed=5), dict(ASYNC, num_shards=4), window_ms=200, min_windows=5)


def test_late_records_routed_identically():
    rng = np.random.default_rng(6)
    t_ms = rng.integers(0, 1200, 200)
    edges = [(int(a), int(b), 0, int(ts)) for a, b, ts in zip(rng.integers(0, 64, 200), rng.integers(0, 64, 200), t_ms)]
    kw = dict(ASYNC, out_of_orderness_ms=150)

    def run(stream, mod):
        late = []

        def sink(src, dst, val, time):
            late.extend((int(s), int(d), int(tt)) for s, d, tt in zip(src, dst, time))

        recs = _cc_records(stream.on_late(sink), mod)
        return recs, late

    t, j = _streams(edges, kw)
    t_recs, t_late = run(t, tcc)
    j_recs, j_late = run(j, jcc)
    _assert_same_cc(t_recs, j_recs)
    assert t_late == j_late
    assert len(t_late) > 0, "the fixture must produce late records"


def test_window_triangles_async_matches_jax():
    edges = _timed_edges(n=300, seed=7)
    t, j = _streams(edges, ASYNC)
    got = twindow_triangles(t, 200).collect()
    assert got == jwindow_triangles(j, 200).collect()
    assert got == twindow_triangles(_streams(edges, KW)[0], 200).collect()
    assert any(c > 0 for c, _ in got)


def test_sliding_window_triangles_async_matches_jax():
    edges = _timed_edges(n=300, seed=8)
    t, j = _streams(edges, ASYNC)
    got = twindow_triangles(t, 400, slide_ms=200).collect()
    assert got == jwindow_triangles(j, 400, slide_ms=200).collect()
    assert got == twindow_triangles(_streams(edges, KW)[0], 400, slide_ms=200).collect()


def test_snapshot_plane_async_matches_jax():
    edges = _timed_edges(n=200, seed=9, valued=True)
    t, j = _streams(edges, ASYNC)
    got = [(int(k), float(v)) for k, v in t.slice(200, TDir.OUT).reduce_on_edges(lambda a, b: a + b).collect()]
    want = [(int(k), float(v)) for k, v in j.slice(200, JDir.OUT).reduce_on_edges(lambda a, b: a + b).collect()]
    assert got == want
    sync = _streams(edges, KW)[0].slice(200, TDir.OUT).reduce_on_edges(lambda a, b: a + b).collect()
    assert got == [(int(k), float(v)) for k, v in sync]
    assert len(got) > 20


def test_async_error_still_delivers_prior_windows():
    """A source failure mid-stream: the windows closed before it are
    delivered, then the error surfaces, as in the JAX package."""

    def make(batch_cls, stream_cls, cfg, device_kw):
        rng = np.random.default_rng(10)

        def factory():
            for i in range(8):
                if i == 5:
                    raise RuntimeError("source died")
                yield batch_cls.from_arrays(
                    rng.integers(0, 64, 16).astype(np.int32),
                    rng.integers(0, 64, 16).astype(np.int32),
                    time=np.full(16, i * 100 + 50),
                    **device_kw,
                )

        return stream_cls.from_batches(factory, cfg, **device_kw)

    def run(stream, mod):
        recs = []
        with pytest.raises(RuntimeError, match="source died"):
            for r in stream.aggregate(mod.ConnectedComponents(window_ms=100)):
                recs.append(r)
        return recs

    t_recs = run(make(TBatch, TStream, TConfig(**ASYNC), {"device": CPU}), tcc)
    _assert_same_cc(t_recs, run(make(JBatch, JStream, JConfig(**ASYNC), {}), jcc))
    assert len(t_recs) == 4  # windows 0..3 closed before batch 5's failure


def test_env_var_switches_pipeline_on(monkeypatch):
    edges = _timed_edges(seed=12)
    sync = _cc_records(_streams(edges, KW)[0], tcc)
    monkeypatch.setenv("GELLY_ASYNC_WINDOWS", "3")
    metrics.reset_pipeline_stats()
    t, j = _streams(edges, KW)
    t_recs = _cc_records(t, tcc)
    assert metrics.pipeline_stats()["pipeline_windows_dispatched"] == len(t_recs) > 0
    _assert_same_cc(t_recs, _cc_records(j, jcc))
    assert [str(r[0]) for r in t_recs] == [str(r[0]) for r in sync]


# ---------------------------------------------------------------------------
# the engine's units


def test_resolve_depth_precedence_matches_jax(monkeypatch):
    for env in (None, "5", "nonsense", "-2"):
        if env is None:
            monkeypatch.delenv("GELLY_ASYNC_WINDOWS", raising=False)
        else:
            monkeypatch.setenv("GELLY_ASYNC_WINDOWS", env)
        for depth in (0, 3):
            got = async_exec.resolve_depth(TConfig(async_windows=depth))
            assert got == jasync.resolve_depth(JConfig(async_windows=depth))
    monkeypatch.setenv("GELLY_ASYNC_WINDOWS", "5")
    assert async_exec.resolve_depth(TConfig()) == 5
    assert async_exec.resolve_depth(TConfig(**ASYNC)) == 3  # explicit config wins


def test_async_windows_validation():
    with pytest.raises(ValueError):
        TConfig(async_windows=-1)
    with pytest.raises(ValueError):
        JConfig(async_windows=-1)


def test_pipeline_metrics_populate():
    metrics.reset_pipeline_stats()
    recs = _cc_records(_streams(_timed_edges(seed=13), ASYNC)[0], tcc)
    stats = metrics.pipeline_stats()
    assert stats["pipeline_windows_dispatched"] == stats["pipeline_windows_drained"] == len(recs) > 0
    # depth 3: the completion queue must have filled past 1
    assert stats["pipeline_inflight_high_water"] >= 2
    assert set(stats) >= set(jasync.metrics.pipeline_stats())
    metrics.reset_pipeline_stats()
    assert metrics.pipeline_stats()["pipeline_windows_dispatched"] == 0


def test_arena_pool_recycles_and_caps():
    pool = async_exec.ArenaPool(per_shape=2)
    a = pool.acquire((8,), torch.int32)
    a[:] = 7
    pool.release(a)
    b = pool.acquire((8,), torch.int32)
    assert b is a, "a released arena must be recycled"
    assert not b.any(), "a recycled arena must come back zeroed"
    c = pool.acquire((8,), torch.int32)
    d = pool.acquire((8,), torch.int32)
    pool.release(b, c, d)  # cap 2: one of the three is dropped
    assert len(pool._free[((8,), torch.int32)]) == 2
    e = pool.acquire((8,), torch.bool)  # shape and dtype classes do not mix
    assert e.dtype == torch.bool and e is not b and e is not c


def test_arena_pool_never_blocks():
    """The pool hands out fresh tensors past its retention cap instead of
    blocking: a blocking pool could deadlock the pack thread against the
    drain that would release arenas."""
    pool = async_exec.ArenaPool(per_shape=1)
    bufs = [pool.acquire((4,), torch.int32) for _ in range(16)]
    assert len({id(b) for b in bufs}) == 16


def test_drain_waits_on_fold_output_not_record(monkeypatch):
    """The drain's arena-release wait targets the fold's output (a state of
    tensors), not the record: CC's record is a DisjointSet wrapper."""
    waited = []
    real = async_exec.wait_ready

    def spy(fetch):
        waited.append(fetch)
        return real(fetch)

    monkeypatch.setattr(async_exec, "wait_ready", spy)
    # a batch misaligned to the window keeps the stream off the wire path
    kw = dict(vertex_capacity=64, batch_size=24, ingest_window_edges=32, async_windows=2)
    rng = np.random.default_rng(5)
    src = rng.integers(0, 64, 256).astype(np.int32)
    dst = rng.integers(0, 64, 256).astype(np.int32)
    recs = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU).aggregate(tcc.ConnectedComponents()).collect()
    _assert_same_cc(recs, JStream.from_arrays(src, dst, JConfig(**kw)).aggregate(jcc.ConnectedComponents()).collect())
    assert len(waited) == len(recs) == 8
    for fetch in waited:
        assert isinstance(fetch.host, tcc.CCState)
        assert all(isinstance(t, torch.Tensor) for t in fetch.host)


class _RunningCount(SummaryBulkAggregation):
    """Counts edges; ``combine`` adds into its first state in place and
    ``transform`` returns the state itself."""

    def initial_state(self, cfg, device):
        return torch.zeros((1,), dtype=torch.int64, device=device)

    def update(self, state, src, dst, val, mask):
        return state.add_(mask.sum() if mask is not None else src.numel())

    def combine(self, a, b):
        return a.add_(b)


def test_a_queued_record_keeps_its_window_after_later_combines():
    """Records wait in the completion queue while later windows' combines
    update the running state in place: each must still hold its own
    window's running count, as on the synchronous path."""
    edges = [(1, 2, 0, 100 * w + j) for w in range(12) for j in range(w + 1)]
    want = list(np.cumsum(np.arange(1, 13)))
    for kw in (ASYNC, dict(KW, async_windows=8), dict(KW, superbatch=4, async_windows=5)):
        stream = TStream.from_collection(edges, TConfig(**kw), batch_size=4, with_time=True, device=CPU)
        got = [int(r[0][0]) for r in stream.aggregate(_RunningCount(window_ms=100)).collect()]
        assert got == want, kw
