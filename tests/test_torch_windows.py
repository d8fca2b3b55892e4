"""Port parity: the PyTorch port's time plane (gelly_streaming_tpu_torch/core/windows.py)
cuts the same panes as the JAX package's, on the same seeded inputs.

Both sides build their streams from the same numpy arrays; panes are
compared field by field (window id, max timestamp, src, dst, time, val).
"""

import numpy as np
import pytest

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.core import windows as jwin
from gelly_streaming_tpu.io.sources import _batched as j_batched
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.core import windows as twin
from gelly_streaming_tpu_torch.io.sources import _batched as t_batched


def _timed_arrays(seed, n=3000, n_v=64, t_max=5000, jitter=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_v, n).astype(np.int64)
    dst = rng.integers(0, n_v, n).astype(np.int64)
    tim = np.sort(rng.integers(0, t_max, n)).astype(np.int64)
    if jitter:
        tim = np.maximum(tim + rng.integers(-jitter, jitter + 1, n), 0)
    return src, dst, tim


def _streams(src, dst, tim, bs, **cfg):
    j = JStream.from_batches(
        j_batched(src, dst, None, tim, None, bs), JConfig(vertex_capacity=1 << 10, **cfg)
    )
    t = TStream.from_batches(
        t_batched(src, dst, None, tim, None, bs, "cpu"),
        TConfig(vertex_capacity=1 << 10, **cfg),
        device="cpu",
    )
    return j, t


def _assert_panes_equal(jpanes, tpanes):
    jpanes, tpanes = list(jpanes), list(tpanes)
    assert len(jpanes) == len(tpanes) > 0
    for a, b in zip(jpanes, tpanes):
        assert a.window_id == b.window_id
        assert a.max_timestamp == b.max_timestamp
        np.testing.assert_array_equal(np.asarray(a.src), b.src)
        np.testing.assert_array_equal(np.asarray(a.dst), b.dst)
        assert (a.time is None) == (b.time is None)
        if a.time is not None:
            np.testing.assert_array_equal(np.asarray(a.time), b.time)
        assert (a.val is None) == (b.val is None)


@pytest.mark.parametrize("window_ms,bs,seed", [(400, 256, 0), (1000, 97, 1), (250, 1024, 2)])
def test_tumbling_panes_match_jax(window_ms, bs, seed):
    src, dst, tim = _timed_arrays(seed)
    j, t = _streams(src, dst, tim, bs)
    _assert_panes_equal(jwin.windowed_panes(j, window_ms), twin.windowed_panes(t, window_ms))


@pytest.mark.parametrize("window_ms,slide_ms", [(800, 200), (1000, 500), (600, 600)])
def test_sliding_panes_match_jax(window_ms, slide_ms):
    src, dst, tim = _timed_arrays(3, t_max=7000)
    j, t = _streams(src, dst, tim, 128)
    _assert_panes_equal(
        jwin.windowed_panes(j, window_ms, slide_ms),
        twin.windowed_panes(t, window_ms, slide_ms),
    )


def test_sliding_panes_with_gap_match_jax():
    src, dst, tim = _timed_arrays(4, n=400, t_max=1000)
    tim = np.concatenate([tim[:200], tim[200:] + 20000])
    j, t = _streams(src, dst, tim, 64)
    _assert_panes_equal(
        jwin.windowed_panes(j, 900, 300), twin.windowed_panes(t, 900, 300)
    )


def test_late_records_and_sink_match_jax():
    src, dst, tim = _timed_arrays(5, jitter=600)
    j, t = _streams(src, dst, tim, 50, out_of_orderness_ms=200)
    j_late, t_late = [], []
    j.on_late(lambda s, d, v, ts: j_late.append((np.asarray(s), np.asarray(ts))))
    t.on_late(lambda s, d, v, ts: t_late.append((s, ts)))
    _assert_panes_equal(jwin.windowed_panes(j, 300), twin.windowed_panes(t, 300))
    assert len(j_late) == len(t_late) > 0
    for (js, jt), (ts_, tt) in zip(j_late, t_late):
        np.testing.assert_array_equal(js, ts_)
        np.testing.assert_array_equal(jt, tt)


@pytest.mark.parametrize("every,bs", [(100, 64), (256, 256), (1000, 333)])
def test_ingestion_count_panes_match_jax(every, bs):
    rng = np.random.default_rng(6)
    edges = [(int(a), int(b)) for a, b in rng.integers(0, 50, (2500, 2))]
    j = JStream.from_collection(edges, JConfig(ingest_window_edges=every), batch_size=bs)
    t = TStream.from_collection(
        edges, TConfig(ingest_window_edges=every), batch_size=bs, device="cpu"
    )
    _assert_panes_equal(jwin.stream_panes(j, 0), twin.stream_panes(t, 0))


def test_array_backed_ingestion_panes_match_jax():
    rng = np.random.default_rng(7)
    src = rng.integers(0, 100, 3333)
    dst = rng.integers(0, 100, 3333)
    j = JStream.from_arrays(src, dst, JConfig(ingest_window_edges=500, batch_size=128))
    t = TStream.from_arrays(
        src, dst, TConfig(ingest_window_edges=500, batch_size=128), device="cpu"
    )
    _assert_panes_equal(jwin.stream_panes(j, 0), twin.stream_panes(t, 0))


def test_untimed_valued_stream_is_one_global_pane():
    edges = [(1, 2, 0.5), (2, 3, 1.5), (3, 1, 2.5)]
    j = JStream.from_collection(edges, JConfig(), batch_size=2)
    t = TStream.from_collection(edges, TConfig(), batch_size=2, device="cpu")
    jp, tp = list(jwin.windowed_panes(j, 100)), list(twin.windowed_panes(t, 100))
    _assert_panes_equal(jp, tp)
    np.testing.assert_array_equal(np.asarray(jp[0].val), tp[0].val)


def test_from_arrays_bounds_check_and_slide_validation():
    with pytest.raises(ValueError, match="vertex ids"):
        TStream.from_arrays(np.array([0, 16]), np.array([1, 2]), TConfig(vertex_capacity=16), device="cpu")
    with pytest.raises(ValueError, match="vertex ids"):
        TStream.from_arrays(np.array([-1]), np.array([1]), TConfig(), device="cpu")
    for bad in (0, 700, 300):
        with pytest.raises(ValueError):
            twin.validate_slide(1000, bad)
        with pytest.raises(ValueError):
            jwin.validate_slide(1000, bad)


def test_config_validation_matches_jax():
    for kw in (
        {"out_of_orderness_ms": -1},
        {"ingest_window_edges": 4, "ingest_window_ms": 4},
        {"out_of_orderness_ms": 5, "ingest_window_edges": 4},
        {"superbatch": -1},
        {"async_windows": -1},
        {"vertex_capacity": 0},
    ):
        with pytest.raises(ValueError):
            JConfig(**kw)
        with pytest.raises(ValueError):
            TConfig(**kw)


def test_edge_batch_padding_matches_jax():
    from gelly_streaming_tpu.core.types import EdgeBatch as JBatch
    from gelly_streaming_tpu_torch.core.types import EdgeBatch as TBatch

    rng = np.random.default_rng(8)
    s, d = rng.integers(0, 9, 5), rng.integers(0, 9, 5)
    tim, sign = rng.integers(0, 99, 5), np.array([1, -1, 1, -1, 1])
    val = (rng.random(5), rng.integers(0, 3, 5))
    jb = JBatch.from_arrays(s, d, val=val, time=tim, sign=sign, pad_to=8)
    tb = TBatch.from_arrays(s, d, val=val, time=tim, sign=sign, pad_to=8, device="cpu")
    for f in ("src", "dst", "mask", "time", "sign"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.asarray(getattr(jb, f)))
    for a, b in zip(tb.val, jb.val):
        # jax (x64 off) narrows to 32 bits; the port keeps numpy's widths
        np.testing.assert_array_equal(a.numpy().astype(np.asarray(b).dtype), np.asarray(b))
    jh, th = JBatch.from_host_arrays(s, d, pad_to=7), TBatch.from_host_arrays(s, d, pad_to=7)
    for f in ("src", "dst", "mask"):
        np.testing.assert_array_equal(getattr(th, f).numpy(), np.asarray(getattr(jh, f)))
    with pytest.raises(ValueError):
        TBatch.from_host_arrays(s, d, pad_to=3)
    stream = TStream.from_batches(
        lambda: iter([TBatch.from_host_arrays(s, d, pad_to=7)] * 2), TConfig(), device="cpu"
    )
    (pane,) = twin.windowed_panes(stream, 100)
    np.testing.assert_array_equal(pane.src, np.concatenate([s, s]))
