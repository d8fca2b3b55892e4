"""Port parity: the network edge source of the PyTorch port against the JAX
package's.

The same pushes go into both packages' ``NetworkEdgeSource`` (the cases of
the JAX unit tests in tests/test_server.py, tests/test_health.py,
tests/test_autoscale.py and tests/test_decode_pool.py): ``ready()``,
``progress()`` (``backlog_age_s`` compared only as zero or not), the
refusals and their ``expected`` / ``declared`` must agree.  Jobs over
``stream()`` (a windowed ConnectedComponents and a DegreeDistributionSummary
job, pushed at widths 2, PAIR40, (EF40, C) and (BDV, C) with a tail) must
give the JAX package's records on the sync and async planes, and across a
crash and a resume from the snapshot's cursor.  Tolerance: none.
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

import gelly_streaming_tpu.utils.checkpoint as jckpt
import gelly_streaming_tpu_torch.utils.checkpoint as tckpt
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.io import sources as jsrc
from gelly_streaming_tpu.io import wire as jw
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu.library import degree_distribution as jdd
from gelly_streaming_tpu.utils import metrics as jmetrics
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.io import sources as tsrc
from gelly_streaming_tpu_torch.io import wire as tw
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.library import degree_distribution as tdd
from gelly_streaming_tpu_torch.utils import metrics as tmetrics

# the async plane and the pushing threads
pytestmark = pytest.mark.timeout_cap(120)

SIDES = ("jax", "port")
CAP = 1 << 12
W = 1 << 10
B = 1 << 9


def _graph(seed: int, n: int, cap: int = CAP):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)


def _source(side, cfg_kw, *args, **kw):
    if side == "jax":
        return jsrc.NetworkEdgeSource(JConfig(**cfg_kw), *args, **kw)
    return tsrc.NetworkEdgeSource(TConfig(**cfg_kw), *args, device="cpu", **kw)


def _mod(side):
    return jsrc if side == "jax" else tsrc


def _refusal(fn):
    """(exception type name, message, expected, declared) of ``fn()``'s
    refusal, or None when it returns."""
    try:
        fn()
    except Exception as e:  # compared across the packages
        return type(e).__name__, str(e), getattr(e, "expected", None), getattr(e, "declared", None)
    return None


def _both(script):
    """``script(side)`` on each package; the observations must be equal."""
    out = {side: script(side) for side in SIDES}
    assert out["port"] == out["jax"]
    return out["port"]


# ---------------------------------------------------------------------------
# the ready() gate and the push guards (tests/test_server.py)


def test_ready_accounting_and_resume_like_jax():
    cfg = dict(vertex_capacity=64, batch_size=16, ingest_window_edges=32)
    buf = jw.pack_edges(np.arange(16, dtype=np.int32), np.arange(16, dtype=np.int32), 2)

    def script(side):
        seen = []
        src = _source(side, cfg, 16)
        seen.append(src.ready())
        for _ in range(2):  # one full window queued, its boundary edge not yet
            src.push_wire(buf, 2)
        seen.append(src.ready())
        src.push_wire(buf, 2)  # the first edge of window 1: closable
        seen.append(src.ready())
        src.close()
        seen += [src.ready(), _refusal(lambda: src.push_wire(buf, 2))]
        res = _source(side, cfg, 16, resume_edges=64)  # filler never makes it ready
        seen.append(res.ready())
        res.push_wire(buf, 2)
        seen.append(res.ready())
        for _ in range(2):
            res.push_wire(buf, 2)
        seen.append(res.ready())
        res.quiesce()
        seen += [res.ready(), _refusal(lambda: res.push_wire(buf, 2))]
        seen.append(_refusal(lambda: _source(side, cfg, 16, resume_edges=48)))
        seen.append(_refusal(lambda: _source(side, cfg, 64)))
        return seen

    seen = _both(script)
    assert seen[:4] == [False, False, True, True] and seen[4][0] == "SourceQuiesced"
    assert seen[5:8] == [False, False, True] and seen[8] is False and seen[9][0] == "SourceQuiesced"
    assert "multiple" in seen[10][1] and "must be <=" in seen[11][1]


def test_tail_guards_like_jax():
    cfg = dict(vertex_capacity=64, batch_size=16)

    def script(side):
        src = _source(side, cfg, 16)
        return [
            _refusal(lambda: src.push_tail(np.array([99], np.int64), np.array([1], np.int64))),
            _refusal(lambda: src.push_tail(np.zeros(17, np.int32), np.zeros(17, np.int32))),
            src.push_tail([1, 2], [3, 4]),
        ]

    seen = _both(script)
    assert "intern ids first" in seen[0][1] and "1..16" in seen[1][1] and seen[2] == 2


def test_push_wire_guards_like_jax():
    """A buffer of the wrong size, ids past the capacity and a width the
    capacity cannot hold are refused with JAX's messages."""
    cfg = dict(vertex_capacity=CAP, batch_size=B, ingest_window_edges=W)
    s, d = _graph(3, B)
    s[0] = CAP - 1

    def script(side):
        src = _source(side, cfg, B)
        wide = jw.pack_edges(s, d, 2)
        over = jw.pack_edges(np.full(B, CAP, np.int32), d, 2)
        return [
            _refusal(lambda: src.push_wire(wide[:-1], 2)),
            _refusal(lambda: src.push_wire(over, 2)),
            _refusal(lambda: src.push_wire(wide, (jw.EF40, 2 * CAP))),
            _refusal(lambda: src.push_wire(wide, 7)),
            src.push_wire(wide, 2),
        ]

    seen = _both(script)
    assert all(r[0] == "ValueError" for r in seen[:4]) and seen[4] == B


# ---------------------------------------------------------------------------
# the progress probe (tests/test_health.py)


def _progress(p):
    return {**p, "backlog_age_s": p["backlog_age_s"] > 0}


def test_progress_probe_like_jax():
    cfg = dict(vertex_capacity=CAP, batch_size=B, ingest_window_edges=W)
    s, d = _graph(0, B)

    def script(side):
        src = _source(side, cfg, B, max_queued_batches=8)
        seen = [_progress(src.progress())]
        for _ in range(6):  # 3072 edges: windows 0 and 1 closable, none delivered
            src.push_tail(s, d)
        time.sleep(0.02)
        seen.append(_progress(src.progress()))
        it = src._factory()
        pulls = 0
        while src.progress()["delivered_windows"] < 2:
            next(it)
            pulls += 1
        seen += [pulls, _progress(src.progress())]  # the held tail does not age
        it.close()
        return seen

    seen = _both(script)
    assert seen[0]["backlog_batches"] == 0 and seen[0]["queue_capacity_edges"] == 8 * B
    assert seen[1]["closable_windows"] == 2 and seen[1]["delivered_windows"] == 0 and seen[1]["backlog_age_s"]
    assert seen[3]["closable_windows"] == seen[3]["delivered_windows"] == 2 and not seen[3]["backlog_age_s"]


def test_progress_applies_resume_floor_like_jax():
    cfg = dict(vertex_capacity=CAP, batch_size=B, ingest_window_edges=W)
    s, d = _graph(4, B)

    def script(side):
        src = _source(side, cfg, B, resume_edges=4 * W, max_queued_batches=8)
        seen = [_progress(src.progress())]
        src.push_tail(s, d)  # the first batch past the cursor, held for its window
        return seen + [_progress(src.progress()), src.edges_accepted, src.queued_batches]

    seen = _both(script)
    assert seen[0]["closable_windows"] == 3 and seen[0]["delivered_windows"] == 4
    assert seen[1]["closable_windows"] == 4 and not seen[1]["backlog_age_s"] and seen[2] == 4 * W + B


# ---------------------------------------------------------------------------
# the offset guard and the drain life cycle (tests/test_autoscale.py,
# tests/test_decode_pool.py)


def test_offset_guard_refuses_stale_pushes_like_jax():
    cfg = dict(vertex_capacity=CAP, batch_size=B, ingest_window_edges=W)
    s, d = _graph(59, B)

    def script(side):
        src = _source(side, cfg, B, resume_edges=2 * W, max_queued_batches=4)
        buf = jw.pack_edges(s, d, 2)
        return [
            _refusal(lambda: src.push_tail(s, d, offset=0)),
            src.push_tail(s, d, offset=2 * W),
            src.push_tail(s, d),  # no declaration: no check
            _refusal(lambda: src.push_wire(buf, 2, offset=2 * W)),
            src.push_wire(buf, 2, offset=2 * W + 2 * B),
        ]

    seen = _both(script)
    assert seen[0][0] == "PushOutOfSync" and "re-push from" in seen[0][1] and seen[0][2:] == (2 * W, 0)
    assert seen[3][2:] == (2 * W + 2 * B, 2 * W)


def test_quiesce_resume_and_close_like_jax():
    cfg = dict(vertex_capacity=CAP, batch_size=B, ingest_window_edges=W)
    s, d = _graph(67, B)
    woken = {side: [] for side in SIDES}

    def script(side):
        src = _source(side, cfg, B, max_queued_batches=4, on_data=lambda: woken[side].append(1))
        src.quiesce()
        seen = [src.draining, _refusal(src.check_open), _refusal(lambda: src.push_tail(s, d))]
        src.resume_pushes()
        seen += [src.draining, src.push_tail(s, d)]
        src.close()  # a closed source stays closed
        src.resume_pushes()
        seen += [src.draining, _refusal(lambda: src.push_tail(s, d)), _refusal(src.check_open)]
        return seen

    seen = _both(script)
    assert seen[0] is True and "draining" in seen[1][1] and seen[3] is False and seen[4] == B
    assert "closed" in seen[6][1]
    assert woken["port"] == woken["jax"] == [1, 1]  # the push and the close


def test_push_decoded_copies_out_before_release_like_jax():
    cfg = dict(vertex_capacity=CAP, batch_size=B)

    def script(side):
        src = _source(side, cfg, B)
        arena = np.zeros((2, B), np.int32)
        arena[0] = np.arange(B)
        arena[1] = np.arange(B) + 1
        fired = []
        refused = _refusal(lambda: src.push_decoded(arena[0, :-1], arena[1, :-1]))
        src.push_decoded(arena[0], arena[1], release=lambda: fired.append(True))
        src.close()
        batches = list(src._factory())
        arena[:] = -1  # recycled by a later decode
        return [refused, len(batches), fired, np.asarray(batches[0].src).tolist(), np.asarray(batches[0].dst).tolist()]

    seen = _both(script)
    assert seen[1] == 1 and seen[2] == [True] and seen[3] == list(range(B)) and seen[4] == list(range(1, B + 1))


def test_push_wire_timeout_on_a_full_queue_raises_full():
    cfg = TConfig(vertex_capacity=CAP, batch_size=B, ingest_window_edges=W)
    src = tsrc.NetworkEdgeSource(cfg, B, max_queued_batches=2, device="cpu")
    buf = tw.pack_edges(*_graph(5, B), 2)
    assert src.push_wire(buf, 2) == src.push_wire(buf, 2) == B
    t0 = time.perf_counter()
    with pytest.raises(queue.Full):
        src.push_wire(buf, 2, timeout=0.05)
    assert time.perf_counter() - t0 >= 0.05
    assert src.edges_accepted == 2 * B and src.queued_batches == 2


def test_stream_device_defaults_to_cuda():
    cfg = TConfig(vertex_capacity=CAP, batch_size=B)
    if torch.cuda.is_available():
        assert tsrc.NetworkEdgeSource(cfg, B).stream().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tsrc.NetworkEdgeSource(cfg, B)
    assert tsrc.NetworkEdgeSource(cfg, B, device="cpu").stream().device.type == "cpu"


# ---------------------------------------------------------------------------
# jobs over stream()

N_JOB = 4 * W + 100  # 8 full batches and a tail of 100 edges
WIDTHS = {"2": 2, "pair40": jw.PAIR40, "ef40": (jw.EF40, CAP), "bdv": (jw.BDV, CAP)}


def _pack(width, s, d):
    if isinstance(width, tuple) and width[0] == jw.BDV:
        return jw.pack_edges_bdv(s, d, width[1])
    return jw.pack_edges(s, d, width)


def _push_all(src, width, s, d, start=0):
    """Push edges [start, len) from a thread: full batches at ``width`` with
    declared offsets, then the tail, then the close."""
    errors = []

    def bounded(fn, *args, **kw):
        # a bounded wait, then the push again: its first step refuses once
        # a failed job has quiesced the source
        while True:
            try:
                return fn(*args, timeout=0.1, **kw)
            except queue.Full:
                pass

    def push():
        try:
            nf = (len(s) - start) // B
            for i in range(nf):
                lo = start + i * B
                bounded(src.push_wire, _pack(width, s[lo : lo + B], d[lo : lo + B]), width, offset=lo)
            if start + nf * B < len(s):
                bounded(src.push_tail, s[start + nf * B :], d[start + nf * B :], offset=start + nf * B)
            src.close()
        except BaseException as e:  # raised on the test's thread
            errors.append(e)

    th = threading.Thread(target=push)
    th.start()
    return th, errors


def _run_job(side, agg, width, plane, s, d, checkpoint_path=None, resume_edges=0, start=0):
    src = _source(side, dict(vertex_capacity=CAP, batch_size=B, ingest_window_edges=W, **plane), B,
                  max_queued_batches=4, resume_edges=resume_edges)
    th, errors = _push_all(src, width, s, d, start)
    try:
        job = src.stream().aggregate(agg, checkpoint_path=checkpoint_path) if checkpoint_path else \
            src.stream().aggregate(agg)
        return job.collect()
    finally:
        if th.is_alive():
            src.quiesce()  # a failed run: the pusher's next push refuses
        th.join()
        if errors and not isinstance(errors[0], _mod(side).SourceQuiesced):
            raise errors[0]


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_records(t_recs, j_recs, fields):
    assert len(t_recs) == len(j_recs) > 0
    for (t,), (j,) in zip(t_recs, j_recs):
        for f in fields:
            a = _host(getattr(t, f) if f else t)
            b = _host(getattr(j, f) if f else j)
            np.testing.assert_array_equal(a, b)


CC = {"jax": jcc.ConnectedComponents, "port": tcc.ConnectedComponents}
DD = {"jax": jdd.DegreeDistributionSummary, "port": tdd.DegreeDistributionSummary}
PLANES = {"sync": {}, "async": {"async_windows": 2}}


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("width", WIDTHS)
def test_cc_job_over_stream_matches_jax(width, plane):
    s, d = _graph(11, N_JOB)
    recs = {side: _run_job(side, CC[side](), WIDTHS[width], PLANES[plane], s, d) for side in SIDES}
    _assert_same_records(recs["port"], recs["jax"], ("parent", "seen"))
    assert len(recs["port"]) == N_JOB // W + 1  # a record a window and the tail's


@pytest.mark.parametrize("width", ["2", "pair40", "ef40", "bdv"])
def test_degree_job_over_stream_matches_jax(width):
    s, d = _graph(13, N_JOB)
    recs = {side: _run_job(side, DD[side](), WIDTHS[width], {}, s, d) for side in SIDES}
    _assert_same_records(recs["port"], recs["jax"], ("",))
    final = _host(recs["port"][-1][0])
    np.testing.assert_array_equal(final, np.bincount(s, minlength=CAP) + np.bincount(d, minlength=CAP))


class _Crash(RuntimeError):
    pass


@pytest.mark.parametrize("plane", PLANES)
def test_crash_and_resume_from_the_cursor_matches_jax(tmp_path, monkeypatch, plane):
    s, d = _graph(17, N_JOB)
    width = jw.PAIR40
    clean = {side: _run_job(side, CC[side](), width, PLANES[plane], s, d) for side in SIDES}
    for side, mod in (("jax", jckpt), ("port", tckpt)):
        real, saves = mod.save_state, []

        def save(p, state, real=real, saves=saves):
            real(p, state)
            saves.append(p)
            if len(saves) == 2:
                raise _Crash()

        monkeypatch.setattr(mod, "save_state", save)
    resumed, cursors = {}, {}
    for side in SIDES:
        path = str(tmp_path / side)
        with pytest.raises(_Crash):
            _run_job(side, CC[side](), width, PLANES[plane], s, d, checkpoint_path=path)
        agg = CC[side]()
        if side == "jax":
            last, _ = agg._restored_position(JConfig(vertex_capacity=CAP, ingest_window_edges=W), path, True)
        else:
            _, last, _ = agg._restore_merge(TConfig(vertex_capacity=CAP, ingest_window_edges=W),
                                            torch.device("cpu"), path, True)
        cursors[side] = (last + 1) * W
        # a push from before the crash's cursor is stale: refused with it
        probe = _source(side, dict(vertex_capacity=CAP, batch_size=B, ingest_window_edges=W), B,
                        resume_edges=cursors[side])
        stale = _refusal(lambda: probe.push_tail(s[:B], d[:B], offset=0))
        assert stale[0] == "PushOutOfSync" and stale[2] == cursors[side]
        resumed[side] = _run_job(side, agg, width, PLANES[plane], s, d, checkpoint_path=path,
                                 resume_edges=cursors[side], start=cursors[side])
    assert cursors["port"] == cursors["jax"] > 0
    _assert_same_records(resumed["port"], resumed["jax"], ("parent", "seen"))
    # the records past the cursor, and the final state, are the clean run's
    _assert_same_records(resumed["port"], clean["port"][-len(resumed["port"]):], ("parent", "seen"))
    _assert_same_records(clean["port"], clean["jax"], ("parent", "seen"))


def test_push_to_fold_latency_reaches_the_histograms():
    tmetrics.reset_histograms()
    jmetrics.reset_histograms()
    s, d = _graph(19, N_JOB)
    old = tmetrics.set_hist_job("net")
    try:
        _run_job("port", CC["port"](), jw.PAIR40, {}, s, d)
    finally:
        tmetrics.set_hist_job(old)
    snap = tmetrics.hist_snapshot()
    pulls = N_JOB // B + 1
    assert snap["global"]["push_to_fold_ms"]["count"] == pulls
    assert snap["jobs"]["net"]["push_to_fold_ms"]["count"] == pulls
    assert snap["global"]["push_to_fold_ms"]["p99_ms"] >= snap["global"]["push_to_fold_ms"]["p50_ms"] >= 0
    # the JAX package's snapshot layout
    jmetrics.hist_record("push_to_fold_ms", 1.0)
    assert set(snap["global"]["push_to_fold_ms"]) == set(jmetrics.hist_snapshot()["global"]["push_to_fold_ms"])
    jmetrics.reset_histograms()
