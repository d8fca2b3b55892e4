"""Port parity: checkpoints of the PyTorch port against the JAX package.

The port's snapshot format (``utils/checkpoint.py``) flattens a state in
the JAX package's leaf order, so a snapshot the port writes holds the same
``leaf_i`` arrays as the JAX package's at the same stream position.  These
tests run both packages on the same numpy-seeded streams with the same
crash plans (the cases of tests/test_checkpoint_resume.py and
tests/test_wire_checkpoint.py, and the windowed planes) and require equal
records, equal snapshot leaves at every position compared, and a JAX
snapshot resumed by the port (``interop.snapshot_from_jax``) to reach the
JAX package's records.  Tolerance: none.
"""

import os
import signal
import subprocess
import sys
import textwrap
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gelly_streaming_tpu.utils.checkpoint as jckpt
import gelly_streaming_tpu_torch.utils.checkpoint as tckpt
from gelly_streaming_tpu.core.aggregation import SummaryBulkAggregation as JBulk
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core import aggregation as tagg
from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation as TBulk
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.library import connected_components as tcc

# the wire path runs the prefetcher's and the snapshot writer's threads
pytestmark = pytest.mark.timeout_cap(120)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


class _Crash(RuntimeError):
    pass


def _edges(n=2048, c=128, seed=5):
    rng = np.random.default_rng(seed)
    return rng.integers(0, c, n).astype(np.int32), rng.integers(0, c, n).astype(np.int32)


def _leaves(path):
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        return [data[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in data.files))]


def _assert_same_leaves(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _assert_same_cc(t_recs, j_recs):
    assert len(t_recs) == len(j_recs) > 0
    for (t,), (j,) in zip(t_recs, j_recs):
        np.testing.assert_array_equal(t.parent.numpy(), np.asarray(j.parent))
        np.testing.assert_array_equal(t.seen.numpy(), np.asarray(j.seen))


class _Saves:
    """Wrap both packages' save_state: record each snapshot's leaves, and
    raise ``_Crash`` after the ``crash_after``-th save."""

    def __init__(self, monkeypatch, crash_after=None, delay=0.0):
        self.taken = {"jax": [], "port": []}
        for side, mod in (("jax", jckpt), ("port", tckpt)):
            real = mod.save_state

            def save(p, state, real=real, side=side):
                if delay:
                    time.sleep(delay)
                real(p, state)
                self.taken[side].append(_leaves(p))
                if crash_after is not None and len(self.taken[side]) == crash_after:
                    raise _Crash()

            monkeypatch.setattr(mod, "save_state", save)

    def assert_same(self):
        j, t = self.taken["jax"], self.taken["port"]
        assert len(j) == len(t) > 0
        for lj, lt in zip(j, t):
            assert len(lj) == len(lt)
            for x, y in zip(lj, lt):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the snapshot format


class _Pair(NamedTuple):
    b: object
    a: object


def test_leaf_order_and_token_follow_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 9, (i + 1,)).astype(np.int32) for i in range(6)]
    j_state = {"z": (arrays[0], _Pair(arrays[1], arrays[2])), "a": {"y": arrays[3], "b": None, "c": arrays[4]},
               "m": [np.full((), 7, np.int64), arrays[5]]}
    t_state = jax.tree.map(lambda x: torch.from_numpy(np.array(x)) if x.ndim else x, j_state)
    j_leaves = [np.asarray(x) for x in jax.tree.leaves(j_state)]
    t_leaves, _ = tckpt.flatten(t_state)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(tckpt.host_array(t), j)
    token = tckpt._treedef_token(t_state)
    j_token = jckpt._treedef_token(j_state)
    assert token["shapes"] == j_token["shapes"] and token["dtypes"] == j_token["dtypes"]
    back = tckpt.unflatten_like(t_state, t_leaves)
    assert list(back) == list(t_state) and isinstance(back["z"][1], _Pair)


def test_save_and_load_like_jax(tmp_path):
    state = {"summary": tcc.CCState(torch.arange(8, dtype=torch.int32), torch.ones(8, dtype=torch.bool)),
             "pos": np.full((), 3, np.int64), "scale": torch.tensor(0.5)}
    path = str(tmp_path / "s")
    tckpt.save_state(path, state)
    assert tckpt.checkpoint_exists(path) and not os.path.exists(path + ".npz.tmp.npz")
    back = tckpt.load_state(path, state)
    assert isinstance(back["summary"], tcc.CCState) and isinstance(back["pos"], np.ndarray)
    assert back["summary"].parent.dtype == torch.int32 and int(back["pos"]) == 3
    j_state = jax.tree.map(lambda x: np.asarray(x), {"summary": jcc.CCState(np.arange(8, dtype=np.int32),
                                                                           np.ones(8, bool)),
                                                      "pos": np.full((), 3, np.int64),
                                                      "scale": np.float32(0.5)})
    jckpt.save_state(str(tmp_path / "j"), j_state)
    _assert_same_leaves(path, str(tmp_path / "j"))
    # a layout change is refused before any leaf is read
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_state(path, {"summary": state["summary"], "pos": state["pos"]})
    with pytest.raises(ValueError, match="structure mismatch"):
        tckpt.load_state(path, {**state, "pos": np.zeros((), np.int32)})
    for name in ("a", "a.npz", "x/../b"):
        assert tckpt.per_job_file(path, name) == jckpt.per_job_file(path, name)


# ---------------------------------------------------------------------------
# windowed planes (tests/test_checkpoint_resume.py, and the async and
# superbatch planes)

EDGES_T = [(1, 2, 0, 10), (3, 4, 0, 110), (2, 3, 0, 210), (5, 6, 0, 310)]


def _timed(side, edges, **kw):
    if side == "jax":
        return JStream.from_collection(edges, JConfig(vertex_capacity=16, max_degree=16, **kw), batch_size=1,
                                       with_time=True)
    return TStream.from_collection(edges, TConfig(vertex_capacity=16, max_degree=16, **kw), batch_size=1,
                                   with_time=True, device=CPU)


CC = {"jax": jcc.ConnectedComponents, "port": tcc.ConnectedComponents}


@pytest.mark.parametrize("plane", [{}, {"async_windows": 2}, {"superbatch": 4}], ids=["sync", "async", "superbatch"])
def test_checkpoint_resume_matches_jax(tmp_path, plane):
    out = {}
    for side in CC:
        ckpt = str(tmp_path / f"{side}.npz")
        first = CC[side](window_ms=100).run(_timed(side, EDGES_T[:2], **plane), checkpoint_path=ckpt).collect()
        mid = _leaves(ckpt)
        second = CC[side](window_ms=100).run(_timed(side, EDGES_T[2:], **plane), checkpoint_path=ckpt).collect()
        fresh = CC[side](window_ms=100).run(_timed(side, EDGES_T[2:], **plane), checkpoint_path=ckpt,
                                            restore=False).collect()
        out[side] = (first, second, fresh, mid, _leaves(ckpt))
    (jf, js, jr, jm, jl), (tf, ts, tr, tm, tl) = out["jax"], out["port"]
    for t, j in ((tf, jf), (ts, js), (tr, jr)):
        _assert_same_cc(t, j)
    assert str(ts[-1][0]) == "{1=[1, 2, 3, 4], 5=[5, 6]}" and str(tr[-1][0]) == "{2=[2, 3], 5=[5, 6]}"
    for a, b in ((tm, jm), (tl, jl)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("plane", [{}, {"async_windows": 2}, {"superbatch": 2}], ids=["sync", "async", "superbatch"])
def test_windowed_crash_after_second_snapshot_resumes_like_jax(tmp_path, monkeypatch, plane):
    edges = [(i % 13, (3 * i + 1) % 13, 0, 100 * (i // 3) + 5) for i in range(24)]
    clean = {side: CC[side](window_ms=100).run(_timed(side, edges, **plane)).collect() for side in CC}
    saves = _Saves(monkeypatch, crash_after=2)
    resumed = {}
    for side in CC:
        ckpt = str(tmp_path / side)
        with pytest.raises(_Crash):
            CC[side](window_ms=100).run(_timed(side, edges, **plane), checkpoint_path=ckpt).collect()
        resumed[side] = CC[side](window_ms=100).run(_timed(side, edges, **plane), checkpoint_path=ckpt).collect()
    saves.assert_same()
    _assert_same_cc(resumed["port"], resumed["jax"])
    _assert_same_cc(resumed["port"][-1:], clean["jax"][-1:])


# ---------------------------------------------------------------------------
# the wire path (tests/test_wire_checkpoint.py)


def _wire_stream(side, src, dst, **kw):
    kw = {"vertex_capacity": 128, "batch_size": 64, "wire_checkpoint_batches": 4, **kw}
    if side == "jax":
        return JStream.from_arrays(src, dst, JConfig(**kw))
    return TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)


def test_wire_crash_after_second_snapshot_resumes_like_jax(tmp_path, monkeypatch):
    src, dst = _edges()
    clean = {side: CC[side]().run(_wire_stream(side, src, dst)).collect() for side in CC}
    saves = _Saves(monkeypatch, crash_after=2)
    resumed = {}
    for side in CC:
        path = str(tmp_path / side)
        with pytest.raises(_Crash):
            CC[side]().run(_wire_stream(side, src, dst), checkpoint_path=path).collect()
        like = CC[side]()._wire_checkpoint_like(_wire_stream(side, src, dst))
        snap = (jckpt if side == "jax" else tckpt).load_state(path, like)
        assert int(snap["next_batch"]) == 8 and not bool(snap["done"])
        resumed[side] = CC[side]().run(_wire_stream(side, src, dst), checkpoint_path=path).collect()
    saves.assert_same()
    _assert_same_leaves(str(tmp_path / "port"), str(tmp_path / "jax"))
    _assert_same_cc(resumed["port"], resumed["jax"])
    _assert_same_cc(resumed["port"], clean["jax"])


def test_wire_done_reemits_without_refolding(tmp_path, monkeypatch):
    src, dst = _edges(n=512)
    path = str(tmp_path / "ck")
    first = tcc.ConnectedComponents().run(_wire_stream("port", src, dst), checkpoint_path=path).collect()

    def boom(*a, **k):
        raise AssertionError("resume of a done stream must not refold")

    monkeypatch.setattr(tagg, "Prefetcher", boom)
    again = tcc.ConnectedComponents().run(_wire_stream("port", src, dst), checkpoint_path=path).collect()
    _assert_same_cc(again, first)
    j_path = str(tmp_path / "j")
    jcc.ConnectedComponents().run(_wire_stream("jax", src, dst), checkpoint_path=j_path).collect()
    _assert_same_leaves(path, j_path)


_CHILD = textwrap.dedent(
    """
    import os, signal, sys
    sys.path.insert(0, {repo!r})
    import numpy as np
    import torch
    import gelly_streaming_tpu_torch.utils.checkpoint as ckpt
    from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream

    class EdgeCount(SummaryBulkAggregation):
        # a non-idempotent fold: a refolded batch would overcount
        def initial_state(self, cfg, device):
            return torch.zeros((), dtype=torch.int32, device=device)

        def update(self, state, src, dst, val, mask):
            return state + (src.shape[0] if mask is None else mask.sum(dtype=torch.int32))

        def combine(self, a, b):
            return a + b

    kill_after = int(os.environ.get("KILL_AFTER_SAVES", "0"))
    if kill_after:
        real = ckpt.save_state
        n = [0]
        def hooked(p, s):
            real(p, s)
            n[0] += 1
            if n[0] >= kill_after:
                os.kill(os.getpid(), signal.SIGKILL)  # no cleanup, no atexit
        ckpt.save_state = hooked

    rng = np.random.default_rng(5)
    src = rng.integers(0, 128, 4096).astype(np.int32)
    dst = rng.integers(0, 128, 4096).astype(np.int32)
    cfg = StreamConfig(vertex_capacity=128, batch_size=64, wire_checkpoint_batches=4)
    out = EdgeStream.from_arrays(src, dst, cfg, device="cpu").aggregate(EdgeCount(), checkpoint_path={ckpt_path!r})
    print("FINAL_COUNT", int(out.collect()[0][0]))
    """
)


@pytest.mark.timeout_cap(300)
def test_wire_sigkill_and_resume_subprocess(tmp_path):
    """SIGKILL the process mid-stream, resume from the snapshot on disk: the
    non-idempotent count comes out exact."""
    ckpt_path = str(tmp_path / "proc_ck")
    script = tmp_path / "child.py"
    script.write_text(_CHILD.format(repo=REPO, ckpt_path=ckpt_path))
    env = dict(os.environ, KILL_AFTER_SAVES="3")
    first = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, timeout=240)
    assert first.returncode == -signal.SIGKILL, (first.returncode, first.stdout, first.stderr)
    assert os.path.exists(ckpt_path + ".npz"), "the snapshot must survive the kill"
    env.pop("KILL_AFTER_SAVES")
    second = subprocess.run([sys.executable, str(script)], env=env, capture_output=True, timeout=240)
    assert second.returncode == 0, second.stderr.decode()
    assert b"FINAL_COUNT 4096" in second.stdout, second.stdout


def test_wire_resume_from_legacy_windowed_snapshot(tmp_path):
    src, dst = _edges(n=512)
    clean = tcc.ConnectedComponents().run(_wire_stream("port", src, dst)).collect()
    agg = tcc.ConnectedComponents()
    cfg = TConfig(vertex_capacity=128)
    folded = agg.update(agg.initial_state(cfg, torch.device(CPU)), torch.from_numpy(src), torch.from_numpy(dst),
                        None, None)
    path = str(tmp_path / "legacy")
    for done, summary in ((True, folded), (False, agg.initial_state(cfg, torch.device(CPU)))):
        tckpt.save_state(path, {"summary": summary, "has_summary": np.full((), done, bool),
                                "last_window": np.full((), -1, np.int64), "global_done": np.full((), done, bool)})
        again = tcc.ConnectedComponents().run(_wire_stream("port", src, dst), checkpoint_path=path).collect()
        assert again[0][0].components() == clean[0][0].components()
    # a bare summary holds no position: a refold from the start
    tckpt.save_state(path, agg.initial_state(cfg, torch.device(CPU)))
    again = tcc.ConnectedComponents().run(_wire_stream("port", src, dst), checkpoint_path=path).collect()
    assert again[0][0].components() == clean[0][0].components()
    # a resume under another batch size is refused
    with pytest.raises(ValueError, match="batch_size"):
        tcc.ConnectedComponents().run(_wire_stream("port", src, dst, batch_size=32), checkpoint_path=path).collect()


class _JCount(JBulk):
    order_free = True

    def initial_state(self, cfg):
        return jnp.zeros((), jnp.int32)

    def update(self, state, src, dst, val, mask):
        return state + jnp.sum(mask.astype(jnp.int32))

    def combine(self, a, b):
        return a + b


class _TCount(TBulk):
    order_free = True

    def initial_state(self, cfg, device):
        return torch.zeros((), dtype=torch.int32, device=device)

    def update(self, state, src, dst, val, mask):
        return state + (src.shape[0] if mask is None else mask.sum(dtype=torch.int32))

    def combine(self, a, b):
        return a + b


def test_wire_checkpoint_resumes_across_encodings(tmp_path, monkeypatch):
    src, dst = _edges(n=1024)
    saves = _Saves(monkeypatch, crash_after=2)
    out = {}
    for side, cls in (("jax", _JCount), ("port", _TCount)):
        path = str(tmp_path / side)
        with pytest.raises(_Crash):
            cls().run(_wire_stream(side, src, dst, wire_encoding="plain"), checkpoint_path=path).collect()
        out[side] = int(cls().run(_wire_stream(side, src, dst, wire_encoding="ef40"),
                                  checkpoint_path=path).collect()[0][0])
    assert out == {"jax": 1024, "port": 1024}  # exactly-once across the switch
    saves.assert_same()


def test_wire_async_writer_backpressure(tmp_path, monkeypatch):
    src, dst = _edges()
    saves = _Saves(monkeypatch, delay=0.02)  # slower than the fold makes snapshots
    out = {}
    for side in CC:
        path = str(tmp_path / side)
        out[side] = CC[side]().run(_wire_stream(side, src, dst, wire_checkpoint_batches=2),
                                   checkpoint_path=path).collect()
    saves.assert_same()  # every snapshot, in order, the terminal one included
    positions = [int(leaves[2]) for leaves in saves.taken["port"]]  # next_batch
    assert positions == list(range(2, 33, 2)) + [32]
    assert bool(saves.taken["port"][-1][1])  # done
    _assert_same_cc(out["port"], out["jax"])


def test_wire_writer_error_surfaces_on_the_fold_thread(tmp_path, monkeypatch):
    src, dst = _edges(n=1024)

    def broken(p, state):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt, "save_state", broken)
    with pytest.raises(OSError, match="disk full"):
        tcc.ConnectedComponents().run(_wire_stream("port", src, dst, wire_checkpoint_batches=1),
                                      checkpoint_path=str(tmp_path / "x")).collect()


# ---------------------------------------------------------------------------
# a JAX snapshot resumed by the port


def test_snapshot_from_jax_resumes_to_jax_records(tmp_path, monkeypatch):
    src, dst = _edges(seed=9)
    j_path = str(tmp_path / "j")
    _Saves(monkeypatch, crash_after=3)
    with pytest.raises(_Crash):
        jcc.ConnectedComponents().run(_wire_stream("jax", src, dst), checkpoint_path=j_path).collect()
    monkeypatch.undo()
    j_final = jcc.ConnectedComponents().run(_wire_stream("jax", src, dst)).collect()
    agg = tcc.ConnectedComponents()
    state = interop.snapshot_from_jax(j_path + ".npz", agg._wire_checkpoint_like(_wire_stream("port", src, dst)))
    assert int(state["next_batch"]) == 12 and isinstance(state["summary"], tcc.CCState)
    t_path = str(tmp_path / "t")
    tckpt.save_state(t_path, state)
    resumed = agg.run(_wire_stream("port", src, dst), checkpoint_path=t_path).collect()
    _assert_same_cc(resumed, j_final)
    with pytest.raises(ValueError, match="leaf"):
        interop.snapshot_from_jax(j_path + ".npz", tcc.ConnectedComponents()._checkpoint_like(
            TConfig(vertex_capacity=128), torch.device(CPU)))
