"""Port parity: supervised recovery of the PyTorch port against the JAX
package (the cases of tests/test_recovery.py).

A flaky source crashes mid-stream; ``run_supervised`` rebuilds the
pipeline, the source replays from the start and the restored position
skips the windows folded before the snapshot.  The port and the JAX
package run the same plan side by side: their records must be equal, the
restart counts equal, and the snapshot each leaves on disk must hold the
same leaves.  A non-idempotent sum proves exactly-once state.  Tolerance:
none (the sums are of small binary fractions, exact in f32).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.aggregation import SummaryBulkAggregation as JBulk
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu.utils import checkpoint as jckpt
from gelly_streaming_tpu.utils import recovery as jrec
from gelly_streaming_tpu_torch.core.aggregation import SummaryBulkAggregation as TBulk
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.utils import checkpoint as tckpt
from gelly_streaming_tpu_torch.utils import recovery as trec

CPU = "cpu"
KW = dict(vertex_capacity=16, max_degree=16)
EDGES_T = [(1, 2, 1.0, 10), (3, 4, 2.0, 110), (2, 3, 4.0, 210), (5, 6, 8.0, 310)]


class JSum(JBulk):
    """Non-idempotent fold: re-folding any window inflates the sum."""

    def initial_state(self, cfg):
        return jnp.zeros((), jnp.float32)

    def update(self, state, src, dst, val, mask):
        return state + jnp.sum(jnp.where(mask, val, 0.0))

    def combine(self, a, b):
        return a + b

    def transform(self, state):
        return float(state)


class TSum(TBulk):
    def initial_state(self, cfg, device):
        return torch.zeros((), dtype=torch.float32, device=device)

    def update(self, state, src, dst, val, mask):
        return state + (val.sum() if mask is None else torch.where(mask, val, 0.0).sum())

    def combine(self, a, b):
        return a + b

    def transform(self, state):
        return float(state)


SIDES = {
    "jax": (JStream, lambda: JConfig(**KW), {}, {"sum": JSum, "cc": jcc.ConnectedComponents}, jrec, jckpt),
    "port": (TStream, lambda: TConfig(**KW), {"device": CPU}, {"sum": TSum, "cc": tcc.ConnectedComponents}, trec,
             tckpt),
}


def _flaky_source(side, plan):
    """Source factory of one package: raises mid-stream on the attempts in
    ``plan`` (attempt -> batch), then replays the whole stream."""
    Stream, cfg, dev, _aggs, _rec, _ck = SIDES[side]
    attempts = {"n": 0}

    def make_stream():
        attempts["n"] += 1
        crash_at = plan.get(attempts["n"])

        def factory():
            for i, e in enumerate(EDGES_T):
                if crash_at is not None and i == crash_at:
                    raise IOError("source died")
                yield next(iter(Stream.from_collection([e], cfg(), batch_size=1, with_time=True, **dev).batches()))

        return Stream.from_batches(factory, cfg(), **dev)

    return make_stream, attempts


def _leaves(path):
    with np.load(path) as data:
        return [data[f"leaf_{i}"] for i in range(sum(k.startswith("leaf_") for k in data.files))]


def _both(tmp_path, fn):
    """fn(side, ckpt path) for each package; the snapshots must agree."""
    out = {}
    for side in SIDES:
        ckpt = os.path.join(str(tmp_path), f"{side}.npz")
        out[side] = fn(side, ckpt)
    j, t = (os.path.join(str(tmp_path), f"{s}.npz") for s in SIDES)
    if os.path.exists(j) or os.path.exists(t):
        lj, lt = _leaves(j), _leaves(t)
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    return out["jax"], out["port"]


def _strs(records):
    return [str(r[0]) for r in records]


@pytest.mark.parametrize("agg", ["sum", "cc"])
def test_crash_and_recover_matches_jax(tmp_path, agg):
    def run(side, ckpt):
        make_source, attempts = _flaky_source(side, {1: 3})
        cls, rec = SIDES[side][3][agg], SIDES[side][4]
        records = list(rec.run_supervised(lambda: cls(window_ms=100).run(make_source(), checkpoint_path=ckpt),
                                          max_restarts=2))
        return _strs(records), attempts["n"]

    j, t = _both(tmp_path, run)
    assert t == j and t[1] == 2
    if agg == "sum":
        assert t[0][-1] == "15.0"  # exactly-once


def test_exhausted_restarts_propagate_like_jax(tmp_path):
    def run(side, ckpt):
        make_source, attempts = _flaky_source(side, {a: 0 for a in range(1, 6)})
        cls, rec = SIDES[side][3]["sum"], SIDES[side][4]
        with pytest.raises(IOError, match="source died"):
            list(rec.run_supervised(lambda: cls(window_ms=100).run(make_source(), checkpoint_path=ckpt),
                                    max_restarts=2))
        return attempts["n"]

    assert _both(tmp_path, run) == (3, 3)


def test_progress_resets_restart_budget_like_jax(tmp_path):
    def run(side, ckpt):
        make_source, attempts = _flaky_source(side, {1: 2, 2: 3})
        cls, rec = SIDES[side][3]["sum"], SIDES[side][4]
        records = list(rec.run_supervised(lambda: cls(window_ms=100).run(make_source(), checkpoint_path=ckpt),
                                          max_restarts=1))
        return _strs(records), attempts["n"]

    j, t = _both(tmp_path, run)
    assert t == j and t[1] == 3 and t[0][-1] == "15.0"


def test_untimed_global_pane_does_not_double_fold(tmp_path):
    def run(side, ckpt):
        Stream, cfg, dev, aggs, _rec, _ck = SIDES[side]

        def once():
            stream = Stream.from_collection([(1, 2, 1.0), (3, 4, 2.0)], cfg(), batch_size=1, **dev)
            return _strs(aggs["sum"]().run(stream, checkpoint_path=ckpt).collect())

        return once(), once()

    j, t = _both(tmp_path, run)
    assert t == j == (["3.0"], [])


def test_legacy_bare_summary_checkpoint_still_restores(tmp_path):
    def run(side, ckpt):
        Stream, cfg, dev, aggs, _rec, ck = SIDES[side]
        ck.save_state(ckpt, jnp.asarray(7.0, jnp.float32) if side == "jax" else torch.tensor(7.0))
        stream = Stream.from_collection(EDGES_T[2:], cfg(), batch_size=1, with_time=True, **dev)
        return _strs(aggs["sum"](window_ms=100).run(stream, checkpoint_path=ckpt).collect())

    j, t = _both(tmp_path, run)
    assert t == j and t[-1] == str(7.0 + 4.0 + 8.0)


def test_emission_precedes_snapshot(tmp_path):
    def run(side, ckpt):
        make_source, _ = _flaky_source(side, {})
        cls = SIDES[side][3]["sum"]
        gen = iter(cls(window_ms=100).run(make_source(), checkpoint_path=ckpt))
        first = next(gen)  # window 0 emitted...
        del gen  # ...and the consumer dies before resuming the generator
        return str(first[0]), _strs(cls(window_ms=100).run(make_source(), checkpoint_path=ckpt).collect())

    j, t = _both(tmp_path, run)
    assert t == j == ("1.0", ["1.0", "3.0", "7.0", "15.0"])


def test_on_restart_hook_observes_failures(tmp_path):
    def run(side, ckpt):
        make_source, _ = _flaky_source(side, {1: 2})
        cls, rec = SIDES[side][3]["sum"], SIDES[side][4]
        seen = []
        list(rec.run_supervised(lambda: cls(window_ms=100).run(make_source(), checkpoint_path=ckpt),
                                max_restarts=2, on_restart=lambda n, e: seen.append((n, str(e)))))
        return seen

    assert _both(tmp_path, run) == ([(1, "source died")],) * 2


def test_total_restart_cap_binds_on_progress_then_crash():
    for rec in (jrec, trec):
        attempts = []

        def make_stream():
            attempts.append(1)

            def gen():
                yield ("progress",)
                raise RuntimeError("deterministic crash after progress")

            return gen()

        with pytest.raises(RuntimeError):
            list(rec.run_supervised(make_stream, max_restarts=2, max_total_restarts=5))
        assert len(attempts) == 6
