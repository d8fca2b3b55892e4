"""Port parity: the greedy weighted matching of the PyTorch port against the
JAX package on the CPU.

``matching_update`` of both packages on the same seeded batches, the state
carried across batches: events f32 [B, 3, 4], emask bool [B, 3], partner
and weight must be equal bit for bit, with integer-weight ties, a pair
matched again (the shared edge counted once), self-loops, masked padding
and ids outside [0, C) (JAX's index rules).  Then
``CentralizedWeightedMatching.run`` over streams (records and final state
equal), a JAX state carried across by ``interop.matching_state_from_numpy``
mid-stream, and the example CLI (the same events; the ``Runtime:`` line
printed).  Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.examples import centralized_weighted_matching as jex
from gelly_streaming_tpu.library import matching as jm
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.examples import centralized_weighted_matching as tex
from gelly_streaming_tpu_torch.library import matching as tm
from gelly_streaming_tpu_torch.ops import matching as m_ops

CPU = "cpu"


def _batch(rng, c, b, lo, hi, weights):
    s = rng.integers(lo, hi, b).astype(np.int32)
    d = rng.integers(lo, hi, b).astype(np.int32)
    if weights == "ints":
        w = rng.integers(1, 6, b).astype(np.float32)
    else:
        w = rng.random(b).astype(np.float32)
    m = rng.random(b) < 0.85
    s[:3] = d[:3]  # self-loops
    s[7], d[7] = d[4], s[4]  # the same pair again, reversed
    return s, d, w, m


def _check_step(jstate, tstate, s, d, w, m):
    js, je, jmask = jm.matching_update(jstate, *(jnp.asarray(x) if x is not None else None for x in (s, d, w, m)))
    ts, te, tmask = tm.matching_update(tstate, *(torch.from_numpy(x) if x is not None else None
                                                  for x in (s, d, w, m)))
    assert np.array_equal(te.numpy().view(np.int32), np.asarray(je).view(np.int32))
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))
    assert np.array_equal(ts.partner.numpy(), np.asarray(js.partner))
    assert np.array_equal(ts.weight.numpy().view(np.int32), np.asarray(js.weight).view(np.int32))
    return js, ts


@pytest.mark.parametrize("weights", ["ints", "floats"])
@pytest.mark.parametrize("ids", ["in_range", "odd"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matching_update_matches_jax(seed, ids, weights):
    c = 16
    rng = np.random.default_rng(seed * 7 + len(ids) + len(weights))
    lo, hi = (0, c) if ids == "in_range" else (-3, c + 3)
    js = jm.init_matching(JConfig(vertex_capacity=c))
    ts = tm.init_matching(TConfig(vertex_capacity=c), CPU)
    for _ in range(4):
        js, ts = _check_step(js, ts, *_batch(rng, c, 40, lo, hi, weights))


def test_unweighted_and_unmasked_rows():
    """``val`` None weighs every edge 1 (so nothing is ever evicted);
    ``mask`` None keeps every row."""
    rng = np.random.default_rng(5)
    js = jm.init_matching(JConfig(vertex_capacity=12))
    ts = tm.init_matching(TConfig(vertex_capacity=12), CPU)
    s, d, _w, _m = _batch(rng, 12, 30, 0, 12, "ints")
    js, ts = _check_step(js, ts, s, d, None, np.ones(30, bool))
    _te, tmask = m_ops.matching_scan(ts.partner, ts.weight, torch.from_numpy(d), torch.from_numpy(s), None, None)
    _js, _je, jmask = jm.matching_update(js, jnp.asarray(d), jnp.asarray(s), None, jnp.ones(30, bool))
    assert np.array_equal(tmask.numpy(), np.asarray(jmask))


def _weighted_streams(rng, n, c, batch, lo=0, hi=None):
    hi = c if hi is None else hi
    edges = [(int(a), int(b), float(w)) for a, b, w in zip(rng.integers(lo, hi, n), rng.integers(lo, hi, n),
                                                           rng.integers(1, 100, n))]
    return (JStream.from_collection(edges, JConfig(vertex_capacity=c), batch_size=batch),
            TStream.from_collection(edges, TConfig(vertex_capacity=c), batch_size=batch, device=CPU))


@pytest.mark.parametrize("lo,hi", [(0, 50), (-2, 52)])
def test_run_records_and_final_state_match_jax(lo, hi):
    js, ts = _weighted_streams(np.random.default_rng(hi), 500, 50, 64, lo, hi)
    jalgo, talgo = jm.CentralizedWeightedMatching(), tm.CentralizedWeightedMatching()
    assert talgo.run(ts).collect() == jalgo.run(js).collect()
    assert np.array_equal(talgo.final_state.partner.numpy(), np.asarray(jalgo.final_state.partner))
    assert talgo.matched_edges(talgo.final_state) == jalgo.matched_edges(jalgo.final_state)


def test_state_carried_across_from_jax():
    rng = np.random.default_rng(11)
    c = 32
    js = jm.init_matching(JConfig(vertex_capacity=c))
    for _ in range(2):
        s, d, w, m = _batch(rng, c, 50, 0, c, "ints")
        js, _e, _m = jm.matching_update(js, jnp.asarray(s), jnp.asarray(d), jnp.asarray(w), jnp.asarray(m))
    ts = interop.matching_state_from_numpy(np.asarray(js.partner), np.asarray(js.weight), device=CPU)
    for _ in range(3):
        js, ts = _check_step(js, ts, *_batch(rng, c, 50, 0, c, "floats"))


def test_wrapper_runs_the_twin_on_the_cpu_and_checks_its_inputs():
    st = tm.init_matching(TConfig(vertex_capacity=8), CPU)
    s = torch.tensor([0, 1], dtype=torch.int32)
    before = m_ops.TWIN_CALLS["matching_scan"]
    m_ops.matching_scan(st.partner, st.weight, s, s + 2, torch.tensor([3.0, 4.0]), None)
    assert m_ops.TWIN_CALLS["matching_scan"] == before + 1
    assert st.partner.tolist()[:4] == [2, 3, 0, 1]
    with pytest.raises(ValueError):
        m_ops.matching_scan(st.partner.long(), st.weight, s, s, None, None)
    with pytest.raises(ValueError):
        m_ops.matching_scan(st.partner, st.weight, s, s[:1], None, None)


def _cli(module, args, capsys):
    """The records a bare run prints (its banner names each package's usage)."""
    module.main(args)
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith(("ADD,", "REMOVE,"))]


def test_example_cli_matches_jax(tmp_path, capsys):
    inp = tmp_path / "in.txt"
    rng = np.random.default_rng(2)
    inp.write_text("".join(f"{a} {b} {w}\n" for a, b, w in zip(rng.integers(0, 30, 200), rng.integers(0, 30, 200),
                                                                 rng.integers(1, 6, 200))))
    jout, tout = tmp_path / "j.csv", tmp_path / "t.csv"
    jex.main([str(inp), str(jout)])
    tex.main(["--device=cpu", str(inp), str(tout)])
    assert tout.read_text() == jout.read_text()
    bare = _cli(tex, ["--device=cpu"], capsys)
    assert bare and bare == _cli(jex, [], capsys)
    tex.main(["--device=cpu"])
    assert capsys.readouterr().out.splitlines()[-1].startswith("Runtime: ")
    small = tmp_path / "small.txt"
    small.write_text("1 2 10\n3 4 20\n")
    tex.main(["--device=cpu", str(small), str(tout)])
    assert tout.read_text().split() == ["ADD,1,2,10.0", "ADD,3,4,20.0"]
