"""Port parity: the sampled triangle estimators of the PyTorch port against
the JAX package on the CPU.

``sampler_update`` of both packages on the same seeded batches, the state
carried across batches: the key (``jax.random``'s threefry bits, copied by
``utils/threefry.py``), every lane's edge, third vertex and flags,
``edges_seen``, ``seen`` and every estimate must be equal, for S in {1, 7,
256, 1024}, with masked rows and ids -1 and C; a state handed over from
JAX mid-stream by ``interop.sampler_state_from_numpy`` goes on equal.
Then ``BroadcastTriangleCount`` / ``IncidenceSamplingTriangleCount.run``
over streams (the records and final states) and both example CLIs.
Tolerance: none (the estimates are the same f32 arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.examples import broadcast_triangle_count as jbex
from gelly_streaming_tpu.examples import incidence_sampling_triangle_count as jiex
from gelly_streaming_tpu.library import sampled_triangles as jst
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.examples import broadcast_triangle_count as tbex
from gelly_streaming_tpu_torch.examples import incidence_sampling_triangle_count as tiex
from gelly_streaming_tpu_torch.library import sampled_triangles as tst
from gelly_streaming_tpu_torch.ops import sampled_triangles as st_ops

CPU = "cpu"
FIELDS = ("edge", "third", "closed_a", "closed_b", "edges_seen", "seen")
_update = jax.jit(jst.sampler_update)


def _same(js, ts):
    assert np.array_equal(ts.key.to(torch.int64).numpy(), np.asarray(js.key).astype(np.int64))
    for f in FIELDS:
        assert np.array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f))), f
    assert tst.estimate(ts) == jst.estimate(js)


def _feed(js, ts, rng, c, b, lo, hi):
    s = rng.integers(lo, hi, b).astype(np.int32)
    d = rng.integers(lo, hi, b).astype(np.int32)
    m = rng.random(b) < 0.85
    js = _update(js, jnp.asarray(s), jnp.asarray(d), jnp.asarray(m))
    tst.sampler_update(ts, torch.from_numpy(s), torch.from_numpy(d), torch.from_numpy(m))
    _same(js, ts)
    return js


@pytest.mark.parametrize("ids", ["in_range", "odd"])
@pytest.mark.parametrize("s_lanes", [1, 7, 256, 1024])
def test_sampler_update_matches_jax(s_lanes, ids):
    c = 20
    rng = np.random.default_rng(s_lanes + len(ids))
    lo, hi = (0, c) if ids == "in_range" else (-1, c + 1)
    js = jst.init_samplers(JConfig(vertex_capacity=c), s_lanes)
    ts = tst.init_samplers(TConfig(vertex_capacity=c), s_lanes, device=CPU)
    _same(js, ts)
    for b in (40, 40, 7, 64):
        js = _feed(js, ts, rng, c, b, lo, hi)


@pytest.mark.parametrize("seed", [0, 12345, 0xDEADBEEF])
def test_seeds_and_handover_from_jax(seed):
    """A JAX state handed over mid-stream (its key as ``key_data``) goes
    on giving the same states."""
    c, s_lanes = 24, 64
    rng = np.random.default_rng(seed % 1000)
    js = jst.init_samplers(JConfig(vertex_capacity=c), s_lanes, seed=seed)
    ts = tst.init_samplers(TConfig(vertex_capacity=c), s_lanes, seed=seed, device=CPU)
    js = _feed(js, ts, rng, c, 50, 0, c)
    handed = interop.sampler_state_from_numpy(
        np.asarray(jax.random.key_data(js.key)), *(np.asarray(getattr(js, f)) for f in FIELDS), device=CPU)
    _same(js, handed)
    for _ in range(3):
        js = _feed(js, handed, rng, c, 50, 0, c)


def test_unmasked_rows_and_empty_batch():
    c, s_lanes = 16, 32
    js = jst.init_samplers(JConfig(vertex_capacity=c), s_lanes)
    ts = tst.init_samplers(TConfig(vertex_capacity=c), s_lanes, device=CPU)
    rng = np.random.default_rng(9)
    s = rng.integers(0, c, 30).astype(np.int32)
    d = rng.integers(0, c, 30).astype(np.int32)
    js = _update(js, jnp.asarray(s), jnp.asarray(d), jnp.ones(30, bool))
    st_ops.sampler_scan(ts, torch.from_numpy(s), torch.from_numpy(d), None)
    _same(js, ts)
    empty = torch.zeros((0,), dtype=torch.int32)
    st_ops.sampler_scan(ts, empty, empty, None)
    _same(js, ts)


def _streams(edges, c, batch):
    return (JStream.from_collection(edges, JConfig(vertex_capacity=c), batch_size=batch),
            TStream.from_collection(edges, TConfig(vertex_capacity=c), batch_size=batch, device=CPU))


@pytest.mark.parametrize("cls", ["BroadcastTriangleCount", "IncidenceSamplingTriangleCount"])
def test_run_records_match_jax(cls):
    rng = np.random.default_rng(4)
    c = 30
    edges = [(int(a), int(b)) for a, b in zip(rng.integers(0, c, 600), rng.integers(0, c, 600))]
    js, ts = _streams(edges, c, 128)
    jalgo, talgo = getattr(jst, cls)(num_samplers=500), getattr(tst, cls)(num_samplers=500)
    got = talgo.run(ts).collect()
    assert got == jalgo.run(js).collect()
    assert len(got) == 5 and got[-1][0] > 0
    _same(jalgo.final_state, talgo.final_state)


def test_wrapper_runs_the_twin_on_the_cpu_and_checks_its_inputs():
    ts = tst.init_samplers(TConfig(vertex_capacity=8), 4, device=CPU)
    s = torch.tensor([0, 1, 2], dtype=torch.int32)
    before = st_ops.TWIN_CALLS["sampler_scan"]
    st_ops.sampler_scan(ts, s, s + 1, None)
    assert st_ops.TWIN_CALLS["sampler_scan"] == before + 1
    assert int(ts.edges_seen) == 3 and int(ts.seen.sum()) == 4
    with pytest.raises(ValueError):
        st_ops.sampler_scan(ts, s.long(), s, None)
    with pytest.raises(ValueError):
        st_ops.sampler_scan(ts._replace(key=ts.key.to(torch.int64)), s, s, None)


@pytest.mark.parametrize("name", ["broadcast", "incidence"])
def test_example_cli_matches_jax(tmp_path, name):
    jmod, tmod = {"broadcast": (jbex, tbex), "incidence": (jiex, tiex)}[name]
    inp = tmp_path / "in.txt"
    inp.write_text("".join(f"{i} {j}\n" for i in range(8) for j in range(i + 1, 8)))
    for args in ([], ["64"]):
        jout, tout = tmp_path / "j.csv", tmp_path / "t.csv"
        jmod.main([str(inp), str(jout), *args])
        tmod.main(["--device=cpu", str(inp), str(tout), *args])
        assert tout.read_text() == jout.read_text()
        assert tout.read_text().strip()
