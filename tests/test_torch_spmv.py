"""Port parity: the masked-semiring SpMV core of the PyTorch port
(``gelly_streaming_tpu_torch/ops/spmv.py``) against the JAX package's
``ops/spmv.py`` on the CPU.

The JAX functions run as the reference tests run them; the port runs its
kernels' plain twins (device="cpu").  Inputs come from numpy seeds and are
handed to both: uniform and Zipf-skewed sources, self-loops, masked rows,
an all-masked pane, the max id C - 1, and ids outside [0, C).  Tolerances:
the min semirings and PLUS_ONE compute exactly and must be equal; a
PLUS_TIMES one-shot within rtol 1e-6 (the port's push sums each
destination in the dst-stable order, the JAX push in src order: one sum in
another order).  The fixpoint's x, frontier, iteration counts, push/pull
split, switches and density histogram must be equal exactly.  The JAX
package's compile-cache retrace test has no counterpart (PyTorch runs
eagerly).  The CUDA kernels are held against the same twins on the GPU by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.ops import spmv as jspmv
from gelly_streaming_tpu.ops import unionfind as juf
from gelly_streaming_tpu.utils import metrics as jmetrics
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.ops import spmv as tspmv
from gelly_streaming_tpu_torch.ops import unionfind as tuf
from gelly_streaming_tpu_torch.utils import envswitch
from gelly_streaming_tpu_torch.utils import metrics as tmetrics

C = 64
CPU = "cpu"
TCFG = TConfig(vertex_capacity=32, max_degree=16, batch_size=8)
SEMIRINGS = [
    (jspmv.MIN_PLUS, tspmv.MIN_PLUS),
    (jspmv.PLUS_TIMES, tspmv.PLUS_TIMES),
    (jspmv.MIN_MIN, tspmv.MIN_MIN),
    (jspmv.PLUS_ONE, tspmv.PLUS_ONE),
]


def _rand_pane(rng, e_pad, capacity=C, skew=False, self_loops=False, mask_frac=0.8):
    """One padded pane (src, dst, w, msk), as tests/test_spmv.py draws it."""
    if skew:
        src = ((rng.zipf(1.3, e_pad) - 1) % capacity).astype(np.int32)
    else:
        src = rng.integers(0, capacity, e_pad).astype(np.int32)
    dst = rng.integers(0, capacity, e_pad).astype(np.int32)
    if self_loops:
        src[: e_pad // 8] = dst[: e_pad // 8]
    src[0], dst[0] = capacity - 1, capacity - 1
    w = rng.integers(1, 8, e_pad).astype(np.float32)
    msk = rng.random(e_pad) < mask_frac
    return src, dst, w, msk


def _panes(src, dst, w, msk, capacity=C):
    return jspmv.prepare_pane(src, dst, w, msk, capacity), tspmv.prepare_pane(src, dst, w, msk, capacity, device=CPU)


def _x(rng, sem):
    if sem.name in ("min_min", "plus_one"):
        return rng.integers(0, 100, C).astype(np.int32)
    return rng.integers(0, 10, C).astype(np.float32)


def _same(sem, got, want, rtol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype
    if sem.name == "plus_times":
        np.testing.assert_allclose(got, want, rtol=rtol)
    else:
        np.testing.assert_array_equal(got, want)


def test_prepare_pane_layouts_match():
    rng = np.random.default_rng(1)
    jop, top = _panes(*_rand_pane(rng, 128, skew=True))
    for name in ("s_dst", "s_w", "off", "d_src", "d_w"):
        np.testing.assert_array_equal(getattr(top, name).numpy(), np.asarray(getattr(jop, name)), err_msg=name)
    assert int(top.n_active) == int(jop.n_active)
    assert (top.capacity, top.e_pad) == (jop.capacity, jop.e_pad)
    # the port's segment offsets of the dst-sorted copy, and its segment ids
    key_d = np.where(np.asarray(jop.d_msk), np.asarray(jop.d_dst), C)
    d_off = top.d_off.numpy()
    np.testing.assert_array_equal(d_off, np.searchsorted(key_d, np.arange(C + 1)))
    np.testing.assert_array_equal(tspmv._segment_ids(top).numpy(), np.asarray(jop.d_dst)[d_off[0] : d_off[C]])
    # masked rows are exactly the ones past the port's last row and segment
    n_live = int(np.asarray(jop.msk).sum())
    for msk_name, end in (("s_msk", int(top.off[C])), ("d_msk", int(d_off[C]))):
        np.testing.assert_array_equal(np.asarray(getattr(jop, msk_name)), np.arange(top.e_pad) < end, err_msg=msk_name)
        assert end == n_live


@pytest.mark.parametrize("case", ["uniform", "skew", "selfloop", "allmask", "nomask", "empty"])
@pytest.mark.parametrize("sems", SEMIRINGS, ids=lambda s: s[0].name)
def test_spmv_dense_matches_jax(sems, case):
    jsem, tsem = sems
    rng = np.random.default_rng(abs(hash((jsem.name, case))) % (1 << 31))
    e_pad = 1 if case == "empty" else 128
    src, dst, w, msk = _rand_pane(
        rng, e_pad, skew=case == "skew", self_loops=case == "selfloop",
        mask_frac={"allmask": 0.0, "nomask": 1.0, "empty": 0.0}.get(case, 0.8),
    )
    jop, top = _panes(src, dst, w, msk)
    x = _x(rng, jsem)
    want = jspmv.spmv_dense(jsem, jop, jnp.asarray(x))
    _same(tsem, tspmv.spmv_dense(tsem, top, torch.from_numpy(x)), want)


@pytest.mark.parametrize("sems", SEMIRINGS, ids=lambda s: s[0].name)
def test_spmsv_frontier_matches_jax(sems):
    jsem, tsem = sems
    rng = np.random.default_rng(7)
    src, dst, w, msk = _rand_pane(rng, 128, skew=True)
    jop, top = _panes(src, dst, w, msk)
    x = _x(rng, jsem)
    fm = rng.random(C) < 0.25
    want = jspmv.spmsv_frontier(jsem, jop, jnp.asarray(x), jnp.asarray(fm))
    got = tspmv.spmsv_frontier(tsem, top, torch.from_numpy(x), torch.from_numpy(fm))
    _same(tsem, got, want)
    # the push reads only frontier rows: the dense product over those edges
    restricted = jspmv.prepare_pane(src, dst, w, msk & fm[src], C)
    _same(tsem, got, jspmv.spmv_dense(jsem, restricted, jnp.asarray(x)))


def test_spmsv_frontier_overflow_refuses_loudly():
    rng = np.random.default_rng(8)
    _, top = _panes(*_rand_pane(rng, 128, mask_frac=1.0))
    x = torch.zeros((C,), dtype=torch.float32)
    with pytest.raises(ValueError, match="f_cap"):
        tspmv.spmsv_frontier(tspmv.MIN_PLUS, top, x, torch.ones((C,), dtype=torch.bool), f_cap=4)
    with pytest.raises(ValueError, match="f_cap"):
        tspmv.spmsv_frontier(tspmv.MIN_PLUS, top, x, torch.ones((C,), dtype=torch.bool), f_cap=0)
    assert tspmv.frontier_caps(128) == jspmv.frontier_caps(128)
    assert tspmv.frontier_caps(1 << 16) == jspmv.frontier_caps(1 << 16)


def test_products_follow_jax_index_rules():
    """Ids -1, -C, C and C + 3 on masked rows: the pull gathers and the
    push scatters as the JAX lowering each replaces."""
    rng = np.random.default_rng(21)
    src, dst, w, msk = _rand_pane(rng, 128)
    src[[3, 5, 9]], dst[[4, 6, 10]] = (-1, C, C + 3), (-1, -C, C)
    msk[[3, 4, 5, 6, 9, 10]] = True
    jop, top = _panes(src, dst, w, msk)
    assert int(top.n_active) == int(jop.n_active)
    x = _x(rng, jspmv.MIN_PLUS)
    fm = rng.random(C) < 0.5
    for jsem, tsem in SEMIRINGS:
        x = _x(rng, jsem)
        _same(tsem, tspmv.spmv_dense(tsem, top, torch.from_numpy(x)), jspmv.spmv_dense(jsem, jop, jnp.asarray(x)))
        if jsem.idempotent:
            _same(tsem, tspmv.spmsv_frontier(tsem, top, torch.from_numpy(x), torch.from_numpy(fm)),
                  jspmv.spmsv_frontier(jsem, jop, jnp.asarray(x), jnp.asarray(fm)))


@pytest.mark.parametrize("sems", SEMIRINGS, ids=lambda s: s[0].name)
def test_scatter_into_matches_jax(sems):
    jsem, tsem = sems
    rng = np.random.default_rng(9)
    src, _, _, msk = _rand_pane(rng, 128)
    src[[1, 2]] = (-2, C + 1)
    vals = _x(rng, jsem)[rng.integers(0, C, 128)]
    want = jspmv.scatter_into(jsem, C, jnp.asarray(src), jnp.asarray(vals), jnp.asarray(msk))
    got = tspmv.scatter_into(tsem, C, torch.from_numpy(src), torch.from_numpy(vals), torch.from_numpy(msk))
    _same(tsem, got, want)
    if jsem.name == "plus_one":
        ones = np.ones((128,), np.int32)
        got = tspmv.scatter_into(tsem, C, src, ones, msk, device=CPU)
        np.testing.assert_array_equal(got.numpy()[:C - 2], np.bincount(src[msk & (src >= 0)], minlength=C)[:C - 2])


def _run_both(src, dst, w, msk, x0, **kw):
    jop, top = _panes(src, dst, w, msk)
    jmetrics.reset_spmv_stats()
    tmetrics.reset_spmv_stats()
    want = jspmv.fixpoint(jspmv.MIN_PLUS, jop, jnp.asarray(x0), **kw)
    got = tspmv.fixpoint(tspmv.MIN_PLUS, top, torch.from_numpy(x0), **kw)
    return got, want


def _assert_fixpoint_equal(got, want):
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    np.testing.assert_array_equal(got.frontier.numpy(), np.asarray(want.frontier))
    assert (got.iters, got.push_iters, got.pull_iters, got.switches) == (
        want.iters, want.push_iters, want.pull_iters, want.switches)
    assert tmetrics.spmv_stats() == jmetrics.spmv_stats()


@pytest.mark.parametrize("mode", ["auto", "push", "pull"])
def test_fixpoint_matches_jax_in_every_mode(mode):
    rng = np.random.default_rng(11)
    src, dst, w, msk = _rand_pane(rng, 256, skew=True)
    x0 = np.full((C,), 1e30, np.float32)
    x0[0] = 0.0
    got, want = _run_both(src, dst, w, msk, x0, max_iters=C - 1, direction=mode)
    _assert_fixpoint_equal(got, want)
    if mode == "push":
        assert got.pull_iters == 0
    if mode == "pull":
        assert got.push_iters == 0


@pytest.mark.parametrize("threshold", [0.0, 0.03, 0.5, 1.0])
def test_fixpoint_threshold_sweep_matches_jax(threshold):
    rng = np.random.default_rng(12)
    src, dst, w, msk = _rand_pane(rng, 256, skew=True)
    x0 = np.full((C,), 1e30, np.float32)
    x0[3] = 0.0
    got, want = _run_both(src, dst, w, msk, x0, max_iters=C - 1, threshold=threshold)
    _assert_fixpoint_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_fixpoint_seeded_panes_match_jax(seed):
    """Seeded uniform and skewed panes, a bounded loop, an explicit start
    frontier, and x0 entries above the identity (inf)."""
    rng = np.random.default_rng(100 + seed)
    src, dst, w, msk = _rand_pane(rng, 256, skew=bool(seed % 2), self_loops=seed == 2)
    x0 = np.where(rng.random(C) < 0.1, rng.integers(0, 20, C), 1e30).astype(np.float32)
    x0[C - 1] = np.inf
    fm = rng.random(C) < 0.2
    for kw in ({"max_iters": C - 1}, {"max_iters": 2, "direction": "pull"}, {"max_iters": 0}):
        got, want = _run_both(src, dst, w, msk, x0, **kw)
        _assert_fixpoint_equal(got, want)
    jop, top = _panes(src, dst, w, msk)
    want = jspmv.fixpoint(jspmv.MIN_PLUS, jop, jnp.asarray(x0), max_iters=C, frontier=jnp.asarray(fm))
    got = tspmv.fixpoint(tspmv.MIN_PLUS, top, torch.from_numpy(x0), max_iters=C, frontier=torch.from_numpy(fm))
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    assert (got.iters, got.push_iters, got.pull_iters) == (want.iters, want.push_iters, want.pull_iters)


def test_fixpoint_min_min_matches_jax():
    rng = np.random.default_rng(13)
    src, dst, w, msk = _rand_pane(rng, 256)
    w = rng.integers(0, 2 * C, 256).astype(np.float32) + 0.5  # truncated to int32 by mul
    jop, top = _panes(src, dst, w, msk)
    x0 = np.arange(C, dtype=np.int32)
    for mode in ("auto", "push", "pull"):
        want = jspmv.fixpoint(jspmv.MIN_MIN, jop, jnp.asarray(x0), max_iters=C, direction=mode)
        got = tspmv.fixpoint(tspmv.MIN_MIN, top, torch.from_numpy(x0), max_iters=C, direction=mode)
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        assert (got.iters, got.push_iters, got.pull_iters, got.switches) == (
            want.iters, want.push_iters, want.pull_iters, want.switches)


def test_fixpoint_rejects_non_idempotent_semirings():
    rng = np.random.default_rng(13)
    _, top = _panes(*_rand_pane(rng, 64))
    with pytest.raises(ValueError, match="idempotent"):
        tspmv.fixpoint(tspmv.PLUS_TIMES, top, torch.zeros((C,), dtype=torch.float32), max_iters=4)
    with pytest.raises(ValueError, match="idempotent"):
        tspmv.fixpoint(tspmv.PLUS_ONE, top, torch.zeros((C,), dtype=torch.int32), max_iters=4)
    with pytest.raises(ValueError, match="direction"):
        tspmv.fixpoint(tspmv.MIN_PLUS, top, torch.zeros((C,), dtype=torch.float32), max_iters=4, direction="sideways")


def test_spmv_stats_registry_counts_direction_split():
    rng = np.random.default_rng(17)
    src, dst, w, msk = _rand_pane(rng, 256, skew=True)
    _, top = _panes(src, dst, w, msk)
    x0 = torch.full((C,), tspmv.MIN_PLUS.identity, dtype=torch.float32)
    x0[0] = 0.0
    tmetrics.reset_spmv_stats()
    res = tspmv.fixpoint(tspmv.MIN_PLUS, top, x0, max_iters=C - 1)
    stats = tmetrics.spmv_stats()
    assert stats["spmv_fixpoints"] == 1
    assert stats["spmv_push_iters"] == res.push_iters
    assert stats["spmv_pull_iters"] == res.pull_iters
    assert stats["spmv_direction_switches"] == res.switches
    assert stats["spmv_iters_total"] == res.iters
    assert sum(stats[f"spmv_density_hist_{b}"] for b in range(tmetrics.SPMV_DENSITY_BINS)) == res.iters
    tmetrics.reset_spmv_stats()
    assert tmetrics.spmv_stats()["spmv_fixpoints"] == 0
    assert tmetrics.SPMV_DENSITY_BINS == jmetrics.SPMV_DENSITY_BINS


def test_fixpoint_log_and_launch_counter():
    """The twin's per-iteration log (direction, frontier size, frontier
    edges) and the CPU path's launch counter (no kernel on CPU tensors)."""
    rng = np.random.default_rng(18)
    _, top = _panes(*_rand_pane(rng, 256, skew=True))
    x0 = torch.full((C,), tspmv.MIN_PLUS.identity, dtype=torch.float32)
    x0[0] = 0.0
    tspmv.reset_launches()
    log = []
    run = tspmv.fixpoint_plain(tspmv.MIN_PLUS, top, x0, x0 != tspmv.MIN_PLUS.identity, 0.05, C - 1, log)
    res = tspmv.fixpoint(tspmv.MIN_PLUS, top, x0, max_iters=C - 1)
    assert len(log) == run.iters == res.iters
    assert sum(pull for pull, _, _ in log) == res.pull_iters
    assert log[0][1] == 1 and log[0][2] == int((top.off[1] - top.off[0]))
    assert sum(tspmv.LAUNCHES.values()) == 0


def test_cc_fixpoint_matches_jax_and_unionfind():
    rng = np.random.default_rng(15)
    for _ in range(5):
        src = rng.integers(0, C, 64).astype(np.int32)
        dst = rng.integers(0, C, 64).astype(np.int32)
        msk = rng.random(64) < 0.7
        p_want, s_want = jspmv.cc_fixpoint(juf.init_parent(C), jnp.zeros((C,), bool), jnp.asarray(src),
                                           jnp.asarray(dst), jnp.asarray(msk))
        p0, s0 = tuf.init_parent(C, CPU), torch.zeros((C,), dtype=torch.bool)
        p_uf, s_uf = tuf.union_edges_with_seen(p0.clone(), s0.clone(), torch.from_numpy(src), torch.from_numpy(dst),
                                               torch.from_numpy(msk))
        p_got, s_got = tspmv.cc_fixpoint(p0, s0, torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(msk))
        assert p_got is p0 and s_got is s0  # in place
        np.testing.assert_array_equal(p_got.numpy(), np.asarray(p_want))
        np.testing.assert_array_equal(s_got.numpy(), np.asarray(s_want))
        assert torch.equal(p_got, p_uf) and torch.equal(s_got, s_uf)


def test_resolve_direction_env_knob(monkeypatch):
    monkeypatch.delenv("GELLY_SPMV_DIRECTION", raising=False)
    assert tspmv.resolve_direction(TCFG) == "auto"
    monkeypatch.setenv("GELLY_SPMV_DIRECTION", "pull")
    assert tspmv.resolve_direction(TCFG) == "pull"
    monkeypatch.setenv("GELLY_SPMV_DIRECTION", " Push ")
    assert tspmv.resolve_direction(TCFG) == "push"
    assert tspmv.resolve_direction(dataclasses.replace(TCFG, spmv_direction="auto")) == "auto"  # cfg beats env
    monkeypatch.setenv("GELLY_SPMV_DIRECTION", "sideways")
    with pytest.raises(ValueError, match="GELLY_SPMV_DIRECTION"):
        tspmv.resolve_direction(TCFG)


def test_resolve_threshold_env_knob(monkeypatch):
    monkeypatch.delenv("GELLY_DIRECTION_THRESHOLD", raising=False)
    assert tspmv.resolve_threshold(TCFG) == tspmv.DEFAULT_DIRECTION_THRESHOLD == jspmv.DEFAULT_DIRECTION_THRESHOLD
    monkeypatch.setenv("GELLY_DIRECTION_THRESHOLD", "0.25")
    assert tspmv.resolve_threshold(TCFG) == 0.25
    assert tspmv.resolve_threshold(dataclasses.replace(TCFG, direction_threshold=0.75)) == 0.75
    for bad in ("lots", "1.5", "-0.1"):
        monkeypatch.setenv("GELLY_DIRECTION_THRESHOLD", bad)
        with pytest.raises(ValueError, match="GELLY_DIRECTION_THRESHOLD"):
            tspmv.resolve_threshold(TCFG)


def test_envswitch_copy_refuses_unrecognized_spellings(monkeypatch):
    monkeypatch.delenv("GELLY_SPMV_DIRECTION", raising=False)
    assert envswitch.env_choice("GELLY_SPMV_DIRECTION", tspmv.DIRECTIONS, "auto") == "auto"
    monkeypatch.setenv("GELLY_SPMV_DIRECTION", "maybe")
    with pytest.raises(ValueError, match="auto/push/pull"):
        envswitch.env_choice("GELLY_SPMV_DIRECTION", tspmv.DIRECTIONS, "auto")
    with pytest.raises(ValueError, match="recognized choice"):
        envswitch.resolve_choice("up", "GELLY_SPMV_DIRECTION", tspmv.DIRECTIONS, "auto")
    monkeypatch.setenv("GELLY_TEST_SWITCH", "On")
    assert envswitch.env_switch("GELLY_TEST_SWITCH", False) is True
    assert envswitch.resolve_switch(0, "GELLY_TEST_SWITCH") is False
    assert envswitch.resolve_switch(-1, "GELLY_TEST_SWITCH") is True
    monkeypatch.setenv("GELLY_TEST_SWITCH", "perhaps")
    with pytest.raises(ValueError, match="GELLY_TEST_SWITCH"):
        envswitch.env_switch("GELLY_TEST_SWITCH", False)


def test_config_rejects_bad_direction_fields():
    with pytest.raises(ValueError, match="spmv_direction"):
        TConfig(vertex_capacity=32, spmv_direction="sideways")
    with pytest.raises(ValueError, match="direction_threshold"):
        TConfig(vertex_capacity=32, direction_threshold=1.5)
    assert TConfig().spmv_direction == JConfig().spmv_direction == ""
    assert TConfig().direction_threshold == JConfig().direction_threshold == -1.0


def test_config_from_dict_carries_the_direction_fields():
    jcfg = JConfig(vertex_capacity=64, spmv_direction="pull", direction_threshold=0.25)
    cfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    assert (cfg.spmv_direction, cfg.direction_threshold) == ("pull", 0.25)
    assert tspmv.resolve_direction(cfg) == "pull" and tspmv.resolve_threshold(cfg) == 0.25
    assert "spmv_direction" in interop.__doc__ and "direction_threshold" in interop.__doc__
