"""Port parity: the routing primitives and kernels' twins of the PyTorch
port (``ops/routing.py``, ``parallel/routing.py``, ``parallel/mesh.py``,
``core/sharded_state.py``) against the JAX package's on the CPU.

The single-shard functions (``pack_slab_deltas``, ``apply_block_deltas``,
``owner_rank``, ``delta_capacity``, ``pow2_bucket``, ``reshard_summary``)
are held against the JAX functions called directly, with full and
one-slot buffers and empty ones; the mesh functions (``device_route``,
``device_route_salted``, ``slab_exchange``, ``gather_blocks``, ``pmin`` and
kin) against the JAX ones inside ``shard_map`` over the 8 forced CPU
devices, the port over 8 CPU shards.  Everything is integer: compared
exactly.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gelly_streaming_tpu.core import sharded_state as jss
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.examples import measurements as jmeas
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu.library import degree_distribution as jdd
from gelly_streaming_tpu.parallel import mesh as jmesh
from gelly_streaming_tpu.parallel import routing as jr
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core import sharded_state as tss
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.examples import measurements as tmeas
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.library import degree_distribution as tdd
from gelly_streaming_tpu_torch.ops import routing as rk
from gelly_streaming_tpu_torch.parallel import mesh as tmesh
from gelly_streaming_tpu_torch.parallel import routing as tr

S8 = 8


@pytest.fixture
def mesh8():
    old = tmesh.set_host_device_count(S8)
    yield tmesh.make_mesh(S8, tmesh.local_devices("cpu"))
    tmesh.set_host_device_count(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_on_mesh(step, *arrays, n_out):
    spec = P(jmesh.SHARD_AXIS)
    fn = jax.jit(jmesh.shard_map(step, mesh=jmesh.make_mesh(S8), in_specs=(spec,) * len(arrays),
                                 out_specs=(spec,) * n_out))
    return [np.asarray(o) for o in fn(*[jnp.asarray(a) for a in arrays])]


# ---------------------------------------------------------------------------
# the single-shard primitives against the JAX functions


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("cap", [1, 4, 64])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.9])
def test_pack_slab_deltas_matches_jax(shards, cap, density):
    rng = np.random.default_rng(shards * 100 + cap)
    c = 256
    changed = rng.random(c) < density
    values = rng.integers(-50, 1 << 20, c).astype(np.int32)
    want = jr.pack_slab_deltas(jnp.asarray(changed), jnp.asarray(values), shards, cap, fill=7)
    got = tr.pack_slab_deltas(_t(changed), _t(values), shards, cap, fill=7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_n(g), np.asarray(w))


@pytest.mark.parametrize("owner_kind", ["modulo", "given"])
def test_owner_pack_one_owner_cap_one_and_empty(owner_kind):
    # every live row in one owner with one slot: sent, occupancy and
    # spilled decide what is retried
    n, s = 100, 4
    live = np.zeros(n, bool)
    live[np.arange(2, n, s)] = True  # owner 2 under the modulo rule
    owner = None if owner_kind == "modulo" else _t(np.full(n, 2, np.int32))
    acc = torch.zeros(3, dtype=torch.int32)
    p = rk.owner_pack(_t(live), owner, None, _t(np.arange(n, dtype=np.int32)), s, 1, want_ok=True,
                      want_sent=True, want_slot=True, acc=acc)
    first = 2  # the first live row, owner 2 either way
    assert p.sent.sum() == 1 and p.sent[first]
    assert p.counts.tolist()[2] == int(live.sum()) and acc.tolist() == [int(live.sum()), int(live.sum()) - 1,
                                                                         int(live.sum())]
    assert p.ok.view(-1).tolist() == [False, False, True, False] and p.out_b.view(-1).tolist()[2] == first
    assert int(p.slot[first]) == 2 and (p.slot[np.flatnonzero(live)[1:]] == -1).all()
    empty = rk.owner_pack(torch.zeros(0, dtype=torch.bool), None, None, torch.zeros(0, dtype=torch.int32), s, 2)
    assert empty.out_a.tolist() == [[-1, -1]] * s and empty.counts.tolist() == [0] * s


def test_owner_rank_matches_jax():
    rng = np.random.default_rng(3)
    owner = rng.integers(0, 8, 500).astype(np.int32)
    mask = rng.random(500) < 0.7
    want = jr.owner_rank(jnp.asarray(owner), jnp.asarray(mask), 8)
    np.testing.assert_array_equal(tr.owner_rank(_t(owner), _t(mask), 8).numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("shape", [(4, 16), (2, 1), (8, 32)])
def test_apply_block_deltas_matches_jax(op, shape):
    rng = np.random.default_rng(len(op) + shape[1])
    rows_n = 40
    block = rng.integers(-100, 100, rows_n).astype(np.int32)
    recv_rows = np.where(rng.random(shape) < 0.3, -1, rng.integers(-rows_n - 2, rows_n + 2, shape)).astype(np.int32)
    recv_vals = rng.integers(-1000, 1000, shape).astype(np.int32)
    fill = {"min": np.iinfo(np.int32).max, "max": 0, "add": 0}[op]
    want = jr.apply_block_deltas(jnp.asarray(block), jnp.asarray(recv_rows), jnp.asarray(recv_vals), op, fill)
    got = tr.apply_block_deltas(_t(block.copy()), _t(recv_rows), _t(recv_vals), op, fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_apply_block_deltas_all_pad_is_a_no_op():
    block = _t(np.arange(10, dtype=np.int32))
    rows = _t(np.full((4, 8), -1, np.int32))
    for op in ("min", "max", "add"):
        tr.apply_block_deltas(block, rows, _t(np.full((4, 8), -7, np.int32)), op)
    assert block.tolist() == list(range(10))


@pytest.mark.parametrize("op", ["min", "max", "add"])
def test_slab_fold_twin_and_flag(op):
    rng = np.random.default_rng(5)
    block = rng.integers(-(1 << 30), 1 << 30, 300).astype(np.int32)
    slabs = rng.integers(-(1 << 30), 1 << 30, (3, 300)).astype(np.int32)
    ref = {"min": lambda: np.minimum(block, slabs.min(0)), "max": lambda: np.maximum(block, slabs.max(0)),
           "add": lambda: (block.astype(np.int64) + slabs.astype(np.int64).sum(0)).astype(np.int32)}[op]()
    flag = torch.zeros(1, dtype=torch.int32)
    got = rk.slab_fold(_t(block.copy()), _t(slabs), op, flag)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(flag) == 1
    ident = _t(np.zeros(300, np.int32)) if op == "add" else got.clone()
    rk.slab_fold(got, [ident], op, flag)
    assert int(flag) == 1  # nothing changed: the flag does not grow


def test_wrappers_refuse_bad_inputs():
    with pytest.raises(ValueError, match="op"):
        rk.slab_fold(_t(np.zeros(4, np.int32)), [], "mul")
    with pytest.raises(ValueError, match="owners"):
        rk.owner_pack(torch.zeros(4, dtype=torch.bool), None, None, None, 0, 1)
    with pytest.raises(ValueError, match="int32"):
        rk.block_delta_fold(torch.zeros(4, dtype=torch.int64), [], [], "min")


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 1000, 1 << 20])
def test_pow2_bucket_and_delta_capacity_match_jax(n):
    assert tr.pow2_bucket(n) == jr.pow2_bucket(n)
    for shards in (1, 2, 8):
        assert tr.delta_capacity(1 << 12, shards, n) == jr.delta_capacity(1 << 12, shards, n)
    for f in ("slab_exchange_nbytes", "gather_blocks_nbytes"):
        assert getattr(tr, f)(n) == getattr(jr, f)(n)
    assert tr.delta_exchange_nbytes(8, n) == jr.delta_exchange_nbytes(8, n)


@pytest.mark.parametrize("new", [1, 2, 4, 16])
def test_reshard_summary_matches_jax(new):
    rng = np.random.default_rng(new)
    c, old = 64, 8
    cfg_j, cfg_t = JConfig(vertex_capacity=c), TConfig(vertex_capacity=c)
    label = rng.integers(0, c, (old, c // old)).astype(np.int32)
    seen = rng.random((old, c // old)) < 0.5
    want = jss.reshard_summary(jcc.CCBlocks(label, seen), cfg_j, old, new)
    got = tss.reshard_summary(tcc.CCBlocks(label, seen), cfg_t, old, new)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    deg = rng.integers(0, 9, (old, c // old)).astype(np.int32)
    want = jss.reshard_summary(jdd.DegreeBlocks(deg), cfg_j, old, new)
    np.testing.assert_array_equal(tss.reshard_summary(tdd.DegreeBlocks(deg), cfg_t, old, new).deg, np.asarray(want.deg))
    with pytest.raises(ValueError):
        tss.reshard_summary(tdd.DegreeBlocks(deg[:3]), cfg_t, old, new)


@pytest.mark.parametrize("spec", ["cc", "degree"])
def test_initial_and_shard_summary_blocks_match_jax(spec):
    c, s = 64, 4
    rng = np.random.default_rng(9)
    if spec == "cc":
        js, ts = jcc.CCShardedState(jcc.ConnectedComponents()), tcc.CCShardedState(tcc.ConnectedComponents())
        summary = {"parent": rng.integers(0, c, c).astype(np.int32), "seen": rng.random(c) < 0.5}
    else:
        js, ts = jdd.DegreeShardedState(None), tdd.DegreeShardedState(None)
        summary = {"deg": rng.integers(0, 5, c).astype(np.int32)}
    for a, b in zip(ts.initial_shard_state(TConfig(vertex_capacity=c), s),
                    js.initial_shard_state(JConfig(vertex_capacity=c), s)):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(ts.shard_summary(summary, None, s), js.shard_summary(summary, None, s)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ---------------------------------------------------------------------------
# the mesh functions against the JAX ones inside shard_map


@pytest.mark.parametrize("salted", [False, True])
@pytest.mark.parametrize("cap", [4, 16, 64])
def test_device_route_matches_jax(mesh8, salted, cap):
    rng = np.random.default_rng(cap + salted)
    per = 48
    keys = np.minimum(rng.zipf(1.3, (S8, per)) - 1, 255).astype(np.int32)
    dst = rng.integers(0, 256, (S8, per)).astype(np.int32)
    mask = rng.random((S8, per)) < 0.8
    jroute = jr.device_route_salted if salted else jr.device_route

    def step(s, d, m):
        rs, rd, rm, drop = jroute(s[0], d[0], m[0], S8, cap)
        return rs[None], rd[None], rm[None], drop[None]

    want = _jax_on_mesh(step, keys, dst, mask, n_out=4)
    troute = tr.device_route_salted if salted else tr.device_route
    got = troute(mesh8, [_t(keys[s]) for s in range(S8)], [_t(dst[s]) for s in range(S8)],
                 [_t(mask[s]) for s in range(S8)], S8, cap)
    for s in range(S8):
        for k, field in enumerate(("src", "dst", "mask")):
            np.testing.assert_array_equal(getattr(got[s], field).numpy(), want[k][s])
        assert int(got[s].dropped) == int(want[3][s])
    if cap == 4 and not salted:
        assert sum(int(g.dropped) for g in got) > 0  # the hub key overflows its one-owner buffers


def test_device_route_carries_values(mesh8):
    rng = np.random.default_rng(1)
    src = [_t(rng.integers(0, 64, 20).astype(np.int32)) for _ in range(S8)]
    dst = [_t(rng.integers(0, 64, 20).astype(np.int32)) for _ in range(S8)]
    mask = [torch.ones(20, dtype=torch.bool) for _ in range(S8)]
    val = [(s.to(torch.float32) * 0.5, s.to(torch.int64) * 3) for s in src]
    got = tr.device_route(mesh8, src, dst, mask, S8, 32, val=val)
    for r in got:
        live = r.mask
        assert torch.equal(r.val[0][live], r.src[live].to(torch.float32) * 0.5)
        assert torch.equal(r.val[1][live], r.src[live].to(torch.int64) * 3)
        assert (r.src[live] % S8 == got.index(r)).all()


def test_slab_exchange_and_gather_blocks_match_jax(mesh8):
    rng = np.random.default_rng(2)
    c = 64
    values = rng.integers(0, 1000, (S8, c)).astype(np.int32)
    blocks = rng.integers(0, 1000, (S8, c // S8)).astype(np.int32)

    def step(v, b):
        return jr.slab_exchange(v[0], S8)[None], jr.gather_blocks(b[0], S8)[None]

    want_recv, want_full = _jax_on_mesh(step, values, blocks, n_out=2)
    recv = tr.slab_exchange(mesh8, [_t(values[s]) for s in range(S8)])
    full = tr.gather_blocks(mesh8, [_t(blocks[s]) for s in range(S8)])
    for s in range(S8):
        np.testing.assert_array_equal(torch.stack(recv[s]).numpy(), want_recv[s])
        np.testing.assert_array_equal(full[s].numpy(), want_full[s])


def test_collectives_reduce_every_shard(mesh8):
    rng = np.random.default_rng(4)
    xs = rng.integers(-100, 100, (S8, 33)).astype(np.int32)
    t = [_t(xs[s]) for s in range(S8)]
    for fn, ref in ((tmesh.pmin, xs.min(0)), (tmesh.pmax, xs.max(0)), (tmesh.psum, xs.sum(0))):
        out = fn(mesh8, t)
        assert all(np.array_equal(o.numpy(), ref) for o in out)
    g = tmesh.all_gather(mesh8, t)
    assert np.array_equal(g[3].numpy(), xs)
    a2a = tmesh.all_to_all(mesh8, [_t(np.arange(S8, dtype=np.int32) + 10 * s) for s in range(S8)])
    assert [int(x) for x in a2a[2]] == [10 * s + 2 for s in range(S8)]
    assert tmesh.make_mesh(2, ["cpu", "cpu"]).groups == ((torch.device("cpu"), (0, 1)),)
    with pytest.raises(ValueError, match="requested 9 shards"):
        tmesh.make_mesh(9, tmesh.local_devices("cpu"))


def test_sharded_cc_fixpoint_matches_jax(mesh8):
    rng = np.random.default_rng(6)
    c = 64
    src = rng.integers(0, c, (S8, 12)).astype(np.int32)
    dst = rng.integers(0, c, (S8, 12)).astype(np.int32)
    parent0 = np.arange(c, dtype=np.int32)

    def step(s, d):
        return jcc.sharded_cc_fixpoint(jnp.asarray(parent0), s[0], d[0], None)[None],

    (want,) = _jax_on_mesh(step, src, dst, n_out=1)
    got = tcc.sharded_cc_fixpoint(mesh8, [_t(parent0) for _ in range(S8)], [_t(src[s]) for s in range(S8)],
                                  [_t(dst[s]) for s in range(S8)])
    for s in range(S8):
        np.testing.assert_array_equal(got[s].numpy(), want[s])
    np.testing.assert_array_equal(tcc.unshard_labels(tcc.init_label_blocks(c, 4)), jcc.unshard_labels(
        jcc.init_label_blocks(c, 4)))


def test_interop_blocks_land_on_the_mesh(mesh8):
    label = jcc.init_label_blocks(64, S8)
    seen = np.zeros((S8, 8), bool)
    blocks = interop.cc_blocks_from_numpy(label, seen, mesh8)
    assert len(blocks) == S8 and blocks[3].label.tolist() == label[3].tolist()
    assert blocks[0].seen.dtype == torch.bool
    deg = interop.degree_blocks_from_numpy(np.ones((S8, 8), np.int32), mesh8)
    assert deg[7].deg.dtype == torch.int32
    with pytest.raises(ValueError, match="blocks"):
        interop.degree_blocks_from_numpy(np.ones((3, 8), np.int32), mesh8)


def test_host_route_matches_jax_with_values():
    rng = np.random.default_rng(8)
    src = rng.integers(0, 100, 300).astype(np.int32)
    dst = rng.integers(0, 100, 300).astype(np.int32)
    val = rng.random(300).astype(np.float32)
    for key in ("src", "dst"):
        want = jr.host_route(src, dst, 4, key=key, val=val)
        got = tr.host_route(src, dst, 4, key=key, val=val)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("argv", [[], ["--capacity", "16", "--batch", "512", "--alpha", "1.1"]])
def test_routing_measurement_matches_jax(mesh8, argv):
    out = tmeas.run(["routing", "--device=cpu", *argv])
    ns = argparse.Namespace(shards=8, batch=256, capacity=64, vertices=1 << 12, alpha=1.3, seed=0)
    for k, v in zip(argv[::2], argv[1::2]):
        setattr(ns, k[2:], type(getattr(ns, k[2:]))(v))
    assert out == jmeas.measure_routing(ns)
    assert out["plain_dropped"] > 0
