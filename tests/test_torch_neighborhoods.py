"""Port parity: the degree-bucketed neighborhood build of the PyTorch port
against the JAX package on the CPU.

Both packages' ``build_buckets`` run on the same numpy-seeded panes in the
OUT, IN and ALL directions, with no values, a scalar value and a tuple of
value leaves, masked rows, a hub pane, out-of-range ids, E from 1 to 2^12
and an E that is not a power of two.  The port allocates only each
bucket's real rows: they, ``num_keys`` and every value must equal the
first ``num_keys`` rows of the JAX bucket exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.core.types import EdgeDirection as JDir
from gelly_streaming_tpu.ops import neighborhoods as jnbh
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.core.types import EdgeDirection as TDir
from gelly_streaming_tpu_torch.core.types import tree_leaves
from gelly_streaming_tpu_torch.ops import neighborhoods as tnbh

DIRECTIONS = ["OUT", "IN", "ALL"]
VALUES = ["none", "scalar", "tuple"]


def _directed(src, dst, val, direction):
    """slice()'s direction semantics on host arrays."""
    if direction == "IN":
        return dst, src, val
    if direction == "ALL":
        return (np.concatenate([src, dst]), np.concatenate([dst, src]),
                None if val is None else tuple(np.concatenate([a, a]) for a in val))
    return src, dst, val


def _pane(rng, n, values, ids=64):
    src, dst = rng.integers(0, ids, n), rng.integers(0, ids, n)
    val = {
        "none": None,
        "scalar": (rng.random(n).astype(np.float32),),
        "tuple": (rng.integers(-50, 50, n).astype(np.int32), rng.random(n).astype(np.float32),
                  rng.random(n) < 0.5),
    }[values]
    return src, dst, val


def _padded(src, dst, val, mask=None, e_pad=None):
    """The pow2 pad of SnapshotStream._padded_pane_edges, plus masked rows."""
    n = len(src)
    e_pad = e_pad or max(1, 1 << (n - 1).bit_length())
    m = np.zeros(e_pad, bool)
    m[:n] = True if mask is None else mask

    def pad(a):
        out = np.zeros((e_pad,) + a.shape[1:], a.dtype)
        out[:n] = a
        return out

    return (pad(np.asarray(src, np.int32)), pad(np.asarray(dst, np.int32)),
            None if val is None else tuple(pad(a) for a in val), m)


def _both(src, dst, val, mask, single_leaf=False):
    """(JAX buckets, port buckets) of the same padded pane.  A scalar value
    goes in as one bare leaf when ``single_leaf``."""
    jv = None if val is None else tuple(jnp.asarray(a) for a in val)
    tv = None if val is None else tuple(torch.from_numpy(a) for a in val)
    if single_leaf and val is not None:
        jv, tv = jv[0], tv[0]
    jb = jnbh.build_buckets(jnp.asarray(src), jnp.asarray(dst), jv, jnp.asarray(mask))
    tb = tnbh.build_buckets(torch.from_numpy(src), torch.from_numpy(dst), tv, torch.from_numpy(mask))
    return jb, tb


def _assert_equal(jb, tb):
    assert len(jb) == len(tb)
    for j, t in zip(jb, tb):
        n = int(j.num_keys)
        assert t.num_keys == n and isinstance(t.num_keys, int)
        assert t.keys.shape == (n,) and t.nbrs.shape == (n, j.nbrs.shape[1])
        np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys)[:n])
        np.testing.assert_array_equal(t.nbrs.numpy(), np.asarray(j.nbrs)[:n])
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid)[:n])
        jl, tl = jax.tree.leaves(j.vals), tree_leaves(t.vals)
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            assert b.numpy().dtype == np.asarray(a).dtype
            np.testing.assert_array_equal(b.numpy(), np.asarray(a)[:n])


@pytest.mark.parametrize("e", [1, 2, 8, 64, 512, 4096])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_build_buckets_matches_jax(e, direction):
    """E from 1 (2 in the ALL direction, which doubles the edges) to 2^12;
    the value kind cycles with the size."""
    values = VALUES[[1, 2, 8, 64, 512, 4096].index(e) % 3]
    rng = np.random.default_rng(e + DIRECTIONS.index(direction))
    n = max(1, e // 2) if direction == "ALL" else e
    src, dst, val = _directed(*_pane(rng, n, values), direction)
    padded = _padded(src, dst, val)
    assert len(padded[0]) == max(e, 2 if direction == "ALL" else 1)
    _assert_equal(*_both(*padded, single_leaf=values == "scalar"))


@pytest.mark.parametrize("values", VALUES)
def test_masked_rows_match_jax(values):
    """Masked rows inside the pane (not only the pad): they join no group."""
    rng = np.random.default_rng(7)
    src, dst, val = _pane(rng, 1000, values, ids=40)
    padded = _padded(src, dst, val, mask=rng.random(1000) < 0.6)
    _assert_equal(*_both(*padded))


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_hub_pane_matches_jax(direction):
    """A star of 2^11 beside Zipf edges: the hub alone in a deep bucket."""
    rng = np.random.default_rng(3)
    p = 1.0 / np.arange(1, 257) ** 1.2
    src = np.concatenate([np.zeros(2048, np.int64), rng.choice(256, 1024, p=p / p.sum())])
    dst = np.concatenate([np.arange(1, 2049), rng.integers(0, 4096, 1024)])
    perm = rng.permutation(len(src))
    jb, tb = _both(*_padded(*_directed(src[perm], dst[perm], None, direction)))
    _assert_equal(jb, tb)
    if direction != "IN":
        hub = [b for b in tb if b.num_keys and 0 in b.keys.tolist() and b.nbrs.shape[1] >= 2048]
        assert len(hub) == 1 and int(hub[0].valid.sum(1).max()) >= 2048


def test_out_of_range_ids_follow_jax():
    """Ids -1, C and C + 5 (unvalidated streams carry them): a key below 0
    surfaces as key 0, neighbor ids pass through raw."""
    c = 16
    rng = np.random.default_rng(5)
    ids = np.array([-1, c, c + 5, -c - 2, c - 1, 0, 3])
    src, dst = rng.choice(ids, 300), rng.choice(ids, 300)
    jb, tb = _both(*_padded(src, dst, None, mask=rng.random(300) < 0.8))
    _assert_equal(jb, tb)
    keys = sorted(k for b in tb for k in b.keys.tolist())
    assert min(keys) == 0 and keys.count(0) == 3 and {c, c + 5} <= set(keys)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_snapshot_panes_with_out_of_range_ids_match_jax(direction):
    """The same ids through from_collection streams and slice(): every
    bucket of every pane equal to the JAX package's."""
    c = 16
    edges = [(-1, 3, 1), (c, 2, 2), (c + 5, -1, 3), (3, c, 4), (-1, 0, 5), (0, c + 5, 6), (2, 3, 7)]
    jcfg = JConfig(vertex_capacity=c, batch_size=4, ingest_window_edges=4)
    tcfg = TConfig(vertex_capacity=c, batch_size=4, ingest_window_edges=4)
    jsnap = JStream.from_collection(edges, jcfg, batch_size=4).slice(1000, getattr(JDir, direction))
    tsnap = TStream.from_collection(edges, tcfg, batch_size=4, device="cpu").slice(1000, getattr(TDir, direction))
    jh, th = list(jsnap._neighborhood_panes()), list(tsnap._neighborhood_panes())
    assert len(jh) == len(th) > 0
    for j, t in zip(jh, th):
        assert j.pane.window_id == t.pane.window_id and j.num_keys == t.num_keys
        n = j.num_keys
        np.testing.assert_array_equal(t.keys.numpy(), np.asarray(j.keys)[:n])
        np.testing.assert_array_equal(t.nbrs.numpy(), np.asarray(j.nbrs)[:n])
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid)[:n])
        np.testing.assert_array_equal(t.vals.numpy(), np.asarray(j.vals)[:n])


def test_edge_count_not_a_power_of_two_matches_jax():
    """A key of degree E has no bucket when E is not a power of two; both
    packages drop it."""
    rng = np.random.default_rng(9)
    n = 3 * 64 + 5
    src = np.where(rng.random(n) < 0.7, 7, rng.integers(0, 20, n)).astype(np.int32)
    dst = rng.integers(0, 20, n).astype(np.int32)
    jb, tb = _both(src, dst, None, np.ones(n, bool))
    _assert_equal(jb, tb)
    assert 7 not in [k for b in tb for k in b.keys.tolist()]


@pytest.mark.parametrize("e_pad", [0, 1, 2, 3, 1024, 1 << 22])
def test_bucket_shapes_are_the_jax_packages(e_pad):
    assert tnbh.bucket_shapes(e_pad) == jnbh.bucket_shapes(e_pad)


def test_cpu_build_launches_no_kernel_and_checks_its_inputs():
    tnbh.reset_launches()
    src = torch.tensor([1, 2, 1, 0], dtype=torch.int32)
    mask = torch.ones(4, dtype=torch.bool)
    out = tnbh.build_buckets(src, src.flip(0).contiguous(), None, mask)
    assert [b.num_keys for b in out] == [2, 1, 0] and tnbh.LAUNCHES["build_buckets"] == 0
    with pytest.raises(ValueError, match="src must be"):
        tnbh.build_buckets(src.long(), src, None, mask)
    with pytest.raises(ValueError, match="mask must"):
        tnbh.build_buckets(src, src, None, mask[:3])
    with pytest.raises(ValueError, match="value leaf"):
        tnbh.build_buckets(src, src, torch.zeros(3), mask)


@pytest.mark.parametrize("bits,lo,plan", [(1, 0, (0,)), (9, -3, (0, 8)), (20, 5, (0, 8, 16)),
                                          (31, -(1 << 30), (0, 8, 16, 24))])
def test_radix_plan_sorts_the_range_in_8_bit_digits(bits, lo, plan):
    """The CUDA sort's passes for valid sources spanning exactly ``bits``
    bits above lo: one 8-bit digit a pass, and no pass for bits above."""
    hi = lo + (1 << bits) - 1
    assert (hi - lo).bit_length() == bits
    assert tnbh.radix_plan(lo, hi) == plan
    assert tnbh.radix_plan(lo, lo + (1 << (bits - 1))) == plan  # the top bit alone sets the count
    assert len(plan) <= len(tnbh.radix_plan(-(1 << 31), (1 << 31) - 1)) == 4  # csrc's kMaxPasses


def test_radix_plan_of_an_all_masked_pane_is_one_pass():
    src = torch.tensor([5, -3, 9, 5], dtype=torch.int32)
    mask = torch.zeros(4, dtype=torch.bool)
    s, d, i, passes = tnbh.sort_valid_rows(src, src.flip(0).contiguous(), mask)
    assert tnbh.radix_plan(None, None) == (0,) and passes == 1
    assert s.numel() == d.numel() == i.numel() == 0
    assert tnbh.radix_plan(7, 7) == (0,)  # one key: the pass only drops the masked rows
    assert all(b.num_keys == 0 for b in tnbh.build_buckets(src, src, None, mask))


def test_sort_valid_rows_is_the_stable_order_of_the_valid_rows():
    rng = np.random.default_rng(9)
    n = 3000
    src = rng.integers(-40, 60, n).astype(np.int32)
    dst = rng.integers(0, 1000, n).astype(np.int32)
    mask = rng.random(n) < 0.7
    s, d, i, passes = tnbh.sort_valid_rows(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(mask))
    keep = np.flatnonzero(mask)
    order = keep[np.argsort(src[keep], kind="stable")]
    np.testing.assert_array_equal(i.numpy(), order)
    np.testing.assert_array_equal(s.numpy(), src[order])
    np.testing.assert_array_equal(d.numpy(), dst[order])
    assert passes == len(tnbh.radix_plan(int(src[keep].min()), int(src[keep].max()))) == 1
