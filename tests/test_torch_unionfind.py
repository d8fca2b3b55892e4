"""Port parity: the union-find of the PyTorch port (gelly_streaming_tpu_torch)
against the JAX package on the CPU.

The port runs its CUDA kernel's plain PyTorch twin here (CPU tensors); the
JAX side runs its lax.while_loop fold.  Inputs come from numpy seeds and
are handed to both; parent and seen must be bit-identical (tolerance:
none).  The kernel itself is held against the same twin on the GPU by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import unionfind as juf
from gelly_streaming_tpu.summaries.disjoint_set import DisjointSet as JDisjointSet
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.ops import unionfind as tuf
from gelly_streaming_tpu_torch.summaries.disjoint_set import DisjointSet as TDisjointSet

CAP = 256
EDGES = 512


def _uniform(rng):
    return rng.integers(0, CAP, EDGES), rng.integers(0, CAP, EDGES)


def _star(rng):
    hub = int(rng.integers(0, CAP))
    leaves = rng.permutation(CAP)[: EDGES // 2]
    u = np.concatenate([np.full(len(leaves), hub), rng.integers(0, CAP, EDGES - len(leaves))])
    v = np.concatenate([leaves, rng.integers(0, CAP, EDGES - len(leaves))])
    return u, v


def _zipf(rng):
    p = 1.0 / np.arange(1, CAP + 1) ** 1.2
    p /= p.sum()
    return rng.choice(CAP, EDGES, p=p), rng.choice(CAP, EDGES, p=p)


def _reverse_path(rng):
    """A path over all vertices in a random id order, its edges inserted
    from the far end first."""
    order = rng.permutation(CAP)
    u, v = order[:-1][::-1], order[1:][::-1]
    pad = rng.integers(0, CAP, EDGES - len(u))
    return np.concatenate([u, pad]), np.concatenate([v, pad])


def _self_loops(rng):
    ids = rng.integers(0, CAP, EDGES)
    return ids, ids


EDGE_CASES = {
    "uniform": _uniform,
    "star": _star,
    "zipf": _zipf,
    "reverse-path": _reverse_path,
    "self-loops": _self_loops,
}


def _forest(rng, capacity=CAP, p_root=0.3):
    """A random forest whose roots are NOT the smallest ids of their trees:
    vertices join, in a random order, under a random earlier vertex."""
    order = rng.permutation(capacity)
    parent = np.arange(capacity, dtype=np.int32)
    for k in range(1, capacity):
        if rng.random() > p_root:
            parent[order[k]] = order[rng.integers(0, k)]
    return parent


def _t(a, dtype=torch.int32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _assert_same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("start", ["identity", "forest"])
def test_union_edges_with_seen_matches_jax(case, start):
    rng = np.random.default_rng(sorted(EDGE_CASES).index(case))
    u, v = (a.astype(np.int32) for a in EDGE_CASES[case](rng))
    mask = rng.random(EDGES) < 0.85
    parent0 = np.arange(CAP, dtype=np.int32) if start == "identity" else _forest(rng)
    seen0 = rng.random(CAP) < 0.1
    jp, js = juf.union_edges_with_seen(
        jnp.asarray(parent0), jnp.asarray(seen0), jnp.asarray(u), jnp.asarray(v), jnp.asarray(mask)
    )
    parent, seen = _t(parent0), _t(seen0, torch.bool)
    got_p, got_s = tuf.union_edges_with_seen(parent, seen, _t(u), _t(v), _t(mask, torch.bool))
    assert got_p is parent and got_s is seen  # updated in place
    _assert_same(parent, jp)
    _assert_same(seen, js)
    # the unmasked fold, and union_edges alone
    jp2 = juf.union_edges(jnp.asarray(parent0), jnp.asarray(u), jnp.asarray(v))
    _assert_same(tuf.union_edges(_t(parent0), _t(u), _t(v)), jp2)


def test_fixed_point_is_the_smallest_id_after_init():
    rng = np.random.default_rng(7)
    u, v = (a.astype(np.int32) for a in _uniform(rng))
    p = tuf.union_edges(tuf.init_parent(CAP, "cpu"), _t(u), _t(v)).numpy()
    labels = np.arange(CAP)
    for _ in range(CAP):  # min-label propagation, the oracle
        m = np.minimum(labels[u], labels[v])
        np.minimum.at(labels, u, m)
        np.minimum.at(labels, v, m)
    np.testing.assert_array_equal(p, labels)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_and_find_roots_match_jax_on_non_minimum_forests(seed):
    rng = np.random.default_rng(seed)
    parent0 = _forest(rng)
    verts = rng.integers(0, CAP, 64).astype(np.int32)
    parent = _t(parent0)
    roots = tuf.find_roots(parent, _t(verts))
    _assert_same(parent, parent0)  # find_roots changes nothing
    _assert_same(roots, juf.find_roots(jnp.asarray(parent0), jnp.asarray(verts)))
    assert tuf.compress(parent) is parent
    _assert_same(parent, juf.compress(jnp.asarray(parent0)))


# forests that compress has to flatten, as parent arrays over DEEP_CAP ids
DEEP_CAP = 4096


def _reversed_path_forest(rng):
    """One chain 0 <- 1 <- ... <- C - 1: depth C - 1."""
    return np.maximum(np.arange(DEEP_CAP) - 1, 0)


def _shuffled_path_forest(rng):
    """One chain through every id in a random order."""
    order = rng.permutation(DEEP_CAP)
    parent = np.empty(DEEP_CAP, np.int64)
    parent[order] = order[np.maximum(np.arange(DEEP_CAP) - 1, 0)]
    return parent


def _star_forest(rng):
    """Every id under one hub, and a second level under some leaves."""
    hub = int(rng.integers(0, DEEP_CAP))
    parent = np.full(DEEP_CAP, hub)
    inner = rng.permutation(np.delete(np.arange(DEEP_CAP), hub))[: DEEP_CAP // 2]
    parent[inner[: DEEP_CAP // 4]] = inner[DEEP_CAP // 4 :]
    return parent


FORESTS = {
    "reversed-path": _reversed_path_forest,
    "shuffled-path": _shuffled_path_forest,
    "star": _star_forest,
    "random": lambda rng: _forest(rng, DEEP_CAP),
}


@pytest.mark.parametrize("case", sorted(FORESTS))
def test_compress_matches_jax_on_deep_and_shallow_forests(case):
    rng = np.random.default_rng(sorted(FORESTS).index(case))
    parent0 = FORESTS[case](rng).astype(np.int32)
    want = juf.compress(jnp.asarray(parent0))
    _assert_same(tuf.compress_plain(_t(parent0)), want)
    parent = _t(parent0)
    assert tuf.compress(parent) is parent
    _assert_same(parent, want)
    # a flat forest is its own compression
    _assert_same(tuf.compress_plain(_t(np.asarray(want))), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_parents_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a0, b0 = _forest(rng), _forest(rng)
    a = _t(a0)
    assert tuf.merge_parents(a, _t(b0)) is a
    _assert_same(a, juf.merge_parents(jnp.asarray(a0), jnp.asarray(b0)))
    # two states folded from edges, as the CC combine sees them
    s1, s2 = _uniform(rng), _zipf(rng)
    ja = juf.union_edges(juf.init_parent(CAP), *(jnp.asarray(x, jnp.int32) for x in s1))
    jb = juf.union_edges(juf.init_parent(CAP), *(jnp.asarray(x, jnp.int32) for x in s2))
    ta = interop.cc_state_from_numpy(np.asarray(ja), np.zeros(CAP, bool), "cpu").parent
    tb = interop.cc_state_from_numpy(np.asarray(jb), np.zeros(CAP, bool), "cpu").parent
    _assert_same(tuf.merge_parents(ta, tb), juf.merge_parents(ja, jb))


def test_incremental_batches_match_one_shot_and_jax():
    rng = np.random.default_rng(5)
    u, v = (a.astype(np.int32) for a in _uniform(rng))
    parent = tuf.init_parent(CAP, "cpu")
    jp = juf.init_parent(CAP)
    for lo in range(0, EDGES, 128):
        tuf.union_edges(parent, _t(u[lo : lo + 128]), _t(v[lo : lo + 128]))
        jp = juf.union_edges(jp, jnp.asarray(u[lo : lo + 128]), jnp.asarray(v[lo : lo + 128]))
    _assert_same(parent, jp)
    _assert_same(parent, tuf.union_edges(tuf.init_parent(CAP, "cpu"), _t(u), _t(v)))


def test_empty_and_fully_masked_batches_only_compress():
    parent0 = _forest(np.random.default_rng(9))
    empty = torch.zeros(0, dtype=torch.int32)
    _assert_same(tuf.union_edges(_t(parent0), empty, empty), juf.compress(jnp.asarray(parent0)))
    ids = _t(np.arange(8, dtype=np.int32))
    seen = torch.zeros(CAP, dtype=torch.bool)
    p, s = tuf.union_edges_with_seen(_t(parent0), seen, ids, ids.flip(0), torch.zeros(8, dtype=torch.bool))
    _assert_same(p, juf.compress(jnp.asarray(parent0)))
    assert not s.any()


def test_disjoint_set_api_matches_jax():
    rng = np.random.default_rng(11)
    jds, tds = JDisjointSet(64), TDisjointSet(64, device="cpu")
    for a, b in [(1, 2), (3, 4), (2, 4), (10, 11), (63, 0)]:
        jds.union(a, b)
        tds.union(a, b)
    u, v = rng.integers(0, 64, 20).astype(np.int32), rng.integers(0, 64, 20).astype(np.int32)
    m = rng.random(20) < 0.5
    jds.union_batch(jnp.asarray(u), jnp.asarray(v), jnp.asarray(m))
    tds.union_batch(u, v, m)
    other_j, other_t = JDisjointSet(64), TDisjointSet(64, device="cpu")
    other_j.union(5, 40)
    other_t.union(5, 40)
    jds.merge(other_j)
    tds.merge(other_t)
    assert str(tds) == str(jds)
    assert tds.components() == jds.components()
    assert tds.get_matches() == jds.get_matches()
    assert [tds.find(x) for x in range(64)] == [jds.find(x) for x in range(64)]
    _assert_same(tds.parent, jds.parent)
    _assert_same(tds.seen, jds.seen)


def test_a_flat_mark_survives_a_state_copy_and_a_write_clears_it():
    """The flat mark (set by every union call on the card) rides through
    ``clone_state``'s copies of an emitted state; ``compressed`` then reads
    the copy as it is, and a write since makes it compress a copy."""
    from gelly_streaming_tpu_torch.core.aggregation import clone_state

    parent0 = _forest(np.random.default_rng(4))
    flat = tuf.mark_flat(_t(np.asarray(juf.compress(jnp.asarray(parent0)))))
    seen = torch.zeros(CAP, dtype=torch.bool)
    copy, seen_copy = clone_state((flat, seen))
    assert copy is not flat and tuf.compressed(copy) is copy
    assert torch.equal(seen_copy, seen) and seen_copy is not seen
    copy[3] = 0
    assert tuf.compressed(copy) is not copy
    written = _t(parent0)
    _assert_same(tuf.compressed(written), juf.compress(jnp.asarray(parent0)))
    _assert_same(written, parent0)


def test_wrappers_check_arguments():
    before = dict(tuf.LAUNCHES)
    p = tuf.init_parent(16, "cpu")
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tuf.union_edges(p.to(torch.int64), ids, ids)
    with pytest.raises(ValueError):
        tuf.union_edges(p, ids, ids[:3])
    with pytest.raises(ValueError):
        tuf.union_edges(p, ids, ids, torch.ones(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        tuf.union_edges_with_seen(p, torch.zeros(8, dtype=torch.bool), ids, ids)
    with pytest.raises(ValueError):
        tuf.merge_parents(p, tuf.init_parent(8, "cpu"))
    with pytest.raises(ValueError, match="no uf_union_launch kernel"):
        tuf.union_edges(p.to("meta"), ids.to("meta"), ids.to("meta"))
    tuf.union_edges(p, ids, ids + 1)
    assert tuf.LAUNCHES == before  # the twins launch nothing
