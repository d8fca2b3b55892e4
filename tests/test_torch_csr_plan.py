"""CPU tests of ``csr_triangles``' plan and of the design its kernel follows.

``ops/csr_triangles.plan`` gives one call's shared-memory lookup (every
warp's filter and hash, and a long row's bitmap over the pane's ids, in
passes where the ids pass ``LOOKUP_CAP``) and its scratch, mirroring
``csrc/csr_triangles.cu``'s layout (a CUDA test holds the two equal).  The
design is emulated here in numpy (rows built by counting, each edge given
to the endpoint with the longer row, the owner's row looked up by counts
while the owned edges' rows stream past it) and held against the JAX
package's ``_superpane_count_fn`` and the port's plain twin on multisets
with duplicates and self-loops.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.library import triangles as jtri
from gelly_streaming_tpu_torch.ops import csr_triangles as ct


@pytest.mark.parametrize("k,e,n_v,scratch,count_passes", [
    (4, 1 << 17, 4096, 4_588_544, 1),  # the superbatch group
    (1, 32768, 11941, 506_368, 1),  # the sparse window (sync CSR fallback)
    (1, 1 << 20, 175957, 12_040_192, 11),  # the hub pane
])
def test_plan_at_the_main_path_shapes(k, e, n_v, scratch, count_passes):
    p = ct.plan(k, e, n_v)
    assert p.lookup_bytes == ct.LOOKUP_MIN == 64 * 1024
    assert p.bitmap_passes == 1 and p.count_passes == count_passes
    assert p.scratch_bytes == ct.scratch_bytes(k, e, n_v) == scratch
    assert p.scratch_bytes <= 15_000_000
    assert p.scratch_bytes >= 8 * k * e  # two int32 entries a slot


@pytest.mark.parametrize("n_v", [1, 4096, 524_288, 524_289, 1_000_000, 1_572_864, 1_572_865, 2_000_000, 1 << 30])
def test_lookup_bytes_follow_the_ids(n_v):
    p = ct.plan(1, 64, n_v)
    assert ct.LOOKUP_MIN <= p.lookup_bytes <= ct.LOOKUP_CAP and p.lookup_bytes % 16 == 0
    bits = 8 * p.lookup_bytes
    assert p.bitmap_passes == -(-n_v // bits)
    assert p.count_passes == -(-n_v // (p.lookup_bytes // 4))
    # one bitmap pass while the pane's ids fit the cap; the lookup never larger than the bitmap needs
    assert (p.bitmap_passes == 1) == (n_v <= 8 * ct.LOOKUP_CAP)
    assert p.lookup_bytes == ct.LOOKUP_MIN or p.lookup_bytes - 16 < -(-n_v // 8) or p.lookup_bytes == ct.LOOKUP_CAP


def test_scratch_counts_rows_and_entries():
    base = ct.scratch_bytes(2, 4096, 1000)
    # two int32 entries a slot, at least, for more slots
    assert ct.scratch_bytes(2, 8192, 1000) - base >= 8 * 2 * 4096 - 256
    # the row tables: degrees, owned counts, 64-bit work, offsets (20 bytes a row at least)
    assert ct.scratch_bytes(2, 4096, 3000) - base >= 20 * 2 * 2000 - 4 * 256
    # every piece is 256-byte aligned, so the whole is
    assert all(ct.scratch_bytes(k, e, n) % 256 == 0 for k, e, n in ((1, 1, 1), (3, 77, 1001), (16, 8192, 1250)))


def _emulate(u, v, ok, n_v):
    """The kernel's design in numpy, per pane: counting-built rows with each
    owner's owned entries first, then for each owner its row's counts looked
    up by every entry of its owned slots' rows; sum // 3."""
    out = []
    for p in range(u.shape[0]):
        a, b = u[p].astype(np.int64), v[p].astype(np.int64)
        live = ok[p] & (a >= 0) & (a < n_v) & (b >= 0) & (b < n_v)
        a, b = a[live], b[live]
        deg = np.bincount(np.concatenate([a, b]), minlength=n_v)
        a_owns = (deg[a] > deg[b]) | ((deg[a] == deg[b]) & (a >= b))  # a self-loop: its u side
        owner, other = np.where(a_owns, a, b), np.where(a_owns, b, a)
        front = collections.defaultdict(list)
        back = collections.defaultdict(list)
        for x, y in zip(owner.tolist(), other.tolist()):
            front[x].append(y)
            back[y].append(x)
        rows = {x: front[x] + back[x] for x in set(front) | set(back)}
        assert all(len(r) == deg[x] for x, r in rows.items())  # the histogram sized every row
        total = 0
        for x, owned in front.items():
            counts = collections.Counter(rows[x])
            total += sum(counts[w] for s in owned for w in rows[s])
        out.append(total // 3)
    return out


def _pane(rng, case, e_pad, n_v):
    if case == "uniform":
        a, b = rng.integers(0, n_v, e_pad), rng.integers(0, n_v, e_pad)
    elif case == "duplicates":  # repeated edges: multiplicities multiply
        a, b = rng.integers(0, 12, e_pad), rng.integers(0, 12, e_pad)
    elif case == "self_loops":
        a = rng.integers(0, n_v, e_pad)
        b = np.where(rng.random(e_pad) < 0.2, a, rng.integers(0, n_v, e_pad))
    elif case == "hub":  # one row far longer than the rest, equal degrees among the leaves
        a = np.concatenate([np.zeros(n_v - 1, np.int64), rng.integers(1, n_v, e_pad - n_v + 1)])
        b = np.concatenate([np.arange(1, n_v), rng.integers(1, n_v, e_pad - n_v + 1)])
    else:  # out-of-range ids and masked slots
        a, b = rng.integers(-3, n_v + 3, e_pad), rng.integers(-3, n_v + 3, e_pad)
    return a.astype(np.int32), b.astype(np.int32)


@pytest.mark.parametrize("cases", [["uniform", "duplicates"], ["self_loops", "hub", "uniform"],
                                   ["ragged", "duplicates", "self_loops"]])
def test_design_emulation_matches_jax_and_the_twin(cases):
    rng = np.random.default_rng(len(cases) * 7 + len(cases[0]))
    k, e_pad, n_v = len(cases), 192, 48
    u = np.zeros((k, e_pad), np.int32)
    v = np.zeros((k, e_pad), np.int32)
    for r, case in enumerate(cases):
        u[r], v[r] = _pane(rng, case, e_pad, n_v)
    ok = rng.random((k, e_pad)) < 0.9
    got = _emulate(u, v, ok, n_v)
    tu, tv = torch.from_numpy(u), torch.from_numpy(v)
    live = ok & (u >= 0) & (u < n_v) & (v >= 0) & (v < n_v)
    deg = max(int(np.bincount(np.concatenate([u[r][live[r]], v[r][live[r]]])).max()) for r in range(k))
    d = 1 << (deg - 1).bit_length()
    if (live == ok).all():  # the JAX table clamps ids outside [0, n_v); the port drops them
        want = np.asarray(jtri._superpane_count_fn(k, e_pad, n_v, d)(jnp.asarray(u), jnp.asarray(v),
                                                                     jnp.asarray(ok)))
        assert got == want.tolist()
    live = torch.from_numpy(live)
    assert got == ct.csr_triangles_plain(tu.clamp(0, n_v - 1), tv.clamp(0, n_v - 1), live, n_v, d).tolist()
    assert any(got)
