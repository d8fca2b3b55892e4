"""Port parity: the fixed-state sketches of the PyTorch port against the JAX
package on the CPU.

The salted hashes on corner ids for every salt; ``hll_fold`` (m in {64,
2048, 65536}, masked rows, saturated ranks), ``cm_fold`` / ``cm_query`` (d
in {1, 4, 8}, negative ids and ids >= C, counts that wrap), ``tri_fold`` /
``tri_merge`` (two edges of one sample hash in one bucket, an edge whose
sample hash is 0xFFFFFFFF) and ``tri_sampled_closures`` (R in {64, 4096},
against JAX and a numpy pair-enumeration oracle); the three descriptors
end to end on the wire path, on event-time windows and with ``num_shards =
8`` against JAX's replicated combine; ``combine`` order-free; the
catalog's errors; the reference's three accuracy contracts run on the port;
a JAX state carried over mid-stream by ``interop.sketch_state_from_numpy``;
the plain models of the HLL filter kernel (B in {1, 4, 132} blocks, cold,
warm and odd registers, a filter over a prefix of the banks, lost nibble
stores) and of count-min's cluster merge (clusters of 1, 8 and 16, counts
that wrap, a grid past a block's private bytes) against JAX's folds.

Tolerances: registers, grids, sample rows, closure counts, ``occ`` and the
top-k ids and values exactly.  The f32 estimates within rtol 1e-6
(``hll_estimate``'s raw branch: its sum of exp2(-reg) reduces in another
order than XLA's) or, on its linear-counting branch, within
``hll_linear_tolerance(m)`` absolute (the one-ulp gaps between XLA's f32
log and torch's, grown by the cancellation; held at every zero count for
m in {64, 2048} and at every count where the logs differ for m = 2^16);
1e-5 (``tri_estimate``, which cubes p).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.library import sketches as jlib
from gelly_streaming_tpu.summaries import sketches as jsk
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.library import sketches as tlib
from gelly_streaming_tpu_torch.ops import sketches as sko
from gelly_streaming_tpu_torch.summaries import sketches as tsk

CPU = "cpu"
SALTS = ("SALT_BUCKET", "SALT_SAMPLE", "SALT_MEMBER", "SALT_CM_ROW", "SALT_EDGE_HLL", "SALT_VERTEX_HLL")
CORNERS = np.array([0, 1, 2, 7, 2**31 - 1, -1, -(2**31), -2, 12345], np.int32)  # -1: the u32 maximum's bits
RTOL = {"hll": 1e-6, "tri": 1e-5}
_tri_fold = jax.jit(jsk.tri_fold)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _exact(t, j):
    assert np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))


def _close(t, j, rtol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=0)


# ---------------------------------------------------------------------------
# a numpy model of the hashes (u32 arithmetic wraps in numpy) and of the
# closure count, independent of both packages


def _np_mix(x):
    x = np.atleast_1d(np.asarray(x).astype(np.uint32))
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _np_pair(lo, hi, salt):
    h = _np_mix(np.atleast_1d(np.asarray(lo).astype(np.uint32)) ^ np.uint32((salt * 0x9E3779B9) & 0xFFFFFFFF))
    return _np_mix(h ^ (np.atleast_1d(np.asarray(hi).astype(np.uint32)) * np.uint32(0x9E3779B9)))


def _closures_oracle(elo, ehi) -> int:
    """Ordered pairs of valid rows sharing a vertex whose other endpoints
    differ and close an edge whose member hash is a valid row's, // 2."""
    elo, ehi = np.asarray(elo), np.asarray(ehi)
    valid = elo != -1
    members = np.setdiff1d(_np_pair(elo[valid], ehi[valid], jsk.SALT_MEMBER), [0xFFFFFFFF])
    rows = np.nonzero(valid)[0]
    # (shared vertex, row, other endpoint), each valid row twice
    inc = np.concatenate([np.stack([elo[rows], rows, ehi[rows]], 1), np.stack([ehi[rows], rows, elo[rows]], 1)])
    closed = 0
    for v in np.unique(inc[:, 0]):
        r, o = inc[inc[:, 0] == v, 1], inc[inc[:, 0] == v, 2]
        i, j = np.meshgrid(np.arange(len(r)), np.arange(len(r)), indexing="ij")
        keep = (r[i] != r[j]) & (o[i] != o[j])
        a, b = o[i][keep], o[j][keep]
        closed += int(np.isin(_np_pair(np.minimum(a, b), np.maximum(a, b), jsk.SALT_MEMBER), members).sum())
    return closed // 2


def _unmix32(y: int) -> int:
    m = 0xFFFFFFFF
    y ^= y >> 16
    y = (y * pow(0xC2B2AE35, -1, 1 << 32)) & m
    y ^= (y >> 13) ^ (y >> 26)
    y = (y * pow(0x85EBCA6B, -1, 1 << 32)) & m
    return y ^ (y >> 16)


def _edges_with_sample_hash(target: int, los: np.ndarray):
    """Canonical edges (lo, hi), lo < hi, whose sample hash is ``target``:
    hi solved from hash_pair's second fmix32 (fmix32 is a bijection and
    GOLDEN is odd)."""
    h1 = _np_mix(los.astype(np.uint32) ^ np.uint32((jsk.SALT_SAMPLE * 0x9E3779B9) & 0xFFFFFFFF))
    hi = ((h1 ^ np.uint32(_unmix32(target))) * np.uint32(pow(0x9E3779B9, -1, 1 << 32))).view(np.int32)
    keep = hi.astype(np.int64) > los
    return los[keep].astype(np.int32), hi[keep]


# ---------------------------------------------------------------------------
# the kernels' functions


@pytest.mark.parametrize("salt", SALTS)
def test_hashes_match_jax_on_corner_ids(salt):
    s = getattr(jsk, salt)
    assert getattr(tsk, salt) == s
    x = CORNERS
    _exact(tsk.hash_u32(_t(x), s), jsk.hash_u32(_j(x), s))
    y = np.roll(x, 3)
    _exact(tsk.hash_pair_u32(_t(x), _t(y), s), jsk.hash_pair_u32(_j(x), _j(y), s))
    _exact(tsk.mix32(_t(x)), jsk.mix32(_j(x)))
    assert np.array_equal(tsk.hash_pair_u32(_t(x), _t(y), s).numpy(), _np_pair(x, y, s).astype(np.int64))


def test_sizing_and_constants_match_jax():
    for n in (1, 2, 3, 64, 65, 4096, 4097):
        assert tsk.next_pow2(n) == jsk.next_pow2(n)
    for eps in (0.001, 0.01, 0.025, 0.05, 0.3):
        assert tsk.hll_num_registers(eps) == jsk.hll_num_registers(eps)
        for delta in (0.01, 0.05, 0.3):
            assert tsk.cm_dims(eps, delta) == jsk.cm_dims(eps, delta)
            assert tsk.tri_rows(eps, delta) == jsk.tri_rows(eps, delta)
    for m in (16, 32, 64, 1024):
        assert tsk.hll_alpha(m) == jsk.hll_alpha(m)
    assert (tsk.GOLDEN, tsk.EMPTY_HASH, tsk.EMPTY_VERTEX) == (int(jsk.GOLDEN), int(jsk.EMPTY_HASH),
                                                             int(jsk.EMPTY_VERTEX))
    assert tsk.TRI_CLOSURE_BLOCK == jsk.TRI_CLOSURE_BLOCK


@pytest.mark.parametrize("m", [64, 2048, 65536])
def test_hll_fold_and_estimate_match_jax(m):
    rng = np.random.default_rng(m)
    treg, jreg = tsk.hll_init(m, CPU), jsk.hll_init(m)
    for n in (3000, 500, 0):
        keys = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
        keys[:4] = 0  # h >> p == 0: the saturating rank 33 - p
        keys[4:8] = m - 1
        mask = rng.random(n) < 0.8
        mask[:2] = True
        assert tsk.hll_fold(treg, _t(keys.astype(np.int64)), _t(mask)) is treg
        jreg = jsk.hll_fold(jreg, _j(keys), _j(mask))
        _exact(treg, jreg)
        _close(tsk.hll_estimate(treg), jsk.hll_estimate(jreg), RTOL["hll"])
    if m > 64:
        assert int(treg.max()) == 33 - (m.bit_length() - 1)


def _linear_regs(m, zeros, rng):
    """m registers, ``zeros`` of them 0 and the rest ranks 1-2 at seeded
    places: the estimate takes the linear count (raw <= 2.5 m)."""
    regs = rng.integers(1, 3, m).astype(np.int32)
    regs[rng.permutation(m)[:zeros]] = 0
    raw = jsk.hll_alpha(m) * m * m / np.exp2(-regs.astype(np.float64)).sum()
    assert raw <= 2.5 * m
    return regs


_jax_hll_estimate = jax.jit(jsk.hll_estimate)  # one executable a register count, as a jitted transform runs it


def _linear_counts_close(m, zero_counts, seed):
    """The port's and JAX's estimates on registers with each zero count,
    within the stated bound; returns the largest absolute difference."""
    rng = np.random.default_rng(seed)
    tol = tsk.hll_linear_tolerance(m)
    worst = 0.0
    for z in zero_counts:
        regs = _linear_regs(m, int(z), rng)
        got, want = float(tsk.hll_estimate(_t(regs))), float(_jax_hll_estimate(_j(regs)))
        assert abs(got - want) <= tol, (m, int(z), got, want, tol)
        worst = max(worst, abs(got - want))
    return worst


@pytest.mark.parametrize("m", [64, 2048])
def test_hll_linear_count_within_its_bound_at_every_zero_count(m):
    """m * (log m - log zeros) cancels, so a one-ulp gap between XLA's f32
    log and torch's grows to m ulps of log m: held within
    ``hll_linear_tolerance(m)``, at every zero count 1..m."""
    worst = _linear_counts_close(m, range(1, m + 1), m)
    assert 0.0 < worst <= m * np.spacing(np.float32(np.log(m)))  # the logs do differ at some count


def test_hll_linear_count_within_its_bound_where_the_logs_differ():
    """m = 2^16 (``HLLDegreeSummary(eps=0.01)``): every zero count whose f32
    log differs between JAX and torch, found here over 1..m, and a seeded
    sample of the rest."""
    m = 1 << 16
    z = np.arange(1, m + 1, dtype=np.float32)
    differ = np.flatnonzero(np.asarray(jnp.log(jnp.asarray(z))) != torch.log(torch.from_numpy(z)).numpy()) + 1
    assert len(differ) > 0
    rest = np.setdiff1d(np.arange(1, m + 1), differ)
    sample = np.random.default_rng(16).choice(rest, 64, replace=False)
    _linear_counts_close(m, np.concatenate([differ, sample]), 17)


def test_hll_degree_summary_run_matches_jax_within_the_linear_bound():
    """535 uniform edges over C = 1000 in batches of 200: the registers are
    equal and the distinct-edge estimates (532.62695 against 532.6279)
    differ by less than the stated bound."""
    rng = np.random.default_rng(109)
    src, dst = rng.integers(0, 1000, 535).astype(np.int32), rng.integers(0, 1000, 535).astype(np.int32)
    kw = dict(vertex_capacity=1000, batch_size=200)
    agg, jagg = tlib.HLLDegreeSummary(eps=0.05), jlib.HLLDegreeSummary(eps=0.05)
    got = agg.run(TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)).collect()
    want = jagg.run(JStream.from_arrays(src, dst, JConfig(**kw))).collect()
    assert len(got) == len(want) == 1
    tol = tsk.hll_linear_tolerance(agg.hll_m)
    for x, y in zip(got[0], want[0]):
        assert abs(float(x) - float(y)) <= tol
    assert float(got[0][1]) != float(want[0][1])  # the case the bound exists for
    state = agg.initial_state(TConfig(**kw), torch.device(CPU))
    jstate = jagg.initial_state(JConfig(**kw))
    for i in range(0, 535, 200):
        s, d = src[i : i + 200], dst[i : i + 200]
        state = agg.update(state, _t(s), _t(d), None, torch.ones(len(s), dtype=torch.bool))
        jstate = jagg.update(jstate, _j(s), _j(d), None, jnp.ones(len(s), bool))
    for x, y in zip(state, jstate):
        _exact(x, y)


@pytest.mark.parametrize("d", [1, 4, 8])
def test_cm_fold_and_query_match_jax(d):
    w, c = 128, 100
    rng = np.random.default_rng(d)
    tg, jg = tsk.cm_init(d, w, CPU), jsk.cm_init(d, w)
    for n in (2000, 300):
        keys = rng.integers(-50, 3 * c, n).astype(np.int32)  # negative ids and ids >= C
        keys[:2] = (2**31 - 1, -(2**31))
        counts = rng.integers(-(2**30), 2**30, n).astype(np.int32)  # sums wrap as int32
        mask = rng.random(n) < 0.7
        tsk.cm_fold(tg, d, w, _t(keys), _t(counts), _t(mask))
        jg = jsk.cm_fold(jg, d, w, _j(keys), _j(counts), _j(mask))
        _exact(tg, jg)
    q = np.arange(-60, 3 * c, dtype=np.int32)
    _exact(tsk.cm_query(tg, d, w, _t(q)), jsk.cm_query(jg, d, w, _j(q)))


# ---------------------------------------------------------------------------
# the kernels' designs (ops/sketches.py's plain models of csrc/sketches.cu)


def _degree_batch(rng, n):
    src = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    dst = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    src[:len(CORNERS)], dst[:len(CORNERS)] = CORNERS, CORNERS[::-1]  # the int32 corners, a self-loop among them
    dst[20:40] = src[20:40]
    return src, dst, rng.random(n) < 0.8


def _jax_degree_fold(jv, je, src, dst, mask):
    for ids in (src, dst):
        jv = jsk.hll_fold(jv, jsk.hash_u32(_j(ids), jsk.SALT_VERTEX_HLL), _j(mask))
    lo, hi = jsk.canonical_edge(_j(src), _j(dst))
    return jv, jsk.hll_fold(je, jsk.hash_pair_u32(lo, hi, jsk.SALT_EDGE_HLL), _j(mask))


@pytest.mark.parametrize("blocks", [1, 4, 132])
@pytest.mark.parametrize("m", [64, 2048, 65536])
def test_hll_filter_model_matches_jax(m, blocks):
    """The filter design: cold registers, warm ones (a bulk fold first), a
    filter over a prefix of the banks, registers no fold writes, the last
    two with lost nibble stores; every step's registers equal JAX's
    hll_fold of the three key families."""
    rng = np.random.default_rng(m + blocks)
    tv, te = tsk.hll_init(m, CPU), tsk.hll_init(m, CPU)
    jv, je = jsk.hll_init(m), jsk.hll_init(m)
    for phase in ("cold", "warm", "prefix", "odd"):
        if phase == "warm":  # the registers after a large batch, on both sides
            bulk = _degree_batch(rng, 50 * m)
            jv, je = _jax_degree_fold(jv, je, *bulk)
            tv.copy_(_t(np.array(jv))), te.copy_(_t(np.array(je)))
        if phase == "odd":  # registers no fold writes: below 0 (a masked row raises them to 0) and past a nibble
            odd = rng.integers(-3, 40, (2, m)).astype(np.int32)
            jv, je = _j(odd[0]), _j(odd[1])
            tv.copy_(_t(odd[0])), te.copy_(_t(odd[1]))
        src, dst, mask = _degree_batch(rng, 900)
        s_t, d_t = _t(src), _t(dst)
        lo, hi = sko.canonical_edge(s_t, d_t)
        families = [(0, sko.hash_u32(s_t, sko.SALT_VERTEX_HLL)), (0, sko.hash_u32(d_t, sko.SALT_VERTEX_HLL)),
                    (1, sko.hash_pair_u32(lo, hi, sko.SALT_EDGE_HLL))]
        stats = sko.hll_filter_model([tv, te], families, _t(mask), blocks, threads=8,
                                     filter_bytes=m // 2 if phase == "prefix" else sko.FILTER_BYTES,
                                     lose=0.3 if phase in ("prefix", "odd") else 0.0, seed=blocks)
        jv, je = _jax_degree_fold(jv, je, src, dst, mask)
        _exact(tv, jv)
        _exact(te, je)
        assert stats["filtered"] + stats["reads"] == 3 * len(mask)
        if phase == "warm":
            assert stats["filtered"] > stats["reads"]  # the filter keeps most updates off the registers


@pytest.mark.parametrize("d", [1, 5, 8])
@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_cm_cluster_model_matches_jax(cluster, d):
    """Per-block private grids summed per cluster: counts that wrap int32
    and a grid past a block's private bytes, against JAX's cm_fold."""
    w = 256
    rng = np.random.default_rng(cluster * 10 + d)
    start = np.full(d * w, 2**31 - 7, np.int32)  # every counter wraps on the first adds
    tg, jg = _t(start.copy()), _j(start)
    # the whole grid private, then half of it (2 bytes a counter)
    for blocks, private in ((cluster, sko.CM_PRIVATE_BYTES), (3 * cluster, d * w * 2)):
        n = 2000
        keys = rng.integers(-50, 300, n).astype(np.int32)
        keys[:2] = (2**31 - 1, -(2**31))
        counts = rng.integers(-(2**30), 2**30, n).astype(np.int32)
        mask = rng.random(n) < 0.7
        sko.cm_cluster_model(tg, d, w, [_t(keys)], _t(counts), _t(mask), blocks, cluster, threads=16,
                             private_bytes=private)
        jg = jsk.cm_fold(jg, d, w, _j(keys), _j(counts), _j(mask))
        _exact(tg, jg)
        src, dst, emask = _degree_batch(rng, n)
        sko.cm_cluster_model(tg, d, w, [_t(src), _t(dst)], None, _t(emask), blocks, cluster, threads=16,
                             private_bytes=private)
        ones = np.ones(n, np.int32)
        for ids in (src, dst):
            jg = jsk.cm_fold(jg, d, w, _j(ids), _j(ones), _j(emask))
        _exact(tg, jg)


def _sample(ts):
    return tuple(x.numpy().astype(np.int64) for x in ts)


def _same_sample(ts, js):
    for x, y in zip(_sample(ts), js):
        assert np.array_equal(x, np.asarray(y).astype(np.int64))


@pytest.mark.parametrize("rows,c", [(64, 30), (64, 1 << 20), (4096, 300)])
def test_tri_fold_and_merge_match_jax(rows, c):
    rng = np.random.default_rng(rows + c)
    ts, js = tsk.tri_init(rows, CPU), jsk.tri_init(rows)
    parts = []
    for n in (4000, 700, 0, 1500):
        s = rng.integers(-3, c, n).astype(np.int32)
        d = rng.integers(-3, c, n).astype(np.int32)
        s[:10] = d[:10]  # self-loops take no part
        mask = rng.random(n) < 0.85
        assert tsk.tri_fold(ts, _t(s), _t(d), _t(mask))[0] is ts[0]
        js = _tri_fold(js, _j(s), _j(d), _j(mask))
        _same_sample(ts, js)
        parts.append(jsk.tri_fold(jsk.tri_init(rows), _j(s), _j(d), _j(mask)))
    # merging the parts' samples in another order gives the same rows
    merged = tuple(_t(np.asarray(x).astype(np.int64 if i == 0 else np.int32)) for i, x in enumerate(parts[3]))
    for p in parts[:3][::-1]:
        merged = tsk.tri_merge(merged, tuple(_t(np.asarray(x).astype(np.int64 if i == 0 else np.int32))
                                             for i, x in enumerate(p)))
    _same_sample(merged, js)


def test_tri_fold_equal_hashes_and_the_empty_hash():
    """Two distinct edges of one sample hash in one bucket: the lesser (lo,
    hi) wins in both packages; an edge whose sample hash is 0xFFFFFFFF is
    never sampled, even alone in its bucket."""
    cand = np.arange(-(1 << 17), 1 << 17, dtype=np.int64)
    nlo, nhi = _edges_with_sample_hash(0xFFFFFFFF, cand)
    assert len(nlo) and int(_np_pair(nlo[0], nhi[0], jsk.SALT_SAMPLE)[0]) == 0xFFFFFFFF
    target = int(_np_pair(-7, 9, jsk.SALT_SAMPLE)[0])
    tlo, thi = _edges_with_sample_hash(target, cand)
    for rows in (64, 4096):
        bucket = int(_np_pair(-7, 9, jsk.SALT_BUCKET)[0]) & (rows - 1)
        same = ((_np_pair(tlo, thi, jsk.SALT_BUCKET) & np.uint32(rows - 1)) == bucket) & (tlo != -7)
        rival = (int(tlo[same][0]), int(thi[same][0]))
        edges = [(int(nlo[0]), int(nhi[0])), (-7, 9), rival, (5, 5)]
        s = np.array([e[1] for e in edges], np.int32)
        d = np.array([e[0] for e in edges], np.int32)
        ts = tsk.tri_fold(tsk.tri_init(rows, CPU), _t(s), _t(d), None)
        js = jsk.tri_fold(jsk.tri_init(rows), _j(s), _j(d), jnp.ones(len(s), bool))
        _same_sample(ts, js)
        assert (int(ts[0][bucket]), int(ts[1][bucket]), int(ts[2][bucket])) == (target, *min((-7, 9), rival))
        kept = set(zip(ts[1].tolist(), ts[2].tolist()))
        assert (int(nlo[0]), int(nhi[0])) not in kept and (5, 5) not in kept
        assert int((ts[0] != jsk.EMPTY_HASH).sum()) == 1  # the tie's bucket alone


@pytest.mark.parametrize("rows,c,n", [(64, 12, 400), (64, 40, 3000), (4096, 60, 1 << 14), (4096, 300, 1 << 14)])
def test_tri_sampled_closures_match_jax_and_the_oracle(rows, c, n):
    rng = np.random.default_rng(rows + n)
    s = rng.integers(0, c, n).astype(np.int32)
    d = rng.integers(0, c, n).astype(np.int32)
    ts = tsk.tri_fold(tsk.tri_init(rows, CPU), _t(s), _t(d), None)
    got = tsk.tri_sampled_closures(ts[1], ts[2])
    assert got.dtype == torch.int32 and got.dim() == 0
    want = int(jax.jit(jsk.tri_sampled_closures)(_j(ts[1].numpy()), _j(ts[2].numpy())))
    assert int(got) == want == _closures_oracle(ts[1].numpy(), ts[2].numpy()) > 0


def test_tri_estimate_matches_jax():
    rng = np.random.default_rng(3)
    s = rng.integers(0, 80, 6000).astype(np.int32)
    d = rng.integers(0, 80, 6000).astype(np.int32)
    ts = tsk.tri_fold(tsk.tri_init(256, CPU), _t(s), _t(d), None)
    js = jsk.tri_fold(jsk.tri_init(256), _j(s), _j(d), jnp.ones(6000, bool))
    lo, hi = np.minimum(s, d), np.maximum(s, d)
    keys = _np_pair(lo, hi, jsk.SALT_EDGE_HLL)
    treg = tsk.hll_fold(tsk.hll_init(256, CPU), _t(keys.astype(np.int64)), _t(lo != hi))
    jreg = jsk.hll_fold(jsk.hll_init(256), _j(keys), _j(lo != hi))
    got, want = tsk.tri_estimate(ts, treg), jsk.tri_estimate(js, jreg)
    _close(got[0], want[0], RTOL["tri"])
    _exact(got[1], want[1])
    _close(got[2], want[2], RTOL["hll"])


def test_wrappers_run_the_twins_on_the_cpu_and_check_their_inputs():
    sko.reset_launches()
    regs = tsk.hll_init(64, CPU)
    keys = torch.arange(10, dtype=torch.int64)
    tsk.hll_fold(regs, keys, None)
    tsk.tri_sampled_closures(*tsk.tri_init(64, CPU)[1:])
    assert sko.TWIN_CALLS == {"hll_fold": 1, "cm_fold": 0, "tri_fold": 0, "tri_sampled_closures": 1}
    assert not any(sko.LAUNCHES.values())
    with pytest.raises(ValueError):
        tsk.hll_fold(regs, keys.to(torch.int32), None)
    with pytest.raises(ValueError):
        tsk.hll_fold(tsk.hll_init(48, CPU), keys, None)
    with pytest.raises(ValueError):
        tsk.cm_fold(tsk.cm_init(2, 64, CPU), 2, 64, keys, None, None)
    with pytest.raises(ValueError):
        sko.tri_fold(*tsk.tri_init(64, CPU), keys.int(), keys.int()[:3], None)
    with pytest.raises(ValueError):
        eh, elo, ehi = tsk.tri_init(64, CPU)
        tsk.tri_fold((eh.int(), elo, ehi), keys.int(), keys.int(), None)


# ---------------------------------------------------------------------------
# the descriptors


def _records_close(got, want, kind):
    assert len(got) == len(want) > 0
    for rt, rj in zip(got, want):
        assert len(rt) == len(rj)
        for x, y in zip(rt, rj):
            if np.asarray(y).dtype == np.float32:
                _close(x, y, RTOL["tri"] if kind == "sketch_triangles" else RTOL["hll"])
            else:
                _exact(x, y)


def _uniform(n, c, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, c, n).astype(np.int32), rng.integers(0, c, n).astype(np.int32)


@pytest.mark.parametrize("kind", tlib.SKETCH_KINDS)
def test_wire_path_emissions_match_jax(kind):
    src, dst = _uniform(5000, 200, 1)
    kw = dict(vertex_capacity=256, batch_size=512, ingest_window_edges=1024)
    agg = tlib.make_sketch(kind, eps=0.1)
    stream = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU)
    assert agg._wire_eligible(stream) and agg._wire_width(stream.cfg)[0] == "ef40"
    got = stream.aggregate(agg).collect()
    want = JStream.from_arrays(src, dst, JConfig(**kw)).aggregate(jlib.make_sketch(kind, eps=0.1)).collect()
    assert len(got) == 5
    _records_close(got, want, kind)


@pytest.mark.parametrize("kind", tlib.SKETCH_KINDS)
def test_event_time_windows_match_jax(kind):
    rng = np.random.default_rng(4)
    n = 600
    t = np.sort(rng.integers(0, 3000, n))
    s, d = _uniform(n, 64, 4)
    edges = [(int(s[i]), int(d[i]), 0.0, int(t[i])) for i in range(n)]
    got = TStream.from_collection(edges, TConfig(vertex_capacity=64), 64, with_time=True, device=CPU).aggregate(
        tlib.make_sketch(kind)).collect()
    want = JStream.from_collection(edges, JConfig(vertex_capacity=64), 64, with_time=True).aggregate(
        jlib.make_sketch(kind)).collect()
    assert len(got) == 3
    _records_close(got, want, kind)


@pytest.mark.parametrize("kind", tlib.SKETCH_KINDS)
@pytest.mark.parametrize("seed", [3, 11])
def test_eight_partitions_match_jax_replicated_combine(kind, seed):
    src, dst = _uniform(512, 64, seed)
    kw = dict(vertex_capacity=64, batch_size=64, num_shards=8, window_ms=1000)
    got = TStream.from_arrays(src, dst, TConfig(**kw), device=CPU).aggregate(tlib.make_sketch(kind)).collect()
    want = JStream.from_arrays(src, dst, JConfig(**kw, sharded_state=0)).aggregate(jlib.make_sketch(kind)).collect()
    _records_close(got, want, kind)


@pytest.mark.parametrize("kind", tlib.SKETCH_KINDS)
def test_combine_order_free_bit_identity(kind):
    agg = tlib.make_sketch(kind)
    cfg = TConfig(vertex_capacity=64)
    parts = []
    for seed in range(4):
        s, d = _uniform(128, 64, seed)
        parts.append(agg.update(agg.initial_state(cfg, torch.device(CPU)), _t(s), _t(d), None,
                                torch.ones(128, dtype=torch.bool)))
    from gelly_streaming_tpu_torch.core.aggregation import clone_state

    fwd = clone_state(parts[0])
    for p in parts[1:]:
        fwd = agg.combine(fwd, p)
    rev = clone_state(parts[3])
    for p in (parts[1], parts[2], parts[0]):
        rev = agg.combine(rev, p)
    for x, y in zip(fwd, rev):
        assert torch.equal(x, y)
    jagg = jlib.make_sketch(kind)
    jparts = [jagg.update(jagg.initial_state(JConfig(vertex_capacity=64)), *(_j(a) for a in _uniform(128, 64, seed)),
                          None, jnp.ones(128, bool)) for seed in range(4)]
    jfwd = jparts[0]
    for p in jparts[1:]:
        jfwd = jagg.combine(jfwd, p)
    for x, y in zip(fwd, jfwd):
        _exact(x, y)


def test_make_sketch_and_param_errors_match_jax():
    for kind in tlib.SKETCH_KINDS:
        t, j = tlib.make_sketch(kind), jlib.make_sketch(kind)
        assert t.error_contract() == j.error_contract()
        assert t.order_free and type(t).__name__ == type(j).__name__
    for args in [("bloom",), ("hll_degree", 0.0), ("sketch_triangles", None, 1.0), ("hll_degree", "x"),
                 ("cm_heavy_hitters", None, None, 0)]:
        with pytest.raises(tlib.SketchParamError) as te:
            tlib.make_sketch(*args)
        with pytest.raises(jlib.SketchParamError) as je:
            jlib.make_sketch(*args)
        assert str(te.value) == str(je.value)
    t = tlib.make_sketch("cm_heavy_hitters", eps=0.001, delta=0.01, top_k=16)
    assert (t.depth, t.width) == (5, 4096)
    assert tlib.SketchTriangleCount(eps=0.05, delta=0.05).rows == 4096
    assert tlib.HLLDegreeSummary(eps=0.01).hll_m == 1 << 16
    with pytest.raises(RuntimeError, match="before initial_state"):
        tlib.CountMinHeavyHitters().transform(None)


def test_top_k_puts_the_lower_id_first_among_ties():
    """jax.lax.top_k's order among equal estimates: [3, 5, 5, 1, 5, 3] ->
    [1, 2, 4, 0]."""
    agg = tlib.CountMinHeavyHitters(top_k=4)
    cfg = TConfig(vertex_capacity=6)
    state = agg.initial_state(cfg, torch.device(CPU))
    for v, k in enumerate((3, 5, 5, 1, 5, 3)):
        ids = torch.full((k,), v, dtype=torch.int32)
        sko.cm_fold(state.grid, agg.depth, agg.width, ids, None, None)
    ids, vals = agg.transform(state)
    jids = jax.lax.top_k(jnp.asarray([3, 5, 5, 1, 5, 3]), 4)[1]
    assert ids.tolist() == np.asarray(jids).tolist() == [1, 2, 4, 0]
    assert vals.tolist() == [5, 5, 5, 3]


# ---------------------------------------------------------------------------
# the reference's accuracy contracts (tests/test_sketches.py), on the port


def _skewed_edges(n, cap, seed=7):
    rng = np.random.default_rng(seed)
    comm = max(cap >> 14, 64)
    cbase = ((cap * rng.random(n) ** 2).astype(np.int64) // comm) * comm
    s = cbase + (comm * rng.random(n) ** 2).astype(np.int64)
    d = cbase + (comm * rng.random(n) ** 4).astype(np.int64)
    return (s % cap).astype(np.int32), (d % cap).astype(np.int32)


def test_hll_degree_within_contract():
    cap, n = 4096, 20_000
    src, dst = _uniform(n, cap, 5)
    cfg = TConfig(vertex_capacity=cap, batch_size=2048, ingest_window_edges=n)
    agg = tlib.HLLDegreeSummary(eps=0.05, delta=0.05)
    recs = TStream.from_arrays(src, dst, cfg, device=CPU).aggregate(agg).collect()
    v_est, e_est = float(recs[-1][0]), float(recs[-1][1])
    exact_v = len(np.unique(np.concatenate([src, dst])))
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    exact_e = len(np.unique(lo.astype(np.int64) * cap + hi))
    assert abs(v_est - exact_v) / exact_v < agg.eps
    assert abs(e_est - exact_e) / exact_e < agg.eps


def test_cm_heavy_hitters_within_contract():
    cap, n = 512, 20_000
    src, dst = _skewed_edges(n, cap, seed=9)
    cfg = TConfig(vertex_capacity=cap, batch_size=2048, ingest_window_edges=n)
    agg = tlib.CountMinHeavyHitters(eps=0.01, delta=0.02, top_k=16)
    recs = TStream.from_arrays(src, dst, cfg, device=CPU).aggregate(agg).collect()
    ids, est = recs[-1][0].numpy(), recs[-1][1].numpy()
    deg = np.bincount(src, minlength=cap) + np.bincount(dst, minlength=cap)
    assert np.all(est >= deg[ids])
    assert np.all(est - deg[ids] <= agg.eps * 2 * n)
    assert set(np.argsort(deg)[-8:].tolist()) <= set(ids.tolist())


def test_triangle_estimate_within_contract():
    cap, n = 256, 40 << 10
    src, dst = _skewed_edges(n, cap, seed=7)
    cfg = TConfig(vertex_capacity=cap, batch_size=1 << 12, ingest_window_edges=n)
    agg = tlib.SketchTriangleCount(eps=0.05, delta=0.05)
    recs = TStream.from_arrays(src, dst, cfg, device=CPU).aggregate(agg).collect()
    est = float(recs[-1][0])
    adj = np.zeros((cap, cap), dtype=np.int64)
    keep = src != dst
    adj[src[keep], dst[keep]] = 1
    adj = np.maximum(adj, adj.T)
    exact = int(np.trace(adj @ adj @ adj)) // 6
    assert exact > 0
    assert abs(est - exact) / exact < agg.eps


# ---------------------------------------------------------------------------
# a JAX state carried over mid-stream


@pytest.mark.parametrize("kind", tlib.SKETCH_KINDS)
def test_state_carried_over_from_jax_mid_stream(kind):
    src, dst = _uniform(4096, 200, 8)
    cfg_j, cfg_t = JConfig(vertex_capacity=256), TConfig(vertex_capacity=256)
    jagg, tagg = jlib.make_sketch(kind), tlib.make_sketch(kind)
    ones = jnp.ones(2048, bool)
    whole = jagg.update(jagg.update(jagg.initial_state(cfg_j), _j(src[:2048]), _j(dst[:2048]), None, ones),
                        _j(src[2048:]), _j(dst[2048:]), None, ones)
    half = jagg.update(jagg.initial_state(cfg_j), _j(src[:2048]), _j(dst[:2048]), None, ones)
    state = interop.sketch_state_from_numpy({f: np.asarray(v) for f, v in half._asdict().items()}, device=CPU)
    assert type(state).__name__ == type(half).__name__
    tagg.initial_state(cfg_t, torch.device(CPU))  # binds the top-k's id range
    state = tagg.update(state, _t(src[2048:]), _t(dst[2048:]), None, None)
    for x, y in zip(state, whole):
        _exact(x, y)
    _records_close([tagg.transform(state)], [jagg.transform(whole)], kind)


def test_sketch_state_from_numpy_checks_its_arrays():
    with pytest.raises(ValueError, match="no sketch state"):
        interop.sketch_state_from_numpy({"regs": np.zeros(64, np.int32)}, device=CPU)
    with pytest.raises(ValueError, match="power-of-two"):
        interop.sketch_state_from_numpy({"verts": np.zeros(48, np.int32), "edges": np.zeros(48, np.int32)},
                                        device=CPU)
    eh = np.full(64, 0xFFFFFFFF, np.uint32)
    with pytest.raises(ValueError, match="differ in shape"):
        interop.sketch_state_from_numpy({"eh": eh, "elo": np.zeros(32, np.int32), "ehi": np.zeros(64, np.int32),
                                         "regs": np.zeros(64, np.int32)}, device=CPU)
    st = interop.sketch_state_from_numpy({"grid": np.arange(128, dtype=np.int32)}, device=CPU)
    assert isinstance(st, tlib.CountMinState) and st.grid.dtype == torch.int32


# ---------------------------------------------------------------------------
# the plain models of tri_fold's cluster kernel and of the grouped closure
# count against JAX's tri_fold (with the edge registers' hll_fold) and
# tri_sampled_closures


def _jax_tri_update(js, jregs, s, d, mask):
    """SketchTriangleCount.update in the JAX package: the sample's fold and
    the edge registers under mask & (lo != hi)."""
    js = _tri_fold(js, _j(s), _j(d), _j(mask))
    lo, hi = jsk.canonical_edge(_j(s), _j(d))
    return js, jsk.hll_fold(jregs, jsk.hash_pair_u32(lo, hi, jsk.SALT_EDGE_HLL), _j(mask) & (lo != hi))


def _tri_model_batches(rng, rows):
    """(src, dst, mask) batches: uniform with repeats, self-loops and ids
    below 0; a batch of one edge many times; a masked batch; none."""
    out = []
    for n, c in ((5000, 3 * rows), (3000, rows // 4 + 5), (1, 10), (2500, 1 << 20), (0, 10)):
        s = rng.integers(-3, c, n).astype(np.int32)
        d = rng.integers(-3, c, n).astype(np.int32)
        s[:n // 20] = d[:n // 20]  # self-loops: no part in the sample, rank 0 in the registers
        if n == 3000:
            s[1000:1500], d[1000:1500] = s[0] + 1, d[0] + 2  # one edge many times
        out.append((s, d, rng.random(n) < (0.3 if n == 2500 else 0.85)))
    return out


@pytest.mark.parametrize("rows", [64, 4096])
@pytest.mark.parametrize("cluster", [1, 8, 16])
def test_tri_cluster_model_matches_jax(cluster, rows):
    """The cluster design at one cluster holding every edge in registers
    and at three (the tickets' merge) whose threads hold 1 edge (most read
    again for the hi step): every
    batch's sample and registers equal JAX's; carried-in registers below 0
    (a masked row or a self-loop raises its register to 0) and a row of
    the empty hash with endpoints, which a fold with no edge replaces."""
    rng = np.random.default_rng(cluster * 7 + rows)
    m = 1 << 14
    start_regs = rng.integers(-4, 3, m).astype(np.int32)  # below 0: a register a row of the batch raises to 0 or more
    eh0 = np.full(rows, 0xFFFFFFFF, np.uint32)
    elo0 = np.full(rows, -1, np.int32)
    ehi0 = np.full(rows, -1, np.int32)
    elo0[3], ehi0[3] = 5, 7  # (EMPTY_HASH, 5, 7): (EMPTY_HASH, -1, -1) precedes it
    for clusters, threads, held in ((1, sko.TRI_THREADS, sko.TRI_HELD), (3, 8, 1)):
        js = (_j(eh0), _j(elo0), _j(ehi0))
        jregs = _j(start_regs)
        ts = (_t(eh0.astype(np.int64)), _t(elo0.copy()), _t(ehi0.copy()))
        tregs = _t(start_regs.copy())
        reread = 0
        for s, d, mask in _tri_model_batches(rng, rows):
            stats = sko.tri_cluster_model(*ts, _t(s), _t(d), _t(mask), tregs, clusters, cluster, threads, held)
            js, jregs = _jax_tri_update(js, jregs, s, d, mask)
            _same_sample(ts, js)
            _exact(tregs, jregs)
            assert stats["offers"] <= int(mask.sum())
            reread += stats["reread"]
        assert (reread > 0) == (held == 1)
        below = _t(start_regs) < 0
        assert bool((below & (tregs == 0)).any()) and bool((tregs < 0).any())  # raised to 0 only by masked rows
        assert tuple(int(x[3]) for x in ts) != (0xFFFFFFFF, 5, 7)  # the row of the empty hash is gone


def test_tri_cluster_model_offers_few_his():
    """Only the edges equal to their block's least key of their bucket
    offer a hi: about one a bucket a block, of 20,000 edges."""
    rows = 64
    rng = np.random.default_rng(4)
    s = rng.integers(0, 1 << 20, 20_000).astype(np.int32)
    d = rng.integers(0, 1 << 20, 20_000).astype(np.int32)
    ts = tsk.tri_init(rows, CPU)
    stats = sko.tri_cluster_model(*ts, _t(s), _t(d), None, None, 2, 8, 64, 4)
    js = jsk.tri_fold(jsk.tri_init(rows), _j(s), _j(d), jnp.ones(len(s), bool))
    _same_sample(ts, js)
    assert stats["winners"] == rows and stats["offers"] < 16 * rows + 16  # 16 blocks, a repeated edge now and then


def _closure_samples(rows, rng):
    """{name: (elo, ehi)}: a folded sample, a star (every row on vertex
    0), a hub with a rim (closures), an empty sample, and adversarial
    states no fold makes: duplicate rows, reversed rows (lo > hi),
    self-loop rows and valid rows with ehi == -1."""
    c = max(8, rows // 6)
    s = rng.integers(0, c, 6 * rows).astype(np.int32)
    d = rng.integers(0, c, 6 * rows).astype(np.int32)
    folded = tsk.tri_fold(tsk.tri_init(rows, CPU), _t(s), _t(d), None)
    out = {"folded": (folded[1].numpy(), folded[2].numpy())}
    out["star"] = (np.zeros(rows, np.int32), np.arange(1, rows + 1, dtype=np.int32))
    lo, hi = np.full(rows, -1, np.int32), np.full(rows, -1, np.int32)
    hub, rim = rows // 2, rows // 4
    lo[:hub], hi[:hub] = 0, np.arange(1, hub + 1)
    lo[hub:hub + rim], hi[hub:hub + rim] = np.arange(1, rim + 1), np.arange(2, rim + 2)  # the rim closes wedges
    out["hub and rim"] = (lo, hi)
    out["empty"] = (np.full(rows, -1, np.int32), np.full(rows, -1, np.int32))
    lo, hi = (x.copy() for x in out["folded"])
    k = rows // 8
    idx = rng.permutation(rows)
    dup, rev, loop, neg = (idx[i * k:(i + 1) * k] for i in range(4))
    lo[dup], hi[dup] = lo[dup[::-1]], hi[dup[::-1]]  # duplicate rows
    lo[rev], hi[rev] = hi[rev], lo[rev]  # reversed rows
    lo[loop] = hi[loop]  # self-loop rows
    hi[neg] = -1  # valid rows whose hi is -1 (one more shared vertex)
    lo[idx[-3:]], hi[idx[-3:]] = -1, rng.integers(0, c, 3)  # invalid rows with a hi
    out["adversarial"] = (lo, hi)
    return out


@pytest.mark.parametrize("rows", [64, 4096])
def test_closures_grouped_model_matches_jax(rows):
    """The grouped count equals JAX's tri_sampled_closures on every
    sample, over a few blocks and the kernel's R / 32 (the pair slices),
    every block given a pair or CLOSURE_PAIRS_A_BLOCK (one block too at R
    = 64), and the twin's; nonzero where the sample closes wedges."""
    rng = np.random.default_rng(rows + 1)
    jfn = jax.jit(jsk.tri_sampled_closures)
    for name, (lo, hi) in _closure_samples(rows, rng).items():
        want = int(jfn(_j(lo), _j(hi)))
        counts = set()
        for blocks, each in ((3, 1), (None, 1), (None, sko.CLOSURE_PAIRS_A_BLOCK)) + (((1, 1),) if rows == 64 else ()):
            got, stats = sko.closures_grouped_model(_t(lo), _t(hi), blocks, each)
            assert got.dtype == torch.int32 and got.dim() == 0
            counts.add(int(got))
            grid = blocks or rows // sko.CLOSURE_ROWS_A_BLOCK
            assert len(stats["per_block"]) == min(grid, max(1, -(-stats["pairs"] // each)))
        assert counts == {want}, name
        if name in ("folded", "hub and rim"):
            assert want > 0
        if name == "star":  # one bucket holds vertex 0's rows (and the odd vertex whose hash meets it)
            assert rows * (rows - 1) // 2 <= stats["pairs"] < rows * (rows - 1) // 2 + 4 * rows
        if name == "empty":
            assert want == 0 and stats["pairs"] == 0
    assert int(sko.tri_sampled_closures_plain(_t(lo), _t(hi))) == want  # the twin on the adversarial sample


def test_closures_grouped_model_counts_a_pair_once_under_jax_first_case():
    """Rows that share two vertices (a duplicate, a reversed copy) and a
    self-loop beside an edge: each pair is counted under the one vertex
    JAX's first holding case names, never twice."""
    lo = np.array([1, 1, 2, 3, 3, 1, 2, -1], np.int32)
    hi = np.array([2, 2, 1, 3, 1, 3, 3, -1], np.int32)  # (1,2) twice, (2,1), (3,3), (3,1), (1,3), (2,3)
    want = int(jsk.tri_sampled_closures(_j(lo), _j(hi)))
    for blocks in (1, 2, 5):
        assert int(sko.closures_grouped_model(_t(lo), _t(hi), blocks)[0]) == want > 0
