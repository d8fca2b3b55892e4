"""CPU tests of the design ``csrc/exact_triangles.cu`` follows: the batch
folded in parallel against arrival-stamped rows.

The design is modelled here in numpy, step by step as the kernels take it,
and held exactly against the JAX package's ``triangle_update_block`` and
``triangle_update`` on the CPU:

1. the prepass: canonical (lo, hi), the first copy of each pair in its
   chunk, the pre-batch membership of hi in lo's row, and the flag that
   sends a batch to the chain kernel (an id outside [0, C), a negative
   degree, hi in lo's row past its degree);
2. each pair's first candidate copy in the batch (the kernel's hash);
3. two entries an edge, (lo's row, hi) and (hi's row, lo), stamped with
   their place in the JAX insert's order, (chunk, role, index), and
   stably sorted by row;
4. the fixed point: a repeat of a pair is ok only when the pair's first
   copy did not land in lo's row; from "no repeat ok", segmented counts of
   the ok entries until the ok set stops changing (it only grows);
5. the slots: the landed entries of a row are the first D - deg of its ok
   entries, at deg + their ordinal; each edge's rows as its chunk found
   them are the final rows cut at deg + the ok entries of earlier chunks;
6. the counts, each edge alone: old-old, old-new and new-new as the JAX
   package defines them; for the trace, one event a counter move, sorted
   by (vertex, edge) and scanned.

Streams: no overflow; a hub that overflows at D = 4; pairs repeated
across chunks through a full lo row; a cascade of repeats over five
vertex ids (five passes); a pre-batch state holding ids outside [0, C)
and a degree past D; small streams drawn by hypothesis.
"""

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.library import triangles as jtri
from gelly_streaming_tpu.ops import neighbors as jnbr

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

_j_trace = jax.jit(jtri.triangle_update)
_j_block = jax.jit(jtri.triangle_update_block, static_argnames="chunk")


def _wrap(x) -> np.ndarray:
    """int64 -> int32 with JAX's wrapping adds."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def _gather(i: int, c: int) -> int:
    i = i + c if i < 0 else i
    return min(max(i, 0), c - 1)


def _scatter(a: np.ndarray, i: int, v: int) -> None:
    i = i + a.shape[0] if i < 0 else i
    if 0 <= i < a.shape[0]:
        a[i] += v


class Fold(NamedTuple):
    nbrs: np.ndarray
    deg: np.ndarray
    dropped: int
    local: np.ndarray
    glob: int
    passes: int
    local_trace: Optional[np.ndarray]  # trace mode
    global_trace: Optional[np.ndarray]


def plan_fold(state, src, dst, mask, chunk: int, trace: bool = False) -> Optional[Fold]:
    """The redesigned fold in numpy; None where the prepass flags the
    batch for the chain kernel."""
    nbrs0, deg0, dropped0, local0, glob0 = (np.asarray(x) for x in (*state.table, state.local, state.global_count))
    c, d = nbrs0.shape
    b = len(src)
    r = 1 if trace else min(chunk, b)
    padded = b + (-b) % r
    pad = padded - b
    src = np.concatenate([np.asarray(src, np.int64), np.zeros(pad, np.int64)])
    dst = np.concatenate([np.asarray(dst, np.int64), np.zeros(pad, np.int64)])
    mask = np.concatenate([np.asarray(mask, bool), np.zeros(pad, bool)])
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    ok0 = mask & (lo != hi)
    chunk_of = np.arange(padded) // r

    # 1. the prepass
    if np.any(ok0 & ((lo < 0) | (hi >= c))):
        return None
    dpre = deg0.astype(np.int64)
    first = np.zeros(padded, bool)
    contains = np.zeros(padded, bool)
    for e in np.flatnonzero(ok0):
        if dpre[lo[e]] < 0 or dpre[hi[e]] < 0:
            return None
        k0 = chunk_of[e] * r
        first[e] = not any(ok0[i] and lo[i] == lo[e] and hi[i] == hi[e] for i in range(k0, e))
        if first[e]:
            hits = np.flatnonzero(nbrs0[lo[e]] == hi[e])
            if np.any(hits >= dpre[lo[e]]):
                return None  # hi past lo's degree: the chain kernel
            contains[e] = len(hits) > 0
    cand = first & ~contains

    # 2. each pair's first candidate copy
    f = np.full(padded, -1, np.int64)
    seen = {}
    for e in np.flatnonzero(cand):
        f[e] = seen.setdefault((lo[e], hi[e]), e)
    repeat = cand & (f != np.arange(padded))

    # 3. the entries, stamped (chunk, role, index) and sorted by row
    e_cand = np.flatnonzero(cand)
    edge = np.concatenate([e_cand, e_cand])
    role = np.concatenate([np.zeros(len(e_cand), np.int64), np.ones(len(e_cand), np.int64)])
    row = np.where(role == 0, lo[edge], hi[edge])
    val = np.where(role == 0, hi[edge], lo[edge])
    stamp = chunk_of[edge] * 2 * r + role * r + edge % r
    by_stamp = np.argsort(stamp, kind="stable")
    order = by_stamp[np.argsort(row[by_stamp], kind="stable")]
    edge, role, row, val, stamp = (a[order] for a in (edge, role, row, val, stamp))
    head = np.ones(len(row), bool)
    head[1:] = row[1:] != row[:-1]
    seg = np.cumsum(head) - 1

    # 4. the fixed point
    ok = cand & ~repeat
    passes = 0
    while True:
        passes += 1
        ok_e = ok[edge].astype(np.int64)
        incl = np.cumsum(ok_e)
        starts = np.flatnonzero(head)
        ordinal = incl - ok_e - (incl - ok_e)[starts][seg]
        landed = ok_e.astype(bool) & (dpre[row] + ordinal < d)
        landed_lo = np.zeros(padded, bool)
        landed_lo[edge[role == 0]] = landed[role == 0]
        grown = cand & (~repeat | ~landed_lo[np.maximum(f, 0)])
        if np.array_equal(grown, ok):
            break
        assert np.all(grown >= ok), "the ok set only grows"
        ok = grown

    # 5. the slots, and each edge's rows as its chunk found them
    nbrs, deg = nbrs0.copy(), deg0.copy()
    for x, y, o in zip(row[landed], val[landed], ordinal[landed]):
        nbrs[x, dpre[x] + o] = y
        deg[x] += 1
    dropped = int(dropped0) + int((ok[edge] & ~landed).sum())
    valid = np.zeros((padded, 2), np.int64)
    for i in range(len(row)):
        h = i
        while h > 0 and row[h - 1] == row[i] and stamp[h - 1] // (2 * r) == stamp[i] // (2 * r):
            h -= 1
        room = max(d - dpre[row[i]], 0)
        valid[edge[i], role[i]] = min(dpre[row[i]] + min(room, ordinal[h]), d)

    # 6. the counts
    local = local0.astype(np.int64)
    cnt = np.zeros(padded, np.int64)
    events = []  # trace: (vertex, edge, place, amount)
    for e in np.flatnonzero(ok):
        rl, rh = nbrs[lo[e], : valid[e, 0]], nbrs[hi[e], : valid[e, 1]]
        eq = rl[:, None] == rh[None, :]
        cnt[e] = eq.sum()
        for a in np.flatnonzero(eq.any(axis=1)):
            _scatter(local, int(rl[a]), 1)
            w = rl[a] + c if rl[a] < 0 else rl[a]
            if 0 <= w < c:
                events.append((int(w), e, a, 1))
        earlier = [i for i in range(chunk_of[e] * r, e) if ok[i]]
        wl, wh = {}, {}  # earlier edge -> its other end, for edges meeting lo (hi)
        for i in earlier:
            if lo[e] in (lo[i], hi[i]):
                wl[i] = hi[i] if lo[i] == lo[e] else lo[i]
            if hi[e] in (lo[i], hi[i]):
                wh[i] = hi[i] if lo[i] == hi[e] else lo[i]
        for i, w in wl.items():
            if np.any(rh == w):
                cnt[e] += 1
                _scatter(local, int(w), 1)
            n3 = sum(1 for w2 in wh.values() if w2 == w)
            cnt[e] += n3
            _scatter(local, int(w), n3)
        for i, w in wh.items():
            if np.any(rl == w):
                cnt[e] += 1
                _scatter(local, int(w), 1)
        _scatter(local, int(lo[e]), int(cnt[e]))
        _scatter(local, int(hi[e]), int(cnt[e]))
    glob = int(glob0) + int(cnt.sum())
    local_trace = global_trace = None
    if trace:
        for e in range(b):
            events.append((_gather(int(lo[e]), c), e, d, int(cnt[e])))
            events.append((_gather(int(hi[e]), c), e, d + 1, int(cnt[e])))
        events.sort(key=lambda x: (x[0], x[1], x[2]))
        local_trace = np.zeros((b, 2), np.int64)
        run, prev = 0, None
        for v, e, place, amount in events:
            run = amount + (run if v == prev else 0)
            prev = v
            if place >= d:
                local_trace[e, place - d] = int(local0[v]) + run
        local_trace = _wrap(local_trace)
        global_trace = _wrap(int(glob0) + np.cumsum(cnt[:b]))
    return Fold(nbrs, deg, dropped, _wrap(local), int(_wrap(glob)), passes, local_trace, global_trace)


# ---------------------------------------------------------------------------
# streams


def _state(c: int, d: int):
    return jtri.init_triangle_state(JConfig(vertex_capacity=c, max_degree=d))


def _odd_state(c: int, d: int):
    """A state that holds ids outside [0, C) (and -1, which reads as an
    empty slot) in valid slots, a row with its degree past D, and values
    past a row's degree that no batch edge looks for."""
    rng = np.random.default_rng(c + d)
    deg = rng.integers(0, d, c).astype(np.int32)
    nbrs = rng.integers(0, c, (c, d)).astype(np.int32)
    nbrs[np.arange(d)[None, :] >= deg[:, None]] = -1
    nbrs[2, 0], nbrs[3, 0], nbrs[4, 0] = -1, c + 5, -3
    deg[2:5] = np.maximum(deg[2:5], 1)
    deg[5] = d + 1
    nbrs[5] = rng.integers(0, c, d)
    nbrs[6, d - 1], deg[6] = c + 9, min(deg[6], d - 1)  # past the degree: never a batch edge's hi
    local = rng.integers(-5, 5, c).astype(np.int32)
    return jtri.TriangleCountState(jnbr.NeighborTable(jnp.asarray(nbrs), jnp.asarray(deg), jnp.asarray(3, jnp.int32)),
                                   jnp.asarray(local), jnp.asarray(7, jnp.int32))


def _spread(pairs, r: int):
    """Each pair alone in its chunk of r edges (the rest masked)."""
    b = len(pairs) * r
    src, dst, mask = np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, bool)
    for i, (u, v) in enumerate(pairs):
        src[i * r], dst[i * r], mask[i * r] = u, v, True
    return src, dst, mask


# row 0 full at D = 2, then each row's repeat filling the next: five passes
CASCADE = [(0, 5), (0, 6), (0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2), (3, 4), (4, 3)]
CASCADE_PASSES = 5


def _uniform(rng, b: int, c: int):
    return (rng.integers(0, c, b).astype(np.int32), rng.integers(0, c, b).astype(np.int32),
            rng.random(b) < 0.9)


def _hub(rng, b: int, c: int):
    src, dst, mask = _uniform(rng, b, c)
    src[: b // 3] = 1
    dst[b // 2: b // 2 + 3] = src[b // 2: b // 2 + 3]
    src[-6:], dst[-6:] = src[:6], dst[:6]
    return src, dst, mask


def _repeats(rng, b: int, c: int):
    """Pairs that come back in later chunks after lo's row filled."""
    src, dst, mask = _uniform(rng, b, c)
    src[: b // 2] = 0
    dst[: b // 2] = rng.integers(1, 6, b // 2)
    mask[: b // 2] = True
    return src, dst, mask


STREAMS = {
    "uniform": (_uniform, 60, 64),  # (make, C, D): no row overflows
    "hub": (_hub, 48, 4),
    "repeats": (_repeats, 32, 3),
}


def _assert_fold(want, got: Fold, trace_want=None):
    names = ("nbrs", "deg", "dropped", "local", "global_count")
    for name, a, b in zip(names, (*want.table, want.local, want.global_count),
                          (got.nbrs, got.deg, got.dropped, got.local, got.glob)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
    if trace_want is not None:
        np.testing.assert_array_equal(np.asarray(trace_want[0]), got.local_trace)
        np.testing.assert_array_equal(np.asarray(trace_want[1]), got.global_trace)


# ---------------------------------------------------------------------------
# the block fold


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("chunk", [1, 7, 64, 256])
def test_plan_equals_the_block_fold(name, chunk):
    make, c, d = STREAMS[name]
    rng = np.random.default_rng(len(name) * 100 + chunk)
    state = _state(c, d)
    passes = []
    for b in (150, 301):  # neither a multiple of 7, 64 or 256
        batch = make(rng, b, c)
        want = _j_block(state, *batch, chunk=chunk)
        got = plan_fold(state, *batch, chunk)
        _assert_fold(want, got)
        passes.append(got.passes)
        state = want
    assert int(state.global_count) > 0
    assert (int(state.table.dropped) > 0) == (name != "uniform")
    if name == "uniform":
        assert passes == [1, 1]


@pytest.mark.parametrize("chunk", [1, 7, 64, 256])
def test_plan_follows_a_cascade_of_repeats(chunk):
    """Row 0 is full, so the repeat of (0, 1) is ok and fills row 1 (two
    copies of 0); then the first copy of (1, 2) finds row 1 full and its
    repeat is ok, and so on to row 4: one pass a link."""
    state = _state(8, 2)
    batch = _spread(CASCADE, chunk)
    want = _j_block(state, *batch, chunk=chunk)
    got = plan_fold(state, *batch, chunk)
    _assert_fold(want, got)
    assert got.passes == CASCADE_PASSES
    np.testing.assert_array_equal(np.asarray(want.table.nbrs)[1:4], [[0, 0], [1, 1], [2, 2]])
    # the same pairs in one chunk: the repeats share the first copy's chunk and are not ok
    flat = _spread(CASCADE, 1)
    got = plan_fold(state, *flat, 64)
    _assert_fold(_j_block(state, *flat, chunk=64), got)
    assert got.passes == 1


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_plan_takes_a_state_with_odd_values(chunk):
    rng = np.random.default_rng(chunk)
    c, d = 24, 5
    state = _odd_state(c, d)
    for _ in range(2):
        batch = _hub(rng, 90, c)
        batch[0][:3], batch[1][:3] = 2, [3, 4, 5]  # the rows that hold -1, C + 5, -3 and deg > D
        want = _j_block(state, *batch, chunk=chunk)
        _assert_fold(want, plan_fold(state, *batch, chunk))
        state = want


def test_plan_flags_the_batches_the_chain_kernel_takes():
    c, d = 16, 4
    state = _state(c, d)
    src, dst, mask = _uniform(np.random.default_rng(1), 40, c - 2)
    assert plan_fold(state, src, dst, mask, 8) is not None
    for u, v in ((-1, 3), (2, c), (c + 3, 1)):
        s, t = src.copy(), dst.copy()
        s[5], t[5] = u, v
        assert plan_fold(state, s, t, mask | (np.arange(40) == 5), 8) is None
        assert plan_fold(state, s, t, mask & (np.arange(40) != 5), 8) is not None  # masked: no flag
    s, t = src.copy(), dst.copy()
    s[5], t[5] = -1, -1  # a self-loop at an odd id: no flag
    assert plan_fold(state, s, t, mask, 8) is not None
    odd = _odd_state(c, d)
    nbrs = np.asarray(odd.table.nbrs).copy()
    deg = np.asarray(odd.table.deg).copy()
    deg[7], nbrs[7] = 1, [3, -1, 9, -1]  # 9 past row 7's degree: a batch edge (7, 9) flags
    held = odd._replace(table=jnbr.NeighborTable(jnp.asarray(nbrs), jnp.asarray(deg), odd.table.dropped))
    assert plan_fold(held, np.array([7], np.int32), np.array([9], np.int32), np.ones(1, bool), 8) is None
    assert plan_fold(held, np.array([7], np.int32), np.array([8], np.int32), np.ones(1, bool), 8) is not None
    deg[8] = -1
    held = odd._replace(table=jnbr.NeighborTable(jnp.asarray(nbrs), jnp.asarray(deg), odd.table.dropped))
    assert plan_fold(held, np.array([7], np.int32), np.array([8], np.int32), np.ones(1, bool), 8) is None


# ---------------------------------------------------------------------------
# the trace fold


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_plan_equals_the_trace_fold(name):
    make, c, d = STREAMS[name]
    rng = np.random.default_rng(len(name))
    state = _state(c, d)
    for b in (120, 77):
        batch = make(rng, b, c)
        want, lt, gt = _j_trace(state, *batch)
        got = plan_fold(state, *batch, 1, trace=True)
        _assert_fold(want, got, (lt, gt))
        state = want


def test_trace_plan_follows_the_cascade_and_odd_states():
    state = _state(8, 2)
    batch = _spread(CASCADE, 3)
    want, lt, gt = _j_trace(state, *batch)
    got = plan_fold(state, *batch, 1, trace=True)
    _assert_fold(want, got, (lt, gt))
    assert got.passes == CASCADE_PASSES
    state = _odd_state(24, 5)
    rng = np.random.default_rng(9)
    for _ in range(2):
        batch = _hub(rng, 70, 24)
        batch[0][:3], batch[1][:3] = 2, [3, 4, 5]
        want, lt, gt = _j_trace(state, *batch)
        _assert_fold(want, plan_fold(state, *batch, 1, trace=True), (lt, gt))
        state = want


# ---------------------------------------------------------------------------
# small drawn streams: few ids and rows of 2 or 3, so repeats, overflow and
# cascades are common


@st.composite
def _small_streams(draw):
    c = 7
    b = 24
    ids = st.integers(0, c - 1)
    src = np.array(draw(st.lists(ids, min_size=b, max_size=b)), np.int32)
    dst = np.array(draw(st.lists(ids, min_size=b, max_size=b)), np.int32)
    mask = np.array(draw(st.lists(st.booleans(), min_size=b, max_size=b)), bool) | (np.arange(b) % 3 != 0)
    return src, dst, mask


@hypothesis.settings(max_examples=60, deadline=None, derandomize=True, database=None)
@hypothesis.given(_small_streams(), _small_streams(), st.sampled_from([1, 5, 8]), st.sampled_from([2, 3]))
def test_plan_equals_both_folds_on_drawn_streams(first, second, chunk, d):
    state, tstate = _state(7, d), _state(7, d)
    for batch in (first, second):
        want = _j_block(state, *batch, chunk=chunk)
        _assert_fold(want, plan_fold(state, *batch, chunk))
        state = want
        twant, lt, gt = _j_trace(tstate, *batch)
        _assert_fold(twant, plan_fold(tstate, *batch, 1, trace=True), (lt, gt))
        tstate = twant
