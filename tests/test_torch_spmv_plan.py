"""CPU tests of the design ``csrc/spmv.cu`` follows for the min semirings'
products: balanced over the edges instead of one warp a hub segment.

The design is modelled here in numpy, step by step as the kernels take it,
and held exactly against the JAX package's ``_pull_product`` and
``_push_product`` (through ``spmv_dense`` and ``spmsv_frontier``) on the
CPU, for min-plus and min-min:

1. pull: the merge path of the segment ends d_off[1..C] with the edges of
   [d_off[0], d_off[C]) cut into tiles of ``threads * items`` items; in a
   tile each thread takes ``items`` consecutive items (found by a merge-path
   search over the tile's staged ends); a segment that begins and ends in
   one thread's items is stored, a piece of a longer one is min-combined,
   the trailing pieces of a warp's lanes merged first.  The guard of every
   write reads the value staged when the tile began (stale at most, which
   costs a write, never a value).  Every edge and every segment end lies in
   exactly one thread's items.
2. push: the frontier queue (each block a contiguous range of vertices, its
   threads' vertices thread-major, one reservation a block of rows and
   edges together, blocks in any order), whose row offsets rise with the
   queue and sum the frontier's edges; then the positions [0, fe) split
   evenly over the warps, 32 a step, each lane's row found by a search over
   the lanes.  The queue covers exactly the frontier's edges, each once.

Cases: a hub segment and a hub row longer than several whole tiles and
warp shares, empty segments, segments that end exactly on tile and
thread boundaries, ids below 0 and at C, masked rows, and small panes
drawn by hypothesis.  The combine with an identity-filled target is the
one-shot product, with min(x, identity) the fixpoint's iteration.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import spmv as jspmv
from gelly_streaming_tpu_torch.ops import spmv as tspmv

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

SEMS = {"min_plus": (jspmv.MIN_PLUS, np.float32, np.float32(1e30)),
        "min_min": (jspmv.MIN_MIN, np.int32, np.int32(2**31 - 1))}


def _mul(name, x, w):
    if name == "min_plus":
        return (np.float32(x) + np.float32(w)).astype(np.float32)
    return np.minimum(np.int32(x), np.int32(np.trunc(w)))


def _gather(i, c):
    i = i + c if i < 0 else i
    return min(max(i, 0), c - 1)


def _scatter(i, c):
    i = i + c if i < 0 else i
    return i if 0 <= i < c else -1


def _arrays(op):
    return {k: getattr(op, k).numpy() for k in ("off", "s_dst", "s_w", "d_off", "d_src", "d_w")}


# ---------------------------------------------------------------------------
# the pull


def path_split(end, n, edges, diag):
    """The merge-path coordinate (segment ends passed, edges passed) of
    item ``diag``: edge j comes before the end of segment r iff j < end[r]."""
    lo, hi = max(0, diag - edges), min(diag, n)
    while lo < hi:
        mid = (lo + hi) // 2
        if end[mid] <= diag - mid - 1:
            lo = mid + 1
        else:
            hi = mid
    return lo, diag - lo


def pull_model(name, a, c, x, preset, threads, items, warp=32):
    """The balanced pull into a copy of ``preset``: (result, edges each
    thread took, segment ends each thread took, the pieces written)."""
    _, dtype, _ = SEMS[name]
    d_off = a["d_off"].astype(np.int64)
    e0, edges = int(d_off[0]), int(d_off[c] - d_off[0])
    end = d_off[1:] - e0
    tile = threads * items
    tiles = -(-(c + edges) // tile)
    coords = [path_split(end, c, edges, min(t * tile, c + edges)) for t in range(tiles + 1)]
    out = preset.copy()
    took_edges, took_ends, writes = [], [], []
    for t in range(tiles):
        (i0, j0), (i1, j1) = coords[t], coords[t + 1]
        na, ne = i1 - i0, j1 - j0
        s_end = end[i0:i1] - j0
        s_start = (d_off[i0] - e0) - j0
        s_val = [_mul(name, x[_gather(int(a["d_src"][e0 + j0 + k]), c)], a["d_w"][e0 + j0 + k]) for k in range(ne)]
        s_cur = [out[i0 + k] if i0 + k < c else None for k in range(na + 1)]
        trailing = []
        for tid in range(threads):
            diag, dend = min(tid * items, na + ne), min(tid * items + items, na + ne)
            lo, hi = max(0, diag - ne), min(diag, na)
            while lo < hi:
                mid = (lo + hi) // 2
                if s_end[mid] <= diag - mid - 1:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, diag - lo
            whole = j == (s_start if i == 0 else s_end[i - 1])
            is_open, acc = False, None
            for _ in range(diag, dend):
                if j < ne and (i >= na or j < s_end[i]):
                    acc = s_val[j] if acc is None else min(acc, s_val[j])
                    took_edges.append(j0 + j)
                    j += 1
                    is_open = True
                else:
                    if is_open and acc < s_cur[i]:
                        writes.append((i0 + i, acc, "store" if whole else "min"))
                    took_ends.append(i0 + i)
                    is_open, acc, whole = False, None, True
                    i += 1
            trailing.append((i, acc) if is_open else (-1, None))
        for w0 in range(0, threads, warp):  # a warp's trailing pieces, one min a run of lanes
            lanes = trailing[w0:w0 + warp]
            for lane, (row, v) in enumerate(lanes):
                if row < 0 or (lane > 0 and lanes[lane - 1][0] == row):
                    continue
                for row2, v2 in lanes[lane + 1:]:
                    if row2 != row:
                        break
                    v = min(v, v2)
                if v < s_cur[row]:
                    writes.append((i0 + row, v, "min"))
    for row, v, kind in writes:
        out[row] = v if kind == "store" else min(out[row], v)
    return out.astype(dtype), took_edges, took_ends, writes


# ---------------------------------------------------------------------------
# the push


def queue_model(fm, off, c, blocks, threads, order):
    """The frontier queue: block b's vertices [b * chunk, ...), thread t's
    v = lo + t + m * threads in order; blocks reserve (rows, edges) in the
    given order.  Returns (queue, qoff, fe, frontier count)."""
    deg = np.diff(off)
    chunk = -(-c // blocks)
    per_block = []
    for b in range(blocks):
        lo, hi = min(c, b * chunk), min(c, b * chunk + chunk)
        rows = [v for t in range(threads) for v in range(lo + t, hi, threads) if fm[v] and deg[v] > 0]
        per_block.append(rows)
    queue, qoff = np.zeros(c, np.int64), np.zeros(c, np.int64)
    q = e = 0
    for b in order:
        for v in per_block[b]:
            queue[q], qoff[q] = v, e
            q += 1
            e += deg[v]
    return queue[:q], qoff[:q], e, int(fm.sum())


def push_model(name, a, c, x, preset, queue, qoff, fe, warps):
    """Each warp's even share of the frontier's edge positions, 32 a step;
    returns (result, the (source, edge) pairs taken)."""
    off, q = a["off"], len(queue)
    out, took = preset.copy(), []
    for w in range(warps):
        p0, p1 = fe * w // warps, fe * (w + 1) // warps
        if p0 >= p1:
            continue
        k = int(np.searchsorted(qoff, p0, side="right")) - 1
        for base in range(p0, p1, 32):
            qo = [qoff[k + lane] if k + lane < q else np.iinfo(np.int64).max for lane in range(32)]
            rows = []
            for lane in range(32):  # the search over the lanes
                p, r = base + lane, 0
                for s in (16, 8, 4, 2, 1):
                    if qo[r + s] <= p:
                        r += s
                rows.append(r)
                if p < p1:
                    v = int(queue[k + r])
                    e = int(off[v] + p - qo[r])
                    took.append((v, e))
                    t = _scatter(int(a["s_dst"][e]), c)
                    if t >= 0:
                        out[t] = min(out[t], _mul(name, x[v], a["s_w"][e]))
            k += rows[31]
    return out, took


# ---------------------------------------------------------------------------
# panes


def _pane(rng, case, c=64):
    e = 256
    src, dst = rng.integers(0, c, e), rng.integers(0, c // 2, e)  # the upper half: empty segments
    if case == "hub":  # a hub's in-segment and out-row over several tiles and warp shares
        src[:160], dst[160:240] = 5, 7
    elif case == "boundary":  # segments of 7 edges: every 8th item closes a segment
        dst = np.repeat(np.arange(e // 7 + 1), 7)[:e]
    elif case == "odd":  # ids below 0 and at C on masked rows
        src[[1, 2, 3]], dst[[4, 5, 6]] = (-1, c, -c), (-1, c, -2)
    w = rng.integers(1, 8, e).astype(np.float32)
    msk = rng.random(e) < 0.9
    if case == "odd":
        msk[1:7] = True
    return src.astype(np.int32), dst.astype(np.int32), w, msk


def _x(rng, name, c):
    if name == "min_min":
        return rng.integers(0, 100, c).astype(np.int32)
    x = rng.integers(0, 10, c).astype(np.float32)
    x[rng.random(c) < 0.3] = np.float32(1e30)
    return x


def _check(name, src, dst, w, msk, x, fm, c, threads, items, warps, blocks, rng):
    jsem, dtype, ident = SEMS[name]
    jop = jspmv.prepare_pane(src, dst, w, msk, c)
    a = _arrays(tspmv.prepare_pane(src, dst, w, msk, c, device="cpu"))
    want_pull = np.asarray(jspmv.spmv_dense(jsem, jop, jnp.asarray(x)))
    want_push = np.asarray(jspmv.spmsv_frontier(jsem, jop, jnp.asarray(x), jnp.asarray(fm)))
    fix = np.minimum(x, ident).astype(dtype)  # the fixpoint's target: min(x, identity)
    for preset, combine in ((np.full(c, ident, dtype), lambda y: y), (fix, lambda y: np.minimum(x, y))):
        got, took_edges, took_ends, _ = pull_model(name, a, c, x, preset, threads, items)
        np.testing.assert_array_equal(got, combine(want_pull).astype(dtype))
        e0, e1 = int(a["d_off"][0]), int(a["d_off"][c])
        assert sorted(took_edges) == list(range(e1 - e0))  # every edge in exactly one share
        assert sorted(took_ends) == list(range(c))  # every segment end in exactly one share
        queue, qoff, fe, _ = queue_model(fm, a["off"], c, blocks, threads, rng.permutation(blocks))
        deg = np.diff(a["off"])
        assert set(queue.tolist()) == {v for v in range(c) if fm[v] and deg[v] > 0} and len(set(queue)) == len(queue)
        assert fe == int(deg[fm].sum()) and np.array_equal(np.diff(np.append(qoff, fe)), deg[queue])
        got, took = push_model(name, a, c, x, preset, queue, qoff, fe, warps)
        np.testing.assert_array_equal(got, combine(want_push).astype(dtype))
        want_took = sorted((v, e) for v in range(c) if fm[v] for e in range(a["off"][v], a["off"][v + 1]))
        assert sorted(took) == want_took  # the queue covers exactly the frontier's edges


@pytest.mark.parametrize("name", sorted(SEMS))
@pytest.mark.parametrize("case", ["uniform", "hub", "boundary", "odd"])
def test_balanced_products_match_jax(name, case):
    rng = np.random.default_rng(len(case) * 11 + len(name))
    c = 64
    src, dst, w, msk = _pane(rng, case, c)
    x = _x(rng, name, c)
    fm = rng.random(c) < 0.4
    fm[5] = True  # the hub's row
    _check(name, src, dst, w, msk, x, fm, c, threads=8, items=4, warps=5, blocks=3, rng=rng)


def test_hub_segment_spans_tiles_in_pieces():
    """A hub's in-segment longer than several tiles reaches the target as
    pieces, at most one a warp's run of lanes and one a thread that closes
    it; each tile's whole segments are stored."""
    rng = np.random.default_rng(3)
    c = 64
    src, dst, w, msk = _pane(rng, "hub", c)
    msk[:] = True
    a = _arrays(tspmv.prepare_pane(src, dst, w, msk, c, device="cpu"))
    x = _x(rng, "min_plus", c)
    _, _, _, writes = pull_model("min_plus", a, c, x, np.full(c, np.float32(1e30), np.float32), 8, 4, warp=4)
    hub_pieces = [v for row, v, kind in writes if row == 7]
    assert all(kind == "min" for row, _, kind in writes if row == 7)
    assert 2 < len(hub_pieces) <= 2 * (80 // 4 + 2)  # ~80 edges over 4-item threads, 4-lane warps
    assert any(kind == "store" for _, _, kind in writes)


def test_segments_end_on_share_boundaries():
    """Segments of 7 edges with 8-item tiles: every tile starts at a
    segment's start, so no segment is split and every write is a store."""
    rng = np.random.default_rng(4)
    c = 64
    dst = np.repeat(np.arange(36), 7)[:252].astype(np.int32)
    src = rng.integers(0, c, 252).astype(np.int32)
    w = np.ones(252, np.float32)
    msk = np.ones(252, bool)
    a = _arrays(tspmv.prepare_pane(src, dst, w, msk, c, device="cpu"))
    x = _x(rng, "min_plus", c)
    d_off = a["d_off"]
    end = d_off[1:] - d_off[0]
    for t in range(5):
        i, j = path_split(end, c, 252, 8 * t)
        assert j == (end[i - 1] if i else 0)  # the tile begins where a segment begins
    _, _, _, writes = pull_model("min_plus", a, c, x, np.full(c, np.float32(1e30), np.float32), threads=1, items=8)
    assert writes and all(kind == "store" for _, _, kind in writes)
    _check("min_plus", src, dst, w, msk, x, rng.random(c) < 0.5, c, 1, 8, 3, 2, rng)


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), threads=st.sampled_from([1, 2, 8, 32, 64]),
                  items=st.sampled_from([1, 3, 8]), warps=st.integers(1, 9), blocks=st.integers(1, 5),
                  name=st.sampled_from(sorted(SEMS)))
def test_balanced_products_hypothesis(seed, threads, items, warps, blocks, name):
    rng = np.random.default_rng(seed)
    c = int(rng.integers(2, 40))
    e = int(rng.integers(1, 120))
    src = rng.integers(-2, c + 2, e).astype(np.int32)
    dst = np.where(rng.random(e) < 0.3, 0, rng.integers(-2, c + 2, e)).astype(np.int32)
    w = rng.integers(1, 8, e).astype(np.float32)
    msk = rng.random(e) < 0.8
    x = _x(rng, name, c)
    _check(name, src, dst, w, msk, x, rng.random(c) < 0.5, c, threads, items, warps, blocks, rng)
