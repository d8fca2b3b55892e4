"""CPU tests of the design ``csrc/spmv.cu`` follows for PageRank's
iteration (``pagerank_kernel``): each destination's spread, an ordered f64
sum, balanced over the edges instead of one warp a hub's in-segment.

The kernel is modelled here in numpy, add by add in the kernel's order, at
small tile sizes (``threads`` threads of ``items`` merge-path items a tile,
``warp`` lanes a warp; the card's are 256, 8 and 32), and held against the
JAX package's ``pagerank_fixpoint`` and the port's twin
``pagerank_fixpoint_plain`` (ranks within rtol 1e-5 / atol 1e-9, in_window
exact, iterations equal):

1. the plan: the merge path of the segment ends d_off[1..C] with the edges,
   cut into tiles of threads * items items (searched once a launch);
2. the vertex phase, a chunk of threads * items vertices a block, items a
   thread in order: r finalized (r0 first; then a tile's store, the carries
   of a segment spanning tiles added in tile order, or r_new of an empty
   segment), c = r / max(out_deg, 1), and the chunk's f64 partials of the
   dangling r and of |r - r_prev| (a thread's vertices in order, a
   butterfly over a warp's lanes, the warps in order); delta and dm are
   the partials summed in chunk order (lane l adds partials l, l + warp,
   ..., then a butterfly);
3. the tiles: a thread adds its items' c in f64 in edge order and stores a
   segment that lies in its items; the open pieces go through a segmented
   scan (Kogge-Stone over a warp's lanes, the warps' totals folded in
   order); the thread holding a segment's end adds the scan before it to
   its head piece and stores the sum, or writes it as the tile's head carry
   when the segment began in an earlier tile; the last thread writes the
   tail carry (and the head carry of a tile that holds no end).

Blocks take their tiles and chunks in any order: the model runs them in a
shuffled order at several block counts, and builds each destination's
addends both from the dst-stable copy (the pull's) and from the edges in
arrival order (the JAX push's scatter order).  The f32 ranks must be the
same bits in every case.
"""

import numpy as np
import pytest

from gelly_streaming_tpu.ops import spmv as jspmv
from gelly_streaming_tpu_torch.ops import spmv as tspmv

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

F32 = np.float32
RTOL, ATOL = 1e-5, 1e-9
C = 64


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


def _butterfly(vals, warp):
    """A warp's v = v + shfl_xor(v, o), o = warp / 2 .. 1 (every lane ends
    with the same bits)."""
    v, o = list(vals), warp // 2
    while o >= 1:
        v = [v[lane] + v[lane ^ o] for lane in range(warp)]
        o //= 2
    return v[0]


def _block_sum(per_thread, warp):
    t = 0.0
    for w0 in range(0, len(per_thread), warp):
        t = t + _butterfly(per_thread[w0:w0 + warp], warp)
    return t


def _grid_sum(p, warp):
    lanes = [0.0] * warp
    for lane in range(warp):
        for i in range(lane, len(p), warp):
            lanes[lane] = lanes[lane] + p[i]
    return _butterfly(lanes, warp)


def _new_rank(sp, w, base_in, damping, dm):
    zero = F32(0)
    return F32((base_in if w else zero) + F32(damping * F32(sp + (dm if w else zero))))


class Model:
    """The kernel's run over one pane (off, d_off, d_src as prepare_pane
    lays them out)."""

    def __init__(self, off, d_off, d_src, c, threads, items, warp, blocks=1, seed=None):
        assert threads % warp == 0 and warp & (warp - 1) == 0
        self.off, self.d_off, self.d_src, self.c = off.astype(np.int64), d_off.astype(np.int64), d_src, c
        self.threads, self.items, self.warp, self.tile = threads, items, warp, threads * items
        self.e0 = int(d_off[0])
        self.edges = int(d_off[c]) - self.e0
        self.tiles = -(-(c + self.edges) // self.tile)
        self.chunks = -(-c // self.tile)
        end = self.d_off[1:] - self.e0
        self.coords = [path_split(end, c, self.edges, min(t * self.tile, c + self.edges))
                       for t in range(self.tiles + 1)]
        rng = np.random.default_rng(seed)
        # block b takes tiles (chunks) b, b + blocks, ...; the blocks in any order
        self.tile_order = self._order(self.tiles, blocks, rng if seed is not None else None)
        self.chunk_order = self._order(self.chunks, blocks, rng if seed is not None else None)
        spans = [((v + self.d_off[v] - self.e0) // self.tile, (v + self.d_off[v + 1] - self.e0) // self.tile)
                 for v in range(c)]
        self.spans = spans
        self.carried = sum(1 for v, (t0, t1) in enumerate(spans) if t1 > t0)
        self.max_span = max((t1 - t0 for t0, t1 in spans), default=0)

    @staticmethod
    def _order(count, blocks, rng):
        order = [list(range(b, count, blocks)) for b in range(blocks)]
        if rng is not None:
            order = [order[b] for b in rng.permutation(blocks)]
        return [t for o in order for t in o]

    # -- the tiles ----------------------------------------------------------

    def _tile(self, t, rn, carries, consts, stored, took):
        (i0, j0), (i1, j1) = self.coords[t], self.coords[t + 1]
        na, ne = i1 - i0, j1 - j0
        e0, threads, items, warp = self.e0, self.threads, self.items, self.warp
        end = [int(self.d_off[i0 + k + 1]) - e0 - j0 for k in range(na)]
        start = int(self.d_off[i0]) - e0 - j0
        val = [float(self.cvec[int(self.d_src[e0 + j0 + k])]) for k in range(ne)]
        length = na + ne

        def store(row, s):
            rn[i0 + row] = _new_rank(F32(s), True, *consts)
            stored[i0 + row] += 1

        open_v, flags, heads = [], [], []
        for tid in range(threads):
            diag = min(tid * items, length)
            dend = min(diag + items, length)
            lo, hi = max(0, diag - ne), min(diag, na)
            while lo < hi:
                mid = (lo + hi) // 2
                if end[mid] <= diag - mid - 1:
                    lo = mid + 1
                else:
                    hi = mid
            i, j = lo, diag - lo
            starts = j == (start if i == 0 else end[i - 1])
            whole, anything, ends, head_row, acc, head = starts, False, False, -1, 0.0, 0.0
            for _ in range(diag, dend):
                if j < ne and (i >= na or j < end[i]):
                    acc = acc + val[j]
                    took["edges"].append(j0 + j)
                    j += 1
                    anything = True
                else:
                    if not whole:
                        head, head_row = acc, i
                    elif anything:
                        store(i, acc)
                    took["ends"].append(i0 + i)
                    acc, whole, ends, anything = 0.0, True, True, False
                    i += 1
            open_v.append(acc)
            flags.append(int(ends or (starts and diag < dend)))
            heads.append((head_row, head))
        # the segmented scan of the open pieces: Kogge-Stone over each warp
        v, f = open_v[:], flags[:]
        for w0 in range(0, threads, warp):
            o = 1
            while o < warp:
                nv, nfl = v[:], f[:]
                for lane in range(o, warp):
                    k = w0 + lane
                    if not f[k]:
                        nv[k] = v[k - o] + v[k]
                    nfl[k] = f[k] | f[k - o]
                v, f = nv, nfl
                o *= 2
        aggs = [(v[w0 + warp - 1], f[w0 + warp - 1]) for w0 in range(0, threads, warp)]
        full, carry_in = [], []
        for k in range(threads):  # the warps before k's, folded in warp order
            pv, pf = 0.0, 0
            for av, af in aggs[:k // warp]:
                pv = av if af else pv + av
                pf |= af
            full.append((v[k] if f[k] else pv + v[k], f[k] | pf))
            carry_in.append((pv, pf))
        for k, (head_row, head) in enumerate(heads):
            if head_row < 0:
                continue
            qv, qf = carry_in[k] if k % warp == 0 else full[k - 1]
            s = qv + head
            if qf:
                store(head_row, s)
            else:
                carries[2 * t] = s
        last_v, last_f = full[threads - 1]
        carries[2 * t + 1] = last_v
        if not last_f:
            carries[2 * t] = last_v

    # -- the vertex phase ---------------------------------------------------

    def _vertices(self, first, r, rn, carries, partials, consts, stored):
        base_in, damping, dm = consts
        c, threads, items, tile = self.c, self.threads, self.items, self.tile
        for ch in self.chunk_order:
            dang, dl = [0.0] * threads, [0.0] * threads
            for tid in range(threads):
                for m in range(items):
                    v = ch * tile + m * threads + tid
                    if v >= c:
                        continue
                    od = int(self.off[v + 1] - self.off[v])
                    lo, hi = int(self.d_off[v]) - self.e0, int(self.d_off[v + 1]) - self.e0
                    w = bool(self.in_window[v])
                    if first:
                        rv = self.r0 if w else F32(0)
                        rn[v] = rv
                    else:
                        t0, t1 = self.spans[v]
                        if lo == hi:
                            rv = _new_rank(F32(0), w, base_in, damping, dm)
                            rn[v] = rv
                            assert stored[v] == 0
                        elif t0 == t1:
                            assert stored[v] == 1  # the tile stored it, once
                            rv = rn[v]
                        else:
                            assert stored[v] == 0
                            s = carries[2 * t0 + 1]
                            for t in range(t0 + 1, t1 + 1):
                                s = s + carries[2 * t]
                            rv = _new_rank(F32(s), True, base_in, damping, dm)
                            rn[v] = rv
                        dl[tid] = dl[tid] + float(np.abs(F32(rv - r[v])))
                    self.cvec[v] = F32(rv / max(F32(od), F32(1)))
                    if od == 0 and w:
                        dang[tid] = dang[tid] + float(rv)
            partials[ch] = _block_sum(dang, self.warp)
            partials[self.chunks + ch] = 0.0 if first else _block_sum(dl, self.warp)

    def run(self, damping, tol, max_iters):
        """(r, in_window, iterations), as the kernel leaves them."""
        c = self.c
        damping, tol = F32(damping), F32(tol)
        self.in_window = (np.diff(self.off) > 0) | (np.diff(self.d_off) > 0)
        nf = max(F32(int(self.in_window.sum())), F32(1))
        base_in = F32(F32(F32(1) - damping) / nf)
        self.r0 = F32(F32(1) / nf)
        rs = np.zeros((2, c), np.float32)
        self.cvec = np.zeros(c, np.float32)
        partials = [0.0] * (2 * self.chunks)
        carries = [0.0] * (2 * self.tiles)
        self._vertices(True, None, rs[0], carries, partials, (base_in, damping, F32(0)), None)
        it = 0
        while True:
            delta = F32(np.inf) if it == 0 else F32(_grid_sum(partials[self.chunks:], self.warp))
            if not (delta > tol and it < max_iters):
                break
            dm = F32(F32(_grid_sum(partials[:self.chunks], self.warp)) / nf)
            r, rn = rs[it & 1], rs[(it & 1) ^ 1]
            consts = (base_in, damping, dm)
            stored = np.zeros(c, np.int64)
            took = {"edges": [], "ends": []}
            for t in self.tile_order:
                self._tile(t, rn, carries, consts, stored, took)
            assert sorted(took["edges"]) == list(range(self.edges))  # every edge in one thread's items
            assert sorted(took["ends"]) == list(range(c))  # every segment end too
            self._vertices(False, r, rn, carries, partials, consts, stored)
            it += 1
        return rs[it & 1].copy(), self.in_window, it


# ---------------------------------------------------------------------------
# panes and references


def _pull_arrays(src, dst, msk, c):
    op = tspmv.prepare_pane(src, dst, None, msk, c, device="cpu")
    return op.off.numpy(), op.d_off.numpy(), op.d_src.numpy()


def _push_arrays(src, dst, msk, c):
    """The addends of each destination in the JAX push's scatter order (the
    masked edges in arrival order), laid out as segments."""
    rows = [[] for _ in range(c)]
    for s, d, m in zip(src.tolist(), dst.tolist(), msk.tolist()):
        if m:
            rows[d].append(s)
    d_off = np.concatenate([[0], np.cumsum([len(r) for r in rows])]).astype(np.int32)
    d_src = np.array([s for r in rows for s in r] + [0] * int((~msk).sum()), np.int32)
    off = np.concatenate([[0], np.cumsum(np.bincount(src[msk], minlength=c))]).astype(np.int32)
    return off, d_off, d_src


def _model(src, dst, msk, c, threads, items, warp, damping=0.85, tol=1e-6, max_iters=100, **kw):
    model = Model(*_pull_arrays(src, dst, msk, c), c, threads, items, warp, **kw)
    return model, model.run(damping, tol, max_iters)


def _check_against_references(src, dst, msk, c, got, damping=0.85, tol=1e-6, max_iters=100):
    r, in_w, iters = got
    jop = jspmv.prepare_pane(src, dst, None, msk, c)
    want_r, want_in, want_it = jspmv.pagerank_fixpoint(jop, damping=damping, tol=tol, max_iters=max_iters)
    np.testing.assert_array_equal(in_w, np.asarray(want_in))
    assert iters == int(want_it)
    np.testing.assert_allclose(r, np.asarray(want_r), rtol=RTOL, atol=ATOL)
    top = tspmv.prepare_pane(src, dst, None, msk, c, device="cpu")
    twin_r, twin_in, twin_it = tspmv.pagerank_fixpoint_plain(top, damping=damping, tol=tol, max_iters=max_iters)
    np.testing.assert_array_equal(in_w, twin_in.numpy())
    assert iters == twin_it
    np.testing.assert_allclose(r, twin_r.numpy(), rtol=RTOL, atol=ATOL)


def _same_bits_everywhere(src, dst, msk, c, threads, items, warp, got, damping=0.85, tol=1e-6, max_iters=100,
                          blocks=(2, 3, 5)):
    """The model's ranks at other block counts, in shuffled block orders,
    and from the push's addends: the same bits as ``got``."""
    for b in blocks:
        model = Model(*_pull_arrays(src, dst, msk, c), c, threads, items, warp, blocks=b, seed=b)
        r, _, iters = model.run(damping, tol, max_iters)
        assert iters == got[2] and np.array_equal(r.view(np.int32), got[0].view(np.int32)), b
    push = Model(*_push_arrays(src, dst, msk, c), c, threads, items, warp, blocks=blocks[-1], seed=1)
    r, _, iters = push.run(damping, tol, max_iters)
    assert iters == got[2] and np.array_equal(r.view(np.int32), got[0].view(np.int32))


def _skewed_pane(seed):
    """tests/test_spmv.py's _rand_pane(rng, 256, skew=True) draws."""
    rng = np.random.default_rng(seed)
    src = ((rng.zipf(1.3, 256) - 1) % C).astype(np.int32)
    dst = rng.integers(0, C, 256).astype(np.int32)
    src[0], dst[0] = C - 1, C - 1
    rng.integers(1, 8, 256)  # the weights, unused here
    return src, dst, rng.random(256) < 0.8


# ---------------------------------------------------------------------------
# the cases


@pytest.mark.parametrize("shape", [(8, 4, 4), (4, 2, 2), (32, 1, 8)])
@pytest.mark.parametrize("seed", [14, 0, 1])
def test_model_matches_jax_on_skewed_panes(seed, shape):
    src, dst, msk = _skewed_pane(seed)
    _, got = _model(src, dst, msk, C, *shape)
    _check_against_references(src, dst, msk, C, got)
    _same_bits_everywhere(src, dst, msk, C, *shape, got)


def _hub_pane(rng, c=C, hub=7, hub_edges=100, other=160):
    src = rng.integers(0, c, hub_edges + other).astype(np.int32)
    dst = np.concatenate([np.full(hub_edges, hub), rng.integers(0, c, other)]).astype(np.int32)
    perm = rng.permutation(len(src))  # the hub's edges arrive among the others
    return src[perm], dst[perm], np.ones(len(src), bool)


def test_hub_segment_spans_three_tiles():
    """A hub of 100 in-edges over tiles of 32 items: its segment begins in
    one tile and ends three or more tiles on, and reaches the owner as a
    tail carry and the heads of the tiles after it."""
    src, dst, msk = _hub_pane(np.random.default_rng(5))
    model, got = _model(src, dst, msk, C, 8, 4, 4)
    t0, t1 = model.spans[7]
    assert t1 - t0 >= 3 and model.max_span == t1 - t0
    _check_against_references(src, dst, msk, C, got)
    _same_bits_everywhere(src, dst, msk, C, 8, 4, 4, got)


def test_hub_at_the_kernels_constants():
    """The kernel's own sizes (256 threads of 8 items, 32-lane warps): a hub
    of 6,000 in-edges spans three tiles of 2,048 items; the model's ranks
    equal the JAX package's and the twin's."""
    rng = np.random.default_rng(9)
    c = 4096
    src, dst, msk = _hub_pane(rng, c, hub=5, hub_edges=6000, other=8192)
    model, got = _model(src, dst, msk, c, 256, 8, 32)
    t0, t1 = model.spans[5]
    assert t1 - t0 >= 2
    _check_against_references(src, dst, msk, c, got)


def _boundary_pane(rng, c=C):
    """Segments whose ends fall on the last item of a thread (4 items), of a
    warp (4 threads) and of a tile (32 items), and on first items: in-degree
    runs 3, 3, 3, 3 (ends at 3, 7, 11, 15), 15 (31), 31 (63), 63 (127), 0
    (128), 2 (131), 4 (136), then 7 and 1 in turn."""
    degs = [3, 3, 3, 3, 15, 31, 63, 0, 2, 4] + [7, 1] * 10
    degs = degs[:c] + [0] * (c - len(degs))
    dst = np.repeat(np.arange(c), degs).astype(np.int32)
    src = rng.integers(0, c, len(dst)).astype(np.int32)
    perm = rng.permutation(len(dst))
    return src[perm], dst[perm], np.ones(len(dst), bool)


def test_segments_end_on_thread_warp_and_tile_boundaries():
    src, dst, msk = _boundary_pane(np.random.default_rng(4))
    model, got = _model(src, dst, msk, C, 8, 4, 4)
    pos = [v + int(model.d_off[v + 1]) for v in range(C)]  # each segment end's merge-path item
    assert any(p % 32 == 31 for p in pos)  # the last item of a tile
    assert any(p % 16 == 15 and p % 32 != 31 for p in pos)  # of a warp
    assert any(p % 4 == 3 and p % 16 != 15 for p in pos)  # of a thread
    assert any(p % 4 == 0 for p in pos)  # a first item
    assert model.carried >= 2  # segments of a whole tile and of two
    _check_against_references(src, dst, msk, C, got)
    _same_bits_everywhere(src, dst, msk, C, 8, 4, 4, got)


def test_empty_segments_and_dangling_vertices():
    """Vertices 40-47 have out-edges only (empty segments on the window),
    48-55 in-edges only (dangling), 56-63 none (off the window)."""
    rng = np.random.default_rng(6)
    src = np.concatenate([rng.integers(0, 40, 150), np.arange(40, 48).repeat(3)]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, 40, 130), rng.integers(48, 56, 20), rng.integers(0, 40, 24)])
    dst = dst.astype(np.int32)
    msk = np.ones(len(src), bool)
    msk[::17] = False
    model, got = _model(src, dst, msk, C, 8, 4, 4)
    in_w = got[1]
    assert in_w[40:56].all() and not in_w[56:].any()
    assert (np.diff(model.d_off)[40:48] == 0).all() and (np.diff(model.off)[48:56] == 0).all()
    _check_against_references(src, dst, msk, C, got)
    _same_bits_everywhere(src, dst, msk, C, 8, 4, 4, got)


@pytest.mark.parametrize("max_iters", [0, 1, 5])
def test_bounded_iterations(max_iters):
    src, dst, msk = _skewed_pane(3)
    _, got = _model(src, dst, msk, C, 8, 4, 4, damping=0.5, max_iters=max_iters)
    assert got[2] == max_iters
    _check_against_references(src, dst, msk, C, got, damping=0.5, max_iters=max_iters)
    _same_bits_everywhere(src, dst, msk, C, 8, 4, 4, got, damping=0.5, max_iters=max_iters)


@hypothesis.settings(max_examples=25, deadline=None)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), warp=st.sampled_from([1, 2, 4, 8, 32]),
                  warps=st.integers(1, 3), items=st.sampled_from([1, 2, 3, 8]), blocks=st.integers(1, 5))
def test_model_bits_across_blocks_and_directions_hypothesis(seed, warp, warps, items, blocks):
    """Small panes (hub-skewed destinations, masked rows): the model's
    ranks are the same bits at 1 and ``blocks`` blocks, in shuffled order,
    and from the push's addends, and within rtol 1e-5 of the twin after the
    same 12 iterations (tol -1: a delta of exactly 0, a fixed point in f32,
    stops neither)."""
    rng = np.random.default_rng(seed)
    c = int(rng.integers(2, 40))
    e = int(rng.integers(1, 120))
    src = rng.integers(0, c, e).astype(np.int32)
    dst = np.where(rng.random(e) < 0.4, 0, rng.integers(0, c, e)).astype(np.int32)
    msk = rng.random(e) < 0.8
    threads = warp * warps
    _, got = _model(src, dst, msk, c, threads, items, warp, tol=-1.0, max_iters=12)
    assert got[2] == 12
    _same_bits_everywhere(src, dst, msk, c, threads, items, warp, got, tol=-1.0, max_iters=12, blocks=(blocks,))
    top = tspmv.prepare_pane(src, dst, None, msk, c, device="cpu")
    twin_r, twin_in, twin_it = tspmv.pagerank_fixpoint_plain(top, damping=0.85, tol=-1.0, max_iters=12)
    assert twin_it == 12 and np.array_equal(got[1], twin_in.numpy())
    np.testing.assert_allclose(got[0], twin_r.numpy(), rtol=RTOL, atol=ATOL)
    assert abs(float(got[0].astype(np.float64).sum()) - 1.0) < 1e-4 or not got[1].any()

