"""CPU tests of the design ``csrc/kcore.cu`` follows: the k-core h-index
fixed point in one cooperative launch, its h-index by counting.

The design is modelled here in numpy, step by step as the kernel takes it,
and held exactly against the JAX package on the CPU (``_h_index_rows``,
``_bucket_round`` and its host loop of rounds):

1. H, the h-index of the starting estimates, from a histogram capped at
   ``bins`` (each block's, then added); H >= bins means no cap.
2. A row's h by counting: its neighbours' estimates capped at
   cap = min(c[key], D, H), counted into bins of width w over the
   candidates [lo, hi], the bin that holds the answer kept and counted
   again until w = 1 (one pass when cap < bins); the spread form (a row's
   slices counted by several blocks, their bins added, one suffix scan);
   the thread form counting down from cap and the warp form's binary
   search over the same values.
   min(c[key], h) equals the JAX row's for rows of distinct neighbours.
3. The one-sync schedule: two estimate buffers; the phase of bucket b reads
   R and writes W at its keys min(R[key], h) while copying the keys of the
   bucket before from R into W; a round changed iff a row's h fell below
   its key's estimate.  Every round's estimates equal the JAX loop's, the
   rounds and the stop equal its, and a bound one round short refuses.

Panes: seeded Graph500-like and uniform simple graphs with hubs, a clique
whose H passes the bins, and small graphs drawn by hypothesis.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.library import kcore as jkcore
from gelly_streaming_tpu_torch.core.windows import WindowPane
from gelly_streaming_tpu_torch.library import kcore as tkcore
from gelly_streaming_tpu_torch.ops import neighborhoods as nbh

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

CPU = "cpu"


def _gather(i, c):
    i = i + c if i < 0 else i
    return min(max(i, 0), c - 1)


def h_index_of(values, bins):
    """H of the estimates: the largest h <= bins with at least h values >= h,
    from their histogram capped at bins; None (no cap) when that is bins."""
    hist = np.bincount(np.clip(values, 0, bins), minlength=bins + 1)
    suffix = np.cumsum(hist[::-1])[::-1]
    h = max(b for b in range(bins + 1) if suffix[b] >= b)
    return None if h == bins else h


def count_h(vals, cap, bins):
    """The block form: the candidates [lo, hi] counted into bins of width w
    (bin 0 never decides), the bin holding the answer kept; a pass a
    refinement.  Returns (h, passes)."""
    lo, hi, passes = 0, cap, 0
    while lo < hi:
        w = (hi - lo) // bins + 1
        nb = (hi - lo) // w + 1
        hist = np.zeros(nb, np.int64)
        above = 0
        for v in vals:
            if v > hi:
                above += 1
            elif v >= lo + w:
                hist[(v - lo) // w] += 1
        s, b = above, 0
        for k in range(nb - 1, -1, -1):
            s += hist[k]
            if s >= lo + k * w:
                b = k
                break
        lo += b * w
        hi = min(hi, lo + w - 1)
        passes += 1
    return lo, passes


def thread_h(vals, cap):
    hh = cap
    while hh > 0 and np.count_nonzero(vals >= hh) < hh:
        hh -= 1
    return hh


def warp_h(vals, cap):
    lo, hi = 0, cap
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if np.count_nonzero(vals >= mid) >= mid:
            lo = mid
        else:
            hi = mid - 1
    return lo


def spread_h(vals, cap, parts):
    """The spread form (one pass, cap < bins): each of ``parts`` blocks
    counts a slice of the row into its bins, the bins are added, and one
    suffix scan takes the largest h with at least h values >= h."""
    total = np.zeros(max(cap, 0) + 1, np.int64)
    for piece in np.array_split(vals, parts):
        total += np.bincount(piece[piece > 0], minlength=max(cap, 0) + 1)[: max(cap, 0) + 1]
    suffix = np.cumsum(total[::-1])[::-1]
    return max(b for b in range(max(cap, 0) + 1) if b == 0 or suffix[b] >= b) if cap > 0 else 0


def row_h(c, key, nbrs, valid, hcap, bins, form):
    n, d = len(c), len(nbrs)
    cap = min(c[_gather(key, n)], d, hcap if hcap is not None else d)
    vals = np.where(valid, np.minimum(c[[_gather(int(v), n) for v in nbrs]], cap), 0)
    if form == "thread":
        return thread_h(vals, cap)
    if form == "warp":
        return warp_h(vals, cap)
    if form == "spread" and hcap is not None and hcap < bins:
        return spread_h(vals, cap, 3)
    return count_h(vals, cap, bins)[0]


def fixpoint_model(c0, buckets, max_rounds, bins, forms=("thread", "warp", "block")):
    """The one-launch fixed point: returns (the estimates at the start and
    after each round, rounds run, converged)."""
    n = len(c0)
    hcap = h_index_of(c0, bins)
    bufs = [c0.copy(), c0.copy()]
    phase, out = 0, [c0.copy()]
    for r in range(1, max_rounds + 1):
        changed = False
        for b, (keys, nbrs, valid) in enumerate(buckets):
            R, W = bufs[phase & 1], bufs[(phase & 1) ^ 1]
            if phase > 0:
                for key in buckets[b - 1][0]:  # the keys of the bucket before (the last one's for b = 0)
                    t = key + n if key < 0 else key
                    if 0 <= t < n:
                        W[t] = min(W[t], R[t])
            d = nbrs.shape[1]
            form = forms[0] if d <= 16 else (forms[1] if d <= 1024 else forms[2])
            for k, key in enumerate(keys):
                hh = row_h(R, key, nbrs[k], valid[k], hcap, bins, form)
                t = key + n if key < 0 else key
                if 0 <= t < n:
                    changed |= hh < R[t]
                    W[t] = min(W[t], hh)
            phase += 1
        out.append(bufs[((phase - 1) & 1) ^ 1].copy() if buckets else bufs[0].copy())  # the last W
        if not changed:
            return out, r, True
    return out, max_rounds, False


def jax_rounds(src, dst, msk, capacity, rounds):
    """The JAX package's estimates at the start and after each of
    ``rounds`` rounds (as tests/test_torch_kcore.py's _jax_rounds)."""
    buckets = jkcore._build_buckets_j(jnp.asarray(src), jnp.asarray(dst), None, jnp.asarray(msk))
    buckets = [b for b in buckets if int(b.num_keys) > 0]
    c = jkcore.spmv.scatter_into(jkcore.spmv.PLUS_ONE, capacity, src, np.ones((len(src),), np.int32), msk)
    out = [np.asarray(c)]
    for _ in range(rounds):
        for b in buckets:
            c = jkcore._bucket_round(c, b.keys, b.nbrs, b.valid, b.num_keys)
        out.append(np.asarray(c))
    return out


def _simple(src, dst, capacity):
    return tkcore.simple_pane_edges(WindowPane(0, -1, np.asarray(src), np.asarray(dst), None, None), capacity)


def _buckets(s, d, m):
    bk = [b for b in nbh.build_buckets(*(torch.from_numpy(a) for a in (s, d)), None, torch.from_numpy(m))
          if b.num_keys > 0]
    return [(b.keys.numpy(), b.nbrs.numpy(), b.valid.numpy()) for b in bk]


def _degrees(s, m, capacity):
    return np.bincount(s[m], minlength=capacity).astype(np.int32)


def _hub_pane(rng, capacity=96, e=600):
    src = rng.integers(0, 80, e)
    dst = np.where(rng.random(e) < 0.3, 0, rng.integers(0, 80, e))  # a hub at 0
    src[:40] = np.arange(40)  # a clique-ish core
    dst[:40] = (np.arange(40) + 1) % 40
    return _simple(src.astype(np.int32), dst.astype(np.int32), capacity)


@pytest.mark.parametrize("bins", [4096, 8, 3])
def test_counting_h_index_matches_jax_rows(bins):
    """min(c[key], h) by each form with cap = min(c[key], D, H) equals the
    JAX row's on random rows of distinct neighbours, rows wider than H
    included; small bins take several passes."""
    rng = np.random.default_rng(bins)
    n = 300
    c = rng.integers(0, 60, n).astype(np.int32)
    c[rng.choice(n, 12, replace=False)] = rng.integers(200, 400, 12)  # a few large estimates
    hcap = h_index_of(c, bins)
    passes = []
    for d in (4, 16, 64, 256):
        k = 20
        nbrs = np.stack([rng.choice(n, d, replace=False) for _ in range(k)]).astype(np.int32)
        valid = rng.random((k, d)) < 0.8
        keys = rng.choice(n, k, replace=False).astype(np.int32)
        want = np.minimum(c[keys], np.asarray(jkcore._h_index_rows(jnp.asarray(c)[nbrs], jnp.asarray(valid))))
        for form in ("thread", "warp", "block", "spread"):
            got = [min(c[key], row_h(c, key, nbrs[i], valid[i], hcap, bins, form)) for i, key in enumerate(keys)]
            np.testing.assert_array_equal(got, want, err_msg=f"{form} D={d}")
        for i, key in enumerate(keys):
            cap = min(c[key], d, hcap if hcap is not None else d)
            passes.append(count_h(np.where(valid[i], np.minimum(c[nbrs[i]], cap), 0), cap, bins)[1])
    if bins == 4096:
        assert hcap is not None and hcap < 64 and max(passes) == 1  # rows of 64 and 256 are wider than H
    else:
        assert hcap is None and max(passes) > 1  # no cap: caps up to D take several passes


def test_h_index_of_the_estimates():
    c = np.array([5, 3, 3, 1, 0, 7, 2, 2], np.int32)
    assert h_index_of(c, 4096) == 3 and h_index_of(c, 2) is None and h_index_of(c, 3) is None
    assert h_index_of(np.zeros(5, np.int32), 8) == 0


@pytest.mark.parametrize("seed", range(3))
def test_one_sync_schedule_matches_jax_round_by_round(seed):
    """The double-buffered schedule's estimates after every round equal the
    JAX loop's (tests/test_torch_kcore.py's _jax_rounds), and it stops at
    the same round."""
    rng = np.random.default_rng(seed)
    capacity = 96
    s, d, m = _hub_pane(rng, capacity)
    want = jax_rounds(s, d, m, capacity, 24)
    stop = next(r for r in range(1, len(want)) if np.array_equal(want[r], want[r - 1]))
    buckets = _buckets(s, d, m)
    got, rounds, converged = fixpoint_model(_degrees(s, m, capacity), buckets, 64, 4096)
    assert converged and rounds == stop > 2
    for r in range(rounds + 1):
        np.testing.assert_array_equal(got[r], want[r], err_msg=f"round {r}")
    assert len({nb.shape[1] for _, nb, _ in buckets}) > 2
    # the port's pane_cores (on the CPU: the per-bucket loop of the twin) stops there too
    cores, t_rounds = tkcore.pane_cores(s, d, m, capacity, CPU)
    assert t_rounds == rounds and np.array_equal(cores.numpy(), got[-1])


def test_max_rounds_refusal():
    """A bound one round short leaves the fixed point unreached: the model
    reports it, and pane_cores raises as the JAX loop does."""
    rng = np.random.default_rng(11)
    capacity = 96
    s, d, m = _hub_pane(rng, capacity)
    _, rounds, converged = fixpoint_model(_degrees(s, m, capacity), _buckets(s, d, m), 64, 4096)
    assert converged
    _, short, conv_short = fixpoint_model(_degrees(s, m, capacity), _buckets(s, d, m), rounds - 1, 4096)
    assert short == rounds - 1 and not conv_short
    with pytest.raises(RuntimeError, match="converge"):
        tkcore.pane_cores(s, d, m, capacity, CPU, max_rounds=rounds - 1)
    assert tkcore.pane_cores(s, d, m, capacity, CPU, max_rounds=rounds)[1] == rounds


def test_pane_whose_h_passes_the_bins():
    """A clique of 20 with pendant leaves (H = 20) against 16 bins: no cap, so the rows'
    counts refine in passes; every round still equals the JAX loop's."""
    capacity = 64
    iu, ju = np.triu_indices(20, 1)
    leaves = np.arange(20, 50)
    s, d, m = _simple(np.concatenate([iu, leaves]).astype(np.int32),
                      np.concatenate([ju, leaves % 20]).astype(np.int32), capacity)
    c0 = _degrees(s, m, capacity)
    assert h_index_of(c0, 16) is None and h_index_of(c0, 4096) == 20
    want = jax_rounds(s, d, m, capacity, 6)
    for forms in (("block", "block", "block"), ("thread", "warp", "block")):
        got, rounds, converged = fixpoint_model(c0, _buckets(s, d, m), 16, 16, forms)
        assert converged and rounds < 6
        for r in range(rounds + 1):
            np.testing.assert_array_equal(got[r], want[r])
    assert int(got[-1][:20].min()) == 19 and int(got[-1][20:50].max()) == 1


@hypothesis.settings(max_examples=20, deadline=None)
@hypothesis.given(seed=st.integers(0, 2**31 - 1), bins=st.sampled_from([2, 5, 4096]),
                  forms=st.sampled_from([("thread", "warp", "block"), ("block", "block", "block"),
                                         ("thread", "thread", "thread"), ("spread", "spread", "spread")]))
def test_schedule_hypothesis(seed, bins, forms):
    rng = np.random.default_rng(seed)
    capacity = 48
    e = int(rng.integers(2, 160))
    simple = _simple(rng.integers(0, 40, e).astype(np.int32), rng.integers(0, 40, e).astype(np.int32), capacity)
    hypothesis.assume(simple is not None)
    s, d, m = simple
    want = jax_rounds(s, d, m, capacity, 40)
    got, rounds, converged = fixpoint_model(_degrees(s, m, capacity), _buckets(s, d, m), 40, bins, forms)
    assert converged
    assert rounds == next(r for r in range(1, len(want)) if np.array_equal(want[r], want[r - 1]))
    for r in range(rounds + 1):
        np.testing.assert_array_equal(got[r], want[r])


def test_repeated_neighbour_passes_the_cap():
    """Why the capped fixed point takes only rows of distinct neighbours: a
    row that repeats a neighbour can have an h above H.  Vertices 0 and 1
    joined by three parallel edges have degrees [3, 3], so H = 2, while the
    JAX row of 0 over [1, 1, 1] has h = 3; the capped count gives 2."""
    c = np.array([3, 3], np.int32)
    hcap = h_index_of(c, 4096)
    nbrs, valid = np.array([1, 1, 1], np.int32), np.ones(3, bool)
    jax_h = int(np.asarray(jkcore._h_index_rows(jnp.asarray(c)[nbrs][None], jnp.asarray(valid)[None]))[0])
    assert hcap == 2 and jax_h == 3
    for form in ("thread", "warp", "block"):
        assert row_h(c, 0, nbrs, valid, hcap, 4096, form) == 2
    # pane_cores never hands such a row over: the pane's edges are deduplicated first
    s, d, m = _simple(np.array([0, 0, 1], np.int32), np.array([1, 1, 0], np.int32), 4)
    assert int(m.sum()) == 2 and h_index_of(_degrees(s, m, 4), 4096) == 1
    assert tkcore.pane_cores(s, d, m, 4, CPU)[0].tolist() == [1, 1, 0, 0]


@pytest.mark.parametrize("seed", range(3))
def test_pane_cores_rows_hold_distinct_neighbours(seed):
    """From a stream that repeats edges in both orientations and holds
    self-loops, every valid row pane_cores builds holds distinct neighbours
    in [0, C), so the capped model equals the JAX loop round by round."""
    rng = np.random.default_rng(100 + seed)
    capacity = 64
    src = rng.integers(0, 40, 300).astype(np.int32)
    dst = rng.integers(0, 40, 300).astype(np.int32)
    src = np.concatenate([src, dst[:100], src[:50], np.arange(10, dtype=np.int32)])
    dst = np.concatenate([dst, src[:100], dst[:50], np.arange(10, dtype=np.int32)])
    s, d, m = _simple(src, dst, capacity)
    buckets = _buckets(s, d, m)
    for _, nbrs, valid in buckets:
        for row, ok in zip(nbrs, valid):
            live = row[ok]
            assert len(np.unique(live)) == len(live) and (live >= 0).all() and (live < capacity).all()
    want = jax_rounds(s, d, m, capacity, 30)
    got, rounds, converged = fixpoint_model(_degrees(s, m, capacity), buckets, 30, 4096)
    assert converged
    for r in range(rounds + 1):
        np.testing.assert_array_equal(got[r], want[r])
    assert np.array_equal(tkcore.pane_cores(s, d, m, capacity, CPU)[0].numpy(), got[-1])
