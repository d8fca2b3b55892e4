"""Port property: the fully-dynamic degree distribution's two-stage twin
(``ops.degrees.degree_dist_scan_plain``, which ``degree_dist_scan`` runs on
CPU tensors) against the event-by-event loop of the JAX scan, on random
small streams drawn by hypothesis.
"""

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")

from gelly_streaming_tpu_torch.ops import degrees  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _i32(x: int) -> int:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _sequential_degree_dist(deg, hist, src, dst, sign, mask):
    """JAX's lax.scan of degree_dist_update as a Python loop over the
    events (int32 wrap, indices below 0 counted from the end once, clamped
    gathers, dropped scatters): (deg, hist, records [B, 4, 2], mask [B, 4])."""
    cap = len(deg)
    d, h = [int(v) for v in deg], [int(v) for v in hist]
    recs, rmask = [], []

    def norm(i):
        return i + cap if i < 0 else i

    def clamp(i):
        return min(max(i, 0), cap - 1)

    def change(v, delta, ok):
        v = norm(v)
        old = d[clamp(v)]
        ok = ok and not (delta < 0 and old <= 0)
        new = max(_i32(old + delta), 0)
        if 0 <= v < cap:
            d[v] = new if ok else old
        emit_new, emit_old = ok and new > 0, ok and old > 0
        if emit_new and new < cap:
            h[new] = _i32(h[new] + 1)
        rec_new = [new, h[clamp(new)]]
        if emit_old and old < cap:
            h[old] = _i32(h[old] - 1)
        recs.append([rec_new, [old, h[clamp(norm(old))]]])
        rmask.append([emit_new, emit_old])

    signs = [1] * len(src) if sign is None else [int(g) for g in sign]
    for u, v, g, ok in zip(src, dst, signs, mask):
        change(int(u), g, bool(ok))
        change(int(v), g, bool(ok))
    n = len(src)
    return (np.array(d, np.int32), np.array(h, np.int32),
            np.array(recs, np.int32).reshape(n, 4, 2), np.array(rmask, bool).reshape(n, 4))


@st.composite
def _signed_batches(draw):
    cap = draw(st.integers(1, 24))
    n = draw(st.integers(0, 40))
    ids = st.lists(st.integers(-cap - 2, cap + 5), min_size=n, max_size=n)
    sign = draw(st.none() | st.lists(st.sampled_from([-128, -3, -1, 0, 1, 2, 127]), min_size=n, max_size=n))
    deg = draw(st.lists(st.integers(0, 6) | st.just((1 << 31) - 2), min_size=cap, max_size=cap))
    hist = draw(st.lists(st.integers(-3, 9), min_size=cap, max_size=cap))
    return (np.array(deg, np.int32), np.array(hist, np.int32), np.array(draw(ids), np.int32),
            np.array(draw(ids), np.int32), None if sign is None else np.array(sign, np.int8),
            np.array(draw(st.lists(st.booleans(), min_size=n, max_size=n)), bool))


@hypothesis.settings(max_examples=200, deadline=None, derandomize=True, database=None)
@hypothesis.given(_signed_batches(), st.integers(1, 4))
def test_degree_dist_scan_twin_equals_the_sequential_loop(case, parts):
    """Random small streams (out-of-range ids, int8 signs, masks, degrees
    at the int32 edge), scanned in ``parts`` in-place calls on one state."""
    deg, hist, src, dst, sign, mask = case
    want = _sequential_degree_dist(*case)
    t_deg, t_hist = _t(deg.copy()), _t(hist.copy())
    cuts = np.linspace(0, len(src), parts + 1).astype(int)
    recs, rmask = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        r, m = degrees.degree_dist_scan(t_deg, t_hist, _t(src[lo:hi]), _t(dst[lo:hi]),
                                        None if sign is None else _t(sign[lo:hi]), _t(mask[lo:hi]))
        recs.append(r.numpy())
        rmask.append(m.numpy())
    got = (t_deg.numpy(), t_hist.numpy(), np.concatenate(recs), np.concatenate(rmask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert degrees.LAUNCHES["degree_dist_scan"] == 0  # CPU tensors run the twin


