"""The plan of the matching's C call against the JAX package, on the CPU.

``ops/matching.matching_rounds_plain`` runs the kernel's rounds on the
host: a window of edges tested at once against the state as the round
began, the longest prefix committed in which no lane reads or writes a row
that an earlier admitting lane of the window writes.  Its events f32
[B, 3, 4], emask bool [B, 3], partner and weight must equal JAX's
``matching_update`` and the serial twin ``matching_scan_plain`` bit for
bit, for windows 1, 7, 32, 256 and 1024, on seeded batches with ids in
[-3, C + 3) (JAX's index rules), self-loops, a pair matched again in
reverse, integer-weight ties, masked rows, and ``val`` / ``mask`` None, the
state carried across batches.  Its round counts: a window of 1 takes one
round an edge, a batch that admits nothing ceil(n / W), and a hub whose
every edge evicts the one before it one commit a round.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.library import matching as jm
from gelly_streaming_tpu_torch.ops import matching as mo

WINDOWS = [1, 7, 32, 256, 1024]
C, B = 40, 300


def _batches():
    """Three batches of ids in [-3, C + 3): self-loops, a pair again
    reversed, integer weights (ties) then floats, masked rows, and a last
    batch with val and mask None."""
    rng = np.random.default_rng(21)
    out = []
    for i in range(3):
        s = rng.integers(-3, C + 3, B).astype(np.int32)
        d = rng.integers(-3, C + 3, B).astype(np.int32)
        s[:5] = d[:5]
        s[9], d[9] = d[6], s[6]
        w = (rng.integers(1, 6, B) if i == 0 else rng.random(B) * 10).astype(np.float32)
        m = rng.random(B) < 0.85
        out.append((s, d, w, m) if i < 2 else (d, s, None, None))
    return out


@pytest.fixture(scope="module")
def jax_run():
    """JAX's events, emask and state after each batch."""
    state = jm.init_matching(JConfig(vertex_capacity=C))
    steps = []
    for s, d, w, m in _batches():
        mask = jnp.ones(B, bool) if m is None else jnp.asarray(m)
        state, ev, em = jm.matching_update(state, jnp.asarray(s), jnp.asarray(d),
                                           None if w is None else jnp.asarray(w), mask)
        steps.append(tuple(np.asarray(x) for x in (ev, em, state.partner, state.weight)))
    return steps


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else t
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want):
    return all(np.array_equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("window", WINDOWS)
def test_rounds_plan_matches_jax_and_the_twin(jax_run, window):
    p1 = torch.full((C,), -1, dtype=torch.int32)
    w1 = torch.zeros((C,))
    p2, w2 = p1.clone(), w1.clone()
    for (s, d, w, m), want in zip(_batches(), jax_run):
        args = [None if x is None else torch.from_numpy(x) for x in (s, d, w, m)]
        ev, em, rounds = mo.matching_rounds_plain(p1, w1, *args, window)
        assert _same((ev, em, p1, w1), want)
        assert _same(mo.matching_scan_plain(p2, w2, *args) + (p2, w2), (ev, em, p1, w1))
        assert -(-B // window) <= rounds <= B
        if window == 1:
            assert rounds == B


@pytest.mark.parametrize("window", WINDOWS)
def test_a_batch_that_admits_nothing_takes_one_round_a_window(window):
    rng = np.random.default_rng(window)
    p = torch.full((C,), -1, dtype=torch.int32)
    w = torch.zeros((C,))
    s = torch.from_numpy(rng.integers(-3, C + 3, B).astype(np.int32))
    d = torch.from_numpy(rng.integers(-3, C + 3, B).astype(np.int32))
    for val, mask in ((None, torch.zeros(B, dtype=torch.bool)), (torch.full((B,), -1.0), None)):
        ev, em, rounds = mo.matching_rounds_plain(p, w, s, d, val, mask, window)
        assert rounds == -(-B // window) and not em.any()
        assert _same(mo.matching_scan_plain(p.clone(), w.clone(), s, d, val, mask), (ev, em))


@pytest.mark.parametrize("window", WINDOWS)
def test_a_hub_commits_one_edge_a_round(window):
    """Every edge (0, k + 1) weighs 3^k and so evicts the one before it;
    each lane reads row 0, which the lane before it writes."""
    n = 60
    p = torch.full((C + n,), -1, dtype=torch.int32)
    w = torch.zeros((C + n,))
    s = torch.zeros(n, dtype=torch.int32)
    d = torch.arange(1, n + 1, dtype=torch.int32)
    val = torch.from_numpy(3.0 ** np.arange(n)).to(torch.float32)
    p2, w2 = p.clone(), w.clone()
    ev, em, rounds = mo.matching_rounds_plain(p, w, s, d, val, None, window)
    assert rounds == n
    assert em[:, 2].all() and em[1:, 0].all() and not em[:, 1].any()
    assert _same(mo.matching_scan_plain(p2, w2, s, d, val, None) + (p2, w2), (ev, em, p, w))
    assert p[0] == n and p[n] == 0 and int((p >= 0).sum()) == 2


def test_window_and_stats_on_the_cpu():
    p = torch.full((8,), -1, dtype=torch.int32)
    w = torch.zeros((8,))
    s = torch.tensor([0, 1], dtype=torch.int32)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            mo.matching_rounds_plain(p, w, s, s + 2, None, None, bad)
    assert mo.WINDOW in WINDOWS
    assert mo.stats("cpu") == {name: 0 for name in mo.STATS}
