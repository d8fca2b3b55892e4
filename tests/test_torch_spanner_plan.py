"""The spanner kernel's design against the JAX package on the CPU.

``csrc/spanner.cu`` tests every edge of a batch against the table as it
stood before the batch (T0) with the walk's own exact test, and walks only
the survivors in arrival order.  That is sound because the table only
grows and each body's answer only turns from "not within" to "within" as
it grows; these tests pin that on the JAX bodies themselves
(``within_two``, ``within_k_balls`` with its truncated "exact" balls,
``bounded_bfs``), on tables grown by ``add_undirected_edge`` with rows
that overflow and ids that were -1 and C.  Then the plain model of the
kernel's two phases (``ops/spanner.spanner_admit_model``) against JAX's
``_admit_batch`` at k in {2, 3, 4} in every body, masked and full rows:
tables, deg, the capped candidates and the survivors, the last counted
with the JAX bodies on T0.  Tolerance: none.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.library import spanner as jsp
from gelly_streaming_tpu.summaries import adjacency as jadj
from gelly_streaming_tpu_torch.ops import spanner as sp_ops


@functools.lru_cache(maxsize=None)
def _jax_body(body: str, k: int):
    """The JAX body over a batch of (u, v) pairs on one table, jitted."""
    if body == "within_two":
        fn = jadj.within_two
    elif body == "balls":
        def fn(nbrs, u, v):
            return jadj.within_k_balls(nbrs, u, v, k)
    else:
        def fn(nbrs, u, v):
            return jadj.bounded_bfs(nbrs, u, v, k)
    return jax.jit(jax.vmap(fn, in_axes=(None, 0, 0)))


_add = jax.jit(jadj.add_undirected_edge)
_admit = jax.jit(jsp._admit_batch, static_argnums=(5, 6, 7))  # k, cap, body: one compile a case
_prefilter = jax.jit(jsp._within_k_prefilter, static_argnums=(3, 4))


@pytest.mark.parametrize("d", [3, 8])
@pytest.mark.parametrize("body,k", [("within_two", 2), ("balls", 2), ("balls", 3), ("balls", 4), ("balls", 5),
                                    ("bfs", 2), ("bfs", 3), ("bfs", 4)])
def test_bodies_only_turn_to_within_as_the_table_grows(body, k, d):
    """Edges as the walk takes them (ids from [-1, C] clamped below at 0,
    so 0 and C occur), inserted one by one; every query pair's answer,
    once "within", stays "within"."""
    c = 20
    rng = np.random.default_rng(100 * k + d)
    fn = _jax_body(body, k)
    qu = jnp.asarray(np.maximum(rng.integers(-1, c + 1, 300), 0).astype(np.int32))
    qv = jnp.asarray(np.maximum(rng.integers(-1, c + 1, 300), 0).astype(np.int32))
    nbrs, deg = jadj.init_table(c, d)
    before = np.asarray(fn(nbrs, qu, qv))
    grew = 0
    for u, v in np.maximum(rng.integers(-1, c + 1, (120, 2)), 0).astype(np.int32):
        nbrs, deg = _add(nbrs, deg, jnp.int32(u), jnp.int32(v))
        now = np.asarray(fn(nbrs, qu, qv))
        assert not (before & ~now).any(), (u, v)
        grew += int((now & ~before).sum())
        before = now
    assert grew > 0 and (np.asarray(deg) == d).any()  # some answers turned, some rows filled


def _survivors_on_t0(nbrs, s, d, m, k, cap, body):
    """The capped candidates, and those the JAX body says are not within
    k on the table before the batch (ids clamped below at 0)."""
    cand = np.asarray(m) & ~np.asarray(_prefilter(nbrs, jnp.asarray(s), jnp.asarray(d), k, cap))
    within = np.asarray(_jax_body(body, k)(nbrs, jnp.asarray(np.maximum(s, 0)), jnp.asarray(np.maximum(d, 0))))
    return int(cand.sum()), int((cand & ~within).sum())


@pytest.mark.parametrize("rows", ["masked", "full"])
@pytest.mark.parametrize("k,body", [(2, "within_two"), (2, "balls"), (2, "bfs"), (3, "balls"), (3, "bfs"),
                                    (4, "balls"), (4, "bfs")])
def test_model_matches_jax_admit_batch(k, body, rows):
    """The exact pre-pass on T0, then the ordered walk over its survivors,
    batch by batch on a carried table: ids -1 and C in the stream; "full"
    keeps every row of a dense stream over narrow rows, so rows overflow."""
    c, d, cap = 24, (3 if rows == "full" else 5), (6 if k > 2 else 128)
    rng = np.random.default_rng(10 * k + len(body) + len(rows))
    jn, jd = jadj.init_table(c, d)
    tn, td = torch.full((c, d), -1, dtype=torch.int32), torch.zeros((c,), dtype=torch.int32)
    survived = 0
    for _ in range(4):
        s = rng.integers(-1, c + 1, 40).astype(np.int32)
        t = rng.integers(-1, c + 1, 40).astype(np.int32)
        m = np.ones(40, bool) if rows == "full" else rng.random(40) < 0.7
        want_cand, want_surv = _survivors_on_t0(jn, s, t, m, k, cap, body)
        jn, jd = _admit(jn, jd, jnp.asarray(s), jnp.asarray(t), jnp.asarray(m), k, cap,
                        "auto" if body == "within_two" else body)
        _, _, cand, surv = sp_ops.spanner_admit_model(tn, td, torch.from_numpy(s), torch.from_numpy(t),
                                                     torch.from_numpy(m), k, cap, body)
        assert (cand, surv) == (want_cand, want_surv)
        assert np.array_equal(tn.numpy(), np.asarray(jn)) and np.array_equal(td.numpy(), np.asarray(jd))
        survived += surv
    assert 0 < survived
    if rows == "full":
        assert (td.numpy() == d).any()


def test_exact_prepass_keeps_only_non_candidates_out():
    """Edges outside the candidates never survive; on an empty table every
    candidate survives but u == v (and, at k = 2, nothing else is within)."""
    c, d = 16, 4
    nbrs = torch.full((c, d), -1, dtype=torch.int32)
    src = torch.tensor([0, 3, 5, 5, 17, -1], dtype=torch.int32)
    dst = torch.tensor([1, 3, 6, 7, 17, 2], dtype=torch.int32)
    cand = torch.tensor([True, True, True, False, True, True])
    for body in ("within_two", "balls", "bfs"):
        got = sp_ops.exact_prepass_plain(nbrs, src, dst, cand, 2, body)
        # bfs: u = 17 >= C reaches nothing, so (17, 17) is not within; the others count u == v
        want = [True, False, True, False, body == "bfs", True]
        assert got.tolist() == want, body
