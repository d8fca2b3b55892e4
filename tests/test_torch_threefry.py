"""Port parity: the port's threefry2x32 draws against ``jax.random``.

``gelly_streaming_tpu_torch/utils/threefry.py`` is the port's own copy of
what ``jax.random`` computes for the sampled triangle estimators (JAX 0.9,
``jax_threefry_partitionable`` True, the default).  On 200 seeded keys its
``split``, ``uniform`` and ``randint`` must give ``jax.random``'s bits at
S in {1, 3, 1000} lanes and at odd spans.  The port's side takes the 200
keys as tensors of shape [200, 1]; a scalar key is checked too.
Tolerance: none, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch.utils import threefry

KEYS = np.random.default_rng(19).integers(0, 1 << 32, (200, 2), dtype=np.uint64).astype(np.uint32)
TKEYS = tuple(torch.from_numpy(KEYS[:, j].astype(np.int64))[:, None] for j in (0, 1))
SPANS = [(0, 1), (0, 7), (0, 1000), (0, 65535), (0, 65536), (0, 65537), (0, 1 << 20), (-5, 12),
         (3, 3), (9, 2), (-(1 << 31), (1 << 31) - 1)]


def _key(k):
    return int(k[0]), int(k[1])


def test_seed_matches_prngkey():
    for s in (0, 1, 42, 0xDEADBEEF, (1 << 32) - 1, -1, -(1 << 31)):
        assert threefry.seed(s) == tuple(int(x) for x in np.asarray(jax.random.PRNGKey(s))), s


@pytest.mark.parametrize("n", [1, 2, 3, 1000])
def test_split_matches_jax(n):
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(jnp.asarray(KEYS))).astype(np.int64)
    w1, w2 = threefry.split(TKEYS, n)
    assert np.array_equal(np.stack([w1.numpy(), w2.numpy()], 2), want)
    s1, s2 = threefry.split(_key(KEYS[7]), n)
    assert np.array_equal(np.stack([s1.numpy(), s2.numpy()], 1), want[7])
    assert [threefry.threefry_2x32(*_key(KEYS[0]), 0, i) for i in range(n)] == [tuple(int(x) for x in r)
                                                                                 for r in want[0]]


@pytest.mark.parametrize("n", [1, 3, 1000])
def test_uniform_matches_jax(n):
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jnp.asarray(KEYS)))
    got = threefry.uniform(TKEYS, n).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert np.array_equal(threefry.uniform(_key(KEYS[3]), n).numpy().view(np.int32), want[3].view(np.int32))


@pytest.mark.parametrize("n", [1, 3, 1000])
@pytest.mark.parametrize("span", SPANS, ids=str)
def test_randint_matches_jax(n, span):
    lo, hi = span
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (n,), lo, hi))(jnp.asarray(KEYS)))
    got = threefry.randint(TKEYS, n, lo, hi).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)
    assert np.array_equal(threefry.randint(_key(KEYS[11]), n, lo, hi).numpy(), want[11])


def test_lane_bits_with_per_lane_keys():
    """The twin's per-lane form: each lane under its own key, at its own index."""
    lanes = torch.arange(200, dtype=torch.int64)
    got = threefry.lane_bits((TKEYS[0][:, 0], TKEYS[1][:, 0]), lanes).numpy()
    bits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (200,), jnp.uint32))(jnp.asarray(KEYS)))
    assert got.tolist() == [int(bits[i, i]) for i in range(200)]


def test_key_tensor_round_trip():
    for k in KEYS[:5]:
        t = threefry.key_tensor(_key(k))
        assert t.dtype == torch.uint32
        assert threefry.key_ints(t) == _key(k)
