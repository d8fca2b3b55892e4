"""The port's copy of what ``jax.random`` computes for the sampled triangle
estimators: the threefry2x32 hash and the draws built on it.

The JAX package threads a ``jax.random`` key through ``sampler_update``
(``gelly_streaming_tpu/library/sampled_triangles.py``): every step splits
it in three and draws a ``uniform`` coin and a ``randint`` third vertex
for each sampler lane.  Those draws are not hardware bits but
threefry2x32 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011), a counter-based hash, so the port gives the same bits as
JAX 0.9 with ``jax_threefry_partitionable=True`` (its default):

* ``seed(s)``: the key ``[s >> 32, s & 0xFFFFFFFF]`` (a negative 32-bit
  seed: ``[0, s & 0xFFFFFFFF]``), ``jax.random.PRNGKey``;
* ``split(key, n)``: key i is the hash of the counter pair ``(0, i)``;
* ``random_bits(key, n)``: lane i is the XOR of the hash of ``(0, i)``;
* ``uniform(key, n)``: f32 in [0, 1) from the top 23 bits;
* ``randint(key, n, lo, hi)``: int32, two ``random_bits`` draws under the
  keys of ``split(key, 2)``, reduced by JAX's span arithmetic (uint32,
  wrapping).

Values are uint32 held in int64 tensors (PyTorch has no uint32
arithmetic) or in Python ints: ``threefry_2x32`` takes either, and a key
is a pair of them.  ``csrc/sampled_triangles.cu`` computes the same hash
on the card.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]  # uint32 values: a Python int or an int64 tensor
Key = Tuple[Word, Word]


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry_2x32(k1: Word, k2: Word, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The threefry2x32 hash of the counter pairs ``(x1, x2)`` under the key
    ``(k1, k2)`` (JAX's ``_threefry2x32_lowering``: 20 rounds, a key
    injection every 4); the arguments broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x1 + ks[0]) & MASK
    y = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & MASK
            y = _rotl(y, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        y = (y + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, y


def seed(s: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(s)``'s key data as two ints."""
    s = int(s)
    if s < 0:
        return 0, s & MASK
    return (s >> 32) & MASK, s & MASK


def _counters(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int64, device=device)


def split(key: Key, n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key, n)``: the n keys as two int64 tensors [n]
    (first and second words; [..., n] for tensor keys of shape [..., 1],
    as the draws below)."""
    dev = key[0].device if isinstance(key[0], torch.Tensor) else device
    return threefry_2x32(key[0], key[1], 0, _counters(n, dev))


def random_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """JAX's 32-bit ``random_bits(key, (n,))`` as an int64 tensor [n]."""
    dev = key[0].device if isinstance(key[0], torch.Tensor) else device
    return lane_bits(key, _counters(n, dev))


def lane_bits(key: Key, lanes: torch.Tensor) -> torch.Tensor:
    """The 32-bit draw of each lane index in ``lanes`` (int64): one lane of
    ``random_bits``, where the key broadcasts against the lanes."""
    b1, b2 = threefry_2x32(key[0], key[1], 0, lanes)
    return b1 ^ b2


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from 32-bit draws, as ``jax.random.uniform`` makes them:
    the top 23 bits as the mantissa of a float in [1, 2), less 1."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one - 1.0


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))``: f32 [n] in [0, 1)."""
    return bits_to_uniform(random_bits(key, n, device))


def span_reduce(higher: torch.Tensor, lower: torch.Tensor, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint``'s reduction of two 32-bit draws into
    [minval, maxval) (int32 bounds): (higher % span) * (2^32 % span) +
    lower % span, in wrapping uint32 arithmetic, as JAX computes it
    (2^32 % span as ((2^16 % span)^2 mod 2^32) % span)."""
    lo32, hi32 = int(minval), int(maxval)
    if not (-(1 << 31) <= lo32 < 1 << 31 and -(1 << 31) <= hi32 < 1 << 31):
        raise ValueError("randint bounds must fit int32")
    span = 1 if hi32 <= lo32 else (hi32 - lo32) & MASK
    mult = (1 << 16) % span
    mult = ((mult * mult) & MASK) % span
    off = (((higher % span) * mult) & MASK) + (lower % span)
    off = (off & MASK) % span
    out = (off + lo32) & MASK  # the int32 add, wrapping
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def randint(key: Key, n: int, minval: int, maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval)`` (int32): int32 [n]
    (or [..., n] for tensor keys of shape [..., 1])."""
    w1, w2 = split(key, 2, device)
    higher = random_bits((w1[..., 0, None], w2[..., 0, None]), n)
    lower = random_bits((w1[..., 1, None], w2[..., 1, None]), n)
    return span_reduce(higher, lower, minval, maxval)


def key_tensor(key: Tuple[int, int], device=None) -> torch.Tensor:
    """A key as the uint32 [2] tensor a ``SamplerState`` holds."""
    host = torch.tensor([int(key[0]), int(key[1])], dtype=torch.int64).to(torch.uint32)
    return host if device is None else host.to(device)


def key_ints(key: torch.Tensor) -> Tuple[int, int]:
    """A uint32 [2] key tensor as two Python ints (one host read)."""
    k = key.cpu().to(torch.int64).tolist()
    return int(k[0]) & MASK, int(k[1]) & MASK
