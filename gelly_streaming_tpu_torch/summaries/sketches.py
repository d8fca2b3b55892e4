"""Fixed-tiny-state sketch cores: min-hash edge sampling, HLL, count-min.

Port of ``gelly_streaming_tpu/summaries/sketches.py``: three sketches whose
state is KB, each an order-free commutative monoid over its registers:

  * min-hash edge sample: per bucket, the lexicographic min on
    ``(sample_hash, lo, hi)``; the identity is the empty row.  The sample
    is a function of the edge SET (arXiv:1308.2166's R estimators in
    min-hash form), so folds commute and duplicates are idempotent.
  * HLL registers: elementwise max of rank-of-leading-zero registers.
  * count-min grid: elementwise add of a d x w counter grid, stored flat.

Shapes are powers of two (``next_pow2`` clamps), functions of (eps, delta)
alone.  The salted fmix32 hashes, the constants and the four loops on the
edges live in ``ops/sketches.py``: ``hll_fold``, ``cm_fold``, ``tri_fold``
and ``tri_sampled_closures`` keep the JAX names and arguments and run one
CUDA C call each on CUDA tensors (their plain twins on CPU tensors).  The
folds update the state in place and return it; ``tri_fold`` takes and
returns the sample as a tuple, like the JAX function.  A sample hash is an
int64 lane holding the u32 value (``EMPTY_HASH`` = 0xFFFFFFFF).  The
estimates (``hll_estimate``, ``cm_query``, ``tri_estimate``) are plain
PyTorch on the state's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gelly_streaming_tpu_torch.ops import sketches as ops
from gelly_streaming_tpu_torch.ops.sketches import (  # noqa: F401  (re-exported: the JAX module's names)
    EMPTY_HASH,
    EMPTY_VERTEX,
    GOLDEN,
    SALT_BUCKET,
    SALT_CM_ROW,
    SALT_EDGE_HLL,
    SALT_MEMBER,
    SALT_SAMPLE,
    SALT_VERTEX_HLL,
    TRI_CLOSURE_BLOCK,
    canonical_edge,
    hash_pair_u32,
    hash_u32,
    mix32,
    tri_merge,
)
from gelly_streaming_tpu_torch.ops.sketches import row_take as _row_take  # noqa: F401


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


# ---------------------------------------------------------------------------
# HLL-style distinct-cardinality registers (max-merge monoid)


def hll_num_registers(eps: float, floor: int = 64, cap: int = 1 << 16) -> int:
    """Registers m for a relative standard error ~1.04/sqrt(m) <= eps/2
    (two sigma: the (eps, delta <= 0.05) contract), pow2-clamped to
    [floor, cap]."""
    m = next_pow2(math.ceil((2.08 / float(eps)) ** 2))
    return max(floor, min(m, cap))


def hll_init(m: int, device=None) -> torch.Tensor:
    """Zero registers: the max-merge identity."""
    return torch.zeros((m,), dtype=torch.int32, device=device)


def hll_fold(regs, keys_u32, mask):
    """Fold hashed keys (``hash_u32`` / ``hash_pair_u32``) into the
    registers in place (scatter-max; order-free): register = the low
    log2(m) bits, rank = 1 + the leading zeros of the rest."""
    return ops.hll_fold(regs, keys_u32, mask)


def hll_merge(a, b):
    return torch.maximum(a, b)


def hll_alpha(m: int) -> float:
    if m <= 16:
        return 0.673
    if m <= 32:
        return 0.697
    if m <= 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def hll_linear_tolerance(m: int) -> float:
    """The most that two f32 implementations' linear counts ``m * (log m -
    log zeros)`` may differ by, for m registers (absolute).

    Each f32 log is within 1 ulp of its value (faithful: XLA's and torch's
    on the CPU, CUDA's ``logf`` on the card), so two implementations' logs
    of one argument differ by at most one ulp of it, and ulp(log zeros) <=
    ulp(log m) since zeros <= m: the difference of the logs differs by at
    most 2 ulp(log m).  Each rounds that difference (<= log m) to half an
    ulp of it, at most 1 ulp(log m) between the two, and the product by m
    to half an ulp of the result (<= m log m).  So the linear counts differ
    by at most 3 m ulp(log m) + ulp(m log m): 0.25 at m = 2^16, where the
    CPU's two logs put them 0.0625 apart at most."""
    ulp = float(np.spacing(np.float32(math.log(m))))
    return 3.0 * m * ulp + float(np.spacing(np.float32(m * math.log(m))))


def hll_estimate(regs: torch.Tensor) -> torch.Tensor:
    """Cardinality estimate (float32 0-d): the harmonic-mean raw estimate
    with the small-range linear-counting correction.

    The raw estimate's f32 sum may reduce in another order than XLA's (a
    relative 1e-6 covers it).  The linear count ``m * (log m - log
    zeros)`` cancels: one ulp of a log becomes m ulps of the count, so it
    is held to another implementation within ``hll_linear_tolerance(m)``
    (absolute), not bit for bit."""
    m = regs.shape[0]
    inv = torch.sum(torch.exp2(-regs.to(torch.float32)))
    raw = torch.tensor(hll_alpha(m) * m * m, dtype=torch.float32, device=regs.device) / inv
    zeros = torch.sum(regs == 0).to(torch.float32)
    fm = torch.tensor(m, dtype=torch.float32, device=regs.device)
    linear = fm * (torch.log(fm) - torch.log(torch.clamp_min(zeros, 1.0)))
    use_linear = (raw <= 2.5 * m) & (zeros > 0)
    return torch.where(use_linear, linear, raw)


# ---------------------------------------------------------------------------
# count-min counter grid (add-merge monoid), stored flat [d * w]


def cm_dims(eps: float, delta: float, floor: int = 64, cap: int = 1 << 16):
    """(depth d, width w): overcount <= eps * N with probability >= 1 -
    delta (N = total increments), e/eps x ln(1/delta)."""
    w = next_pow2(math.ceil(math.e / float(eps)))
    w = max(floor, min(w, cap))
    d = max(1, min(math.ceil(math.log(1.0 / float(delta))), 8))
    return d, w


def cm_init(d: int, w: int, device=None) -> torch.Tensor:
    return torch.zeros((d * w,), dtype=torch.int32, device=device)


def cm_fold(grid, d: int, w: int, keys, counts, mask):
    """Scatter-add ``counts`` for each key into all d rows, in place
    (order-free)."""
    return ops.cm_fold(grid, d, w, keys, counts, mask)


def cm_merge(a, b):
    return a + b


def cm_query(grid: torch.Tensor, d: int, w: int, keys: torch.Tensor) -> torch.Tensor:
    """Point estimate a key: the min over the d row counters (int32)."""
    est = None
    for r in range(d):
        row = grid[r * w + (hash_u32(keys, SALT_CM_ROW + r) & (w - 1))]
        est = row if est is None else torch.minimum(est, row)
    return est


# ---------------------------------------------------------------------------
# min-hash edge sample (lexicographic-min-merge monoid) and the sampled
# closure count


def tri_rows(eps: float, delta: float, floor: int = 64, cap: int = 1 << 12) -> int:
    """Sample rows R ~ 2 ln(1/delta) / eps^2, pow2-clamped to [floor, cap]
    (the cap bounds the O(R^2) emission-time closure check)."""
    r = next_pow2(math.ceil(2.0 * math.log(1.0 / float(delta)) / float(eps) ** 2))
    return max(floor, min(r, cap))


def tri_init(rows: int, device=None):
    """(eh, elo, ehi): empty sample rows, the lexicographic-min identity."""
    return (
        torch.full((rows,), EMPTY_HASH, dtype=torch.int64, device=device),
        torch.full((rows,), EMPTY_VERTEX, dtype=torch.int32, device=device),
        torch.full((rows,), EMPTY_VERTEX, dtype=torch.int32, device=device),
    )


def tri_fold(sample, src, dst, mask):
    """Fold an edge batch into the R-row min-hash sample, in place: each
    canonical edge belongs to one bucket, whose kept edge is the
    sample-hash argmin (ties by lo, then hi), so arrival order and
    duplicates cannot change the result.  Returns the sample."""
    return ops.tri_fold(*sample, src, dst, mask)


def tri_sampled_closures(elo, ehi):
    """Closed-wedge count among the sampled rows // 2 (3x the fully sampled
    triangle count), int32 0-d."""
    return ops.tri_sampled_closures(elo, ehi)


def tri_estimate(sample, regs, closures=None):
    """(estimate f32, occupied rows int32, distinct edges f32): closures/3
    / min(p, 1)^3 with p = occupied rows / the registers' distinct edges;
    EXACT when the sample covers every distinct edge (p = 1).  ``closures``:
    the sample's closure count already taken (None: counted here)."""
    eh, elo, ehi = sample
    occ = torch.sum(eh != EMPTY_HASH).to(torch.float32)
    distinct_edges = hll_estimate(regs)
    p = torch.clamp_max(occ / torch.clamp_min(distinct_edges, 1.0), 1.0)
    if closures is None:
        closures = tri_sampled_closures(elo, ehi)
    closures = closures.to(torch.float32)
    triangles = closures / 3.0
    pm = torch.clamp_min(p, 1e-9)
    return triangles / (pm * (pm * pm)), occ.to(torch.int32), distinct_edges
