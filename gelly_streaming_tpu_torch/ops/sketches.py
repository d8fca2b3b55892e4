"""The fixed-state sketches' kernels: the wrappers of ``csrc/sketches.cu``,
their plain twins, and the salted hashes both compute.

Replaces four XLA loops of ``gelly_streaming_tpu/summaries/sketches.py``:
``hll_fold`` (:112-126, a scatter-max of ranks into HLL registers),
``cm_fold`` (:175-183, d salted scatter-adds into a count-min grid),
``tri_fold`` with ``tri_merge`` (:226-287, each bucket's lexicographic
argmin of (sample hash, lo, hi) merged into the R-row min-hash sample) and
``tri_sampled_closures`` (:296-368, the closed wedges among the sampled
rows).

The hashes are murmur3's fmix32 with the JAX package's salts, on u32
lanes.  PyTorch has no unsigned 32-bit arithmetic on the CPU, so here a
hash is an int64 tensor holding the u32 value, products are taken in 16-bit
halves so that no int64 product overflows, and ids are hashed by their
two's-complement bits (ids outside [0, C), negative ones included, hash
like any other: they are never indexed).

On CUDA tensors each wrapper is one C call: ``hll_fold`` (precomputed
hashes) and ``hll_degree_fold`` (HLLDegreeSummary's three key families in
one filter kernel), each after a kernel that writes the registers' filter
image into a kept scratch buffer; ``cm_fold`` and ``cm_degree_fold`` (src,
then dst; one cluster launch); ``tri_fold`` (the sample and, given
``regs``, the distinct-edge registers; one cluster launch) and
``tri_sampled_closures`` (one launch), each with a kept scratch buffer
zeroed once.  On CPU tensors they run the twins, the JAX formulas in plain
PyTorch.  The folds update their state in place and return it.
``hll_filter_model``, ``cm_cluster_model``, ``tri_cluster_model`` and
``closures_grouped_model`` are the kernels' designs step by step on the
host, for the CPU tests.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gelly_streaming_tpu_torch.ops import _cuda

_SOURCE = "sketches.cu"

# golden-ratio odd constant: distinct salts decorrelate the hash families
GOLDEN = 0x9E3779B9
#: identity of the min-hash lattice: an empty sample row
EMPTY_HASH = 0xFFFFFFFF
#: sentinel endpoint of an empty sample row
EMPTY_VERTEX = -1

# hash-family salts (the JAX package's)
SALT_BUCKET = 0x2545F491  # which of the R buckets an edge belongs to
SALT_SAMPLE = 0x9E4C1B3B  # the within-bucket min-hash ranking
SALT_MEMBER = 0x61C88647  # membership keys of the emission's closure check
SALT_CM_ROW = 0x7FEB352D  # count-min per-row hash family base
SALT_EDGE_HLL = 0x45D9F3B5  # distinct-edge cardinality registers
SALT_VERTEX_HLL = 0x119DE1F3  # distinct-vertex cardinality registers

#: the JAX package's closure-check strip height (the twin's strips)
TRI_CLOSURE_BLOCK = 32

_M32 = 0xFFFFFFFF
_I32_MAX = (1 << 31) - 1

# C calls since the last reset_launches() (CUDA tensors only), and the
# wrappers' twin calls (CPU tensors only)
KERNELS = ("hll_fold", "cm_fold", "tri_fold", "tri_sampled_closures")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
TWIN_CALLS: Dict[str, int] = {k: 0 for k in KERNELS}
_scratch: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


# ---------------------------------------------------------------------------
# the hashes, on int64 lanes holding u32 values


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """The u32 bits of integer lanes, as int64 in [0, 2^32)."""
    return x.to(torch.int64) & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), in 16-bit halves of c."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer on u32 lanes (full avalanche)."""
    x = as_u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _salted(salt: int) -> int:
    return (salt * GOLDEN) & _M32


def hash_u32(x: torch.Tensor, salt: int) -> torch.Tensor:
    """Salted 32-bit hash of integer lanes."""
    return mix32(as_u32(x) ^ _salted(salt))


def hash_pair_u32(lo: torch.Tensor, hi: torch.Tensor, salt: int) -> torch.Tensor:
    """Salted 32-bit hash of canonical (lo, hi) vertex pairs."""
    h = mix32(as_u32(lo) ^ _salted(salt))
    return mix32(h ^ _mul32(as_u32(hi), GOLDEN))


def canonical_edge(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) with lo <= hi: undirected edge identity."""
    return torch.minimum(src, dst), torch.maximum(src, dst)


def _log2(n: int, what: str) -> int:
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what} must be a power of two, got {n}")
    return n.bit_length() - 1


def _kept(mask: Optional[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    return torch.ones(like.shape, dtype=torch.bool, device=like.device) if mask is None else mask


# ---------------------------------------------------------------------------
# the plain twins: the JAX formulas


def hll_fold_plain(regs: torch.Tensor, keys: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Scatter-max of each kept key's rank into register ``key & (m - 1)``:
    rank = clz32(key >> p) - p + 1 (33 - p where key >> p is 0)."""
    m = regs.shape[0]
    p = _log2(m, "the register count")
    k = as_u32(keys)
    # clz32(v) = 32 - bit length; frexp's exponent is the bit length (v < 2^53)
    bits = torch.frexp((k >> p).to(torch.float64)).exponent.to(torch.int64)
    rank = torch.where(_kept(mask, k), 33 - p - bits, 0).to(torch.int32)
    return regs.scatter_reduce_(0, k & (m - 1), rank, "amax")


def cm_fold_plain(grid: torch.Tensor, d: int, w: int, keys: torch.Tensor, counts: Optional[torch.Tensor],
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Each kept key's count (1 where ``counts`` is None) added into its
    column of every row (int32, wrapping)."""
    cnt = torch.ones(keys.shape, dtype=torch.int32, device=keys.device) if counts is None else counts.to(torch.int32)
    cnt = torch.where(_kept(mask, keys), cnt, 0)
    for r in range(d):
        col = hash_u32(keys, SALT_CM_ROW + r) & (w - 1)
        grid.index_add_(0, r * w + col, cnt)
    return grid


def hll_degree_fold_plain(verts, edges, src, dst, mask):
    """``HLLDegreeSummary.update``: src and dst vertex hashes into
    ``verts``, the canonical edge's hash into ``edges``, all under
    ``mask`` (self-loops included)."""
    hll_fold_plain(verts, hash_u32(src, SALT_VERTEX_HLL), mask)
    hll_fold_plain(verts, hash_u32(dst, SALT_VERTEX_HLL), mask)
    lo, hi = canonical_edge(src, dst)
    hll_fold_plain(edges, hash_pair_u32(lo, hi, SALT_EDGE_HLL), mask)
    return verts, edges


def row_take(eh_a, elo_a, ehi_a, eh_b, elo_b, ehi_b) -> torch.Tensor:
    """True where row b lexicographically precedes row a on (hash, lo,
    hi): the hash unsigned (int64 lanes), lo and hi signed."""
    return (eh_b < eh_a) | ((eh_b == eh_a) & ((elo_b < elo_a) | ((elo_b == elo_a) & (ehi_b < ehi_a))))


def tri_merge(a, b):
    """Rowwise lexicographic min of two samples (eh, elo, ehi): new
    tensors (commutative, idempotent)."""
    take = row_take(*a, *b)
    return tuple(torch.where(take, y, x) for x, y in zip(a, b))


def tri_fold_plain(eh, elo, ehi, src, dst, mask, regs=None):
    """Each bucket's lexicographic argmin of (sample hash, lo, hi) over the
    kept non-self-loop edges, merged rowwise into (eh, elo, ehi) in
    place; given ``regs``, the canonical edges' hashes folded into them
    under the same mask.  Returns (eh, elo, ehi)."""
    rows = eh.shape[0]
    _log2(rows, "the sample's rows")
    lo, hi = canonical_edge(src, dst)
    ok = _kept(mask, lo) & (lo != hi)  # self-loops close no wedges
    if regs is not None:
        hll_fold_plain(regs, hash_pair_u32(lo, hi, SALT_EDGE_HLL), ok)
    bucket = hash_pair_u32(lo, hi, SALT_BUCKET) & (rows - 1)
    s = torch.where(ok, hash_pair_u32(lo, hi, SALT_SAMPLE), EMPTY_HASH)
    # the lexicographic argmin a bucket: the least hash, then the least lo
    # among the hash's winners, then the least hi among (hash, lo)'s
    bmin = torch.full((rows,), EMPTY_HASH, dtype=torch.int64, device=eh.device).scatter_reduce_(
        0, bucket, s, "amin")
    on_h = ok & (s == bmin[bucket])
    blo = torch.full((rows,), _I32_MAX, dtype=torch.int32, device=eh.device).scatter_reduce_(
        0, bucket, torch.where(on_h, lo, _I32_MAX), "amin")
    on_hl = on_h & (lo == blo[bucket])
    bhi = torch.full((rows,), _I32_MAX, dtype=torch.int32, device=eh.device).scatter_reduce_(
        0, bucket, torch.where(on_hl, hi, _I32_MAX), "amin")
    won = bmin != EMPTY_HASH  # a sample hash of 0xFFFFFFFF is never kept
    winner = (bmin, torch.where(won, blo, EMPTY_VERTEX), torch.where(won, bhi, EMPTY_VERTEX))
    for old, new in zip((eh, elo, ehi), tri_merge((eh, elo, ehi), winner)):
        old.copy_(new)
    return eh, elo, ehi


def tri_sampled_closures_plain(elo: torch.Tensor, ehi: torch.Tensor) -> torch.Tensor:
    """The closed wedges among the sampled rows // 2 (int32 0-d), strip by
    strip as the JAX package enumerates them: for each ordered pair of
    valid rows (i != j) sharing a vertex, with distinct other endpoints,
    is the closing edge's member hash among the sorted member hashes?"""
    rows = elo.shape[0]
    block = min(TRI_CLOSURE_BLOCK, rows)
    valid = elo != EMPTY_VERTEX
    keys = torch.sort(torch.where(valid, hash_pair_u32(elo, ehi, SALT_MEMBER), EMPTY_HASH)).values
    col = torch.arange(rows, device=elo.device)
    lo_j, hi_j = elo[None, :], ehi[None, :]
    total = torch.zeros((), dtype=torch.int64, device=elo.device)
    for start in range(0, rows, block):
        sl = slice(start, start + block)
        lo_i, hi_i, v_i = elo[sl, None], ehi[sl, None], valid[sl, None]
        shape = (lo_i.shape[0], rows)
        shared = torch.zeros(shape, dtype=torch.bool, device=elo.device)
        close_a = torch.zeros(shape, dtype=elo.dtype, device=elo.device)
        close_b = torch.zeros(shape, dtype=elo.dtype, device=elo.device)
        # distinct canonical edges share at most one vertex: the first case
        # that holds names the closing pair
        for cond, a, b in ((lo_i == lo_j, hi_i, hi_j), (lo_i == hi_j, hi_i, lo_j), (hi_i == lo_j, lo_i, hi_j),
                           (hi_i == hi_j, lo_i, lo_j)):
            pick = cond & ~shared
            close_a = torch.where(pick, a.expand(shape), close_a)
            close_b = torch.where(pick, b.expand(shape), close_b)
            shared = shared | cond
        not_self = (start + torch.arange(lo_i.shape[0], device=elo.device))[:, None] != col[None, :]
        pair_ok = v_i & valid[None, :] & shared & not_self & (close_a != close_b)
        ckey = hash_pair_u32(torch.minimum(close_a, close_b), torch.maximum(close_a, close_b), SALT_MEMBER)
        pos = torch.searchsorted(keys, ckey).clamp_(0, rows - 1)
        total += (pair_ok & (keys[pos] == ckey) & (ckey != EMPTY_HASH)).sum()
    # each ordered pair counted twice; each triangle has 3 unordered pairs
    return (total // 2).to(torch.int32)


# ---------------------------------------------------------------------------
# plain models of the kernels' designs (csrc/sketches.cu), step by step on
# the host: the CPU tests hold them to the JAX package

#: csrc/sketches.cu's FILTER_BYTES: the HLL filter's bytes a block, a nibble a register
FILTER_BYTES = 96 * 1024
#: csrc/sketches.cu's CM_PRIVATE_BYTES: a count-min block's private grid
CM_PRIVATE_BYTES = 96 * 1024


def _blocks_of(n: int, blocks: int, threads: int):
    """The kernels' grid-stride cut: edge e to block (e // threads) % blocks."""
    return [(e // threads) % blocks for e in range(n)]


def _nibble(v: int) -> int:
    """A register's filter nibble: the register plus one, clamped to [0, 15]."""
    return min(max(v + 1, 0), 15)


def hll_filter_model(banks, families, mask: Optional[torch.Tensor], blocks: int, threads: int = 1024,
                     filter_bytes: int = FILTER_BYTES, lose: float = 0.0, seed: int = 0) -> dict:
    """The HLL filter kernel's design on the host.  ``banks``: int32
    register tensors [m], updated in place; ``families``: (bank index,
    hashes as int64 lanes [n]) in an edge's order of updates.  Each block
    starts from a filter of the banks' nibbles as they stood before the
    batch (bank 0, then bank 1; a register plus one, clamped to [0, 15];
    the first 2 * ``filter_bytes`` registers), the blocks' edges
    interleaved one edge a block a step.  A masked row is rank 0.  An
    update is done where its rank is below its nibble; else it reads the
    register, raises it where the rank does, and stores the larger of the
    two into the nibble, a store lost with probability ``lose`` (a race
    that puts back an older nibble).  Returns the counts of filtered
    updates, register reads and raises."""
    import random

    m = banks[0].shape[0]
    p = _log2(m, "the register count")
    regs = [b.tolist() for b in banks]
    image = bytes(_nibble(v) for bank in regs for v in bank)[:2 * filter_bytes]
    flen = len(image)
    filters = [bytearray(image) for _ in range(blocks)]
    hashes = [(bank, as_u32(h).tolist()) for bank, h in families]
    n = len(hashes[0][1]) if hashes else 0
    keep = [True] * n if mask is None else mask.tolist()
    queues = [[] for _ in range(blocks)]
    for e, b in enumerate(_blocks_of(n, blocks, threads)):
        queues[b].append(e)
    rng = random.Random(seed)
    stats = {"filtered": 0, "reads": 0, "raises": 0}
    for step in range(max((len(q) for q in queues), default=0)):
        for b, q in enumerate(queues):
            if step >= len(q):
                continue
            e = q[step]
            for bank, hs in hashes:
                h = hs[e]
                idx, rank = h & (m - 1), (32 - (h >> p).bit_length() - p + 1 if keep[e] else 0)
                f = bank * m + idx
                if f < flen and rank < filters[b][f]:
                    stats["filtered"] += 1
                    continue
                g = regs[bank][idx]
                stats["reads"] += 1
                if rank > g:
                    regs[bank][idx] = rank
                    stats["raises"] += 1
                if f < flen and not (lose and rng.random() < lose):
                    filters[b][f] = _nibble(max(rank, g))
    for t, r in zip(banks, regs):
        t.copy_(torch.tensor(r, dtype=torch.int32))
    return stats


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def cm_cluster_model(grid: torch.Tensor, d: int, w: int, keys, counts: Optional[torch.Tensor],
                     mask: Optional[torch.Tensor], blocks: int, cluster: int, threads: int = 512,
                     private_bytes: int = CM_PRIVATE_BYTES) -> torch.Tensor:
    """The count-min cluster kernel's design on the host: ``keys`` a list
    of int32 key tensors (src, then dst) folded with the same counts.  Each
    block (``blocks`` a multiple of ``cluster``) gathers its edges' updates
    to the first ``private_bytes`` / 4 counters in a private grid, the rest
    going straight to ``grid``; each cluster of consecutive blocks sums its
    members' grids (wrapping int32) and adds each nonzero sum into
    ``grid``, in place."""
    if blocks % cluster:
        raise ValueError("blocks must be a multiple of the cluster size")
    n = keys[0].shape[0]
    priv = min(d * w, private_bytes // 4)
    cnt = torch.ones((n,), dtype=torch.int64) if counts is None else counts.to(torch.int64)
    cnt = torch.where(_kept(mask, keys[0]), cnt, 0)
    block = torch.tensor(_blocks_of(n, blocks, threads), dtype=torch.int64)
    partial = torch.zeros((blocks, priv), dtype=torch.int64)
    direct = torch.zeros((d * w,), dtype=torch.int64)
    for k in keys:
        for r in range(d):
            cell = r * w + (hash_u32(k, SALT_CM_ROW + r) & (w - 1))
            inside = cell < priv
            partial.view(-1).index_put_((block[inside] * priv + cell[inside],), cnt[inside], accumulate=True)
            direct.index_add_(0, cell[~inside], cnt[~inside])
    sums = _wrap32(partial.view(blocks // cluster, cluster, priv).sum(1)).to(torch.int64)
    total = grid.to(torch.int64) + direct
    total[:priv] += (sums * (sums != 0)).sum(0)
    grid.copy_(_wrap32(total))
    return grid


#: csrc/sketches.cu's tri_fold shape: threads a block, edges a thread keeps
#: in registers for the hi step, blocks a cluster
TRI_THREADS, TRI_HELD, TRI_CLUSTER = 1024, 8, 8
#: csrc/sketches.cu's closure count: sample rows a block of the grid (at
#: most one an SM), the most rows it takes
CLOSURE_ROWS_A_BLOCK, CLOSURE_MAX = 32, 8192
#: pairs that pay for a closure-count block's copy of the tables
CLOSURE_PAIRS_A_BLOCK = 1024
_NO_KEY = (1 << 63) - 1
_I32_MIN = -(1 << 31)


def _key64(s: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """(sample hash, lo) as one int64 in the order of the kernel's u64 key
    (hash << 32) | (lo ^ 2^31): the hash unsigned, then lo signed."""
    return ((s - (1 << 31)) << 32) + (lo.to(torch.int64) + (1 << 31))


def tri_cluster_model(eh, elo, ehi, src, dst, mask, regs=None, clusters: int = 1, cluster: int = TRI_CLUSTER,
                      threads: int = TRI_THREADS, held: int = TRI_HELD) -> dict:
    """The tri_fold cluster kernel's design on the host, updating (eh, elo,
    ehi) and ``regs`` in place.  Edge e goes to block (e // threads) %
    blocks of ``clusters`` clusters of ``cluster`` blocks (the grid
    stride), a thread holding its first ``held`` edges.  Each block takes
    the least (hash, lo) key a bucket over its edges and folds its edge
    registers privately (untouched: INT_MIN; rank 0 where the edge takes
    no part in the sample); its edges equal to their bucket's least offer
    their hi to the block's least hi of the bucket; bucket b's owner
    (member b // per) takes the lexicographic least (key, hi) over the
    cluster's members and max-merges the members' registers into
    ``regs``; with more clusters the last block of each rank takes the
    clusters' least; each winner merges into its row.  Returns counts: the
    edges read again for the hi step, the offers, the winners."""
    rows = eh.shape[0]
    _log2(rows, "the sample's rows")
    n, blocks = src.shape[0], clusters * cluster
    e = torch.arange(n)
    blk = (e // threads) % blocks
    lo, hi = canonical_edge(src.to(torch.int64), dst.to(torch.int64))
    part = _kept(mask, lo) & (lo != hi)
    if regs is not None:
        m = regs.shape[0]
        p = _log2(m, "the register count")
        h = hash_pair_u32(lo, hi, SALT_EDGE_HLL)
        rank = torch.where(part, 33 - p - torch.frexp((h >> p).to(torch.float64)).exponent.to(torch.int64), 0)
        private = torch.full((blocks * m,), _I32_MIN, dtype=torch.int64).scatter_reduce_(
            0, blk * m + (h & (m - 1)), rank, "amax")
        owners = private.view(clusters, cluster, m).amax(1)  # each owner's slice over the members, by DSMEM
        regs.copy_(torch.maximum(regs.to(torch.int64), owners.amax(0)).to(torch.int32))
    s = hash_pair_u32(lo, hi, SALT_SAMPLE)
    ok = part & (s != EMPTY_HASH)
    bucket = hash_pair_u32(lo, hi, SALT_BUCKET) & (rows - 1)
    key = _key64(s, lo)
    slot = blk * rows + bucket
    local = torch.full((blocks * rows,), _NO_KEY, dtype=torch.int64).scatter_reduce_(0, slot[ok], key[ok], "amin")
    offer = ok & (key == local[slot])
    lhi = torch.full((blocks * rows,), _I32_MAX, dtype=torch.int64).scatter_reduce_(0, slot[offer], hi[offer], "amin")
    lkey, lhi = local.view(clusters, cluster, rows), lhi.view(clusters, cluster, rows)
    cmin = lkey.amin(1)  # each owner's lexicographic least over the members, by DSMEM
    chi = torch.where(lkey == cmin[:, None, :], lhi, _I32_MAX).amin(1)
    kmin = cmin.amin(0)
    hmin = torch.where(cmin == kmin, chi, _I32_MAX).amin(0)
    won = kmin != _NO_KEY
    winner = (torch.where(won, (kmin >> 32) + (1 << 31), EMPTY_HASH),
              torch.where(won, (kmin & _M32) - (1 << 31), EMPTY_VERTEX).to(torch.int32),
              torch.where(won, hmin, EMPTY_VERTEX).to(torch.int32))
    for old, new in zip((eh, elo, ehi), tri_merge((eh, elo, ehi), winner)):
        old.copy_(new)
    return {"reread": int((e >= blocks * threads * held).sum()), "offers": int(offer.sum()), "winners": int(won.sum())}


def _pair_uv(r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pair r of a group as (u, v), 0 <= u < v, r = v (v - 1) / 2 + u."""
    v = ((1.0 + torch.sqrt(8.0 * r.to(torch.float64) + 1.0)) * 0.5).to(torch.int64)
    v = torch.where(v * (v - 1) // 2 > r, v - 1, v)
    v = torch.where((v + 1) * v // 2 <= r, v + 1, v)
    return r - v * (v - 1) // 2, v


def closures_grouped_model(elo: torch.Tensor, ehi: torch.Tensor, blocks: Optional[int] = None,
                           pairs_a_block: int = CLOSURE_PAIRS_A_BLOCK):
    """The grouped closure count's design on the host: (the count as
    ``tri_sampled_closures`` gives it, an int32 0-d tensor; counts).  Each
    valid row has an incidence at lo (2i) and one at hi (2i + 1) unless hi
    == lo, in bucket mix32(vertex) & (R - 1); each bucket's incidences give
    c (c - 1) / 2 unordered pairs, the pairs' offsets a prefix sum (one
    build of the tables, which every block reads); of a grid of ``blocks``
    (default: the kernel's R / 32), one a ``pairs_a_block`` pairs each
    take an even slice of the pairs.  A pair of incidences (rows i < j)
    counts where both are on one vertex x, JAX's ordered (i, j) shares x
    by its first holding case (lo lo, lo hi, hi lo, hi hi), its other
    endpoints differ and their edge's member hash is a valid row's (not
    EMPTY_HASH).  JAX's total is twice the count, mod 2^32; the result is
    that total // 2 in int32."""
    rows = elo.shape[0]
    _log2(rows, "the sample's rows")
    grid = blocks or max(1, rows // CLOSURE_ROWS_A_BLOCK)
    lo, hi = elo.to(torch.int64), ehi.to(torch.int64)
    valid = elo != EMPTY_VERTEX
    members = hash_pair_u32(lo[valid], hi[valid], SALT_MEMBER)
    members = torch.unique(members[members != EMPTY_HASH])
    ids = torch.arange(2 * rows)
    row, side = ids >> 1, ids & 1
    inc = valid[row] & ~((side == 1) & (hi[row] == lo[row]))
    vertex = torch.where(side == 1, hi[row], lo[row])
    ids = ids[inc]
    bucket = mix32(vertex[inc]) & (rows - 1)
    grouped = ids[torch.argsort(bucket, stable=True)]
    size = torch.bincount(bucket, minlength=rows)
    starts = torch.cumsum(size, 0) - size
    npairs = size * (size - 1) // 2
    pref = torch.cumsum(npairs, 0) - npairs
    total = int(npairs.sum())
    blocks = min(grid, max(1, -(-total // pairs_a_block)))
    per_block = []
    for b in range(blocks):
        q = torch.arange(total * b // blocks, total * (b + 1) // blocks)
        k = torch.searchsorted(pref, q, right=True) - 1
        u, v = _pair_uv(q - pref[k])
        a, c = grouped[starts[k] + u], grouped[starts[k] + v]
        x = vertex[a]
        i, j = torch.minimum(a >> 1, c >> 1), torch.maximum(a >> 1, c >> 1)
        li, hii, lj, hj = lo[i], hi[i], lo[j], hi[j]
        shared = torch.where(li == lj, li, torch.where(li == hj, li, hii))
        p = torch.where(li == lj, hii, torch.where(li == hj, hii, li))
        r = torch.where(li == lj, hj, torch.where(li == hj, lj, torch.where(hii == lj, hj, lj)))
        key = hash_pair_u32(torch.minimum(p, r), torch.maximum(p, r), SALT_MEMBER)
        pos = torch.searchsorted(members, key).clamp_(max=max(members.numel() - 1, 0))
        hit = members[pos] == key if members.numel() else torch.zeros_like(key, dtype=torch.bool)
        ok = (vertex[c] == x) & (shared == x) & (p != r) & (key != EMPTY_HASH) & hit
        per_block.append(int(ok.sum()))
    twice = 2 * sum(per_block) % (1 << 32)
    twice -= (1 << 32) if twice >= 1 << 31 else 0
    return torch.tensor(twice >> 1, dtype=torch.int32), {"buckets": int((size >= 2).sum()), "pairs": total,
                                                         "per_block": per_block}

# ---------------------------------------------------------------------------
# the wrappers


def _check_ids(dev, n, *named) -> None:
    for t, name in named:
        if t is None:
            continue
        if t.dim() != 1 or t.shape[0] != n or t.device != dev:
            raise ValueError(f"{name} must be a 1-D tensor of {n} rows on {dev}")


def _check_mask(mask, n, dev) -> None:
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (n,) or mask.device != dev):
        raise ValueError(f"mask must be a bool tensor of {n} rows on {dev}, or None")


def _check_regs(regs, name: str = "regs") -> None:
    if regs.dtype != torch.int32 or regs.dim() != 1 or not regs.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 [m] tensor")
    _log2(regs.shape[0], f"{name}' length")


def _check_int32(t, name: str) -> None:
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _dense(*ts):
    """Contiguous copies of ``ts`` (None stays None).  The caller binds
    them to locals that outlive the C call: a copy made inside the call's
    argument list is freed as soon as its ``data_ptr()`` is taken, and the
    allocator may hand its block to the next copy before the launch."""
    return tuple(None if t is None else t.contiguous() for t in ts)


def _hll_scratch(dev, banks: int, m: int) -> torch.Tensor:
    """The HLL filter's image buffer for ``banks`` banks of ``m``
    registers (the C library's ``hll_scratch_bytes``), one a device and
    shape, kept."""
    key = ("hll", dev, banks, m)
    buf = _scratch.get(key)
    if buf is None:
        nbytes = int(_cuda.library(_SOURCE).hll_scratch_bytes(banks, m))
        buf = _scratch[key] = torch.empty((nbytes,), dtype=torch.uint8, device=dev)
    return buf


@_cuda.on_device_of("regs")
def hll_fold(regs: torch.Tensor, keys: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Fold hashed keys (int64 lanes of u32 hashes: ``hash_u32`` /
    ``hash_pair_u32``) into the int32 registers ``regs`` [m] in place;
    ``mask`` None keeps every row.  Returns ``regs``."""
    _check_regs(regs)
    dev = regs.device
    n = keys.shape[0] if keys.dim() == 1 else -1
    _check_ids(dev, n, (keys, "keys"))
    _check_mask(mask, n, dev)
    if keys.dtype != torch.int64:
        raise ValueError("keys must be int64 lanes of u32 hashes")
    if dev.type != "cuda":
        TWIN_CALLS["hll_fold"] += 1
        return hll_fold_plain(regs, keys, mask)
    keys_c, mask_c = _dense(keys, mask)
    scratch = _hll_scratch(dev, 1, regs.shape[0])
    err = _cuda.library(_SOURCE).hll_fold_launch(regs.data_ptr(), regs.shape[0], keys_c.data_ptr(), _ptr(mask_c), n,
                                                  scratch.data_ptr(), scratch.numel(), _stream(dev))
    _cuda.check(err, "hll_fold_launch")
    LAUNCHES["hll_fold"] += 1
    return regs


@_cuda.on_device_of("verts")
def hll_degree_fold(verts: torch.Tensor, edges: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """``HLLDegreeSummary.update`` in place: the src and dst vertex hashes
    into ``verts``, the canonical edge's hash into ``edges`` (both int32
    [m]), under ``mask`` (self-loops included); one C call."""
    _check_regs(verts, "verts")
    _check_regs(edges, "edges")
    dev = verts.device
    if edges.shape != verts.shape or edges.device != dev:
        raise ValueError("verts and edges must be register banks of one length on one device")
    n = src.shape[0]
    _check_ids(dev, n, (src, "src"), (dst, "dst"))
    _check_int32(src, "src")
    _check_int32(dst, "dst")
    _check_mask(mask, n, dev)
    if dev.type != "cuda":
        TWIN_CALLS["hll_fold"] += 1
        return hll_degree_fold_plain(verts, edges, src, dst, mask)
    src_c, dst_c, mask_c = _dense(src, dst, mask)
    scratch = _hll_scratch(dev, 2, verts.shape[0])
    err = _cuda.library(_SOURCE).hll_degree_launch(
        verts.data_ptr(), edges.data_ptr(), verts.shape[0], src_c.data_ptr(), dst_c.data_ptr(), _ptr(mask_c), n,
        scratch.data_ptr(), scratch.numel(), _stream(dev))
    _cuda.check(err, "hll_degree_launch")
    LAUNCHES["hll_fold"] += 1
    return verts, edges


@_cuda.on_device_of("grid")
def _cm_call(grid, d, w, keys_a, keys_b, counts, mask):
    if grid.dtype != torch.int32 or grid.dim() != 1 or not grid.is_contiguous() or grid.shape[0] != d * w:
        raise ValueError(f"grid must be a contiguous int32 [d * w] = [{d * w}] tensor")
    if not 1 <= d:
        raise ValueError(f"d must be at least 1, got {d}")
    _log2(w, "w")
    dev = grid.device
    n = keys_a.shape[0] if keys_a.dim() == 1 else -1
    _check_ids(dev, n, (keys_a, "keys"), (keys_b, "dst"), (counts, "counts"))
    for t, name in ((keys_a, "keys"), (keys_b, "dst")):
        if t is not None:
            _check_int32(t, name)
    _check_mask(mask, n, dev)
    if dev.type != "cuda":
        TWIN_CALLS["cm_fold"] += 1
        cm_fold_plain(grid, d, w, keys_a, counts, mask)
        return grid if keys_b is None else cm_fold_plain(grid, d, w, keys_b, counts, mask)
    a_c, b_c, mask_c = _dense(keys_a, keys_b, mask)
    cnt_c = None if counts is None else counts.to(torch.int32).contiguous()
    err = _cuda.library(_SOURCE).cm_fold_launch(grid.data_ptr(), d, w, a_c.data_ptr(), _ptr(b_c), _ptr(cnt_c),
                                                _ptr(mask_c), n, _stream(dev))
    _cuda.check(err, "cm_fold_launch")
    LAUNCHES["cm_fold"] += 1
    return grid


def cm_fold(grid: torch.Tensor, d: int, w: int, keys: torch.Tensor, counts: Optional[torch.Tensor],
            mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Add each kept key's count (``counts`` None: 1) into its column of
    all d rows of the flat int32 grid [d * w], in place (int32, wrapping);
    ``keys`` are int32 ids.  Returns ``grid``."""
    return _cm_call(grid, d, w, keys, None, counts, mask)


def cm_degree_fold(grid: torch.Tensor, d: int, w: int, src: torch.Tensor, dst: torch.Tensor,
                   mask: Optional[torch.Tensor]) -> torch.Tensor:
    """``CountMinHeavyHitters.update`` in place: 1 for src, then 1 for
    dst, into every row; one C call."""
    return _cm_call(grid, d, w, src, dst, None, mask)


def _tri_scratch(kind: str, dev, rows: int) -> torch.Tensor:
    """The scratch of tri_fold (``kind`` "fold": its tickets and the
    clusters' winners) or of the closure count ("closures": its sum,
    ticket and pairs, and the tables as one block built them), one a
    device and R, kept; zeroed once, the kernels leave their counters
    zero."""
    key = (kind, dev, rows)
    buf = _scratch.get(key)
    if buf is None:
        lib = _cuda.library(_SOURCE)
        nbytes = int((lib.tri_fold_scratch_bytes if kind == "fold" else lib.tri_closures_scratch_bytes)(rows))
        if nbytes < 0:
            raise RuntimeError(f"{kind} scratch: no size for {rows} rows on {dev}")
        buf = _scratch[key] = torch.zeros((nbytes,), dtype=torch.uint8, device=dev)
    return buf


def _check_sample(eh, elo, ehi) -> None:
    dev = eh.device
    if eh.dtype != torch.int64 or eh.dim() != 1 or not eh.is_contiguous():
        raise ValueError("eh must be a contiguous int64 [R] tensor of u32 hashes")
    for t, name in ((elo, "elo"), (ehi, "ehi")):
        if t.dtype != torch.int32 or t.shape != eh.shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{name} must be a contiguous int32 tensor of eh's shape on {dev}")
    _log2(eh.shape[0], "the sample's rows")


@_cuda.on_device_of("eh")
def tri_fold(eh: torch.Tensor, elo: torch.Tensor, ehi: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             mask: Optional[torch.Tensor], regs: Optional[torch.Tensor] = None):
    """Fold an edge batch into the R-row min-hash sample (eh int64, elo,
    ehi int32 [R]) in place; given ``regs`` (int32 [m]), also the
    canonical edges' hashes into those distinct-edge registers under
    ``mask & (lo != hi)`` (a row outside it as rank 0); one C call.
    Returns (eh, elo, ehi)."""
    _check_sample(eh, elo, ehi)
    dev = eh.device
    if regs is not None:
        _check_regs(regs)
        if regs.device != dev:
            raise ValueError(f"regs must be on {dev}")
    n = src.shape[0]
    _check_ids(dev, n, (src, "src"), (dst, "dst"))
    _check_int32(src, "src")
    _check_int32(dst, "dst")
    _check_mask(mask, n, dev)
    if dev.type != "cuda":
        TWIN_CALLS["tri_fold"] += 1
        return tri_fold_plain(eh, elo, ehi, src, dst, mask, regs)
    scratch = _tri_scratch("fold", dev, eh.shape[0])
    src_c, dst_c, mask_c = _dense(src, dst, mask)
    err = _cuda.library(_SOURCE).tri_fold_launch(
        eh.data_ptr(), elo.data_ptr(), ehi.data_ptr(), eh.shape[0], _ptr(regs), 0 if regs is None else regs.shape[0],
        src_c.data_ptr(), dst_c.data_ptr(), _ptr(mask_c), n, scratch.data_ptr(), scratch.numel(), _stream(dev))
    _cuda.check(err, "tri_fold_launch")
    LAUNCHES["tri_fold"] += 1
    return eh, elo, ehi


@_cuda.on_device_of("elo")
def tri_sampled_closures(elo: torch.Tensor, ehi: torch.Tensor) -> torch.Tensor:
    """The closed wedges among the sampled rows // 2 (three times the
    fully sampled triangle count), an int32 0-d tensor on their device.
    On the card R is at most CLOSURE_MAX."""
    if elo.dtype != torch.int32 or elo.dim() != 1 or ehi.dtype != torch.int32 or ehi.shape != elo.shape \
            or ehi.device != elo.device:
        raise ValueError("elo and ehi must be int32 [R] tensors on one device")
    rows = elo.shape[0]
    _log2(rows, "the sample's rows")
    dev = elo.device
    if dev.type != "cuda":
        TWIN_CALLS["tri_sampled_closures"] += 1
        return tri_sampled_closures_plain(elo, ehi)
    if rows > CLOSURE_MAX:
        raise ValueError(f"the closure count on the card takes at most {CLOSURE_MAX} rows, got {rows}")
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    scratch = _tri_scratch("closures", dev, rows)
    elo_c, ehi_c = _dense(elo, ehi)
    err = _cuda.library(_SOURCE).tri_closures_launch(elo_c.data_ptr(), ehi_c.data_ptr(), rows, out.data_ptr(),
                                                     scratch.data_ptr(), scratch.numel(), _stream(dev))
    _cuda.check(err, "tri_closures_launch")
    LAUNCHES["tri_sampled_closures"] += 1
    return out[0]
