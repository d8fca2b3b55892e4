"""Degree-bucketed neighborhood grouping of a window pane.

Port of ``gelly_streaming_tpu/ops/neighborhoods.py``.  A pane's padded
edge list is grouped by source key on the device: bucket b holds the keys
whose valid degree lies in (2^(b-1), 2^b], one row a key in sorted key
order, its neighbors in arrival order in the row's first ``degree``
columns of D_b = 2^b, so one hub vertex no longer pads every row to the
pane's maximum degree.

``bucket_shapes`` gives the JAX package's static (K_b, D_b).  The port
allocates only each bucket's real rows: the counts are copied to the host
once a pane (the JAX sync path makes the same copy at ``int(num_keys)``),
so every returned bucket holds exactly ``num_keys`` rows, equal to the
first ``num_keys`` rows of the JAX bucket, and ``num_keys`` is a Python
int.

The JAX package's quirks are kept: a key's row carries ``max(src, 0)``
(its key table is a scatter-max against zeros, so a source id below 0
surfaces as key 0), neighbor ids pass through raw, and a key whose degree
class has no bucket (possible only when E is not a power of two) is
dropped.

On CUDA tensors ``build_buckets`` is three C calls into
``csrc/neighborhoods.cu``, counted once in ``LAUNCHES``: a stable radix
sort of the valid rows by source (its digit passes planned on the device
from the sources' range, as ``radix_plan`` gives them), a count pass and a
scatter pass (one more scatter a value leaf); on CPU tensors it runs
``build_buckets_plain``, the same algorithm in PyTorch ops, and launches
nothing.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from gelly_streaming_tpu_torch.core.types import tree_leaves, tree_map, _tree_unflatten_like
from gelly_streaming_tpu_torch.ops import _cuda, segments

_SOURCE = "neighborhoods.cu"
_DIGIT_BITS = 8  # bits a radix pass sorts (csrc/neighborhoods.cu kDigitBits)

# kernel launches since the last reset_launches() (CUDA tensors only)
LAUNCHES: Dict[str, int] = {"build_buckets": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class NeighborhoodBucket(NamedTuple):
    """One degree class of a pane: [num_keys, D_b] tensors on the pane's device."""

    keys: torch.Tensor  # int32[num_keys]
    nbrs: torch.Tensor  # int32[num_keys, D_b]
    vals: Optional[object]  # value tree of [num_keys, D_b, ...] or None
    valid: torch.Tensor  # bool[num_keys, D_b]
    num_keys: int  # real keys in this bucket


def radix_plan(lo: Optional[int], hi: Optional[int]) -> Tuple[int, ...]:
    """The digit shifts of the radix sort for valid sources in [lo, hi]
    (None, None: no valid row): 8-bit digits over the bits that hi - lo
    spans, and at least one pass, which also drops the masked rows.  The
    kernels plan the same on the device."""
    bits = 0 if lo is None else (hi - lo).bit_length()
    return tuple(range(0, max(1, -(-bits // _DIGIT_BITS)) * _DIGIT_BITS, _DIGIT_BITS))


def bucket_shapes(e_pad: int) -> List[tuple]:
    """The JAX package's static (K_b, D_b) per degree bucket for a pow2
    edge capacity (the port allocates only each bucket's real rows)."""
    shapes = []
    b = 0
    while (1 << b) <= e_pad:
        d = 1 << b
        k = max(1, min(e_pad, (2 * e_pad) // d))
        shapes.append((k, d))
        b += 1
    return shapes


def _ceil_log2(deg: torch.Tensor) -> torch.Tensor:
    """ceil(log2(deg)) for deg >= 1 (0 for deg <= 1), exactly: the bit length
    of deg - 1, read off float64's exponent (exact below 2^53)."""
    return torch.frexp((deg.to(torch.int64) - 1).clamp(min=0).to(torch.float64)).exponent.to(torch.int32)


def _check(src, dst, val, mask) -> None:
    for t, name, dtype in ((src, "src", torch.int32), (dst, "dst", torch.int32), (mask, "mask", torch.bool)):
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
        if t.device != src.device or t.shape != src.shape:
            raise ValueError(f"{name} must lie on {src.device} with src's shape")
    for leaf in tree_leaves(val):
        if leaf.device != src.device or leaf.dim() < 1 or leaf.shape[0] != src.shape[0]:
            raise ValueError("every value leaf must lie on src's device with src's length first")


def build_buckets_plain(src, dst, val, mask) -> List[NeighborhoodBucket]:
    """The JAX package's ``build_buckets`` (``ops/neighborhoods.py:55-135``)
    in PyTorch ops, real rows only."""
    e = src.shape[0]
    dev = src.device
    order, sorted_gk = segments.sort_by_key(src, mask)
    ks, kd, kmask = src[order], dst[order], mask[order]
    kval = tree_map(lambda a: a[order], val)
    boundary = segments.segment_boundaries(sorted_gk) if e else torch.zeros((0,), dtype=torch.bool, device=dev)
    key_id = torch.cumsum(boundary, 0) - 1  # dense segment rank [E]
    pos = torch.arange(e, device=dev)
    seg_start = torch.cummax(torch.where(boundary, pos, 0), 0).values if e else pos
    col = pos - seg_start  # within-key arrival rank

    deg = torch.zeros((e,), dtype=torch.int32, device=dev).index_add_(0, key_id, kmask.to(torch.int32))
    key_of = torch.zeros((e,), dtype=torch.int32, device=dev).scatter_reduce_(
        0, torch.where(kmask, key_id, 0), torch.where(kmask, ks, 0), "amax"
    )
    key_valid = deg > 0
    bucket_of = torch.where(key_valid, _ceil_log2(deg), -1)

    out: List[NeighborhoodBucket] = []
    for b, (_k_b, d_b) in enumerate(bucket_shapes(e)):
        in_b = bucket_of == b  # per key slot
        n_b = int(in_b.sum())
        row_of = torch.cumsum(in_b, 0) - 1
        keys_b = torch.zeros((n_b,), dtype=torch.int32, device=dev)
        keys_b[row_of[in_b]] = key_of[in_b]
        esel = kmask & in_b[key_id]
        erow, ecol = row_of[key_id][esel], col[esel]
        nbrs_b = torch.zeros((n_b, d_b), dtype=torch.int32, device=dev)
        nbrs_b[erow, ecol] = kd[esel]
        valid_b = torch.zeros((n_b, d_b), dtype=torch.bool, device=dev)
        valid_b[erow, ecol] = True

        def scatter_leaf(a):
            leaf = torch.zeros((n_b, d_b) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
            leaf[erow, ecol] = a[esel]
            return leaf

        out.append(NeighborhoodBucket(keys_b, nbrs_b, tree_map(scatter_leaf, kval), valid_b, n_b))
    return out


def sort_valid_rows_plain(src, dst, mask) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(src, dst, arrival index) of the valid rows, stably sorted by src:
    the order of ``torch.sort(stable=True)`` of the grouping keys, masked
    rows dropped."""
    keys = (src.to(torch.int64) << 1) | (~mask).to(torch.int64)
    order = torch.sort(keys, stable=True).indices
    order = order[mask[order]]
    return src[order], dst[order], order.to(torch.int32)


@_cuda.on_device_of("src")
def sort_valid_rows(src, dst, mask) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """(src, dst, arrival index, passes): the valid rows as the CUDA radix
    sort leaves them (a check of ``build_buckets``' sort; passes = the
    number of digit passes the device planned).  On CPU tensors the plain
    sort, with the passes ``radix_plan`` gives."""
    _check(src, dst, None, mask)
    if src.device.type == "cpu":
        s, d, i = sort_valid_rows_plain(src, dst, mask)
        lohi = (int(s.min()), int(s.max())) if s.numel() else (None, None)
        return s, d, i, len(radix_plan(*lohi))
    n = src.shape[0]
    if n == 0:
        empty = torch.empty((0,), dtype=torch.int32, device=src.device)
        return empty, empty, empty, 1
    lib = _cuda.library(_SOURCE)
    stream = torch.cuda.current_stream(src.device).cuda_stream
    scratch = torch.empty((lib.nb_scratch_bytes(n, 1),), dtype=torch.uint8, device=src.device)
    out = torch.empty((3, n), dtype=torch.int32, device=src.device)
    meta = torch.empty((3,), dtype=torch.int32, device=src.device)
    _cuda.check(lib.nb_sort_launch(src.data_ptr(), dst.data_ptr(), mask.data_ptr(), n, 1, scratch.data_ptr(),
                                   scratch.numel(), stream), "nb_sort_launch")
    _cuda.check(lib.nb_sorted_launch(n, 1, scratch.data_ptr(), scratch.numel(), out[0].data_ptr(),
                                     out[1].data_ptr(), out[2].data_ptr(), meta.data_ptr(), stream),
                "nb_sorted_launch")
    _lo, valid, passes = meta.tolist()
    return out[0, :valid], out[1, :valid], out[2, :valid], passes


@_cuda.on_device_of("src")
def build_buckets(src, dst, val, mask) -> List[NeighborhoodBucket]:
    """Group a padded edge list by source key into degree buckets.

    ``src``/``dst``: int32 [E]; ``mask``: bool [E]; ``val``: None or a value
    tree of [E, ...] leaves.  Returns one bucket per degree class of
    ``bucket_shapes(E)`` (possibly with no rows); neighbor columns within a
    key are in arrival order.  Ids must lie in [-2^30, 2^30) (the int32
    grouping key 2 * src + 1 of either package)."""
    _check(src, dst, val, mask)
    if src.device.type == "cpu":
        return build_buckets_plain(src, dst, val, mask)
    if src.device.type != "cuda":
        raise ValueError(f"no build_buckets kernel for device {src.device}")
    e = src.shape[0]
    shapes = bucket_shapes(e)
    if e == 0:
        return []
    if e >= 1 << 30:
        raise ValueError("build_buckets takes fewer than 2^30 edges")
    nb = len(shapes)
    dev = src.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    leaves = [leaf.contiguous() for leaf in tree_leaves(val)]
    with_idx = int(bool(leaves))
    lib = _cuda.library(_SOURCE)
    scratch = torch.empty((lib.nb_scratch_bytes(e, with_idx),), dtype=torch.uint8, device=dev)
    totals = torch.empty((nb,), dtype=torch.int32, device=dev)
    sp = (scratch.data_ptr(), scratch.numel())
    _cuda.check(lib.nb_sort_launch(src.data_ptr(), dst.data_ptr(), mask.data_ptr(), e, with_idx, *sp,
                                   stream), "nb_sort_launch")
    _cuda.check(lib.nb_count_launch(e, nb, with_idx, *sp, totals.data_ptr(), stream), "nb_count_launch")
    counts = totals.tolist()  # the one copy to the host a pane
    n_keys, n_slots = sum(counts), sum(n << b for b, n in enumerate(counts))
    keys_all = torch.empty((n_keys,), dtype=torch.int32, device=dev)
    nbrs_all = torch.empty((n_slots,), dtype=torch.int32, device=dev)
    valid_all = torch.empty((n_slots,), dtype=torch.bool, device=dev)
    _cuda.check(lib.nb_scatter_launch(e, nb, with_idx, *sp, keys_all.data_ptr(), nbrs_all.data_ptr(),
                                      valid_all.data_ptr(), stream), "nb_scatter_launch")
    leaves_all = []
    for leaf in leaves:
        out = torch.empty((n_slots,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=dev)
        elem = leaf.element_size() * leaf[0].numel()
        _cuda.check(lib.nb_scatter_values_launch(e, nb, *sp, leaf.data_ptr(), out.data_ptr(), elem, stream),
                    "nb_scatter_values_launch")
        leaves_all.append(out)
    LAUNCHES["build_buckets"] += 1

    buckets = []
    k0 = s0 = 0
    for b, n in enumerate(counts):
        d = 1 << b
        views = [a[s0 : s0 + n * d].view((n, d) + tuple(a.shape[1:])) for a in leaves_all]
        buckets.append(
            NeighborhoodBucket(
                keys_all[k0 : k0 + n],
                nbrs_all[s0 : s0 + n * d].view(n, d),
                None if val is None else _tree_unflatten_like(val, views),
                valid_all[s0 : s0 + n * d].view(n, d),
                n,
            )
        )
        k0, s0 = k0 + n, s0 + n * d
    return buckets
