"""Degree kernels: the wrappers of ``csrc/degrees.cu`` and their plain twins.

* ``degree_trace`` is the kernel of the continuous degree stream
  (``EdgeStream.get_degrees`` and its in/out variants; the JAX package's
  ``_degree_stream`` kernel, ``core/stream.py:869-884``): the running
  degree ``counts[v] + rank + 1`` of every endpoint row, rank being its
  occurrence rank among the valid rows of its vertex in the batch, the
  counts update, and the records packed 48 bits a row plus one mask bit
  (vertex spaces up to 2^20) or as raw columns.
* ``degree_fold`` is ``DegreeDistributionSummary.update``: one added to the
  degree of both endpoints of every valid row.
* ``degree_dist_scan`` is ``degree_dist_update``'s scan
  (``library/degree_distribution.py:43-84`` of the JAX package): the
  fully-dynamic (degree, count) histogram records, event by event, computed
  as two segmented scans, a per-vertex degree walk and per-degree counts.
  ``degree_dist_scan_serial`` is its first, one-thread kernel, kept as an
  oracle on the card.

The wrappers update their state tensors in place.  On CUDA tensors each is
one C call (``degree_trace`` after a stable ``torch.sort`` of the grouping
keys, a scan kernel and a pack kernel; ``degree_dist_scan`` three, the two
scans each after a stable sort)
and ``LAUNCHES`` counts it once; on CPU tensors they run the plain twins
(``*_plain``: the same algorithm in PyTorch ops), which return new tensors
and launch nothing, and ``TWIN_CALLS`` counts those calls.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gelly_streaming_tpu_torch.io import wire
from gelly_streaming_tpu_torch.ops import _cuda, indexing, segments

_SOURCE = "degrees.cu"
_MAX_KEY_CAPACITY = 1 << 30  # grouping keys 2 * v + 1 must fit int32

# kernel launches since the last reset_launches() (CUDA tensors only)
LAUNCHES: Dict[str, int] = {"degree_trace": 0, "degree_fold": 0, "degree_dist_scan": 0, "degree_dist_scan_serial": 0}
# the wrappers' twin calls on CPU tensors since the last reset_launches()
TWIN_CALLS: Dict[str, int] = {"degree_trace": 0, "degree_fold": 0, "degree_dist_scan": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


def _check_vector(t: torch.Tensor, dtype: torch.dtype, name: str, like: torch.Tensor) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor")
    if t.device != like.device:
        raise ValueError(f"{name} must be on {like.device}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(t: torch.Tensor, kernel: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no {kernel} kernel for device {t.device}")


# ---------------------------------------------------------------------------
# the degree trace


def degree_trace_plain(
    counts: torch.Tensor, v: torch.Tensor, m: torch.Tensor, packed: bool
) -> Tuple[torch.Tensor, tuple]:
    """(new counts, outs): outs is ``(records uint8[6n], mask bits
    uint8[ceil(n/8)])`` when ``packed``, else ``(v, emitted int32, m)``."""
    rank = segments.occurrence_rank(v, m)
    emitted = counts[indexing.gather_index(v, counts.shape[0])] + rank + 1
    counts = indexing.scatter_add_(counts.clone(), torch.where(m, v, 0), m.to(torch.int32))
    if packed:
        return counts, (wire.pack_records48(v, emitted), wire.pack_mask_bits(m))
    return counts, (v, emitted, m)


@_cuda.on_device_of("counts")
def degree_trace(counts: torch.Tensor, v: torch.Tensor, m: torch.Tensor, packed: bool) -> tuple:
    """The records of one batch of endpoint rows ``v`` (valid where ``m``)
    against the running ``counts``, which are updated in place; returns the
    outs of ``degree_trace_plain``."""
    _check_vector(counts, torch.int32, "counts", counts)
    _check_vector(v, torch.int32, "v", counts)
    _check_vector(m, torch.bool, "m", counts)
    if m.shape != v.shape:
        raise ValueError("v and m must have the same shape")
    if counts.device.type == "cpu":
        TWIN_CALLS["degree_trace"] += 1
        new, outs = degree_trace_plain(counts, v, m, packed)
        counts.copy_(new)
        return outs
    _require_cuda(counts, "degree_trace")
    if counts.shape[0] > _MAX_KEY_CAPACITY or v.shape[0] >= 1 << 31:
        raise ValueError("degree_trace needs vertex ids below 2^30 and fewer than 2^31 rows")
    n = v.shape[0]
    keys = (v << 1) | (~m).to(torch.int32)
    sorted_keys, order = torch.sort(keys, stable=True)
    dev = counts.device
    if packed:
        records = torch.empty((6 * n,), dtype=torch.uint8, device=dev)
        maskbits = torch.empty(((n + 7) // 8,), dtype=torch.uint8, device=dev)
        emitted = None
    else:
        records = maskbits = None
        emitted = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        lib = _cuda.library(_SOURCE)
        scratch_bytes = lib.degree_trace_scratch_bytes(n)
        scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
        err = lib.degree_trace_launch(
            v.data_ptr(), m.data_ptr(), sorted_keys.data_ptr(), order.data_ptr(), n,
            counts.data_ptr(), counts.shape[0], _ptr(records), _ptr(maskbits), _ptr(emitted),
            scratch.data_ptr(), scratch_bytes, _stream(counts),
        )
        _cuda.check(err, "degree_trace_launch")
        LAUNCHES["degree_trace"] += 1
    return (records, maskbits) if packed else (v, emitted, m)


# ---------------------------------------------------------------------------
# the degree fold


def degree_fold_plain(
    deg: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """A new degree vector: one added at both endpoints of every valid row."""
    ones = torch.ones(src.shape, dtype=torch.int32, device=src.device) if mask is None else mask.to(torch.int32)
    s = src if mask is None else torch.where(mask, src, 0)
    d = dst if mask is None else torch.where(mask, dst, 0)
    return indexing.scatter_add_(indexing.scatter_add_(deg.clone(), s, ones), d, ones)


@_cuda.on_device_of("deg")
def degree_fold(
    deg: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Fold a batch into ``deg`` in place; returns ``deg``."""
    _check_vector(deg, torch.int32, "deg", deg)
    _check_vector(src, torch.int32, "src", deg)
    _check_vector(dst, torch.int32, "dst", deg)
    if mask is not None:
        _check_vector(mask, torch.bool, "mask", deg)
    if src.shape != dst.shape or (mask is not None and mask.shape != src.shape):
        raise ValueError("src, dst and mask must have the same shape")
    if deg.device.type == "cpu":
        TWIN_CALLS["degree_fold"] += 1
        return deg.copy_(degree_fold_plain(deg, src, dst, mask))
    _require_cuda(deg, "degree_fold")
    n = src.shape[0]
    if n:
        err = _cuda.library(_SOURCE).degree_fold_launch(
            deg.data_ptr(), src.data_ptr(), dst.data_ptr(), _ptr(mask), n, deg.shape[0], _stream(deg)
        )
        _cuda.check(err, "degree_fold_launch")
        LAUNCHES["degree_fold"] += 1
    return deg


# ---------------------------------------------------------------------------
# the fully-dynamic degree distribution scan
#
# Each event touches the state only through two keyed cells, so the JAX
# scan is two segmented scans (csrc/degrees.cu says why):
#   stage 1, rows r = 2e + j grouped by their vertex's clamped index: the
#   degree walk d -> max(d + a, 0) in closed form, T - min(0, running min
#   of T), T the segmented sum of the effective signs seeded with deg at
#   the group's head;
#   stage 2, record slots s = 4e + 2j + {0 new, 1 old} grouped by their
#   clamped degree: hist[key] plus the segmented sum of the +1/-1 adds.
# A group whose additions could carry a degree past 2^31 - 1 (or that
# starts below 0) is walked in order instead, as JAX wraps there.

_I32_MAX = (1 << 31) - 1
_UNSAFE = 1 << 40  # Q of a group whose degree starts below 0
_MAX_SCAN_EVENTS = 1 << 28  # the 8n record words fit int32 indices


def _i32(x: int) -> int:
    """Python int -> int32 with two's-complement wrap."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _groups(keys: torch.Tensor):
    """(sorted keys, order, head, end, group id, first sorted position of
    each row's group) of a stable grouping."""
    sk, order = torch.sort(keys, stable=True)
    head = segments.segment_boundaries(sk)
    end = torch.cat([head[1:], torch.ones((1,), dtype=torch.bool, device=sk.device)])
    gid = torch.cumsum(head, 0) - 1
    start = torch.nonzero(head).reshape(-1)[gid]
    return sk, order, head, end, gid, start


def _segmented_sum(v: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    """Inclusive sums of the int64 ``v`` within groups (sorted order)."""
    cs = torch.cumsum(v, 0)
    return cs - (cs - v)[start]


def _segmented_cummin(v: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Running minima of the int64 ``v`` within groups: each later group is
    offset below every earlier one, so one global cummin stays inside it."""
    span = int(v.max() - v.min()) + 1
    offset = gid * span
    return torch.cummin(v - offset, 0).values + offset


def degree_dist_scan_plain(
    deg: torch.Tensor,
    hist: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    sign: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(new deg, new hist, records int32[B, 4, 2], record mask bool[B, 4]):
    the JAX scan as the two segmented scans, in PyTorch ops."""
    cap, n, dev = deg.shape[0], src.shape[0], deg.device
    x = torch.stack([src, dst], 1).reshape(-1).long()
    a = torch.ones_like(x) if sign is None else sign.long().repeat_interleave(2)
    m = mask.repeat_interleave(2)
    xn = indexing.normalize(x, cap)
    in_range = (xn >= 0) & (xn < cap)
    new_deg, new_hist = deg.clone(), hist.clone()
    if n == 0:
        return new_deg, new_hist, torch.zeros((0, 4, 2), dtype=torch.int32, device=dev), \
            torch.zeros((0, 4), dtype=torch.bool, device=dev)

    # stage 1, in sorted order
    sk, order, head, end, gid, start = _groups(xn.clamp(0, cap - 1))
    a_s, m_s = a[order], m[order]
    eff = torch.where(m_s & in_range[order], a_s, 0)
    d0 = deg.long()[sk]
    t = d0 + _segmented_sum(eff, start)
    after = t - _segmented_cummin(t, gid).clamp(max=0)
    old = torch.where(head, d0, after.roll(1))
    q = torch.where(d0 < 0, _UNSAFE, d0) + _segmented_sum(eff.clamp(min=0), start)
    unsafe = (q > _I32_MAX)[end][gid]  # the group's Q is its last row's
    ends = end & ~unsafe
    new_deg[sk[ends]] = after[ends].to(torch.int32)
    if bool(unsafe.any()):
        # JAX's int32 walk, in order, for the few groups near the wrap
        pos = torch.nonzero(unsafe).reshape(-1).tolist()
        key_of, xs, aa, mm = sk.tolist(), in_range[order].tolist(), a_s.tolist(), m_s.tolist()
        olds = old.tolist()
        cell = {}
        for p in pos:
            k = key_of[p]
            d = cell.get(k, int(deg[k]))
            olds[p] = d
            ok = mm[p] and not (aa[p] < 0 and d <= 0)
            if xs[p] and ok:
                d = max(_i32(d + aa[p]), 0)
            cell[k] = d
        for k, d in cell.items():
            new_deg[k] = d
        old = torch.tensor(olds, dtype=torch.int64, device=dev)
    new = _wrap32(old + a_s).long().clamp(min=0)
    ok = m_s & ~((a_s < 0) & (old <= 0))
    emit_new, emit_old = ok & (new > 0), ok & (old > 0)

    # back to arrival order: slot s = 2r + k, k = 0 new, 1 old
    val = torch.empty((2 * n, 2), dtype=torch.int64, device=dev)
    val[order] = torch.stack([new, old], 1)
    emit = torch.empty((2 * n, 2), dtype=torch.bool, device=dev)
    emit[order] = torch.stack([emit_new, emit_old], 1)
    val, emit = val.reshape(-1), emit.reshape(-1)

    # stage 2, in sorted order
    step = torch.tensor([1, -1], dtype=torch.int64, device=dev).repeat(2 * n)
    add = torch.where(emit & (val < cap), step, 0)
    sk2, order2, _, end2, _, start2 = _groups(indexing.normalize(val, cap).clamp(0, cap - 1))
    count_s = _wrap32(hist.long()[sk2] + _segmented_sum(add[order2], start2))
    new_hist[sk2[end2]] = count_s[end2]
    count = torch.empty((4 * n,), dtype=torch.int32, device=dev)
    count[order2] = count_s
    recs = torch.stack([val.to(torch.int32), count], 1).reshape(n, 4, 2)
    return new_deg, new_hist, recs, emit.reshape(n, 4)


def _check_scan_args(deg, hist, src, dst, sign, mask) -> None:
    _check_vector(deg, torch.int32, "deg", deg)
    _check_vector(hist, torch.int32, "hist", deg)
    _check_vector(src, torch.int32, "src", deg)
    _check_vector(dst, torch.int32, "dst", deg)
    _check_vector(mask, torch.bool, "mask", deg)
    if sign is not None:
        _check_vector(sign, torch.int8, "sign", deg)
    if hist.shape != deg.shape:
        raise ValueError("deg and hist must have the same shape")
    if src.shape != dst.shape or mask.shape != src.shape or (sign is not None and sign.shape != src.shape):
        raise ValueError("src, dst, sign and mask must have the same shape")
    if src.shape[0] >= _MAX_SCAN_EVENTS:
        raise ValueError(f"degree_dist_scan takes fewer than {_MAX_SCAN_EVENTS} events a call")


@_cuda.on_device_of("deg")
def degree_dist_scan(
    deg: torch.Tensor,
    hist: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    sign: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan one batch of signed events (``sign`` None = all additions) into
    ``deg``/``hist`` in place; returns ``(records int32[B, 4, 2], record
    mask bool[B, 4])``, per event the slots [u new degree, u old degree, v
    new degree, v old degree], each a (degree, count) record."""
    _check_scan_args(deg, hist, src, dst, sign, mask)
    if deg.device.type == "cpu":
        TWIN_CALLS["degree_dist_scan"] += 1
        new_deg, new_hist, recs, rmask = degree_dist_scan_plain(deg, hist, src, dst, sign, mask)
        deg.copy_(new_deg)
        hist.copy_(new_hist)
        return recs, rmask
    _require_cuda(deg, "degree_dist_scan")
    n, cap, dev = src.shape[0], deg.shape[0], deg.device
    recs = torch.empty((n, 4, 2), dtype=torch.int32, device=dev)
    rmask = torch.empty((n, 4), dtype=torch.bool, device=dev)
    if n:
        lib, stream = _cuda.library(_SOURCE), _stream(deg)
        keys = torch.empty((2 * n,), dtype=torch.int32, device=dev)
        words = torch.empty((2 * n,), dtype=torch.int32, device=dev)
        _cuda.check(lib.degree_dist_keys_launch(
            src.data_ptr(), dst.data_ptr(), _ptr(sign), mask.data_ptr(), n, cap, keys.data_ptr(), words.data_ptr(),
            stream,
        ), "degree_dist_keys_launch")
        sorted_keys, order = torch.sort(keys, stable=True)
        key2 = torch.empty((4 * n,), dtype=torch.int32, device=dev)
        scratch_bytes = lib.degree_dist_scratch_bytes(n)
        scratch = torch.empty((scratch_bytes,), dtype=torch.uint8, device=dev)
        _cuda.check(lib.degree_dist_rows_launch(
            deg.data_ptr(), cap, sorted_keys.data_ptr(), order.data_ptr(), words.data_ptr(), n, recs.data_ptr(),
            rmask.data_ptr(), key2.data_ptr(), scratch.data_ptr(), scratch_bytes, stream,
        ), "degree_dist_rows_launch")
        sorted_key2, order2 = torch.sort(key2, stable=True)
        _cuda.check(lib.degree_dist_counts_launch(
            hist.data_ptr(), cap, sorted_key2.data_ptr(), order2.data_ptr(), rmask.data_ptr(), n,
            recs.data_ptr(), scratch.data_ptr(), scratch_bytes, stream,
        ), "degree_dist_counts_launch")
        LAUNCHES["degree_dist_scan"] += 1
    return recs, rmask


@_cuda.on_device_of("deg")
def degree_dist_scan_serial(
    deg: torch.Tensor,
    hist: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    sign: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``degree_dist_scan`` by the first design's kernel, one thread walking
    the events in order; CUDA tensors only.  On no main path: an oracle on
    the card that shares nothing with the two-stage form."""
    _check_scan_args(deg, hist, src, dst, sign, mask)
    _require_cuda(deg, "degree_dist_scan_serial")
    n = src.shape[0]
    recs = torch.empty((n, 4, 2), dtype=torch.int32, device=deg.device)
    rmask = torch.empty((n, 4), dtype=torch.bool, device=deg.device)
    if n:
        err = _cuda.library(_SOURCE).degree_dist_scan_serial_launch(
            deg.data_ptr(), hist.data_ptr(), deg.shape[0], src.data_ptr(), dst.data_ptr(),
            _ptr(sign), mask.data_ptr(), n, recs.data_ptr(), rmask.data_ptr(), _stream(deg),
        )
        _cuda.check(err, "degree_dist_scan_serial_launch")
        LAUNCHES["degree_dist_scan_serial"] += 1
    return recs, rmask
