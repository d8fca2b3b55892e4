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
  fully-dynamic (degree, count) histogram records, event by event.

The wrappers update their state tensors in place.  On CUDA tensors each is
one C call (``degree_trace`` after a stable ``torch.sort`` of the grouping
keys) and ``LAUNCHES`` counts it; on CPU tensors they run the plain twins
(``*_plain``: the JAX algorithm in PyTorch ops, or, for the sequential scan,
a Python loop), which return new tensors and launch nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from gelly_streaming_tpu_torch.io import wire
from gelly_streaming_tpu_torch.ops import _cuda, segments

_SOURCE = "degrees.cu"
_MAX_KEY_CAPACITY = 1 << 30  # grouping keys 2 * v + 1 must fit int32

# kernel launches since the last reset_launches() (CUDA tensors only)
LAUNCHES: Dict[str, int] = {"degree_trace": 0, "degree_fold": 0, "degree_dist_scan": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
    emitted = counts[v.long()] + rank + 1
    counts = counts.clone()
    counts.index_add_(0, torch.where(m, v, 0).long(), m.to(torch.int32))
    if packed:
        return counts, (wire.pack_records48(v, emitted), wire.pack_mask_bits(m))
    return counts, (v, emitted, m)


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
        err = _cuda.library(_SOURCE).degree_trace_launch(
            m.data_ptr(), sorted_keys.data_ptr(), order.data_ptr(), n,
            counts.data_ptr(), counts.shape[0], _ptr(records), _ptr(maskbits), _ptr(emitted),
            _stream(counts),
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
    deg = deg.clone()
    deg.index_add_(0, s.long(), ones)
    deg.index_add_(0, d.long(), ones)
    return deg


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


def _i32(x: int) -> int:
    """Python int -> int32 with two's-complement wrap."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def degree_dist_scan_plain(
    deg: torch.Tensor,
    hist: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    sign: Optional[torch.Tensor],
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(new deg, new hist, records int32[B, 4, 2], record mask bool[B, 4]):
    the JAX scan as a loop over the events, on the host."""
    cap = deg.shape[0]
    d, h = deg.tolist(), hist.tolist()
    us, vs, ms = src.tolist(), dst.tolist(), mask.tolist()
    sg = [1] * len(us) if sign is None else sign.tolist()
    recs, rmask = [], []

    def clamp(i):
        return min(max(i, 0), cap - 1)

    def change(v, delta, ok):
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
        recs.append([rec_new, [old, h[clamp(old)]]])
        rmask.append([emit_new, emit_old])

    for u, v, s, ok in zip(us, vs, sg, ms):
        change(u, s, ok)
        change(v, s, ok)
    dev = deg.device
    n = len(us)
    return (
        torch.tensor(d, dtype=torch.int32, device=dev),
        torch.tensor(h, dtype=torch.int32, device=dev),
        torch.tensor(recs, dtype=torch.int32, device=dev).reshape(n, 4, 2),
        torch.tensor(rmask, dtype=torch.bool, device=dev).reshape(n, 4),
    )


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
    if deg.device.type == "cpu":
        new_deg, new_hist, recs, rmask = degree_dist_scan_plain(deg, hist, src, dst, sign, mask)
        deg.copy_(new_deg)
        hist.copy_(new_hist)
        return recs, rmask
    _require_cuda(deg, "degree_dist_scan")
    n = src.shape[0]
    recs = torch.empty((n, 4, 2), dtype=torch.int32, device=deg.device)
    rmask = torch.empty((n, 4), dtype=torch.bool, device=deg.device)
    if n:
        err = _cuda.library(_SOURCE).degree_dist_scan_launch(
            deg.data_ptr(), hist.data_ptr(), deg.shape[0], src.data_ptr(), dst.data_ptr(),
            _ptr(sign), mask.data_ptr(), n, recs.data_ptr(), rmask.data_ptr(), _stream(deg),
        )
        _cuda.check(err, "degree_dist_scan_launch")
        LAUNCHES["degree_dist_scan"] += 1
    return recs, rmask
