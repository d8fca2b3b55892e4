"""Compact host->device wire format: packers on the host, unpack on the card.

Port of the parts of ``gelly_streaming_tpu/io/wire.py`` that the
aggregation wire path uses.  The packers and the (dst, src) sorter call
the port's native host library (``utils/native.py``, built from
``csrc/edge_parser.cpp``) when it loads, else the JAX package's numpy
fallbacks: the same bytes either way.  The device unpack (``unpack_edges``)
is the ``wire_unpack`` kernel at width 3 and PAIR40, and for EF40 and BDV
the ``ef40_unpack`` and ``bdv_decode`` kernels (``ops/wire_decode.py``) on
a CUDA buffer, their twins on a CPU one; widths 2 and 4 are PyTorch ops on
the buffer's device.
``resolve_binned_ingest`` and ``resolve_wire_compress`` resolve the binned
and compressed ingest switches (config, then env); ``decode_wire_into`` is
the native one-pass validate + decode (+ bin) of a wire buffer into
caller-owned arrays, with ``decode_wire_np`` its numpy twin.

Encodings (``width``):

* 2 / 3 / 4: the src block then the dst block, each id truncated to its
  low ``width`` little-endian bytes;
* ``PAIR40``: each edge as one 5-byte 20+20-bit pair (capacity <= 2^20);
* ``(EF40, capacity)``: the src-grouped Elias-Fano multiset, a unary src
  histogram of ``n + capacity`` bits then 20-bit dsts two per 5 bytes;
* ``(BDV, capacity)``: the (dst, src)-sorted group-varint delta stream
  (ops/wire_decode.py), bucket-padded.

EF40 and BDV ship a multiset, not the arrival order: order-free folds only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.ops import wire_decode
from gelly_streaming_tpu_torch.ops.wire_decode import ef40_nbytes
from gelly_streaming_tpu_torch.ops.wire_decode import pair40_fields as _pair40_fields
from gelly_streaming_tpu_torch.ops.wire_decode import unpack_edges_ef40  # noqa: F401  (the JAX module's name)
from gelly_streaming_tpu_torch.utils import metrics, native
from gelly_streaming_tpu_torch.utils.envswitch import resolve_switch

PAIR40 = wire_decode.PAIR40  # 5-byte (src, dst) pair packing for capacities <= 2^20
EF40 = "ef40"  # sorted Elias-Fano multiset packing (order-free folds only)
BDV = "bdv"  # destination-binned delta/varint packing (order-free folds only)

# BDV ids (and zigzag values) are bounded so every varint fits 4 bytes
BDV_MAX_ID_BITS = 28
# the native sorter covers the whole BDV id range; numpy lexsort is the
# no-library fallback only
_BDV_NATIVE_SORT_CAP = 1 << 28


def resolve_binned_ingest(cfg) -> bool:
    """Effective destination-binning switch: config > env > off.

    ``cfg.binned_ingest``: 1 forces on, 0 forces off, -1 defers to
    ``GELLY_BINNED_INGEST`` (default off).  A resolved ``wire_compress``
    turns binning on too (delta encoding needs the sorted bins), but an
    explicit ``binned_ingest=0`` pins the arrival-order path even against
    an ambient ``GELLY_WIRE_COMPRESS=1``."""
    if getattr(cfg, "binned_ingest", -1) == 0:
        return False
    if resolve_wire_compress(cfg):
        return True
    return resolve_switch(getattr(cfg, "binned_ingest", -1), "GELLY_BINNED_INGEST")


def resolve_wire_compress(cfg) -> bool:
    """Effective wire-compression switch: config > env > off.
    ``cfg.wire_compress``: 1 on, 0 off, -1 defers to ``GELLY_WIRE_COMPRESS``.
    An explicit ``binned_ingest=0`` pins the arrival-order path, so ambient
    env compression cannot ride it."""
    if getattr(cfg, "binned_ingest", -1) == 0 and getattr(cfg, "wire_compress", -1) != 1:
        return False
    return resolve_switch(getattr(cfg, "wire_compress", -1), "GELLY_WIRE_COMPRESS")


def width_for_capacity(capacity: int):
    """Tightest fixed encoding covering ids in [0, capacity): a byte width
    (2/3/4) or ``PAIR40`` for capacities in (2^16, 2^20]."""
    if capacity <= 1 << 16:
        return 2  # 4 bytes/edge
    if capacity <= 1 << 20:
        return PAIR40  # 5 bytes/edge
    if capacity <= 1 << 24:
        return 3  # 6 bytes/edge
    return 4


def wire_nbytes(n: int, width) -> int:
    """Wire bytes for an n-edge batch (BDV: the worst-case bound)."""
    if isinstance(width, tuple):
        if width[0] == BDV:
            return bdv_max_nbytes(n)
        return ef40_nbytes(n, width[1])
    return wire_decode.fixed_nbytes(n, width)


def replay_width(capacity: int, batch: int, order_free: bool = True):
    """Whichever legal encoding ships the fewest bytes for this (capacity,
    batch): EF40 for order-free folds with ids in 20 bits when its unary
    bitvector is outweighed by the 2.5 B/edge dst stream, else the fixed
    width."""
    fixed = width_for_capacity(capacity)
    if (
        order_free
        and capacity <= 1 << 20
        and ef40_nbytes(batch, capacity) < wire_nbytes(batch, fixed)
    ):
        return (EF40, capacity)
    return fixed


# ---------------------------------------------------------------------------
# host packers (numpy)


def _pack_edges40(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    n = src.shape[0]
    lib = native.load_ingest_lib()
    if lib is not None:
        out = np.empty(5 * n, np.uint8)
        if lib.pack_edges40(src.ctypes.data, dst.ctypes.data, n, out.ctypes.data) == out.nbytes:
            return out
    w = (src.astype(np.uint64) & 0xFFFFF) | ((dst.astype(np.uint64) & 0xFFFFF) << np.uint64(20))
    return np.ascontiguousarray(w.view(np.uint8).reshape(-1, 8)[:, :5]).reshape(-1)


def _pack_edges_ef40(src: np.ndarray, dst: np.ndarray, capacity: int) -> np.ndarray:
    """Src-grouped Elias-Fano multiset pack: the i-th grouped edge's one
    bit sits at position src_i + i of an (n + capacity)-bit vector, then
    the grouped dsts (stable within a group), 20 bits each, two per 5
    bytes."""
    n = src.shape[0]
    out = np.empty(ef40_nbytes(n, capacity), np.uint8)
    lib = native.load_ingest_lib()
    if lib is not None:
        wrote = lib.pack_edges_ef40(src.ctypes.data, dst.ctypes.data, n, capacity, out.ctypes.data, out.nbytes)
        if wrote == out.nbytes:
            return out
    order = np.argsort(src, kind="stable")
    s_grouped = src[order].astype(np.int64)
    d_grouped = dst[order].astype(np.int64) & 0xFFFFF
    bits = np.zeros((n + capacity,), np.uint8)
    bits[s_grouped + np.arange(n, dtype=np.int64)] = 1
    bv = np.packbits(bits, bitorder="little")
    pad = d_grouped if n % 2 == 0 else np.append(d_grouped, 0)
    pairs = pad[0::2].astype(np.uint64) | (pad[1::2].astype(np.uint64) << np.uint64(20))
    low = np.ascontiguousarray(pairs.view(np.uint8).reshape(-1, 8)[:, :5]).reshape(-1)
    out[: bv.nbytes] = bv
    out[bv.nbytes :] = low
    return out


def pack_edges(src: np.ndarray, dst: np.ndarray, width) -> np.ndarray:
    """Pack an edge batch into a uint8 wire buffer at ``width``."""
    if width not in (2, 3, 4, PAIR40) and not (
        isinstance(width, tuple) and width[0] in (EF40, BDV)
    ):
        raise ValueError(f"unsupported wire width {width}")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if dst.shape[0] != src.shape[0]:
        raise ValueError("src/dst length mismatch")
    if isinstance(width, tuple):
        if width[0] == BDV:
            return pack_edges_bdv(src, dst, width[1])
        return _pack_edges_ef40(src, dst, width[1])
    if width == PAIR40:
        return _pack_edges40(src, dst)
    n = src.shape[0]
    lib = native.load_ingest_lib()
    if lib is not None:
        out = np.empty(2 * n * width, np.uint8)
        if lib.pack_edges(src.ctypes.data, dst.ctypes.data, n, width, out.ctypes.data) == out.nbytes:
            return out

    def low_bytes(x: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(x.view(np.uint8).reshape(-1, 4)[:, :width]).reshape(-1)

    return np.concatenate([low_bytes(src), low_bytes(dst)])


def pack_edges_into(src: np.ndarray, dst: np.ndarray, width, out: np.ndarray) -> None:
    """Pack an edge batch straight into ``out`` (a contiguous
    ``uint8[wire_nbytes]`` slice, e.g. one row of a superbatch arena): the
    native packers write through the row's pointer with the GIL released;
    without the library the allocating packer's bytes are copied in."""
    if isinstance(width, tuple) and width[0] == BDV:
        # BDV rows are data-dependent sizes: group arenas bucket to the
        # group's own widest row instead (io/ingest.pack_bdv_group)
        raise ValueError("BDV buffers are variable-size; use pack_edges_bdv")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    n = src.shape[0]
    if dst.shape[0] != n:
        raise ValueError("src/dst length mismatch")
    expect = wire_nbytes(n, width)
    if out.dtype != np.uint8 or out.nbytes != expect or not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous uint8 buffer of {expect} bytes")
    lib = native.load_ingest_lib()
    if lib is not None:
        s_p, d_p, o_p = src.ctypes.data, dst.ctypes.data, out.ctypes.data
        if isinstance(width, tuple):
            if lib.pack_edges_ef40(s_p, d_p, n, width[1], o_p, expect) == expect:
                return
        elif width == PAIR40:
            if lib.pack_edges40(s_p, d_p, n, o_p) == expect:
                return
        elif lib.pack_edges(s_p, d_p, n, width, o_p) == expect:
            return
    out[:] = pack_edges(src, dst, width)


def pack_bucket_rows(src2d: np.ndarray, dst2d: np.ndarray, counts: np.ndarray, width) -> np.ndarray:
    """Pack per-shard edge buckets (``[S, cap]``, ``counts[s]`` valid a row)
    into ``uint8[S, wire_nbytes(cap, width)]`` rows whose pads keep the
    count-prefix contract of the mesh's device steps: fixed widths keep
    position (zero pads), EF40 sorts, so its pads are the maximal id pair
    and sort to the end.  Port of ``gelly_streaming_tpu/io/wire.py``'s."""
    n_rows, cap = src2d.shape
    rows = np.zeros((n_rows, wire_nbytes(cap, width)), np.uint8)
    pad_id = width[1] - 1 if isinstance(width, tuple) else 0
    s = np.empty((cap,), np.int32)
    d = np.empty((cap,), np.int32)
    for r in range(n_rows):
        k = int(counts[r])
        s[:k] = src2d[r, :k]
        d[:k] = dst2d[r, :k]
        s[k:] = pad_id
        d[k:] = pad_id
        pack_edges_into(s, d, width, rows[r])
    return rows


def pack_stream(
    src: np.ndarray, dst: np.ndarray, batch: int, width
) -> Tuple[list, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Pre-pack a finite edge stream into per-batch wire buffers: returns
    ``(bufs, tail)``, the full-batch buffers plus the raw ``(src, dst)``
    remainder (or None).  The producer side of ``EdgeStream.from_wire``."""
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    n_full = len(src) // batch
    bufs = [
        pack_edges(src[i * batch : (i + 1) * batch], dst[i * batch : (i + 1) * batch], width)
        for i in range(n_full)
    ]
    tail = (src[n_full * batch :], dst[n_full * batch :]) if len(src) > n_full * batch else None
    return bufs, tail


# ---------------------------------------------------------------------------
# BDV producer (numpy)


def bdv_max_nbytes(n: int, valued: bool = False) -> int:
    """Worst-case BDV bytes for an n-edge batch: a 4-byte dst-delta varint
    plus a 5-byte zigzag src-delta varint per edge (plus a 5-byte zigzag
    value when valued)."""
    return (14 if valued else 9) * max(int(n), 1)


def _sort_edges_bdv(src: np.ndarray, dst: np.ndarray, capacity: int, val=None):
    """(dst, src)-stable-sorted copy of a batch: the native counting/radix
    sort when the library is loaded (value-less batches), else numpy
    lexsort; the same order either way."""
    n = src.shape[0]
    if val is None and n and capacity <= _BDV_NATIVE_SORT_CAP:
        lib = native.load_ingest_lib()
        if lib is not None:
            out_s = np.empty(n, np.int32)
            out_d = np.empty(n, np.int32)
            rows = lib.sort_edges_dst_src(src.ctypes.data, dst.ctypes.data, n, capacity, out_s.ctypes.data,
                                          out_d.ctypes.data)
            if rows == n:
                return out_s, out_d, None
    order = np.lexsort((src, dst))
    return src[order], dst[order], None if val is None else np.asarray(val)[order]


def sort_edges_binned(src: np.ndarray, dst: np.ndarray, capacity: int, record_stats: bool = False):
    """Destination-bin a value-less batch: the (dst, src) stable sort every
    binned-ingest site shares.  ``record_stats`` raises the wire path's
    bin-occupancy high-water (utils.metrics).  Returns ``(src_sorted,
    dst_sorted)``."""
    s, d, _ = _sort_edges_bdv(
        np.ascontiguousarray(src, dtype=np.int32), np.ascontiguousarray(dst, dtype=np.int32), capacity
    )
    if record_stats:
        metrics.wire_high_water("wire_bin_occupancy_hwm", max_dst_run(d))
    return s, d


def max_dst_run(dst_sorted: np.ndarray) -> int:
    """Longest equal-dst run of a sorted dst column (the bin-occupancy
    figure of the wire metrics)."""
    n = len(dst_sorted)
    if n == 0:
        return 0
    bounds = np.flatnonzero(np.diff(dst_sorted) != 0)
    edges = np.concatenate([[-1], bounds, [n - 1]])
    return int(np.max(np.diff(edges)))


def _varint_encode_np(vals: np.ndarray) -> np.ndarray:
    """Values -> group-varint bytes: a control block of 2-bit lengths, then
    the little-endian value bytes."""
    vals = np.asarray(vals, np.uint64)
    count = len(vals)
    ctrl = (count + 3) // 4
    lens = np.ones(count, np.int64)
    for k in (8, 16, 24):
        lens += vals >= (np.uint64(1) << np.uint64(k))
    ends = np.cumsum(lens)
    out = np.zeros(ctrl + (int(ends[-1]) if count else 0), np.uint8)
    k = np.arange(count)
    np.bitwise_or.at(out, k >> 2, ((lens - 1) << (2 * (k & 3))).astype(np.uint8))
    starts = ctrl + ends - lens
    for j in range(4):
        sel = lens > j
        if not sel.any():
            break
        out[starts[sel] + j] = ((vals[sel] >> np.uint64(8 * j)) & np.uint64(0xFF)).astype(np.uint8)
    return out


def _varint_decode_np(buf: np.ndarray, count: int) -> np.ndarray:
    """Host twin of ``ops.wire_decode.decode_varints``; refuses a buffer
    shorter than its control block + payload."""
    b = np.asarray(buf, np.uint8).astype(np.int64)
    ctrl = (count + 3) // 4
    nb = len(b)
    if nb < ctrl:
        raise ValueError(
            f"BDV buffer truncated: {count} varints need a {ctrl}-byte "
            f"control block, got {nb} bytes total"
        )
    k = np.arange(count)
    lens = ((b[k >> 2] >> (2 * (k & 3))) & 3) + 1 if count else np.zeros(0, np.int64)
    needed = ctrl + (int(lens.sum()) if count else 0)
    if nb < needed:
        raise ValueError(f"BDV buffer truncated: control block declares {needed} bytes, got {nb}")
    starts = ctrl + np.cumsum(lens) - lens
    vals = np.zeros(count, np.int64)
    for j in range(4):
        idx = np.minimum(starts + j, nb - 1)
        vals |= np.where(lens > j, b[idx] << (8 * j), 0)
    return vals


def _zigzag_encode_np(v: np.ndarray) -> np.ndarray:
    v = np.asarray(v, np.int64)
    return np.asarray((v << 1) ^ (v >> 63), np.uint64)


def _encode_bdv_np(src_s, dst_s, val_i32=None) -> np.ndarray:
    """Varint-encode a dst-sorted batch: unsigned dst deltas interleaved
    with global zigzag src deltas (src[-1] = 0), so the decode is a pair
    of cumsums."""
    n = len(src_s)
    per = 2 if val_i32 is None else 3
    s = np.asarray(src_s, np.int64)
    d = np.asarray(dst_s, np.int64)
    d_delta = np.empty(n, np.int64)
    s_delta = np.empty(n, np.int64)
    if n:
        d_delta[0] = d[0]
        d_delta[1:] = np.diff(d)
        s_delta[0] = s[0]
        s_delta[1:] = np.diff(s)
    stream = np.empty(per * n, np.uint64)
    stream[0::per] = d_delta.astype(np.uint64)
    stream[1::per] = _zigzag_encode_np(s_delta) & np.uint64(0xFFFFFFFF)
    if val_i32 is not None:
        stream[2::per] = _zigzag_encode_np(np.asarray(val_i32, np.int64))
    return _varint_encode_np(stream)


def bdv_bucket_nbytes(payload_nbytes: int) -> int:
    """Shape bucket for a BDV payload: the next size of form {4,5,6,7}<<k."""
    n = max(int(payload_nbytes), 4)
    k = max((n - 1).bit_length() - 3, 0)
    return -(-n >> k) << k


def pack_edges_bdv(
    src: np.ndarray,
    dst: np.ndarray,
    capacity: int,
    val_i32: Optional[np.ndarray] = None,
    sort: bool = True,
    record_stats: bool = False,
) -> np.ndarray:
    """Bin (sort by (dst, src) unless ``sort=False``), varint-encode (the
    native encoder on the value-less path when the library is loaded, else
    numpy; the same bytes) and zero-pad to the byte bucket, clamped at the
    worst-case bound.  ``record_stats`` raises the bin-occupancy
    high-water."""
    if capacity <= 0 or capacity > (1 << BDV_MAX_ID_BITS):
        raise ValueError(f"BDV needs 0 < capacity <= 2^{BDV_MAX_ID_BITS} (got {capacity})")
    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    if dst.shape[0] != src.shape[0]:
        raise ValueError("src/dst length mismatch")
    if sort:
        src, dst, val_i32 = _sort_edges_bdv(src, dst, capacity, val_i32)
    if record_stats:
        metrics.wire_high_water("wire_bin_occupancy_hwm", max_dst_run(dst))
    payload = None
    if val_i32 is None:
        lib = native.load_ingest_lib()
        if lib is not None:
            n = src.shape[0]
            out = np.empty(bdv_max_nbytes(n) + 8, np.uint8)
            wrote = lib.encode_edges_bdv(src.ctypes.data, dst.ctypes.data, n, out.ctypes.data, out.nbytes)
            if wrote >= 0:
                payload = out[:wrote]
    if payload is None:
        payload = _encode_bdv_np(src, dst, val_i32)
    bucket = min(
        bdv_bucket_nbytes(len(payload)), bdv_max_nbytes(src.shape[0], val_i32 is not None)
    )
    buf = np.zeros(bucket, np.uint8)
    buf[: len(payload)] = payload
    return buf


def unpack_edges_bdv_host(buf: np.ndarray, n: int, valued: bool = False):
    """Host (numpy) BDV decode -> (src, dst[, val]) int32[n] in the packed
    (dst, src)-sorted order."""
    per = 3 if valued else 2
    vals = _varint_decode_np(np.asarray(buf, np.uint8), per * n)
    dst = np.cumsum(vals[0::per]).astype(np.int32)
    s_enc = vals[1::per].astype(np.uint64)
    s_delta = ((s_enc >> np.uint64(1)).astype(np.int64)) ^ -(s_enc & np.uint64(1)).astype(np.int64)
    src = np.cumsum(s_delta).astype(np.int32)
    if not valued:
        return src, dst
    z = vals[2::per].astype(np.uint64)
    val = ((z >> np.uint64(1)).astype(np.int64)) ^ -(z & np.uint64(1)).astype(np.int64)
    return src, dst, val.astype(np.int32)


# ---------------------------------------------------------------------------
# one-pass validate + decode (+ bin) of a wire buffer on the host

# decode_wire_into's native width codes: fixed byte widths pass through,
# PAIR40 is 5 and BDV 6 (EF40 has no native decode)
_NATIVE_DECODE_CODES = {2: 2, 3: 3, 4: 4, PAIR40: 5}


def decode_wire_np(buf, n: int, width, capacity: int, sort: bool = False):
    """Numpy twin of ``decode_wire_into``: ``core/stream.
    validate_wire_buffer``'s guards (size bounds, host decode, both ends of
    the id range), then the optional (dst, src) binning.  Its typed
    ``ValueError``s are the refusals, whichever implementation ran."""
    from gelly_streaming_tpu_torch.core.stream import validate_wire_buffer

    s, d = validate_wire_buffer(buf, n, width, capacity, decode_ids=True)
    if sort:
        s, d = sort_edges_binned(s, d, capacity)
    return s, d


def decode_wire_into(buf, n: int, width, capacity: int, out_src: np.ndarray, out_dst: np.ndarray,
                     sort: bool = False) -> bool:
    """Native one-pass validate + decode (+ bin) of one wire buffer into
    ``out_src``/``out_dst`` (contiguous int32[n]), the GIL released for the
    whole call.  True when the native path ran and the buffer is valid;
    False when it cannot run (no library, an encoding it lacks, odd
    layouts, an internal fallback): the caller then runs
    ``decode_wire_np``.  A refused buffer raises the twin's own
    ``ValueError``."""
    code = 6 if (isinstance(width, tuple) and width[0] == BDV) else _NATIVE_DECODE_CODES.get(width)
    lib = native.load_ingest_lib()
    if code is None or lib is None:
        return False
    b = np.asarray(buf)
    if (
        b.dtype != np.uint8
        or not b.flags.c_contiguous
        or out_src.dtype != np.int32
        or out_dst.dtype != np.int32
        or out_src.shape != (n,)
        or out_dst.shape != (n,)
        or not out_src.flags.c_contiguous
        or not out_dst.flags.c_contiguous
    ):
        return False
    rc = lib.decode_wire_into(b.ctypes.data, b.nbytes, n, code, capacity, 1 if sort else 0, out_src.ctypes.data,
                              out_dst.ctypes.data)
    if rc == n:
        return True
    if rc == -4:
        return False  # internal (allocation, sort bounds): the twin serves it
    # a refusal: the twin raises the canonical error for this buffer
    decode_wire_np(buf, n, width, capacity, sort=sort)
    raise RuntimeError(f"native decode refused (rc={rc}) a buffer the numpy twin accepts")


# ---------------------------------------------------------------------------
# decoders


def unpack_edges(wire: torch.Tensor, n: int, width):
    """Device unpack: wire uint8 tensor -> (src, dst) int32[n] tensors on
    the same device."""
    if isinstance(width, tuple):
        if width[0] == BDV:
            return wire_decode.decode_bdv(wire, n)
        return wire_decode.unpack_edges_ef40(wire, n, width[1])
    if width in (3, PAIR40):
        return wire_decode.unpack_edges_fixed(wire, n, width)
    return wire_decode.unpack_edges_fixed_plain(wire, n, width)


def unpack_edges_host(buf: np.ndarray, n: int, width):
    """Host (numpy) decode of one wire buffer -> (src, dst) int32[n]; EF40
    decodes to src-grouped order, BDV to (dst, src)-sorted order."""
    buf = np.asarray(buf, np.uint8)
    if isinstance(width, tuple) and width[0] == BDV:
        return unpack_edges_bdv_host(buf, n)
    if isinstance(width, tuple):
        capacity = width[1]
        bvbytes = (n + capacity + 7) // 8
        bits = np.unpackbits(buf[:bvbytes], bitorder="little")[: n + capacity]
        src = (np.flatnonzero(bits) - np.arange(n, dtype=np.int64)).astype(np.int32)
        npairs = (n + 1) // 2
        lo, hi = _pair40_fields(buf[bvbytes : bvbytes + 5 * npairs].reshape(npairs, 5).astype(np.int64))
        dst = np.stack([lo, hi], axis=1).reshape(-1)[:n]
        return src, dst.astype(np.int32)
    if width == PAIR40:
        lo, hi = _pair40_fields(buf[: 5 * n].reshape(n, 5).astype(np.int64))
        return lo.astype(np.int32), hi.astype(np.int32)
    b = buf[: 2 * n * width].reshape(2, n, width).astype(np.int64)
    v = b[..., 0]
    for k in range(1, width):
        v = v | (b[..., k] << (8 * k))
    v = v.astype(np.uint32).view(np.int32)
    return v[0], v[1]


# ---------------------------------------------------------------------------
# emission plane (device -> host): a property-trace record (vertex id,
# running value) packs on the device into 48 bits plus one mask bit, against
# 9 B a row for raw int32 columns and a bool mask


def pack_records48(ids: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """(ids < 2^20, vals clipped to [0, 2^28 - 1]) -> uint8[6n], little
    endian: lo = id | (val & 0xFFF) << 20, then hi = val >> 12 (16 bits)."""
    ids_u = ids.to(torch.int64) & 0xFFFFFFFF
    vals_u = torch.clamp(vals.to(torch.int64), 0, (1 << 28) - 1)
    lo = (ids_u | ((vals_u & 0xFFF) << 20)) & 0xFFFFFFFF
    hi = vals_u >> 12
    shifts4 = torch.arange(4, device=ids.device) * 8
    shifts2 = torch.arange(2, device=ids.device) * 8
    b_lo = ((lo[:, None] >> shifts4) & 0xFF).to(torch.uint8)
    b_hi = ((hi[:, None] >> shifts2) & 0xFF).to(torch.uint8)
    return torch.cat([b_lo, b_hi], dim=1).reshape(-1)


def pack_mask_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool[n] -> uint8[ceil(n/8)], little-endian bit order."""
    pad = (-mask.shape[0]) % 8
    m = torch.cat([mask, mask.new_zeros((pad,))]) if pad else mask
    weights = 1 << torch.arange(8, dtype=torch.int32, device=mask.device)
    return (m.reshape(-1, 8).to(torch.int32) * weights).sum(dim=1).to(torch.uint8)


def unpack_records48(packed: np.ndarray, maskbits: np.ndarray, n: int):
    """Host decode: (uint8[6n], uint8[ceil(n/8)]) -> (ids, vals, mask),
    int64 ids and values and a bool mask.  Each record is read as three
    little-endian 16-bit words (4.7x faster than widening every byte)."""
    w = np.ascontiguousarray(packed, np.uint8).view("<u2").reshape(n, 3)
    lo = w[:, 0].astype(np.uint32) | (w[:, 1].astype(np.uint32) << 16)
    ids = (lo & 0xFFFFF).astype(np.int64)
    vals = ((lo >> 20) | (w[:, 2].astype(np.uint32) << 12)).astype(np.int64)
    bits = np.unpackbits(np.asarray(maskbits, np.uint8), bitorder="little")[:n]
    return ids, vals, bits.astype(bool)
