"""Device-side wire decodes: the wrappers of ``csrc/wire_decode.cu`` and
their plain PyTorch twins.

BDV, port of ``gelly_streaming_tpu/ops/wire_decode.py``.  BDV (io/wire.py)
ships a dst-sorted edge batch as one interleaved group-varint stream: per
edge an unsigned dst delta, then a zigzag GLOBAL src delta (src[-1] = 0),
then for valued batches a zigzag value.  A control block of 2-bit byte
lengths (four values per control byte) heads the buffer; the value bytes
follow, little-endian; buckets pad with 0x00.  A byte read at or past the
buffer's end reads its last byte, as the JAX decode's clipped gathers do.
On CUDA tensors ``decode_bdv`` is one C call (``bdv_decode_launch``): one
cooperative launch, the chunks chained by two grid-wide reductions (byte
offsets, then the delta sums).  On CPU tensors it runs
``decode_bdv_plain``: gathers and cumsums, values carried in int64 and the
id columns wrapped to int32 at the end, as the JAX decode's int32 cumsums
wrap.

EF40, port of ``unpack_edges_ef40`` (``gelly_streaming_tpu/io/wire.py``):
a unary src histogram of n + C bits, then the dsts' 20-bit pairs.  On CUDA
tensors ``unpack_edges_ef40`` is one C call (``ef40_unpack_launch``: one
cooperative launch, the ones counted and the pairs decoded, a grid-wide
sync, the ranks scanned and written); on CPU tensors it runs
``unpack_edges_ef40_plain``.

The fixed widths, port of ``unpack_edges`` and ``_unpack_edges40``
(``gelly_streaming_tpu/io/wire.py``): at width 3 and PAIR40
``unpack_edges_fixed`` is one C call on CUDA tensors
(``wire_unpack_launch``: a block stages a tile's bytes in shared memory by
16-byte loads and writes 16-byte runs of src and dst); on CPU tensors it
runs ``unpack_edges_fixed_plain``, widening PyTorch ops, which
``io/wire.unpack_edges`` also runs for widths 2 and 4 on any device.
"""

from __future__ import annotations

from typing import Dict

import torch

from gelly_streaming_tpu_torch.ops import _cuda

_SOURCE = "wire_decode.cu"

# C calls since the last reset_launches() (CUDA tensors only), and the
# wrapper's twin calls (CPU tensors only)
LAUNCHES: Dict[str, int] = {"bdv_decode": 0, "ef40_unpack": 0, "wire_unpack": 0}
TWIN_CALLS: Dict[str, int] = {"bdv_decode": 0, "ef40_unpack": 0, "wire_unpack": 0}

PAIR40 = "pair40"  # io/wire.PAIR40: 5-byte (src, dst) pairs for capacities <= 2^20
_scratch: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


def decode_varints(buf: torch.Tensor, count: int) -> torch.Tensor:
    """uint8[cap] group-varint stream -> int64[count] values (< 2^32).

    Bytes past the encoded payload are never asked for; an all-zero buffer
    decodes to zeros."""
    b = buf.to(torch.int64)
    nb = b.shape[0]
    ctrl = (count + 3) // 4
    k = torch.arange(count, dtype=torch.int64, device=buf.device)
    lens = ((b[torch.clamp(k >> 2, max=nb - 1)] >> (2 * (k & 3))) & 3) + 1
    starts = ctrl + torch.cumsum(lens, 0) - lens
    val = torch.zeros((count,), dtype=torch.int64, device=buf.device)
    for j in range(4):
        byte = b[torch.clamp(starts + j, max=nb - 1)]
        val |= torch.where(lens > j, byte << (8 * j), 0)
    return val


def _unzigzag(z: torch.Tensor) -> torch.Tensor:
    """zigzag value (< 2^32, in int64) -> signed value."""
    return (z >> 1) ^ -(z & 1)


def _int32(x: torch.Tensor) -> torch.Tensor:
    """Wrap int64 values to int32 modulo 2^32, as int32 arithmetic would."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def decode_bdv_plain(buf: torch.Tensor, n: int, valued: bool = False):
    """The twin: BDV wire buffer -> (src, dst[, val]) int32[n] in dst-sorted
    order, by PyTorch ops on the buffer's device."""
    per = 3 if valued else 2
    vals = decode_varints(buf, per * n)
    dst = _int32(torch.cumsum(vals[0::per], 0))
    src = _int32(torch.cumsum(_unzigzag(vals[1::per]), 0))
    if not valued:
        return src, dst
    return src, dst, _int32(_unzigzag(vals[2::per]))


def _scratch_for(dev: torch.device, stream: int, nbytes: int) -> torch.Tensor:
    """A reused scratch buffer of at least ``nbytes`` for calls on one
    stream, which run in order; a call writes every slot it reads."""
    buf = _scratch.get((dev, stream))
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty((max(nbytes, 1 << 16),), dtype=torch.uint8, device=dev)
        _scratch[(dev, stream)] = buf
    return buf


def decode_bdv(buf: torch.Tensor, n: int, valued: bool = False):
    """BDV wire buffer (uint8[nb], 1-D) -> (src, dst[, val]) int32[n] in
    dst-sorted order, on the buffer's device."""
    if buf.dim() != 1 or buf.dtype != torch.uint8:
        raise ValueError("a BDV buffer is a 1-D uint8 tensor")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if n and buf.shape[0] == 0:
        raise ValueError(f"an empty BDV buffer cannot hold {n} edges")
    if buf.device.type == "cpu":
        TWIN_CALLS["bdv_decode"] += 1
        return decode_bdv_plain(buf, n, valued)
    if buf.device.type != "cuda":
        raise ValueError(f"decode_bdv runs on CUDA or CPU tensors, not {buf.device.type}")
    dev = buf.device
    outs = [torch.empty((n,), dtype=torch.int32, device=dev) for _ in range(3 if valued else 2)]
    if n == 0:
        return tuple(outs)
    src, dst = outs[0], outs[1]
    val = outs[2] if valued else None
    lib = _cuda.library(_SOURCE)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch_for(dev, stream, int(lib.bdv_decode_scratch_bytes(n)))
    b = buf.contiguous()
    err = lib.bdv_decode_launch(
        b.data_ptr(), b.shape[0], n, 1 if valued else 0, src.data_ptr(), dst.data_ptr(),
        None if val is None else val.data_ptr(), scratch.data_ptr(), scratch.numel(), stream,
    )
    _cuda.check(err, "bdv_decode_launch")
    LAUNCHES["bdv_decode"] += 1
    return tuple(outs)


def ef40_nbytes(n: int, capacity: int) -> int:
    """Wire bytes of an EF40 batch of n edges over ``capacity`` ids."""
    return (n + capacity + 7) // 8 + ((n + 1) // 2) * 5


def pair40_fields(b):
    """(lo 20 bits, hi 20 bits) of [m, 5] pair bytes, widened to int64
    (numpy or torch)."""
    lo = (b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)) & 0xFFFFF
    hi = (b[:, 2] >> 4) | (b[:, 3] << 4) | (b[:, 4] << 12)
    return lo, hi


def unpack_edges_ef40_plain(wire: torch.Tensor, n: int, capacity: int):
    """The twin: EF40 wire uint8 -> src-grouped (src, dst) int32[n], by
    PyTorch ops on the buffer's device.

    Bit expansion and one cumsum recover the unary src ranks: the grouped
    src of rank i is ``pos - i``, pos the position of the i-th one, found
    by binary search in the cumsum (ranks the bitvector lacks decode to 0,
    as the JAX scatter leaves them).  The JAX decode scatters every
    position instead, the zeros into one dropped slot: on the H100 those
    ~C atomics on one address serialize, and with them the bench's 50
    batches took 1.74 s end to end against 0.11 s with the search
    (chip_smoke.py phase 7)."""
    dev = wire.device
    bvbytes = (n + capacity + 7) // 8
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    bits = ((wire[:bvbytes].to(torch.int32)[:, None] >> shifts) & 1).reshape(-1)[: n + capacity]
    ones_upto = torch.cumsum(bits, 0)  # int64, non-decreasing
    rank = torch.arange(n, dtype=torch.int64, device=dev)
    pos = torch.searchsorted(ones_upto, rank + 1)
    src = torch.where(pos < n + capacity, pos - rank, 0).to(torch.int32)
    npairs = (n + 1) // 2
    b = wire[bvbytes : bvbytes + 5 * npairs].reshape(npairs, 5).to(torch.int64)
    lo, hi = pair40_fields(b)
    dst = torch.stack([lo, hi], dim=1).reshape(-1)[:n].to(torch.int32)
    return src, dst


def unpack_edges_ef40(wire: torch.Tensor, n: int, capacity: int):
    """EF40 wire buffer (uint8, 1-D) -> src-grouped (src, dst) int32[n], on
    the buffer's device."""
    if wire.dim() != 1 or wire.dtype != torch.uint8:
        raise ValueError("an EF40 buffer is a 1-D uint8 tensor")
    if n < 0 or capacity < 0:
        raise ValueError(f"n and capacity must be >= 0, got {n}, {capacity}")
    if wire.device.type == "cpu":
        TWIN_CALLS["ef40_unpack"] += 1
        return unpack_edges_ef40_plain(wire, n, capacity)
    if wire.device.type != "cuda":
        raise ValueError(f"unpack_edges_ef40 runs on CUDA or CPU tensors, not {wire.device.type}")
    if wire.shape[0] < ef40_nbytes(n, capacity):
        raise ValueError(f"an EF40 buffer of {n} edges over {capacity} ids holds {ef40_nbytes(n, capacity)} bytes, "
                         f"got {wire.shape[0]}")
    dev = wire.device
    src = torch.empty((n,), dtype=torch.int32, device=dev)
    dst = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return src, dst
    lib = _cuda.library(_SOURCE)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _scratch_for(dev, stream, int(lib.ef40_unpack_scratch_bytes(n, capacity)))
    b = wire.contiguous()
    err = lib.ef40_unpack_launch(b.data_ptr(), b.shape[0], n, capacity, src.data_ptr(), dst.data_ptr(),
                                 scratch.data_ptr(), scratch.numel(), stream)
    _cuda.check(err, "ef40_unpack_launch")
    LAUNCHES["ef40_unpack"] += 1
    return src, dst


# ---------------------------------------------------------------------------
# the fixed widths


def fixed_nbytes(n: int, width) -> int:
    """Wire bytes of n edges at a fixed width (2, 3, 4 or PAIR40)."""
    return 5 * n if width == PAIR40 else 2 * n * width


def unpack_edges_fixed_plain(wire: torch.Tensor, n: int, width):
    """The twin: fixed-width wire uint8 -> (src, dst) int32[n], by PyTorch
    ops on the buffer's device (the buffer widened to int64, then shifts
    and ORs)."""
    if width == PAIR40:
        lo, hi = pair40_fields(wire[: 5 * n].reshape(n, 5).to(torch.int64))
        return lo.to(torch.int32), hi.to(torch.int32)
    b = wire[: 2 * n * width].reshape(2, n, width).to(torch.int64)
    v = b[..., 0]
    for k in range(1, width):
        v = v | (b[..., k] << (8 * k))
    v = v.to(torch.int32)
    return v[0], v[1]


def unpack_edges_fixed(wire: torch.Tensor, n: int, width):
    """Width-3 or PAIR40 wire buffer (uint8, 1-D, any byte offset) ->
    (src, dst) int32[n], on the buffer's device."""
    if width not in (3, PAIR40):
        raise ValueError(f"unpack_edges_fixed takes width 3 or PAIR40, not {width!r}")
    if wire.dim() != 1 or wire.dtype != torch.uint8:
        raise ValueError("a wire buffer is a 1-D uint8 tensor")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    need = fixed_nbytes(n, width)
    if wire.shape[0] < need:
        raise ValueError(f"a wire buffer of {n} edges at width {width} holds {need} bytes, got {wire.shape[0]}")
    if wire.device.type == "cpu":
        TWIN_CALLS["wire_unpack"] += 1
        return unpack_edges_fixed_plain(wire, n, width)
    if wire.device.type != "cuda":
        raise ValueError(f"unpack_edges_fixed runs on CUDA or CPU tensors, not {wire.device.type}")
    dev = wire.device
    src = torch.empty((n,), dtype=torch.int32, device=dev)
    dst = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return src, dst
    lib = _cuda.library(_SOURCE)
    b = wire.contiguous()
    err = lib.wire_unpack_launch(b.data_ptr(), b.shape[0], n, 5 if width == PAIR40 else 3, src.data_ptr(),
                                 dst.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "wire_unpack_launch")
    LAUNCHES["wire_unpack"] += 1
    return src, dst
