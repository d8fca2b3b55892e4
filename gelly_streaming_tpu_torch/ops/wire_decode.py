"""Device-side decode of the BDV compressed wire format: the wrapper of
``csrc/wire_decode.cu`` and its plain PyTorch twin.

Port of ``gelly_streaming_tpu/ops/wire_decode.py``.  BDV (io/wire.py)
ships a dst-sorted edge batch as one interleaved group-varint stream: per
edge an unsigned dst delta, then a zigzag GLOBAL src delta (src[-1] = 0),
then for valued batches a zigzag value.  A control block of 2-bit byte
lengths (four values per control byte) heads the buffer; the value bytes
follow, little-endian; buckets pad with 0x00.  A byte read at or past the
buffer's end reads its last byte, as the JAX decode's clipped gathers do.

On CUDA tensors ``decode_bdv`` is one C call (``bdv_decode_launch``): a
memset of its scratch's header and one kernel, tiles chained by two
decoupled look-backs (byte offsets, then the delta sums).  On CPU tensors
it runs ``decode_bdv_plain``: gathers and cumsums, values carried in int64
and the id columns wrapped to int32 at the end, as the JAX decode's int32
cumsums wrap.
"""

from __future__ import annotations

from typing import Dict

import torch

from gelly_streaming_tpu_torch.ops import _cuda

_SOURCE = "wire_decode.cu"

# C calls since the last reset_launches() (CUDA tensors only), and the
# wrapper's twin calls (CPU tensors only)
LAUNCHES: Dict[str, int] = {"bdv_decode": 0}
TWIN_CALLS: Dict[str, int] = {"bdv_decode": 0}
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
    stream, which run in order; each call zeroes the header it uses."""
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
