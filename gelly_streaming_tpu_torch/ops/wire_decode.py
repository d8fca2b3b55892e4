"""Device-side decode of the BDV compressed wire format, in PyTorch.

Port of ``gelly_streaming_tpu/ops/wire_decode.py``.  BDV (io/wire.py)
ships a dst-sorted edge batch as one interleaved group-varint stream: per
edge an unsigned dst delta, then a zigzag GLOBAL src delta (src[-1] = 0),
then for valued batches a zigzag value.  A control block of 2-bit byte
lengths (four values per control byte) heads the buffer; the value bytes
follow, little-endian; buckets pad with 0x00.

The decode is gathers and cumsums on the buffer's device: lengths from the
control block, starts by an exclusive cumsum, four clipped byte gathers,
then a cumsum of each delta stream.  Values are carried in int64 and the
id columns wrap to int32 at the end, as the JAX decode's int32 cumsums do.
"""

from __future__ import annotations

import torch


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


def decode_bdv(buf: torch.Tensor, n: int, valued: bool = False):
    """BDV wire buffer -> (src, dst[, val]) int32[n] in dst-sorted order."""
    per = 3 if valued else 2
    vals = decode_varints(buf, per * n)
    dst = _int32(torch.cumsum(vals[0::per], 0))
    src = _int32(torch.cumsum(_unzigzag(vals[1::per]), 0))
    if not valued:
        return src, dst
    return src, dst, _int32(_unzigzag(vals[2::per]))
