"""Dense pane triangle counting: the wrappers of the port's two CUDA kernels.

Port of ``gelly_streaming_tpu/ops/pallas_triangles.py``.  For a pane's
undirected simple adjacency A (zero diagonal),

    triangles = sum(A * (A @ A)) / 6

since (A @ A)[u, v] counts common neighbors of u and v and each triangle
is seen once per ordered adjacent pair.  A pane ships in the same 4 B/edge
packed words as the JAX package (``pack_pane``: ``u | v << 14``), and the
device does the rest in two kernels (``csrc/pane_triangles.cu``):

* ``pane_adjacency``: packed words -> symmetric bitset adjacency, K/32
  int32 words per row (replaces ``_count_from_packed``/``_adjacency_count``);
* ``dense_triangles``: bitset -> one int64 total ``sum(A * (A @ A))``
  (replaces the Pallas ``_kernel``/``_count_halves``).

``pane_triangles`` runs both in one C call; the main path uses it.

Each kernel has a plain PyTorch twin here (``*_plain``).  A wrapper runs
the twin only for tensors that lie on the CPU; for CUDA tensors it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.
Bitset words are stored as int32 and read by the kernels as uint32 (bit
31 is an ordinary adjacency bit).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.io.prefetch import upload
from gelly_streaming_tpu_torch.ops import _cuda

TILE = 128  # K granularity, kept from the TPU kernel's tile edge
MAX_K = 1 << 14  # exactness/id bound: ids pack into 14 bits
_ID_BITS = 14
_SOURCE = "pane_triangles.cu"

# kernel launches since the last reset_launches() (only real launches on
# CUDA tensors count, never the plain twins)
LAUNCHES: Dict[str, int] = {"pane_adjacency": 0, "dense_triangles": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_k(k: int) -> None:
    if k > MAX_K:
        raise ValueError(f"K={k} exceeds the kernel's exactness bound {MAX_K}")


def pane_k(num_vertices: int) -> int:
    """Padded adjacency size K for a pane of ``num_vertices`` ids."""
    k = max(TILE, ((num_vertices + TILE - 1) // TILE) * TILE)
    _check_k(k)
    return k


# ---------------------------------------------------------------------------
# host-side pane packing


def pack_pane(u: np.ndarray, v: np.ndarray, mask=None):
    """Host-side pane pack: (u, v) -> (uint32[cap] edge words, n) at 4
    B/edge, capacity padded to the next power of two.  Masked-out edges are
    dropped.  Byte-identical to the JAX package's ``pack_pane``."""
    if mask is not None:
        u, v = np.asarray(u)[mask], np.asarray(v)[mask]
    n = len(u)
    if n:
        u = np.asarray(u)
        v = np.asarray(v)
        # u packs into the low _ID_BITS; a larger id would bleed into v's
        # bits (corrupted edges, no error), so refuse it loudly
        if int(min(u.min(), v.min())) < 0 or int(max(u.max(), v.max())) >= (
            1 << _ID_BITS
        ):
            raise ValueError(
                f"pack_pane ids must be in [0, 2^{_ID_BITS}); got "
                f"[{int(min(u.min(), v.min()))}, "
                f"{int(max(u.max(), v.max()))}]"
            )
    n_cap = max(1, 1 << (n - 1).bit_length()) if n else 1
    w = np.zeros((n_cap,), np.uint32)
    w[:n] = u.astype(np.uint32) | (v.astype(np.uint32) << _ID_BITS)
    return w, np.int32(n)


def packed_host_arrays(w: np.ndarray, n) -> tuple:
    """``pack_pane``'s output as the (int32 words, int32[1] count) host
    arrays the kernels take: the words reinterpreted, not converted."""
    return w.view(np.int32), np.array([n], np.int32)


# ---------------------------------------------------------------------------
# bitset helpers (plain PyTorch)

_BIT_WEIGHTS = [1 << b for b in range(32)]


def pack_bits(adj: torch.Tensor) -> torch.Tensor:
    """bool [K, K] -> int32 [K, K/32]: bit b of word w of row i is
    adj[i, 32*w + b]."""
    k = adj.shape[0]
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=adj.device)
    words = (adj.reshape(k, k // 32, 32).to(torch.int64) * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_bits(bits: torch.Tensor) -> torch.Tensor:
    """int32 [K, K/32] -> bool [K, K] (inverse of pack_bits)."""
    k = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = bits.to(torch.int64) & 0xFFFFFFFF
    return ((words[..., None] >> shifts) & 1).bool().reshape(k, k)


# ---------------------------------------------------------------------------
# kernel 1: pane_adjacency


def pane_adjacency_plain(words: torch.Tensor, n: torch.Tensor, k: int) -> torch.Tensor:
    """Plain twin of ``pane_adjacency``: scatter into a bool [K, K] and
    pack the bits.  Words past ``n``, self-loops and ids >= k are dropped."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    u = w & ((1 << _ID_BITS) - 1)
    v = w >> _ID_BITS
    live = torch.arange(w.shape[0], device=w.device) < n.to(torch.int64)[0]
    ok = live & (u != v) & (u < k) & (v < k)
    adj = torch.zeros((k, k), dtype=torch.bool, device=w.device)
    adj[u[ok], v[ok]] = True
    adj[v[ok], u[ok]] = True
    return pack_bits(adj)


def _check_adjacency_args(words: torch.Tensor, n: torch.Tensor, k: int) -> None:
    if words.dtype != torch.int32 or words.dim() != 1 or not words.is_contiguous():
        raise ValueError("words must be a contiguous 1-D int32 tensor")
    if n.dtype != torch.int32 or n.shape != (1,):
        raise ValueError("n must be an int32 tensor of shape [1]")
    if n.device != words.device:
        raise ValueError("words and n must be on the same device")
    if k <= 0 or k % 32 or k > MAX_K:
        raise ValueError(f"k must be a positive multiple of 32 <= {MAX_K}, got {k}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {t.device}")


@_cuda.on_device_of("words")
def pane_adjacency(words: torch.Tensor, n: torch.Tensor, k: int) -> torch.Tensor:
    """Packed pane words -> int32 [k, k/32] symmetric bitset adjacency.

    ``words``: int32 [cap] (the uint32 words of ``pack_pane``), ``n``:
    int32 [1] live word count, on the same device."""
    _check_adjacency_args(words, n, k)
    if words.device.type == "cpu":
        return pane_adjacency_plain(words, n, k)
    _check_cuda(words, "pane_adjacency")
    lib = _cuda.library(_SOURCE)
    bits = torch.empty((k, k // 32), dtype=torch.int32, device=words.device)
    err = lib.pane_adjacency_launch(
        words.data_ptr(), n.data_ptr(), words.shape[0], bits.data_ptr(), k, _stream(words)
    )
    _cuda.check(err, "pane_adjacency")
    LAUNCHES["pane_adjacency"] += 1
    return bits


# ---------------------------------------------------------------------------
# kernel 2: dense_triangles


def dense_triangles_plain(bits: torch.Tensor) -> torch.Tensor:
    """Plain twin of ``dense_triangles``: unpack to float64 and compute
    sum(A * (A @ A)), exact below 2^53 (the total is <= K^3 = 2^42)."""
    a = unpack_bits(bits).to(torch.float64)
    return (a @ a * a).sum().to(torch.int64).reshape(1)


@_cuda.on_device_of("bits")
def dense_triangles(bits: torch.Tensor) -> torch.Tensor:
    """int32 [K, K/32] bitset of a symmetric zero-diagonal adjacency ->
    int64 [1] total sum(A * (A @ A)) (six times the triangle count)."""
    k = bits.shape[0]
    if (
        bits.dtype != torch.int32
        or bits.dim() != 2
        or bits.shape[1] * 32 != k
        or not bits.is_contiguous()
    ):
        raise ValueError("bits must be a contiguous int32 [K, K/32] tensor")
    if k % 32 or k > MAX_K:
        raise ValueError(f"K must be a multiple of 32 <= {MAX_K}, got {k}")
    if bits.device.type == "cpu":
        return dense_triangles_plain(bits)
    _check_cuda(bits, "dense_triangles")
    lib = _cuda.library(_SOURCE)
    total = torch.empty((1,), dtype=torch.int64, device=bits.device)
    err = lib.dense_triangles_launch(bits.data_ptr(), k, total.data_ptr(), _stream(bits))
    _cuda.check(err, "dense_triangles")
    LAUNCHES["dense_triangles"] += 1
    return total


@_cuda.on_device_of("words")
def pane_triangles(words: torch.Tensor, n: torch.Tensor, k: int) -> torch.Tensor:
    """``dense_triangles(pane_adjacency(words, n, k))``: on CUDA one C call
    enqueues both kernels (and the clears of their outputs)."""
    _check_adjacency_args(words, n, k)
    if words.device.type == "cpu":
        return dense_triangles_plain(pane_adjacency_plain(words, n, k))
    _check_cuda(words, "pane_triangles")
    lib = _cuda.library(_SOURCE)
    bits = torch.empty((k, k // 32), dtype=torch.int32, device=words.device)
    total = torch.empty((1,), dtype=torch.int64, device=words.device)
    err = lib.pane_triangles_launch(
        words.data_ptr(), n.data_ptr(), words.shape[0], bits.data_ptr(), k,
        total.data_ptr(), _stream(words),
    )
    _cuda.check(err, "pane_triangles")
    LAUNCHES["pane_adjacency"] += 1
    LAUNCHES["dense_triangles"] += 1
    return total


# ---------------------------------------------------------------------------
# pane counts: submit without waiting, fetch later


class PendingCount(NamedTuple):
    """A device count on its way to the host: ``value`` is the int64 [1]
    host tensor that receives it (pinned, filled by a non-blocking copy on
    CUDA) and ``done`` the event recorded after that copy (None on CPU)."""

    value: torch.Tensor
    done: Optional["torch.cuda.Event"]


def start_readback(t: torch.Tensor) -> PendingCount:
    """Queue the copy of a one-element device count to the host."""
    t = t.reshape(1).to(torch.int64)
    if t.device.type == "cpu":
        return PendingCount(t, None)
    host = torch.empty((1,), dtype=torch.int64, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(t.device))
    return PendingCount(host, done)


def wait_device(p: PendingCount) -> None:
    """Block until the device has produced the count and copied it."""
    if p.done is not None:
        p.done.synchronize()


def read_count(p: PendingCount) -> int:
    wait_device(p)
    return int(p.value[0])


def triangle_count_dense(adj: torch.Tensor) -> int:
    """Exact triangle count of a dense 0/1 adjacency tensor (zero diagonal),
    [K, K] with K a multiple of TILE and K <= MAX_K."""
    k = adj.shape[0]
    if tuple(adj.shape) != (k, k) or k % TILE != 0:
        raise ValueError(
            f"adjacency must be square with K % {TILE} == 0, got {tuple(adj.shape)}"
        )
    _check_k(k)
    return read_count(start_readback(dense_triangles(pack_bits(adj != 0)))) // 6


def pane_triangles_submit_packed(w, n, num_vertices: int, device: DeviceLike = None):
    """Dispatch a packed pane without waiting: host arrays from
    ``pack_pane`` (uploaded to ``device``) or device tensors from
    ``packed_host_arrays`` + upload (used where they lie).  Returns a
    ``PendingCount`` of the total; ``triangles_from_total`` turns it into
    the count."""
    k = pane_k(num_vertices)
    if isinstance(w, np.ndarray):
        w, n = upload(packed_host_arrays(w, n), resolve_device(device))
    return start_readback(pane_triangles(w, n, k))


def pane_triangles_submit(
    u: np.ndarray, v: np.ndarray, num_vertices: int, mask=None, device: DeviceLike = None
):
    """Pack, upload and dispatch a pane's dense count without waiting
    (None for an empty pane).  ``u``/``v`` may hold duplicates and both
    orientations; self-loops are dropped; ``num_vertices`` bounds the ids."""
    if len(u) == 0:
        return None
    w, n = pack_pane(u, v, mask)
    return pane_triangles_submit_packed(w, n, num_vertices, device)


def triangles_from_total(pending: Optional[PendingCount]) -> int:
    """Blocking fetch: a submitted pane's total -> triangle count."""
    return 0 if pending is None else read_count(pending) // 6


def pane_triangles_dense(
    u: np.ndarray, v: np.ndarray, num_vertices: int, mask=None, device: DeviceLike = None
) -> int:
    """Synchronous pane count (submit + fetch in one call)."""
    return triangles_from_total(
        pane_triangles_submit(u, v, num_vertices, mask, device)
    )
