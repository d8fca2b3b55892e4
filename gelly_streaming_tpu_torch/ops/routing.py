"""The mesh plane's routing kernels: the wrappers of ``csrc/routing.cu`` and
their plain PyTorch twins.

* ``owner_pack``: port of the compaction in
  ``gelly_streaming_tpu/parallel/routing.py`` (``pack_slab_deltas``,
  ``owner_rank`` + ``_exchange_by_owner``).  Items with an owner in
  [0, S) and a live flag land in ``[S, cap]`` slots by their rank among the
  live items of their owner in input order (JAX's cumsum); the payload is
  ``a`` (default: the block row ``i // S``) and ``b``; empty slots hold the
  fills.  Also returns which items landed (``sent``), where (``slot``, -1
  for none) and each owner's live count before capping, and accumulates
  ``acc`` = (high-water of the counts, rows past cap, live items).
* ``block_delta_fold``: port of ``apply_block_deltas``: S senders'
  ``(row, value)`` buffers fold into a ``[R]`` block by min, max or add;
  ``DELTA_PAD`` rows are empty, out-of-range rows drop (JAX's
  ``mode="drop"`` scatter, a row below -1 counting from the end once).
* ``slab_fold``: ``block = op(block, slab_0, ..., slab_{S-1})`` elementwise
  over S received slabs (the dense slab reconcile and the reductions of
  ``pmin`` / ``pmax`` / ``psum``), adding to ``flag`` where anything
  changed (the kernel adds one a thread block that changed an entry, the
  twin one a call: either way the flag grows exactly when the block
  changed).

All three update their outputs in place on both paths.  On CUDA tensors
each is one C call (``owner_pack_launch``: count, scan, scatter kernels;
``block_delta_fold_launch``; ``slab_fold_launch``) that raises on failure;
on CPU tensors the twin runs.  ``LAUNCHES`` counts the C calls,
``TWIN_CALLS`` the twins' calls.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from gelly_streaming_tpu_torch.ops import _cuda

_SOURCE = "routing.cu"
DELTA_PAD = -1  # an empty slot's row
OPS = {"min": 0, "max": 1, "add": 2}
MAX_SHARDS = 64  # the pointer tables' room (csrc/routing.cu kMaxShards)
MAX_PACK_OWNERS = 1024

LAUNCHES: Dict[str, int] = {"owner_pack": 0, "block_delta_fold": 0, "slab_fold": 0}
TWIN_CALLS: Dict[str, int] = {"owner_pack": 0, "block_delta_fold": 0, "slab_fold": 0}

_scratch: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


class Packed(NamedTuple):
    out_a: torch.Tensor  # int32[S, cap]
    out_b: Optional[torch.Tensor]  # int32[S, cap]
    ok: Optional[torch.Tensor]  # bool[S, cap]: the slot holds an item
    sent: Optional[torch.Tensor]  # bool[n]: the item landed
    slot: Optional[torch.Tensor]  # int32[n]: where (-1: nowhere)
    counts: torch.Tensor  # int32[S]: live items an owner, before capping


def _vector(t: Optional[torch.Tensor], dtypes, name: str, n: Optional[int] = None):
    if t is None:
        return
    if t.dtype not in dtypes or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D tensor of {dtypes}")
    if n is not None and t.shape[0] != n:
        raise ValueError(f"{name} must hold {n} rows, not {t.shape[0]}")


# ---------------------------------------------------------------------------
# plain twins


def owner_pack_plain(live, owner, a, b, s: int, cap: int, fill_a: int = DELTA_PAD, fill_b: int = 0,
                     want_ok: bool = False, want_sent: bool = False, want_slot: bool = False,
                     acc: Optional[torch.Tensor] = None) -> Packed:
    """The twin: JAX's one-hot cumsum rank and capped scatter."""
    n = live.shape[0]
    dev = live.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    o = idx % s if owner is None else owner.to(torch.int64)
    lv = live.bool() & (o >= 0) & (o < s)
    onehot = (o[:, None] == torch.arange(s, dtype=torch.int64, device=dev)[None, :]) & lv[:, None]
    csum = torch.cumsum(onehot.to(torch.int64), 0)
    counts = csum[-1] if n else torch.zeros((s,), dtype=torch.int64, device=dev)
    rank = csum.gather(1, o.clamp(0, s - 1)[:, None]).squeeze(1) - 1 if n else idx
    ok = lv & (rank < cap)
    slot = o * cap + rank
    live_slots = slot[ok]
    out_a = torch.full((s * cap,), fill_a, dtype=torch.int32, device=dev)
    out_a[live_slots] = (idx // s).to(torch.int32)[ok] if a is None else a[ok]
    out_b = None
    if b is not None:
        out_b = torch.full((s * cap,), fill_b, dtype=torch.int32, device=dev)
        out_b[live_slots] = b[ok]
    okbuf = None
    if want_ok:
        okbuf = torch.zeros((s * cap,), dtype=torch.bool, device=dev)
        okbuf[live_slots] = True
    if acc is not None:
        acc[0] = max(int(acc[0]), int(counts.max()) if s else 0)
        acc[1] += int(torch.clamp(counts - cap, min=0).sum())
        acc[2] += int(counts.sum())
    TWIN_CALLS["owner_pack"] += 1
    return Packed(
        out_a.view(s, cap),
        None if out_b is None else out_b.view(s, cap),
        None if okbuf is None else okbuf.view(s, cap),
        ok if want_sent else None,
        torch.where(ok, slot, -1).to(torch.int32) if want_slot else None,
        counts.to(torch.int32),
    )


def block_delta_fold_plain(block: torch.Tensor, rows: Sequence[torch.Tensor], vals: Sequence[torch.Tensor],
                           op: str) -> torch.Tensor:
    """The twin: JAX's masked scatter with ``mode="drop"``, in place."""
    r = block.shape[0]
    ri = torch.cat([t.reshape(-1) for t in rows]).to(torch.int64)
    rv = torch.cat([t.reshape(-1) for t in vals])
    idx = torch.where(ri != DELTA_PAD, ri, r)
    idx = torch.where(idx < 0, idx + r, idx)
    keep = (idx >= 0) & (idx < r)
    reduce = {"min": "amin", "max": "amax", "add": "sum"}[op]
    block.scatter_reduce_(0, idx[keep], rv[keep], reduce, include_self=True)
    TWIN_CALLS["block_delta_fold"] += 1
    return block


def slab_fold_plain(block: torch.Tensor, slabs: Sequence[torch.Tensor], op: str,
                    flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The twin: the elementwise reduction of the slabs into the block, in
    place; one is added to ``flag`` when the block changed."""
    TWIN_CALLS["slab_fold"] += 1
    if not len(slabs) or block.shape[0] == 0:
        return block
    stacked = torch.stack([t.reshape(-1) for t in slabs])
    if op == "min":
        new = torch.minimum(block, stacked.amin(0))
    elif op == "max":
        new = torch.maximum(block, stacked.amax(0))
    else:
        new = block + stacked.sum(0, dtype=torch.int32)
    if flag is not None and not torch.equal(new, block):
        flag += 1
    return block.copy_(new)


# ---------------------------------------------------------------------------
# wrappers: the kernel on CUDA tensors, the twin on CPU tensors


def _scratch_for(dev: torch.device, nbytes: int) -> torch.Tensor:
    """A reused scratch buffer for calls on the current stream, which run
    in order; a call writes every slot it reads."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.empty((max(nbytes, 1 << 16),), dtype=torch.uint8, device=dev)
        _scratch[key] = buf
    return buf


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


@_cuda.on_device_of("live")
def owner_pack(live: torch.Tensor, owner: Optional[torch.Tensor], a: Optional[torch.Tensor],
               b: Optional[torch.Tensor], s: int, cap: int, fill_a: int = DELTA_PAD, fill_b: int = 0,
               want_ok: bool = False, want_sent: bool = False, want_slot: bool = False,
               acc: Optional[torch.Tensor] = None) -> Packed:
    """Compact the live items of ``live`` (bool[n]) into ``[s, cap]`` slots
    by owner (``owner`` int32[n], or ``i % s``), stable in input order;
    payload ``a`` (int32[n], or ``i // s``) and ``b`` (int32[n] or None).
    ``acc`` (int32[3] on the same device, or None) accumulates (high-water
    of the counts, rows past cap, live items).  ``cap`` 0 counts alone."""
    if s < 1 or s > MAX_PACK_OWNERS:
        raise ValueError(f"owner_pack takes 1..{MAX_PACK_OWNERS} owners, not {s}")
    if cap < 0:
        raise ValueError("cap must be >= 0")
    _vector(live, (torch.bool, torch.uint8), "live")
    n = live.shape[0]
    _vector(owner, (torch.int32,), "owner", n)
    _vector(a, (torch.int32,), "a", n)
    _vector(b, (torch.int32,), "b", n)
    _vector(acc, (torch.int32,), "acc", 3)
    for t in (owner, a, b, acc):
        if t is not None and t.device != live.device:
            raise ValueError("owner_pack's tensors must share one device")
    if live.device.type == "cpu":
        return owner_pack_plain(live, owner, a, b, s, cap, fill_a, fill_b, want_ok, want_sent, want_slot, acc)
    if live.device.type != "cuda":
        raise ValueError(f"no owner_pack kernel for device {live.device}")
    dev = live.device
    lib = _cuda.library(_SOURCE)
    out_a = torch.empty((s * cap,), dtype=torch.int32, device=dev)
    out_b = torch.empty((s * cap,), dtype=torch.int32, device=dev) if b is not None else None
    okbuf = torch.empty((s * cap,), dtype=torch.bool, device=dev) if want_ok else None
    sent = torch.empty((n,), dtype=torch.bool, device=dev) if want_sent else None
    slot = torch.empty((n,), dtype=torch.int32, device=dev) if want_slot else None
    counts = torch.empty((s,), dtype=torch.int32, device=dev)
    nbytes = lib.owner_pack_scratch_bytes(n, s)
    scratch = _scratch_for(dev, nbytes)
    err = lib.owner_pack_launch(
        live.data_ptr(), _ptr(owner), _ptr(a), _ptr(b), n, s, cap, fill_a, fill_b, out_a.data_ptr(), _ptr(out_b),
        _ptr(okbuf), _ptr(sent), _ptr(slot), counts.data_ptr(), _ptr(acc), scratch.data_ptr(), scratch.numel(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "owner_pack_launch")
    LAUNCHES["owner_pack"] += 1
    return Packed(
        out_a.view(s, cap), None if out_b is None else out_b.view(s, cap),
        None if okbuf is None else okbuf.view(s, cap), sent, slot, counts,
    )


def _rows(t: Union[torch.Tensor, Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    """A [S, k] tensor or a list of S [k] tensors as a list of rows."""
    return list(t.unbind(0)) if isinstance(t, torch.Tensor) else list(t)


def _pointer_table(rows: List[torch.Tensor], k: int, dev: torch.device, name: str):
    for t in rows:
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != k or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 rows of {k}")
        if t.device != dev:
            raise ValueError(f"{name} must lie on the block's device")
    return (ctypes.c_longlong * len(rows))(*(t.data_ptr() for t in rows))


@_cuda.on_device_of("block")
def block_delta_fold(block: torch.Tensor, rows, vals, op: str) -> torch.Tensor:
    """Fold S senders' ``(row, value)`` buffers (``[S, cap]`` tensors or
    lists of S ``[cap]`` rows) into ``block`` (int32[R]) by ``op`` ("min",
    "max" or "add"), in place; returns ``block``."""
    if op not in OPS:
        raise ValueError(f"unknown block-delta op {op!r}")
    _vector(block, (torch.int32,), "block")
    rows, vals = _rows(rows), _rows(vals)
    if len(rows) != len(vals):
        raise ValueError("rows and vals must come from the same senders")
    if block.device.type == "cpu":
        return block_delta_fold_plain(block, rows, vals, op)
    if block.device.type != "cuda":
        raise ValueError(f"no block_delta_fold kernel for device {block.device}")
    s = len(rows)
    if s < 1 or s > MAX_SHARDS:
        raise ValueError(f"block_delta_fold takes 1..{MAX_SHARDS} senders, not {s}")
    cap = rows[0].shape[0]
    rp = _pointer_table(rows, cap, block.device, "rows")
    vp = _pointer_table(vals, cap, block.device, "vals")
    lib = _cuda.library(_SOURCE)
    err = lib.block_delta_fold_launch(block.data_ptr(), block.shape[0], rp, vp, s, cap, OPS[op],
                                      torch.cuda.current_stream(block.device).cuda_stream)
    _cuda.check(err, "block_delta_fold_launch")
    LAUNCHES["block_delta_fold"] += 1
    return block


@_cuda.on_device_of("block")
def slab_fold(block: torch.Tensor, slabs, op: str, flag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``block = op(block, slab_0, ..., slab_{S-1})`` elementwise (``slabs``:
    a ``[S, R]`` tensor or a list of S ``[R]`` rows; ``op`` "min", "max" or
    "add", int32 adds wrapping), in place; ``flag`` (int32[1] or None) grows
    exactly when the block changed.  Returns ``block``."""
    if op not in OPS:
        raise ValueError(f"unknown slab op {op!r}")
    _vector(block, (torch.int32,), "block")
    _vector(flag, (torch.int32,), "flag", 1)
    slabs = _rows(slabs)
    if block.device.type == "cpu":
        for t in slabs:
            if t.shape != block.shape:
                raise ValueError("every slab must have the block's shape")
        return slab_fold_plain(block, slabs, op, flag)
    if block.device.type != "cuda":
        raise ValueError(f"no slab_fold kernel for device {block.device}")
    if len(slabs) > MAX_SHARDS:
        raise ValueError(f"slab_fold takes at most {MAX_SHARDS} slabs")
    table = _pointer_table(slabs, block.shape[0], block.device, "slabs")
    if flag is not None and flag.device != block.device:
        raise ValueError("flag must lie on the block's device")
    lib = _cuda.library(_SOURCE)
    err = lib.slab_fold_launch(block.data_ptr(), block.shape[0], table, len(slabs), OPS[op], _ptr(flag),
                               torch.cuda.current_stream(block.device).cuda_stream)
    _cuda.check(err, "slab_fold_launch")
    LAUNCHES["slab_fold"] += 1
    return block
