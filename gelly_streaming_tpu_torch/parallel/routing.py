"""Edge routing (the keyBy shuffle) and the owner-block exchange primitives.

Port of ``gelly_streaming_tpu/parallel/routing.py``:

* ``host_route``: the ingest plane, on the host: a window pane's edges
  bucketed by owning shard into stacked ``[S, B]`` arrays, each bucket
  padded to a common capacity (the keyBy-from-source analog).
* ``device_route`` / ``device_route_salted``: the data plane, re-keying
  every shard's edges to their owners on the devices: an ``owner_pack``
  into ``[S, cap]`` send buffers (``ops/routing.py``), then the mesh's
  ``all_to_all``; overflow past the pow2-bucketed cap is dropped and
  counted.
* the delta-exchange plane of owner-sharded summary state: vertex g lives
  on shard g % S at block row g // S; ``slab_exchange`` ships whole
  per-owner slabs, ``pack_slab_deltas`` / ``exchange_slab_deltas`` only
  the changed rows in fixed-capacity ``(row, value)`` buffers,
  ``apply_block_deltas`` folds received buffers into a block
  (``block_delta_fold``), ``gather_blocks`` reassembles the full view at
  emit and snapshot boundaries.

The mesh functions take and return per-shard lists (``parallel/mesh.py``:
one process drives every shard); the single-shard ones (``owner_rank``,
``pack_slab_deltas``, ``apply_block_deltas``) take one shard's tensors,
like the JAX functions called inside ``shard_map``.  Capacities are
pow2-bucketed (``pow2_bucket``), as in the JAX package.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from gelly_streaming_tpu_torch.parallel.mesh import Mesh, all_to_all, block_rows
from gelly_streaming_tpu_torch.utils import native

DELTA_PAD = -1  # pack_slab_deltas row sentinel for empty buffer slots


def pow2_bucket(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


class RoutedEdges(NamedTuple):
    """Stacked per-shard edge arrays: leading axis = shard."""

    src: np.ndarray  # [S, B]
    dst: np.ndarray  # [S, B]
    mask: np.ndarray  # [S, B]
    val: Optional[object] = None  # a value column of [S, B, ...] arrays


def host_route(src: np.ndarray, dst: np.ndarray, num_shards: int, key: str = "src",
               capacity: Optional[int] = None, val=None) -> RoutedEdges:
    """Bucket edges by owner shard (``key`` % num_shards) on the host, each
    bucket padded to a common capacity (a power of two unless given),
    arrival order kept within a shard; an optional ``val`` column (a leaf,
    or a tuple, list or dict of leaves) routes alongside.  Value-less int32
    batches scatter through the native single-pass router when the host
    library loads, the rest take one boolean selection a shard."""
    from gelly_streaming_tpu_torch.core.types import tree_map

    if val is None and len(src) and src.dtype == np.int32 and dst.dtype == np.int32:
        lib = native.load_ingest_lib()
        if lib is not None:
            cap = capacity or pow2_bucket(
                int(np.bincount((src if key == "src" else dst) % num_shards, minlength=num_shards).max())
            )
            s = np.zeros((num_shards, cap), np.int32)
            d = np.zeros((num_shards, cap), np.int32)
            counts = np.zeros((num_shards,), np.int64)
            src_c = np.ascontiguousarray(src)
            dst_c = np.ascontiguousarray(dst)
            wrote = lib.route_edges(src_c.ctypes.data, dst_c.ctypes.data, len(src), num_shards,
                                    1 if key == "src" else 0, cap, s.ctypes.data, d.ctypes.data, counts.ctypes.data)
            if wrote == len(src):  # no overflow: buckets are complete
                m = np.arange(cap)[None, :] < counts[:, None]
                return RoutedEdges(s, d, m, None)
    owner = (src if key == "src" else dst) % num_shards
    counts = np.bincount(owner, minlength=num_shards)
    cap = capacity or (pow2_bucket(int(counts.max())) if len(src) else 1)
    s = np.zeros((num_shards, cap), np.int32)
    d = np.zeros((num_shards, cap), np.int32)
    m = np.zeros((num_shards, cap), bool)
    v = tree_map(lambda a: np.zeros((num_shards, cap) + a.shape[1:], a.dtype), val)
    for shard in range(num_shards):
        sel = owner == shard
        n = min(int(sel.sum()), cap)
        s[shard, :n] = src[sel][:n]
        d[shard, :n] = dst[sel][:n]
        m[shard, :n] = True
        if v is not None:
            tree_map(lambda buf, a: buf.__setitem__((shard, slice(0, n)), a[sel][:n]), v, val)
    return RoutedEdges(s, d, m, v)


def owner_rank(owner: torch.Tensor, mask: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Per-owner occurrence rank for owner ids in [0, num_shards): the JAX
    package's one-hot cumsum, in PyTorch ops (on the routing path the rank
    is computed inside ``owner_pack``; rows outside the mask get the rank
    the cumsum gives them, as there)."""
    oh = (owner.to(torch.int64)[:, None] == torch.arange(num_shards, device=owner.device)[None, :]) & mask[:, None]
    c = torch.cumsum(oh.to(torch.int32), 0, dtype=torch.int32)
    if owner.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int32, device=owner.device)
    return c.gather(1, owner.to(torch.int64).clamp(0, num_shards - 1)[:, None]).squeeze(1) - 1


class RoutedDeviceEdges:
    """One shard's ``device_route`` result: flattened ``[S * cap]`` received
    edges; iterating yields ``(src, dst, mask, dropped)``, ``.val`` the
    routed value column."""

    __slots__ = ("src", "dst", "mask", "dropped", "val")

    def __init__(self, src, dst, mask, dropped, val=None):
        self.src = src
        self.dst = dst
        self.mask = mask
        self.dropped = dropped  # int32 scalar tensor: rows this shard failed to send
        self.val = val

    def __iter__(self):
        return iter((self.src, self.dst, self.mask, self.dropped))


def _exchange_by_owner(mesh: Mesh, src, dst, mask, owner, num_shards: int, capacity: int,
                       val=None) -> List[RoutedDeviceEdges]:
    """Pack every shard's rows into ``[S, cap]`` send buffers by owner
    (``owner_pack``) and swap them (``all_to_all``)."""
    from gelly_streaming_tpu_torch.core.types import tree_leaves, tree_map
    from gelly_streaming_tpu_torch.ops import routing as rk

    capacity = pow2_bucket(capacity)
    n = num_shards
    sends, dropped = [], []
    for s in range(mesh.size):
        p = rk.owner_pack(mask[s], owner[s], src[s], dst[s], n, capacity, fill_a=0, fill_b=0, want_ok=True,
                          want_slot=val is not None)
        dropped.append((p.counts - capacity).clamp(min=0).sum(dtype=torch.int32))
        sv = None
        if val is not None:
            ok = p.slot >= 0
            here = p.slot[ok].to(torch.int64)

            def put(leaf, here=here, ok=ok):
                buf = torch.zeros((n * capacity,) + tuple(leaf.shape[1:]), dtype=leaf.dtype, device=leaf.device)
                buf[here] = leaf[ok]
                return buf.view((n, capacity) + tuple(leaf.shape[1:]))

            sv = tree_map(put, val[s])
        sends.append((p.out_a, p.out_b, p.ok, sv))
    out = []
    recv = [all_to_all(mesh, [snd[k] for snd in sends]) for k in range(3)]
    recv_val = None
    if val is not None:
        leaves = [tree_leaves(snd[3]) for snd in sends]
        recv_val = [all_to_all(mesh, [lv[j] for lv in leaves]) for j in range(len(leaves[0]))]
    for r in range(mesh.size):
        rs, rd, rm = (torch.cat(recv[k][r]) for k in range(3))
        rv = None
        if val is not None:
            flat = [torch.cat(recv_val[j][r]) for j in range(len(recv_val))]
            it = iter(flat)
            rv = tree_map(lambda _: next(it), val[r])
        out.append(RoutedDeviceEdges(rs, rd, rm, dropped[r], rv))
    return out


def _owners(keys, mask, num_shards):
    return torch.where(mask, torch.remainder(keys, num_shards), num_shards - 1).to(torch.int32)


def device_route(mesh: Mesh, src: Sequence[torch.Tensor], dst: Sequence[torch.Tensor],
                 mask: Sequence[torch.Tensor], num_shards: int, capacity: int, key: str = "src",
                 val=None) -> List[RoutedDeviceEdges]:
    """Re-key every shard's edges to their owner shards: per shard a
    ``RoutedDeviceEdges`` of the ``[S * cap]`` rows it received (``cap``
    pow2-bucketed) and the rows it failed to send (``dropped``, counted,
    never silent).  ``src``/``dst``/``mask`` (and ``val``) are per-shard
    lists."""
    keys = src if key == "src" else dst
    owner = [_owners(keys[s], mask[s], num_shards) for s in range(mesh.size)]
    return _exchange_by_owner(mesh, src, dst, mask, owner, num_shards, capacity, val)


def device_route_salted(mesh: Mesh, src: Sequence[torch.Tensor], dst: Sequence[torch.Tensor],
                        mask: Sequence[torch.Tensor], num_shards: int, capacity: int, key: str = "src",
                        val=None) -> List[RoutedDeviceEdges]:
    """Skew-safe routing for associative keyed aggregation: a key's k-th
    local occurrence goes to shard ``(owner + k) % S`` (k: the key's
    occurrence rank, ``ops/segments.occurrence_rank``), so a hub's rows
    spread over the mesh; receivers hold partial per-key state."""
    from gelly_streaming_tpu_torch.ops import segments

    keys = src if key == "src" else dst
    owner = []
    for s in range(mesh.size):
        base = _owners(keys[s], mask[s], num_shards).to(torch.int64)
        salt = segments.occurrence_rank(keys[s], mask[s]).to(torch.int64)
        owner.append(torch.remainder(base + salt, num_shards).to(torch.int32))
    return _exchange_by_owner(mesh, src, dst, mask, owner, num_shards, capacity, val)


# ---------------------------------------------------------------------------
# owner-sharded summary state: the block exchange primitives


def slab_exchange(mesh: Mesh, values: Sequence[torch.Tensor]) -> List[List[torch.Tensor]]:
    """Dense block route: shard s's full-[C] ``values[s]`` -> for each owner
    r the S slabs ``values[s][r::S]`` proposed for its block rows (one
    copy a sender to lay its slabs out, then the ``all_to_all``)."""
    n = mesh.size
    return all_to_all(mesh, [v.view(-1, n).T.contiguous() for v in values])


def slab_exchange_nbytes(capacity: int, itemsize: int = 4) -> int:
    """Per-shard wire volume of one slab_exchange over a [C] value array."""
    return capacity * itemsize


def delta_capacity(capacity: int, num_shards: int, delta_bound: int) -> int:
    """Pow2-bucketed per-(sender, receiver) capacity for a delta exchange:
    the changed-row bound, clamped at the structural C/S."""
    return pow2_bucket(min(block_rows(capacity, num_shards), max(int(delta_bound), 1)))


def pack_slab_deltas(changed: torch.Tensor, values: torch.Tensor, num_shards: int, capacity: int, fill):
    """Compact the changed rows of one shard's full-[C] view into per-owner
    delta buffers: ``(rows [S, cap] int32 (block rows g // S, DELTA_PAD
    empty), vals [S, cap] (``fill`` empty), sent [C] bool, occupancy,
    spilled)``, the last two int32 scalars (the max per-owner demand before
    capping, and the rows past the cap)."""
    from gelly_streaming_tpu_torch.ops import routing as rk

    p = rk.owner_pack(changed, None, None, values, num_shards, capacity, fill_a=DELTA_PAD, fill_b=int(fill),
                      want_sent=True)
    occupancy = p.counts.max()
    spilled = (p.counts - capacity).clamp(min=0).sum(dtype=torch.int32)
    return p.out_a, p.out_b, p.sent, occupancy, spilled


def exchange_slab_deltas(mesh: Mesh, changed: Sequence[torch.Tensor], values: Sequence[torch.Tensor],
                         num_shards: int, capacity: int, fill=0, accs=None, want_sent: bool = False):
    """``owner_pack`` of every shard's changed rows, then the swap: returns
    ``(recv_rows, recv_vals, sent)`` with ``recv_rows[r][s]`` the block rows
    shard s proposes values for on shard r (DELTA_PAD empty) and ``sent[s]``
    shard s's landed rows (None unless asked).  ``accs``:
    ``{device: int32[3]}`` accumulators (``ops/routing.owner_pack``)."""
    from gelly_streaming_tpu_torch.ops import routing as rk

    rows, vals, sent = [], [], []
    for s in range(mesh.size):
        p = rk.owner_pack(changed[s], None, None, values[s], num_shards, capacity, fill_a=DELTA_PAD,
                          fill_b=int(fill), want_sent=want_sent,
                          acc=None if accs is None else accs[mesh.devices[s]])
        rows.append(p.out_a)
        vals.append(p.out_b)
        sent.append(p.sent)
    return all_to_all(mesh, rows), all_to_all(mesh, vals), sent


def delta_exchange_nbytes(num_shards: int, capacity: int, itemsize: int = 4) -> int:
    """Per-shard wire volume of one exchange_slab_deltas pass (rows + vals)."""
    return num_shards * capacity * (4 + itemsize)


def apply_block_deltas(block: torch.Tensor, recv_rows, recv_vals, op: str, fill=None) -> torch.Tensor:
    """Fold received delta buffers (``[S, cap]`` tensors or lists of S
    ``[cap]`` rows) into this shard's int32 ``[C/S]`` block by ``op``
    ("min" / "max" / "add"), in place (``block_delta_fold``).  Empty slots
    (DELTA_PAD rows) drop whatever they hold, so ``fill`` is not read; it
    stays for the JAX signature."""
    from gelly_streaming_tpu_torch.ops import routing as rk

    return rk.block_delta_fold(block, recv_rows, recv_vals, op)


def gather_full(blocks: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """``[C/S, ...]`` owner blocks -> the full ``[C, ...]`` view on
    ``device`` (vertex g from ``blocks[g % S][g // S]``), a new tensor."""
    g = torch.stack([b.to(device, non_blocking=True) for b in blocks], dim=1)
    return g.reshape((-1,) + tuple(g.shape[2:]))


def gather_blocks(mesh: Mesh, blocks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``gather_full`` for each shard: one tensor a device, shared by its
    shards."""
    out = {d: gather_full(blocks, d) for d, _ in mesh.groups}
    return [out[d] for d in mesh.devices]


def gather_blocks_nbytes(capacity: int, itemsize: int = 4) -> int:
    """Per-shard wire volume of one gather_blocks over a [C]-row state."""
    return capacity * itemsize
