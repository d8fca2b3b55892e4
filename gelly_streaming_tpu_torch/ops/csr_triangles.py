"""Masked-CSR triangle count of K panes: the wrapper of the port's CUDA kernel.

Replaces two XLA programs of ``gelly_streaming_tpu/library/triangles.py``:
``_superpane_count_fn`` (the superbatch plane's vmapped count over K
panes) and ``_count_kernel_impl`` (the same count for one pane past the
dense kernels' vertex bound).  For each pane k, over its ``ok`` slots
(u, v):

    count[k] = sum |N(u) & N(v)| / 3

with N the adjacency of the pane's ``ok`` edges in both directions: each
triangle is counted once per its three edges.

``csr_triangles`` launches ``csrc/csr_triangles.cu`` on CUDA tensors,
one C call: the panes' rows are counted, scanned into offsets and filled
with each edge's two directed entries (no sort: a row's order does not
matter), each edge given to the endpoint with the longer row; each such
owner stages its row in shared memory (a warp's filter and hash, or a
block's bitmap over the pane's ids) and streams the rows of the edges it
owns against it, min(d_u, d_v) lookups an edge; no [E, D, D] tensor and no
[n_v, D] table.  ``plan`` gives the call's shared-memory lookup and scratch.  On CPU tensors
it runs ``csr_triangles_plain``, the JAX functions' own form: the neighbor
table of ``ops/neighbors`` and the masked [E, D, D] equality reduction,
chunked over edges so that ``[chunk, D, D]`` stays under
``TWIN_CHUNK_BYTES``.  Sums are int64 (the JAX package sums in int32, so
parity holds below 2^31).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from gelly_streaming_tpu_torch.ops import _cuda
from gelly_streaming_tpu_torch.ops import neighbors as nbr_ops

_SOURCE = "csr_triangles.cu"
TWIN_CHUNK_BYTES = 1 << 28  # the twin's [chunk, D, D] bool intermediate
# csrc/csr_triangles.cu's constants
WARP_ROW = 128  # rows up to this length: a warp's filter and hash; longer: a block's bitmap
FILTER_BITS = 1 << 14  # a warp's filter (exact where the pane's ids fit it)
LOOKUP_MIN = 16 * (FILTER_BITS // 8 + 2 * WARP_ROW * 8)  # 16 warps: a filter and a (id, count) hash each
LOOKUP_CAP = 192 * 1024  # shared memory a block's lookup takes at most
TILE_ROWS = 2048  # rows a scan tile
CONTROL_WORDS = 16

# kernel launches since the last reset_launches() (CUDA tensors only)
LAUNCHES: Dict[str, int] = {"csr_triangles": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(u, v, ok, num_vertices: int, max_deg: int) -> None:
    for t, name, dtype in ((u, "u", torch.int32), (v, "v", torch.int32), (ok, "ok", torch.bool)):
        if t.dtype != dtype or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dtype} tensor [K, E]")
        if t.device != u.device or t.shape != u.shape:
            raise ValueError(f"{name} must lie on {u.device} with u's shape")
    if num_vertices < 1 or max_deg < 1:
        raise ValueError("num_vertices and max_deg must be positive")
    if u.shape[0] * u.shape[1] >= 1 << 30 or u.shape[0] * num_vertices >= (1 << 31) - 1:
        raise ValueError("csr_triangles takes K * E < 2^30 slots and K * num_vertices < 2^31 - 1 rows")


def csr_triangles_plain(u, v, ok, num_vertices: int, max_deg: int) -> torch.Tensor:
    """The JAX package's masked-CSR count per pane (``_superpane_count_fn``'s
    ``one``): a [num_vertices, max_deg] neighbor table of the ok edges in
    both directions, then the masked [E, D, D] equality sum, // 3.  int64 [K].
    The masked slots, whose terms the JAX form zeroes, are left out."""
    k = u.shape[0]
    dev = u.device
    chunk = max(1, TWIN_CHUNK_BYTES // (max_deg * max_deg))
    out = torch.zeros((k,), dtype=torch.int64, device=dev)
    for p in range(k):
        table = nbr_ops.init_table(num_vertices, max_deg, dev)
        table = nbr_ops.insert_batch(
            table, torch.cat([u[p], v[p]]), torch.cat([v[p], u[p]]), torch.cat([ok[p], ok[p]])
        )
        # masked slots add nothing to the reduction: only the ok ones are gathered
        live = ok[p].nonzero().squeeze(1)
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for lo in range(0, live.numel(), chunk):
            sel = live[lo : lo + chunk]
            rows_u, valid_u = nbr_ops.gather_rows(table, u[p, sel])  # [chunk, D]
            rows_v, valid_v = nbr_ops.gather_rows(table, v[p, sel])
            eq = (rows_u[:, :, None] == rows_v[:, None, :]) & valid_u[:, :, None] & valid_v[:, None, :]
            total += eq.sum(dtype=torch.int64)
        out[p] = total // 3
    return out


class Plan(NamedTuple):
    """One call's layout (``csrc/csr_triangles.cu``'s, mirrored)."""

    lookup_bytes: int  # the count kernel's dynamic shared memory
    bitmap_passes: int  # passes over id ranges of a long row's bitmap
    count_passes: int  # the same for a long row with a repeated neighbour (32-bit counts)
    scratch_bytes: int  # the device bytes beyond inputs and output


def _up(x: int) -> int:
    return (x + 255) & ~255


def plan(k: int, e: int, num_vertices: int) -> Plan:
    """The shared-memory lookup and the scratch of one call over ``k`` panes
    of ``e`` slots with ids in [0, ``num_vertices``): the lookup holds every
    warp's filter and hash (``LOOKUP_MIN``) and a long row's bitmap of the
    pane's ids where it fits under ``LOOKUP_CAP``, else that bitmap goes in
    passes; the
    scratch is the zeroed counters (row degrees, owned counts, 64-bit owned
    work, scan tile states, K sums, control words), the row offsets, the
    long-row list and its chunks' starts, and two int32 entries a slot, each
    piece 256-byte aligned (``csr_scratch_bytes``, which checks it)."""
    rows, entries = k * num_vertices, 2 * k * e
    lookup = min(LOOKUP_CAP, max(LOOKUP_MIN, -(-num_vertices // 128) * 16))
    max_big = min(rows, entries // (WARP_ROW + 1)) + 1
    tiles = -(-rows // TILE_ROWS)
    zeroed = _up(4 * rows) * 2 + _up(8 * rows) + _up(8 * tiles) + _up(8 * k) + _up(4 * CONTROL_WORDS)
    return Plan(lookup, -(-num_vertices // (8 * lookup)), -(-num_vertices // (lookup // 4)),
                zeroed + _up(4 * (rows + 1)) + _up(4 * max_big) + _up(4 * (max_big + 1)) + _up(4 * entries))


def scratch_bytes(k: int, e: int, num_vertices: int) -> int:
    """The device bytes one call takes beyond its inputs and output."""
    return plan(k, e, num_vertices).scratch_bytes


@_cuda.on_device_of("u")
def csr_triangles(u, v, ok, num_vertices: int, max_deg: int) -> torch.Tensor:
    """Triangles of each of K panes: int64 [K].

    ``u``/``v``: int32 [K, E], ids in [0, num_vertices); ``ok``: bool
    [K, E], the slots that are edges.  ``max_deg`` bounds every row's
    degree (the twin's table width; the kernel needs no bound).  Callers
    pass deduplicated canonical edges, so the count is that of the edge
    set."""
    _check(u, v, ok, num_vertices, max_deg)
    if u.device.type == "cpu":
        return csr_triangles_plain(u, v, ok, num_vertices, max_deg)
    if u.device.type != "cuda":
        raise ValueError(f"no csr_triangles kernel for device {u.device}")
    k, e = u.shape
    dev = u.device
    if k == 0 or e == 0:
        return torch.zeros((k,), dtype=torch.int64, device=dev)
    p = plan(k, e, num_vertices)
    out = torch.empty((k,), dtype=torch.int64, device=dev)
    scratch = torch.empty((p.scratch_bytes,), dtype=torch.uint8, device=dev)
    _cuda.check(_cuda.library(_SOURCE).csr_triangles_launch(
        u.data_ptr(), v.data_ptr(), ok.data_ptr(), k, e, num_vertices, p.lookup_bytes, out.data_ptr(),
        scratch.data_ptr(), scratch.numel(), torch.cuda.current_stream(dev).cuda_stream), "csr_triangles")
    LAUNCHES["csr_triangles"] += 1
    return out
