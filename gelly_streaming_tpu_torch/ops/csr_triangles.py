"""Masked-CSR triangle count of K panes: the wrapper of the port's CUDA kernel.

Replaces two XLA programs of ``gelly_streaming_tpu/library/triangles.py``:
``_superpane_count_fn`` (the superbatch plane's vmapped count over K
panes) and ``_count_kernel_impl`` (the same count for one pane past the
dense kernels' vertex bound).  For each pane k, over its ``ok`` slots
(u, v):

    count[k] = sum |N(u) & N(v)| / 3

with N the adjacency of the pane's ``ok`` edges in both directions: each
triangle is counted once per its three edges.

``csr_triangles`` launches ``csrc/csr_triangles.cu`` on CUDA tensors: the
panes' directed edges are written as (row, col) entries, ordered by the
port's radix sort of ``csrc/neighborhoods.cu`` (one sort on a fused key
where it fits 31 bits, else by column and then stably by row) into CSR
rows, and each edge's shorter row is binary-searched in its longer one;
no [E, D, D] tensor and no [n_v, D] table.  On CPU tensors it runs
``csr_triangles_plain``, the JAX functions' own form: the neighbor table
of ``ops/neighbors`` and the masked [E, D, D] equality reduction, chunked
over edges so that ``[chunk, D, D]`` stays under ``TWIN_CHUNK_BYTES``.
Sums are int64 (the JAX package sums in int32, so parity holds below
2^31).  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

from typing import Dict

import torch

from gelly_streaming_tpu_torch.ops import _cuda
from gelly_streaming_tpu_torch.ops import neighbors as nbr_ops

_SOURCE = "csr_triangles.cu"
_SORT_SOURCE = "neighborhoods.cu"  # the port's stable radix sort
TWIN_CHUNK_BYTES = 1 << 28  # the twin's [chunk, D, D] bool intermediate

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


def _plan(k: int, e: int, num_vertices: int):
    """(entries, shift): two entries a slot; shift the bits of
    num_vertices - 1 when (row << shift | col) fits 31 bits (one sort),
    else 0 (a sort by column, then by row)."""
    cb = (num_vertices - 1).bit_length()
    return 2 * k * e, cb if (k * num_vertices - 1).bit_length() + cb <= 31 else 0


def scratch_bytes(k: int, e: int, num_vertices: int) -> int:
    """The device bytes one call takes beyond its inputs and output: the
    count's scratch (``csr_scratch_bytes``), the entries (int32 rows and
    cols, bool mask) and the sort's scratch (builds the libraries)."""
    n, _shift = _plan(k, e, num_vertices)
    return (int(_cuda.library(_SOURCE).csr_scratch_bytes(k, e, num_vertices)) + 9 * n + 12
            + int(_cuda.library(_SORT_SOURCE).nb_scratch_bytes(n, 0)))


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
    out = torch.zeros((k,), dtype=torch.int64, device=dev)
    if k == 0 or e == 0:
        return out
    lib, nb = _cuda.library(_SOURCE), _cuda.library(_SORT_SOURCE)
    n, shift = _plan(k, e, num_vertices)
    rows = torch.empty((n,), dtype=torch.int32, device=dev)
    cols = torch.empty((n,), dtype=torch.int32, device=dev)
    mask = torch.empty((n,), dtype=torch.bool, device=dev)
    meta = torch.empty((3,), dtype=torch.int32, device=dev)
    sort_scratch = torch.empty((nb.nb_scratch_bytes(n, 0),), dtype=torch.uint8, device=dev)
    scratch = torch.empty((lib.csr_scratch_bytes(k, e, num_vertices),), dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ss = (sort_scratch.data_ptr(), sort_scratch.numel())

    def sort(src, dst):  # stable by src, the sorted rows written back over src and dst
        _cuda.check(nb.nb_sort_launch(src.data_ptr(), dst.data_ptr(), mask.data_ptr(), n, 0, *ss, stream),
                    "nb_sort_launch")
        _cuda.check(nb.nb_sorted_launch(n, 0, *ss, src.data_ptr(), dst.data_ptr(), None, meta.data_ptr(), stream),
                    "nb_sorted_launch")

    _cuda.check(lib.csr_expand_launch(u.data_ptr(), v.data_ptr(), ok.data_ptr(), k, e, num_vertices, shift,
                                      rows.data_ptr(), cols.data_ptr(), mask.data_ptr(), stream), "csr_expand")
    if shift:
        sort(rows, cols)
    else:
        sort(cols, rows)
        _cuda.check(lib.csr_prefix_mask_launch(meta.data_ptr(), n, mask.data_ptr(), stream), "csr_prefix_mask")
        sort(rows, cols)
    _cuda.check(lib.csr_count_launch(u.data_ptr(), v.data_ptr(), ok.data_ptr(), k, e, num_vertices, shift,
                                     rows.data_ptr(), cols.data_ptr(), meta.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), scratch.numel(), stream), "csr_count")
    LAUNCHES["csr_triangles"] += 1
    return out
