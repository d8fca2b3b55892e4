"""The neighbor gather and masked mean of GraphSAGE: the wrapper of
``csrc/sage.cu`` and its plain twin.

``gather_mean(table, keys, nbrs, valid)`` returns bf16 [K, 2F]: for each
row of a degree bucket, the row's own table row and the mean of its valid
neighbors' rows, ``[x_self | mean]``, the input of the layer's one
product with the stacked ``[W_self; W_nbr]``
(``library/graphsage.sage_kernel``).  The table is bf16 [C, F]; ids
outside [0, C) follow JAX's gather rule (``ops/indexing.gather_index``).
The mean sums in f32 and rounds once to bf16 (the JAX package rounds the
sum and the count to bf16 before its division; the embeddings' tolerance
covers the difference).

On CUDA tensors the wrapper is one C call (the gather kernel, and a finish
kernel for rows longer than one 256-slot chunk) and ``LAUNCHES`` counts it;
on CPU tensors it runs ``gather_mean_plain`` and launches nothing.
"""

from __future__ import annotations

from typing import Dict

import torch

from gelly_streaming_tpu_torch.ops import _cuda, indexing

_SOURCE = "sage.cu"
_CHUNK = 256  # neighbor slots a warp; longer rows spread over several warps

# kernel launches since the last reset_launches() (CUDA tensors only)
LAUNCHES: Dict[str, int] = {"sage_gather_mean": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(table, keys, nbrs, valid) -> None:
    if table.dtype != torch.bfloat16 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous bf16 [C, F] tensor")
    if table.shape[0] == 0:
        raise ValueError("table must have at least one row")
    if keys.dtype != torch.int32 or keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous int32 [K] tensor")
    if nbrs.dtype != torch.int32 or nbrs.dim() != 2 or not nbrs.is_contiguous():
        raise ValueError("nbrs must be a contiguous int32 [K, D] tensor")
    if valid.dtype != torch.bool or valid.shape != nbrs.shape or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool tensor shaped like nbrs")
    if nbrs.shape[0] != keys.shape[0]:
        raise ValueError("keys and nbrs must have the same number of rows")
    for t in (keys, nbrs, valid):
        if t.device != table.device:
            raise ValueError(f"every input must lie on {table.device}")


def gather_mean_plain(table, keys, nbrs, valid) -> torch.Tensor:
    """bf16 [K, 2F]: ``[table[keys] | bf16(sum of the valid neighbors'
    rows in f32 / max(count, 1))]``, in PyTorch ops."""
    c = table.shape[0]
    x_self = table[indexing.gather_index(keys, c)]
    x_nbr = table[indexing.gather_index(nbrs, c)].float()  # [K, D, F]
    total = torch.where(valid.unsqueeze(-1), x_nbr, 0.0).sum(1)
    count = valid.sum(1, dtype=torch.float32).clamp(min=1.0)
    return torch.cat([x_self, (total / count.unsqueeze(1)).to(torch.bfloat16)], 1)


def gather_mean(table, keys, nbrs, valid) -> torch.Tensor:
    """The bucket's ``[x_self | mean]`` rows, bf16 [K, 2F] (see the module)."""
    _check(table, keys, nbrs, valid)
    if table.device.type == "cpu":
        return gather_mean_plain(table, keys, nbrs, valid)
    if table.device.type != "cuda":
        raise ValueError(f"no sage_gather_mean kernel for device {table.device}")
    (c, f), (k, d) = table.shape, nbrs.shape
    out = torch.empty((k, 2 * f), dtype=torch.bfloat16, device=table.device)
    if k == 0:
        return out
    nchunks = max(1, -(-d // _CHUNK))
    part = part_cnt = None
    if nchunks > 1:
        part = torch.empty((k * nchunks, f), dtype=torch.float32, device=table.device)
        part_cnt = torch.empty((k * nchunks,), dtype=torch.int32, device=table.device)
    vec = int(f % 8 == 0 and table.data_ptr() % 16 == 0)
    err = _cuda.library(_SOURCE).sage_gather_mean_launch(
        table.data_ptr(), c, f, keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, _CHUNK, nchunks, vec,
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if part_cnt is None else part_cnt.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream,
    )
    _cuda.check(err, "sage_gather_mean_launch")
    LAUNCHES["sage_gather_mean"] += 1
    return out
