"""One GraphSAGE layer over a degree bucket: the wrapper of ``csrc/sage.cu``
and its plain twin.

``sage_layer(table, keys, nbrs, valid, w, bias, out=None, row0=0)``
writes bf16 ``relu([x_self | mean] @ w + bias)`` for each row of a degree
bucket into ``out[row0 : row0 + K]`` and returns those rows: ``x_self``
the row's own table row, ``mean`` the mean of its valid neighbors' rows,
``w`` the stacked ``[W_self; W_nbr]`` (bf16 [2 F_in, F_out]).  The table
is bf16 [C, F_in]; ids outside [0, C) follow JAX's gather rule
(``ops/indexing.gather_index``).  The mean sums in f32 and rounds once to
bf16 (the JAX package rounds the sum and the count to bf16 before its
division; the embeddings' tolerance covers the difference; the kernel
multiplies by the count's reciprocal, the twin divides); the product
accumulates in f32, adds the bias in f32 and rounds once.

``sage_layer_backward(table, keys, nbrs, valid, z, dz, dw, db)`` is the
layer's weight gradient: it adds ``[x_self | mean]^T @ dh`` into the f32
``dw`` [2 F_in, F_out] and ``dh.sum(0)`` into the f32 ``db`` [F_out],
``dh = dz * [z > 0]`` in f32 from the bf16 output ``z`` and its bf16
gradient ``dz`` (ReLU's derivative at 0 is 0, as ``jax.nn.relu`` has
it).  The table and ids are constants: no gradient flows into feature
rows.  ``SageLayerFn`` is the layer as an autograd Function: its forward
is ``sage_layer`` and saves the ids and ``z``, never ``[x_self | mean]``;
its backward rebuilds those rows the forward's way, so the gradient is
taken at the very A the forward multiplied.  Autograd rounds the f32
gradient it returns for the bf16 ``w`` and ``bias`` to bf16, as the JAX
package's gradient passes through bf16 at ``_as_bf16``.

On CUDA tensors the wrapper is one C call (the layer kernel, after a
partial-sum kernel, a warp a 256-slot chunk, for rows of more than 32
slots) and ``LAUNCHES`` counts it; the ``[x_self | mean]`` rows never
reach device memory.  F_in and F_out multiples of 8 take the product by
wgmma, other widths by the CUDA cores; wide layers walk F_in in K chunks,
so every width runs.  On CPU tensors it runs ``sage_layer_plain`` and
launches nothing.  The backward on CUDA tensors is one C call too (the
partial-sum kernel for long rows, the gradient kernel, a kernel that adds
its blocks' partials in block order, so ``dw`` is the same bit for bit
from run to run), counted in ``LAUNCHES["sage_layer_backward"]``; on CPU
tensors ``sage_layer_backward_plain``.  F_in and F_out multiples of 8 take
the gradient's product by wgmma, the next tile's gather overlapped with
it, other widths the CUDA cores.  With D = 0 (an empty neighborhood: the
training contexts) the mean half is all zeros: both kernels skip its
product, and the backward leaves ``dw``'s W_nbr rows as they were (the
twin adds exact zeros there), as the JAX package never forms that half.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gelly_streaming_tpu_torch.ops import _cuda, indexing

_SOURCE = "sage.cu"
_DIRECT = 32  # rows of up to this many slots are gathered by the layer kernel itself
_CHUNK = 256  # neighbor slots a warp of the partial-sum kernel; longer rows spread over several

# kernel launches since the last reset_launches() (CUDA tensors only)
LAUNCHES: Dict[str, int] = {"sage_layer": 0, "sage_layer_backward": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_bucket(table, keys, nbrs, valid) -> None:
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


def _check_device(table, *tensors) -> None:
    for t in tensors:
        if t.device != table.device:
            raise ValueError(f"every input must lie on {table.device}")


def _check(table, keys, nbrs, valid, w, bias, out, row0) -> None:
    _check_bucket(table, keys, nbrs, valid)
    f_in = table.shape[1]
    if w.dtype != torch.bfloat16 or w.dim() != 2 or w.shape[0] != 2 * f_in or not w.is_contiguous():
        raise ValueError(f"w must be a contiguous bf16 [2 * {f_in}, F_out] tensor (the stacked [W_self; W_nbr])")
    f_out = w.shape[1]
    if bias.dtype != torch.bfloat16 or bias.shape != (f_out,) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous bf16 [{f_out}] tensor")
    if out is not None:
        if out.dtype != torch.bfloat16 or out.dim() != 2 or out.shape[1] != f_out or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous bf16 [N, {f_out}] tensor")
        if row0 < 0 or row0 + keys.shape[0] > out.shape[0]:
            raise ValueError(f"rows [{row0}, {row0 + keys.shape[0]}) do not fit out's {out.shape[0]} rows")
    elif row0 != 0:
        raise ValueError("row0 needs an out buffer")
    _check_device(table, keys, nbrs, valid, w, bias, *(() if out is None else (out,)))


def _check_backward(table, keys, nbrs, valid, z, dz, dw, db) -> None:
    _check_bucket(table, keys, nbrs, valid)
    k, f_in = keys.shape[0], table.shape[1]
    if z.dtype != torch.bfloat16 or z.dim() != 2 or z.shape[0] != k or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous bf16 [{k}, F_out] tensor (the layer's output)")
    f_out = z.shape[1]
    if dz.dtype != torch.bfloat16 or dz.shape != z.shape or not dz.is_contiguous():
        raise ValueError(f"dz must be a contiguous bf16 [{k}, {f_out}] tensor (z's gradient)")
    if dw.dtype != torch.float32 or dw.shape != (2 * f_in, f_out) or not dw.is_contiguous():
        raise ValueError(f"dw must be a contiguous f32 [{2 * f_in}, {f_out}] tensor")
    if db.dtype != torch.float32 or db.shape != (f_out,) or not db.is_contiguous():
        raise ValueError(f"db must be a contiguous f32 [{f_out}] tensor")
    _check_device(table, keys, nbrs, valid, z, dz, dw, db)


def _partials(table, k: int, d: int):
    """(chunks, partial sums, partial counts) for a bucket's rows of D
    slots: the partial-sum kernel's scratch where D passes _DIRECT."""
    nchunks = -(-d // _CHUNK) if d > _DIRECT else 0
    if not nchunks:
        return 0, None, None
    part = torch.empty((k * nchunks, table.shape[1]), dtype=torch.float32, device=table.device)
    part_cnt = torch.empty((k * nchunks,), dtype=torch.int32, device=table.device)
    return nchunks, part, part_cnt


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gather_mean_plain(table, keys, nbrs, valid) -> torch.Tensor:
    """bf16 [K, 2F]: ``[table[keys] | bf16(sum of the valid neighbors'
    rows in f32 / max(count, 1))]``, in PyTorch ops."""
    c = table.shape[0]
    x_self = table[indexing.gather_index(keys, c)]
    x_nbr = table[indexing.gather_index(nbrs, c)].float()  # [K, D, F]
    total = torch.where(valid.unsqueeze(-1), x_nbr, 0.0).sum(1)
    count = valid.sum(1, dtype=torch.float32).clamp(min=1.0)
    return torch.cat([x_self, (total / count.unsqueeze(1)).to(torch.bfloat16)], 1)


def sage_layer_plain(table, keys, nbrs, valid, w, bias) -> torch.Tensor:
    """bf16 [K, F_out]: ``relu(gather_mean_plain(...) @ w + bias)``, in
    PyTorch ops (one product with the stacked weights in f32: the bias and
    both products summed before the one rounding to bf16; a bf16 ``addmm``
    on the card may reduce split-K partial sums in bf16)."""
    xm = gather_mean_plain(table, keys, nbrs, valid)
    return torch.relu_(torch.addmm(bias.float(), xm.float(), w.float())).to(torch.bfloat16)


@_cuda.on_device_of("table")
def sage_layer(table, keys, nbrs, valid, w, bias, out: Optional[torch.Tensor] = None, row0: int = 0) -> torch.Tensor:
    """The bucket's embeddings, bf16 [K, F_out], written to
    ``out[row0 : row0 + K]`` when ``out`` is given (see the module)."""
    _check(table, keys, nbrs, valid, w, bias, out, row0)
    (c, f_in), (k, d), f_out = table.shape, nbrs.shape, w.shape[1]
    if out is None:
        out = torch.empty((k, f_out), dtype=torch.bfloat16, device=table.device)
    rows = out[row0 : row0 + k]
    if table.device.type == "cpu":
        return rows.copy_(sage_layer_plain(table, keys, nbrs, valid, w, bias))
    if table.device.type != "cuda":
        raise ValueError(f"no sage_layer kernel for device {table.device}")
    if k == 0:
        return rows
    nchunks, part, part_cnt = _partials(table, k, d)
    err = _cuda.library(_SOURCE).sage_layer_launch(
        table.data_ptr(), c, f_in, keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, w.data_ptr(),
        bias.data_ptr(), f_out, rows.data_ptr(), _CHUNK, nchunks, _ptr(part), _ptr(part_cnt),
        torch.cuda.current_stream(table.device).cuda_stream,
    )
    _cuda.check(err, "sage_layer_launch")
    LAUNCHES["sage_layer"] += 1
    return rows


def sage_layer_backward_plain(table, keys, nbrs, valid, z, dz, dw, db):
    """Adds the bucket's ``gather_mean_plain(...)^T @ dh`` into ``dw`` and
    ``dh.sum(0)`` into ``db``, ``dh = dz * [z > 0]`` in f32, in PyTorch ops
    (the forward twin's A, so both twins see one A); returns (dw, db)."""
    dh = torch.where(z > 0, dz.float(), 0.0)
    dw.add_(gather_mean_plain(table, keys, nbrs, valid).float().T @ dh)
    db.add_(dh.sum(0))
    return dw, db


@_cuda.on_device_of("table")
def sage_layer_backward(table, keys, nbrs, valid, z, dz, dw, db):
    """The layer's weight gradient over one bucket, added into the f32
    ``dw`` and ``db`` (see the module); returns (dw, db)."""
    _check_backward(table, keys, nbrs, valid, z, dz, dw, db)
    if table.device.type == "cpu":
        return sage_layer_backward_plain(table, keys, nbrs, valid, z, dz, dw, db)
    if table.device.type != "cuda":
        raise ValueError(f"no sage_layer_backward kernel for device {table.device}")
    (c, f_in), (k, d), f_out = table.shape, nbrs.shape, z.shape[1]
    if k == 0:
        return dw, db
    lib = _cuda.library(_SOURCE)
    nbytes = lib.sage_layer_backward_scratch_bytes(f_in, f_out)
    if nbytes < 0:
        raise RuntimeError("sage_layer_backward_scratch_bytes: the device could not be read")
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=table.device)
    nchunks, part, part_cnt = _partials(table, k, d)
    err = lib.sage_layer_backward_launch(
        table.data_ptr(), c, f_in, keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, z.data_ptr(),
        dz.data_ptr(), f_out, dw.data_ptr(), db.data_ptr(), _CHUNK, nchunks, _ptr(part), _ptr(part_cnt),
        scratch.data_ptr(), nbytes, torch.cuda.current_stream(table.device).cuda_stream,
    )
    _cuda.check(err, "sage_layer_backward_launch")
    LAUNCHES["sage_layer_backward"] += 1
    return dw, db


class SageLayerFn(torch.autograd.Function):
    """``sage_layer`` with its weight gradient: ``apply(table, keys, nbrs,
    valid, w, bias)`` -> bf16 [K, F_out]; gradients for ``w`` and ``bias``
    only (the table and the ids are constants)."""

    @staticmethod
    def forward(ctx, table, keys, nbrs, valid, w, bias):
        z = sage_layer(table, keys, nbrs, valid, w, bias)
        ctx.save_for_backward(table, keys, nbrs, valid, z)
        return z

    @staticmethod
    def backward(ctx, dz):
        table, keys, nbrs, valid, z = ctx.saved_tensors
        if not (ctx.needs_input_grad[4] or ctx.needs_input_grad[5]):
            return None, None, None, None, None, None
        dw = torch.zeros((2 * table.shape[1], z.shape[1]), dtype=torch.float32, device=z.device)
        db = torch.zeros((z.shape[1],), dtype=torch.float32, device=z.device)
        sage_layer_backward(table, keys, nbrs, valid, z, dz.to(torch.bfloat16).contiguous(), dw, db)
        return (None, None, None, None, dw if ctx.needs_input_grad[4] else None,
                db if ctx.needs_input_grad[5] else None)
