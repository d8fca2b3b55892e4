"""Core value types: padded COO edge micro-batches and enums.

Port of ``gelly_streaming_tpu/core/types.py``.  An ``EdgeBatch`` holds
torch tensors on one device: int32 ``src``/``dst``, a bool ``mask``
(False rows are padding), an optional ``val`` (a tensor, or a tuple/dict
of tensors), int64 ``time`` and int8 ``sign``.  Padding rules match the
JAX type: pad rows are masked out, ``sign`` pads with +1, the rest with 0.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device


class EventType(enum.Enum):
    """Edge event kind (reference: EventType.java:24-27)."""

    EDGE_ADDITION = 1
    EDGE_DELETION = -1


class EdgeDirection(enum.Enum):
    """Neighborhood direction for degree ops (Flink's EdgeDirection)."""

    IN = "in"
    OUT = "out"
    ALL = "all"


def tree_leaves(tree) -> list:
    """The leaves of a value column (see ``tree_map``), in order."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def _tree_unflatten_like(tree, leaves: list):
    """``tree``'s structure with ``leaves`` (consumed in order) as leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of a value column: a leaf, or a tuple,
    list or dict of leaves (nested).  Stands in for ``jax.tree.map`` over
    edge values; ``None`` maps to ``None``."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)
        )
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


# value columns take the JAX package's default (32-bit) widths
_CANONICAL = {
    torch.int64: torch.int32,
    torch.float64: torch.float32,
    torch.complex128: torch.complex64,
}


def _value_tensor(x, device: torch.device) -> torch.Tensor:
    """A value leaf on ``device`` at the width the JAX package gives it
    (64-bit leaves become 32-bit, as jnp.asarray makes them)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=_CANONICAL.get(x.dtype, x.dtype))


def _tensor(x, dtype: Optional[torch.dtype], device: torch.device) -> torch.Tensor:
    """``x`` (array or tensor) on ``device``, cast to ``dtype`` unless None."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype or x.dtype)


@dataclasses.dataclass(frozen=True)
class EdgeBatch:
    """A padded COO micro-batch of edge events (equal-length 1-D tensors).

      src, dst: interned (dense) vertex ids, int32.
      mask:     validity; False rows are padding and must be ignored.
      val:      optional edge values (32-bit leaves, as in the JAX package);
                ``None`` for NullValue graphs.
      time:     optional event-time timestamps, int64 ms.
      sign:     optional +1/-1 event sign, int8; ``None`` = all additions.
    """

    src: torch.Tensor
    dst: torch.Tensor
    mask: torch.Tensor
    val: Optional[object] = None
    time: Optional[torch.Tensor] = None
    sign: Optional[torch.Tensor] = None

    # ---- construction -------------------------------------------------------

    @staticmethod
    def from_arrays(
        src,
        dst,
        val=None,
        time=None,
        sign=None,
        mask=None,
        pad_to: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "EdgeBatch":
        """Build a batch from host arrays or tensors on ``device``,
        optionally padding to a capacity."""
        dev = resolve_device(device)
        src = _tensor(src, torch.int32, dev)
        dst = _tensor(dst, torch.int32, dev)
        n = src.shape[0]
        if mask is None:
            mask = torch.ones((n,), dtype=torch.bool, device=dev)
        else:
            mask = _tensor(mask, torch.bool, dev)
        if val is not None:
            val = tree_map(lambda a: _value_tensor(a, dev), val)
        if time is not None:
            time = _tensor(time, torch.int64, dev)
        if sign is not None:
            sign = _tensor(sign, torch.int8, dev)
        batch = EdgeBatch(src=src, dst=dst, mask=mask, val=val, time=time, sign=sign)
        if pad_to is not None and pad_to != n:
            batch = batch.pad_to(pad_to)
        return batch

    @staticmethod
    def from_host_arrays(src, dst, pad_to: Optional[int] = None) -> "EdgeBatch":
        """Host-plane batch: contiguous int32 CPU tensors sharing the numpy
        arrays' memory, for value-less untimed sources whose consumer is the
        host pane cutter (core/windows.py reads every field back to numpy
        before any device work)."""
        src = np.ascontiguousarray(src, dtype=np.int32)
        dst = np.ascontiguousarray(dst, dtype=np.int32)
        n = src.shape[0]
        if dst.shape[0] != n:
            raise ValueError("src/dst length mismatch")
        size = n if pad_to is None else int(pad_to)
        if size < n:
            raise ValueError(f"cannot pad batch of size {n} down to {size}")
        mask = np.zeros(size, bool)
        mask[:n] = True
        if size != n:
            pad = size - n
            src = np.concatenate([src, np.zeros(pad, np.int32)])
            dst = np.concatenate([dst, np.zeros(pad, np.int32)])
        return EdgeBatch(
            src=torch.from_numpy(src),
            dst=torch.from_numpy(dst),
            mask=torch.from_numpy(mask),
        )

    @staticmethod
    def from_edges(
        edges: Sequence[tuple],
        pad_to: Optional[int] = None,
        with_time: bool = False,
        device: DeviceLike = None,
    ) -> "EdgeBatch":
        """Build from a list of (src, dst[, val[, time]]) tuples (host-side helper)."""
        if not edges:
            dev = resolve_device(device)
            size = pad_to or 0
            return EdgeBatch(
                src=torch.zeros((size,), dtype=torch.int32, device=dev),
                dst=torch.zeros((size,), dtype=torch.int32, device=dev),
                mask=torch.zeros((size,), dtype=torch.bool, device=dev),
            )
        src = np.array([e[0] for e in edges], dtype=np.int32)
        dst = np.array([e[1] for e in edges], dtype=np.int32)
        val = None
        time = None
        if len(edges[0]) > 2:
            first = edges[0][2]
            if isinstance(first, tuple):
                # tuple-valued edges become a tuple of columns
                val = tuple(
                    np.array([e[2][k] for e in edges]) for k in range(len(first))
                )
            else:
                val = np.array([e[2] for e in edges])
        if with_time and len(edges[0]) > 3:
            time = np.array([e[3] for e in edges], dtype=np.int64)
        return EdgeBatch.from_arrays(
            src, dst, val=val, time=time, pad_to=pad_to, device=device
        )

    # ---- shape/padding ------------------------------------------------------

    @property
    def size(self) -> int:
        """Static batch capacity B (including padding)."""
        return int(self.src.shape[0])

    def pad_to(self, capacity: int) -> "EdgeBatch":
        n = self.size
        if capacity < n:
            raise ValueError(f"cannot pad batch of size {n} down to {capacity}")
        if capacity == n:
            return self
        pad = capacity - n

        def _pad1(x, fill=0):
            tail = torch.full(
                (pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device
            )
            return torch.cat([x, tail])

        def _pad(x, fill=0):
            return tree_map(lambda leaf: _pad1(leaf, fill), x)

        return EdgeBatch(
            src=_pad1(self.src),
            dst=_pad1(self.dst),
            mask=_pad1(self.mask, False),
            val=_pad(self.val),
            time=_pad(self.time),
            sign=_pad(self.sign, fill=1),
        )

    def num_valid(self) -> torch.Tensor:
        """Number of valid rows, an int32 scalar tensor."""
        return self.mask.sum(dtype=torch.int32)

    # ---- transforms used by the stream API ---------------------------------

    def reversed(self) -> "EdgeBatch":
        """Swap src/dst (reference: SimpleEdgeStream.java:328)."""
        return dataclasses.replace(self, src=self.dst, dst=self.src)

    def replace(self, **kw) -> "EdgeBatch":
        return dataclasses.replace(self, **kw)

    def concat(self, other: "EdgeBatch") -> "EdgeBatch":
        """Rows of ``self`` then ``other``.  A field present on one side
        only gets its semantic default on the other (sign: +1 for "all
        additions", val: zeros); a one-sided time is an error."""

        def _cat(a, b, field, fill=None):
            if a is None and b is None:
                return None
            if (a is None) != (b is None):
                if fill is None:
                    raise ValueError(f"cannot concat batches where only one side has {field!r}")
                length = (self.src if a is None else other.src).shape[0]

                def synth(leaf):
                    return torch.full(
                        (length,) + tuple(leaf.shape[1:]), fill, dtype=leaf.dtype, device=leaf.device
                    )

                if a is None:
                    a = tree_map(synth, b)
                else:
                    b = tree_map(synth, a)
            return tree_map(lambda x, y: torch.cat([x, y]), a, b)

        return EdgeBatch(
            src=torch.cat([self.src, other.src]),
            dst=torch.cat([self.dst, other.dst]),
            mask=torch.cat([self.mask, other.mask]),
            val=_cat(self.val, other.val, "val", fill=0),
            time=_cat(self.time, other.time, "time"),
            sign=_cat(self.sign, other.sign, "sign", fill=1),
        )

    # ---- host-side inspection ----------------------------------------------

    def to_tuples(self) -> list:
        """Valid edges as host tuples, ``(src, dst)`` or ``(src, dst,
        val)``; a tuple/dict-valued ``val`` renders as a nested value per
        row (Flink's Tuple CSV rendering)."""
        src = self.src.cpu().tolist()
        dst = self.dst.cpu().tolist()
        mask = self.mask.cpu().tolist()
        leaves = [leaf.cpu().tolist() for leaf in tree_leaves(self.val)]
        out = []
        for i, ok in enumerate(mask):
            if not ok:
                continue
            if self.val is None:
                out.append((src[i], dst[i]))
            else:
                out.append((src[i], dst[i], _tree_unflatten_like(self.val, [leaf[i] for leaf in leaves])))
        return out
