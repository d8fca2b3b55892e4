"""Checkpoint/resume for operator state.

Port of ``gelly_streaming_tpu/utils/checkpoint.py``.  A state is a tree of
tensors and numpy arrays (tuples, NamedTuples, lists, dicts; ``None`` holds
no leaf); ``save_state`` flattens it in the JAX package's leaf order
(NamedTuple fields and tuple items in order, dict keys sorted) and stores
the leaves as ``leaf_0``, ``leaf_1``, ... of an ``.npz``, so a snapshot the
port writes holds the same arrays under the same names as the JAX
package's at the same stream position.  ``__treedef__`` holds the port's
own structure string with the leaves' shapes and dtypes; ``load_state``
refuses a snapshot whose layout differs from ``like``'s before it reads a
leaf.  ``interop.snapshot_from_jax`` reads a snapshot the JAX package wrote.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def _normalize(path: str) -> str:
    """np.savez appends .npz to bare paths; make that explicit everywhere so
    exists()-checks and load paths agree with what save actually wrote."""
    return path if path.endswith(".npz") else path + ".npz"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, bool, int, float))


def flatten(state: Any) -> Tuple[List[Any], str]:
    """(leaves in the JAX package's order, the structure string)."""
    leaves: List[Any] = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if _is_leaf(x):
            leaves.append(x)
            return "*"
        if hasattr(x, "_fields"):  # NamedTuple
            return f"{type(x).__name__}({','.join(f'{k}={walk(v)}' for k, v in zip(x._fields, x))})"
        if isinstance(x, (tuple, list)):
            inner = ",".join(walk(v) for v in x)
            return f"({inner},)" if isinstance(x, tuple) else f"[{inner}]"
        if isinstance(x, dict):
            return "{" + ",".join(f"{k!r}:{walk(x[k])}" for k in sorted(x)) + "}"
        raise TypeError(f"cannot checkpoint a {type(x).__name__} leaf")

    return leaves, walk(state)


def unflatten_like(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with ``leaves`` (in flatten's order) as leaves."""
    it = iter(leaves)

    def build(x):
        if x is None:
            return None
        if _is_leaf(x):
            return next(it)
        if hasattr(x, "_fields"):
            return type(x)(*(build(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(build(v) for v in x)
        out = {k: build(x[k]) for k in sorted(x)}
        return {k: out[k] for k in x}

    return build(like)


def dtype_name(leaf) -> str:
    """numpy's name for a leaf's dtype ("int32", "bool", "float32", ...)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _shape(leaf) -> list:
    return list(leaf.shape) if isinstance(leaf, torch.Tensor) else list(np.shape(leaf))


def host_array(leaf) -> np.ndarray:
    """A leaf as a host numpy array (a tensor copied off its device)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _treedef_token(state: Any) -> dict:
    """A stable, comparable description of the state's layout for validation."""
    leaves, structure = flatten(state)
    return {
        "treedef": structure,
        "shapes": [_shape(l) for l in leaves],
        "dtypes": [dtype_name(l) for l in leaves],
    }


def save_state(path: str, state: Any) -> None:
    """Snapshot a state tree to ``path`` (.npz), atomically: a crash
    mid-save must never destroy the previous good snapshot."""
    path = _normalize(path)
    leaves, _ = flatten(state)
    arrays = {f"leaf_{i}": host_array(leaf) for i, leaf in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    token = np.frombuffer(json.dumps(_treedef_token(state)).encode(), dtype=np.uint8)
    np.savez(tmp, __treedef__=token, **arrays)
    os.replace(tmp, path)


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(_normalize(path))


def restore_leaves(stored: List[np.ndarray], like_leaves: List[Any]) -> List[Any]:
    """Stored arrays as ``like``'s leaves: tensors on the like leaf's device
    and dtype, numpy leaves as numpy, Python scalars as Python scalars."""
    out = []
    for s, l in zip(stored, like_leaves):
        if isinstance(l, torch.Tensor):
            out.append(torch.from_numpy(np.array(s)).to(device=l.device, dtype=l.dtype))
        elif isinstance(l, (np.ndarray, np.generic)):
            out.append(np.asarray(s, dtype=np.asarray(l).dtype))
        else:
            out.append(type(l)(np.asarray(s).item()))
    return out


def load_state(path: str, like: Any) -> Any:
    """Restore a snapshot into the structure of ``like``; ``ValueError``
    when its layout differs, before any leaf is read."""
    path = _normalize(path)
    like_leaves, _ = flatten(like)
    with np.load(path) as data:
        token = json.loads(bytes(data["__treedef__"]).decode())
        expect = _treedef_token(like)
        if token != expect:
            raise ValueError(f"checkpoint structure mismatch: stored {token}, expected {expect}")
        stored = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
    return unflatten_like(like, restore_leaves(stored, like_leaves))


def per_job_file(path: str, job_id: str) -> str:
    """Per-job snapshot file under a shared checkpoint prefix: the prefix
    keyed with the job id, normalized so the .npz extension stays terminal
    and an id with path separators cannot escape the checkpoint directory."""
    base = path[: -len(".npz")] if path.endswith(".npz") else path
    safe = re.sub(r"[^A-Za-z0-9._-]", "_", str(job_id))
    return f"{base}.job_{safe}.npz"


def tree_map_leaves(fn: Callable, state: Any) -> Any:
    """``state`` with ``fn`` applied to every leaf (the flatten's walk)."""
    leaves, _ = flatten(state)
    return unflatten_like(state, [fn(l) for l in leaves])
