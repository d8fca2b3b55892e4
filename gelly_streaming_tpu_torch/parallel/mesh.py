"""Device mesh, vertex-space partitioning and the mesh collectives.

Port of ``gelly_streaming_tpu/parallel/mesh.py``.  The JAX plane is one
process driving S devices through ``shard_map``: a 1-D mesh over a
``shards`` axis, collectives (``all_to_all``, ``all_gather``, ``pmin``,
``pmax``, ``psum``) inside one program.  The port's counterpart is also
one process, a single controller:

* a ``Mesh`` is an ordered tuple of S shard devices on one ``shards``
  axis; a shard's state is a tensor on its own device, held in a
  per-shard list;
* the collectives are plain functions over such lists.  They move data by
  copies between shard tensors (peer copies across GPUs; shards that share
  a device read each other's tensors in place, and a gathered or reduced
  result is one tensor a device, shared by its shards: read it, do not
  write it), and their elementwise reductions run the ``slab_fold``
  kernel (``ops/routing.py``);
* ownership is ``vertex_id % num_shards`` over the dense interned id space,
  vertex g at block row g // S (the analog of Flink's key-group hashing).

``torch.distributed`` / NCCL process groups are the counterpart of the JAX
package's multi-process plane (``parallel/multihost.py``,
``jax.distributed``) and come with that module.  ``mesh_cache_key`` and
``shard_map`` have no counterpart here: nothing is traced or compiled per
mesh, each shard's work is enqueued eagerly on its device.

``local_devices(device)`` is what a process may shard over: every visible
GPU for a CUDA stream; for a CPU stream ``host_device_count()`` copies of
the CPU device (1 unless ``set_host_device_count(n)`` is called: the
counterpart of the ``--xla_force_host_platform_device_count`` the JAX
package's tests run under).  ``make_mesh(n, devices=...)`` takes an
explicit list, which may repeat a device (several shards on one GPU, as
the chip smoke runs them); the aggregation runtime never puts two shards
on one GPU by itself.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

SHARD_AXIS = "shards"

_HOST_DEVICE_COUNT = 1


def set_host_device_count(n: int) -> int:
    """Set how many shards a CPU stream may spread over; returns the old
    count."""
    global _HOST_DEVICE_COUNT
    if n < 1:
        raise ValueError("the host device count must be >= 1")
    old, _HOST_DEVICE_COUNT = _HOST_DEVICE_COUNT, int(n)
    return old


def host_device_count() -> int:
    return _HOST_DEVICE_COUNT


def local_devices(device=None) -> List[torch.device]:
    """The devices a stream on ``device`` may shard over (``None``: CUDA)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev.type == "cpu":
        return [torch.device("cpu")] * host_device_count()
    raise ValueError(f"unsupported device {dev}")


class Mesh:
    """An ordered tuple of shard devices on one ``shards`` axis."""

    axis_names = (SHARD_AXIS,)

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = tuple(torch.device(d) for d in devices)
        groups: Dict[torch.device, List[int]] = {}
        for s, d in enumerate(self.devices):
            groups.setdefault(d, []).append(s)
        #: (device, its shard indices) in first-shard order
        self.groups = tuple((d, tuple(ix)) for d, ix in groups.items())

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Where a replicated result is kept: shard 0's device."""
        return self.devices[0]

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


def make_mesh(num_shards: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first ``num_shards`` devices (default: all of
    ``local_devices()``); ``devices`` may repeat a device."""
    devs = list(devices if devices is not None else local_devices())
    n = num_shards or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} shards but only {len(devs)} devices")
    return Mesh(devs[:n])


def owner_of(vertex_ids: np.ndarray, num_shards: int) -> np.ndarray:
    """Owning shard of each vertex (dense interned ids: modulo spreads load)."""
    return vertex_ids % num_shards


def block_rows(capacity: int, num_shards: int) -> int:
    """Rows of one owner block of a [capacity] modulo-sharded state."""
    if capacity % num_shards:
        raise ValueError(f"vertex capacity {capacity} must divide over {num_shards} shards")
    return capacity // num_shards


# ---------------------------------------------------------------------------
# collectives over per-shard lists


def per_device(mesh: Mesh, fn) -> Dict[torch.device, object]:
    """``{device: fn(device)}`` over the mesh's distinct devices."""
    return {d: fn(d) for d, _ in mesh.groups}


def all_to_all(mesh: Mesh, send: Sequence) -> List[List[torch.Tensor]]:
    """``send[s][r]`` is what shard s sends shard r (``send[s]``: a tensor
    with a leading axis of S, or a list of S tensors); returns ``recv`` with
    ``recv[r][s] == send[s][r]`` on shard r's device (in place where the two
    shards share a device)."""
    n = mesh.size
    return [[send[s][r].to(mesh.devices[r], non_blocking=True) for s in range(n)] for r in range(n)]


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``[S, ...]`` stack of every shard's ``xs[s]``, for each shard (one
    tensor a device, shared by its shards)."""
    out = per_device(mesh, lambda d: torch.stack([x.to(d, non_blocking=True) for x in xs]))
    return [out[d] for d in mesh.devices]


def _reduce(mesh: Mesh, xs: Sequence[torch.Tensor], op: str, flags=None) -> List[torch.Tensor]:
    from gelly_streaming_tpu_torch.ops import routing as rk

    out = {}
    for d, ix in mesh.groups:
        first = xs[ix[0]]
        acc = first.to(d, copy=True).reshape(-1)
        rest = [xs[s].reshape(-1) for s in ix[1:]] + [
            xs[s].to(d, non_blocking=True).reshape(-1) for s in range(mesh.size) if mesh.devices[s] != d
        ]
        rk.slab_fold(acc, rest, op, None if flags is None else flags[d])
        out[d] = acc.view(first.shape)
    return [out[d] for d in mesh.devices]


def pmin(mesh: Mesh, xs: Sequence[torch.Tensor], flags=None) -> List[torch.Tensor]:
    """Elementwise min of every shard's int32 ``xs[s]``, for each shard (one
    tensor a device).  ``flags``: ``{device: int32[1]}`` that grow where the
    result differs from that device's first shard's input, or None."""
    return _reduce(mesh, xs, "min", flags)


def pmax(mesh: Mesh, xs: Sequence[torch.Tensor], flags=None) -> List[torch.Tensor]:
    """Elementwise max of every shard's int32 ``xs[s]`` (see ``pmin``)."""
    return _reduce(mesh, xs, "max", flags)


def psum(mesh: Mesh, xs: Sequence[torch.Tensor], flags=None) -> List[torch.Tensor]:
    """Elementwise int32 (wrapping) sum of every shard's ``xs[s]`` (see
    ``pmin``)."""
    return _reduce(mesh, xs, "add", flags)


#: host reads of device counters by the collectives' loops (one a device
#: a round) since the last reset: the mesh plane's host syncs
HOST_SYNCS = {"reads": 0}


def read_host(tensors: Dict[torch.device, torch.Tensor]) -> List[list]:
    """Every device's small int tensor on the host (one read a device,
    counted in ``HOST_SYNCS``)."""
    HOST_SYNCS["reads"] += len(tensors)
    return [t.tolist() for t in tensors.values()]


def read_flags(flags: Dict[torch.device, torch.Tensor]) -> int:
    """The sum of the per-device counters (``read_host``)."""
    return sum(sum(v) for v in read_host(flags))
