"""Union-find summary with the reference DisjointSet's API.

Port of ``gelly_streaming_tpu/summaries/disjoint_set.py``.  The summary is
a pair of dense tensors on one device (``parent: int32[C]``, ``seen:
bool[C]``) folded by ``ops/unionfind.py``; this class is the host-facing
wrapper with the reference's object API (union, merge, find, the
``{root=[members]}`` string).  ``union``/``union_batch``/``merge`` update
the wrapper's tensors in place; the queries never change them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import unionfind as uf


def _ids(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.int32).contiguous()


class DisjointSet:
    """Host wrapper over (parent, seen) tensors; one component = one root."""

    def __init__(self, capacity: int, parent=None, seen=None, device: DeviceLike = None):
        self.capacity = capacity
        dev = parent.device if parent is not None else resolve_device(device)
        self.parent = uf.init_parent(capacity, dev) if parent is None else parent
        self.seen = torch.zeros((capacity,), dtype=torch.bool, device=dev) if seen is None else seen

    @property
    def device(self) -> torch.device:
        return self.parent.device

    # ---- mutation -----------------------------------------------------------

    def union(self, a: int, b: int) -> None:
        """Single-edge union (reference: DisjointSet.java:92-118)."""
        self.union_batch([a], [b])

    def union_batch(self, src, dst, mask=None) -> None:
        """Batched union of an edge micro-batch (arrays or tensors)."""
        dev = self.device
        m = None
        if mask is not None:
            m = (mask if isinstance(mask, torch.Tensor) else torch.from_numpy(np.asarray(mask)))
            m = m.to(device=dev, dtype=torch.bool).contiguous()
        uf.union_edges_with_seen(self.parent, self.seen, _ids(src, dev), _ids(dst, dev), m)

    def merge(self, other: "DisjointSet") -> None:
        """Combine with another summary (reference: DisjointSet.java:127-131)."""
        self.parent = uf.merge_parents(self.parent, other.parent)
        self.seen = self.seen | other.seen

    # ---- queries ------------------------------------------------------------

    def _roots(self) -> np.ndarray:
        return uf.compressed(self.parent).cpu().numpy()

    def find(self, v: int) -> int:
        """Root of v's component (DisjointSet.java:66-81)."""
        return int(self._roots()[v])

    def get_matches(self) -> Dict[int, int]:
        """vertex -> root for all seen vertices (DisjointSet.java:40-46)."""
        p = self._roots()
        return {int(v): int(p[v]) for v in np.nonzero(self.seen.cpu().numpy())[0]}

    def components(self) -> Dict[int, List[int]]:
        """root -> sorted member list, for seen vertices only."""
        p = self._roots()
        comps: Dict[int, List[int]] = {}
        for v in np.nonzero(self.seen.cpu().numpy())[0]:
            comps.setdefault(int(p[v]), []).append(int(v))
        return comps

    def __str__(self) -> str:
        """The Java Map<R, List<R>> rendering (DisjointSet.java:134-150),
        e.g. ``{1=[1, 2, 3, 5], 6=[6, 7], 8=[8, 9]}``."""
        parts = [
            f"{root}=[{', '.join(str(v) for v in members)}]"
            for root, members in sorted(self.components().items())
        ]
        return "{" + ", ".join(parts) + "}"
