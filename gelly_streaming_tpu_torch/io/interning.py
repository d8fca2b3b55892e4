"""Vertex-id interning: arbitrary external ids -> dense [0, capacity) indices.

The reference keys operators by raw vertex ids through Flink's hash partitioner
(any Comparable key).  Dense device state instead requires a bounded id space,
and out-of-range ids silently corrupt device scatter/gather state — so the
interner is the framework's bounds guard (SURVEY.md §7 "interning" under the
central design problem).
"""

from __future__ import annotations

from typing import Dict, Hashable, List

import numpy as np


class VertexInterner:
    """Host-side incremental interner with reverse lookup.

    ``intern_ints`` vectorizes the common integer-id case; ``intern`` accepts
    any hashable ids (strings etc.).  Raises when capacity would be exceeded —
    loudly, because the device alternative is silent corruption.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._fwd: Dict[Hashable, int] = {}
        self._rev: List[Hashable] = []

    def __len__(self) -> int:
        return len(self._rev)

    def intern(self, ids) -> np.ndarray:
        out = np.empty(len(ids), np.int32)
        fwd = self._fwd
        rev = self._rev
        for i, x in enumerate(ids):
            idx = fwd.get(x)
            if idx is None:
                idx = len(rev)
                if idx >= self.capacity:
                    raise ValueError(
                        f"vertex capacity {self.capacity} exceeded; raise "
                        f"StreamConfig.vertex_capacity"
                    )
                fwd[x] = idx
                rev.append(x)
            out[i] = idx
        return out

    def intern_ints(self, ids: np.ndarray) -> np.ndarray:
        """Vectorized interning for integer ids (dict only touched for new ids)."""
        ids = np.asarray(ids)
        uniq, first_pos = np.unique(ids, return_index=True)
        # Assign new dense ids in first-arrival order (stable across batchings).
        uniq = uniq[np.argsort(first_pos)]
        new = [u for u in uniq.tolist() if u not in self._fwd]
        for u in new:
            idx = len(self._rev)
            if idx >= self.capacity:
                raise ValueError(
                    f"vertex capacity {self.capacity} exceeded; raise "
                    f"StreamConfig.vertex_capacity"
                )
            self._fwd[u] = idx
            self._rev.append(u)
        try:
            lut_keys = np.fromiter(
                self._fwd.keys(), dtype=ids.dtype, count=len(self._fwd)
            )
        except (ValueError, TypeError):
            # mixed key types (e.g. strings interned earlier): generic path
            return self.intern(ids.tolist())
        lut_vals = np.fromiter(self._fwd.values(), dtype=np.int32, count=len(self._fwd))
        order = np.argsort(lut_keys)
        pos = np.searchsorted(lut_keys[order], ids)
        return lut_vals[order][pos].astype(np.int32)

    def lookup(self, idx: int) -> Hashable:
        return self._rev[idx]

    def lookup_many(self, idxs) -> List[Hashable]:
        return [self._rev[i] for i in idxs]


class IdentityInterner:
    """No-op interner for graphs whose ids are already dense ints < capacity
    (the test fixtures and generated benchmark graphs).  Still bounds-checks."""

    def __init__(self, capacity: int):
        self.capacity = capacity

    def intern_ints(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        if len(ids) and (ids.min() < 0 or ids.max() >= self.capacity):
            raise ValueError(
                f"vertex id out of range [0, {self.capacity}); use VertexInterner"
            )
        return ids.astype(np.int32)

    def lookup(self, idx: int) -> int:
        return idx
