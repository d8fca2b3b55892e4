"""Bipartiteness summary view with the reference's Candidates rendering.

Port of ``gelly_streaming_tpu/summaries/candidates.py`` (reference:
summaries/Candidates.java, ``(Boolean, TreeMap<componentId, Map<vertexId,
SignedVertex>>)``; any conflict collapses to ``(false,{})``).  The summary
is the doubled-vertex parity union-find of ``ops/unionfind.py``; this is
the host view that renders it in Candidates' string format, e.g.
``(true,{1={1=(1,true), 2=(2,false)}})``: component ids are the
component's smallest vertex, and a sign is true iff the vertex lies on the
side of that vertex (the reference's min-endpoint-positive convention,
BipartitenessCheck.java:52-59).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.ops import unionfind as uf


class Candidates:
    def __init__(self, parent2: torch.Tensor, seen: torch.Tensor):
        self.parent2 = parent2  # int32[2C] doubled-space union-find
        self.seen = seen  # bool[C]

    @property
    def capacity(self) -> int:
        return int(self.parent2.shape[0]) // 2

    def is_bipartite(self) -> bool:
        return bool(uf.is_bipartite(self.parent2, self.seen))

    def components(self) -> Dict[int, Dict[int, Tuple[int, bool]]]:
        """component-min-vertex -> {vertex -> (vertex, same_side_as_min)}."""
        p = uf.compressed(self.parent2).cpu().numpy()
        seen = np.nonzero(self.seen.cpu().numpy())[0]
        comp_key = np.minimum(p[2 * seen], p[2 * seen + 1])
        comps: Dict[int, Dict[int, Tuple[int, bool]]] = {}
        for key in np.unique(comp_key):
            members = seen[comp_key == key]
            m = int(members.min())
            m_side = p[2 * m]
            comps[m] = {int(v): (int(v), bool(p[2 * v] == m_side)) for v in members}
        return comps

    def __str__(self) -> str:
        if not self.is_bipartite():
            return "(false,{})"
        comps = self.components()
        comp_strs = []
        for key in sorted(comps):
            inner = ", ".join(
                f"{v}=({v},{'true' if side else 'false'})" for v, (_, side) in sorted(comps[key].items())
            )
            comp_strs.append(f"{key}={{{inner}}}")
        return "(true,{" + ", ".join(comp_strs) + "})"
