"""Windowed single-source shortest paths over sliced edge streams.

Port of ``gelly_streaming_tpu/library/sssp.py``.  Per closed window the
pane relaxes on the kernel core's min-plus semiring (``ops/spmv.py``):
``dist = min(dist, A^T dist)`` under the direction-optimized push/pull
fixpoint, one ``spmv_fixpoint_launch`` (``csrc/spmv.cu``) a window on the
GPU; the emitted distances are the same in every direction mode.  Edge
values are the weights (valueless streams relax hop counts); negative
weights are rejected.  ``slide_ms`` composes through the shared pane
dispatch (``core/windows.windowed_panes``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.output import OutputStream, RecordBlock
from gelly_streaming_tpu_torch.core.types import tree_leaves
from gelly_streaming_tpu_torch.core.windows import pad_pane_edges, windowed_panes
from gelly_streaming_tpu_torch.ops import spmv


def sssp_windows(
    stream,
    source: int,
    window_ms: int,
    slide_ms: Optional[int] = None,
    max_iters: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(vertex ids [V], distances [V]) per window, reached vertices only.

    ``max_iters`` bounds the relaxation rounds: the default (capacity - 1)
    always converges to exact shortest paths; a smaller value computes
    BOUNDED-HOP distances: shortest paths using at most ``max_iters``
    relaxation rounds, with farther vertices reported unreached."""
    cfg = stream.cfg
    if not 0 <= source < cfg.vertex_capacity:
        # an out-of-range source would read as "nothing reachable"
        raise ValueError(f"source {source} outside [0, {cfg.vertex_capacity})")
    direction = spmv.resolve_direction(cfg)
    threshold = spmv.resolve_threshold(cfg)
    for pane in windowed_panes(stream, window_ms, slide_ms):
        e = pane.num_edges
        if e == 0:
            continue
        src, dst, msk = pad_pane_edges(pane)
        e_pad = len(src)
        if pane.val is not None:
            leaves = tree_leaves(pane.val)
            if len(leaves) != 1 or np.ndim(leaves[0]) != 1:
                # a multi-leaf value has no unambiguous weight
                raise ValueError(
                    "sssp needs a single scalar edge value as the weight; "
                    f"got a {len(leaves)}-leaf value pytree"
                )
            wts = np.asarray(leaves[0], np.float32)
            if (wts < 0).any():
                raise ValueError("sssp requires non-negative edge weights")
            w = np.zeros((e_pad,), np.float32)
            w[:e] = wts
        else:
            w = None  # hop counts (unit weights)
        iters = max_iters if max_iters is not None else cfg.vertex_capacity - 1
        op = spmv.prepare_pane(src, dst, w, msk, cfg.vertex_capacity, device=stream.device)
        dist0 = torch.full((cfg.vertex_capacity,), spmv.MIN_PLUS.identity, dtype=torch.float32, device=stream.device)
        dist0[source] = 0.0
        res = spmv.fixpoint(spmv.MIN_PLUS, op, dist0, max_iters=iters, direction=direction, threshold=threshold)
        d = res.x.cpu().numpy()
        vids = np.nonzero(d < 1e30)[0]
        yield vids, d[vids]


def windowed_sssp(
    stream,
    source: int,
    window_ms: int,
    slide_ms: Optional[int] = None,
    max_iters: Optional[int] = None,
) -> OutputStream:
    """(vertex, distance) records per closed window (tumbling or sliding).

    Directionality is as-given (relaxation follows src -> dst); pre-apply
    ``stream.undirected()`` for symmetric distances.  Unreached vertices
    emit nothing; with a user ``max_iters`` below the window's path depth
    that includes vertices farther than the bound (bounded-hop semantics,
    see sssp_windows).
    """

    def blocks() -> Iterator[RecordBlock]:
        for vids, dists in sssp_windows(stream, source, window_ms, slide_ms, max_iters):
            yield RecordBlock((vids.astype(np.int64), dists))

    return OutputStream(blocks_fn=blocks)
