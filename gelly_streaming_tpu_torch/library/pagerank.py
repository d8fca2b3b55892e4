"""Windowed PageRank over sliced edge streams.

Port of ``gelly_streaming_tpu/library/pagerank.py``.  Each closed pane's
subgraph becomes dense [C]-indexed tensors and the damped power iteration
runs on the kernel core's plus-times semiring (``ops/spmv.
pagerank_fixpoint``: one ``pagerank_fixpoint_launch`` of ``csrc/spmv.cu``
a window on the GPU).  Push and pull give the same bits on the card.

Semantics per window (the damped random surfer restricted to the pane's
subgraph): vertices = endpoints present in the window; uniform teleport
over those vertices; dangling mass (window vertices with no out-edge)
redistributes uniformly; iterate until the L1 delta drops below ``tol``
or ``max_iters``.  ``slide_ms`` ranks every sliding window through the
shared pane dispatch (``core/windows.windowed_panes``).
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from gelly_streaming_tpu_torch.core.output import OutputStream, RecordBlock
from gelly_streaming_tpu_torch.core.windows import pad_pane_edges, windowed_panes
from gelly_streaming_tpu_torch.ops import spmv


def windowed_pagerank(
    stream,
    window_ms: int,
    slide_ms: Optional[int] = None,
    damping: float = 0.85,
    tol: float = 1e-6,
    max_iters: int = 100,
) -> OutputStream:
    """(vertex, rank) records per closed window (tumbling or sliding).

    Ranks sum to ~1 within each window.  Direction is as-given (each edge
    src -> dst contributes out-mass from src); pre-apply
    ``stream.undirected()`` for symmetric ranking.
    """

    def blocks() -> Iterator[RecordBlock]:
        for vids, ranks in pagerank_windows(
            stream, window_ms, slide_ms, damping=damping, tol=tol, max_iters=max_iters,
        ):
            yield RecordBlock((vids.astype(np.int64), ranks))

    return OutputStream(blocks_fn=blocks)


def pagerank_windows(
    stream,
    window_ms: int,
    slide_ms: Optional[int] = None,
    damping: float = 0.85,
    tol: float = 1e-6,
    max_iters: int = 100,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(vertex ids [V], ranks [V]) arrays per window: the array-level view
    of ``windowed_pagerank``."""
    cfg = stream.cfg
    # every iteration spreads all mass (no frontier), so direction is a
    # whole-run choice, counted by the kernel core's metrics
    use_pull = spmv.resolve_direction(cfg) == "pull"
    for pane in windowed_panes(stream, window_ms, slide_ms):
        if pane.num_edges == 0:
            continue
        src, dst, msk = pad_pane_edges(pane)
        op = spmv.prepare_pane(src, dst, None, msk, cfg.vertex_capacity, device=stream.device)
        r, in_w, _ = spmv.pagerank_fixpoint(op, damping=damping, tol=tol, max_iters=max_iters, use_pull=use_pull)
        r_h, in_h = r.cpu().numpy(), in_w.cpu().numpy()
        vids = np.nonzero(in_h)[0]
        yield vids, r_h[vids]
