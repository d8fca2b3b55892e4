"""Windowed k-core decomposition over sliced edge streams.

Port of ``gelly_streaming_tpu/library/kcore.py``.  Core numbers per closed
window via the iterative h-index fixed point: each vertex's estimate
starts at its degree, then is repeatedly set to the h-index of its
neighbours' estimates; the sequence is non-increasing and converges to the
core number (Lü et al., "The H-index of a network node", 2016).  The
window's neighbourhoods are degree-bucketed [K, D] rows
(``ops/neighborhoods.build_buckets``), and a round updates the buckets in
order until a round changes nothing: ``ops/spmv._kcore_fixpoint``, on the
GPU every round of a pane in one launch (``csrc/kcore.cu``), on the CPU
the per-bucket loop of its twin.

The window graph is treated as simple and undirected: edges are
canonicalized and deduplicated per pane on the host, self-loops dropped
(the standard k-core contract).  ``slide_ms`` composes through the shared
pane dispatch.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.output import OutputStream, RecordBlock
from gelly_streaming_tpu_torch.core.windows import pow2, windowed_panes
from gelly_streaming_tpu_torch.ops import neighborhoods as nbh_ops
from gelly_streaming_tpu_torch.ops import spmv


def simple_pane_edges(pane, capacity: int) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(src, dst, msk) of the pane's simple undirected graph, both
    directions, padded to a power of two; None when no edge is left after
    the canonical dedupe and the self-loop drop (the host's part of a
    window)."""
    a = np.minimum(pane.src, pane.dst).astype(np.int64)
    b = np.maximum(pane.src, pane.dst).astype(np.int64)
    keep = a != b
    uniq = np.unique(a[keep] * capacity + b[keep])
    us, ud = (uniq // capacity).astype(np.int32), (uniq % capacity).astype(np.int32)
    e2 = 2 * len(us)
    if e2 == 0:
        return None
    e_pad = pow2(e2)
    src = np.zeros((e_pad,), np.int32)
    dst = np.zeros((e_pad,), np.int32)
    msk = np.zeros((e_pad,), bool)
    src[: len(us)], src[len(us) : e2] = us, ud
    dst[: len(us)], dst[len(us) : e2] = ud, us
    msk[:e2] = True
    return src, dst, msk


def pane_cores(src, dst, msk, capacity: int, device, max_rounds: Optional[int] = None,
               round_fn=None) -> Tuple[torch.Tensor, int]:
    """(core numbers int32 [capacity], rounds run) of one pane's simple
    graph from ``simple_pane_edges``: ``spmv._kcore_fixpoint`` (one launch
    and one header read a pane on the GPU), or with ``round_fn(c, keys,
    nbrs, valid)``, which updates c in place (``spmv.kcore_round``, or a
    twin), a host loop of rounds of one call a bucket.  Raises when
    ``max_rounds`` (default: the directed edge count + 1) runs out before
    a round changes nothing."""
    s, d, m = (torch.from_numpy(a).to(device) for a in (src, dst, msk))
    buckets = [bkt for bkt in nbh_ops.build_buckets(s, d, None, m) if bkt.num_keys > 0]
    # estimates start at degree (an upper bound of the core number);
    # off-window vertices stay 0.  Counting incidence is the kernel core's
    # plus-one scatter.
    c = spmv.scatter_into(spmv.PLUS_ONE, capacity, s, torch.ones_like(s), m)
    bound = max_rounds if max_rounds is not None else int(np.count_nonzero(msk)) + 1
    rows = [(b.keys, b.nbrs, b.valid) for b in buckets]
    if round_fn is None:
        rounds, converged = spmv._kcore_fixpoint(c, rows, bound)  # rows of distinct neighbours
    else:
        rounds, converged = spmv.kcore_fixpoint_plain(c, rows, bound, round_fn)
    if converged:
        return c, rounds
    raise RuntimeError(
        f"k-core h-index did not converge within {bound} rounds; "
        "raise max_rounds (default iterates to the fixed point)"
    )


def core_numbers_windows(
    stream,
    window_ms: int,
    slide_ms: Optional[int] = None,
    max_rounds: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """(vertex ids [V], core numbers [V]) per closed window.

    The default iterates to the exact fixed point (bounded by the window's
    edge count: corrections can propagate one hop per round, e.g. along a
    long path).  A user ``max_rounds`` that runs out before convergence
    raises rather than yielding silently over-estimated cores."""
    capacity = stream.cfg.vertex_capacity
    for pane in windowed_panes(stream, window_ms, slide_ms):
        if pane.num_edges == 0:
            continue
        simple = simple_pane_edges(pane, capacity)
        if simple is None:
            continue
        c, _ = pane_cores(*simple, capacity, stream.device, max_rounds)
        c_h = c.cpu().numpy()
        vids = np.nonzero(c_h > 0)[0]
        yield vids, c_h[vids]


def windowed_kcore(
    stream,
    window_ms: int,
    slide_ms: Optional[int] = None,
) -> OutputStream:
    """(vertex, core number) records per closed window."""

    def blocks() -> Iterator[RecordBlock]:
        for vids, cores in core_numbers_windows(stream, window_ms, slide_ms):
            yield RecordBlock((vids.astype(np.int64), cores.astype(np.int64)))

    return OutputStream(blocks_fn=blocks)
