"""Iterative connected components: label propagation on the device.

Port of ``gelly_streaming_tpu/library/iterative_cc.py`` (reference:
example/IterativeConnectedComponents.java:45-167, a Flink feedback
iteration whose emitted (vertex, component) records re-enter the keyed
flatMap).  The feedback loop collapses into the union-find fixed point
(``ops/spmv.cc_fixpoint``: the CUDA ``union_kernel`` on the GPU) run per
micro-batch against persistent labels, with the same converged labels
(the smallest id of each component).  The output is the reference's: a
continuous (vertex, componentId) stream re-emitting the vertices a batch
relabelled or first saw.
"""

from __future__ import annotations

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.output import OutputStream, RecordBlock
from gelly_streaming_tpu_torch.ops import spmv
from gelly_streaming_tpu_torch.ops import unionfind as uf


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a CPU tensor the next batch updates)."""
    return t.to("cpu", copy=True).numpy()


class IterativeConnectedComponents:
    """Continuous (vertex, component) stream with on-device label propagation."""

    def __init__(self):
        # the min-min semiring fixpoint of the kernel core: it updates the
        # labels in place, and run() keeps the previous batch's labels as a
        # host copy
        self._kernel = spmv.cc_fixpoint

    def run(self, stream) -> OutputStream:
        cfg = stream.cfg

        def blocks():
            parent = uf.init_parent(cfg.vertex_capacity, stream.device)
            seen = torch.zeros((cfg.vertex_capacity,), dtype=torch.bool, device=stream.device)
            prev = _host(parent)
            prev_seen = np.zeros((cfg.vertex_capacity,), bool)
            for batch in stream.batches():
                parent, seen = self._kernel(parent, seen, batch.src, batch.dst, batch.mask)
                p_h, s_h = _host(parent), _host(seen)
                # re-emit every vertex whose label or membership changed: the
                # observable effect of the reference's feedback re-emissions
                # (IterativeConnectedComponents.java:116-167), one block a batch
                changed = (s_h & ~prev_seen) | (s_h & (p_h != prev))
                idx = np.nonzero(changed)[0]
                if len(idx):
                    yield RecordBlock((idx.astype(np.int64), p_h[idx].astype(np.int64)))
                prev, prev_seen = p_h, s_h
            self.final_labels = _host(parent)

        return OutputStream(blocks_fn=blocks)
