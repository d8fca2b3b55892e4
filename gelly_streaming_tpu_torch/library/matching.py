"""Greedy 1/6-approximation streaming weighted matching (centralized).

Port of ``gelly_streaming_tpu/library/matching.py`` (reference:
example/CentralizedWeightedMatching.java:68-108, a parallelism-1 stateful
flatMap): for each edge, the matched edges colliding on either endpoint
are collected; if the new weight exceeds twice their weight sum, they are
evicted (REMOVE events) and the edge admitted (ADD event).  The state is a
pair of dense tensors (partner[C], weight-by-endpoint), so collisions are
two O(1) lookups.  A batch is one ``ops/matching.matching_scan`` call: on
the GPU one C call (``csrc/matching.cu``), on the CPU its twin.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.output import OutputStream
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import matching as matching_ops
from gelly_streaming_tpu_torch.utils.value_types import MatchingEvent


class MatchingState(NamedTuple):
    partner: torch.Tensor  # int32[C]; -1 = unmatched
    weight: torch.Tensor  # float32[C]; weight of the matched edge at this vertex


def init_matching(cfg: StreamConfig, device: DeviceLike = None) -> MatchingState:
    dev = resolve_device(device)
    return MatchingState(
        partner=torch.full((cfg.vertex_capacity,), -1, dtype=torch.int32, device=dev),
        weight=torch.zeros((cfg.vertex_capacity,), dtype=torch.float32, device=dev),
    )


def matching_update(state: MatchingState, src, dst, val, mask):
    """Returns (state, events[B, 3, 4], event_mask[B, 3]); updates the
    state's tensors in place.

    Event slots per edge: [REMOVE collision@src, REMOVE collision@dst, ADD].
    Each event row is (type, src, dst, weight) with type 0=REMOVE, 1=ADD.
    """
    events, emask = matching_ops.matching_scan(state.partner, state.weight, src, dst, val, mask)
    return state, events, emask


class CentralizedWeightedMatching:
    """Continuous MatchingEvent stream (ADD/REMOVE), single-shard stateful op.

    On the GPU the run loop is one batch deep: batch k + 1's scan is
    enqueued before batch k's events become records, and each batch's
    events and emask are copied into pinned host buffers without blocking;
    the loop waits on that copy's CUDA event alone."""

    def run(self, stream) -> OutputStream:
        def emit(e_h, m_h):
            for i, slot in zip(*np.nonzero(m_h)):
                t, s, d, w = e_h[i, slot]
                yield MatchingEvent("ADD" if t > 0.5 else "REMOVE", int(s), int(d), float(w)).as_tuple()

        def records():
            state = init_matching(stream.cfg, stream.device)
            pinned = {}  # two pinned (events, emask) pairs a batch shape, used in turns
            pending = None  # the batch whose copy is in flight: (events, emask, its copy's event)
            for k, batch in enumerate(stream.batches()):
                state, events, emask = matching_update(state, batch.src, batch.dst, batch.val, batch.mask)
                if events.device.type != "cuda":
                    yield from emit(events.numpy(), emask.numpy())
                    continue
                key = (events.shape[0], k % 2)
                if key not in pinned:
                    pinned[key] = (torch.empty(events.shape, dtype=events.dtype, pin_memory=True),
                                   torch.empty(emask.shape, dtype=emask.dtype, pin_memory=True))
                e_h, m_h = pinned[key]
                e_h.copy_(events, non_blocking=True)
                m_h.copy_(emask, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(torch.cuda.current_stream(events.device))
                if pending is not None:
                    pending[2].synchronize()
                    yield from emit(pending[0].numpy(), pending[1].numpy())
                pending = (e_h, m_h, copied)
            if pending is not None:
                pending[2].synchronize()
                yield from emit(pending[0].numpy(), pending[1].numpy())
            self.final_state = state

        return OutputStream(records)

    def matched_edges(self, state: MatchingState):
        """Current matching as canonical (u, v, w) host tuples."""
        partner = state.partner.cpu().numpy()
        weight = state.weight.cpu().numpy()
        out = []
        for u in np.nonzero(partner >= 0)[0]:
            v = partner[u]
            if u < v:
                out.append((int(u), int(v), float(weight[u])))
        return out
