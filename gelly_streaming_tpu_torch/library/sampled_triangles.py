"""Sampling-based triangle-count estimators (broadcast + incidence routing).

Port of ``gelly_streaming_tpu/library/sampled_triangles.py``.  Reference:
example/BroadcastTriangleCount.java:41-174 broadcasts every edge to all
subtasks, each running ``samples/parallelism`` reservoir triangle samplers
(TriangleSampler :62-135: replace the sampled edge with probability 1/i
:200-207, pick a random third vertex, watch for the two closing edges),
with a parallelism-1 TriangleSummer recombining per-subtask estimates into
``(1/samples) * sum(beta) * |E| * (|V|-2)`` (:138-174).
example/IncidenceSamplingTriangleCount.java:39-242 computes the same
estimator but routes each edge only to the samplers whose sampled edge it
is incident to.

All samplers live in one vectorized state (tensors of shape [S]); a batch
is one ``ops/sampled_triangles.sampler_scan`` call: on the GPU one C call
(``csrc/sampled_triangles.cu``) whose step keys the host computes ahead
(``csrc/threefry_chain.c``), on the CPU its twin.  Randomness is
``jax.random``'s threefry2x32 with an explicit threaded key
(``utils/threefry.py``; the reference seeds a JVM Random with 0xDEADBEEF,
IncidenceSamplingTriangleCount.java:61), so a state carried over from the
JAX package goes on drawing the same bits.
"""

from __future__ import annotations

import torch

from gelly_streaming_tpu_torch.core.config import StreamConfig
from gelly_streaming_tpu_torch.core.output import OutputStream
from gelly_streaming_tpu_torch.device import DeviceLike, resolve_device
from gelly_streaming_tpu_torch.ops import sampled_triangles as sampler_ops
from gelly_streaming_tpu_torch.ops.sampled_triangles import SamplerState
from gelly_streaming_tpu_torch.utils import threefry

__all__ = [
    "BroadcastTriangleCount",
    "IncidenceSamplingTriangleCount",
    "SamplerState",
    "estimate",
    "init_samplers",
    "sampler_update",
]


def init_samplers(cfg: StreamConfig, num_samplers: int, seed: int = 0xDEADBEEF,
                  device: DeviceLike = None) -> SamplerState:
    dev = resolve_device(device)
    return SamplerState(
        key=threefry.key_tensor(threefry.seed(seed), dev),
        edge=torch.full((num_samplers, 2), -1, dtype=torch.int32, device=dev),
        third=torch.full((num_samplers,), -1, dtype=torch.int32, device=dev),
        closed_a=torch.zeros((num_samplers,), dtype=torch.bool, device=dev),
        closed_b=torch.zeros((num_samplers,), dtype=torch.bool, device=dev),
        edges_seen=torch.zeros((), dtype=torch.int32, device=dev),
        seen=torch.zeros((cfg.vertex_capacity,), dtype=torch.bool, device=dev),
    )


def sampler_update(state: SamplerState, src, dst, mask, chain=None) -> SamplerState:
    """Feed an edge micro-batch through every sampler, in place (``chain``:
    the stream's ``ops/sampled_triangles.KeyChain`` on CUDA, or None)."""
    return sampler_ops.sampler_scan(state, src, dst, mask, chain)


def estimate(state: SamplerState) -> float:
    """(1/S) * sum(beta) * |E| * (|V| - 2)  (TriangleSummer,
    BroadcastTriangleCount.java:160-171), in f32 as the JAX package
    computes it."""
    betas = int((state.closed_a & state.closed_b).sum())
    v = int(state.seen.sum())
    f32 = torch.float32
    s = state.edge.shape[0]
    e = state.edges_seen.to(f32).cpu()
    total = torch.tensor(float(betas), dtype=f32) / s * e * (torch.tensor(float(v), dtype=f32) - 2.0).clamp_min(0.0)
    return float(total)


class _SampledTriangleCount:
    def __init__(self, num_samplers: int, seed: int = 0xDEADBEEF):
        self.num_samplers = num_samplers
        self.seed = seed

    def run(self, stream) -> OutputStream:
        """Continuous estimates: one record (estimate,) after each micro-batch.
        On CUDA the key chain stays on the host, from the seed: after
        enqueueing batch k the loop computes batch k + 1's keys while the
        card runs, then ``estimate`` reads the state."""

        def records():
            state = init_samplers(stream.cfg, self.num_samplers, self.seed, stream.device)
            dev = state.edge.device
            chain = sampler_ops.KeyChain(threefry.seed(self.seed), dev) if dev.type == "cuda" else None
            for batch in stream.batches():
                state = sampler_update(state, batch.src, batch.dst, batch.mask, chain)
                if chain is not None:
                    chain.ahead(stream.cfg.batch_size)
                yield (estimate(state),)
            self.final_state = state

        return OutputStream(records)


class BroadcastTriangleCount(_SampledTriangleCount):
    """Every edge reaches every sampler (BroadcastTriangleCount.java:41-45)."""


class IncidenceSamplingTriangleCount(_SampledTriangleCount):
    """Same estimator; the reference routes edges only to incident samplers
    (IncidenceSamplingTriangleCount.java:61-122), a communication-topology
    choice that the single state's lane masking already embodies on one
    device.  The routed mesh form is ``MeshSampledTriangleCount``, not
    ported yet (ROADMAP queue A.7)."""
