"""Wire value types (reference: util/*.java Tuple subclasses).

Port of ``gelly_streaming_tpu/utils/value_types.py``: plain host-side
records; on the device the same information travels as columns of batch
tensors (the tuple-of-arrays dual of Flink's array-of-tuples).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SignedVertex:
    """(vertexId, sign) — util/SignedVertex.java:23-41."""

    vertex: int
    sign: bool

    def as_tuple(self) -> Tuple:
        return (self.vertex, self.sign)

    def __str__(self):
        return f"({self.vertex},{'true' if self.sign else 'false'})"


@dataclasses.dataclass(frozen=True)
class MatchingEvent:
    """(ADD/REMOVE, edge) — util/MatchingEvent.java:24-42."""

    type: str  # "ADD" | "REMOVE"
    src: int
    dst: int
    weight: float

    def as_tuple(self) -> Tuple:
        return (self.type, self.src, self.dst, self.weight)

    def __str__(self):
        return f"({self.type},{self.src},{self.dst},{self.weight})"


@dataclasses.dataclass(frozen=True)
class SampledEdge:
    """(subtask, instance, edge, edgeCount, resample) — util/SampledEdge.java:25."""

    subtask: int
    instance: int
    src: int
    dst: int
    edge_count: int
    resample: bool

    def as_tuple(self) -> Tuple:
        return (
            self.subtask,
            self.instance,
            self.src,
            self.dst,
            self.edge_count,
            self.resample,
        )


@dataclasses.dataclass(frozen=True)
class TriangleEstimate:
    """(sourceSubtask, edgeCount, beta) — util/TriangleEstimate.java:23."""

    source_subtask: int
    edge_count: int
    beta: int

    def as_tuple(self) -> Tuple:
        return (self.source_subtask, self.edge_count, self.beta)
