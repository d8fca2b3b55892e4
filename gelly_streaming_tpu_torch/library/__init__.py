"""Streaming graph algorithms of the port (the JAX package's library/)."""

from gelly_streaming_tpu_torch.library.graphsage import (
    GraphSAGEWindows,
    SageParams,
    SageTrainState,
    sage_init_train,
    sage_train_step,
    sage_train_step_mesh,
    sample_pairs,
)
from gelly_streaming_tpu_torch.library.triangles import GLOBAL_KEY, ExactTriangleCount

__all__ = [
    "ExactTriangleCount",
    "GLOBAL_KEY",
    "GraphSAGEWindows",
    "SageParams",
    "SageTrainState",
    "sage_init_train",
    "sage_train_step",
    "sage_train_step_mesh",
    "sample_pairs",
]
