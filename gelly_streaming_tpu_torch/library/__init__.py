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

__all__ = [
    "GraphSAGEWindows",
    "SageParams",
    "SageTrainState",
    "sage_init_train",
    "sage_train_step",
    "sage_train_step_mesh",
    "sample_pairs",
]
