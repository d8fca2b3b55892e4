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
from gelly_streaming_tpu_torch.library.iterative_cc import IterativeConnectedComponents
from gelly_streaming_tpu_torch.library.kcore import core_numbers_windows, windowed_kcore
from gelly_streaming_tpu_torch.library.matching import CentralizedWeightedMatching
from gelly_streaming_tpu_torch.library.pagerank import pagerank_windows, windowed_pagerank
from gelly_streaming_tpu_torch.library.sampled_triangles import (
    BroadcastTriangleCount,
    IncidenceSamplingTriangleCount,
)
from gelly_streaming_tpu_torch.library.sketches import (
    SKETCH_KINDS,
    CountMinHeavyHitters,
    HLLDegreeSummary,
    SketchParamError,
    SketchTriangleCount,
    make_sketch,
)
from gelly_streaming_tpu_torch.library.spanner import Spanner
from gelly_streaming_tpu_torch.library.sssp import sssp_windows, windowed_sssp
from gelly_streaming_tpu_torch.library.triangles import GLOBAL_KEY, ExactTriangleCount

__all__ = [
    "BroadcastTriangleCount",
    "CentralizedWeightedMatching",
    "CountMinHeavyHitters",
    "ExactTriangleCount",
    "GLOBAL_KEY",
    "GraphSAGEWindows",
    "HLLDegreeSummary",
    "IncidenceSamplingTriangleCount",
    "IterativeConnectedComponents",
    "SageParams",
    "SKETCH_KINDS",
    "SageTrainState",
    "SketchParamError",
    "SketchTriangleCount",
    "Spanner",
    "core_numbers_windows",
    "make_sketch",
    "pagerank_windows",
    "sage_init_train",
    "sage_train_step",
    "sage_train_step_mesh",
    "sample_pairs",
    "sssp_windows",
    "windowed_kcore",
    "windowed_pagerank",
    "windowed_sssp",
]
