"""PyTorch/CUDA port of gelly_streaming_tpu for one NVIDIA H100.

The module layout mirrors the JAX package so each port module sits at the
same path as its counterpart.  The package imports ``torch`` and ``numpy``
only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` on a machine without a GPU raises
instead of silently running on the CPU (see ``device.resolve_device``).

Slices ported so far: the windowed exact triangle count
(``library.triangles.window_triangles``) with its two hand-written CUDA
kernels (``ops.dense_triangles``, ``csrc/pane_triangles.cu``), and
streaming connected components (``library.connected_components``, the
``EdgeStream.from_wire``/``from_arrays`` wire path of
``core.aggregation``) with its union-find kernels (``ops.unionfind``,
``csrc/unionfind.cu``).
"""

from gelly_streaming_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
