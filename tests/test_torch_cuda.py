"""The port's CUDA kernels against their plain PyTorch twins, on the GPU.

Marked ``cuda``: each test skips where no GPU is present (as on a CPU-only
CI host).  On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch.ops import dense_triangles as dt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _words(rng, k, edges, dev):
    u, v = rng.integers(0, k, edges), rng.integers(0, k, edges)
    w, n = dt.pack_pane(np.concatenate([u, v, u[:9]]), np.concatenate([v, u, u[:9]]))
    w = np.concatenate([w, rng.integers(0, 1 << 28, 5).astype(np.uint32)])
    return tuple(torch.from_numpy(a).to(dev) for a in dt.packed_host_arrays(w, n))


@pytest.mark.parametrize("k", [128, 4096, 16384])
def test_pane_adjacency_kernel_matches_twin(cuda_device, k):
    words, n = _words(np.random.default_rng(k), k, 4 * k, cuda_device)
    before = dt.LAUNCHES["pane_adjacency"]
    got = dt.pane_adjacency(words, n, k)
    assert dt.LAUNCHES["pane_adjacency"] == before + 1
    assert torch.equal(got, dt.pane_adjacency_plain(words, n, k))


@pytest.mark.parametrize("k,p", [(128, 0.3), (4096, 0.01), (2048, 1.0)])
def test_dense_triangles_kernel_matches_twin(cuda_device, k, p):
    rng = np.random.default_rng(k)
    upper = np.triu(rng.random((k, k)) < p, 1)
    bits = dt.pack_bits(torch.from_numpy(upper | upper.T).to(cuda_device))
    got = dt.dense_triangles(bits)
    assert int(got[0]) == int(dt.dense_triangles_plain(bits)[0])


def test_window_triangles_on_gpu_matches_cpu(cuda_device):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io.sources import _batched
    from gelly_streaming_tpu_torch.library.triangles import window_triangles

    rng = np.random.default_rng(0)
    src = rng.integers(0, 2000, 40000)
    dst = rng.integers(0, 2000, 40000)
    tim = np.sort(rng.integers(0, 8000, 40000))
    cfg = StreamConfig(vertex_capacity=1 << 12)

    def run(dev):
        s = EdgeStream.from_batches(_batched(src, dst, None, tim, None, 4096, dev), cfg, device=dev)
        return window_triangles(s, 1000, slide_ms=500).collect()

    assert run(cuda_device) == run("cpu")
