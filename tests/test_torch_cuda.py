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


# adversarial panes: (name, k, edge list maker)
def _star(rng, k):
    """Vertex 0 joined to all others, plus leaf edges: a row of degree k - 1."""
    u = np.concatenate([np.zeros(k - 1, np.int64), rng.integers(1, k, 2 * k)])
    return u, np.concatenate([np.arange(1, k), rng.integers(1, k, 2 * k)])


def _zipf(rng, k, edges=1 << 17):
    p = 1.0 / np.arange(1, k + 1) ** 1.2
    p /= p.sum()
    return rng.choice(k, edges, p=p), rng.choice(k, edges, p=p)


def _word_boundaries(rng, k):
    """A complete graph on vertices at bit 0/31 of words and the row's end."""
    ids = sorted({x for x in (0, 1, 30, 31, 32, 33, 63, 64, 95, 96, k - 33, k - 1) if x < k})
    u, v = zip(*[(a, b) for a in ids for b in ids if a < b])
    return np.array(u), np.array(v)


def _uniform(rng, k):
    return rng.integers(0, k, 8 * k), rng.integers(0, k, 8 * k)


def _empty(rng, k):
    return np.zeros(0, np.int64), np.zeros(0, np.int64)


ADVERSARIAL = [
    ("star", 4096, _star),
    ("zipf", 4096, _zipf),
    ("word-boundaries", 4096, _word_boundaries),
    ("word-boundaries", 96, _word_boundaries),
    ("empty", 4096, _empty),
    ("uniform", 32, _uniform),
    ("uniform", 96, _uniform),
    ("uniform", 16384, _uniform),
]


def _pane_words(rng, k, u, v, dev):
    """Device (words, n) of an edge list, with garbage words past n."""
    w, n = dt.pack_pane(u, v)
    w = np.concatenate([w, (rng.integers(0, k, 5) | (1 << 14)).astype(np.uint32)])
    return tuple(torch.from_numpy(a).to(dev) for a in dt.packed_host_arrays(w, n))


@pytest.mark.parametrize("name,k,make", ADVERSARIAL, ids=[f"{c[0]}-{c[1]}" for c in ADVERSARIAL])
@pytest.mark.parametrize("aligned", [True, False])
def test_pane_kernels_match_twins_on_adversarial_panes(cuda_device, name, k, make, aligned):
    rng = np.random.default_rng(k)
    words, n = _pane_words(rng, k, *make(rng, k), cuda_device)
    if not aligned:  # 4 B off a 16 B boundary: the kernels' scalar loads
        words, n = words[1:], torch.clamp(n - 1, min=0)
    bits = dt.pane_adjacency(words, n, k)
    want_bits = dt.pane_adjacency_plain(words, n, k)
    assert torch.equal(bits, want_bits)
    counted = bits
    if not aligned:
        flat = torch.empty(bits.numel() + 1, dtype=torch.int32, device=cuda_device)
        counted = flat[1:].view(bits.shape)
        counted.copy_(bits)
    want = int(dt.dense_triangles_plain(bits)[0])
    assert int(dt.dense_triangles(counted)[0]) == want
    assert int(dt.pane_triangles(words, n, k)[0]) == want
    if name == "empty":
        assert want == 0 and not bits.any()


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


# ---------------------------------------------------------------------------
# the union-find kernel (csrc/unionfind.cu) against its twin


def _forest(rng, c):
    """A forest whose roots are not the smallest ids of their trees."""
    order = rng.permutation(c)
    parent = np.arange(c, dtype=np.int32)
    k = np.nonzero(rng.random(c) < 0.7)[0]
    k = k[k > 0]
    parent[order[k]] = order[(rng.random(len(k)) * k).astype(np.int64)]
    return parent


def _uf_edges(rng, c, case):
    n = 2 * c
    if case == "uniform":
        return rng.integers(0, c, n), rng.integers(0, c, n), None
    if case == "star":
        return np.full(c - 1, c - 1), np.arange(c - 1), None
    if case == "zipf":
        return (rng.zipf(1.3, n) - 1) % c, (rng.zipf(1.3, n) - 1) % c, None
    if case == "reverse-path":
        return np.arange(c - 1)[::-1], np.arange(1, c)[::-1], None
    if case == "shuffled-path":
        order = rng.permutation(c - 1)
        return order, order + 1, None
    if case == "self-loops":
        ids = rng.integers(0, c, n)
        return ids, ids, None
    if case == "masked-tail":
        mask = np.ones(n, bool)
        mask[n // 2 :] = False
        return rng.integers(0, c, n), rng.integers(0, c, n), mask
    raise ValueError(case)


UF_CASES = ["uniform", "star", "zipf", "reverse-path", "shuffled-path", "self-loops", "masked-tail"]


@pytest.mark.parametrize("case", UF_CASES)
@pytest.mark.parametrize("start", ["identity", "forest"])
def test_union_kernel_matches_twin(cuda_device, case, start):
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c = 1 << 16
    rng = np.random.default_rng(UF_CASES.index(case))
    u, v, m = _uf_edges(rng, c, case)
    s, d = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda_device) for a in (u, v))
    mask = None if m is None else torch.from_numpy(m).to(cuda_device)
    parent0 = np.arange(c, dtype=np.int32) if start == "identity" else _forest(rng, c)
    parent = torch.from_numpy(parent0).to(cuda_device)
    seen = torch.zeros(c, dtype=torch.bool, device=cuda_device)
    want_p, want_s = uf.union_edges_with_seen_plain(parent, seen, s, d, mask)
    before = dict(uf.LAUNCHES)
    got_p, got_s = uf.union_edges_with_seen(parent, seen, s, d, mask)
    torch.cuda.synchronize()
    assert got_p is parent and got_s is seen
    assert uf.LAUNCHES["union_kernel"] == before["union_kernel"] + 1
    assert uf.LAUNCHES["compress_kernel"] == before["compress_kernel"] + 1
    assert torch.equal(parent, want_p) and torch.equal(seen, want_s)


def test_merge_and_compress_kernels_match_twins(cuda_device):
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c = 1 << 16
    rng = np.random.default_rng(42)
    a0 = torch.from_numpy(_forest(rng, c)).to(cuda_device)
    b0 = torch.from_numpy(_forest(rng, c)).to(cuda_device)
    assert torch.equal(uf.merge_parents(a0.clone(), b0), uf.merge_parents_plain(a0, b0))
    assert torch.equal(uf.compress(a0.clone()), uf.compress_plain(a0))
    top = torch.tensor([c - 1, 0], dtype=torch.int32, device=cuda_device)
    p = uf.union_edges(uf.init_parent(c, cuda_device), top, top.flip(0))
    assert int(p[c - 1]) == 0 and int(p[1]) == 1


def test_cc_wire_path_on_gpu_matches_cpu(cuda_device):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents

    rng = np.random.default_rng(0)
    src = rng.integers(0, 1 << 14, 70000)
    dst = rng.integers(0, 1 << 14, 70000)
    cfg = StreamConfig(vertex_capacity=1 << 14, ingest_window_edges=1 << 14, superbatch=2)

    def run(dev):
        bufs, tail = wire.pack_stream(src, dst, 1 << 13, (wire.EF40, 1 << 14))
        s = EdgeStream.from_wire(bufs, 1 << 13, (wire.EF40, 1 << 14), cfg, tail=tail, device=dev)
        return [(r[0].parent.cpu(), r[0].seen.cpu()) for r in s.aggregate(ConnectedComponents()).collect()]

    got, want = run(cuda_device), run("cpu")
    assert len(got) == len(want) == 5
    for (gp, gs), (wp, ws) in zip(got, want):
        assert torch.equal(gp, wp) and torch.equal(gs, ws)
