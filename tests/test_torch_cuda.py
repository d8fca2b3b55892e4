"""The port's CUDA kernels against their plain PyTorch twins, on the GPU.

Marked ``cuda``: each test skips where no GPU is present (as on a CPU-only
CI host).  On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""

import os

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


# ---------------------------------------------------------------------------
# the degree kernels (csrc/degrees.cu) and the parity union against their twins


def _endpoints(rng, c, n, case):
    if case == "uniform":
        v = rng.integers(0, c, n)
    elif case == "hub":
        v = np.where(rng.random(n) < 0.6, c - 1, rng.integers(0, c, n))
    else:  # zipf
        v = (rng.zipf(1.3, n) - 1) % c
    m = rng.random(n) < 0.8
    return np.ascontiguousarray(v, np.int32), m


@pytest.mark.parametrize("case", ["uniform", "hub", "zipf"])
@pytest.mark.parametrize("packed", [True, False])
def test_degree_trace_kernel_matches_twin(cuda_device, case, packed):
    from gelly_streaming_tpu_torch.ops import degrees

    c, n = 1 << 12, 50_001
    rng = np.random.default_rng(7)
    v, m = _endpoints(rng, c, n, case)
    counts0 = rng.integers(0, 1 << 10, c).astype(np.int32)
    counts0[5] = (1 << 31) - 3  # int32 wrap and the 2^28 - 1 clip
    tv, tm, tc = (torch.from_numpy(a).to(cuda_device) for a in (v, m, counts0))
    want_counts, want = degrees.degree_trace_plain(tc, tv, tm, packed)
    before = degrees.LAUNCHES["degree_trace"]
    got = degrees.degree_trace(tc, tv, tm, packed)
    assert degrees.LAUNCHES["degree_trace"] == before + 1
    assert torch.equal(tc, want_counts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("masked", [False, True])
def test_degree_fold_kernel_matches_twin(cuda_device, masked):
    from gelly_streaming_tpu_torch.ops import degrees

    c, n = 1 << 14, 1 << 17
    rng = np.random.default_rng(3)
    s, d = (torch.from_numpy(rng.integers(0, c, n).astype(np.int32)).to(cuda_device) for _ in range(2))
    mask = torch.from_numpy(rng.random(n) < 0.5).to(cuda_device) if masked else None
    deg = torch.from_numpy(rng.integers(0, 9, c).astype(np.int32)).to(cuda_device)
    want = degrees.degree_fold_plain(deg, s, d, mask)
    assert degrees.degree_fold(deg, s, d, mask) is deg
    assert torch.equal(deg, want)


@pytest.mark.parametrize("capacity", [64, 1 << 12])
def test_degree_dist_scan_kernel_matches_twin(cuda_device, capacity):
    from gelly_streaming_tpu_torch.ops import degrees

    n = 3000
    rng = np.random.default_rng(capacity)
    nv = min(capacity, 40)  # few vertices: degrees pass a capacity of 64
    src = rng.integers(0, nv, n).astype(np.int32)
    dst = rng.integers(0, nv, n).astype(np.int32)
    dst[::17] = src[::17]  # self-loops
    sign = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int8)
    mask = rng.random(n) < 0.95
    args = [torch.from_numpy(a).to(cuda_device) for a in (src, dst, sign, mask)]
    deg = torch.zeros(capacity, dtype=torch.int32, device=cuda_device)
    hist = torch.zeros(capacity, dtype=torch.int32, device=cuda_device)
    for lo in range(0, n, 1000):
        part = [a[lo : lo + 1000] for a in args]
        wd, wh, wr, wm = degrees.degree_dist_scan_plain(deg, hist, *part)
        recs, rmask = degrees.degree_dist_scan(deg, hist, *part)
        assert torch.equal(deg, wd) and torch.equal(hist, wh)
        assert torch.equal(recs, wr) and torch.equal(rmask, wm)
    assert int(deg.max()) >= 64


def _scan_batch(rng, n, case, c):
    src = rng.integers(0, c, n).astype(np.int32)
    dst = rng.integers(0, c, n).astype(np.int32)
    dst[::13] = src[::13]
    sign = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int8)
    if case == "one_vertex":  # one group across hundreds of blocks
        src[:] = 5
        dst[:] = 5
        sign = np.where(rng.random(n) < 0.2, -1, 1).astype(np.int8)
    elif case == "out_of_range":
        src[rng.random(n) < 0.1] = -1
        dst[rng.random(n) < 0.1] = c
        dst[rng.random(n) < 0.05] = c + 5
        sign = rng.choice(np.array([-128, -3, -1, 0, 1, 2, 127], np.int8), n)
    return src, dst, sign, rng.random(n) < 0.9


@pytest.mark.parametrize("n", [1, 255, 256, 257, 3000, (1 << 18) + 3])
@pytest.mark.parametrize("case,capacity", [("uniform", 1 << 12), ("uniform", 64), ("one_vertex", 1 << 12),
                                           ("out_of_range", 1 << 10)])
def test_degree_dist_scan_two_stage_kernels_match_serial_and_twin(cuda_device, n, case, capacity):
    """The two-stage kernels against the one-thread kernel and the twin,
    bit for bit, over two in-place calls on one state."""
    from gelly_streaming_tpu_torch.ops import degrees

    rng = np.random.default_rng(n)
    deg0 = rng.integers(0, 4, capacity).astype(np.int32)
    deg0[7] = (1 << 31) - 3  # a group at the int32 wrap
    hist0 = np.bincount(np.minimum(deg0, capacity - 1), minlength=capacity).astype(np.int32)
    states = [(torch.from_numpy(deg0.copy()).to(cuda_device), torch.from_numpy(hist0.copy()).to(cuda_device))
              for _ in range(3)]
    for call in range(2):
        src, dst, sign, mask = _scan_batch(rng, n, case, capacity)
        if call == 1:
            src[: min(n, 5)] = 7
        args = [torch.from_numpy(a).to(cuda_device) for a in (src, dst, sign, mask)]
        twin = degrees.degree_dist_scan_plain(*states[2], *args)
        states[2][0].copy_(twin[0])
        states[2][1].copy_(twin[1])
        before = degrees.LAUNCHES["degree_dist_scan"]
        got = degrees.degree_dist_scan(*states[0], *args)
        assert degrees.LAUNCHES["degree_dist_scan"] == before + 1
        serial = degrees.degree_dist_scan_serial(*states[1], *args)
        torch.cuda.synchronize()
        for g, s, w in zip(got, serial, twin[2:]):
            assert torch.equal(g, s) and torch.equal(g, w)
        for (gd, gh), (sd, sh) in zip(states[:2], states[1:]):
            assert torch.equal(gd, sd) and torch.equal(gh, sh)
    if case == "uniform" and capacity == 64 and n >= 3000:
        assert int(states[0][0].max()) >= 64  # degrees pass the capacity


@pytest.mark.parametrize("start", ["identity", "forest"])
@pytest.mark.parametrize("masked", [False, True])
def test_parity_union_kernel_matches_twin(cuda_device, start, masked):
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c, n = 1 << 14, 1 << 15
    rng = np.random.default_rng(11)
    # a bipartite half (even -> odd) and a few odd cycles
    src = rng.integers(0, c // 2, n) * 2
    dst = rng.integers(0, c // 2, n) * 2 + 1
    src[: n // 64] = rng.integers(0, c, n // 64)
    s, d = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda_device) for a in (src, dst))
    mask = torch.from_numpy(rng.random(n) < 0.7).to(cuda_device) if masked else None
    p0 = np.arange(2 * c, dtype=np.int32) if start == "identity" else _forest(rng, 2 * c)
    parent2 = torch.from_numpy(p0).to(cuda_device)
    seen = torch.zeros(c, dtype=torch.bool, device=cuda_device)
    want_p, want_s = uf.parity_union_edges_with_seen_plain(parent2, seen, s, d, mask)
    before = uf.LAUNCHES["parity_union_kernel"]
    uf.parity_union_edges_with_seen(parent2, seen, s, d, mask)
    assert uf.LAUNCHES["parity_union_kernel"] == before + 1
    assert torch.equal(parent2, want_p) and torch.equal(seen, want_s)
    assert bool(uf.is_bipartite(parent2, seen)) == bool(uf.is_bipartite(want_p, want_s))


def test_property_streams_on_gpu_match_cpu(cuda_device):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream

    rng = np.random.default_rng(5)
    src = rng.integers(0, 3000, 20000)
    dst = rng.integers(0, 3000, 20000)
    for cap in (1 << 12, (1 << 20) + 8):  # packed records, then raw columns
        cfg = StreamConfig(vertex_capacity=cap, batch_size=4096)

        def run(dev, op):
            return getattr(EdgeStream.from_arrays(src, dst, cfg, device=dev), op)().collect()

        for op in ("get_degrees", "get_in_degrees", "get_vertices", "number_of_vertices", "number_of_edges"):
            assert run(cuda_device, op) == run("cpu", op), op


def test_degree_and_bipartite_aggregations_on_gpu_match_cpu(cuda_device):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io.sources import _batched
    from gelly_streaming_tpu_torch.library.bipartiteness import BipartitenessCheck
    from gelly_streaming_tpu_torch.library.degree_distribution import (
        DegreeDistribution,
        DegreeDistributionSummary,
    )

    rng = np.random.default_rng(9)
    n = 6000
    src = rng.integers(0, 500, n)
    dst = rng.integers(0, 500, n)
    sign = np.where(rng.random(n) < 0.3, -1, 1)
    tim = np.sort(rng.integers(0, 4000, n))
    cfg = StreamConfig(vertex_capacity=1 << 10, batch_size=1024)

    def run(dev):
        degs = [r[0].cpu() for r in EdgeStream.from_arrays(src, dst, cfg, device=dev)
                .aggregate(DegreeDistributionSummary()).collect()]
        signed = EdgeStream.from_batches(_batched(src, dst, None, None, sign, 1000, dev), cfg, device=dev)
        dist = DegreeDistribution().run(signed).collect()
        timed = EdgeStream.from_batches(_batched(src, dst, None, tim, None, 1000, dev), cfg, device=dev)
        bip = [str(r[0]) for r in timed.aggregate(BipartitenessCheck(window_ms=1000)).collect()]
        even = EdgeStream.from_batches(
            _batched(src - src % 2, dst | 1, None, tim, None, 1000, dev), cfg, device=dev)
        bip += [str(r[0]) for r in even.aggregate(BipartitenessCheck(window_ms=1000)).collect()]
        return degs, dist, bip

    (g_deg, g_dist, g_bip), (c_deg, c_dist, c_bip) = run(cuda_device), run("cpu")
    assert all(torch.equal(a, b) for a, b in zip(g_deg, c_deg)) and len(g_deg) == len(c_deg)
    assert g_dist == c_dist and g_bip == c_bip
    assert g_bip[-1].startswith("(true,")


# ---------------------------------------------------------------------------
# the redesigned degree trace and union kernels, and JAX's index rules for
# ids outside [0, C) on the card

TRACE_CASES = ["hub-2^20", "all-masked", "one-row", "ragged", "out-of-range"]


def _trace_case(rng, case):
    """(v, m, capacity) of each degree-trace case."""
    if case == "hub-2^20":  # one vertex's rows span about 1000 tiles
        n, c = (1 << 20) + 4096, 1 << 12
        v = np.where(np.arange(n) < 1 << 20, 7, rng.integers(0, c, n))
        return v[rng.permutation(n)], rng.random(n) < 0.9, c
    if case == "all-masked":
        return rng.integers(0, 1 << 10, 5000), np.zeros(5000, bool), 1 << 10
    if case == "one-row":
        return np.array([3]), np.array([True]), 16
    if case == "ragged":  # n not a multiple of the tile or of 8
        return rng.integers(0, 300, 3 * 1024 + 5), rng.random(3 * 1024 + 5) < 0.8, 300
    c = 16  # -1, C, C + 5 and -C - 2 beside C - 1
    return rng.choice(np.array([-1, c, c + 5, -c - 2, c - 1, 0, 3]), 4099), rng.random(4099) < 0.7, c


@pytest.mark.parametrize("case", TRACE_CASES)
@pytest.mark.parametrize("packed", [True, False])
def test_degree_trace_redesign_matches_twin(cuda_device, case, packed):
    from gelly_streaming_tpu_torch.ops import degrees

    rng = np.random.default_rng(TRACE_CASES.index(case))
    v, m, c = _trace_case(rng, case)
    counts0 = rng.integers(0, 1 << 10, c).astype(np.int32)
    tv = torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(cuda_device)
    tm = torch.from_numpy(np.ascontiguousarray(m)).to(cuda_device)
    tc = torch.from_numpy(counts0).to(cuda_device)
    want_counts, want = degrees.degree_trace_plain(tc, tv, tm, packed)
    got = degrees.degree_trace(tc, tv, tm, packed)
    assert torch.equal(tc, want_counts)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_degree_fold_follows_jax_index_rules(cuda_device):
    from gelly_streaming_tpu_torch.ops import degrees

    c, n = 16, 1 << 12
    rng = np.random.default_rng(5)
    ids = np.array([-1, c, c + 5, -c - 2, c - 1, 0, 3], np.int32)
    s, d = (torch.from_numpy(rng.choice(ids, n)).to(cuda_device) for _ in range(2))
    mask = torch.from_numpy(rng.random(n) < 0.8).to(cuda_device)
    deg = torch.zeros(c, dtype=torch.int32, device=cuda_device)
    want = degrees.degree_fold_plain(deg, s, d, mask)
    assert torch.equal(degrees.degree_fold(deg, s, d, mask), want)


def _state(case, c, rng, dev, parity):
    """(parent, src, dst, mask) of each union case, parent on the card."""
    nodes = 2 * c if parity else c
    ident = torch.arange(nodes, dtype=torch.int32, device=dev)
    if case == "reverse-path":
        s, d = np.arange(c - 1)[::-1], np.arange(1, c)[::-1]
    elif case == "star":
        s, d = np.full(c - 1, c // 2), np.delete(np.arange(c), c // 2)
    elif case == "out-of-range":
        ids = np.array([-1, c, c + 5, -c - 2, c - 1, 0, 3, 9])
        s, d = rng.choice(ids, 4 * c), rng.integers(0, c, 4 * c)
    else:
        s, d = rng.integers(0, c, 2 * c), rng.integers(0, c, 2 * c)
    s, d = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev) for a in (s, d))
    return ident, s, d, None


UNION_CASES = ["reverse-path", "star", "out-of-range", "uniform"]


@pytest.mark.parametrize("case", UNION_CASES)
@pytest.mark.parametrize("parity", [False, True])
def test_union_redesign_matches_twin_and_skips_compress_on_a_flat_state(cuda_device, case, parity):
    """Two folds into one state: the first compresses (a new tensor), the
    second skips compress (the state is known flat); both equal the twin,
    and the round counts are reported."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c = 1 << 14
    rng = np.random.default_rng(UNION_CASES.index(case))
    parent, s, d, mask = _state(case, c, rng, cuda_device, parity)
    seen = torch.zeros(c, dtype=torch.bool, device=cuda_device)
    fold, plain = ((uf.parity_union_edges_with_seen, uf.parity_union_edges_with_seen_plain) if parity
                   else (uf.union_edges_with_seen, uf.union_edges_with_seen_plain))
    s2, d2 = s.roll(7), d.flip(0)
    want = plain(*plain(parent, seen, s, d, mask), s2, d2, mask)
    before = dict(uf.LAUNCHES)
    fold(parent, seen, s, d, mask)
    first = uf.last_rounds()
    fold(parent, seen, s2, d2, mask)
    late = uf.last_rounds()
    assert uf.LAUNCHES["compress_kernel"] == before["compress_kernel"] + 1
    assert first["compress"] >= 1 and late["compress"] == 0 and first["hook"] >= 1 and late["hook"] >= 1
    assert torch.equal(parent, want[0]) and torch.equal(seen, want[1])


@pytest.mark.parametrize("parity", [False, True])
def test_union_compresses_a_state_written_since(cuda_device, parity):
    """A state left by merge_parents, then written in place by the caller
    (not flat): the next fold compresses first and equals the twin."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c = 1 << 12
    nodes = 2 * c if parity else c
    rng = np.random.default_rng(21)
    a = torch.from_numpy(_forest(rng, nodes)).to(cuda_device)
    b = torch.from_numpy(_forest(rng, nodes)).to(cuda_device)
    want_merged = uf.merge_parents_plain(a, b)
    assert torch.equal(uf.merge_parents(a, b), want_merged)
    a.copy_(torch.from_numpy(_forest(rng, nodes)).to(cuda_device))  # a caller's own write
    s, d = (torch.from_numpy(rng.integers(0, c, 3 * c).astype(np.int32)).to(cuda_device) for _ in range(2))
    seen = torch.zeros(c, dtype=torch.bool, device=cuda_device)
    fold, plain = ((uf.parity_union_edges_with_seen, uf.parity_union_edges_with_seen_plain) if parity
                   else (uf.union_edges_with_seen, uf.union_edges_with_seen_plain))
    want = plain(a, seen, s, d)
    before = uf.LAUNCHES["compress_kernel"]
    fold(a, seen, s, d)
    assert uf.LAUNCHES["compress_kernel"] == before + 1
    assert torch.equal(a, want[0]) and torch.equal(seen, want[1])


def _fold_batch(rng, case, n, c):
    """(src, dst, mask | None) of one degree-fold case over capacity c."""
    if case == "uniform":
        return rng.integers(0, c, n), rng.integers(0, c, n), None
    if case == "grouped":  # src-grouped as the EF40 wire decodes, long runs among short ones
        src = np.sort(np.concatenate([rng.integers(0, c, n - n // 4), np.full(n // 4, c // 2)]))
        return src, rng.integers(0, c, n), None
    if case == "star":
        return np.full(n, c - 1), rng.integers(0, c, n), None
    if case == "zipf":
        ids = rng.permutation(c)
        return ids[(rng.zipf(1.2, n) - 1) % c], ids[(rng.zipf(1.2, n) - 1) % c], None
    if case == "masked":
        return rng.integers(0, c, n), np.sort(rng.integers(0, c, n)), rng.random(n) < 0.6
    if case == "out-of-range":
        ids = np.array([-1, c, c + 5, -c, -c - 2, c - 1, 0, 3])
        return rng.choice(ids, n), rng.integers(-1, c + 1, n), rng.random(n) < 0.8
    raise ValueError(case)


FOLD_CASES = ["uniform", "grouped", "star", "zipf", "masked", "out-of-range"]


@pytest.mark.parametrize("case", FOLD_CASES)
@pytest.mark.parametrize("n,c", [(1, 1 << 10), (100, 1 << 10), (1 << 18, 12345), (1 << 21, 1 << 20)])
def test_degree_fold_redesign_matches_twin(cuda_device, case, n, c):
    """Every batch shape: one row, fewer rows than a warp folds at once, a
    capacity that is no power of two, the main path's size; equal exactly."""
    from gelly_streaming_tpu_torch.ops import degrees

    rng = np.random.default_rng(FOLD_CASES.index(case))
    u, v, m = _fold_batch(rng, case, n, c)
    s, d = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda_device) for a in (u, v))
    mask = None if m is None else torch.from_numpy(m).to(cuda_device)
    deg = torch.from_numpy(rng.integers(0, 1 << 30, c).astype(np.int32)).to(cuda_device)
    want = degrees.degree_fold_plain(deg, s, d, mask)
    before = degrees.LAUNCHES["degree_fold"]
    assert degrees.degree_fold(deg, s, d, mask) is deg
    assert degrees.LAUNCHES["degree_fold"] == before + 1
    assert torch.equal(deg, want)


def test_degree_fold_redesign_takes_unaligned_views_and_wraps(cuda_device):
    """Views that do not start 16-byte aligned take the scalar loads; the
    adds wrap at 2^31 as JAX's int32 adds do."""
    from gelly_streaming_tpu_torch.ops import degrees

    c, n = 4096, 1 << 16
    rng = np.random.default_rng(8)
    s0, d0 = (torch.from_numpy(np.sort(rng.integers(0, c, n + 3)).astype(np.int32)).to(cuda_device) for _ in range(2))
    m0 = torch.from_numpy(rng.random(n + 3) < 0.9).to(cuda_device)
    s, d, m = s0[1 : n + 1], d0[3:], m0[2 : n + 2]
    deg = torch.full((c,), (1 << 31) - 5, dtype=torch.int32, device=cuda_device)
    want = degrees.degree_fold_plain(deg, s, d, m)
    assert torch.equal(degrees.degree_fold(deg, s, d, m), want)
    assert int(deg.min()) < 0  # wrapped


def _compress_case(case, nodes, rng):
    """A parent array over `nodes` ids: flat, a shallow forest, a star with a
    second level, or a path (depth nodes - 1) in id order or shuffled."""
    if case == "flat":
        return np.arange(nodes)
    if case == "forest":
        return _forest(rng, nodes)
    if case == "star":
        parent = np.full(nodes, nodes // 3)
        inner = rng.permutation(np.delete(np.arange(nodes), nodes // 3))[: 2 * (nodes // 4)]
        parent[inner[: nodes // 4]] = inner[nodes // 4 :]
        return parent
    order = np.arange(nodes) if case == "reversed-path" else rng.permutation(nodes)
    parent = np.empty(nodes, np.int64)
    parent[order] = order[np.maximum(np.arange(nodes) - 1, 0)]
    return parent


COMPRESS_CASES = ["flat", "forest", "star", "reversed-path", "shuffled-path"]


@pytest.mark.parametrize("case", COMPRESS_CASES)
@pytest.mark.parametrize("parity", [False, True])
@pytest.mark.parametrize("c", [1 << 15, 12345])
def test_compress_redesign_matches_twin_alone_and_before_a_union(cuda_device, case, parity, c):
    """The compress pass and its rounds over C and 2C nodes (12345: a pass
    whose last thread holds fewer than 4 nodes): alone (a call with no
    edges, the rounds kernel) and before a union (the union kernel runs
    the rounds); a flat state is one pass, a deep one takes rounds."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    nodes = 2 * c if parity else c
    rng = np.random.default_rng(COMPRESS_CASES.index(case))
    parent0 = torch.from_numpy(_compress_case(case, nodes, rng).astype(np.int32)).to(cuda_device)
    want = uf.compress_plain(parent0)
    before = uf.LAUNCHES["compress_kernel"]
    got = parent0.clone()
    assert uf.compress(got) is got
    rounds = uf.last_rounds()
    assert torch.equal(got, want)
    assert uf.LAUNCHES["compress_kernel"] == before + 1
    if case == "flat":
        assert rounds["compress"] == 1
    elif "path" in case:
        assert rounds["compress"] > 1
    # the same state before a batch: the union kernel finishes the compress
    s, d = (torch.from_numpy(rng.integers(0, c, 2 * c).astype(np.int32)).to(cuda_device) for _ in range(2))
    seen = torch.zeros(c, dtype=torch.bool, device=cuda_device)
    fold, plain = ((uf.parity_union_edges_with_seen, uf.parity_union_edges_with_seen_plain) if parity
                   else (uf.union_edges_with_seen, uf.union_edges_with_seen_plain))
    want_p, want_s = plain(parent0, seen, s, d)
    got_p, got_s = fold(parent0.clone(), seen.clone(), s, d)
    # the union kernel's larger grid may double in fewer rounds
    after = uf.last_rounds()["compress"]
    assert after == 1 if case == "flat" else after >= 1
    assert torch.equal(got_p, want_p) and torch.equal(got_s, want_s)
    assert uf.LAUNCHES["compress_kernel"] == before + 2


def test_readouts_of_a_flat_state_launch_no_compress(cuda_device):
    """After a union the state is known flat: find, components, the string,
    find_roots and the Candidates view read it without a compress launch;
    a state written since is compressed, into a copy."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.summaries.candidates import Candidates
    from gelly_streaming_tpu_torch.summaries.disjoint_set import DisjointSet

    c = 1 << 10
    rng = np.random.default_rng(17)
    u, v = rng.integers(0, c, 300), rng.integers(0, c, 300)
    ds = DisjointSet(c, device=cuda_device)
    ds.union_batch(u, v)
    cpu = DisjointSet(c, device="cpu")
    cpu.union_batch(u, v)
    before = uf.LAUNCHES["compress_kernel"]
    assert [ds.find(x) for x in range(0, c, 7)] == [cpu.find(x) for x in range(0, c, 7)]
    assert ds.components() == cpu.components() and str(ds) == str(cpu)
    verts = torch.arange(c, dtype=torch.int32, device=cuda_device)
    assert torch.equal(uf.find_roots(ds.parent, verts).cpu(), uf.find_roots(cpu.parent, verts.cpu()))
    p2 = uf.init_parity_parent(c, cuda_device)
    seen = torch.zeros(c, dtype=torch.bool, device=cuda_device)
    even = torch.from_numpy((2 * rng.integers(0, c // 2, 200)).astype(np.int32)).to(cuda_device)
    uf.parity_union_edges_with_seen(p2, seen, even, even + 1)
    launched = uf.LAUNCHES["compress_kernel"]
    cand = Candidates(p2, seen)
    cpu_cand = Candidates(p2.cpu(), seen.cpu())
    assert str(cand) == str(cpu_cand) and cand.components() == cpu_cand.components()
    assert uf.LAUNCHES["compress_kernel"] == launched == before + 1  # the parity union's own compress
    # an aggregation's emitted records: copies of a flat state, read as they are
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents

    cfg = StreamConfig(vertex_capacity=c, batch_size=128, ingest_window_edges=256)
    es, ed = (rng.integers(0, c, 512).astype(np.int32) for _ in range(2))
    records = EdgeStream.from_arrays(es, ed, cfg, device=cuda_device).aggregate(ConnectedComponents()).collect()
    cpu_records = EdgeStream.from_arrays(es, ed, cfg, device="cpu").aggregate(ConnectedComponents()).collect()
    launched = uf.LAUNCHES["compress_kernel"]
    assert len(records) == 2 and [str(r[0]) for r in records] == [str(r[0]) for r in cpu_records]
    assert uf.LAUNCHES["compress_kernel"] == launched
    # written since: a readout compresses a copy and leaves the state as it is
    ds.parent[5] = 3
    written = ds.parent.clone()
    assert ds.find(5) == int(uf.compress_plain(written.cpu())[5])
    assert uf.LAUNCHES["compress_kernel"] == launched + 1 and torch.equal(ds.parent, written)


# ---------------------------------------------------------------------------
# the neighborhood build and the GraphSAGE gather-mean, on the card

BUCKET_CASES = ["uniform", "hub", "masked", "ragged", "one-row", "out-of-range", "values"]


def _bucket_case(rng, case):
    """(src, dst, mask, value tree | None) of each build_buckets case."""
    if case == "hub":  # a star of 2^17 beside Zipf edges: the deepest buckets
        n = 1 << 18
        p = 1.0 / np.arange(1, 4097) ** 1.2
        src = np.concatenate([np.zeros(1 << 17, np.int64), rng.choice(4096, n - (1 << 17), p=p / p.sum())])
        dst = np.concatenate([np.arange(1, (1 << 17) + 1), rng.integers(0, 1 << 17, n - (1 << 17))])
        perm = rng.permutation(n)
        return src[perm], dst[perm], np.ones(n, bool), None
    if case == "masked":
        n = 1 << 14
        return rng.integers(0, 300, n), rng.integers(0, 300, n), rng.random(n) < 0.3, None
    if case == "ragged":  # E not a power of two: a key of degree E has no bucket
        n = 3 * 1024 + 5
        return np.where(rng.random(n) < 0.7, 7, rng.integers(0, 50, n)), rng.integers(0, 50, n), np.ones(n, bool), None
    if case == "one-row":
        return np.array([3]), np.array([9]), np.array([True]), None
    if case == "out-of-range":
        c, n = 16, 1 << 12
        ids = np.array([-1, c, c + 5, -c - 2, c - 1, 0, 3])
        return rng.choice(ids, n), rng.choice(ids, n), rng.random(n) < 0.8, None
    n = 1 << 16
    src, dst = rng.integers(0, 1 << 12, n), rng.integers(0, 1 << 12, n)
    if case == "values":
        vals = (rng.random(n).astype(np.float32), rng.integers(-9, 9, (n, 3)).astype(np.int32),
                rng.random(n) < 0.5)
        return src, dst, rng.random(n) < 0.9, vals
    return src, dst, np.ones(n, bool), None


@pytest.mark.parametrize("case", BUCKET_CASES)
def test_build_buckets_kernel_matches_twin(cuda_device, case):
    from gelly_streaming_tpu_torch.core.types import tree_leaves, tree_map
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh

    rng = np.random.default_rng(BUCKET_CASES.index(case))
    src, dst, mask, vals = _bucket_case(rng, case)
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda_device) for a in (src, dst)]
    tvals = tree_map(lambda a: torch.from_numpy(a).to(cuda_device), vals)
    tmask = torch.from_numpy(np.ascontiguousarray(mask)).to(cuda_device)
    want = nbh.build_buckets_plain(*args, tvals, tmask)
    before = nbh.LAUNCHES["build_buckets"]
    got = nbh.build_buckets(*args, tvals, tmask)
    torch.cuda.synchronize()
    assert nbh.LAUNCHES["build_buckets"] == before + 1
    assert len(got) == len(want) == len(nbh.bucket_shapes(len(src)))
    for g, w in zip(got, want):
        assert g.num_keys == w.num_keys
        for a, b in zip((g.keys, g.nbrs, g.valid, *tree_leaves(g.vals)), (w.keys, w.nbrs, w.valid, *tree_leaves(w.vals))):
            assert a.shape == b.shape and torch.equal(a, b)


SAGE_CASES = [  # (name, C, F_in, F_out, K, D): wgmma widths (F_in, F_out multiples of 8; output
    # columns padded to 64; F_in past one K chunk) and CUDA-core widths (F_in past 512 too)
    ("f128-d1", 4096, 128, 128, 3000, 1),
    ("f128-d8", 4096, 128, 128, 2000, 8),
    ("f128-d5", 4096, 128, 128, 900, 5),
    ("f128-d16", 4096, 128, 128, 700, 16),
    ("f128-d32", 4096, 128, 128, 300, 32),
    ("f128-d256", 4096, 128, 128, 64, 256),
    ("f128-d1024", 4096, 128, 128, 9, 1024),
    ("f128-hub", 1 << 16, 128, 128, 1, 1 << 17),
    ("f16-f8-d4", 512, 16, 8, 700, 4),
    ("f256-f200-d2", 2048, 256, 200, 300, 2),
    ("f512-f64-d3", 1024, 512, 64, 100, 3),
    ("f8-f8-d16", 512, 8, 8, 700, 16),
    ("f12-f20-d4", 512, 12, 20, 700, 4),
    ("f40-f24-d600", 512, 40, 24, 5, 600),
    ("f128-f12-d8", 512, 128, 12, 130, 8),
    ("f64-f192-d40", 1024, 64, 192, 300, 40),
    ("f256-f256-d8", 2048, 256, 256, 200, 8),
    ("f24-f40-d6", 512, 24, 40, 300, 6),
    ("f640-f128-d4", 1024, 640, 128, 200, 4),
    ("f520-f264-d40", 1024, 520, 264, 100, 40),
    ("f602-f41-d3", 1024, 602, 41, 150, 3),
    ("f1030-f200-d300", 512, 1030, 200, 70, 300),
]
# the layer against its twin: both round the mean once (at most one bf16
# step apart where the sums' order flips a rounding, carried through W ~
# N(0, 1/F_in): well below 2^-9) and the output once (one bf16 step,
# 2^-7 of the value)
SAGE_RTOL, SAGE_ATOL = 2.0 ** -7, 2.0 ** -9


def _layer_inputs(dev, c, f_in, f_out, k, d, seed):
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(c, f_in)).astype(np.float32)).to(dev, torch.bfloat16)
    keys = torch.from_numpy(rng.integers(-c - 3, c + 3, k).astype(np.int32)).to(dev)
    nbrs = torch.from_numpy(rng.integers(-c - 3, c + 3, (k, d)).astype(np.int32)).to(dev)
    valid = rng.random((k, d)) < 0.7
    if k:
        valid[0] = False  # a row with no valid neighbor
    valid = torch.from_numpy(valid).to(dev)
    w = torch.from_numpy(rng.normal(size=(2 * f_in, f_out)).astype(np.float32) / np.sqrt(f_in)).to(dev, torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=f_out).astype(np.float32) * 0.1).to(dev, torch.bfloat16)
    return table, keys, nbrs, valid, w, bias


@pytest.mark.parametrize("case", SAGE_CASES, ids=[c[0] for c in SAGE_CASES])
def test_sage_gather_mean_kernel_matches_twin(cuda_device, case):
    """The fused layer (gather, mean, product, bias, ReLU) against its twin,
    on both instantiations, over K chunks and n-tiles, and on rows past one
    256-slot chunk."""
    from gelly_streaming_tpu_torch.ops import sage

    _name, c, f_in, f_out, k, d = case
    args = _layer_inputs(cuda_device, c, f_in, f_out, k, d, f_in * d + k)
    want = sage.sage_layer_plain(*args)
    before = sage.LAUNCHES["sage_layer"]
    got = sage.sage_layer(*args)
    torch.cuda.synchronize()
    assert sage.LAUNCHES["sage_layer"] == before + 1
    assert got.shape == (k, f_out) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=SAGE_RTOL, atol=SAGE_ATOL)


def test_sage_layer_writes_at_a_row_offset_and_skips_an_empty_bucket(cuda_device):
    from gelly_streaming_tpu_torch.ops import sage

    table, keys, nbrs, valid, w, bias = _layer_inputs(cuda_device, 4096, 128, 128, 100, 4, 5)
    out = torch.full((300, 128), 7.0, dtype=torch.bfloat16, device=cuda_device)
    before = sage.LAUNCHES["sage_layer"]
    rows = sage.sage_layer(table, keys, nbrs, valid, w, bias, out=out, row0=37)
    empty = sage.sage_layer(table, keys[:0], nbrs[:0], valid[:0], w, bias, out=out, row0=300)
    torch.cuda.synchronize()
    assert sage.LAUNCHES["sage_layer"] == before + 1 and empty.shape == (0, 128)
    assert rows.data_ptr() == out[37].data_ptr()
    assert bool((out[:37] == 7).all()) and bool((out[137:] == 7).all())
    torch.testing.assert_close(out[37:137].float(), sage.sage_layer_plain(table, keys, nbrs, valid, w, bias).float(),
                               rtol=SAGE_RTOL, atol=SAGE_ATOL)
    wide = _layer_inputs(cuda_device, 64, 528, 8, 4, 2, 6)  # past one K chunk, into an out buffer too
    out2 = torch.zeros((9, 8), dtype=torch.bfloat16, device=cuda_device)
    sage.sage_layer(*wide, out=out2, row0=5)
    torch.testing.assert_close(out2[5:].float(), sage.sage_layer_plain(*wide).float(), rtol=SAGE_RTOL, atol=SAGE_ATOL)
    assert bool((out2[:5] == 0).all())


MEAN_CASES = ["f128-d8", "f128-d1024", "f128-hub", "f12-f20-d4", "f40-f24-d600", "f640-f128-d4", "f1030-f200-d300"]


@pytest.mark.parametrize("name", MEAN_CASES)
def test_sage_layer_mean_matches_twin_at_one_bf16_step(cuda_device, name):
    """The mean itself, held at one bf16 step: with W = [0; I], no bias and
    a table of values >= 1 (ReLU keeps them) the layer writes bf16(mean),
    which a dropped chunk or a wrong count would move by far more than the
    layer tolerance lets show through a random W."""
    from gelly_streaming_tpu_torch.ops import sage

    _name, c, f_in, _f_out, k, d = next(case for case in SAGE_CASES if case[0] == name)
    table, keys, nbrs, valid, _w, _b = _layer_inputs(cuda_device, c, f_in, f_in, k, d, f_in * d + k)
    table = (table.float().abs() + 1).to(torch.bfloat16)
    w = torch.cat([torch.zeros(f_in, f_in), torch.eye(f_in)]).to(cuda_device, torch.bfloat16)
    bias = torch.zeros(f_in, dtype=torch.bfloat16, device=cuda_device)
    got = sage.sage_layer(table, keys, nbrs, valid, w, bias).float()
    mean = sage.gather_mean_plain(table, keys, nbrs, valid)[:, f_in:].float()
    want = sage.sage_layer_plain(table, keys, nbrs, valid, w, bias).float()
    assert torch.equal(want, mean)
    assert bool((mean[valid.any(1)] >= 1).all())
    torch.testing.assert_close(got, want, rtol=2.0 ** -7, atol=1e-6)


def test_sage_layer_runs_an_empty_neighborhood(cuda_device):
    """D = 0 (the training contexts): the mean is 0 and the layer writes
    relu(x_self @ W_self + b)."""
    from gelly_streaming_tpu_torch.ops import sage

    table, keys, nbrs, valid, w, bias = _layer_inputs(cuda_device, 4096, 128, 128, 3000, 0, 9)
    got = sage.sage_layer(table, keys, nbrs, valid, w, bias).float()
    want = sage.sage_layer_plain(table, keys, nbrs, valid, w, bias).float()
    torch.testing.assert_close(got, want, rtol=SAGE_RTOL, atol=SAGE_ATOL)
    self_only = torch.relu(table[sage.indexing.gather_index(keys, 4096)].float() @ w[:128].float() + bias.float())
    torch.testing.assert_close(got, self_only.to(torch.bfloat16).float(), rtol=SAGE_RTOL, atol=SAGE_ATOL)


# backward-only buckets: (C, F_in, F_out, K, D).  k19237 = 64 * 300 + 37:
# more 64-row tiles than the grid has blocks, the last one ragged (a
# persistent block's stage holds its previous tile's rows past the
# bucket); k1 and k65: one row, and one row past a tile; f384: past one K
# chunk of the tensor-core kernel; f256 out: two passes of 128 dw columns;
# "-view": the ids and flags a view 5 slots into a larger buffer (as
# build_buckets' buckets are), so neither starts 16-byte aligned.
BACKWARD_SHAPES = {
    "f128-d8-k19237-view": (1 << 16, 128, 128, 64 * 300 + 37, 8),
    "f128-d0": (4096, 128, 128, 3000, 0),
    "f128-d8-k19237": (1 << 16, 128, 128, 64 * 300 + 37, 8),
    "f128-d4-k1": (4096, 128, 128, 1, 4),
    "f128-d4-k65": (4096, 128, 128, 65, 4),
    "f128-d0-k19237": (1 << 16, 128, 128, 64 * 300 + 37, 0),
    "f384-f128-d4": (2048, 384, 128, 700, 4),
    "f128-f256-d4": (2048, 128, 256, 700, 4),
}
BACKWARD_CASES = ["f128-d0", "f128-d8", "f128-d32", "f128-d1024", "f128-hub", "f12-f20-d4", "f602-f41-d3",
                  "f40-f24-d600", "f256-f200-d2", "f128-d8-k19237", "f128-d4-k1", "f128-d4-k65", "f128-d0-k19237",
                  "f384-f128-d4", "f128-f256-d4", "f128-d8-k19237-view"]


def _backward_inputs(dev, name, seed=0):
    """A bucket (SAGE_CASES or BACKWARD_SHAPES), its layer output z and a
    bf16 gradient dz of it."""
    from gelly_streaming_tpu_torch.ops import sage

    if name in BACKWARD_SHAPES:
        c, f_in, f_out, k, d = BACKWARD_SHAPES[name]
    else:
        _name, c, f_in, f_out, k, d = next(case for case in SAGE_CASES if case[0] == name)
    args = _layer_inputs(dev, c, f_in, f_out, k, d, f_in * d + k + seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    if k == 1:  # the hub row: valid neighbors (_layer_inputs empties row 0)
        args = (*args[:3], torch.rand(args[3].shape, generator=g, device=dev) < 0.7, *args[4:])
    if name.endswith("-view"):
        views = []
        for t in args[2:4]:
            buf = torch.zeros((t.numel() + 9,), dtype=t.dtype, device=dev)
            views.append(buf[5 : 5 + t.numel()].view(t.shape).copy_(t))
        args = (*args[:2], *views, *args[4:])
    z = sage.sage_layer(*args)
    dz = torch.randn(z.shape, generator=g, device=dev).to(torch.bfloat16)
    return args[:4], z, dz


def _backward_bound(table, keys, nbrs, valid, z, dz):
    """One bf16 step of every A entry carried through the product (a mean
    may round one step apart, the kernel multiplying by the count's
    reciprocal where the twin divides; the f32 sums' order is far inside
    it): 2^-7 |A|^T |dH|, and 2^-10 sum |dH| for db."""
    from gelly_streaming_tpu_torch.ops import sage

    dh = torch.where(z > 0, dz.float(), 0.0).abs()
    a = sage.gather_mean_plain(table, keys, nbrs, valid).float().abs()
    return 2.0 ** -7 * (a.T @ dh) + 1e-6, 2.0 ** -10 * dh.sum(0) + 1e-6


@pytest.mark.parametrize("name", BACKWARD_CASES)
def test_sage_layer_backward_kernel_matches_twin(cuda_device, name):
    """The weight-gradient kernel against its twin, at F = 128 for D = 0,
    8, 32 and 1024 (the partial-sum kernel's chunks), a hub row, buckets of
    1 row, 65 rows and more tiles than the grid's blocks with a ragged last
    tile, and at widths that are not multiples of 8 (2-byte loads) or pass
    one K chunk or n-tile; two runs give the same dw and db bit for bit."""
    from gelly_streaming_tpu_torch.ops import sage

    (table, keys, nbrs, valid), z, dz = _backward_inputs(cuda_device, name)
    f_in, f_out = table.shape[1], z.shape[1]

    def run(fn):
        dw = torch.full((2 * f_in, f_out), 0.5, dtype=torch.float32, device=cuda_device)
        db = torch.full((f_out,), -0.25, dtype=torch.float32, device=cuda_device)
        fn(table, keys, nbrs, valid, z, dz, dw, db)
        return dw, db

    before = sage.LAUNCHES["sage_layer_backward"]
    got = run(sage.sage_layer_backward)
    again = run(sage.sage_layer_backward)
    torch.cuda.synchronize()
    assert sage.LAUNCHES["sage_layer_backward"] == before + 2
    want = run(sage.sage_layer_backward_plain)
    tol = _backward_bound(table, keys, nbrs, valid, z, dz)
    for g, a, w, t in zip(got, again, want, tol):
        assert torch.equal(g, a)
        assert bool(((g - w).abs() <= t).all()), float((g - w).abs().max())
    # no neighbors (D = 0): the mean is 0 and the W_nbr half is left as it
    # was, bit for bit
    assert bool((got[0][f_in:] == 0.5).all()) == (nbrs.shape[1] == 0)


def test_sage_layer_fn_gradients_match_the_twins_autograd(cuda_device):
    """One step's loss and gradients through SageLayerFn (the kernels)
    against autograd of the plain twin on the card, within the JAX
    package's bounds between its training planes."""
    from gelly_streaming_tpu_torch.library import graphsage as gs
    from gelly_streaming_tpu_torch.ops import sage

    rng = np.random.default_rng(3)
    c, f, k, d = 1 << 12, 128, 2048, 40
    table = torch.from_numpy(rng.normal(size=(c, f)).astype(np.float32)).to(cuda_device, torch.bfloat16)
    keys = torch.from_numpy(rng.integers(0, c, k).astype(np.int32)).to(cuda_device)
    nbrs = torch.from_numpy(rng.integers(0, c, (k, d)).astype(np.int32)).to(cuda_device)
    valid = torch.from_numpy(rng.random((k, d)) < 0.8).to(cuda_device)
    state = gs.sage_init_train(f, f, lr=1e-2, generator=torch.Generator().manual_seed(0), device=cuda_device)
    pairs = gs.sample_pairs(torch.Generator(device=cuda_device).manual_seed(1), nbrs, valid, c)
    args = (table, keys, nbrs, valid, *pairs)
    before = dict(sage.LAUNCHES)
    loss = gs.sage_loss(state.params, *args)
    grads = torch.autograd.grad(loss, list(state.params))
    assert sage.LAUNCHES["sage_layer"] == before["sage_layer"] + 2
    assert sage.LAUNCHES["sage_layer_backward"] == before["sage_layer_backward"] + 2
    loss_p = gs._loss(sage.sage_layer_plain, state.params, *args)
    grads_p = torch.autograd.grad(loss_p, list(state.params))
    torch.testing.assert_close(loss, loss_p, rtol=2e-2, atol=0)
    for g, w in zip(grads, grads_p):
        torch.testing.assert_close(g, w, rtol=5e-2, atol=5e-3)
    state, first = gs.sage_train_step(state, *args)
    for _ in range(9):
        state, last = gs.sage_train_step(state, *args)
    assert float(last) < float(first)


SORT_CASES = {  # name: (src, mask) from rng
    "negative-ids": lambda rng: (rng.integers(-5000, 5000, 70001), rng.random(70001) < 0.8),
    "past-24-bits": lambda rng: (rng.integers(-(1 << 30), (1 << 30) - 1, 1 << 18), np.ones(1 << 18, bool)),
    "ragged-n": lambda rng: (rng.integers(0, 1 << 20, 4096 * 3 + 17), rng.random(4096 * 3 + 17) < 0.5),
    "one-key": lambda rng: (np.full(50000, 123456), rng.random(50000) < 0.9),
    "all-masked": lambda rng: (rng.integers(0, 100, 5000), np.zeros(5000, bool)),
    "one-row": lambda rng: (np.array([-7]), np.array([True])),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_build_buckets_sort_matches_torch_sort(cuda_device, case):
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh

    rng = np.random.default_rng(len(case))
    src, mask = SORT_CASES[case](rng)
    dst = rng.integers(-9, 1 << 20, len(src))
    ts, td = (torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(cuda_device) for a in (src, dst))
    tm = torch.from_numpy(np.ascontiguousarray(mask)).to(cuda_device)
    s, d, i, passes = nbh.sort_valid_rows(ts, td, tm)
    ws, wd, wi = nbh.sort_valid_rows_plain(ts, td, tm)
    assert torch.equal(i, wi) and torch.equal(s, ws) and torch.equal(d, wd)
    v = src[mask]
    assert passes == len(nbh.radix_plan(*((int(v.min()), int(v.max())) if len(v) else (None, None))))
    got = nbh.build_buckets(ts, td, None, tm)
    want = nbh.build_buckets_plain(ts, td, None, tm)
    for g, w in zip(got, want):
        assert g.num_keys == w.num_keys
        for a, b in ((g.keys, w.keys), (g.nbrs, w.nbrs), (g.valid, w.valid)):
            assert a.shape == b.shape and torch.equal(a, b)


def test_slice_and_graphsage_on_gpu_match_cpu(cuda_device):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeDirection
    from gelly_streaming_tpu_torch.library import graphsage as gs

    rng = np.random.default_rng(11)
    c, n = 256, 3000
    edges = [(int(a), int(b), float(x)) for a, b, x in
             zip(rng.integers(0, c, n), rng.integers(0, c, n), rng.integers(0, 100, n))]
    cfg = StreamConfig(vertex_capacity=c, batch_size=512, ingest_window_edges=1024)
    feats = rng.normal(size=(c, 16)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    layers = [gs.init_params(16, 16, generator=gen, device="cpu") for _ in range(2)]

    def run(dev):
        stream = EdgeStream.from_collection(edges, cfg, batch_size=512, device=dev)
        snap = stream.slice(1000, EdgeDirection.ALL)
        fold = snap.fold_neighbors((0, 0.0), lambda acc, vid, nbr, val: (vid, acc[1] + val)).collect()
        red = snap.reduce_on_edges(lambda a, b: torch.maximum(a, b)).collect()
        app = snap.apply_on_neighbors(lambda vid, nb, vals, ok: (vid, ok.sum())).collect()
        one = list(gs.GraphSAGEWindows(layers[0], feats, device=dev).run(snap))
        two = list(gs.GraphSAGEWindows(layers, feats, device=dev).run(snap))
        return fold, red, app, one, two

    cpu, gpu = run("cpu"), run(cuda_device)
    assert cpu[:3] == gpu[:3]
    for wins_c, wins_g in zip(cpu[3:], gpu[3:]):
        assert len(wins_c) == len(wins_g) == 3
        for (kc, ec), (kg, eg) in zip(wins_c, wins_g):
            np.testing.assert_array_equal(kc, kg)
            np.testing.assert_allclose(eg, ec, rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# csr_triangles: the masked-CSR count of K panes


def _csr_rows(panes, dedup=True, loops=False):
    """[K, E_pad] int32 u, v and bool ok of each pane's canonical edges
    (deduplicated unless ``dedup`` is False; self-loops dropped unless
    ``loops``), ids as given; (u, v, ok, num_vertices, max_deg) with
    max_deg a power of two bounding every row."""
    rows = []
    for src, dst in panes:
        lo, hi = np.minimum(src, dst), np.maximum(src, dst)
        keep = (lo != hi) | loops
        pairs = np.stack([lo[keep], hi[keep]], axis=1)
        if dedup:
            pairs = np.unique(pairs, axis=0)
        rows.append(pairs)
    e_pad = max(1, 1 << (max(len(r) for r in rows) - 1).bit_length())
    k = len(rows)
    u = np.zeros((k, e_pad), np.int32)
    v = np.zeros((k, e_pad), np.int32)
    ok = np.zeros((k, e_pad), bool)
    n_v, d_max = 1, 1
    for i, pairs in enumerate(rows):
        u[i, : len(pairs)], v[i, : len(pairs)], ok[i, : len(pairs)] = pairs[:, 0], pairs[:, 1], True
        if len(pairs):
            n_v = max(n_v, int(pairs.max()) + 1)
            d_max = max(d_max, int(np.bincount(pairs.ravel()).max()))
    return u, v, ok, n_v, 1 << (d_max - 1).bit_length()


def _csr_case(name, rng):
    if name == "uniform":
        return [(rng.integers(0, 300, 4000), rng.integers(0, 300, 4000)) for _ in range(4)]
    if name == "padding_rows":  # an all-masked row and an empty pane among real ones
        return [(rng.integers(0, 200, 3000), rng.integers(0, 200, 3000)), (np.zeros(0, int), np.zeros(0, int)),
                (rng.integers(0, 90, 700), rng.integers(0, 90, 700)), (np.array([5]), np.array([5]))]
    if name == "hub":  # a star, and two hubs sharing 1030 neighbours: rows past the warp's share
        star = (np.zeros(1100, int), rng.integers(1, 3000, 1100))
        shared = np.arange(10, 1040)
        pair = (np.concatenate([np.full(1030, 1), np.full(1030, 2), [1]]), np.concatenate([shared, shared, [2]]))
        return [star, pair, (rng.integers(0, 3000, 2000), rng.integers(0, 3000, 2000))]
    if name == "wide_keys":  # ids past 2^16 (the parent's (row, col) keys past 31 bits)
        ids = rng.choice(1 << 17, 3000, replace=False)
        return [(ids[rng.integers(0, 3000, 6000)], ids[rng.integers(0, 3000, 6000)]) for _ in range(2)]
    if name == "self_loops":  # self-loop slots beside real edges, on short rows and on a long one (a block's)
        loops = rng.integers(0, 300, 60)
        star = np.arange(1, 400)
        return [(np.concatenate([rng.integers(0, 300, 4000), loops]), np.concatenate([rng.integers(0, 300, 4000),
                                                                                      loops])),
                (np.concatenate([np.zeros(399, int), [0, 0, 7], rng.integers(1, 400, 600)]),
                 np.concatenate([star, [0, 0, 7], rng.integers(1, 400, 600)]))]
    if name == "multiplicity":  # a triangle's edges 300, 270 and 260 times; a long row past kWarpRow beside them
        tri = [(1, 2)] * 300 + [(2, 3)] * 270 + [(1, 3)] * 260 + [(1, 3 + i) for i in range(1, 200)]
        tri += [(3 + i, 4 + i) for i in range(1, 150)] * 2
        a, b = np.array(tri).T
        return [(a, b), (rng.integers(0, 60, 900), rng.integers(0, 60, 900))]
    if name == "wide_ids":  # ids past the block lookup's reach (8 * 192 KB bits): its bitmap goes in passes
        ids = np.sort(rng.choice(2_000_000, 600, replace=False))
        ids[-1] = 1_999_999
        ring = np.arange(1, 200)
        return [(np.concatenate([np.full(200, ids[0]), ids[ring], ids[rng.integers(1, 600, 3000)]]),
                 np.concatenate([ids[1:201], ids[ring + 1], ids[rng.integers(1, 600, 3000)]]))]
    if name == "sixteen_panes":  # K = 16 panes of uneven sizes, one empty
        sizes = [0, 3, 40, 5000, 700, 12, 2000, 90, 4000, 1, 300, 64, 2500, 150, 800, 7]
        return [(rng.integers(0, max(2, n // 4), n), rng.integers(0, max(2, n // 4), n)) for n in sizes]
    if name == "hub_chunks":  # a hub whose neighbours have long rows: its owned slots span many blocks
        nbrs = np.arange(1, 1001)
        a, b = rng.integers(1, 1001, 70000), rng.integers(1, 1001, 70000)
        return [(np.concatenate([np.zeros(1000, int), a]), np.concatenate([nbrs, b]))]
    raise ValueError(name)


@pytest.mark.parametrize("name", ["uniform", "padding_rows", "hub", "wide_keys", "self_loops", "multiplicity",
                                  "wide_ids", "sixteen_panes", "hub_chunks"])
@pytest.mark.parametrize("dedup", [True, False])
def test_csr_triangles_kernel_matches_twin(cuda_device, name, dedup):
    from gelly_streaming_tpu_torch.ops import csr_triangles as ct

    u, v, ok, n_v, d = _csr_rows(_csr_case(name, np.random.default_rng(len(name))), dedup, loops=name == "self_loops")
    tu, tv, tok = (torch.from_numpy(a).to(cuda_device) for a in (u, v, ok))
    before = ct.LAUNCHES["csr_triangles"]
    got = ct.csr_triangles(tu, tv, tok, n_v, d)
    assert ct.LAUNCHES["csr_triangles"] == before + 1
    want = ct.csr_triangles_plain(tu, tv, tok, n_v, d)
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    assert torch.equal(got, ct.csr_triangles(tu, tv, tok, n_v, d))  # repeatable
    if name == "hub":
        assert got[1].item() == 1030  # hubs 1 and 2 close a triangle with each shared neighbour
    if name == "multiplicity" and not dedup:
        assert got[0].item() >= 300 * 270 * 260  # the triangle (1, 2, 3), each edge a multiset
    plan = ct.plan(*u.shape, n_v)
    if name == "wide_ids":
        assert plan.bitmap_passes > 1 and d > ct.WARP_ROW
    if name == "hub_chunks":
        assert d > ct.WARP_ROW


@pytest.mark.parametrize("k,e,n_v", [(4, 1 << 17, 4096), (1, 32768, 11941), (1, 1 << 20, 175957),
                                     (1, 4096, 2_000_000), (16, 8192, 1250), (3, 5, 1)])
def test_csr_plan_equals_the_kernel_scratch(cuda_device, k, e, n_v):
    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import csr_triangles as ct

    assert ct.scratch_bytes(k, e, n_v) == _cuda.library("csr_triangles.cu").csr_scratch_bytes(k, e, n_v)


def test_csr_triangles_kernel_counts_a_complete_graph(cuda_device):
    from gelly_streaming_tpu_torch.ops import csr_triangles as ct

    n = 200
    a, b = np.triu_indices(n, 1)
    u, v, ok, n_v, d = _csr_rows([(a, b)])
    got = ct.csr_triangles(*(torch.from_numpy(x).to(cuda_device) for x in (u, v, ok)), n_v, d)
    assert got.tolist() == [n * (n - 1) * (n - 2) // 6]


@pytest.mark.parametrize("plane", [dict(async_windows=3), dict(superbatch=4), dict(superbatch=3, async_windows=2)])
def test_async_and_superbatch_planes_on_gpu_match_cpu(cuda_device, plane):
    """The windowed planes of the async pipeline and the superbatch groups
    on the card: CC, bipartiteness, the degree summary (valued batches),
    window_triangles and reduce_on_edges emit the CPU path's records."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeDirection
    from gelly_streaming_tpu_torch.io.sources import _batched
    from gelly_streaming_tpu_torch.library.bipartiteness import BipartitenessCheck
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.library.degree_distribution import DegreeDistributionSummary
    from gelly_streaming_tpu_torch.library.triangles import window_triangles
    from gelly_streaming_tpu_torch.ops import csr_triangles as ct

    rng = np.random.default_rng(11)
    n = 12000
    src, dst = rng.integers(0, 700, n), rng.integers(0, 700, n)
    tim = np.sort(rng.integers(0, 9000, n))
    val = rng.random(n).astype(np.float32)
    cfg = StreamConfig(vertex_capacity=1 << 10, batch_size=1000, **plane)

    def stream(dev):
        return EdgeStream.from_batches(_batched(src, dst, val, tim, None, 1000, dev), cfg, device=dev)

    def run(dev):
        cc = [r[0].parent.cpu() for r in stream(dev).aggregate(ConnectedComponents(window_ms=1000)).collect()]
        bip = [str(r[0]) for r in stream(dev).aggregate(BipartitenessCheck(window_ms=1000)).collect()]
        deg = [r[0].cpu() for r in stream(dev).aggregate(DegreeDistributionSummary(window_ms=1000)).collect()]
        tri = window_triangles(stream(dev), 1000).collect()
        red = stream(dev).slice(1000, EdgeDirection.OUT).reduce_on_edges(lambda a, b: a + b).collect()
        return cc, bip, deg, tri, red

    before = ct.LAUNCHES["csr_triangles"]
    gpu, cpu = run(cuda_device), run("cpu")
    assert len(gpu[0]) == len(cpu[0]) == 9
    assert all(torch.equal(a, b) for a, b in zip(gpu[0], cpu[0]))
    assert gpu[1] == cpu[1]
    assert all(torch.equal(a, b) for a, b in zip(gpu[2], cpu[2]))
    assert gpu[3] == cpu[3] and any(c > 0 for c, _ in gpu[3])
    assert gpu[4] == cpu[4] and len(gpu[4]) > 500
    if "superbatch" in plane:
        assert ct.LAUNCHES["csr_triangles"] >= before + 3


# ---------------------------------------------------------------------------
# the streaming exact triangle fold (csrc/exact_triangles.cu)

TRI_C = 1 << 10


def _tri_batch(rng, b: int):
    """A batch over [0, C - 2): a hub on an eighth of the rows (past D =
    256 neighbors over a 2^16 batch), duplicates, self-loops, a masked
    tenth, and ids -1, -2, C and C + 3 (never aliasing a positive id)."""
    src = rng.integers(0, TRI_C - 2, b).astype(np.int32)
    dst = rng.integers(0, TRI_C - 2, b).astype(np.int32)
    src[: max(1, b // 8)] = 1
    dst[b // 2 : b // 2 + 3] = src[b // 2 : b // 2 + 3]
    if b > 16:
        src[-6:], dst[-6:] = src[:6], dst[:6]
        src[3], dst[7], src[9], dst[11] = -1, -2, TRI_C, TRI_C + 3
    mask = rng.random(b) < 0.9
    return src, dst, mask


def _tri_start(d: int, dev):
    """The state after a first batch of 4096 edges (folded by the twin)."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.library.triangles import init_triangle_state
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    state = init_triangle_state(StreamConfig(vertex_capacity=TRI_C, max_degree=d), dev)
    s, t, m = (torch.from_numpy(a).to(dev) for a in _tri_batch(np.random.default_rng(d), 4096))
    return et.triangle_update_block_plain(state, s, t, m)


def _tri_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip((*a.table, a.local, a.global_count),
                                                           (*b.table, b.local, b.global_count)))


@pytest.mark.parametrize("d", [4, 64, 256])
@pytest.mark.parametrize("b", [1, 1 << 16])
def test_triangle_block_kernel_matches_twin(cuda_device, d, b):
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    start = _tri_start(d, cuda_device)
    s, t, m = (torch.from_numpy(a).to(cuda_device) for a in _tri_batch(np.random.default_rng(b + d), b))
    want = et.triangle_update_block_plain(start, s, t, m)
    state = et.clone_state(start)
    before = et.LAUNCHES["triangle_block"]
    assert et.triangle_update_block(state, s, t, m) is state
    torch.cuda.synchronize()
    assert et.LAUNCHES["triangle_block"] == before + 1
    assert _tri_equal(state, want)
    if b > 1:
        assert int(state.table.dropped) > int(start.table.dropped) and int(state.global_count) > 0


@pytest.mark.parametrize("chunk", [1, 7, 128, 256])
def test_triangle_block_kernel_takes_any_chunk(cuda_device, chunk):
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    start = _tri_start(16, cuda_device)
    s, t, m = (torch.from_numpy(a).to(cuda_device) for a in _tri_batch(np.random.default_rng(chunk), 3001))
    want = et.triangle_update_block_plain(start, s, t, m, chunk=chunk)
    state = et.triangle_update_block(et.clone_state(start), s, t, m, chunk=chunk)
    assert _tri_equal(state, want)
    with pytest.raises(ValueError):
        et.triangle_update_block(state, s, t, m, chunk=et.MAX_CHUNK + 1)


@pytest.mark.parametrize("d,b", [(4, 1 << 16), (64, 1 << 16), (256, 1), (256, 1 << 12)])
def test_triangle_trace_kernel_matches_twin(cuda_device, d, b):
    """The twin on the card replays its edge steps from a CUDA graph (held
    equal to the CPU twin below)."""
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    start = _tri_start(d, cuda_device)
    s, t, m = (torch.from_numpy(a).to(cuda_device) for a in _tri_batch(np.random.default_rng(b + d + 1), b))
    want, want_local, want_global = et.triangle_update_plain(start, s, t, m)
    before = et.LAUNCHES["triangle_trace"]
    state, local_trace, global_trace = et.triangle_update(et.clone_state(start), s, t, m)
    torch.cuda.synchronize()
    assert et.LAUNCHES["triangle_trace"] == before + 1
    assert _tri_equal(state, want)
    assert torch.equal(local_trace, want_local) and torch.equal(global_trace, want_global)


@pytest.mark.parametrize("d", [4, 64])
def test_twins_on_the_card_match_the_cpu_twins(cuda_device, d):
    """The twins replay their steps from a CUDA graph on the card; they
    give the CPU twins' states and traces."""
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    start = _tri_start(d, cuda_device)
    on_cpu = et.TriangleCountState(type(start.table)(*(x.cpu() for x in start.table)), start.local.cpu(),
                                   start.global_count.cpu())
    arrays = _tri_batch(np.random.default_rng(d + 2), 1 << 11)
    s, t, m = (torch.from_numpy(a).to(cuda_device) for a in arrays)
    cs, ct, cm = (torch.from_numpy(a) for a in arrays)
    got = et.triangle_update_block_plain(start, s, t, m, chunk=48)
    assert _tri_equal(got, et.triangle_update_block_plain(on_cpu, cs, ct, cm, chunk=48))
    got = et.triangle_update_plain(start, s[:300], t[:300], m[:300])
    want = et.triangle_update_plain(on_cpu, cs[:300], ct[:300], cm[:300])
    assert _tri_equal(got[0], want[0]) and torch.equal(got[1].cpu(), want[1]) and torch.equal(got[2].cpu(), want[2])


def test_exact_triangle_count_on_gpu_matches_cpu(cuda_device):
    """ExactTriangleCount in both modes on the card emits the CPU path's
    records and blocks, and launches its kernels."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.triangles import ExactTriangleCount
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 300, 5000), rng.integers(0, 300, 5000)
    cfg = StreamConfig(vertex_capacity=512, max_degree=32, batch_size=700)

    def run(dev, mode):
        out = ExactTriangleCount(mode=mode).run(EdgeStream.from_arrays(src, dst, cfg, device=dev))
        return [tuple(c.tolist() for c in blk.columns) for blk in out.blocks()] if mode == "block" else out.collect()

    et.reset_launches()
    for mode in ("block", "trace"):
        assert run(cuda_device, mode) == run("cpu", mode)
    assert et.LAUNCHES == {"triangle_block": 8, "triangle_trace": 8}


# the parallel fold (csrc/exact_triangles.cu since its redesign): batches
# with every counted id in [0, C) and ordinary rows, held against the twins


def _tri_clean(rng, b: int):
    """_tri_batch without the ids outside [0, C): the parallel path's."""
    src, dst, mask = _tri_batch(rng, b)
    for a in (src, dst):
        odd = (a < 0) | (a >= TRI_C)
        a[odd] = rng.integers(0, TRI_C, int(odd.sum()))
    return src, dst, mask


# row 0 full at D = 2, then each row's repeat filling the next: five passes
# (tests/test_torch_exact_plan.py models it)
_CASCADE = [(0, 5), (0, 6), (0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2), (3, 4), (4, 3)]


def _spread_pairs(pairs, r: int):
    b = len(pairs) * r
    src, dst, mask = np.zeros(b, np.int32), np.zeros(b, np.int32), np.zeros(b, bool)
    for i, (u, v) in enumerate(pairs):
        src[i * r], dst[i * r], mask[i * r] = u, v, True
    return src, dst, mask


def _repeat_batch(rng, b: int, c: int):
    """Pairs (0, 1..5) on half the rows: they come back after row 0 fills."""
    src, dst = rng.integers(0, c, b).astype(np.int32), rng.integers(0, c, b).astype(np.int32)
    src[: b // 2], dst[: b // 2] = 0, rng.integers(1, 6, b // 2)
    return src, dst, np.ones(b, bool)


def _empty_state(c: int, d: int, dev):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.library.triangles import init_triangle_state

    return init_triangle_state(StreamConfig(vertex_capacity=c, max_degree=d), dev)


def _both_folds_equal(start, batch, chunk: int) -> None:
    """The block and the trace fold of one batch from ``start`` equal their
    twins (state, and the traces)."""
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    s, t, m = batch
    want = et.triangle_update_block_plain(start, s, t, m, chunk=chunk)
    got = et.triangle_update_block(et.clone_state(start), s, t, m, chunk=chunk)
    assert _tri_equal(got, want)
    want, want_l, want_g = et.triangle_update_plain(start, s, t, m)
    got, got_l, got_g = et.triangle_update(et.clone_state(start), s, t, m)
    assert _tri_equal(got, want) and torch.equal(got_l, want_l) and torch.equal(got_g, want_g)


@pytest.mark.parametrize("chunk", [1, 7, 64, 256])
@pytest.mark.parametrize("name", ["cascade", "repeats", "hub"])
def test_parallel_fold_matches_twin_on_overflow_streams(cuda_device, name, chunk):
    """A cascade of repeats (five fixed-point passes), pairs repeated through
    a full lo row, and a hub past D = 4: both folds on the parallel path."""
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    rng = np.random.default_rng(chunk)
    if name == "cascade":
        state, batches = _empty_state(8, 2, cuda_device), [_spread_pairs(_CASCADE, chunk)]
    elif name == "repeats":
        state, batches = _empty_state(40, 3, cuda_device), [_repeat_batch(rng, 3001, 40) for _ in range(2)]
    else:
        state, batches = _empty_state(TRI_C, 4, cuda_device), [_tri_clean(rng, 3001) for _ in range(2)]
    et.reset_stats()
    for batch in batches:
        batch = tuple(torch.from_numpy(a).to(cuda_device) for a in batch)
        _both_folds_equal(state, batch, chunk)
        state = et.triangle_update_block_plain(state, *batch, chunk=chunk)
    got = et.stats(cuda_device)
    assert got["parallel"] == 2 * len(batches) and got["chain"] == 0
    assert int(state.table.dropped) > 0 and got["max_passes"] >= (5 if name == "cascade" else 2)


def test_flagged_batches_take_the_chain_kernel(cuda_device):
    """An id outside [0, C) on an edge that counts, a negative degree or hi
    past lo's degree sends a batch to the chain kernel; a masked odd id or
    odd values in valid slots do not.  Every batch equals the twins."""
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    rng = np.random.default_rng(7)
    start = _tri_start(16, cuda_device)
    clean = _tri_clean(rng, 2000)
    cases = [("clean", clean, "parallel")]
    for u, v in ((-1, 3), (5, TRI_C), (TRI_C + 3, 2)):
        s, t, m = (a.copy() for a in clean)
        s[9], t[9], m[9] = u, v, True
        cases.append((f"({u}, {v})", (s, t, m), "chain"))
        m = m.copy()
        m[9] = False
        cases.append((f"({u}, {v}) masked", (s, t, m), "parallel"))
    for name, batch, path in cases:
        et.reset_stats()
        _both_folds_equal(start, tuple(torch.from_numpy(a).to(cuda_device) for a in batch), 64)
        got = et.stats(cuda_device)
        assert got[path] == 2 and got["parallel" if path == "chain" else "chain"] == 0, name
    # a pre-batch state with -1, C + 5, -3 in valid slots and a degree past D: parallel
    odd = et.clone_state(start)
    odd.table.nbrs[2, 0], odd.table.nbrs[3, 0], odd.table.nbrs[4, 0] = -1, TRI_C + 5, -3
    odd.table.deg[2:5].clamp_(min=1)
    odd.table.deg[5] = 17
    s, t, m = (torch.from_numpy(a).to(cuda_device) for a in clean)
    s[:3], t[:3] = 2, torch.tensor([3, 4, 5], dtype=torch.int32)
    et.reset_stats()
    _both_folds_equal(odd, (s, t, m), 64)
    assert et.stats(cuda_device)["parallel"] == 2
    # hi past lo's degree, and a negative degree: the chain kernel
    for fix in ("past", "negative"):
        held = et.clone_state(start)
        if fix == "past":
            held.table.deg[7] = 1
            held.table.nbrs[7, 1:] = -1
            held.table.nbrs[7, 2] = 9
            s1, t1 = 7, 9
        else:
            held.table.deg[8] = -1
            s1, t1 = 7, 8
        s, t, m = (torch.from_numpy(a).to(cuda_device) for a in clean)
        s[0], t[0], m[0] = s1, t1, True
        et.reset_stats()
        _both_folds_equal(held, (s, t, m), 64)
        assert et.stats(cuda_device)["chain"] == 2, fix


@pytest.mark.parametrize("d", [4, 64, 256])
def test_parallel_fold_carries_a_state_across_batches(cuda_device, d):
    """Six batches in turn, the state carried by each fold, equal to the
    twins after every batch; all on the parallel path."""
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    rng = np.random.default_rng(d)
    block, trace = _empty_state(TRI_C, d, cuda_device), _empty_state(TRI_C, d, cuda_device)
    want_b, want_t = et.clone_state(block), et.clone_state(trace)
    et.reset_stats()
    for i in range(6):
        s, t, m = (torch.from_numpy(a).to(cuda_device) for a in _tri_clean(rng, 4096 if i % 2 else 3001))
        et.triangle_update_block(block, s, t, m)
        want_b = et.triangle_update_block_plain(want_b, s, t, m)
        assert _tri_equal(block, want_b), i
        _, got_l, got_g = et.triangle_update(trace, s[:700], t[:700], m[:700])
        want_t, want_l, want_g = et.triangle_update_plain(want_t, s[:700], t[:700], m[:700])
        assert _tri_equal(trace, want_t) and torch.equal(got_l, want_l) and torch.equal(got_g, want_g), i
    got = et.stats(cuda_device)
    assert got["parallel"] == 12 and got["chain"] == 0
    assert int(block.global_count) > 0 and int(block.table.dropped) > 0  # the hub passes D


@pytest.mark.parametrize("n,c,d,chunk,trace", [
    (1 << 16, 1 << 20, 64, 64, False), (1 << 16, 1 << 18, 64, 64, False), (1 << 12, 1 << 20, 64, 1, True),
    (3001, 1024, 4, 7, False), (1, 1, 1, 1, True), (700, 1024, 256, 1, True), (77, 300, 5, 256, False)])
def test_exact_scratch_is_the_kernels_and_kept_a_shape(cuda_device, n, c, d, chunk, trace):
    """A call's scratch is the bytes exact_scratch_bytes gives, allocated at
    the first call of a shape and reused by the next."""
    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import exact_triangles as et

    r = 1 if trace else min(chunk, n)
    want = _cuda.library("exact_triangles.cu").exact_scratch_bytes(n, c, d, r, int(trace))
    rng = np.random.default_rng(n)
    s, t = (torch.from_numpy(rng.integers(0, c, n).astype(np.int32)).to(cuda_device) for _ in range(2))
    m = torch.ones(n, dtype=torch.bool, device=cuda_device)
    state = _empty_state(c, d, cuda_device)
    et._scratch.clear()
    held = []
    for _ in range(2):
        if trace:
            et.triangle_update(state, s, t, m)
        else:
            et.triangle_update_block(state, s, t, m, chunk)
        held.append([(key[2:], buf.numel(), buf.data_ptr()) for key, buf in et._scratch.items()])
    assert want > 0 and held[0] == held[1] and [h[:2] for h in held[0]] == [((n, c, d, r, trace), want)]


# ---------------------------------------------------------------------------
# the SpMV core (csrc/spmv.cu) and the k-core round (csrc/kcore.cu)


def _spmv_pane(rng, c, e, dev, case="uniform", w_kind="int"):
    """(src, dst, w, msk) of one pane: uniform, Zipf-skewed sources and
    destinations (rows and segments past a warp), a star, or odd ids."""
    if case == "zipf":
        src = ((rng.zipf(1.2, e) - 1) % c).astype(np.int32)
        dst = ((rng.zipf(1.2, e) - 1) % c).astype(np.int32)
    elif case == "star":
        src = np.where(rng.random(e) < 0.5, 0, rng.integers(0, c, e)).astype(np.int32)
        dst = np.where(rng.random(e) < 0.5, 1, rng.integers(0, c, e)).astype(np.int32)
    else:
        src, dst = (rng.integers(0, c, e).astype(np.int32) for _ in range(2))
    if case == "odd":
        src[[3, 5, 9]], dst[[4, 6, 10]] = (-1, c, c + 3), (-1, -c, c)
    w = rng.integers(1, 8, e).astype(np.float32) if w_kind == "int" else rng.random(e).astype(np.float32)
    msk = rng.random(e) < 0.9
    if case == "odd":
        msk[[3, 4, 5, 6, 9, 10]] = True
    return src, dst, w, msk


def _spmv_x(rng, sem, c, dev):
    if sem.dtype == torch.int32:
        return torch.from_numpy(rng.integers(0, 100, c).astype(np.int32)).to(dev)
    x = rng.integers(0, 10, c).astype(np.float32) - np.float32(3)  # negative entries: both atomic orders
    return torch.from_numpy(x).to(dev)


def _assert_product(sem, got, want):
    assert got.dtype == want.dtype and got.device == want.device
    if sem.name == "plus_times":
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["uniform", "zipf", "star", "odd"])
@pytest.mark.parametrize("name", ["MIN_PLUS", "PLUS_TIMES", "MIN_MIN", "PLUS_ONE"])
def test_spmv_products_match_twins(cuda_device, name, case):
    from gelly_streaming_tpu_torch.ops import spmv

    sem = getattr(spmv, name)
    rng = np.random.default_rng(len(case) * 7 + sem.code)
    for c, e in ((64, 256), (1 << 14, 1 << 17)):
        op = spmv.prepare_pane(*_spmv_pane(rng, c, e, cuda_device, case), c, device=cuda_device)
        x = _spmv_x(rng, sem, c, cuda_device)
        fm = torch.from_numpy(rng.random(c) < 0.3).to(cuda_device)
        fm[0] = True  # the hub's row
        before = spmv.LAUNCHES["spmv_product"]
        _assert_product(sem, spmv.spmv_dense(sem, op, x), spmv.product_plain(sem, op, x))
        _assert_product(sem, spmv.spmsv_frontier(sem, op, x, fm), spmv.product_plain(sem, op, x, fm))
        assert spmv.LAUNCHES["spmv_product"] == before + 2
        # the same bits on a second run
        assert torch.equal(spmv.spmv_dense(sem, op, x), spmv.spmv_dense(sem, op, x))


def _fixpoint_both(spmv, sem, op, x0, fm0, thr, max_iters):
    got = spmv._fixpoint_cuda(sem, op, x0, fm0, thr, max_iters)
    want = spmv.fixpoint_plain(sem, op, x0, fm0, thr, max_iters)
    assert torch.equal(got.x, want.x) and torch.equal(got.frontier, want.frontier)
    assert (got.iters, got.push_iters, got.pull_iters, got.switches, got.hist) == (
        want.iters, want.push_iters, want.pull_iters, want.switches, want.hist)
    return got


@pytest.mark.parametrize("case", ["uniform", "zipf", "star", "odd"])
def test_spmv_fixpoint_matches_twin(cuda_device, case):
    from gelly_streaming_tpu_torch.ops import spmv

    rng = np.random.default_rng(len(case))
    for c, e in ((64, 256), (1 << 14, 1 << 16), (1 << 16, 1 << 18)):
        pane = _spmv_pane(rng, c, e, cuda_device, case, w_kind="float")
        op = spmv.prepare_pane(*pane, c, device=cuda_device)
        x0 = torch.full((c,), spmv.MIN_PLUS.identity, dtype=torch.float32, device=cuda_device)
        x0[int(np.bincount(pane[0][pane[3] & (pane[0] >= 0) & (pane[0] < c)], minlength=c).argmax())] = 0.0
        x0[c - 1] = float("inf")  # above the identity
        fm0 = x0 != spmv.MIN_PLUS.identity
        before = spmv.LAUNCHES["spmv_fixpoint"]
        runs = [_fixpoint_both(spmv, spmv.MIN_PLUS, op, x0, fm0, thr, c - 1) for thr in (2.0, -1.0, 0.05, 0.0, 1.0)]
        assert spmv.LAUNCHES["spmv_fixpoint"] == before + 5
        assert runs[0].pull_iters == 0 and runs[1].push_iters == 0 and runs[0].iters > 1
        if case != "odd":  # ids outside [0, C): the JAX package's push and pull disagree
            for r in runs[1:]:
                assert torch.equal(r.x, runs[0].x)
        _fixpoint_both(spmv, spmv.MIN_PLUS, op, x0, fm0, 0.05, 2)  # bounded
        _fixpoint_both(spmv, spmv.MIN_PLUS, op, x0, fm0, 0.05, 0)
        labels = torch.arange(c, dtype=torch.int32, device=cuda_device)
        _fixpoint_both(spmv, spmv.MIN_MIN, op, labels, torch.ones_like(fm0), 0.05, c)


def test_spmv_fixpoint_wrapper_counts_and_metrics(cuda_device):
    from gelly_streaming_tpu_torch.ops import spmv
    from gelly_streaming_tpu_torch.utils import metrics

    rng = np.random.default_rng(5)
    c = 1 << 12
    op = spmv.prepare_pane(*_spmv_pane(rng, c, 1 << 15, cuda_device, "zipf"), c, device=cuda_device)
    x0 = torch.full((c,), spmv.MIN_PLUS.identity, dtype=torch.float32, device=cuda_device)
    x0[0] = 0.0
    metrics.reset_spmv_stats()
    res = spmv.fixpoint(spmv.MIN_PLUS, op, x0, max_iters=c - 1)
    stats = metrics.spmv_stats()
    assert stats["spmv_iters_total"] == res.iters == res.push_iters + res.pull_iters > 0
    assert sum(stats[f"spmv_density_hist_{b}"] for b in range(metrics.SPMV_DENSITY_BINS)) == res.iters
    assert res.x.device == x0.device


_RANK_TILE = 2048  # csrc/spmv.cu's kTile: merge-path items (segment ends and edges) a tile


def _rank_tile_span(op, v):
    """The tiles from the one holding v's first in-edge to the one holding
    its segment's end."""
    d_off = op.d_off.cpu().numpy().astype(np.int64)
    return (v + d_off[v + 1]) // _RANK_TILE - (v + d_off[v]) // _RANK_TILE


def _rank_pane(rng, case):
    """(c, src, dst, msk): "hub", two hubs of 40,000 and 5,000 in-edges among
    2^17 uniform edges (in arrival order among them); "boundary", segments
    that fill whole tiles (2,047 edges and the end), one filling two, 256 of
    7 edges (thread, warp and tile boundaries), 300 empty ones, then
    segments of 2,046 and 2,049 edges in turn, then uniform edges."""
    if case == "hub":
        c = 1 << 16
        dst = np.concatenate([np.full(40000, 3), np.full(5000, 4), rng.integers(0, c, 1 << 17)])
    else:
        c = 1 << 14
        degs = [2047] * 4 + [4095] + [7] * 256 + [0] * 300 + [2046, 2049] * 4
        dst = np.concatenate([np.repeat(np.arange(len(degs)), degs), rng.integers(len(degs), c, 1 << 15)])
    src = rng.integers(0, c, len(dst))
    perm = rng.permutation(len(dst))
    return c, src[perm].astype(np.int32), dst[perm].astype(np.int32), np.ones(len(dst), bool)


@pytest.mark.parametrize("case", ["uniform", "zipf", "star", "hub", "boundary"])
def test_pagerank_fixpoint_matches_twin(cuda_device, case):
    """The kernel against its twin on the card, push, pull and a second run
    bit for bit; "hub" and "boundary" (``_rank_pane``) put in-segments over
    many tiles and segment ends on thread, warp and tile boundaries."""
    from gelly_streaming_tpu_torch.ops import spmv

    rng = np.random.default_rng(11 + len(case))
    if case in ("hub", "boundary"):
        panes = [_rank_pane(rng, case)]
    else:
        panes = [(c, *(_spmv_pane(rng, c, e, cuda_device, case)[i] for i in (0, 1, 3)))
                 for c, e in ((64, 256), (1 << 14, 1 << 17), (1 << 18, 1 << 20))]
    for c, src, dst, msk in panes:
        op = spmv.prepare_pane(src, dst, None, msk, c, device=cuda_device)
        if case == "hub":
            assert _rank_tile_span(op, 3) >= 15 and _rank_tile_span(op, 4) >= 2
        elif case == "boundary":
            d_off = op.d_off.cpu().numpy().astype(np.int64)
            ends = np.arange(c) + d_off[1:]  # each segment end's merge-path item
            assert (ends[:5] % _RANK_TILE == _RANK_TILE - 1).all() and _rank_tile_span(op, 4) == 1
        before = spmv.LAUNCHES["pagerank_fixpoint"]
        runs = [spmv.pagerank_fixpoint(op, damping=0.85, tol=1e-6, max_iters=100, use_pull=p)
                for p in (False, True, False)]
        assert spmv.LAUNCHES["pagerank_fixpoint"] == before + 3
        r, in_w, iters = runs[0]
        for r2, in2, it2 in runs[1:]:  # push, pull and a second run: the same bits
            assert torch.equal(r2, r) and torch.equal(in2, in_w) and it2 == iters
        want_r, want_in, want_it = spmv.pagerank_fixpoint_plain(op, damping=0.85, tol=1e-6, max_iters=100)
        assert torch.equal(in_w, want_in) and abs(iters - want_it) <= 1
        torch.testing.assert_close(r, want_r, rtol=1e-5, atol=1e-9)
        assert abs(float(r.double().sum()) - 1.0) < 1e-4
        bounded = spmv.pagerank_fixpoint(op, damping=0.85, tol=1e-6, max_iters=3)
        want_b = spmv.pagerank_fixpoint_plain(op, damping=0.85, tol=1e-6, max_iters=3)
        assert bounded[2] == want_b[2] == 3
        torch.testing.assert_close(bounded[0], want_b[0], rtol=1e-5, atol=1e-9)


def _rmat(rng, scale, edge_factor=16, abc=(0.57, 0.19, 0.19)):
    """Graph500's Kronecker generator (duplicates and self-loops kept)."""
    m = edge_factor << scale
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        src |= (r >= abc[0] + abc[1]).astype(np.int64) << bit
        dst |= (((r >= abc[0]) & (r < abc[0] + abc[1])) | (r >= sum(abc))).astype(np.int64) << bit
    perm = rng.permutation(1 << scale)
    return perm[src].astype(np.int32), perm[dst].astype(np.int32)


@pytest.mark.parametrize("case", ["star", "kronecker"])
def test_spmv_fixpoint_hub_panes_match_twin(cuda_device, case):
    """The balanced products on a hub longer than many pull tiles and push
    shares: a star (vertex 0 with 2^15 out-edges, vertex 1 with 2^15
    in-edges) and a Graph500 Kronecker pane, min-plus from the largest
    out-row and min-min labels, at every forcing threshold, with the
    header's counters equal to the twin's."""
    from gelly_streaming_tpu_torch.ops import spmv

    rng = np.random.default_rng(21)
    if case == "star":
        c, hub = 1 << 17, 1 << 15
        leaves = rng.permutation(np.arange(2, c))[: 2 * hub]
        src = np.concatenate([np.zeros(hub, np.int32), leaves[hub:], rng.integers(0, c, 1 << 14)]).astype(np.int32)
        dst = np.concatenate([leaves[:hub], np.ones(hub, np.int32), rng.integers(0, c, 1 << 14)]).astype(np.int32)
    else:
        c = 1 << 16
        src, dst = _rmat(rng, 16)
    w = rng.random(len(src)).astype(np.float32)
    op = spmv.prepare_pane(src, dst, w, np.ones(len(src), bool), c, device=cuda_device)
    x0 = torch.full((c,), spmv.MIN_PLUS.identity, dtype=torch.float32, device=cuda_device)
    x0[int(np.bincount(src, minlength=c).argmax())] = 0.0
    fm0 = x0 != spmv.MIN_PLUS.identity
    runs = [_fixpoint_both(spmv, spmv.MIN_PLUS, op, x0, fm0, thr, c - 1) for thr in (2.0, -1.0, 0.05, 0.0, 1.0)]
    assert runs[0].pull_iters == 0 and runs[1].push_iters == 0 and runs[0].iters > 1
    for r in runs[1:]:
        assert torch.equal(r.x, runs[0].x)
    labels = torch.arange(c, dtype=torch.int32, device=cuda_device)
    for thr in (2.0, -1.0, 0.05):
        _fixpoint_both(spmv, spmv.MIN_MIN, op, labels, torch.ones_like(fm0), thr, c)
    # one-shot products through the same balanced code
    fm = torch.from_numpy(rng.random(c) < 0.2).to(cuda_device)
    fm[0] = True
    for sem, x in ((spmv.MIN_PLUS, runs[0].x), (spmv.MIN_MIN, labels)):
        assert torch.equal(spmv.spmv_dense(sem, op, x), spmv.product_plain(sem, op, x))
        assert torch.equal(spmv.spmsv_frontier(sem, op, x, fm), spmv.product_plain(sem, op, x, fm))


@pytest.mark.parametrize("c, e", [(1 << 12, 1 << 16), (1 << 15, 1 << 18)])
def test_spmv_fixpoint_grid_follows_the_edges(cuda_device, c, e):
    """A pane of few vertices and many edges: the fixpoint's grid takes a
    block a pull tile (2,048 merge-path items of vertices and padded edges)
    where that is more than a thread a vertex, and the run equals the
    twin's."""
    from gelly_streaming_tpu_torch.ops import spmv

    rng = np.random.default_rng(c)
    src = ((rng.zipf(1.2, e) - 1) % c).astype(np.int32)
    dst = rng.integers(0, c, e).astype(np.int32)
    op = spmv.prepare_pane(src, dst, rng.random(e).astype(np.float32), np.ones(e, bool), c, device=cuda_device)
    x0 = torch.full((c,), spmv.MIN_PLUS.identity, dtype=torch.float32, device=cuda_device)
    x0[0] = 0.0
    fm0 = x0 != spmv.MIN_PLUS.identity
    _fixpoint_both(spmv, spmv.MIN_PLUS, op, x0, fm0, 0.05, c - 1)
    blocks = int(spmv.fixpoint_launch(spmv.MIN_PLUS, op, x0, fm0, 0.05, c - 1)[2][spmv.FIX_BLOCKS])
    assert blocks == -(-(c + op.e_pad) // 2048) > c // 256


def _kcore_pane(src, dst, c):
    from gelly_streaming_tpu_torch.core.windows import WindowPane
    from gelly_streaming_tpu_torch.library import kcore as kc

    return kc.simple_pane_edges(WindowPane(0, -1, src, dst, None, None), c)


def _twin_round(c, keys, nbrs, valid):
    from gelly_streaming_tpu_torch.ops import spmv

    return c.copy_(spmv.kcore_round_plain(c, keys, nbrs, valid))


@pytest.mark.parametrize("scale", [10, 14, 16])
def test_kcore_fixpoint_matches_twin_loop(cuda_device, scale):
    """pane_cores through one kcore_fixpoint launch against the twin's
    per-bucket host loop on Graph500 Kronecker panes: cores and rounds,
    then the refusal at max_rounds = rounds - 1."""
    from gelly_streaming_tpu_torch.library import kcore as kc
    from gelly_streaming_tpu_torch.ops import spmv

    c = 1 << scale
    simple = _kcore_pane(*_rmat(np.random.default_rng(scale), scale), c)
    before = spmv.LAUNCHES["kcore_fixpoint"]
    cores, rounds = kc.pane_cores(*simple, c, cuda_device)
    assert spmv.LAUNCHES["kcore_fixpoint"] == before + 1
    want, want_rounds = kc.pane_cores(*simple, c, cuda_device, round_fn=_twin_round)
    assert torch.equal(cores, want) and rounds == want_rounds > 2
    with pytest.raises(RuntimeError, match="converge"):
        kc.pane_cores(*simple, c, cuda_device, max_rounds=rounds - 1)
    # a bound of exactly the rounds needed is enough
    assert torch.equal(kc.pane_cores(*simple, c, cuda_device, max_rounds=rounds)[0], want)


def test_kcore_fixpoint_rounds_match_twin_round_by_round(cuda_device):
    """Each round's estimates: the launch bounded at r rounds leaves c as
    the twin's r-th round does (the unconverged result included)."""
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import spmv

    c = 1 << 12
    s, d, m = (torch.from_numpy(a).to(cuda_device) for a in _kcore_pane(*_rmat(np.random.default_rng(4), 12), c))
    buckets = [(b.keys, b.nbrs, b.valid) for b in nbh.build_buckets(s, d, None, m) if b.num_keys > 0]
    start = spmv.scatter_into(spmv.PLUS_ONE, c, s, torch.ones_like(s), m)
    want = start.clone()
    for r in range(1, 6):
        for keys, nbrs, valid in buckets:
            _twin_round(want, keys, nbrs, valid)
        got = start.clone()
        rounds, converged = spmv._kcore_fixpoint(got, buckets, r)
        assert rounds == r and not converged
        assert torch.equal(got, want), r


@pytest.mark.parametrize("seed", [0, 1])
def test_kcore_fixpoint_multigraph_pane_matches_twin(cuda_device, seed):
    """A stream that repeats edges in both orientations and holds
    self-loops: pane_cores dedupes it, so the one launch (whose values are
    capped at H) equals the twin's per-bucket loop and the CPU's cores."""
    from gelly_streaming_tpu_torch.library import kcore as kc
    from gelly_streaming_tpu_torch.ops import spmv

    rng = np.random.default_rng(40 + seed)
    c = 1 << 12
    src, dst = _rmat(rng, 12)
    src = np.concatenate([src, dst, src[:5000], np.arange(64, dtype=np.int32)])
    dst = np.concatenate([dst, src[: len(dst)], dst[:5000], np.arange(64, dtype=np.int32)])
    simple = _kcore_pane(src, dst, c)
    before = spmv.LAUNCHES["kcore_fixpoint"]
    cores, rounds = kc.pane_cores(*simple, c, cuda_device)
    assert spmv.LAUNCHES["kcore_fixpoint"] == before + 1
    want, want_rounds = kc.pane_cores(*simple, c, cuda_device, round_fn=_twin_round)
    cpu, cpu_rounds = kc.pane_cores(*simple, c, "cpu")
    assert torch.equal(cores, want) and torch.equal(cores.cpu(), cpu) and rounds == want_rounds == cpu_rounds


def test_kcore_fixpoint_large_h_path(cuda_device):
    """A pane whose degree h-index passes the shared bins (4096): a clique
    of 4,120 vertices (H = 4,119) with pendant leaves, so the hub rows take
    the refining passes; cores and rounds equal the twin's."""
    from gelly_streaming_tpu_torch.library import kcore as kc
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import spmv

    q, c = 4120, 1 << 14
    rng = np.random.default_rng(8)
    iu, ju = np.triu_indices(q, 1)
    leaves = np.arange(q, c)
    src = np.concatenate([iu, leaves]).astype(np.int32)
    dst = np.concatenate([ju, rng.integers(0, q, len(leaves))]).astype(np.int32)
    simple = _kcore_pane(src, dst, c)
    s_t, d_t, m_t = (torch.from_numpy(a).to(cuda_device) for a in simple)
    buckets = [(b.keys, b.nbrs, b.valid) for b in nbh.build_buckets(s_t, d_t, None, m_t) if b.num_keys > 0]
    est = spmv.scatter_into(spmv.PLUS_ONE, c, s_t, torch.ones_like(s_t), m_t)
    hdr = spmv._kcore_fixpoint_launch(est, spmv._kcore_table(buckets, cuda_device), int(m_t.sum()) + 1).tolist()
    assert hdr[1] == 1 and hdr[2] == -1  # H = 4,119 >= 4,096: no cap
    cores, rounds = kc.pane_cores(*simple, c, cuda_device)
    want, want_rounds = kc.pane_cores(*simple, c, cuda_device, round_fn=_twin_round)
    assert torch.equal(cores, want) and torch.equal(est, want) and rounds == want_rounds == hdr[0]
    assert int(cores[:q].min()) == int(cores[:q].max()) == q - 1 and int(cores[q:].max()) == 1


def _kcore_bucket(rng, k, d, c, dev, full=False):
    c_est = torch.from_numpy(rng.integers(0, d + 3, c).astype(np.int32)).to(dev)
    keys = torch.from_numpy(rng.permutation(c)[:k].astype(np.int32)).to(dev)
    nbrs = torch.from_numpy(rng.integers(0, c, (k, d)).astype(np.int32)).to(dev)
    valid = torch.from_numpy(np.ones((k, d), bool) if full else rng.random((k, d)) < 0.7).to(dev)
    return c_est, keys, nbrs, valid


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 32, 64, 256, 1024, 2048, 1 << 17])
def test_kcore_round_matches_twin(cuda_device, d):
    from gelly_streaming_tpu_torch.ops import spmv

    rng = np.random.default_rng(d)
    c = 1 << 18
    for k in sorted({1, 3, max(1, (1 << 20) // d // 8)}):
        for full in (False, True):
            c_est, keys, nbrs, valid = _kcore_bucket(rng, min(k, c), d, c, cuda_device, full)
            if d >= 1024:  # a hub: estimates above the row's width
                c_est[keys.long()] = d + 5
                c_est += d // 2
            want = spmv.kcore_round_plain(c_est, keys, nbrs, valid)
            before = spmv.LAUNCHES["kcore_round"]
            got = spmv.kcore_round(c_est.clone(), keys, nbrs, valid)
            assert spmv.LAUNCHES["kcore_round"] == before + 1
            assert torch.equal(got, want), (d, k, full)


def test_kcore_round_index_rules(cuda_device):
    from gelly_streaming_tpu_torch.ops import spmv

    rng = np.random.default_rng(3)
    c = 256
    c_est, keys, nbrs, valid = _kcore_bucket(rng, 40, 16, c, cuda_device)
    keys[:4] = torch.tensor([-1, c, c + 3, -c], dtype=torch.int32)
    nbrs[:3, :2] = torch.tensor([[-1, c], [c + 9, -c], [-2, 0]], dtype=torch.int32)
    assert torch.equal(spmv.kcore_round(c_est.clone(), keys, nbrs, valid), spmv.kcore_round_plain(c_est, keys, nbrs, valid))


def test_spmv_algorithms_on_the_card_match_the_cpu(cuda_device):
    """windowed_sssp, windowed_kcore, IterativeConnectedComponents (exact)
    and windowed_pagerank (rtol 1e-5) over one timed stream, GPU against
    the plain twins on the CPU."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library import (
        IterativeConnectedComponents, windowed_kcore, windowed_pagerank, windowed_sssp)
    from gelly_streaming_tpu_torch.ops import spmv

    rng = np.random.default_rng(9)
    n = 4000
    t = np.sort(rng.integers(0, 4000, n))
    edges = [(int(rng.integers(0, 300)), int(rng.integers(0, 300)), float(np.float32(rng.random())), int(t[i]))
             for i in range(n)]
    cfg = StreamConfig(vertex_capacity=512, max_degree=16, batch_size=256)

    def run(dev):
        s = EdgeStream.from_collection(edges, cfg, batch_size=256, with_time=True, device=dev)
        ic = IterativeConnectedComponents()
        return (windowed_sssp(s, 0, 1000).collect(), windowed_kcore(s, 1000).collect(),
                windowed_pagerank(s, 1000).collect(), ic.run(s).collect(), ic.final_labels)

    spmv.reset_launches()
    got = run(cuda_device)
    assert spmv.LAUNCHES["spmv_fixpoint"] == spmv.LAUNCHES["pagerank_fixpoint"] == 4
    assert spmv.LAUNCHES["kcore_fixpoint"] == 4 and spmv.LAUNCHES["kcore_round"] == 0  # one launch a pane
    want = run("cpu")
    assert got[0] == want[0] and got[1] == want[1] and got[3] == want[3]
    assert np.array_equal(got[4], want[4])
    assert [v for v, _ in got[2]] == [v for v, _ in want[2]]
    np.testing.assert_allclose([r for _, r in got[2]], [r for _, r in want[2]], rtol=1e-5, atol=1e-9)


# ---------------------------------------------------------------------------
# the spanner, the weighted matching and the sampled triangle estimators
# (csrc/spanner.cu, matching.cu, sampled_triangles.cu): every kernel equal to
# its twin on the card, exactly, at small and at phase 17's shapes


def _edge_batch(rng, dev, n, lo, hi, p_mask=0.9):
    s = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)
    d = torch.from_numpy(rng.integers(lo, hi, n).astype(np.int32)).to(dev)
    m = torch.from_numpy(rng.random(n) < p_mask).to(dev)
    return s, d, m


@pytest.mark.parametrize("c,d,k,cap,body,n,lo,hi", [
    (24, 4, 3, 4, "bfs", 64, -3, 27),
    (24, 4, 3, 128, "balls", 64, -3, 27),
    (24, 4, 2, 128, "within_two", 64, -3, 27),
    (64, 8, 4, 4, "balls", 256, -2, 66),
    (64, 8, 1, 128, "bfs", 256, 0, 64),
    (40, 3, 0, 1, "bfs", 100, -1, 41),
    (512, 64, 2, 128, "within_two", 1 << 14, 0, 512),
    (4096, 64, 3, 128, "balls", 1 << 14, 0, 4096),
    (4096, 64, 3, 128, "bfs", 1 << 12, 0, 4096),
])
def test_spanner_admit_matches_twin(cuda_device, c, d, k, cap, body, n, lo, hi):
    from gelly_streaming_tpu_torch.ops import spanner as sp

    rng = np.random.default_rng(c + k + cap)
    n1 = torch.full((c, d), -1, dtype=torch.int32, device=cuda_device)
    d1 = torch.zeros((c,), dtype=torch.int32, device=cuda_device)
    n2, d2 = n1.clone(), d1.clone()
    for _ in range(1 if n >= 1 << 12 else 3):  # the twin takes seconds a wide batch on the card
        s, t, m = _edge_batch(rng, cuda_device, n, lo, hi)
        before = sp.LAUNCHES["spanner_admit"]
        sp.spanner_admit(n1, d1, s, t, m, k, cap, body)
        assert sp.LAUNCHES["spanner_admit"] == before + 1
        sp.spanner_admit_plain(n2, d2, s, t, m, k, cap, body)
        assert torch.equal(n1, n2) and torch.equal(d1, d2)


def test_spanner_admit_unmasked_empty_and_stats(cuda_device):
    from gelly_streaming_tpu_torch.ops import spanner as sp

    rng = np.random.default_rng(8)
    n1 = torch.full((32, 4), -1, dtype=torch.int32, device=cuda_device)
    d1 = torch.zeros((32,), dtype=torch.int32, device=cuda_device)
    n2, d2 = n1.clone(), d1.clone()
    sp.reset_stats()
    s, t, _m = _edge_batch(rng, cuda_device, 80, 0, 32)
    sp.spanner_admit(n1, d1, s, t, None, 2, 128, "within_two")
    sp.spanner_admit_plain(n2, d2, s, t, None, 2, 128, "within_two")
    assert torch.equal(n1, n2) and torch.equal(d1, d2)
    st = sp.stats(cuda_device)
    assert st["calls"] == 1 and st["admitted"] == int(d1.sum()) // 2 and st["candidates"] >= st["admitted"]
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    sp.spanner_admit(n1, d1, empty, empty, None, 2, 128, "bfs")
    assert torch.equal(n1, n2)
    with pytest.raises(ValueError):  # balls past the kernel's scratch (4^20 entries): raises, no fallback
        sp.spanner_admit(n1, d1, s, t, None, 40, 128, "balls")


def test_spanner_on_the_card_matches_the_cpu(cuda_device):
    """Windowed ``Spanner`` (pane folds and combines) on the card and on the CPU."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.spanner import Spanner

    rng = np.random.default_rng(4)
    edges = [(int(a), int(b), 0, int(t)) for a, b, t in zip(rng.integers(0, 40, 400), rng.integers(0, 40, 400),
                                                            np.sort(rng.integers(0, 4000, 400)))]
    cfg = StreamConfig(vertex_capacity=40, max_degree=6)
    out = {}
    for dev in ("cpu", cuda_device):
        stream = EdgeStream.from_collection(edges, cfg, batch_size=32, with_time=True, device=dev)
        out[str(dev)] = [(g.nbrs.cpu(), g.deg.cpu()) for (g,) in stream.aggregate(Spanner(1000, 3)).collect()]
    (a, b) = out.values()
    assert len(a) == len(b) == 4
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(a, b))


@pytest.mark.parametrize("body", ["balls", "bfs"])
def test_spanner_prepass_and_walk_at_k4_match_twin_and_model(cuda_device, body):
    """The exact pre-pass on T0 and the walk over its survivors at k = 4:
    rows that overflow (D = 3), ids -1 and C, masked rows, then an
    all-masked batch; the table equal to the twin's and to the plain
    model's, the survivors counted by the kernel equal to the model's."""
    from gelly_streaming_tpu_torch.ops import spanner as sp

    c, d, cap = 30, 3, 5
    rng = np.random.default_rng(44 + len(body))
    n1 = torch.full((c, d), -1, dtype=torch.int32, device=cuda_device)
    d1 = torch.zeros((c,), dtype=torch.int32, device=cuda_device)
    n2, d2 = n1.clone(), d1.clone()
    n3, d3 = n1.cpu(), d1.cpu()
    for i in range(5):
        s, t, m = _edge_batch(rng, cuda_device, 96, -1, c + 1, 0.0 if i == 4 else 0.85)
        sp.reset_stats()
        sp.spanner_admit(n1, d1, s, t, m, 4, cap, body)
        st = sp.stats(cuda_device)
        sp.spanner_admit_plain(n2, d2, s, t, m, 4, cap, body)
        _, _, cand, surv = sp.spanner_admit_model(n3, d3, s.cpu(), t.cpu(), m.cpu(), 4, cap, body)
        assert torch.equal(n1, n2) and torch.equal(d1, d2)
        assert torch.equal(n1.cpu(), n3) and torch.equal(d1.cpu(), d3)
        assert (st["candidates"], st["survivors"]) == (cand, surv)
        assert st["survivors"] <= st["candidates"] and st["admitted"] <= st["survivors"]
        if i == 4:
            assert st["candidates"] == 0 and st["calls"] == 1
    assert (d1 == d).any()  # rows overflowed


@pytest.mark.parametrize("c,d,k,body,n", [(512, 64, 2, "within_two", 1 << 14), (4096, 64, 3, "balls", 1 << 14),
                                          (4096, 64, 3, "bfs", 1 << 12)])
def test_spanner_survivors_match_the_model_at_phase_17_shapes(cuda_device, c, d, k, body, n):
    """Two batches of uniform edges from the empty table (the first: the
    walk's worst case, the table in shared memory at C = 512): the
    kernel's candidates and survivors equal the model's pre-pass on the
    card, and the table equals the model's walk."""
    from gelly_streaming_tpu_torch.ops import spanner as sp

    rng = np.random.default_rng(c + k)
    n1 = torch.full((c, d), -1, dtype=torch.int32, device=cuda_device)
    d1 = torch.zeros((c,), dtype=torch.int32, device=cuda_device)
    for _ in range(2):
        s, t, _m = _edge_batch(rng, cuda_device, n, 0, c)
        before, deg_before = n1.clone(), d1.clone()
        cand = ~sp.prefilter_plain(before, s, t, k, 128)
        surv = sp.exact_prepass_plain(before, s, t, cand, k, body)
        sp.reset_stats()
        sp.spanner_admit(n1, d1, s, t, None, k, 128, body)
        st = sp.stats(cuda_device)
        assert (st["candidates"], st["survivors"]) == (int(cand.sum()), int(surv.sum()))
        n3, d3 = before.cpu(), deg_before.cpu()
        sp.walk_plain(n3, d3, s.cpu(), t.cpu(), surv.cpu(), k, body)
        assert torch.equal(n1.cpu(), n3) and torch.equal(d1.cpu(), d3)


def _matching_call_matches(mo, p1, w1, s, t, val, mask):
    """One C call against the twin and the plan from the same state: events,
    emask and state bit for bit, the device counters' rounds the plan's."""
    p2, w2, p3, w3 = p1.clone(), w1.clone(), p1.cpu(), w1.cpu()
    mo.reset_stats()
    before = mo.LAUNCHES["matching_scan"]
    e1, em1 = mo.matching_scan(p1, w1, s, t, val, mask)
    assert mo.LAUNCHES["matching_scan"] == before + 1
    st = mo.stats(p1.device)
    e2, em2 = mo.matching_scan_plain(p2, w2, s, t, val, mask)
    assert torch.equal(e1.view(torch.int32), e2.view(torch.int32)) and torch.equal(em1, em2)
    assert torch.equal(p1, p2) and torch.equal(w1.view(torch.int32), w2.view(torch.int32))
    cpu = [None if x is None else x.cpu() for x in (s, t, val, mask)]
    e3, em3, rounds = mo.matching_rounds_plain(p3, w3, *cpu, mo.WINDOW)
    assert torch.equal(e3.view(torch.int32), e2.cpu().view(torch.int32)) and torch.equal(em3, em2.cpu())
    assert st["calls"] == 1 and st["rounds"] == rounds and st["max_rounds"] == rounds
    assert st["admitted"] == int(em1[:, 2].sum())
    assert -(-s.shape[0] // mo.WINDOW) <= rounds <= s.shape[0]
    return rounds


@pytest.mark.parametrize("c,n,lo,hi,ints", [(16, 40, -3, 19, True), (64, 500, 0, 64, False),
                                           (4096, 8192, 0, 4096, False), (2625, 8192, 0, 2625, True),
                                           (300, 2000, -3, 303, True), (1 << 16, 8192, -3, (1 << 16) + 3, False),
                                           (1 << 16, 8192, -3, (1 << 16) + 3, True)])
def test_matching_scan_matches_twin(cuda_device, c, n, lo, hi, ints):
    """The C = 2^16 cases (768 KB of state and stamps) run the rounds on
    the global arrays; the others keep the state in shared memory."""
    from gelly_streaming_tpu_torch.ops import matching as mo

    assert mo.state_in_shared(c) == (c < 1 << 16)
    rng = np.random.default_rng(c + n)
    p1 = torch.full((c,), -1, dtype=torch.int32, device=cuda_device)
    w1 = torch.zeros((c,), dtype=torch.float32, device=cuda_device)
    for i in range(3):
        s, t, m = _edge_batch(rng, cuda_device, n, lo, hi, 0.95)
        w = torch.from_numpy((rng.integers(1, 6, n) if ints else rng.random(n)).astype(np.float32)).to(cuda_device)
        val, mask = (None, None) if i == 2 else (w, m)
        _matching_call_matches(mo, p1, w1, s, t, val, mask)


@pytest.mark.parametrize("kind,c", [("hub", 64), ("hub", 1 << 16), ("chain", 16385), ("chain", 1 << 16)])
def test_matching_scan_where_every_lane_conflicts(cuda_device, kind, c):
    """One commit a round.  Hub: edge k (0, k + 1) weighs 3^k and evicts
    the one before it.  Chain: the pairs (2i, 2i + 1) matched at weight 1,
    edge e (2e - 1, 2e) at weight 3 evicts 2e + 1, whose row edge e + 1
    reads."""
    from gelly_streaming_tpu_torch.ops import matching as mo

    p1 = torch.full((c,), -1, dtype=torch.int32, device=cuda_device)
    w1 = torch.zeros((c,), dtype=torch.float32, device=cuda_device)
    if kind == "hub":
        n = 60
        s = torch.zeros(n, dtype=torch.int32)
        t = torch.arange(1, n + 1, dtype=torch.int32)
        val = torch.from_numpy(3.0 ** np.arange(n)).to(torch.float32)
    else:
        n = 8192
        p1[:2 * n] = torch.arange(2 * n, dtype=torch.int32, device=cuda_device) ^ 1
        w1[:2 * n] = 1.0
        s = torch.cat([torch.tensor([2 * n]), 2 * torch.arange(1, n) - 1]).to(torch.int32)
        t = 2 * torch.arange(n, dtype=torch.int32)
        val = torch.full((n,), 3.0)
    s, t, val = (x.to(cuda_device) for x in (s, t, val))
    assert _matching_call_matches(mo, p1, w1, s, t, val, None) == n


def test_matching_scan_stamp_epochs_restart(cuda_device, tmp_path):
    """matching.cu built with a stamp epoch of 5 rounds (the shipped one is
    8,388,606), so the stamps restart every 5 rounds: random batches in
    both branches and the 8192-round chain still equal the twin and the
    plan."""
    import ctypes

    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import matching as mo

    src = (_cuda.CSRC_DIR / "matching.cu").read_text()
    epoch = "constexpr int EPOCH_ROUNDS = 0x7fffffff / W - 1;"
    assert epoch in src
    path = tmp_path / "matching_epoch5.cu"
    path.write_text(src.replace(epoch, "constexpr int EPOCH_ROUNDS = 5;"))
    lib = ctypes.CDLL(str(_cuda.build_all([str(path)])[str(path)].path))
    lib.matching_scan_launch.argtypes = _cuda.SIGNATURES["matching.cu"]["matching_scan_launch"]

    def check(p1, w1, s, t, val, mask):
        c, n = p1.shape[0], s.shape[0]
        p2, w2, p3, w3 = p1.clone(), w1.clone(), p1.cpu(), w1.cpu()
        st = torch.zeros(4, dtype=torch.int32, device=cuda_device)
        scratch = torch.empty(c, dtype=torch.int32, device=cuda_device)
        ev = torch.empty((n, 3, 4), device=cuda_device)
        em = torch.empty((n, 3), dtype=torch.bool, device=cuda_device)
        _cuda.check(lib.matching_scan_launch(
            p1.data_ptr(), w1.data_ptr(), c, s.data_ptr(), t.data_ptr(), val.data_ptr(),
            None if mask is None else mask.data_ptr(), n, ev.data_ptr(), em.data_ptr(), scratch.data_ptr(),
            st.data_ptr(), torch.cuda.current_stream(cuda_device).cuda_stream), "matching_scan_launch")
        ev2, em2 = mo.matching_scan_plain(p2, w2, s, t, val, mask)
        cpu = [None if x is None else x.cpu() for x in (s, t, val, mask)]
        _, _, rounds = mo.matching_rounds_plain(p3, w3, *cpu, mo.WINDOW)
        assert torch.equal(ev.view(torch.int32), ev2.view(torch.int32)) and torch.equal(em, em2)
        assert torch.equal(p1, p2) and torch.equal(w1.view(torch.int32), w2.view(torch.int32))
        assert int(st[1]) == rounds
        return rounds

    rng = np.random.default_rng(3)
    for c in (4096, 1 << 16):
        p1 = torch.full((c,), -1, dtype=torch.int32, device=cuda_device)
        w1 = torch.zeros((c,), dtype=torch.float32, device=cuda_device)
        for _ in range(2):
            s, t, m = _edge_batch(rng, cuda_device, 8192, -3, c + 3, 0.9)
            w = torch.from_numpy(rng.integers(1, 9, 8192).astype(np.float32)).to(cuda_device)
            assert check(p1, w1, s, t, w, m) > 5
    n = 8192
    p1 = torch.full((2 * n + 1,), -1, dtype=torch.int32, device=cuda_device)
    p1[:2 * n] = torch.arange(2 * n, dtype=torch.int32, device=cuda_device) ^ 1
    w1 = torch.zeros((2 * n + 1,), dtype=torch.float32, device=cuda_device)
    w1[:2 * n] = 1.0
    s = torch.cat([torch.tensor([2 * n]), 2 * torch.arange(1, n) - 1]).to(torch.int32).to(cuda_device)
    t = (2 * torch.arange(n, dtype=torch.int32)).to(cuda_device)
    assert check(p1, w1, s, t, torch.full((n,), 3.0, device=cuda_device), None) == n


def test_matching_run_on_the_card_matches_the_cpu(cuda_device):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.matching import CentralizedWeightedMatching

    rng = np.random.default_rng(5)
    edges = [(int(a), int(b), float(w)) for a, b, w in zip(rng.integers(0, 50, 700), rng.integers(0, 50, 700),
                                                           rng.integers(1, 100, 700))]
    cfg = StreamConfig(vertex_capacity=64)
    got = [CentralizedWeightedMatching().run(EdgeStream.from_collection(edges, cfg, batch_size=64, device=dev))
           .collect() for dev in ("cpu", cuda_device)]
    assert got[0] == got[1] and len(got[0]) > 0


@pytest.mark.parametrize("c,s_lanes,n,odd", [(24, 7, 37, True), (24, 1024, 300, True), (64, 1, 513, False),
                                             (1 << 20, 1000, 1 << 16, False)])
def test_sampler_scan_matches_twin(cuda_device, c, s_lanes, n, odd):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.library import sampled_triangles as lst
    from gelly_streaming_tpu_torch.ops import sampled_triangles as sto

    rng = np.random.default_rng(s_lanes + n)
    st1 = lst.init_samplers(StreamConfig(vertex_capacity=c), s_lanes, device=cuda_device)
    st2 = sto.clone_state(st1)
    lo, hi = (-2, c + 2) if odd else (0, c)
    for i in range(3):
        s, t, m = _edge_batch(rng, cuda_device, n, lo, hi)
        mask = None if i == 1 else m
        before = sto.LAUNCHES["sampler_scan"]
        sto.sampler_scan(st1, s, t, mask)
        assert sto.LAUNCHES["sampler_scan"] == before + 1
        sto.sampler_scan_plain(st2, s, t, mask)
        for a, b in zip(st1, st2):
            assert torch.equal(a.cpu().to(torch.int64) if a.dtype == torch.uint32 else a.cpu(),
                               b.cpu().to(torch.int64) if b.dtype == torch.uint32 else b.cpu())
        assert lst.estimate(st1) == lst.estimate(st2)
    empty = torch.zeros((0,), dtype=torch.int32, device=cuda_device)
    sto.sampler_scan(st1, empty, empty, None)
    assert torch.equal(st1.edge, st2.edge)


def test_sampler_key_chain_prefix_and_continuation(cuda_device):
    """A KeyChain computed ahead for one length, then batches shorter
    (a prefix) and longer (a continuation): every state, key included,
    equal to the twin's, which draws its own keys."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.library import sampled_triangles as lst
    from gelly_streaming_tpu_torch.ops import sampled_triangles as sto
    from gelly_streaming_tpu_torch.utils import threefry

    rng = np.random.default_rng(77)
    st1 = lst.init_samplers(StreamConfig(vertex_capacity=300), 64, seed=5, device=cuda_device)
    st2 = sto.clone_state(st1)
    chain = sto.KeyChain(threefry.seed(5), cuda_device)
    for ahead, n in [(500, 123), (100, 700), (0, 1), (256, 256), (64, 0), (10, 999)]:
        if ahead:
            chain.ahead(ahead)
        s, t, m = _edge_batch(rng, cuda_device, n, 0, 300)
        sto.sampler_scan(st1, s, t, m, chain)
        sto.sampler_scan_plain(st2, s, t, m)
        for a, b in zip(st1, st2):
            assert torch.equal(a.cpu().to(torch.int64) if a.dtype == torch.uint32 else a.cpu(),
                               b.cpu().to(torch.int64) if b.dtype == torch.uint32 else b.cpu())
        assert chain.key == threefry.key_ints(st2.key)


def test_sampler_run_loop_reads_nothing_from_the_card(cuda_device):
    """Within the run loop's step, ``sampler_scan`` given the chain's keys
    enqueues no device-to-host copy and no synchronization (sync debug
    mode raises on either); batches of uneven length through
    ``from_batches`` then match the CPU's records."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeBatch
    from gelly_streaming_tpu_torch.library import sampled_triangles as lst
    from gelly_streaming_tpu_torch.ops import sampled_triangles as sto
    from gelly_streaming_tpu_torch.utils import threefry

    rng = np.random.default_rng(8)
    state = lst.init_samplers(StreamConfig(vertex_capacity=256), 100, device=cuda_device)
    chain = sto.KeyChain(threefry.seed(0xDEADBEEF), cuda_device)
    batches = [_edge_batch(rng, cuda_device, n, 0, 256) for n in (512, 300, 512, 40, 512)]
    sto.sampler_scan(state, *batches[0], chain)  # scratch and buffers allocated
    chain.ahead(512)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for s, t, m in batches[1:]:
                sto.sampler_scan(state, s, t, m, chain)
                chain.ahead(512)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    names = [e.name for e in prof.events()]
    assert not [x for x in names if "DtoH" in x or "Device -> Pageable" in x or "Device -> Pinned" in x], names
    assert len([x for x in names if "HtoD" in x or "Pinned -> Device" in x]) >= 4, names  # the keys' uploads
    sizes = [512, 300, 512, 40, 512, 7]
    edges = [(rng.integers(0, 200, n), rng.integers(0, 200, n)) for n in sizes]
    cfg = StreamConfig(vertex_capacity=256, batch_size=512)
    got = []
    for dev in ("cpu", cuda_device):
        def factory(dev=dev):
            for a, b in edges:
                yield EdgeBatch.from_arrays(a.astype(np.int32), b.astype(np.int32), device=dev)

        algo = lst.BroadcastTriangleCount(300)
        got.append(algo.run(EdgeStream.from_batches(factory, cfg, device=dev)).collect())
    assert got[0] == got[1] and len(got[0]) == len(sizes)


def test_sampled_triangles_run_on_the_card_matches_the_cpu(cuda_device):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.sampled_triangles import BroadcastTriangleCount

    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, 200, 5000), rng.integers(0, 200, 5000)
    cfg = StreamConfig(vertex_capacity=256, batch_size=1024)
    got = [BroadcastTriangleCount(300).run(EdgeStream.from_arrays(src, dst, cfg, device=dev)).collect()
           for dev in ("cpu", cuda_device)]
    assert got[0] == got[1] and got[0][-1][0] > 0


# the sketches (ops/sketches.py): hll_fold, cm_fold, tri_fold, tri_sampled_closures


def _unmix32(y: int) -> int:
    """The x with fmix32(x) == y (fmix32 is a bijection on u32)."""
    m = 0xFFFFFFFF
    y ^= y >> 16
    y = (y * pow(0xC2B2AE35, -1, 1 << 32)) & m
    y ^= (y >> 13) ^ (y >> 26)
    y = (y * pow(0x85EBCA6B, -1, 1 << 32)) & m
    return y ^ (y >> 16)


def _edges_with_sample_hash(target: int, los: torch.Tensor):
    """Canonical edges (lo, hi), lo < hi, whose sample hash is ``target``,
    for the candidate ``los`` that give one: hi is solved from hash_pair's
    second fmix32 (GOLDEN is odd, so it has an inverse mod 2^32)."""
    from gelly_streaming_tpu_torch.ops import sketches as sko

    h1 = sko.mix32(sko.as_u32(los) ^ ((sko.SALT_SAMPLE * sko.GOLDEN) & 0xFFFFFFFF))
    hi = sko._mul32(h1 ^ _unmix32(target), pow(sko.GOLDEN, -1, 1 << 32))
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)
    keep = hi > los
    return los[keep].to(torch.int32), hi[keep].to(torch.int32)


def _sample_equal(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x.cpu(), y.cpu())


# n: below one block's share, a batch of 50,000, past three clusters' shares
# and not a multiple of one (an HLL cluster takes 8 x 1024 x 8 edges, a
# count-min cluster 8 x 512 x 8), none; the first fold finds cold state,
# the later ones warm
SKETCH_NS = (100, 50_000, 3 * (1 << 16) + 777, 0)


@pytest.mark.parametrize("m", [64, 1 << 14, 1 << 16, 1 << 18])
def test_hll_folds_match_twin(cuda_device, m):
    """m = 2^18: the registers pass the filter's 192 KB, the rest read in L2."""
    from gelly_streaming_tpu_torch.ops import sketches as sko

    rng = np.random.default_rng(m)
    r1 = torch.zeros(m, dtype=torch.int32, device=cuda_device)
    r2 = r1.clone()
    for n in SKETCH_NS:
        keys = torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.int64)).to(cuda_device)
        keys[:5] = 0  # saturated ranks
        keys[5:9] = m - 1
        mask = torch.from_numpy(rng.random(n) < 0.8).to(cuda_device)
        for msk in (mask, None, torch.zeros_like(mask)):
            before = sko.LAUNCHES["hll_fold"]
            sko.hll_fold(r1, keys, msk)
            assert sko.LAUNCHES["hll_fold"] == before + 1
            sko.hll_fold_plain(r2, keys, msk)
            assert torch.equal(r1, r2)
    assert int(r1.max()) == 33 - (m.bit_length() - 1)
    # registers no fold writes (negative, above any rank, past a byte) meet the filter's clamp
    odd = torch.from_numpy(rng.integers(-3, 300, m).astype(np.int32)).to(cuda_device)
    v1, e1 = torch.zeros(m, dtype=torch.int32, device=cuda_device), odd.clone()
    v2, e2 = v1.clone(), e1.clone()
    for n in SKETCH_NS:
        s, d, msk = _edge_batch(rng, cuda_device, n, -(1 << 31), (1 << 31) - 1)
        s[:100] = d[:100]  # self-loops: folded by HLLDegreeSummary
        for mm in (msk, None):
            before = sko.LAUNCHES["hll_fold"]
            sko.hll_degree_fold(v1, e1, s, d, mm)
            assert sko.LAUNCHES["hll_fold"] == before + 1
            sko.hll_degree_fold_plain(v2, e2, s, d, mm)
            assert torch.equal(v1, v2) and torch.equal(e1, e2)
    assert int((e1 != odd).sum()) > 0


@pytest.mark.parametrize("d,w", [(1, 64), (8, 2048), (5, 4096), (8, 1 << 16), (9, 256)])
def test_cm_folds_match_twin(cuda_device, d, w):
    """(8, 2^16): a 2 MB grid, past a block's private 96 KB; (9, 256): more rows than the unrolled kernels take."""
    from gelly_streaming_tpu_torch.ops import sketches as sko

    rng = np.random.default_rng(d * w)
    g1 = torch.zeros(d * w, dtype=torch.int32, device=cuda_device)
    g2 = g1.clone()
    for n in SKETCH_NS:
        s, t, m = _edge_batch(rng, cuda_device, n, -5, 1 << 20)  # negative ids and ids past any C
        counts = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32)).to(cuda_device)  # wraps
        for keys, cnt, mm in ((s, counts, m), (t, None, None), (s, counts, torch.zeros_like(m))):
            sko.cm_fold(g1, d, w, keys, cnt, mm)
            sko.cm_fold_plain(g2, d, w, keys, cnt, mm)
            assert torch.equal(g1, g2)
        before = sko.LAUNCHES["cm_fold"]
        sko.cm_degree_fold(g1, d, w, s, t, m)
        assert sko.LAUNCHES["cm_fold"] == before + 1
        sko.cm_fold_plain(g2, d, w, s, None, m)
        sko.cm_fold_plain(g2, d, w, t, None, m)
        assert torch.equal(g1, g2)


@pytest.mark.parametrize("rows,m,c", [(64, 256, 40), (64, 1 << 16, 1 << 20), (4096, 8192, 3000),
                                      (4096, 1 << 16, 1 << 20), (16384, 8192, 1 << 20)])
def test_tri_fold_matches_twin(cuda_device, rows, m, c):
    """Registers carried in below 0 (a masked row or a self-loop raises its
    register to 0), batches in one cluster, a 2^21-edge batch over several
    clusters (its edges past the threads' registers read again), a masked
    batch, an empty batch; m = 2^16: the registers past the block's shared
    memory, folded in device memory; R = 16384: 136 KB of keys a block."""
    from gelly_streaming_tpu_torch.ops import sketches as sko
    from gelly_streaming_tpu_torch.summaries import sketches as sks

    rng = np.random.default_rng(rows + c)
    regs = torch.from_numpy(rng.integers(-4, 3, m).astype(np.int32)).to(cuda_device)
    a = (*sks.tri_init(rows, cuda_device), regs)
    b = tuple(x.clone() for x in a)
    for i, n in enumerate((20_000, 20_000, 20_000, 1 << 21, 20_000)):
        s, t, mask = _edge_batch(rng, cuda_device, n, -3, c)
        s[:50] = t[:50]  # self-loops take no part in the sample
        mm = (mask, None, torch.zeros_like(mask), mask, mask)[i]
        before = sko.LAUNCHES["tri_fold"]
        sko.tri_fold(*a[:3], s, t, mm, a[3])
        assert sko.LAUNCHES["tri_fold"] == before + 1
        sko.tri_fold_plain(*b[:3], s, t, mm, b[3])
        _sample_equal(a, b)
    sko.tri_fold(*a[:3], s[:0], t[:0], None)  # an empty batch
    _sample_equal(a, b)


def test_tri_fold_masked_rows_raise_registers_below_zero(cuda_device):
    """A batch whose every row is masked or a self-loop: the registers its
    rows hit rise from below 0 to 0, as the JAX package's where(mask, rank,
    0) has them; the sample does not change."""
    from gelly_streaming_tpu_torch.ops import sketches as sko
    from gelly_streaming_tpu_torch.summaries import sketches as sks

    rng = np.random.default_rng(31)
    for rows, m in ((64, 256), (4096, 8192), (4096, 1 << 18)):
        regs = torch.full((m,), -3, dtype=torch.int32, device=cuda_device)
        a = (*sks.tri_init(rows, cuda_device), regs)
        b = tuple(x.clone() for x in a)
        s, t, _ = _edge_batch(rng, cuda_device, 3000, 0, 1 << 16)
        s[:1000] = t[:1000]
        mask = torch.arange(3000, device=cuda_device) < 1000  # the self-loops kept, the rest masked
        sko.tri_fold(*a[:3], s, t, mask, a[3])
        sko.tri_fold_plain(*b[:3], s, t, mask, b[3])
        _sample_equal(a, b)
        assert int((a[3] == 0).sum()) > 0 and int((a[3] > 0).sum()) == 0 and bool((a[1] == -1).all())


def test_tri_fold_quirks(cuda_device):
    """An edge whose sample hash is 0xFFFFFFFF is never sampled, even alone
    in its bucket; of two edges with one sample hash in one bucket the
    lesser (lo, hi) wins; ids at the int32 extremes hash like any other."""
    from gelly_streaming_tpu_torch.ops import sketches as sko
    from gelly_streaming_tpu_torch.summaries import sketches as sks

    cand = torch.arange(-(1 << 17), 1 << 17, dtype=torch.int64)
    nlo, nhi = _edges_with_sample_hash(0xFFFFFFFF, cand)
    never = (int(nlo[0]), int(nhi[0]))
    base = torch.tensor([-7], dtype=torch.int32), torch.tensor([9], dtype=torch.int32)
    target = int(sko.hash_pair_u32(*base, sko.SALT_SAMPLE)[0])
    tlo, thi = _edges_with_sample_hash(target, cand)
    for rows in (64, 4096):
        bucket = sko.hash_pair_u32(*base, sko.SALT_BUCKET) & (rows - 1)
        same = (sko.hash_pair_u32(tlo, thi, sko.SALT_BUCKET) & (rows - 1) == bucket) & (tlo != -7)
        rival = (int(tlo[same][0]), int(thi[same][0]))
        edges = [never, (-7, 9), rival, (-(1 << 31), (1 << 31) - 1), (3, 3)]
        s = torch.tensor([e[1] for e in edges], dtype=torch.int32, device=cuda_device)  # reversed: canonicalized
        t = torch.tensor([e[0] for e in edges], dtype=torch.int32, device=cuda_device)
        a, b = sks.tri_init(rows, cuda_device), sks.tri_init(rows, cuda_device)
        sko.tri_fold(*a, s, t, None)
        sko.tri_fold_plain(*b, s, t, None)
        _sample_equal(a, b)
        kept = {(int(lo), int(hi)) for lo, hi in zip(a[1].cpu(), a[2].cpu()) if lo != -1}
        assert never not in kept and (3, 3) not in kept
        assert (-(1 << 31), (1 << 31) - 1) in kept
        assert (int(a[0][int(bucket)]), int(a[1][int(bucket)]), int(a[2][int(bucket)])) == (target, *min((-7, 9), rival))


def _closure_cases(elo, ehi, rng):
    """{name: (elo, ehi)} beside a folded sample: a star (every row on
    vertex 0), a hub with a rim, and states no fold makes: duplicate rows,
    reversed rows (lo > hi), self-loop rows, valid rows with ehi == -1 and
    invalid rows with a hi."""
    rows, dev = elo.shape[0], elo.device
    ar = torch.arange(rows, dtype=torch.int32, device=dev)
    out = {"star": (torch.zeros_like(elo), ar + 1)}
    hub, rim = rows // 2, rows // 4
    lo, hi = torch.full_like(elo, -1), torch.full_like(ehi, -1)
    lo[:hub], hi[:hub] = 0, ar[:hub] + 1
    lo[hub:hub + rim], hi[hub:hub + rim] = ar[:rim] + 1, ar[:rim] + 2
    out["hub and rim"] = (lo, hi)
    lo, hi = elo.clone(), ehi.clone()
    idx = torch.from_numpy(rng.permutation(rows)).to(dev)
    k = rows // 8
    dup, rev, loop, neg = (idx[i * k:(i + 1) * k] for i in range(4))
    lo[dup], hi[dup] = lo[dup.flip(0)], hi[dup.flip(0)]
    lo[rev], hi[rev] = hi[rev], lo[rev]
    lo[loop] = hi[loop]
    hi[neg] = -1
    lo[idx[-3:]] = -1
    out["adversarial"] = (lo, hi)
    return out


@pytest.mark.parametrize("rows,c,n", [(64, 12, 400), (64, 40, 2000), (4096, 60, 1 << 14), (4096, 400, 1 << 15),
                                      (8192, 600, 1 << 15)])
def test_tri_sampled_closures_match_twin(cuda_device, rows, c, n):
    """The empty, a folded, the star, a hub-and-rim and an adversarial
    sample, each one launch; R = 8192 takes the tables past the shared
    memory's cap from scratch; R = 16384 is refused."""
    from gelly_streaming_tpu_torch.ops import sketches as sko
    from gelly_streaming_tpu_torch.summaries import sketches as sks

    rng = np.random.default_rng(rows + c)
    eh, elo, ehi = sks.tri_init(rows, cuda_device)
    before = sko.LAUNCHES["tri_sampled_closures"]
    assert int(sko.tri_sampled_closures(elo, ehi)) == 0  # the empty sample
    s, t, _ = _edge_batch(rng, cuda_device, n, 0, c)
    sko.tri_fold(eh, elo, ehi, s, t, None)
    got = sko.tri_sampled_closures(elo, ehi)
    assert sko.LAUNCHES["tri_sampled_closures"] == before + 2
    assert got.dtype == torch.int32 and got.device.type == "cuda"
    assert int(got) == int(sko.tri_sampled_closures_plain(elo, ehi)) > 0
    for name, (lo, hi) in _closure_cases(elo, ehi, rng).items():
        before = sko.LAUNCHES["tri_sampled_closures"]
        got = int(sko.tri_sampled_closures(lo, hi))
        assert sko.LAUNCHES["tri_sampled_closures"] == before + 1
        assert got == int(sko.tri_sampled_closures_plain(lo, hi)), name
        assert got > 0 or name != "hub and rim"
    with pytest.raises(ValueError, match="at most 8192"):
        sko.tri_sampled_closures(*sks.tri_init(16384, cuda_device)[1:])


def test_sketch_wrappers_take_strided_inputs(cuda_device):
    """Columns of [n, 2] tensors go in: each wrapper's contiguous copies of
    src, dst, keys, counts and mask must outlive the launch, so that no
    copy reads another's reused block."""
    from gelly_streaming_tpu_torch.ops import sketches as sko
    from gelly_streaming_tpu_torch.summaries import sketches as sks

    rng = np.random.default_rng(23)
    n = 30_000
    pair = torch.from_numpy(rng.integers(-3, 60, (n, 2)).astype(np.int32)).to(cuda_device)
    masks = torch.from_numpy(rng.random((n, 2)) < 0.8).to(cuda_device)
    wide = torch.from_numpy(rng.integers(0, 1 << 32, (n, 2), dtype=np.int64)).to(cuda_device)
    counts = torch.from_numpy(rng.integers(-9, 9, (n, 2)).astype(np.int32)).to(cuda_device)
    s, t, m, keys, cnt = pair[:, 0], pair[:, 1], masks[:, 1], wide[:, 1], counts[:, 0]
    assert not any(x.is_contiguous() for x in (s, t, m, keys, cnt))
    sc, tc, mc, kc, cc = (x.contiguous() for x in (s, t, m, keys, cnt))

    r1 = torch.zeros(1 << 14, dtype=torch.int32, device=cuda_device)
    r2 = r1.clone()
    sko.hll_fold(r1, keys, m)
    sko.hll_fold_plain(r2, kc, mc)
    assert torch.equal(r1, r2)
    v1, e1 = torch.zeros_like(r1), torch.zeros_like(r1)
    v2, e2 = v1.clone(), e1.clone()
    sko.hll_degree_fold(v1, e1, s, t, m)
    sko.hll_degree_fold_plain(v2, e2, sc, tc, mc)
    assert torch.equal(v1, v2) and torch.equal(e1, e2)

    g1 = torch.zeros(8 * 4096, dtype=torch.int32, device=cuda_device)
    g2 = g1.clone()
    sko.cm_degree_fold(g1, 8, 4096, s, t, m)
    sko.cm_fold(g1, 8, 4096, t, cnt, m)
    for k, c in ((sc, None), (tc, None), (tc, cc)):
        sko.cm_fold_plain(g2, 8, 4096, k, c, mc)
    assert torch.equal(g1, g2)

    a = (*sks.tri_init(4096, cuda_device), torch.zeros(1 << 14, dtype=torch.int32, device=cuda_device))
    b = tuple(x.clone() for x in a)
    sko.tri_fold(*a[:3], s, t, m, a[3])
    sko.tri_fold_plain(*b[:3], sc, tc, mc, b[3])
    _sample_equal(a, b)
    both = torch.stack([a[1], a[2]], 1)
    got = int(sko.tri_sampled_closures(both[:, 0], both[:, 1]))
    assert got == int(sko.tri_sampled_closures_plain(b[1], b[2])) > 0


def test_sketch_descriptors_make_one_c_call_an_update(cuda_device):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.library import sketches as lsk
    from gelly_streaming_tpu_torch.ops import sketches as sko

    cfg = StreamConfig(vertex_capacity=1 << 12)
    s, t, m = _edge_batch(np.random.default_rng(2), cuda_device, 5000, 0, 1 << 12)
    for agg, name in ((lsk.SketchTriangleCount(), "tri_fold"), (lsk.HLLDegreeSummary(), "hll_fold"),
                      (lsk.CountMinHeavyHitters(), "cm_fold")):
        sko.reset_launches()
        agg.update(agg.initial_state(cfg, cuda_device), s, t, None, m)
        assert sko.LAUNCHES == {k: int(k == name) for k in sko.KERNELS}
        assert not any(sko.TWIN_CALLS.values())


@pytest.mark.parametrize("kind", ["sketch_triangles", "hll_degree", "cm_heavy_hitters"])
def test_sketch_runs_on_the_card_match_the_cpu(cuda_device, kind):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.sketches import make_sketch

    rng = np.random.default_rng(11)
    src, dst = rng.integers(0, 300, 20_000), rng.integers(0, 300, 20_000)
    cfg = StreamConfig(vertex_capacity=512, batch_size=2048, ingest_window_edges=4096)
    got = [EdgeStream.from_arrays(src, dst, cfg, device=dev).aggregate(make_sketch(kind)).collect()
           for dev in ("cpu", cuda_device)]
    assert len(got[0]) == len(got[1]) == 5
    for ra, rb in zip(*got):
        for x, y in zip(ra, rb):
            if x.dtype == torch.float32:  # the estimates' f32 sums reduce in another order on the card
                torch.testing.assert_close(y.cpu(), x, rtol=1e-5, atol=0)
            else:
                assert torch.equal(x, y.cpu())


# ---------------------------------------------------------------------------
# bdv_decode (csrc/wire_decode.cu) and the checkpointed wire path


def _bdv_buffers(case):
    """(uint8 buffer, n, valued) triples of one case."""
    from gelly_streaming_tpu_torch.io import wire

    rng = np.random.default_rng(len(case))

    def pack(n, cap, valued=False):
        s, d = rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)
        v = rng.integers(-(1 << 27), 1 << 27, n).astype(np.int32) if valued else None
        return wire.pack_edges_bdv(s, d, cap, val_i32=v)

    if case == "cc_batch":
        return [(pack(1 << 21, 1 << 20), 1 << 21, False)]
    if case == "group_arena":
        rows = [pack(4096, cap) for cap in (1 << 20, 1 << 10, 1 << 16, 1 << 28)]
        arena = np.zeros((4, max(r.nbytes for r in rows)), np.uint8)
        for j, r in enumerate(rows):
            arena[j, : r.nbytes] = r
        return [(arena[j], 4096, False) for j in range(4)]
    if case == "varint_boundaries":
        b = np.array([0, 1, 255, 256, 65535, 65536, (1 << 24) - 1, 1 << 24, (1 << 29) - 1, 1 << 29], np.uint64)
        enc = wire._varint_encode_np(np.concatenate([b, b[::-1]]))
        return [(enc, 10, False), (enc, 6, True)]
    if case == "ids_2^28":
        top = (1 << 28) - 1
        ids = np.array([top, 0, top, top - 1, 0, top], np.int32)
        return [(wire.pack_edges_bdv(ids, ids[::-1].copy(), 1 << 28), 6, False)]
    if case == "valued":
        return [(pack(n, 1 << 20, True), n, True) for n in (1, 3, 5, 4097, 70001)]
    if case == "small_n":
        return [(pack(max(n, 1), 1 << 20), n, v) for n in (0, 1, 3, 5) for v in (False, True)]
    if case == "bucket_padding":
        return [(np.concatenate([pack(n, 1 << 16), np.zeros(n, np.uint8)]), n, False) for n in (2047, 2048, 2049)]
    if case == "truncated":
        full = pack(1 << 16, 1 << 20)
        return [(full[: full.nbytes // 2], 1 << 16, False), (full[:3], 1 << 16, False), (full[:1], 5, True)]
    assert case == "random_bytes"
    return [(rng.integers(0, 256, int(nb)).astype(np.uint8), int(n), bool(v))
            for nb, n, v in zip(rng.integers(1, 1 << 12, 4096), rng.integers(1, 1 << 11, 4096),
                                rng.integers(0, 2, 4096))]


@pytest.mark.parametrize("case", ["cc_batch", "group_arena", "varint_boundaries", "ids_2^28", "valued", "small_n",
                                  "bucket_padding", "truncated", "random_bytes"])
def test_bdv_decode_matches_twin(cuda_device, case):
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    for buf, n, valued in _bdv_buffers(case):
        b = torch.from_numpy(np.ascontiguousarray(buf)).to(cuda_device)
        before = wd.LAUNCHES["bdv_decode"]
        got = wd.decode_bdv(b, n, valued)
        assert wd.LAUNCHES["bdv_decode"] == before + (1 if n else 0)
        want = wd.decode_bdv_plain(b, n, valued)
        assert len(got) == len(want) == (3 if valued else 2)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w), (case, n, valued, buf.nbytes)


# ---------------------------------------------------------------------------
# ef40_unpack (csrc/wire_decode.cu)


def _ef40_buffers(case):
    """(uint8 buffer, n, capacity) triples of one case."""
    from gelly_streaming_tpu_torch.io import wire

    rng = np.random.default_rng(len(case))

    def arbitrary(n, cap, density=None):
        buf = rng.integers(0, 256, wire.ef40_nbytes(n, cap)).astype(np.uint8)
        bv = (n + cap + 7) // 8
        if density is not None:
            buf[:bv] = np.packbits(rng.random(8 * bv) < density, bitorder="little")
        return buf

    if case == "cc_batch":
        s, d = rng.integers(0, 1 << 20, 1 << 21).astype(np.int32), rng.integers(0, 1 << 20, 1 << 21).astype(np.int32)
        return [(wire.pack_edges(s, d, (wire.EF40, 1 << 20)), 1 << 21, 1 << 20)]
    if case == "packed":
        out = []
        for n, cap in ((1, 1), (7, 5), (4097, 1000), (70001, 1 << 16), (1 << 20, 1 << 20)):
            s, d = rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)
            out.append((wire.pack_edges(s, d, (wire.EF40, cap)), n, cap))
        return out
    if case == "no_ones":
        return [(arbitrary(n, cap, 0.0), n, cap) for n, cap in ((1, 1), (5000, 300), (1 << 21, 1 << 20))]
    if case == "all_ones":
        return [(arbitrary(n, cap, 1.0), n, cap) for n, cap in ((1, 1), (5000, 300), (1 << 21, 1 << 20))]
    if case == "too_few_ones":
        return [(arbitrary(n, cap, n / (4 * (n + cap))), n, cap) for n, cap in ((9, 40), (6000, 6000),
                                                                               (1 << 21, 1 << 20))]
    if case == "too_many_ones":
        return [(arbitrary(n, cap, min(1.0, 2 * n / (n + cap))), n, cap) for n, cap in ((9, 40), (6000, 6000),
                                                                                        (1 << 21, 1 << 20))]
    if case == "odd_n":
        return [(arbitrary(n, cap), n, cap) for n, cap in ((1, 0), (3, 7), (2049, 100), (16385, 1 << 14),
                                                           ((1 << 21) - 1, 1 << 20))]
    assert case == "random_bytes"
    return [(arbitrary(int(n), int(cap)), int(n), int(cap))
            for n, cap in zip(rng.integers(1, 1 << 12, 256), rng.integers(0, 1 << 12, 256))]


@pytest.mark.parametrize("case", ["cc_batch", "packed", "no_ones", "all_ones", "too_few_ones", "too_many_ones",
                                  "odd_n", "random_bytes"])
def test_ef40_unpack_matches_twin(cuda_device, case):
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    for buf, n, cap in _ef40_buffers(case):
        b = torch.from_numpy(buf).to(cuda_device)
        before = dict(wd.LAUNCHES)
        got = wd.unpack_edges_ef40(b, n, cap)
        assert wd.LAUNCHES == {**before, "ef40_unpack": before["ef40_unpack"] + 1}
        want = wd.unpack_edges_ef40_plain(b, n, cap)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w), (case, n, cap)


def test_wire_decodes_take_more_than_one_grid(cuda_device):
    """Batches past one launch's co-resident blocks: bdv_decode's rounds
    (more than 132 chunks of 16,384 edges), ef40_unpack's blocks taking
    several pieces of the bitvector and several pair tiles."""
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    rng = np.random.default_rng(9)
    n, cap = 3 * (1 << 21) + 12345, 1 << 20
    s, d = rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)
    v = rng.integers(-(1 << 27), 1 << 27, n).astype(np.int32)
    for valued in (False, True):
        b = torch.from_numpy(wire.pack_edges_bdv(s, d, cap, val_i32=v if valued else None)).to(cuda_device)
        got, want = wd.decode_bdv(b, n, valued), wd.decode_bdv_plain(b, n, valued)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), valued
    n, cap = (1 << 22) + 3, 1 << 22
    b = torch.from_numpy(rng.integers(0, 256, wire.ef40_nbytes(n, cap)).astype(np.uint8)).to(cuda_device)
    got, want = wd.unpack_edges_ef40(b, n, cap), wd.unpack_edges_ef40_plain(b, n, cap)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_ef40_unpack_reads_views_at_any_offset(cuda_device):
    """A superbatch arena's rows start at any byte: the kernel's staging
    and bit reads do not assume an aligned buffer."""
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    rng = np.random.default_rng(3)
    n, cap = 12345, 4099
    s, d = rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)
    buf = wire.pack_edges(s, d, (wire.EF40, cap))
    big = torch.zeros(buf.nbytes + 64, dtype=torch.uint8, device=cuda_device)
    want = wd.unpack_edges_ef40_plain(torch.from_numpy(buf).to(cuda_device), n, cap)
    for off in range(17):
        view = big[off : off + buf.nbytes]
        view.copy_(torch.from_numpy(buf))
        got = wd.unpack_edges_ef40(view, n, cap)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), off
    with pytest.raises(ValueError):
        wd.unpack_edges_ef40(big[: buf.nbytes - 1], n, cap)


# ---------------------------------------------------------------------------
# wire_unpack (csrc/wire_decode.cu): width 3 and PAIR40


@pytest.mark.parametrize("width", [3, "pair40"], ids=["3", "pair40"])
@pytest.mark.parametrize("n", [1, 2, 3, 31, 2047, 2049, 1 << 16, (1 << 21) + 5])
def test_wire_unpack_matches_twin_at_any_offset(cuda_device, width, n):
    """Exact against the twin and the packed ids (0, C - 1, PAIR40's
    bit-19/20 seam), for buffers starting at every byte of a 16-byte word
    and lengths that are no multiple of 16; one launch a call."""
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    cap = 1 << 20 if width == wire.PAIR40 else 1 << 24
    rng = np.random.default_rng(n)
    s, d = rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)
    s[0], d[-1] = cap - 1, 0
    if n > 4:
        s[1:4] = (1 << 19) - 1, 1 << 19, (1 << 20) - 1
    buf = wire.pack_edges(s, d, width)
    big = torch.full((buf.nbytes + 32,), 0xAB, dtype=torch.uint8, device=cuda_device)
    for off in range(16):
        view = big[off : off + buf.nbytes]
        view.copy_(torch.from_numpy(buf))
        before = dict(wd.LAUNCHES)
        got = wd.unpack_edges_fixed(view, n, width)
        assert wd.LAUNCHES == {**before, "wire_unpack": before["wire_unpack"] + 1}
        want = wd.unpack_edges_fixed_plain(view, n, width)
        assert all(g.dtype == torch.int32 and torch.equal(g, w) for g, w in zip(got, want)), off
        assert np.array_equal(got[0].cpu().numpy(), s) and np.array_equal(got[1].cpu().numpy(), d), off
    with pytest.raises(ValueError):
        wd.unpack_edges_fixed(big[: buf.nbytes - 1], n, width)


def test_wire_unpack_on_the_wire_paths(cuda_device):
    """get_degrees over a PAIR40 from_wire replay and the degrees
    measurement launch the kernel once a batch and never the twin."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.examples import measurements
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import wire_decode as wd

    rng = np.random.default_rng(2)
    cap, batch, n = 1 << 17, 1 << 12, 1 << 15
    s, d = rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)
    cfg = StreamConfig(vertex_capacity=cap, batch_size=batch)
    bufs, _ = wire.pack_stream(s, d, batch, wire.PAIR40)
    wd.reset_launches()
    got = EdgeStream.from_wire(bufs, batch, wire.PAIR40, cfg, device=cuda_device).get_degrees().collect()
    assert wd.LAUNCHES["wire_unpack"] == n // batch and wd.TWIN_CALLS["wire_unpack"] == 0
    assert got == EdgeStream.from_arrays(s, d, cfg, batch_size=batch, device="cpu").get_degrees().collect()
    wd.reset_launches()
    out = measurements.run(["degrees", "--edges", str(n), "--batch", str(batch)])
    assert wd.LAUNCHES["wire_unpack"] == n // batch and out["degree_total"] == 2 * n


def test_checkpointed_compressed_wire_run_on_the_card_resumes(cuda_device, tmp_path):
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import wire_decode as wd
    from gelly_streaming_tpu_torch.utils.recovery import run_supervised

    rng = np.random.default_rng(5)
    c, batch, nb = 1 << 16, 1 << 14, 24
    src = rng.integers(0, c, nb * batch).astype(np.int32)
    dst = rng.integers(0, c, nb * batch).astype(np.int32)
    path = str(tmp_path / "ck")
    want = None
    for kw in ({}, {"wire_compress": 1}, {"wire_compress": 1, "superbatch": 4}):
        cfg = StreamConfig(vertex_capacity=c, batch_size=batch, wire_checkpoint_batches=4, **kw)

        class Crashing(ConnectedComponents):
            calls = 0

            def update(self, st, s, d, v, m):
                type(self).calls += 1
                if type(self).calls == 11:
                    raise RuntimeError("injected crash")
                return super().update(st, s, d, v, m)

        clean = EdgeStream.from_arrays(src, dst, cfg, device=cuda_device).aggregate(ConnectedComponents()).collect()
        agg = Crashing()
        wd.reset_launches()
        restarts = []
        recs = list(run_supervised(
            lambda: EdgeStream.from_arrays(src, dst, cfg, device=cuda_device).aggregate(agg, checkpoint_path=path),
            max_restarts=1, on_restart=lambda n, e: restarts.append(n)))
        assert restarts == [1]
        for got in (recs[-1][0], clean[-1][0]):
            labels = (got.parent.cpu().numpy(), got.seen.cpu().numpy())
            if want is None:
                want = labels
            assert np.array_equal(labels[0], want[0]) and np.array_equal(labels[1], want[1])
        if kw:  # batches 0-10 before the crash (10 decoded, not folded), then 8-23 after the restore
            assert wd.LAUNCHES["bdv_decode"] == 11 + (nb - 8)
        os.remove(path + ".npz")


# ---------------------------------------------------------------------------
# the mesh plane's routing kernels (csrc/routing.cu)


@pytest.mark.parametrize("n,s,cap,owned", [(0, 4, 8, False), (1000, 4, 64, False), (70000, 8, 1024, True),
                                           (5000, 3, 1, True), (300, 8, 0, False), (1 << 18, 64, 32, True)])
def test_owner_pack_matches_twin(cuda_device, n, s, cap, owned):
    from gelly_streaming_tpu_torch.ops import routing as rk

    rng = np.random.default_rng(n + s)
    live = torch.from_numpy(rng.random(n) < 0.4)
    owner = torch.from_numpy(rng.integers(-1, s + 1, n).astype(np.int32)) if owned else None
    a = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32)) if owned else None
    b = torch.from_numpy(rng.integers(-5, 1 << 20, n).astype(np.int32))
    acc_c = torch.zeros(3, dtype=torch.int32)
    want = rk.owner_pack(live, owner, a, b, s, cap, -1, 7, True, True, True, acc_c)
    acc_g = torch.zeros(3, dtype=torch.int32, device=cuda_device)
    on = [None if t is None else t.to(cuda_device) for t in (live, owner, a, b)]
    before = rk.LAUNCHES["owner_pack"]
    got = rk.owner_pack(*on, s, cap, -1, 7, True, True, True, acc_g)
    assert rk.LAUNCHES["owner_pack"] == before + 1
    for x, y in zip(want, got):
        assert torch.equal(x, y.cpu())
    assert torch.equal(acc_c, acc_g.cpu())


@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("rows,s,cap", [(1000, 4, 64), (1 << 18, 8, 4096), (17, 2, 5)])
def test_block_delta_fold_matches_twin(cuda_device, op, rows, s, cap):
    from gelly_streaming_tpu_torch.ops import routing as rk

    rng = np.random.default_rng(rows + cap)
    blk = torch.from_numpy(rng.integers(-100, 100, rows).astype(np.int32))
    rr = [torch.from_numpy(np.where(rng.random(cap) < 0.3, -1, rng.integers(-rows - 3, rows + 3, cap)).astype(np.int32))
          for _ in range(s)]
    vv = [torch.from_numpy(rng.integers(-1000, 1000, cap).astype(np.int32)) for _ in range(s)]
    want = rk.block_delta_fold(blk.clone(), rr, vv, op)
    got = rk.block_delta_fold(blk.to(cuda_device), [r.to(cuda_device) for r in rr], [v.to(cuda_device) for v in vv], op)
    assert torch.equal(want, got.cpu())


@pytest.mark.parametrize("op", ["min", "max", "add"])
@pytest.mark.parametrize("rows,s,offset", [(1000, 4, 0), (1 << 20, 8, 0), (13, 3, 0), (4096, 2, 1)])
def test_slab_fold_matches_twin(cuda_device, op, rows, s, offset):
    from gelly_streaming_tpu_torch.ops import routing as rk

    rng = np.random.default_rng(rows + s)
    blk = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, rows).astype(np.int32))
    slabs = [torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, rows).astype(np.int32)) for _ in range(s)]
    fc = torch.zeros(1, dtype=torch.int32)
    want = rk.slab_fold(blk.clone(), slabs, op, fc)
    on = torch.empty(rows + offset, dtype=torch.int32, device=cuda_device)[offset:]
    on.copy_(blk.to(cuda_device))
    fg = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    got = rk.slab_fold(on, [x.to(cuda_device) for x in slabs], op, fg)
    assert torch.equal(want, got.cpu()) and (int(fg) > 0) == (int(fc) > 0)
    ident = torch.zeros_like(got) if op == "add" else got.clone()
    before = int(fg)
    rk.slab_fold(got, [ident], op, fg)
    assert int(fg) == before


def test_mesh_exchange_on_shared_card_matches_cpu(cuda_device):
    """The owner-sharded CC exchange, 4 shards sharing the card, in the delta
    and the dense regime: the same blocks and counters as the CPU shards."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.parallel import mesh as pm
    from gelly_streaming_tpu_torch.utils import metrics

    rng = np.random.default_rng(0)
    edges = [(int(a), int(b), 0.0, int(t)) for a, b, t in zip(rng.integers(0, 4096, 600), rng.integers(0, 4096, 600),
                                                               np.sort(rng.integers(0, 3000, 600)))]
    out = {}
    for dev, devices in ((cuda_device, [cuda_device] * 4), (torch.device("cpu"), [torch.device("cpu")] * 4)):
        from gelly_streaming_tpu_torch.core.aggregation import MeshAggregationRunner

        metrics.reset_comms_stats()
        cfg = StreamConfig(vertex_capacity=4096, num_shards=4)
        stream = EdgeStream.from_collection(edges, cfg, 32, with_time=True, device=dev)
        runner = MeshAggregationRunner(ConnectedComponents(window_ms=500), pm.make_mesh(4, devices))
        recs = [r[0].parent.cpu() for r in runner.run(stream).collect()]
        out[dev.type] = (recs, metrics.comms_stats())
    assert len(out["cuda"][0]) == len(out["cpu"][0]) >= 5
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"][0], out["cpu"][0]))
    assert out["cuda"][1] == out["cpu"][1]


def _distinct_cards():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs two or more CUDA GPUs")
    return [torch.device("cuda", i) for i in range(min(n, 4))]


def test_wrappers_launch_on_a_card_that_is_not_current(cuda_device):
    """Each mesh kernel handed tensors on the last card while card 0 is
    current: the launch goes to the tensors' card (``ops/_cuda.on_device_of``)."""
    from gelly_streaming_tpu_torch.ops import routing as rk
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    far = _distinct_cards()[-1]
    rng = np.random.default_rng(5)
    torch.cuda.set_device(0)
    live = torch.from_numpy(rng.random(70000) < 0.4)
    b = torch.from_numpy(rng.integers(0, 1 << 20, 70000).astype(np.int32))
    want = rk.owner_pack(live, None, None, b, 4, 4096, want_sent=True)
    got = rk.owner_pack(live.to(far), None, None, b.to(far), 4, 4096, want_sent=True)
    assert all(x is None or torch.equal(x, y.cpu()) for x, y in zip(want, got))
    blk = torch.from_numpy(rng.integers(0, 1000, 5000).astype(np.int32))
    slabs = [torch.from_numpy(rng.integers(0, 1000, 5000).astype(np.int32)) for _ in range(3)]
    assert torch.equal(rk.slab_fold(blk.clone(), slabs, "min"),
                       rk.slab_fold(blk.to(far), [s.to(far) for s in slabs], "min").cpu())
    rows = [torch.from_numpy(rng.integers(-1, 5000, 64).astype(np.int32)) for _ in range(3)]
    vals = [s[:64] for s in slabs]
    assert torch.equal(rk.block_delta_fold(blk.clone(), rows, vals, "add"),
                       rk.block_delta_fold(blk.to(far), [r.to(far) for r in rows], [v.to(far) for v in vals],
                                           "add").cpu())
    parent = torch.arange(4096, dtype=torch.int32)
    src = torch.from_numpy(rng.integers(0, 4096, 3000).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, 4096, 3000).astype(np.int32))
    assert torch.equal(uf.union_edges(parent.clone(), src, dst),
                       uf.union_edges(parent.to(far), src.to(far), dst.to(far)).cpu())
    assert torch.cuda.current_device() == 0


@pytest.mark.parametrize("sharded", [0, 1])
def test_mesh_on_distinct_cards_matches_cpu(cuda_device, sharded):
    """CC on 4 shards spread over the visible cards (up to 4, one each),
    both planes and both paths (windowed, wire): the same records and
    counters as 4 CPU shards."""
    from gelly_streaming_tpu_torch.core.aggregation import MeshAggregationRunner
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.parallel import mesh as pm
    from gelly_streaming_tpu_torch.utils import metrics

    cards = _distinct_cards()
    rng = np.random.default_rng(1)
    n = 6000
    src, dst = rng.integers(0, 1 << 14, n).astype(np.int32), rng.integers(0, 1 << 14, n).astype(np.int32)
    edges = [(int(a), int(b), 0.0, int(t)) for a, b, t in zip(src, dst, np.sort(rng.integers(0, 3000, n)))]
    out = {}
    for name, devices in (("cuda", [cards[i % len(cards)] for i in range(4)]), ("cpu", [torch.device("cpu")] * 4)):
        dev = devices[0]
        cfg = StreamConfig(vertex_capacity=1 << 14, batch_size=1024, num_shards=4, sharded_state=sharded)
        mesh = pm.make_mesh(4, devices)
        metrics.reset_comms_stats()
        windowed = MeshAggregationRunner(ConnectedComponents(window_ms=500), mesh).run(
            EdgeStream.from_collection(edges, cfg, 256, with_time=True, device=dev)).collect()
        wired = list(MeshAggregationRunner(ConnectedComponents(), mesh).wire_records(
            EdgeStream.from_arrays(src, dst, cfg, device=dev)))
        out[name] = ([r[0].parent.cpu() for r in windowed] + [wired[-1][0].parent.cpu()], metrics.comms_stats())
    assert len(out["cuda"][0]) == len(out["cpu"][0]) >= 5
    assert all(torch.equal(a, b) for a, b in zip(out["cuda"][0], out["cpu"][0]))
    assert out["cuda"][1] == out["cpu"][1]
