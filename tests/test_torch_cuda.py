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
