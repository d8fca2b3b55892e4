"""Port parity: the windowed exact triangle count of the PyTorch port
(gelly_streaming_tpu_torch) against the JAX package on the CPU.

The port runs its kernels' plain PyTorch twins here (device="cpu"); the JAX
side runs the Pallas kernel in interpret mode, as tests/test_pallas_triangles.py
does.  Inputs come from numpy seeds and are handed to both; counts must be
equal exactly.  The CUDA kernels themselves are held against the same twins
on the GPU by tests/test_torch_cuda.py and chip_smoke.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.io.sources import _batched as j_batched
from gelly_streaming_tpu.library import triangles as jtri
from gelly_streaming_tpu.ops import neighbors as jnbr
from gelly_streaming_tpu.ops import pallas_triangles as jpal
from gelly_streaming_tpu.ops import segments as jseg
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.io.sources import _batched as t_batched
from gelly_streaming_tpu_torch.library import triangles as ttri
from gelly_streaming_tpu_torch.ops import dense_triangles as dt
from gelly_streaming_tpu_torch.ops import neighbors as tnbr
from gelly_streaming_tpu_torch.ops import segments as tseg

# the pipelined counter runs the Prefetcher's threads
pytestmark = pytest.mark.timeout_cap(120)

CPU = "cpu"

TRIANGLES_DATA = [
    (1, 2, 100), (1, 3, 150), (3, 2, 200), (2, 4, 250), (3, 4, 300),
    (3, 5, 350), (4, 5, 400), (4, 6, 450), (6, 5, 500), (5, 7, 550),
    (6, 7, 600), (8, 6, 650), (7, 8, 700), (7, 9, 750), (8, 9, 800),
    (10, 8, 850), (9, 10, 900), (9, 11, 950), (10, 11, 1000),
]


def _dense_reference(adj: np.ndarray) -> int:
    a = adj.astype(np.int64)
    return int(np.sum(a * (a @ a)) // 6)


# ---------------------------------------------------------------------------
# dense pane count (the kernels' plain twins) vs the Pallas kernel


@pytest.mark.parametrize(
    "n,p,seed",
    [(30, 0.3, 0), (128, 0.1, 1), (200, 0.05, 2), (257, 0.2, 3), (384, 0.04, 4), (96, 0.6, 5)],
)
def test_dense_count_matches_pallas(n, p, seed):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < p, 1)
    u, v = np.nonzero(upper)
    u, v = u.astype(np.int32), v.astype(np.int32)
    got = dt.pane_triangles_dense(u, v, n, device=CPU)
    assert got == jpal.pane_triangles_dense(u, v, n) == _dense_reference(upper | upper.T)


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_dense_count_multigraph_matches_pallas(seed):
    """Duplicates, both orientations, self-loops and a mask."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 300))
    u = rng.integers(0, n, 4 * n).astype(np.int32)
    v = rng.integers(0, n, 4 * n).astype(np.int32)
    u = np.concatenate([u, v[: n // 2], u[:5]])
    v = np.concatenate([v, u[: n // 2], u[:5]])
    mask = rng.random(len(u)) < 0.8
    got = dt.pane_triangles_dense(u, v, n, mask=mask, device=CPU)
    assert got == jpal.pane_triangles_dense(u, v, n, mask=mask)


def test_dense_count_small_cases_match_pallas():
    e = np.array([], np.int32)
    assert dt.pane_triangles_dense(e, e, 0, device=CPU) == 0
    path = np.arange(10, dtype=np.int32)
    assert dt.pane_triangles_dense(path, path + 1, 11, device=CPU) == 0
    tri_u, tri_v = np.array([0, 0, 1], np.int32), np.array([1, 2, 2], np.int32)
    assert dt.pane_triangles_dense(tri_u, tri_v, 3, device=CPU) == 1
    uu, vv = zip(*[(a, b) for a in range(4) for b in range(a + 1, 4)])
    uu, vv = np.array(uu, np.int32), np.array(vv, np.int32)
    assert dt.pane_triangles_dense(uu, vv, 4, device=CPU) == jpal.pane_triangles_dense(uu, vv, 4) == 4


def test_triangle_count_dense_checks_shapes():
    with pytest.raises(ValueError):
        dt.triangle_count_dense(torch.zeros((100, 100)))
    with pytest.raises(ValueError):
        dt.triangle_count_dense(torch.zeros((dt.MAX_K + 128,) * 2, dtype=torch.bool))
    k4 = 1 - torch.eye(128)
    k4[4:, :] = 0
    k4[:, 4:] = 0
    assert dt.triangle_count_dense(k4) == 4


def test_pack_pane_is_byte_identical_and_guards_ids():
    rng = np.random.default_rng(20)
    for n in (0, 1, 5, 64, 1000):
        u = rng.integers(0, 1 << 14, n).astype(np.int32)
        v = rng.integers(0, 1 << 14, n).astype(np.int32)
        mask = rng.random(n) < 0.7
        for m in (None, mask):
            tw, tn = dt.pack_pane(u, v, m)
            jw, jn = jpal.pack_pane(u, v, m)
            assert tw.dtype == jw.dtype == np.uint32
            assert tw.tobytes() == jw.tobytes() and int(tn) == int(jn)
    top = (1 << 14) - 1
    dt.pack_pane(np.array([top]), np.array([0]))
    for bad_u, bad_v in (([1 << 14], [0]), ([-1], [0]), ([0], [1 << 14])):
        with pytest.raises(ValueError, match="pack_pane ids"):
            dt.pack_pane(np.array(bad_u, np.int32), np.array(bad_v, np.int32))


# ---------------------------------------------------------------------------
# the kernels' plain twins against numpy


@pytest.mark.parametrize("k,edges,seed", [(32, 50, 0), (128, 900, 1), (384, 3000, 2)])
def test_pane_adjacency_twin_matches_numpy(k, edges, seed):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, k, edges)
    v = rng.integers(0, k, edges)
    w, n = dt.pack_pane(u, v)
    # garbage past n must be ignored
    w = np.concatenate([w, rng.integers(0, 1 << 28, 7).astype(np.uint32)])
    words, nn = (torch.from_numpy(a) for a in dt.packed_host_arrays(w, n))
    bits = dt.pane_adjacency(words, nn, k)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (k, k // 32)
    want = np.zeros((k, k), bool)
    keep = u != v
    want[u[keep], v[keep]] = True
    want[v[keep], u[keep]] = True
    np.testing.assert_array_equal(dt.unpack_bits(bits).numpy(), want)
    # the same words as numpy's little-endian bit packing, bit 31 included
    packed = np.packbits(want, axis=1, bitorder="little").view("<u4").view(np.int32)
    np.testing.assert_array_equal(bits.numpy(), packed)


def test_pack_bits_round_trip_uses_bit_31():
    adj = torch.zeros((64, 64), dtype=torch.bool)
    adj[0, 31] = adj[31, 0] = adj[5, 63] = adj[63, 5] = True
    bits = dt.pack_bits(adj)
    assert int(bits[0, 0]) == -(1 << 31) and int(bits[5, 1]) == -(1 << 31)
    assert torch.equal(dt.unpack_bits(bits), adj)


@pytest.mark.parametrize("k,p,seed", [(32, 0.3, 0), (256, 0.1, 1), (384, 0.05, 2)])
def test_dense_triangles_twin_matches_numpy(k, p, seed):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((k, k)) < p, 1)
    adj = upper | upper.T
    total = dt.dense_triangles(dt.pack_bits(torch.from_numpy(adj)))
    assert total.dtype == torch.int64 and tuple(total.shape) == (1,)
    a = adj.astype(np.int64)
    assert int(total[0]) == int(np.trace(a @ a @ a)) == 6 * _dense_reference(adj)


def _above(b: int) -> np.uint32:
    """Mask of the bits strictly above bit b of a uint32 word."""
    return np.uint32(0 if b == 31 else (0xFFFFFFFF << (b + 1)) & 0xFFFFFFFF)


def _oriented_count_model(bits: torch.Tensor) -> int:
    """The dense_triangles kernel's arithmetic in numpy: work items (row i,
    slab of 32 words), candidate columns j > i of the slab, and for each
    the popcount of row_i & row_j over row j's words from j // 32 on, with
    the bits at or below j masked in word j // 32; six times the sum."""
    words = bits.numpy().view(np.uint32)
    k, wpr = words.shape
    total = 0
    for i in range(k):
        for w0 in range(0, wpr, 32):
            if 32 * (w0 + 32) <= i + 1:  # every column of the slab is <= i
                continue
            slab = np.unpackbits(words[i, w0 : w0 + 32].view(np.uint8), bitorder="little")
            for j in np.nonzero(slab)[0] + 32 * w0:
                if j <= i:
                    continue
                jw, jb = divmod(int(j), 32)
                both = words[i, jw:] & words[j, jw:]
                both[0] &= _above(jb)
                total += int(np.unpackbits(both.view(np.uint8)).sum())
    return 6 * total


def _boundary_clique(k: int) -> np.ndarray:
    """Complete graph on vertices at bit 0/31 of words and at the ends."""
    ids = sorted({v for v in (0, 1, 30, 31, 32, 33, 63, 64, 95, k - 33, k - 32, k - 1) if v < k})
    adj = np.zeros((k, k), bool)
    adj[np.ix_(ids, ids)] = True
    np.fill_diagonal(adj, False)
    return adj


def _star_with_leaf_edges(k: int, seed: int) -> np.ndarray:
    """Vertex 0 adjacent to every other vertex, plus random leaf edges."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((k, k), bool)
    adj[0, 1:] = adj[1:, 0] = True
    u, v = rng.integers(1, k, 2 * k), rng.integers(1, k, 2 * k)
    adj[u, v] = adj[v, u] = True
    np.fill_diagonal(adj, False)
    return adj


def _random_adjacency(k: int, p: float, seed: int) -> np.ndarray:
    upper = np.triu(np.random.default_rng(seed).random((k, k)) < p, 1)
    return upper | upper.T


@pytest.mark.parametrize(
    "case,adj",
    [
        ("K=32", _random_adjacency(32, 0.4, 40)),
        ("K=96", _random_adjacency(96, 0.2, 41)),
        ("K=256", _random_adjacency(256, 0.1, 42)),
        ("K=384", _random_adjacency(384, 0.05, 43)),
        ("star K=256", _star_with_leaf_edges(256, 44)),
        ("bit 31 K=160", _boundary_clique(160)),
        ("bit 31 K=96", _boundary_clique(96)),
        ("empty K=64", np.zeros((64, 64), bool)),
    ],
)
def test_oriented_count_model_matches_twin_numpy_and_pallas(case, adj):
    k = adj.shape[0]
    bits = dt.pack_bits(torch.from_numpy(adj))
    model = _oriented_count_model(bits)
    a = adj.astype(np.int64)
    assert model == int(dt.dense_triangles_plain(bits)[0]) == int(np.trace(a @ a @ a))
    pad = -k % jpal.TILE  # isolated padding vertices add no triangle
    padded = np.pad(adj, ((0, pad), (0, pad))).astype(np.float32)
    assert model == 6 * jpal.triangle_count_dense(padded, interpret=True)


def test_kernel_wrappers_check_arguments():
    w = torch.zeros(8, dtype=torch.int32)
    n = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError):
        dt.pane_adjacency(w.to(torch.int64), n, 128)
    with pytest.raises(ValueError):
        dt.pane_adjacency(w, n, 100)
    with pytest.raises(ValueError):
        dt.pane_adjacency(w, n.reshape(()), 128)
    with pytest.raises(ValueError):
        dt.dense_triangles(torch.zeros((64, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="no pane_adjacency kernel"):
        dt.pane_adjacency(w.to("meta"), n.to("meta"), 128)


# ---------------------------------------------------------------------------
# host prep, CSR fallback, neighbor tables


def _pane(seed, n_v, n_e):
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, n_v, n_e).astype(np.int32),
        rng.integers(0, n_v, n_e).astype(np.int32),
    )


@pytest.mark.parametrize(
    "n_v,n_e,offset", [(100, 400, 0), (300, 2000, 0), (400, 1500, 20000), (2000, 3000, 0)]
)
def test_pane_prepare_matches_jax(n_v, n_e, offset):
    src, dst = _pane(n_v + n_e, n_v, n_e)
    src, dst = src + offset, dst + offset
    tmeta, tarr = ttri._pane_prepare((src, dst), torch.device(CPU))
    jmeta, jarr = jtri._pane_prepare((src, dst))
    assert tmeta == jmeta
    if tmeta[0] == "packed":
        np.testing.assert_array_equal(tarr[0].view(np.uint32), jarr[0])
        assert int(tarr[1][0]) == int(jarr[1])
    else:
        for a, b in zip(tarr, jarr):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,n_v,n_e", [(0, 600, 3000), (1, 1500, 6000), (2, 800, 9000)])
def test_csr_count_matches_jax(seed, n_v, n_e):
    """Panes past the CPU dense bound (512) take the CSR path on both sides."""
    src, dst = _pane(seed, n_v, n_e)
    meta, (cu, cv) = ttri._pane_prepare((src, dst), torch.device(CPU))
    assert meta[0] == "csr"
    _, k_n, d_max = meta
    got = ttri._count_kernel_impl(torch.from_numpy(cu), torch.from_numpy(cv), k_n, d_max)
    want = jtri._count_kernel_impl(np.asarray(cu), np.asarray(cv), k_n, d_max)
    assert int(got) == int(want) == ttri._pane_triangle_count(src, dst, CPU)
    dense_k = dt.pane_k(k_n)
    assert int(got) == dt.pane_triangles_dense(cu, cv, dense_k, device=CPU)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_occurrence_rank_matches_jax(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 20, 300).astype(np.int32)
    mask = rng.random(300) < 0.7
    for m in (None, mask):
        got = tseg.occurrence_rank(torch.from_numpy(keys), None if m is None else torch.from_numpy(m))
        want = jseg.occurrence_rank(keys, m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_neighbor_table_interop_continues_like_jax():
    """A JAX table carried across with interop.neighbor_table_from_numpy
    takes the next batch (with overflow) exactly as the JAX table does."""
    rng = np.random.default_rng(3)
    cap, deg = 32, 6
    s1, d1 = rng.integers(0, cap, 80).astype(np.int32), rng.integers(0, cap, 80).astype(np.int32)
    m1 = rng.random(80) < 0.8
    jt = jnbr.insert_batch(jnbr.init_table(cap, deg), s1, d1, m1)
    tt = interop.neighbor_table_from_numpy(
        np.asarray(jt.nbrs), np.asarray(jt.deg), np.asarray(jt.dropped), device=CPU
    )
    s2, d2 = rng.integers(0, cap, 120).astype(np.int32), rng.integers(0, cap, 120).astype(np.int32)
    m2 = rng.random(120) < 0.9
    jt2 = jnbr.insert_batch(jt, s2, d2, m2)
    tt2 = tnbr.insert_batch(tt, torch.from_numpy(s2), torch.from_numpy(d2), torch.from_numpy(m2))
    np.testing.assert_array_equal(tt2.nbrs.numpy(), np.asarray(jt2.nbrs))
    np.testing.assert_array_equal(tt2.deg.numpy(), np.asarray(jt2.deg))
    assert int(tt2.dropped) == int(jt2.dropped) > 0
    q = rng.integers(0, cap, 50).astype(np.int32)
    r = rng.integers(0, cap, 50).astype(np.int32)
    np.testing.assert_array_equal(
        tnbr.contains_batch(tt2, torch.from_numpy(q), torch.from_numpy(r)).numpy(),
        np.asarray(jnbr.contains_batch(jt2, q, r)),
    )
    trows, tvalid = tnbr.gather_rows(tt2, torch.from_numpy(q))
    jrows, jvalid = jnbr.gather_rows(jt2, q)
    np.testing.assert_array_equal(trows.numpy(), np.asarray(jrows))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def test_config_interop_round_trips():
    jcfg = JConfig(
        vertex_capacity=1 << 12, max_degree=17, batch_size=99, out_of_orderness_ms=5,
        superbatch=1, num_shards=4, wire_encoding="plain",
    )
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    for f in dataclasses.fields(TConfig):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name)
    with pytest.raises(ValueError):
        interop.config_from_dict({"ingest_window_edges": 3, "ingest_window_ms": 3})
    with pytest.raises(ValueError):
        interop.neighbor_table_from_numpy(np.zeros((4, 2)), np.zeros(3), 0, device=CPU)


# ---------------------------------------------------------------------------
# window_triangles end to end


def _timed_streams(src, dst, tim, bs, capacity=1 << 16):
    j = JStream.from_batches(
        j_batched(src, dst, None, tim, None, bs), JConfig(vertex_capacity=capacity)
    )
    t = TStream.from_batches(
        t_batched(src, dst, None, tim, None, bs, CPU), TConfig(vertex_capacity=capacity), device=CPU
    )
    return j, t


def test_window_triangles_itcase_golden():
    edges = [(s, d, 0, t) for s, d, t in TRIANGLES_DATA]
    cfg = TConfig(vertex_capacity=16, max_degree=16)
    stream = TStream.from_collection(edges, cfg, batch_size=4, with_time=True, device=CPU)
    got = ttri.window_triangles(stream, 400).collect()
    jstream = JStream.from_collection(
        edges, JConfig(vertex_capacity=16, max_degree=16), batch_size=4, with_time=True
    )
    assert got == jtri.window_triangles(jstream, 400).collect()
    assert sorted(got) == [(2, 399), (2, 1199), (3, 799)]


@pytest.mark.parametrize("slide_ms", [None, 250, 500])
def test_window_triangles_seeded_stream_matches_jax(slide_ms):
    rng = np.random.default_rng(30)
    n = 4000
    src = rng.integers(0, 120, n)
    dst = rng.integers(0, 120, n)
    tim = np.sort(rng.integers(0, 6000, n))
    j, t = _timed_streams(src, dst, tim, 512)
    got = ttri.window_triangles(t, 1000, slide_ms=slide_ms).collect()
    assert got == jtri.window_triangles(j, 1000, slide_ms=slide_ms).collect()
    assert len(got) >= 6 and any(c > 0 for c, _ in got)


def test_window_triangles_mixed_dense_and_csr_panes_match_jax():
    """Windows below and above the CPU dense bound, a sparse-id window that
    compacts into the dense path, a triangle-free and an empty-gap window."""
    rng = np.random.default_rng(31)
    parts = [
        (rng.integers(0, 200, 1500), rng.integers(0, 200, 1500)),  # dense ids
        (rng.integers(0, 900, 4000), rng.integers(0, 900, 4000)),  # CSR
        (rng.integers(0, 100, 800) * 97, rng.integers(0, 100, 800) * 97),  # compacted dense
        (np.arange(50), np.arange(50) + 1),  # a path: no triangles
        (rng.integers(0, 3000, 3000), rng.integers(0, 3000, 3000)),  # sparse CSR
    ]
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    tim = np.concatenate(
        [np.sort(rng.integers(w * 2000, w * 2000 + 1000, len(p[0]))) for w, p in enumerate(parts)]
    )
    j, t = _timed_streams(src, dst, tim, 700)
    kinds = [ttri._pane_prepare(p, torch.device(CPU))[0][0] for p in parts]
    assert kinds == ["packed", "csr", "packed", "packed", "csr"]
    got = ttri.window_triangles(t, 1000).collect()
    assert got == jtri.window_triangles(j, 1000).collect()
    assert got[3] == (0, 6999)


def test_pipelined_pane_counts_match_jax():
    from gelly_streaming_tpu_torch.utils.metrics import WindowLatencyRecorder

    panes = [_pane(s, n_v, n_e) for s, n_v, n_e in [(0, 64, 300), (1, 700, 3000), (2, 300, 2000), (3, 5, 0), (4, 128, 900)]]
    rec, dev_rec = WindowLatencyRecorder(), WindowLatencyRecorder()
    got = ttri.pipelined_pane_counts(
        panes, recorder=rec, warmup=1, depth=3, device_recorder=dev_rec, device=CPU
    )
    assert got == jtri.pipelined_pane_counts(panes, depth=3)
    assert len(rec.latencies_ms) == 4 and len(dev_rec.latencies_ms) == 3
    assert rec.percentile(100) >= rec.percentile(50) >= 0


def test_pipelined_pane_counts_surfaces_prepare_errors():
    bad = [(np.array([0, 1], np.int32), np.array([1, 2], np.int32)), (np.array([0]), np.array([1, 2]))]
    with pytest.raises(Exception):
        ttri.pipelined_pane_counts(bad, device=CPU)


def test_window_triangles_refuses_unported_planes():
    # the async and superbatch planes are ported: the JAX package's records
    edges = [(1, 2, 0, 5), (2, 3, 0, 6), (1, 3, 0, 7)]
    for kw in ({"async_windows": 2}, {"superbatch": 4}):
        s = TStream.from_collection(edges, TConfig(**kw), with_time=True, device=CPU)
        j = JStream.from_collection(edges, JConfig(**kw), with_time=True)
        assert ttri.window_triangles(s, 100).collect() == jtri.window_triangles(j, 100).collect() == [(1, 99)]
    s = TStream.from_collection(edges, TConfig(superbatch=1), with_time=True, device=CPU)
    assert ttri.window_triangles(s, 100).collect() == [(1, 99)]


# ---------------------------------------------------------------------------
# the example program and device selection


ITCASE_FILE = "".join(f"{s} {d} {t}\n" for s, d, t in TRIANGLES_DATA)


@pytest.mark.parametrize("extra", [["400"], ["400", "--slide=200"], ["300"]])
def test_example_csv_matches_jax_example(tmp_path, extra):
    from gelly_streaming_tpu.examples import window_triangles as jex
    from gelly_streaming_tpu_torch.examples import window_triangles as tex

    inp = os.path.join(str(tmp_path), "in.txt")
    with open(inp, "w") as f:
        f.write(ITCASE_FILE)
    jout = os.path.join(str(tmp_path), "jax.csv")
    tout = os.path.join(str(tmp_path), "torch.csv")
    jex.main([inp, jout, *extra])
    tex.main([inp, tout, *extra, "--device=cpu"])
    with open(jout) as a, open(tout) as b:
        assert a.read() == b.read()
    if extra == ["400"]:
        with open(tout) as b:
            assert sorted(b.read().split()) == ["2,1199", "2,399", "3,799"]


def test_parse_edge_file_matches_jax_numpy_parser(tmp_path):
    from gelly_streaming_tpu.io.sources import _parse_edge_file_numpy
    from gelly_streaming_tpu_torch.io.sources import parse_edge_file

    for text in (ITCASE_FILE, "# c\n1 2\n3,4\n", "1 2 +\n2 3 -\n", "1\t2\t0.5\t10\n% x\n3 4 1.5 20\n"):
        path = os.path.join(str(tmp_path), "e.txt")
        with open(path, "w") as f:
            f.write(text)
        for a, b in zip(parse_edge_file(path), _parse_edge_file_numpy(path)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)


def test_cuda_without_gpu_raises(monkeypatch):
    from gelly_streaming_tpu_torch.device import resolve_device
    from gelly_streaming_tpu_torch.examples import window_triangles as tex

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            resolve_device(dev)
    with pytest.raises(RuntimeError):
        TStream.from_collection([(1, 2)], TConfig())
    with pytest.raises(RuntimeError):
        dt.pane_triangles_dense(np.array([0]), np.array([1]), 2)
    with pytest.raises(RuntimeError):
        ttri.pipelined_pane_counts([])
    with pytest.raises(RuntimeError):
        tex.main(["--device=cuda"])
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
