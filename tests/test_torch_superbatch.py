"""Port parity: the windowed superbatch planes of the PyTorch port against the
JAX package on the CPU.

``cfg.superbatch`` > 1 groups up to K closed panes a dispatch: the
aggregation folds a group's [rows, E_pad] layout one row a pane, and
``window_triangles`` counts a group's canonical edges in one
``csr_triangles`` call.  The records must equal the JAX package's and the
per-pane path's (mirroring tests/test_superbatch.py's windowed cases), the
grouping helpers must build the JAX package's layouts, and the kernel's
plain twin must equal the JAX package's ``_superpane_count_fn`` and
``_count_kernel_impl`` on seeded [K, E] inputs with padding rows, an
all-masked row and a hub row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import windows as jwin
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.library import connected_components as jcc
from gelly_streaming_tpu.library import triangles as jtri
from gelly_streaming_tpu_torch.core import windows as twin
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.library import connected_components as tcc
from gelly_streaming_tpu_torch.library import triangles as ttri
from gelly_streaming_tpu_torch.ops import csr_triangles as ct

CPU = "cpu"


def _timed_edges(n=600, c=48, seed=5, step=37):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(0, c)), int(rng.integers(0, c)), 0.0, step * i) for i in range(n)]


def _components(recs):
    return [r[0].components() for r in recs]


# ---------------------------------------------------------------------------
# the planes' records


@pytest.mark.parametrize("sb", [2, 4, 5])
def test_windowed_superbatch_matches_per_pane_and_jax(sb):
    edges = _timed_edges()
    runs = []
    for k in (0, sb):
        cfg = TConfig(vertex_capacity=64, batch_size=64, superbatch=k)
        stream = TStream.from_collection(edges, cfg, 64, with_time=True, device=CPU)
        runs.append(stream.aggregate(tcc.ConnectedComponents(window_ms=1000)).collect())
    j = JStream.from_collection(edges, JConfig(vertex_capacity=64, batch_size=64, superbatch=sb), 64, with_time=True)
    j_recs = j.aggregate(jcc.ConnectedComponents(window_ms=1000)).collect()
    assert _components(runs[0]) == _components(runs[1]) == _components(j_recs)
    for (t,), (jr,) in zip(runs[1], j_recs):
        np.testing.assert_array_equal(t.parent.numpy(), np.asarray(jr.parent))
    assert len(runs[0]) > 5  # windowed, not one global pane


def test_windowed_superbatch_untimed_global_pane():
    rng = np.random.default_rng(7)
    pairs = list(zip(rng.integers(0, 64, 512).tolist(), rng.integers(0, 64, 512).tolist()))
    # a collection source is not wire-backed: the windowed path runs, and
    # the untimed stream's single global pane makes a group of one
    out = TStream.from_collection(pairs, TConfig(vertex_capacity=64, batch_size=64, superbatch=4), 64,
                                  device=CPU).aggregate(tcc.ConnectedComponents()).collect()
    ref = JStream.from_collection(pairs, JConfig(vertex_capacity=64, batch_size=64, superbatch=4),
                                  64).aggregate(jcc.ConnectedComponents()).collect()
    assert _components(out) == _components(ref)


@pytest.mark.parametrize("slide", [None, 500])
def test_window_triangles_superbatch_matches_per_pane_and_jax(slide):
    edges = _timed_edges(n=700, c=40)

    def run(stream_cls, cfg_cls, fn, sb, **kw):
        cfg = cfg_cls(vertex_capacity=64, batch_size=64, superbatch=sb)
        return fn(stream_cls.from_collection(edges, cfg, 64, with_time=True, **kw), 1000, slide).collect()

    r1 = run(TStream, TConfig, ttri.window_triangles, 0, device=CPU)
    r4 = run(TStream, TConfig, ttri.window_triangles, 4, device=CPU)
    assert r1 == r4 == run(JStream, JConfig, jtri.window_triangles, 4)
    assert any(c > 0 for c, _ in r1)  # the workload has triangles


def test_superbatched_window_counts_keep_empty_panes():
    """A pane with no edge and one with only a self-loop still emit (0, ts)
    in their group, as the JAX package's grouping keeps them."""
    panes = [
        twin.WindowPane(0, 99, np.array([1, 2, 1]), np.array([2, 3, 3]), None, None),
        twin.WindowPane(1, 199, np.zeros(0, np.int64), np.zeros(0, np.int64), None, None),
        twin.WindowPane(2, 299, np.array([4]), np.array([4]), None, None),
        twin.WindowPane(3, 399, np.array([0, 1, 2, 0]), np.array([1, 2, 0, 2]), None, None),
        twin.WindowPane(4, 499, np.array([7, 8, 7]), np.array([8, 9, 9]), None, None),
    ]
    j_panes = [jwin.WindowPane(*p) for p in panes]
    got = list(ttri._superbatched_window_counts(panes, 4, torch.device(CPU)))
    assert got == list(jtri._superbatched_window_counts(j_panes, 4))
    assert got == [(1, 99), (0, 199), (0, 299), (1, 399), (1, 499)]


# ---------------------------------------------------------------------------
# the grouping helpers


def test_pad_pane_edges_into_arenas_matches_jax():
    """The async plane's pow2 pad into pooled arenas equals the JAX
    package's ``pad_pane_edges``; a recycled arena's old entries are gone
    (20 edges, then 17 in the same 32-slot arenas)."""
    from gelly_streaming_tpu_torch.core import async_exec

    rng = np.random.default_rng(6)
    pool = async_exec.ArenaPool(per_shape=2)
    for n in (1, 5, 8, 20, 17):
        pane = twin.WindowPane(0, 99, rng.integers(0, 9, n), rng.integers(0, 9, n), None, None)
        arenas = tuple(pool.acquire((twin.pow2(n),), dt) for dt in (torch.int32, torch.int32, torch.bool))
        got = twin.pad_pane_edges(pane, out=tuple(a.numpy() for a in arenas))
        for a, b in zip(got, jwin.pad_pane_edges(jwin.WindowPane(*pane))):
            np.testing.assert_array_equal(a, np.asarray(b))
        pool.release(*arenas)


def test_group_and_pad_helpers_match_jax():
    rng = np.random.default_rng(3)
    sizes = [5, 0, 3, 17, 0, 1, 8]
    panes = [twin.WindowPane(w, 100 * w + 99, rng.integers(0, 9, n), rng.integers(0, 9, n),
                             rng.random(n).astype(np.float32), None) for w, n in enumerate(sizes)]
    j_panes = [jwin.WindowPane(*p) for p in panes]
    for keep in (False, True):
        got = [[p.window_id for p in g] for g in twin.group_panes(iter(panes), 3, keep_empty=keep)]
        assert got == [[p.window_id for p in g] for g in jwin.group_panes(iter(j_panes), 3, keep_empty=keep)]
    for p, jp in zip(panes, j_panes):
        if p.num_edges:
            for a, b in zip(twin.pad_pane_edges(p), jwin.pad_pane_edges(jp)):
                np.testing.assert_array_equal(a, np.asarray(b))


def test_assemble_superpane_rows_matches_jax():
    rng = np.random.default_rng(4)
    panes = [twin.WindowPane(w, -1, rng.integers(0, 50, n), rng.integers(0, 50, n),
                             (rng.random(n).astype(np.float32), rng.integers(0, 5, (n, 2)).astype(np.int32)), None)
             for w, n in enumerate([7, 30, 2])]
    got = tcc.ConnectedComponents()._assemble_superpane_rows(panes)
    want = jcc.ConnectedComponents()._assemble_superpane_rows([jwin.WindowPane(*p) for p in panes])
    for a, b in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(got[2], want[2]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert got[0].shape == (4, 32)  # pow2 rows and edges


# ---------------------------------------------------------------------------
# the kernel's plain twin against the JAX functions


def _rows(rng, k, e_pad, n_v, cases):
    """Seeded [k, e_pad] canonical rows: each case makes one pane's
    deduplicated (lo, hi) pairs over [0, n_v); padding rows stay masked."""
    u = np.zeros((k, e_pad), np.int32)
    v = np.zeros((k, e_pad), np.int32)
    ok = np.zeros((k, e_pad), bool)
    for row, case in enumerate(cases):
        if case == "uniform":
            a, b = rng.integers(0, n_v, 3 * e_pad // 4), rng.integers(0, n_v, 3 * e_pad // 4)
        elif case == "hub":  # vertex 0 joined to most others, plus random edges
            a = np.concatenate([np.zeros(n_v - 8, np.int64), rng.integers(0, n_v, e_pad // 4)])
            b = np.concatenate([np.arange(1, n_v - 7), rng.integers(0, n_v, e_pad // 4)])
        elif case == "masked":  # edges written but every slot masked
            u[row], v[row] = rng.integers(0, n_v, e_pad), rng.integers(0, n_v, e_pad)
            continue
        else:  # a padding row
            continue
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        pairs = np.unique(np.stack([lo[lo != hi], hi[lo != hi]], axis=1), axis=0)[:e_pad]
        u[row, : len(pairs)], v[row, : len(pairs)], ok[row, : len(pairs)] = pairs[:, 0], pairs[:, 1], True
    deg = max(int(np.bincount(np.concatenate([u[r][ok[r]], v[r][ok[r]]]), minlength=1).max()) if ok[r].any() else 1
              for r in range(k))
    return u, v, ok, 1 << (deg - 1).bit_length()


@pytest.mark.parametrize("cases", [["uniform", "uniform", "hub", "masked"], ["hub", "uniform"],
                                   ["masked", "uniform", "pad", "pad"]])
def test_twin_matches_jax_superpane_count_fn(cases):
    rng = np.random.default_rng(len(cases) + len(cases[0]))
    k, e_pad, n_v = len(cases), 256, 96
    u, v, ok, d = _rows(rng, k, e_pad, n_v, cases)
    got = ct.csr_triangles(torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(ok), n_v, d)
    want = np.asarray(jtri._superpane_count_fn(k, e_pad, n_v, d)(jnp.asarray(u), jnp.asarray(v), jnp.asarray(ok)))
    assert got.dtype == torch.int64
    assert got.tolist() == want.tolist()
    assert all(got[r] == 0 for r, c in enumerate(cases) if c in ("masked", "pad"))
    assert all(got[r] > 0 for r, c in enumerate(cases) if c in ("hub", "uniform"))


@pytest.mark.parametrize("seed", [0, 1])
def test_count_kernel_impl_matches_jax_through_the_wrapper(seed):
    """The sync CSR fallback's one-pane count routes through the kernel's
    wrapper, whose twin runs here."""
    rng = np.random.default_rng(seed)
    u, v, ok, d = _rows(rng, 1, 512, 160, ["hub" if seed else "uniform"])
    n = int(ok[0].sum())
    cu, cv = u[0, :n], v[0, :n]
    got = ttri._count_kernel_impl(torch.from_numpy(cu), torch.from_numpy(cv), 160, d)
    assert int(got) == int(jtri._count_kernel_impl(jnp.asarray(cu), jnp.asarray(cv), 160, d))


def test_twin_chunks_equal_one_pass(monkeypatch):
    rng = np.random.default_rng(9)
    u, v, ok, d = _rows(rng, 2, 256, 64, ["hub", "uniform"])
    args = (torch.from_numpy(u), torch.from_numpy(v), torch.from_numpy(ok), 64, d)
    whole = ct.csr_triangles_plain(*args)
    monkeypatch.setattr(ct, "TWIN_CHUNK_BYTES", 7 * d * d)  # 7-edge chunks
    assert torch.equal(ct.csr_triangles_plain(*args), whole)


def test_wrapper_checks_and_counts_no_launch_on_cpu():
    before = dict(ct.LAUNCHES)
    u = torch.zeros((2, 4), dtype=torch.int32)
    ok = torch.zeros((2, 4), dtype=torch.bool)
    assert ct.csr_triangles(u, u, ok, 4, 1).tolist() == [0, 0]
    assert ct.LAUNCHES == before
    with pytest.raises(ValueError, match="int32"):
        ct.csr_triangles(u.long(), u, ok, 4, 1)
    with pytest.raises(ValueError, match="shape"):
        ct.csr_triangles(u, u[:1], ok, 4, 1)
    with pytest.raises(ValueError, match="positive"):
        ct.csr_triangles(u, u, ok, 0, 1)


@pytest.mark.parametrize("lo_range,hi_range", [((0, 50), (0, 50)), ((-5, 3), (-7, 9)), ((0, 1 << 40), (0, 1 << 30))])
def test_unique_pairs_equals_the_row_wise_unique(lo_range, hi_range):
    rng = np.random.default_rng(lo_range[1] % 97)
    lo, hi = rng.integers(*lo_range, 3000), rng.integers(*hi_range, 3000)
    got = ttri._unique_pairs(lo, hi)
    np.testing.assert_array_equal(got, np.unique(np.stack([lo, hi], axis=1), axis=0))
    assert ttri._unique_pairs(lo[:0], hi[:0]).shape == (0, 2)
