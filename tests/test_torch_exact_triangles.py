"""Port parity: the streaming exact triangle count of the PyTorch port
(``ExactTriangleCount``, ``ops/exact_triangles``) against the JAX package
on the CPU.

The JAX functions run jitted; the port runs its kernels' plain twins
(device="cpu").  Inputs come from numpy seeds and are handed to both:
duplicates, self-loops, masked rows, ids below 0 and at or past C, rows
that overflow (D = 4) and chunks that do not divide the batch.  States,
traces, records and block columns (values and dtypes) must be equal
exactly.  Negative ids never alias a positive id of the same stream (-1
and C - 1 in one batch would write one slot twice, in an order JAX leaves
unspecified).  The CUDA kernels are held against the same twins on the GPU
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.examples import exact_triangle_count as j_example
from gelly_streaming_tpu.library import triangles as jtri
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.examples import exact_triangle_count as t_example
from gelly_streaming_tpu_torch.library import triangles as ttri
from gelly_streaming_tpu_torch.ops import exact_triangles as et

CPU = "cpu"
_j_trace = jax.jit(jtri.triangle_update)
_j_block = jax.jit(jtri.triangle_update_block, static_argnames="chunk")


def _batch(rng, b: int, c: int, hub: bool = True):
    """One batch over [0, C - 2) with a hub, duplicates, self-loops, a
    masked tenth, and ids -1, -2, C and C + 3."""
    src = rng.integers(0, c - 2, b).astype(np.int32)
    dst = rng.integers(0, c - 2, b).astype(np.int32)
    if hub:
        src[: b // 3] = 1  # a hub whose row overflows at D = 4
    dst[b // 2 : b // 2 + 3] = src[b // 2 : b // 2 + 3]  # self-loops
    src[-6:], dst[-6:] = src[:6], dst[:6]  # duplicates
    src[3], dst[7], src[9], dst[11] = -1, -2, c, c + 3
    mask = rng.random(b) < 0.9
    return src, dst, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j_state_arrays(s):
    return [np.asarray(x) for x in (*s.table, s.local, s.global_count)]


def _t_state_arrays(s):
    return [x.numpy() for x in (*s.table, s.local, s.global_count)]


def _assert_states(j, t):
    names = ("nbrs", "deg", "dropped", "local", "global_count")
    for name, a, b in zip(names, _j_state_arrays(j), _t_state_arrays(t)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _states(c: int, d: int):
    return jtri.init_triangle_state(JConfig(vertex_capacity=c, max_degree=d)), ttri.init_triangle_state(
        TConfig(vertex_capacity=c, max_degree=d), CPU)


@pytest.mark.parametrize("d", [4, 32])
def test_triangle_update_matches_jax(d):
    rng = np.random.default_rng(d)
    c = 48
    js, ts = _states(c, d)
    for b in (40, 57, 33):
        s, t, m = _batch(rng, b, c)
        js, jl, jg = _j_trace(js, s, t, m)
        ts, tl, tg = et.triangle_update(ts, _t(s), _t(t), _t(m))
        _assert_states(js, ts)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
    assert int(ts.global_count) > 0
    assert (int(ts.table.dropped) > 0) == (d == 4)  # the hub's row overflows at D = 4


@pytest.mark.parametrize("d", [4, 32])
@pytest.mark.parametrize("chunk", [1, 16, 64, 128])
def test_triangle_update_block_matches_jax(d, chunk):
    rng = np.random.default_rng(100 * d + chunk)
    c = 48
    js, ts = _states(c, d)
    for b in (100, 77, 150):  # none a multiple of 16, 64 or 128
        s, t, m = _batch(rng, b, c)
        js = _j_block(js, s, t, m, chunk=chunk)
        ts = et.triangle_update_block(ts, _t(s), _t(t), _t(m), chunk=chunk)
        _assert_states(js, ts)
    assert int(ts.global_count) > 0 and int(ts.table.dropped) > 0  # the hub's row overflows


def test_wrappers_update_in_place_and_launch_nothing_on_cpu():
    rng = np.random.default_rng(5)
    _, ts = _states(20, 8)
    s, t, m = _batch(rng, 30, 20, hub=False)
    et.reset_launches()
    want = et.triangle_update_block_plain(ts, _t(s), _t(t), _t(m))
    local = ts.local
    got = et.triangle_update_block(ts, _t(s), _t(t), _t(m))
    assert got is ts and got.local is local and torch.equal(local, want.local)
    assert et.LAUNCHES == {"triangle_block": 0, "triangle_trace": 0}
    assert et.TWIN_CALLS == {"triangle_block": 1, "triangle_trace": 0}
    with pytest.raises(ValueError):
        et.triangle_update_block(ts, _t(s), _t(t)[:-1], _t(m))


# ---------------------------------------------------------------------------
# ExactTriangleCount


def _same_blocks(jb, tb):
    assert len(jb) == len(tb)
    for a, b in zip(jb, tb):
        assert len(a.columns) == len(b.columns) == 2
        for x, y in zip(a.columns, b.columns):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def _edges(seed: int, n: int, c: int):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, c, n)
    t = rng.integers(0, c, n)
    s[:8] = 2  # a hub
    s[-5:], t[-5:] = s[:5], t[:5]
    t[10:12] = s[10:12]
    return s, t


@pytest.mark.parametrize("source", ["collection", "arrays"])
@pytest.mark.parametrize("d", [4, 64])
def test_exact_triangle_count_matches_jax(source, d):
    c, bs = 40, 23
    s, t = _edges(d, 130, c)
    jcfg = JConfig(vertex_capacity=c, max_degree=d, batch_size=bs)
    tcfg = TConfig(vertex_capacity=c, max_degree=d, batch_size=bs)
    if source == "collection":
        edges = list(zip(s.tolist(), t.tolist()))
        j = JStream.from_collection(edges, jcfg, batch_size=bs)
        tt = TStream.from_collection(edges, tcfg, batch_size=bs, device=CPU)
    else:
        j = JStream.from_arrays(s, t, jcfg)
        tt = TStream.from_arrays(s, t, tcfg, device=CPU)
    for mode in ("block", "trace"):
        jr, tr = jtri.ExactTriangleCount(mode=mode), ttri.ExactTriangleCount(mode=mode)
        if mode == "block":
            _same_blocks(list(jr.run(j).blocks()), list(tr.run(tt).blocks()))
        else:
            want = jr.run(j).collect()
            assert tr.run(tt).collect() == want
            assert all(type(x) is int for rec in want[:6] for x in rec)
        _assert_states(jr.final_state, tr.final_state)


def test_exact_triangle_count_out_of_range_ids():
    """Ids -1 and -2 read the last counters in block mode; an id at C
    raises IndexError there after the earlier blocks, as numpy indexing
    does in the JAX package; trace mode clamps and emits."""
    c = 20
    ok_edges = [(1, 2), (2, 3), (1, 3), (-1, 3), (3, -2), (-1, -2), (1, -1), (4, 4), (2, 1)]
    bad_edges = ok_edges + [(5, c), (c + 2, 3)]
    for edges in (ok_edges, bad_edges):
        j = JStream.from_collection(edges, JConfig(vertex_capacity=c, max_degree=4), batch_size=4)
        tt = TStream.from_collection(edges, TConfig(vertex_capacity=c, max_degree=4), batch_size=4, device=CPU)
        want = jtri.ExactTriangleCount(mode="trace").run(j).collect()
        assert ttri.ExactTriangleCount(mode="trace").run(tt).collect() == want
        if edges is ok_edges:
            _same_blocks(list(jtri.ExactTriangleCount().run(j).blocks()),
                         list(ttri.ExactTriangleCount().run(tt).blocks()))
            continue
        jb, tb = [], []
        with pytest.raises(IndexError):
            for blk in jtri.ExactTriangleCount().run(j).blocks():
                jb.append(blk)
        with pytest.raises(IndexError):
            for blk in ttri.ExactTriangleCount().run(tt).blocks():
                tb.append(blk)
        assert len(jb) == 2
        _same_blocks(jb, tb)


def test_example_cli_matches_jax(tmp_path):
    j_out, t_out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(j_out):
        j_example.main([])
    with contextlib.redirect_stdout(t_out):
        t_example.main(["--device=cpu"])
    j_lines, t_lines = j_out.getvalue().splitlines(), t_out.getvalue().splitlines()
    # the usage line names the port's --device flag; every record is equal
    assert t_lines[3:] == j_lines[3:] and len(t_lines) > 100
    assert t_lines[-1].startswith("-1,")
    # the file path and CSV sink
    edges = tmp_path / "edges.txt"
    edges.write_text("1 2\n2 3\n3 1\n3 4\n4 1\n2 4\n")
    j_csv, t_csv = tmp_path / "j.csv", tmp_path / "t.csv"
    j_example.main([str(edges), str(j_csv)])
    t_example.main(["--device=cpu", str(edges), str(t_csv)])
    assert t_csv.read_text() == j_csv.read_text()
    assert t_csv.read_text().splitlines()[-1] == "-1,4"


@pytest.mark.parametrize("mode", ["block", "trace"])
def test_mid_stream_state_carried_from_jax(mode):
    """Both packages fold two more batches from the JAX package's state
    after three, carried across by interop.triangle_state_from_numpy."""
    rng = np.random.default_rng(11)
    c, d = 40, 6
    js, _ = _states(c, d)
    for _ in range(3):
        js = _j_block(js, *_batch(rng, 50, c), chunk=64)
    ts = interop.triangle_state_from_numpy(*_j_state_arrays(js), device=CPU)
    _assert_states(js, ts)
    for _ in range(2):
        s, t, m = _batch(rng, 45, c)
        if mode == "block":
            js = _j_block(js, s, t, m, chunk=64)
            ts = et.triangle_update_block(ts, _t(s), _t(t), _t(m))
        else:
            js, jl, _ = _j_trace(js, s, t, m)
            ts, tl, _ = et.triangle_update(ts, _t(s), _t(t), _t(m))
            np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        _assert_states(js, ts)
    with pytest.raises(ValueError):
        interop.triangle_state_from_numpy(*_j_state_arrays(js)[:3], np.zeros(c + 1), 0, device=CPU)
