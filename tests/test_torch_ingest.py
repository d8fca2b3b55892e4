"""Port parity: the parallel host ingest of the PyTorch port against the
JAX package.

The port's parsers (native serial, native byte ranges across the ingest
pool, and the numpy fallback without the native library) must return the
JAX package's arrays for every column shape; its packers (native and numpy)
the JAX package's bytes at every width, row by row into superbatch arenas
too.  Tolerance: none.
"""

import numpy as np
import pytest

from gelly_streaming_tpu.io import ingest as jingest
from gelly_streaming_tpu.io import sources as jsources
from gelly_streaming_tpu.io import wire as jw
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.io import ingest as tingest
from gelly_streaming_tpu_torch.io import sources as tsources
from gelly_streaming_tpu_torch.io import wire as tw
from gelly_streaming_tpu_torch.parallel import routing as trouting
from gelly_streaming_tpu_torch.utils import native

# the pool's threads
pytestmark = pytest.mark.timeout_cap(120)


def _write(tmp_path, name, lines, trailing=True):
    path = tmp_path / name
    path.write_text("\n".join(lines) + ("\n" if trailing else ""))
    return str(path)


@pytest.fixture(params=["native", "numpy"])
def lib_mode(request, monkeypatch):
    """Run a test with the port's native library, then without it."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "load_ingest_lib", lambda: None)
    else:
        assert native.load_ingest_lib() is not None, "the host C++ compiler must build csrc/edge_parser.cpp here"
    return request.param


def _assert_same_parse(path):
    want = jsources.parse_edge_file(path, workers=1)
    for got in (tsources.parse_edge_file(path, workers=1), tingest.parse_edge_file_parallel(path, workers=4)):
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_parallel_parse_matches_jax_all_column_shapes(tmp_path, lib_mode):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 500, (1500, 2))
    cases = {
        "plain.txt": [f"{s} {d}" for s, d in ids],
        "valued.txt": [f"{s},{d},{(s + d) / 7:.5f}" for s, d in ids],
        "timed.txt": [f"{s}\t{d}\t{s % 3}.5\t{i}" for i, (s, d) in enumerate(ids)],
        "signed.txt": [f"{s} {d} {'+' if i % 3 else '-'}" for i, (s, d) in enumerate(ids)],
    }
    for name, lines in cases.items():
        salted = ["# header", ""]
        for i, ln in enumerate(lines):
            salted.append(ln)
            if i % 500 == 0:
                salted.append("% interleaved comment")
        _assert_same_parse(_write(tmp_path, name, salted))


def test_parallel_parse_edge_cases(tmp_path, lib_mode):
    _assert_same_parse(_write(tmp_path, "notrail.txt", ["1 2", "3 4", "5 6"], trailing=False))
    _assert_same_parse(_write(tmp_path, "tiny.txt", ["7 8"]))
    src, dst, val, tim, sign = tingest.parse_edge_file_parallel(
        _write(tmp_path, "comments.txt", ["# a", "% b"]), workers=4
    )
    assert len(src) == 0 and val is None and tim is None and sign is None


@pytest.mark.parametrize("lines", [
    [f"{i} {i + 1}" for i in range(997)],
    ["1 2", "# " + "x" * (70 << 10), "3 4", "5 6", "# " + "x" * (70 << 10), "7 8"],
], ids=["short", "past-the-reader-buffer"])
def test_parallel_parse_range_boundaries_partition_lines(tmp_path, monkeypatch, lines):
    """Many ranges over a small file (boundaries inside lines longer than
    the native reader's 64 KB buffer too): every line parsed once."""
    path = _write(tmp_path, "bounds.txt", lines)
    want = jsources.parse_edge_file(path, workers=1)
    monkeypatch.setattr(tingest, "MIN_RANGE_BYTES", 64)
    got = tingest.parse_edge_file_parallel(path, workers=16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


WIDTHS = [2, 3, 4, tw.PAIR40, (tw.EF40, 1 << 12)]


@pytest.mark.parametrize("width", WIDTHS, ids=["2", "3", "4", "pair40", "ef40"])
def test_pack_rows_into_gives_jax_bytes(width, lib_mode):
    rng = np.random.default_rng(1)
    batch, groups = 512, 5
    hi = 1 << 12 if isinstance(width, tuple) else (1 << 15 if width == 2 else 1 << 19)
    src = rng.integers(0, hi, batch * groups).astype(np.int32)
    dst = rng.integers(0, hi, batch * groups).astype(np.int32)
    arena = np.empty((groups, tw.wire_nbytes(batch, width)), np.uint8)
    tingest.pack_rows_into(src, dst, 0, groups, batch, width, arena, workers=4)
    binned = np.empty_like(arena)
    tingest.pack_binned_rows_into(src, dst, 0, groups, batch, width, hi, binned, workers=4)
    j_binned = np.empty_like(arena)
    jingest.pack_binned_rows_into(src, dst, 0, groups, batch, width, hi, j_binned, workers=4)
    np.testing.assert_array_equal(binned, j_binned)
    for j in range(groups):
        s, d = src[j * batch : (j + 1) * batch], dst[j * batch : (j + 1) * batch]
        want = jw.pack_edges(s, d, width)
        np.testing.assert_array_equal(arena[j], want)
        np.testing.assert_array_equal(tw.pack_edges(s, d, width), want)
        row = np.empty(want.nbytes, np.uint8)
        tw.pack_edges_into(s, d, width, row)
        np.testing.assert_array_equal(row, want)


def test_bdv_group_and_parallel_pack_stream_give_jax_bytes(lib_mode):
    rng = np.random.default_rng(2)
    src = rng.integers(0, 4096, 10_000).astype(np.int32)
    dst = (4096 * rng.random(10_000) ** 3).astype(np.int32)
    for width in (3, (tw.EF40, 4096), (tw.BDV, 4096)):
        want, want_tail = jw.pack_stream(src, dst, 1024, width)
        got, tail = tw.pack_stream(src, dst, 1024, width)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tail[0], want_tail[0])
        if not (isinstance(width, tuple) and width[0] == tw.BDV):
            par, par_tail = tingest.parallel_pack_stream(src, dst, 1024, width, workers=4)
            for a, b in zip(par, want):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(par_tail[1], want_tail[1])
    np.testing.assert_array_equal(tingest.pack_bdv_group(src, dst, 1, 4, 1024, 4096, 4),
                                  jingest.pack_bdv_group(src, dst, 1, 4, 1024, 4096, 4))


def test_native_calls_are_counted():
    if native.load_ingest_lib() is None:
        pytest.fail("the host C++ compiler must build csrc/edge_parser.cpp here")
    native.reset_calls()
    src = np.arange(64, dtype=np.int32)
    tw.pack_edges_bdv(src, src[::-1].copy(), 64)
    tw.pack_edges(src, src, 2)
    assert native.CALLS["sort_edges_dst_src"] == 1
    assert native.CALLS["encode_edges_bdv"] == 1
    assert native.CALLS["pack_edges"] == 1


def test_pack_edges_into_rejects_bad_buffer():
    src = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError):
        tw.pack_edges_into(src, src, 2, np.empty(3, np.uint8))
    with pytest.raises(ValueError, match="variable-size"):
        tw.pack_edges_into(src, src, (tw.BDV, 64), np.zeros(64, np.uint8))


def test_resolve_workers_env(monkeypatch):
    assert tingest.resolve_workers(3) == 3
    monkeypatch.setenv("GELLY_INGEST_WORKERS", "5")
    assert tingest.resolve_workers(0) == jingest.resolve_workers(0) == 5
    monkeypatch.delenv("GELLY_INGEST_WORKERS")
    assert tingest.resolve_workers(0) == jingest.resolve_workers(0) >= 1
    with pytest.raises(ValueError, match="ingest_workers"):
        TConfig(ingest_workers=-1)


def test_file_stream_parses_in_parallel_by_default(tmp_path, monkeypatch):
    lines = [f"{i % 50} {(i * 7) % 50}" for i in range(2000)]
    path = _write(tmp_path, "stream.txt", lines)
    calls = []
    real = tingest.parse_edge_file_parallel
    monkeypatch.setattr(tingest, "parse_edge_file_parallel", lambda p, w: calls.append(w) or real(p, w))
    stream, _ = tsources.file_stream(path, TConfig(vertex_capacity=64, batch_size=256), device="cpu")
    assert calls == [0]
    assert stream.collect_edges() == [(i % 50, (i * 7) % 50) for i in range(2000)]


@pytest.mark.parametrize("n,shards,key", [(0, 2, "src"), (100, 3, "dst"), (1 << 15, 4, "src")])
def test_parallel_host_route_matches_jax(n, shards, key, lib_mode):
    from gelly_streaming_tpu.parallel import routing

    rng = np.random.default_rng(7)
    src = rng.integers(0, 4096, n).astype(np.int32)
    dst = ((4096 * rng.random(n) ** 3).astype(np.int64) % 4096).astype(np.int32)
    want = routing.host_route(src, dst, shards, key=key)
    for got in (trouting.host_route(src, dst, shards, key=key),
                tingest.parallel_host_route(src, dst, shards, key=key, workers=2)):
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
    # skewed panes keep pow2 bin-arena capacities
    par = tingest.parallel_host_route(src, dst, shards, key="dst", workers=2)
    assert par.src.shape[1] & (par.src.shape[1] - 1) == 0
