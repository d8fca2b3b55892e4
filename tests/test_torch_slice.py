"""Port parity: slice() and the three neighborhood aggregations of the
PyTorch port against the JAX package on the CPU.

The goldens of TestSlice.java (:40-201), all nine combinations of {fold,
reduce, apply} x {OUT, IN, ALL}, through the port's device mode (the user
functions written with torch ops, as the JAX package's are with jnp) and
host mode; every record must equal the JAX package's.  Then random
streams, sliding and count-cut windows, tuple accumulators, the refusals,
and the paths that are not ported yet.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import LONG_LONG_EDGES
from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.core.types import EdgeDirection as JDir
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.core.types import EdgeDirection as TDir

FOLD_OUT = "1,25\n2,23\n3,69\n4,45\n5,51"
FOLD_IN = "1,51\n2,12\n3,36\n4,34\n5,80"
FOLD_ALL = "1,76\n2,35\n3,105\n4,79\n5,131"
APPLY_OUT = "1,small\n2,small\n3,big\n4,small\n5,big"
APPLY_IN = "1,big\n2,small\n3,small\n4,small\n5,big"
APPLY_ALL = "1,big\n2,small\n3,big\n4,big\n5,big"
GOLDENS = {
    "fold": {"OUT": FOLD_OUT, "IN": FOLD_IN, "ALL": FOLD_ALL},
    "reduce": {"OUT": FOLD_OUT, "IN": FOLD_IN, "ALL": FOLD_ALL},
    "apply": {"OUT": APPLY_OUT, "IN": APPLY_IN, "ALL": APPLY_ALL},
}
DIRECTIONS = ["OUT", "IN", "ALL"]
KW = dict(vertex_capacity=16, max_degree=16, batch_size=4)


def _fold(accum, vid, nbr, val):
    # SumEdgeValues (TestSlice.java:206-214): accum = (vertex id, sum + val)
    return (vid, accum[1] + val)


def _reduce(a, b):
    return a + b


def _japply(vid, nbrs, vals, valid):
    return (vid, jnp.sum(jnp.where(valid, vals, 0)) > 50)


def _tapply(vid, nbrs, vals, valid):
    # SumEdgeValuesApply (TestSlice.java:221-238): sum > 50 -> "big" else "small"
    return (vid, torch.sum(torch.where(valid, vals, 0)) > 50)


def _post(rec):
    vid, big = rec
    return (vid, "big" if big else "small")


def _streams(edges=LONG_LONG_EDGES, batch=None, with_time=False, **kw):
    """The same collection as a JAX and a port stream (port on the CPU),
    in batches of ``batch`` edges; ``kw`` are config fields."""
    cfg = {**KW, **kw}
    j = JStream.from_collection(edges, JConfig(**cfg), batch_size=batch, with_time=with_time)
    t = TStream.from_collection(edges, TConfig(**cfg), batch_size=batch, with_time=with_time, device="cpu")
    return j, t


def _aggregate(snap, kind, package, mode="device"):
    if kind == "fold":
        return snap.fold_neighbors((0, 0), _fold, mode=mode)
    if kind == "reduce":
        return snap.reduce_on_edges(_reduce, mode=mode)
    if mode == "host":
        fn = lambda vid, nbrs: (vid, sum(v for _, v in nbrs) > 50)  # noqa: E731
    else:
        fn = _japply if package == "jax" else _tapply
    return snap.apply_on_neighbors(fn, post=_post, mode=mode)


def _records(kind, direction, mode, **stream_kw):
    j, t = _streams(**stream_kw)
    jo = _aggregate(j.slice(1000, getattr(JDir, direction)), kind, "jax", mode)
    to = _aggregate(t.slice(1000, getattr(TDir, direction)), kind, "torch", mode)
    return jo, to


@pytest.mark.parametrize("mode", ["device", "host"])
@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("kind", ["fold", "reduce", "apply"])
def test_goldens_match_jax(kind, direction, mode):
    jo, to = _records(kind, direction, mode)
    jr, tr = jo.collect(), to.collect()
    assert tr == jr
    want = sorted(line for line in GOLDENS[kind][direction].split("\n"))
    assert sorted(to.lines()) == want


@pytest.mark.parametrize("kind", ["fold", "reduce", "apply"])
def test_multi_batch_single_window_and_sharded_config(kind):
    """Untimed finite streams form one pane whatever the batching; a
    num_shards config with fewer GPUs takes the single-device path (the
    JAX package runs its 8-device CPU mesh there: the same records)."""
    jo, to = _records(kind, "OUT", "device", batch=2)
    assert to.collect() == jo.collect()
    jo, to = _records(kind, "ALL", "device", num_shards=8)
    assert sorted(to.lines()) == sorted(jo.lines())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_random_streams_match_jax(seed, direction):
    """Fold, reduce and apply over random streams cut into count panes."""
    rng = np.random.default_rng(seed)
    cap, n = 32, int(rng.integers(20, 160))
    edges = [(int(a), int(b), int(a) * 100 + int(b)) for a, b in zip(rng.integers(0, cap, n), rng.integers(0, cap, n))]
    kw = dict(vertex_capacity=cap, max_degree=32, batch_size=8, ingest_window_edges=48)
    j, t = _streams(edges, batch=8, **kw)
    js, ts = j.slice(1000, getattr(JDir, direction)), t.slice(1000, getattr(TDir, direction))
    for kind in ("fold", "reduce", "apply"):
        assert _aggregate(ts, kind, "torch").collect() == _aggregate(js, kind, "jax").collect(), kind
    j_max = js.reduce_on_edges(lambda a, b: jnp.maximum(a, b)).collect()
    assert ts.reduce_on_edges(lambda a, b: torch.maximum(a, b)).collect() == j_max


def test_sliding_windows_match_jax():
    """Event-time sliding windows (pane-shared) through slice()."""
    rng = np.random.default_rng(4)
    n = 120
    times = np.sort(rng.integers(0, 4000, n))
    edges = [(int(a), int(b), int(v), int(ts)) for a, b, v, ts in
             zip(rng.integers(0, 16, n), rng.integers(0, 16, n), rng.integers(0, 9, n), times)]
    j, t = _streams(edges, batch=16, with_time=True)
    jr = j.slice(1000, JDir.ALL, slide_ms=500).fold_neighbors((0, 0), _fold).collect()
    tr = t.slice(1000, TDir.ALL, slide_ms=500).fold_neighbors((0, 0), _fold).collect()
    assert tr == jr and len(jr) > 16


def test_tuple_accumulators_keep_their_arity_in_both_modes():
    """Float tuple accumulators: device and host records equal the JAX
    package's, two fields each."""
    j, t = _streams()

    def fold(acc, vid, nbr, val):
        return (acc[0] + val, acc[1] + 1)

    jr = j.slice(1000, JDir.OUT).fold_neighbors((jnp.float32(0), jnp.float32(0)), fold).collect()
    tr = t.slice(1000, TDir.OUT).fold_neighbors((torch.tensor(0.0), torch.tensor(0.0)), fold).collect()
    host = t.slice(1000, TDir.OUT).fold_neighbors((0.0, 0.0), fold, mode="host").collect()
    assert tr == jr
    assert sorted(map(lambda r: tuple(map(float, r)), host)) == sorted(map(lambda r: tuple(map(float, r)), jr))
    assert all(len(r) == 2 for r in tr)


def test_host_modes_string_building_and_list_accumulators():
    """Plain-Python host functions (EdgesFold.java:47, EdgesReduce.java:43,
    EdgesApply.java:47): strings, lists, 0..n records per vertex."""
    j, t = _streams()

    def strs(snap):
        return sorted(r[0] for r in snap.fold_neighbors(
            "", lambda acc, vid, nbr, val: acc + f"[{vid}->{nbr}:{val:g}]", mode="host"))

    assert strs(t.slice(1000, TDir.OUT)) == strs(j.slice(1000, JDir.OUT)) == [
        "[1->2:12][1->3:13]", "[2->3:23]", "[3->4:34][3->5:35]", "[4->5:45]", "[5->1:51]"]
    lists = t.slice(1000, TDir.OUT).fold_neighbors([], lambda acc, vid, nbr, val: acc + [nbr], mode="host")
    assert sorted(r[0] for r in lists) == [[1], [2, 3], [3], [4, 5], [5]]
    cfg = dict(vertex_capacity=16, batch_size=8)
    src, dst = np.array([1, 1, 2], np.int32), np.array([2, 3, 3], np.int32)

    def wedges(vid, neighbors):
        assert all(v is None for _, v in neighbors)
        ids = [nb for nb, _ in neighbors]
        return [(vid, a, b) for a in ids for b in ids if a < b]

    jw = list(JStream.from_arrays(src, dst, JConfig(**cfg)).slice(1000, JDir.OUT).apply_on_neighbors(wedges, mode="host"))
    tw = list(TStream.from_arrays(src, dst, TConfig(**cfg), device="cpu").slice(1000, TDir.OUT)
              .apply_on_neighbors(wedges, mode="host"))
    assert tw == jw == [(1, 2, 3)]


def test_valueless_device_fold_matches_jax():
    """A value-less stream: the fold function sees no value (None)."""
    src, dst = np.array([1, 1, 2, 3, 3, 3], np.int32), np.array([2, 3, 3, 1, 2, 4], np.int32)
    cfg = dict(vertex_capacity=16, batch_size=8)

    def count(acc, vid, nbr, val):
        assert val is None
        return (vid, acc[1] + 1)

    jr = JStream.from_arrays(src, dst, JConfig(**cfg)).slice(1000, JDir.ALL).fold_neighbors((0, 0), count).collect()
    tr = (TStream.from_arrays(src, dst, TConfig(**cfg), device="cpu").slice(1000, TDir.ALL)
          .fold_neighbors((0, 0), count).collect())
    assert tr == jr and sorted(tr) == [(1, 3), (2, 3), (3, 5), (4, 1)]


def test_refusals():
    _, t = _streams()
    snap = t.slice(1000, TDir.OUT)
    with pytest.raises(ValueError, match="unknown fold_neighbors mode"):
        snap.fold_neighbors("", lambda *a: "", mode="python")
    with pytest.raises(ValueError, match="unknown reduce_on_edges mode"):
        snap.reduce_on_edges(_reduce, mode="python")
    with pytest.raises(ValueError, match="unknown apply_on_neighbors mode"):
        snap.apply_on_neighbors(_tapply, mode="python")
    with pytest.raises(ValueError, match="slide_ms"):
        t.slice(1000, TDir.OUT, slide_ms=300)
    valueless = TStream.from_arrays(np.array([1], np.int32), np.array([2], np.int32),
                                    TConfig(vertex_capacity=4), device="cpu")
    with pytest.raises(ValueError, match="requires edge values"):
        valueless.slice(1000, TDir.OUT).reduce_on_edges(_reduce).collect()
    with pytest.raises(ValueError, match="requires edge values"):
        valueless.slice(1000, TDir.OUT).reduce_on_edges(_reduce, mode="host").collect()


def test_unported_planes_raise(monkeypatch):
    """The asynchronous window pipeline is ported (it emits the JAX
    package's records); the sharded plane (A.8) raises
    NotImplementedError where the JAX package would take it."""
    j, t = _streams(async_windows=2)
    got = [(int(k), float(v)) for k, v in t.slice(1000, TDir.OUT).reduce_on_edges(_reduce).collect()]
    assert got == [(int(k), float(v)) for k, v in j.slice(1000, JDir.OUT).reduce_on_edges(_reduce).collect()]
    assert len(got) == 5
    _, t = _streams(num_shards=2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 8"):
        t.slice(1000, TDir.OUT).reduce_on_edges(_reduce).collect()


def test_slice_defaults_to_the_window_and_streams_to_cuda():
    """slice() takes the config's window; a stream made without a device
    asks for CUDA and raises where there is none."""
    _, t = _streams(window_ms=250)
    snap = t.slice(direction=TDir.IN)
    assert (snap.window_ms, snap.direction, snap.slide_ms) == (250, TDir.IN, None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TStream.from_collection(LONG_LONG_EDGES, TConfig(**KW))
