"""Port parity: windowed GraphSAGE (the serving path) of the PyTorch port
against the JAX package on the CPU.

The JAX package's parameters (``init_params(PRNGKey(s), ...)``) are
carried across by ``interop.sage_params_from_numpy``, bit for bit, so both
packages compute the same layers.  Keys must be equal; embeddings agree
within rtol = atol = 2e-2, the JAX package's own bound between its two
GraphSAGE planes (tests/test_graphsage.py): both round to bf16, in other
places (the JAX kernel rounds the neighbor sum and the count to bf16
before dividing, and each projection and the bias apart; the port
divides in f32 and makes one product of ``[x_self | mean]`` with
``[W_self; W_nbr]``, the bias included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.config import StreamConfig as JConfig
from gelly_streaming_tpu.core.stream import EdgeStream as JStream
from gelly_streaming_tpu.core.types import EdgeDirection as JDir
from gelly_streaming_tpu.library import graphsage as jgs
from gelly_streaming_tpu_torch import interop
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream
from gelly_streaming_tpu_torch.core.types import EdgeDirection as TDir
from gelly_streaming_tpu_torch.library import graphsage as tgs
from gelly_streaming_tpu_torch.ops import sage

TOL = dict(rtol=2e-2, atol=2e-2)


def _params(seed, f_in, f_out):
    """(JAX params, the port's copy of them)."""
    p = jgs.init_params(jax.random.PRNGKey(seed), f_in, f_out)
    return p, interop.sage_params_from_numpy(*(np.asarray(a) for a in p), device="cpu")


def _bits(x) -> np.ndarray:
    return x.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("seed,f_in,f_out", [(0, 128, 128), (3, 16, 8), (7, 5, 3)])
def test_jax_params_round_trip_bit_exactly(seed, f_in, f_out):
    jp, tp = _params(seed, f_in, f_out)
    for a, b in zip(jp, tp):
        assert b.dtype == torch.bfloat16 and b.device.type == "cpu"
        np.testing.assert_array_equal(_bits(b), np.asarray(a).view(np.uint16))
    with pytest.raises(ValueError, match="expected w_self"):
        interop.sage_params_from_numpy(np.zeros((4, 2)), np.zeros((4, 3)), np.zeros(2), device="cpu")


def test_init_params_draws_from_the_generator():
    a = tgs.init_params(16, 8, generator=torch.Generator().manual_seed(5), device="cpu")
    b = tgs.init_params(16, 8, generator=torch.Generator().manual_seed(5), device="cpu")
    c = tgs.init_params(16, 8, generator=torch.Generator().manual_seed(6), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a.w_self, c.w_self)
    assert a.w_self.shape == (16, 8) and a.w_self.dtype == torch.bfloat16 and not a.bias.any()
    assert 0.15 < float(a.w_self.float().std()) < 0.35  # normal / sqrt(16)


@pytest.mark.parametrize("k,d,f", [(64, 1, 128), (100, 8, 128), (7, 300, 16), (30, 8, 6)])
def test_sage_kernel_matches_jax(k, d, f):
    """One bucket, ids -1, C and C + 5 among keys and neighbors (JAX's
    gather: below 0 from the end once, then clamp), rows with no valid
    neighbor among them."""
    rng = np.random.default_rng(k * d)
    c = 40
    jp, tp = _params(k, f, f)
    feats = rng.normal(size=(c, f)).astype(np.float32)
    ids = np.concatenate([rng.integers(0, c, 10), [-1, c, c + 5, -c - 2]])
    keys = rng.choice(ids, k).astype(np.int32)
    nbrs = rng.choice(ids, (k, d)).astype(np.int32)
    valid = rng.random((k, d)) < 0.7
    valid[0] = False
    want = jgs.sage_kernel(jp, jnp.asarray(feats), jnp.asarray(keys), jnp.asarray(nbrs), jnp.asarray(valid))
    got = tgs.sage_kernel(tp, torch.from_numpy(feats), *(torch.from_numpy(a) for a in (keys, nbrs, valid)))
    assert got.dtype == torch.bfloat16 and got.shape == (k, f)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL)


def _random_edges(rng, c, n):
    return [(int(a), int(b)) for a, b in zip(rng.integers(0, c, n), rng.integers(0, c, n))]


def _windows(edges, layers, feats, direction, c, batch=64, window_edges=256):
    """(JAX windows, port windows) of GraphSAGEWindows.run over count panes."""
    kw = dict(vertex_capacity=c, max_degree=64, batch_size=batch, ingest_window_edges=window_edges)
    jl, tl = zip(*layers)
    js = JStream.from_collection(edges, JConfig(**kw), batch_size=batch).slice(1000, getattr(JDir, direction))
    ts = TStream.from_collection(edges, TConfig(**kw), batch_size=batch, device="cpu").slice(
        1000, getattr(TDir, direction))
    jw = list(jgs.GraphSAGEWindows(jl[0] if len(jl) == 1 else list(jl), feats).run(js))
    tw = list(tgs.GraphSAGEWindows(tl[0] if len(tl) == 1 else list(tl), feats, device="cpu").run(ts))
    return jw, tw


def _assert_windows(jw, tw):
    assert len(jw) == len(tw) > 0
    for (jk, je), (tk, te) in zip(jw, tw):
        assert tk.dtype == np.int32 and te.dtype == np.float32
        np.testing.assert_array_equal(tk, jk)
        np.testing.assert_allclose(te, je, **TOL)


@pytest.mark.parametrize("layers,direction", [(1, "OUT"), (1, "IN"), (1, "ALL"), (2, "ALL"), (3, "ALL")])
def test_windows_match_jax(layers, direction):
    rng = np.random.default_rng(layers * 10 + len(direction))
    c, f = 96, 16
    feats = rng.normal(size=(c, f)).astype(np.float32)
    params = [_params(s, f, f) for s in range(layers)]
    _assert_windows(*_windows(_random_edges(rng, c, 700), params, feats, direction, c))


def test_hub_window_matches_jax():
    """A star beside uniform edges: the hub's deep bucket runs too."""
    rng = np.random.default_rng(12)
    c, f = 2048, 32
    edges = [(0, i) for i in range(1, 1500)] + _random_edges(rng, c, 500)
    feats = rng.normal(size=(c, f)).astype(np.float32)
    _assert_windows(*_windows(edges, [_params(1, f, 8)], feats, "ALL", c, batch=512, window_edges=4096))


def test_sage_matches_numpy_reference():
    """The port's layer against a float64 numpy oracle of the grouping and
    the layer (test_graphsage.py's case)."""
    rng = np.random.default_rng(0)
    features = rng.normal(size=(16, 8)).astype(np.float32)
    _, tp = _params(0, 8, 4)
    stream = TStream.from_collection([(1, 2), (1, 3), (2, 3), (3, 4)], TConfig(vertex_capacity=16), device="cpu")
    ((keys, emb),) = list(tgs.GraphSAGEWindows(tp, features, device="cpu").run(stream.slice(1000, TDir.ALL)))
    adj = {1: [2, 3], 2: [1, 3], 3: [1, 2, 4], 4: [3]}
    w_self, w_nbr, bias = (t.double().numpy() for t in tp)
    for i, v in enumerate(keys.tolist()):
        mean = np.mean([features[u] for u in adj[v]], axis=0)
        want = np.maximum(features[v] @ w_self + mean @ w_nbr + bias, 0.0)
        assert (np.abs(emb[i] - want) <= 2e-2 * (1 + np.abs(want))).all()


def test_output_stream_matches_jax():
    rng = np.random.default_rng(4)
    c, f = 64, 8
    feats = rng.normal(size=(c, f)).astype(np.float32)
    jp, tp = _params(2, f, f)
    kw = dict(vertex_capacity=c, batch_size=64)
    edges = _random_edges(rng, c, 200)
    jr = jgs.GraphSAGEWindows(jp, feats).output(JStream.from_collection(edges, JConfig(**kw)).slice(1000, JDir.ALL))
    tr = tgs.GraphSAGEWindows(tp, feats, device="cpu").output(
        TStream.from_collection(edges, TConfig(**kw), device="cpu").slice(1000, TDir.ALL))
    j, t = jr.collect(), tr.collect()
    assert [k for k, _ in t] == [k for k, _ in j]
    np.testing.assert_allclose([n for _, n in t], [n for _, n in j], **TOL)
    # identity self-projection of all-ones features: norm sqrt(8)
    ident = tgs.SageParams(torch.eye(8, dtype=torch.bfloat16), torch.zeros(8, 8, dtype=torch.bfloat16),
                           torch.zeros(8, dtype=torch.bfloat16))
    stream = TStream.from_collection([(1, 2), (2, 3)], TConfig(vertex_capacity=16), device="cpu")
    recs = dict(tgs.GraphSAGEWindows(ident, np.ones((16, 8), np.float32), device="cpu")
                .output(stream.slice(1000, TDir.ALL)).collect())
    assert set(recs) == {1, 2, 3} and all(abs(n - np.sqrt(8.0)) < 1e-2 for n in recs.values())


@pytest.mark.parametrize("layers", [1, 2])
def test_out_of_range_ids_follow_jax(layers):
    """Ids -1, C and C + 5 through from_collection: the key of a source
    below 0 is 0 and the gathers clamp.  One layer takes all of them; two
    layers take -1 beside 0 (key 0 twice in a window: the last row wins in
    the hidden buffer, as numpy's assignment leaves it), and both packages
    raise IndexError on a key past the table."""
    c, f = 16, 8
    rng = np.random.default_rng(layers)
    feats = rng.normal(size=(c, f)).astype(np.float32)
    params = [_params(s, f, f) for s in range(layers)]
    edges = [(-1, 3), (0, 2), (2, -1), (3, 0), (5, 6), (-1, 5), (c, 2), (c + 5, -1), (3, c)]
    if layers == 1:
        _assert_windows(*_windows(edges, params, feats, "ALL", c, batch=4, window_edges=8))
        return
    ok = [e for e in edges if max(e) < c]
    _assert_windows(*_windows(ok, params, feats, "ALL", c, batch=4, window_edges=8))
    with pytest.raises(IndexError):
        _windows(edges, params, feats, "ALL", c, batch=4, window_edges=8)


def test_refusals(monkeypatch):
    _, tp = _params(0, 4, 4)
    feats = np.zeros((8, 4), np.float32)
    stream = TStream.from_collection([(1, 2)], TConfig(vertex_capacity=8), device="cpu")
    with pytest.raises(ValueError, match="require slice"):
        list(tgs.GraphSAGEWindows([tp, tp], feats, device="cpu").run(stream.slice(1000, TDir.OUT)))
    with pytest.raises(TypeError, match="SageParams"):
        tgs.GraphSAGEWindows([], feats, device="cpu")
    with pytest.raises(TypeError, match="SageParams"):
        tgs.GraphSAGEWindows([tp, (1, 2)], feats, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        tgs.sage_kernel_ring(tp, None, None, None, None, 2)
    sharded = TStream.from_collection([(1, 2)], TConfig(vertex_capacity=8, num_shards=2), device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="item 8"):
        list(tgs.GraphSAGEWindows(tp, feats, device="cpu").run(sharded.slice(1000, TDir.ALL)))
    if not torch.cuda.is_available():  # the default device is cuda
        with pytest.raises(RuntimeError, match="CUDA"):
            tgs.GraphSAGEWindows(tp, feats)
        with pytest.raises(RuntimeError, match="CUDA"):
            tgs.init_params(4, 4, generator=torch.Generator())


def test_gather_mean_twin_on_the_cpu_launches_nothing_and_checks_inputs():
    """sage_layer on CPU tensors: its twin, no launch.  With W = I (F_out =
    2 F_in) and a zero bias the rows are the gathered [x_self | mean]."""
    sage.reset_launches()
    table = torch.arange(12, dtype=torch.float32).view(4, 3).to(torch.bfloat16)
    keys = torch.tensor([-1, 4], dtype=torch.int32)
    nbrs = torch.tensor([[0, 1], [-5, 9]], dtype=torch.int32)
    valid = torch.tensor([[True, True], [True, False]])
    w = torch.eye(6, dtype=torch.bfloat16)
    bias = torch.zeros(6, dtype=torch.bfloat16)
    out = sage.sage_layer(table, keys, nbrs, valid, w, bias)
    assert sage.LAUNCHES["sage_layer"] == 0
    want = [[9, 10, 11, 1.5, 2.5, 3.5], [9, 10, 11, 0, 1, 2]]
    assert out.float().tolist() == want
    buf = torch.full((5, 6), -1.0, dtype=torch.bfloat16)
    rows = sage.sage_layer(table, keys, nbrs, valid, w, bias, out=buf, row0=2)
    assert rows.data_ptr() == buf[2].data_ptr() and buf[2:4].float().tolist() == want
    assert (buf[:2] == -1).all() and (buf[4] == -1).all()
    assert sage.LAUNCHES["sage_layer"] == 0
    with pytest.raises(ValueError, match="table must be"):
        sage.sage_layer(table.float(), keys, nbrs, valid, w, bias)
    with pytest.raises(ValueError, match="valid must be"):
        sage.sage_layer(table, keys, nbrs, valid[:, :1].contiguous(), w, bias)
    with pytest.raises(ValueError, match="w must be"):
        sage.sage_layer(table, keys, nbrs, valid, w[:5].contiguous(), bias)
    with pytest.raises(ValueError, match="bias must be"):
        sage.sage_layer(table, keys, nbrs, valid, w, bias[:5].contiguous())
    with pytest.raises(ValueError, match="do not fit"):
        sage.sage_layer(table, keys, nbrs, valid, w, bias, out=buf, row0=4)
    with pytest.raises(ValueError, match="needs an out"):
        sage.sage_layer(table, keys, nbrs, valid, w, bias, row0=1)


@pytest.mark.parametrize("f_in,f_out,k,d", [(12, 20, 50, 4), (128, 128, 64, 8), (128, 128, 3, 300)])
def test_sage_layer_plain_matches_jax(f_in, f_out, k, d):
    """The layer's twin against the JAX sage_kernel at an odd width (the
    kernel's CUDA-core instantiation) and at the repo's width (its
    tensor-core one), rows longer than one 256-slot chunk among them."""
    rng = np.random.default_rng(f_in * f_out + d)
    c = 300
    jp, tp = _params(f_in + d, f_in, f_out)
    feats = rng.normal(size=(c, f_in)).astype(np.float32)
    keys = rng.integers(-c - 2, c + 2, k).astype(np.int32)
    nbrs = rng.integers(-c - 2, c + 2, (k, d)).astype(np.int32)
    valid = rng.random((k, d)) < 0.7
    valid[0] = False
    want = jgs.sage_kernel(jp, jnp.asarray(feats), jnp.asarray(keys), jnp.asarray(nbrs), jnp.asarray(valid))
    table = torch.from_numpy(feats).to(torch.bfloat16)
    w = torch.cat([tp.w_self, tp.w_nbr], 0)
    got = sage.sage_layer_plain(table, *(torch.from_numpy(a) for a in (keys, nbrs, valid)), w, tp.bias)
    assert got.dtype == torch.bfloat16 and got.shape == (k, f_out)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL)
