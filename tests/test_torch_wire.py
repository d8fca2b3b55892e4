"""Port parity: the wire format of the PyTorch port against the JAX package.

Packers (numpy in both packages) must give the same bytes; the port's
device unpack (PyTorch ops, run here on CPU tensors) and host unpack must
decode the same (src, dst) as the JAX decoders, for every width; the
from_wire guards refuse what the JAX guards refuse.  Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import stream as jstream
from gelly_streaming_tpu.io import wire as jw
from gelly_streaming_tpu.ops import wire_decode as jdec
from gelly_streaming_tpu_torch.core import stream as tstream
from gelly_streaming_tpu_torch.core.config import StreamConfig as TConfig
from gelly_streaming_tpu_torch.io import wire as tw
from gelly_streaming_tpu_torch.ops import wire_decode as tdec


def _edges(n, cap, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)


# (width, capacity): ids reach the top bit of each fixed width
WIDTHS = [
    (2, 1 << 16),
    (3, 1 << 23),
    (4, 1 << 31),
    (tw.PAIR40, 1 << 20),
    ((tw.EF40, 1 << 10), 1 << 10),
    ((tw.BDV, 1 << 12), 1 << 12),
]
WIDTH_IDS = ["2", "3", "4", "pair40", "ef40", "bdv"]


@pytest.mark.parametrize("width,cap", WIDTHS, ids=WIDTH_IDS)
@pytest.mark.parametrize("n", [0, 1, 513])
def test_pack_and_unpack_match_jax(width, cap, n):
    src, dst = _edges(n, cap - 1, n + len(str(width)))
    src[: min(n, 2)] = cap - 1  # the largest id
    buf = tw.pack_edges(src, dst, width)
    assert buf.dtype == np.uint8
    assert buf.tobytes() == jw.pack_edges(src, dst, width).tobytes()
    if n == 0:
        return
    t_s, t_d = tw.unpack_edges(torch.from_numpy(buf), n, width)
    assert t_s.dtype == t_d.dtype == torch.int32
    j_s, j_d = jw.unpack_edges(jnp.asarray(buf), n, width)
    np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
    h_s, h_d = tw.unpack_edges_host(buf, n, width)
    jh_s, jh_d = jw.unpack_edges_host(buf, n, width)
    np.testing.assert_array_equal(h_s, jh_s)
    np.testing.assert_array_equal(h_d, jh_d)
    np.testing.assert_array_equal(h_s, t_s.numpy())
    # the decoded multiset is the packed one
    got = sorted(zip(h_s.tolist(), h_d.tolist()))
    assert got == sorted(zip(src.tolist(), dst.tolist()))


def test_size_helpers_match_jax():
    for cap in (1, 100, 1 << 16, (1 << 16) + 1, 1 << 20, (1 << 20) + 1, 1 << 24, 1 << 26):
        assert tw.width_for_capacity(cap) == jw.width_for_capacity(cap)
        for batch in (1, 1000, 1 << 16, 1 << 21):
            assert tw.replay_width(cap, batch) == jw.replay_width(cap, batch)
            assert tw.replay_width(cap, batch, False) == jw.replay_width(cap, batch, False)
            assert tw.ef40_nbytes(batch, cap) == jw.ef40_nbytes(batch, cap)
            for w in (2, 3, 4, tw.PAIR40, (tw.EF40, cap), (tw.BDV, cap)):
                assert tw.wire_nbytes(batch, w) == jw.wire_nbytes(batch, w)
    for payload in (0, 3, 4, 5, 17, 1000, 12345, 1 << 20):
        assert tw.bdv_bucket_nbytes(payload) == jw.bdv_bucket_nbytes(payload)
    assert tw.BDV_MAX_ID_BITS == jw.BDV_MAX_ID_BITS
    assert (tw.PAIR40, tw.EF40, tw.BDV) == (jw.PAIR40, jw.EF40, jw.BDV)


def test_varints_and_valued_bdv_match_jax():
    rng = np.random.default_rng(3)
    vals = np.concatenate(
        [rng.integers(0, 1 << 32, 200, dtype=np.uint64), np.array([0, 255, 256, 65535, 65536, (1 << 24) - 1, 1 << 24, (1 << 32) - 1], np.uint64)]
    )
    enc = tw._varint_encode_np(vals)
    assert enc.tobytes() == jw._varint_encode_np(vals).tobytes()
    np.testing.assert_array_equal(tw._varint_decode_np(enc, len(vals)), jw._varint_decode_np(enc, len(vals)))
    padded = np.concatenate([enc, np.zeros(13, np.uint8)])
    got = tdec.decode_varints(torch.from_numpy(padded), len(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jdec.decode_varints(jnp.asarray(padded), len(vals))))
    src, dst = _edges(300, 1 << 12, 4)
    val = rng.integers(-(1 << 30), 1 << 30, 300).astype(np.int32)
    buf = tw.pack_edges_bdv(src, dst, 1 << 12, val_i32=val)
    assert buf.tobytes() == jw.pack_edges_bdv(src, dst, 1 << 12, val_i32=val).tobytes()
    for a, b in zip(tdec.decode_bdv(torch.from_numpy(buf), 300, valued=True), jdec.decode_bdv(jnp.asarray(buf), 300, valued=True)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tw.unpack_edges_bdv_host(buf, 300, valued=True), jw.unpack_edges_bdv_host(buf, 300, valued=True)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="truncated"):
        tw._varint_decode_np(enc[:10], len(vals))
    with pytest.raises(ValueError):
        tw.pack_edges_bdv(src, dst, (1 << 28) + 1)


@pytest.mark.parametrize("batch", [64, 100])
def test_pack_stream_matches_jax(batch):
    src, dst = _edges(1000, 1 << 10, 5)
    for width in (2, tw.PAIR40, (tw.EF40, 1 << 10), (tw.BDV, 1 << 10)):
        tb, tt = tw.pack_stream(src, dst, batch, width)
        jb, jt = jw.pack_stream(src, dst, batch, width)
        assert [b.tobytes() for b in tb] == [b.tobytes() for b in jb]
        assert (tt is None) == (jt is None)
        if tt is not None:
            np.testing.assert_array_equal(tt[0], jt[0])
            np.testing.assert_array_equal(tt[1], jt[1])


def test_plan_superbatch_groups_matches_jax():
    for n in (0, 1, 7, 33):
        for k in (0, 1, 3, 4, 8):
            for bounds in ((), ((4, 0),), ((3, 1), (5, 0))):
                got = tstream.plan_superbatch_groups(n, k, bounds)
                assert got == jstream.plan_superbatch_groups(n, k, bounds)
                assert sum(got) == n


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def test_from_wire_guards_refuse_what_jax_refuses():
    from gelly_streaming_tpu.core.config import StreamConfig as JConfig
    from gelly_streaming_tpu.core.stream import EdgeStream as JStream
    from gelly_streaming_tpu_torch.core.stream import EdgeStream as TStream

    cap, batch = 1000, 64
    src, dst = _edges(batch, cap, 6)
    ok2 = tw.pack_edges(src, dst, 2)
    far = tw.pack_edges(src + 1000, dst, 2)  # ids past the capacity
    bdv = tw.pack_edges_bdv(src, dst, cap)
    tail = (src[:10], dst[:10])
    cases = [
        ([ok2], 2, None),
        ([np.zeros(7, np.uint8)], 2, None),
        ([ok2.astype(np.int16)], 2, None),
        ([far], 2, None),
        ([ok2], 2, (np.full(3, cap), np.zeros(3, np.int64))),
        ([ok2], 2, (np.zeros(batch, np.int32), np.zeros(batch, np.int32))),
        ([ok2], 2, tail),
        ([ok2], 5, None),
        ([tw.pack_edges(src, dst, (tw.EF40, 1024))], (tw.EF40, 1024), None),
        ([tw.pack_edges(src, dst, (tw.EF40, cap))], (tw.EF40, cap), tail),
        ([bdv], (tw.BDV, cap), None),
        ([bdv[:20]], (tw.BDV, cap), None),
        ([np.zeros(10 * batch, np.uint8)], (tw.BDV, cap), None),
    ]
    for bufs, width, t in cases:
        want = _refusal(lambda: JStream.from_wire(bufs, batch, width, JConfig(vertex_capacity=cap), tail=t))
        got = _refusal(
            lambda: TStream.from_wire(bufs, batch, width, TConfig(vertex_capacity=cap), tail=t, device="cpu")
        )
        assert got == want, (width, got, want)
    s = TStream.from_wire([ok2, ok2], batch, 2, TConfig(vertex_capacity=cap), tail=tail, device="cpu")
    assert s.num_edges_hint() == 2 * batch + 10
    batches = list(s.batches())
    assert len(batches) == 3 and int(batches[-1].mask.sum()) == 10
    np.testing.assert_array_equal(batches[0].src.numpy(), src)


def test_ef40_device_unpack_matches_jax_on_arbitrary_bytes():
    """Bitvectors with too few or too many ones decode as the JAX scatter
    leaves them (missing ranks 0, extra ones dropped)."""
    rng = np.random.default_rng(21)
    for _ in range(12):
        n, cap = int(rng.integers(1, 50)), int(rng.integers(1, 64))
        buf = rng.integers(0, 256, tw.ef40_nbytes(n, cap)).astype(np.uint8)
        got = tw.unpack_edges(torch.from_numpy(buf), n, (tw.EF40, cap))
        want = jw.unpack_edges(jnp.asarray(buf), n, (jw.EF40, cap))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
