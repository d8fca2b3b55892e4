"""Port parity: the wire format of the PyTorch port against the JAX package.

Packers (numpy in both packages) must give the same bytes; the port's
device unpack (PyTorch ops and the kernels' twins, run here on CPU
tensors) and host unpack must decode the same (src, dst) as the JAX
decoders, for every width and on arbitrary EF40 and BDV bytes; the
from_wire guards refuse what the JAX guards refuse.  Tolerance: none.
"""

import jax
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


# the JAX decode as the JAX package dispatches it: one executable a shape
_jax_unpack_ef40 = jax.jit(jw.unpack_edges_ef40, static_argnums=(1, 2))


def _ef40_bytes(case, rng, n, cap):
    """A buffer of one arbitrary-bytes case: the bitvector's ones against
    n."""
    buf = rng.integers(0, 256, tw.ef40_nbytes(n, cap)).astype(np.uint8)
    bv = (n + cap + 7) // 8
    if case == "no_ones":
        buf[:bv] = 0
    elif case == "all_ones":
        buf[:bv] = 0xFF
    elif case == "too_few_ones":  # about n / 4 ones in n + cap bits
        bits = rng.random(8 * bv) < n / (4 * (n + cap))
        buf[:bv] = np.packbits(bits, bitorder="little")
    elif case == "too_many_ones":  # about 2n ones
        bits = rng.random(8 * bv) < min(1.0, 2 * n / (n + cap))
        buf[:bv] = np.packbits(bits, bitorder="little")
    return buf


@pytest.mark.parametrize("case", ["no_ones", "all_ones", "too_few_ones", "too_many_ones", "odd_n", "thousands"])
def test_ef40_device_unpack_matches_jax_on_edge_cases(case):
    """The twin (the CPU path of ``ops/wire_decode.unpack_edges_ef40``) and
    the JAX decode on bitvectors with no, every, too few and too many ones,
    odd n, and n and capacity in the thousands."""
    rng = np.random.default_rng(len(case))
    if case == "thousands":
        n, cap = int(rng.integers(2000, 6000)), int(rng.integers(2000, 6000))
    else:  # one shape a case: one JAX compile
        n, cap = int(rng.integers(1, 300)) | (1 if case == "odd_n" else 0), int(rng.integers(1, 300))
    for _ in range(4):
        buf = _ef40_bytes(case, rng, n, cap)
        got = tdec.unpack_edges_ef40(torch.from_numpy(buf), n, cap)
        want = _jax_unpack_ef40(jnp.asarray(buf), n, cap)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ef40_wrapper_runs_the_twin_on_cpu_tensors_only_and_counts_it():
    src, dst = _edges(1001, 1000, 4)
    buf = tw.pack_edges(src, dst, (tw.EF40, 1000))
    tdec.reset_launches()
    got = tw.unpack_edges(torch.from_numpy(buf), 1001, (tw.EF40, 1000))
    assert tdec.TWIN_CALLS == {"bdv_decode": 0, "ef40_unpack": 1, "wire_unpack": 0}
    assert not any(tdec.LAUNCHES.values())
    want = tdec.unpack_edges_ef40_plain(torch.from_numpy(buf), 1001, 1000)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    order = np.lexsort((dst, src))  # the multiset, src-grouped
    assert np.array_equal(np.sort(got[0].numpy()), src[order]) and sorted(zip(*(x.tolist() for x in got))) == \
        sorted(zip(src.tolist(), dst.tolist()))
    with pytest.raises(ValueError):
        tdec.unpack_edges_ef40(torch.from_numpy(buf).to(torch.int32), 1001, 1000)
    with pytest.raises(ValueError):
        tdec.unpack_edges_ef40(torch.from_numpy(buf), -1, 1000)
    with pytest.raises(ValueError):
        tdec.unpack_edges_ef40(torch.from_numpy(buf).to("meta"), 1001, 1000)
    assert tdec.TWIN_CALLS["ef40_unpack"] == 1


# ---------------------------------------------------------------------------
# the BDV decode (ops/wire_decode.py): the wrapper runs its plain twin on
# CPU tensors, which must equal the JAX decode on any bytes


# the JAX decode as the JAX package dispatches it: traced into one cached
# executable a shape (n and the layout static)
_jax_decode_bdv = jax.jit(jdec.decode_bdv, static_argnums=(1, 2))


@pytest.mark.parametrize("width,cap", [(3, 1 << 24), (tw.PAIR40, 1 << 20)], ids=["3", "pair40"])
@pytest.mark.parametrize("n", [1, 7, 4096])
def test_fixed_unpack_wrapper_takes_the_twin_on_cpu_and_matches_jax(width, cap, n):
    """``unpack_edges_fixed`` (the ``wire_unpack`` kernel's wrapper) on a
    CPU tensor runs its twin, counts it, launches nothing, and decodes
    JAX's values: ids 0 and C - 1, values across PAIR40's bit-19/20 seam,
    buffers that start at an odd byte of a larger one."""
    rng = np.random.default_rng(n)
    src, dst = _edges(n, cap, n + 1)
    src[0], dst[-1] = cap - 1, 0
    if n > 4:
        src[1:4] = [(1 << 19) - 1, 1 << 19, (1 << 20) - 1] if width == tw.PAIR40 else [(1 << 16) - 1, 1 << 16, 255]
        dst[1:4] = src[1:4][::-1]
    buf = tw.pack_edges(src, dst, width)
    for off in (0, 1, 7, 15):
        big = np.concatenate([rng.integers(0, 256, off).astype(np.uint8), buf, np.full(3, 0xFF, np.uint8)])
        view = torch.from_numpy(big)[off : off + buf.nbytes]
        before_l, before_t = dict(tdec.LAUNCHES), dict(tdec.TWIN_CALLS)
        t_s, t_d = tdec.unpack_edges_fixed(view, n, width)
        assert tdec.LAUNCHES == before_l
        assert tdec.TWIN_CALLS == {**before_t, "wire_unpack": before_t["wire_unpack"] + 1}
        j_s, j_d = jw.unpack_edges(jnp.asarray(buf), n, width)
        assert t_s.dtype == t_d.dtype == torch.int32
        np.testing.assert_array_equal(t_s.numpy(), np.asarray(j_s))
        np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
        np.testing.assert_array_equal(t_s.numpy(), src)
    # io/wire.unpack_edges routes these widths to the wrapper
    before = tdec.TWIN_CALLS["wire_unpack"]
    tw.unpack_edges(torch.from_numpy(buf), n, width)
    assert tdec.TWIN_CALLS["wire_unpack"] == before + 1


def test_fixed_unpack_wrapper_refuses_bad_buffers():
    buf = torch.from_numpy(tw.pack_edges(*_edges(8, 1 << 20, 0), tw.PAIR40))
    for bad, width in ((buf.to(torch.int32), tw.PAIR40), (buf.reshape(5, 8), tw.PAIR40), (buf[:-1], tw.PAIR40),
                       (buf[: 6 * 8 - 1], 3), (buf, 2), (buf, 4)):
        with pytest.raises(ValueError):
            tdec.unpack_edges_fixed(bad, 8, width)
    with pytest.raises(ValueError):
        tdec.unpack_edges_fixed(buf, -1, 3)
    # widths 2 and 4 keep their PyTorch ops, which the wrapper never counts
    before = dict(tdec.TWIN_CALLS)
    s2 = tw.pack_edges(*_edges(8, 1 << 16, 1), 2)
    tw.unpack_edges(torch.from_numpy(s2), 8, 2)
    assert tdec.TWIN_CALLS == before


def _bdv_kinds(kind, n, cap, rng):
    if kind == "uniform":
        return rng.integers(0, cap, n).astype(np.int32), rng.integers(0, cap, n).astype(np.int32)
    if kind == "skewed":
        d = (cap * rng.random(n) ** 4).astype(np.int64).astype(np.int32) % cap
        return (cap * rng.random(n) ** 2).astype(np.int64).astype(np.int32) % cap, d
    # every edge on one destination: the widest single bin
    return np.sort(rng.integers(0, cap, n)).astype(np.int32), np.full(n, cap - 1, np.int32)


@pytest.mark.parametrize("kind", ["uniform", "skewed", "max-degree"])
@pytest.mark.parametrize("cap", [1 << 10, 1 << 28])
def test_bdv_twin_round_trips_like_jax(kind, cap):
    rng = np.random.default_rng(cap % 97 + len(kind))
    for n in (0, 1, 5, 513):
        src, dst = _bdv_kinds(kind, n, cap, rng)
        buf = tw.pack_edges_bdv(src, dst, cap)
        assert buf.tobytes() == jw.pack_edges_bdv(src, dst, cap).tobytes()
        assert buf.nbytes <= tw.wire_nbytes(n, (tw.BDV, cap))
        order = np.lexsort((src, dst))
        if n == 0:
            continue
        # bucket padding and a group arena's wider row decode the same
        for b in (buf, np.concatenate([buf, np.zeros(4096, np.uint8)]))[: 2 if n == 513 else 1]:
            got = tdec.decode_bdv(torch.from_numpy(b), n)
            want = _jax_decode_bdv(jnp.asarray(b), n, False)
            for a, w, o in zip(got, want, (src[order], dst[order])):
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
                np.testing.assert_array_equal(a.numpy(), o)


def test_bdv_twin_matches_jax_on_arbitrary_bytes():
    """Clipped reads past the end, truncated buffers, random control
    blocks, the valued layout and counts not a multiple of 4 decode as the
    JAX decode's clipped gathers and wrapping int32 cumsums decode them."""
    rng = np.random.default_rng(22)
    src, dst = _edges(700, 1 << 20, 23)
    full = tw.pack_edges_bdv(src, dst, 1 << 20)
    cases = [(full[: len(full) // 3], 700, False), (full[:5], 700, False), (full[:1], 3, True)]
    # a few shapes (each compiles the JAX decode once), many buffers each
    for nb, n, valued in ((7, 5, False), (64, 1, True), (64, 41, False), (300, 90, True)):
        cases += [(rng.integers(0, 256, nb).astype(np.uint8), n, valued) for _ in range(8)]
    cases.append((np.full(64, 0xFF, np.uint8), 41, False))  # 4-byte varints: the sums wrap
    for buf, n, valued in cases:
        got = tdec.decode_bdv(torch.from_numpy(buf), n, valued)
        want = _jax_decode_bdv(jnp.asarray(buf), n, valued)
        assert len(got) == len(want) == (3 if valued else 2)
        for a, w in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_bdv_wrapper_takes_the_twin_on_cpu_only():
    tdec.reset_launches()
    buf = tw.pack_edges_bdv(np.arange(9, dtype=np.int32), np.arange(9, dtype=np.int32)[::-1].copy(), 16)
    tdec.decode_bdv(torch.from_numpy(buf), 9)
    assert tdec.TWIN_CALLS["bdv_decode"] == 1 and tdec.LAUNCHES["bdv_decode"] == 0
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tdec.decode_bdv(torch.from_numpy(buf).to("meta"), 9)
    with pytest.raises(ValueError):
        tdec.decode_bdv(torch.zeros(0, dtype=torch.uint8), 1)
    with pytest.raises(ValueError):
        tdec.decode_bdv(torch.from_numpy(buf).to(torch.int32), 9)


def test_native_sort_and_encoder_give_numpy_bytes():
    from gelly_streaming_tpu_torch.utils import native

    assert native.load_ingest_lib() is not None
    rng = np.random.default_rng(4)
    for cap in (2, 1 << 8, 1 << 20, 1 << 28):
        src = rng.integers(0, cap, 4000).astype(np.int32)
        dst = rng.integers(0, cap, 4000).astype(np.int32)
        s, d, _ = tw._sort_edges_bdv(src, dst, cap)
        order = np.lexsort((src, dst))
        np.testing.assert_array_equal(s, src[order])
        np.testing.assert_array_equal(d, dst[order])
        payload = tw._encode_bdv_np(s, d)
        buf = tw.pack_edges_bdv(src, dst, cap)
        np.testing.assert_array_equal(buf[: len(payload)], payload)
        assert not buf[len(payload):].any()
        assert tw.max_dst_run(d) == jw.max_dst_run(d)
        for a, b in zip(tw.sort_edges_binned(src, dst, cap), jw.sort_edges_binned(src, dst, cap)):
            np.testing.assert_array_equal(a, b)
    assert tw.max_dst_run(np.zeros(0, np.int32)) == 0


def test_host_decode_into_matches_jax():
    """The native one-pass validate + decode (+ bin) and its numpy twin:
    the JAX package's arrays, and its refusals."""
    rng = np.random.default_rng(24)
    cap, n = 1 << 12, 300
    src, dst = _edges(n, cap, 25)
    for width in (2, 3, 4, tw.PAIR40, (tw.BDV, cap)):
        buf = tw.pack_edges(src, dst, width)
        for sort in (False, True):
            want = jw.decode_wire_np(buf, n, width, cap, sort=sort)
            got = tw.decode_wire_np(buf, n, width, cap, sort=sort)
            out_s, out_d = np.empty(n, np.int32), np.empty(n, np.int32)
            assert tw.decode_wire_into(buf, n, width, cap, out_s, out_d, sort=sort)
            for a, b, c in zip(got, (out_s, out_d), want):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, c)
    assert not tw.decode_wire_into(tw.pack_edges(src, dst, (tw.EF40, cap)), n, (tw.EF40, cap), cap,
                                   np.empty(n, np.int32), np.empty(n, np.int32))
    # a near-worst-case batch (huge dst deltas, alternating src deltas) buckets
    # no further than wire_nbytes, and decodes
    big = 1 << 28
    w_dst = (np.arange(16, dtype=np.int64) * (1 << 24)).astype(np.int32)
    w_src = np.where(np.arange(16) % 2, 1 << 27, 0).astype(np.int32)
    worst = tw.pack_edges_bdv(w_src, w_dst, big)
    assert worst.tobytes() == jw.pack_edges_bdv(w_src, w_dst, big).tobytes()
    assert worst.nbytes <= tw.wire_nbytes(16, (tw.BDV, big))
    for a, b in zip(tw.decode_wire_np(worst, 16, (tw.BDV, big), big), jw.decode_wire_np(worst, 16, (tw.BDV, big), big)):
        np.testing.assert_array_equal(a, b)
    # a stream [dst delta 0, zigzag(src delta -1)] decodes src = -1: BDV's
    # signed deltas reach below 0, and both ends of the range are refused
    negative = np.zeros(tw.wire_nbytes(n, (tw.BDV, cap)), np.uint8)
    payload = tw._varint_encode_np(np.array([0, 1] + [0] * (2 * n - 2), np.uint64))
    negative[: len(payload)] = payload
    bad = [(tw.pack_edges(src, dst, 2)[:-1], 2), (tw.pack_edges(src + cap, dst, 3), 3),
           (rng.integers(0, 256, 9 * n).astype(np.uint8), (tw.BDV, cap)), (negative, (tw.BDV, cap))]
    for buf, width in bad:
        want = _refusal(lambda: jw.decode_wire_np(buf, n, width, cap))
        assert want is not None
        assert _refusal(lambda: tw.decode_wire_np(buf, n, width, cap)) == want
        assert _refusal(lambda: tw.decode_wire_into(buf, n, width, cap, np.empty(n, np.int32),
                                                    np.empty(n, np.int32))) == want
