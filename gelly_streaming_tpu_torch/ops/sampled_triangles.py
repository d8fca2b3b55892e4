"""The reservoir triangle samplers' batch scan: the wrapper of
``csrc/sampled_triangles.cu`` and its plain twin.

Replaces the ``lax.scan`` of ``sampler_update``
(``gelly_streaming_tpu/library/sampled_triangles.py:56-98``).  A step
splits the key in three (next key, coin key, third-vertex key) whether or
not its edge is valid; i counts the valid edges so far.  Each of S lanes
replaces its sampled edge with a valid step's edge when its ``uniform``
coin is below 1 / max(i, 1) (f32), draws a ``randint`` third vertex in
[0, C) and clears its closing flags; a valid edge joining the sampled
edge's first (second) endpoint with the third vertex sets ``closed_a``
(``closed_b``).  The draws are ``jax.random``'s bits (``utils/threefry.py``).

Key t of a stream depends on the seed and t alone, so the chain of B
dependent hashes is host work: ``host_chain`` runs it in C on a host core
(``csrc/threefry_chain.c``), and a ``KeyChain`` holds a stream's chain
ahead of the card and hands each batch's keys over by one async copy out
of a pinned double buffer.  Given the step keys, each lane evolves alone
and only its last replacement in the batch matters.  The twin computes it
that way, with tensors: ``coin_walk`` (the key chain in Python ints; the
coins of every (step, lane) in chunks of steps; each lane's last
replacement), then its randint there and the closing edges from that
step on.  On CUDA tensors ``sampler_scan`` is one C call a batch (seven
kernels; see the source) fed by a ``KeyChain``: the caller's, which
makes the call free of device-to-host reads, or one started from the
state's key by an 8-byte read.  Both update the state's tensors in
place and return it.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from gelly_streaming_tpu_torch.ops import _cuda, indexing
from gelly_streaming_tpu_torch.utils import threefry

_SOURCE = "sampled_triangles.cu"
_HOST_SOURCE = "threefry_chain.c"
TWIN_ELEMENTS = 1 << 22  # (step, lane) pairs the twin's coins hold at once
MAX_STEPS = 65535 * 256  # the kernel's grid: tiles of 256 steps on grid.y
SCRATCH_CACHE = 8

# C calls since the last reset_launches() (CUDA tensors only), and the
# wrapper's twin calls (CPU tensors only)
LAUNCHES: Dict[str, int] = {"sampler_scan": 0}
TWIN_CALLS: Dict[str, int] = {"sampler_scan": 0}
_scratch: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


class SamplerState(NamedTuple):
    key: torch.Tensor  # uint32[2] PRNG key (jax.random's key data)
    edge: torch.Tensor  # int32[S, 2] sampled edge per sampler (-1 = none)
    third: torch.Tensor  # int32[S] watched third vertex
    closed_a: torch.Tensor  # bool[S] saw (u, third)
    closed_b: torch.Tensor  # bool[S] saw (v, third)
    edges_seen: torch.Tensor  # int32[] |E| so far
    seen: torch.Tensor  # bool[C] vertex presence (|V| tracking)


def clone_state(state: SamplerState) -> SamplerState:
    return SamplerState(*(t.clone() for t in state))


def _check(state: SamplerState, src, dst, mask) -> None:
    dev = state.edge.device
    s_lanes = state.edge.shape[0]
    shapes = {"key": ((2,), torch.uint32), "edge": ((s_lanes, 2), torch.int32), "third": ((s_lanes,), torch.int32),
              "closed_a": ((s_lanes,), torch.bool), "closed_b": ((s_lanes,), torch.bool),
              "edges_seen": ((), torch.int32)}
    for name, (shape, dtype) in shapes.items():
        t = getattr(state, name)
        if tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"state.{name} must be a contiguous {dtype} tensor of shape {shape} on {dev}")
    seen = state.seen
    if seen.dtype != torch.bool or seen.dim() != 1 or not seen.is_contiguous() or seen.device != dev:
        raise ValueError(f"state.seen must be a contiguous bool [C] tensor on {dev}")
    if s_lanes < 1 or seen.shape[0] < 1:
        raise ValueError("the samplers need S >= 1 and C >= 1")
    for t, name in ((src, "src"), (dst, "dst")):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != src.shape or t.device != dev:
            raise ValueError(f"{name} must be a 1-D int32 tensor on {dev} with src's length")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != src.shape or mask.device != dev):
        raise ValueError(f"mask must be a bool tensor of src's shape on {dev}, or None")
    if src.shape[0] > MAX_STEPS:
        raise ValueError(f"a batch holds at most {MAX_STEPS} edges")


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def coin_walk(state: SamplerState, ok: torch.Tensor):
    """(step keys int64 [B, 2], the key after the batch as ints, the valid
    counts i int64 [B], each lane's last replacement int64 [S], -1 for
    none) of a batch whose valid rows are ``ok``: the key chain in Python
    ints (B dependent hashes), then every (step, lane) coin in chunks of
    steps."""
    dev = ok.device
    b, s_lanes = ok.shape[0], state.edge.shape[0]
    k = threefry.key_ints(state.key)
    chain = []
    for _ in range(b):
        chain.append(k)
        k = threefry.threefry_2x32(k[0], k[1], 0, 0)
    keys = torch.tensor(chain, dtype=torch.int64, device=dev).reshape(b, 2)
    coin1, coin2 = threefry.threefry_2x32(keys[:, 0], keys[:, 1], 0, 1)
    count = state.edges_seen.to(torch.int64) + torch.cumsum(ok.to(torch.int64), 0)
    thr = 1.0 / _wrap_int32(count).clamp_min(1).to(torch.float32)
    lanes = torch.arange(s_lanes, dtype=torch.int64, device=dev)
    steps = torch.arange(b, dtype=torch.int64, device=dev)
    chunk = max(1, TWIN_ELEMENTS // s_lanes)
    last = torch.full((s_lanes,), -1, dtype=torch.int64, device=dev)
    for lo in range(0, b, chunk):
        sl = slice(lo, lo + chunk)
        bits = threefry.lane_bits((coin1[sl, None], coin2[sl, None]), lanes[None, :])
        fell = (threefry.bits_to_uniform(bits) < thr[sl, None]) & ok[sl, None]
        last = torch.maximum(last, torch.where(fell, steps[sl, None], -1).amax(0))
    return keys, k, count, last


def sampler_scan_plain(state: SamplerState, src, dst, mask) -> SamplerState:
    """The JAX ``sampler_update`` over a batch, lane by lane: updates the
    state in place and returns it."""
    dev = src.device
    b = src.shape[0]
    if b == 0:
        return state
    s_lanes, capacity = state.edge.shape[0], state.seen.shape[0]
    ok = torch.ones((b,), dtype=torch.bool, device=dev) if mask is None else mask
    keys, k, count, last = coin_walk(state, ok)
    third1, third2 = threefry.threefry_2x32(keys[:, 0], keys[:, 1], 0, 2)
    lanes = torch.arange(s_lanes, dtype=torch.int64, device=dev)
    steps = torch.arange(b, dtype=torch.int64, device=dev)
    chunk = max(1, TWIN_ELEMENTS // s_lanes)
    moved = last >= 0
    r = last.clamp_min(0)
    # randint(k_third, (S,), 0, C) at each lane's last replacement
    h1 = threefry.threefry_2x32(third1[r], third2[r], 0, 0)
    h2 = threefry.threefry_2x32(third1[r], third2[r], 0, 1)
    rnd = threefry.span_reduce(threefry.lane_bits(h1, lanes), threefry.lane_bits(h2, lanes), 0, capacity)
    edge = torch.where(moved[:, None], torch.stack([src[r], dst[r]], 1), state.edge)
    third = torch.where(moved, rnd, state.third)
    closed_a = state.closed_a & ~moved
    closed_b = state.closed_b & ~moved
    start = torch.where(moved, r, 0)
    eu, ev = edge[:, 0], edge[:, 1]
    for lo in range(0, b, chunk):
        sl = slice(lo, lo + chunk)
        u, v = src[sl, None], dst[sl, None]
        live = ok[sl, None] & (steps[sl, None] >= start[None, :])
        closed_a |= (live & (((eu == u) & (third == v)) | ((eu == v) & (third == u)))).any(0)
        closed_b |= (live & (((ev == u) & (third == v)) | ((ev == v) & (third == u)))).any(0)
    indexing.scatter_true_(state.seen, src[ok])
    indexing.scatter_true_(state.seen, dst[ok])
    state.edge.copy_(edge)
    state.third.copy_(third)
    state.closed_a.copy_(closed_a)
    state.closed_b.copy_(closed_b)
    state.edges_seen.copy_(_wrap_int32(count[-1]))
    state.key.copy_(threefry.key_tensor(k, dev))
    return state


# ---------------------------------------------------------------------------
# the key chain on the host


def host_chain(key: Tuple[int, int], n: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The key before each of ``n`` steps from ``key``, then the key after
    them: int32 [n + 1, 2] holding the uint32 words, computed by
    ``csrc/threefry_chain.c`` on a host core into ``out`` (a contiguous
    CPU int32 tensor of at least n + 1 rows) or a new tensor."""
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if out is None:
        out = torch.empty((n + 1, 2), dtype=torch.int32)
    elif out.device.type != "cpu" or out.dtype != torch.int32 or out.shape[0] < n + 1 or not out.is_contiguous():
        raise ValueError("out must be a contiguous CPU int32 tensor [>= n + 1, 2]")
    _cuda.host_library(_HOST_SOURCE).threefry_chain(int(key[0]) & threefry.MASK, int(key[1]) & threefry.MASK, n,
                                                   out.data_ptr())
    return out[: n + 1]


class KeyChain:
    """The step keys of one sampler stream on a CUDA device, computed on
    the host ahead of the card.

    ``key`` is the key before the next step not handed out yet.
    ``ahead(n)`` computes the next n steps' keys into the pinned buffer the
    next ``take`` copies from; a shorter next batch takes a prefix of them
    and a longer one continues the chain, exact either way, since key t
    depends on t alone.  ``take(n)`` hands the next n steps' keys to the
    card by one async copy on the current stream out of a pinned double
    buffer (a buffer is refilled only after its last copy's event) and
    returns the device tensor int32 [n + 1, 2] (the key after the n steps
    last), valid until the next ``take``.  Nothing reads the device."""

    def __init__(self, key: Tuple[int, int], device):
        self.key = (int(key[0]) & threefry.MASK, int(key[1]) & threefry.MASK)
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError("a KeyChain feeds CUDA states; the twin draws its own keys")
        self._host = [None, None]  # pinned int32 [rows, 2]
        self._events = [None, None]
        self._dev: Optional[torch.Tensor] = None
        self._next = 0  # the buffer the next take copies from
        self._ready = 0  # steps already in it, from self.key

    def _buffer(self, rows: int) -> torch.Tensor:
        i = self._next
        if self._events[i] is not None:
            self._events[i].synchronize()
            self._events[i] = None
        buf = self._host[i]
        if buf is None or buf.shape[0] < rows:
            grown = torch.empty((rows, 2), dtype=torch.int32, pin_memory=True)
            if self._ready:
                grown[: self._ready + 1] = buf[: self._ready + 1]
            self._host[i] = buf = grown
        return buf

    def ahead(self, n: int) -> None:
        """Compute the next ``n`` steps' keys now (those not computed yet)."""
        buf = self._buffer(n + 1)
        if n > self._ready:
            start = self.key if self._ready == 0 else tuple(int(x) for x in buf[self._ready].tolist())
            host_chain(start, n - self._ready, buf[self._ready:])
            self._ready = n

    def take(self, n: int) -> torch.Tensor:
        """The next ``n`` steps' keys on the card (see the class)."""
        self.ahead(n)
        buf = self._host[self._next]
        if self._dev is None or self._dev.shape[0] < n + 1:
            self._dev = torch.empty((max(n + 1, 1), 2), dtype=torch.int32, device=self.device)
        dev = self._dev[: n + 1]
        dev.copy_(buf[: n + 1], non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._events[self._next] = event
        self.key = tuple(int(x) & threefry.MASK for x in buf[n].tolist())
        self._next ^= 1
        self._ready = 0
        return dev


# ---------------------------------------------------------------------------
# the CUDA call


@_cuda.on_device_of("src")
def scan_launch(state: SamplerState, src: torch.Tensor, dst: torch.Tensor, mask, keys: torch.Tensor) -> SamplerState:
    """The C call over a batch whose step keys are already on the card
    (``keys`` int32 [n + 1, 2]: the key before each step, then after; a
    ``KeyChain.take``), in place; no device-to-host read."""
    dev = state.edge.device
    n, s_lanes = src.shape[0], state.edge.shape[0]
    if keys.dtype != torch.int32 or keys.device != dev or tuple(keys.shape) != (n + 1, 2) or not keys.is_contiguous():
        raise ValueError(f"keys must be a contiguous int32 [{n + 1}, 2] tensor on {dev}")
    lib = _cuda.library(_SOURCE)
    stream = torch.cuda.current_stream(dev)
    key = (dev, stream.cuda_stream, n, s_lanes)
    buf = _scratch.get(key)
    if buf is None:
        if len(_scratch) >= SCRATCH_CACHE:
            _scratch.clear()
        nbytes = int(lib.sampler_scratch_bytes(n, s_lanes))
        buf = _scratch[key] = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    src_c, dst_c = src.contiguous(), dst.contiguous()
    mask_c = None if mask is None else mask.contiguous()
    err = lib.sampler_scan_launch(
        state.key.data_ptr(), state.edge.data_ptr(), state.third.data_ptr(), state.closed_a.data_ptr(),
        state.closed_b.data_ptr(), state.edges_seen.data_ptr(), state.seen.data_ptr(), s_lanes,
        state.seen.shape[0], src_c.data_ptr(), dst_c.data_ptr(), None if mask_c is None else mask_c.data_ptr(),
        n, keys.data_ptr(), buf.data_ptr(), buf.numel(), stream.cuda_stream,
    )
    _cuda.check(err, "sampler_scan_launch")
    LAUNCHES["sampler_scan"] += 1
    return state


def sampler_scan(state: SamplerState, src: torch.Tensor, dst: torch.Tensor, mask,
                 chain: Optional[KeyChain] = None) -> SamplerState:
    """Feed an edge batch through every sampler (``mask`` None keeps every
    row), in place; returns the state.  On CUDA the step keys come from
    ``chain``, whose ``key`` must be the state's (a run loop keeps one
    from the seed), or, without one, from a chain started at the state's
    key by one 8-byte read."""
    _check(state, src, dst, mask)
    if state.edge.device.type != "cuda":
        if chain is not None:
            raise ValueError("a KeyChain feeds CUDA states; the twin draws its own keys")
        TWIN_CALLS["sampler_scan"] += 1
        return sampler_scan_plain(state, src, dst, mask)
    if chain is None:
        chain = KeyChain(threefry.key_ints(state.key), state.edge.device)
    elif chain.device != state.edge.device:
        raise ValueError(f"the chain feeds {chain.device}, the state is on {state.edge.device}")
    return scan_launch(state, src, dst, mask, chain.take(src.shape[0]))
