"""The greedy weighted matching's batch scan: the wrapper of
``csrc/matching.cu``, its plain twin and the plain model of its rounds.

Replaces the ``lax.scan`` of ``matching_update``
(``gelly_streaming_tpu/library/matching.py:38-96``): one step an edge, in
arrival order.  The matched edges at u and at v weigh wu and wv (the edge
u-v itself counted once); the edge is admitted when it is valid, not a
self-loop and its weight exceeds 2 (wu + wv), all in f32.  An admission
evicts the matched edge at u, then the one at v on the updated state, and
matches u with v.  Each edge writes three event rows (type, src, dst,
weight) in f32, ids included: REMOVE at u and REMOVE at v as (0, min,
max, weight), whatever happened, and (1, u, v, w); ``emask`` marks the
rows that happened.

On CUDA tensors ``matching_scan`` is one C call a batch: one block runs
rounds over a window of ``WINDOW`` edges, each lane the JAX step on the
state as the round began, and commits the longest prefix in which no lane
reads or writes a row that an earlier admitting lane of the window writes
(only admissions write, so that prefix saw the serial state); the rest
redo their step in the next round.  ``matching_rounds_plain`` is that plan
on the host, round for round; ``matching_scan_plain`` is the serial twin.
The C call's device counters (``stats``) sum the calls, the rounds and
the admissions; nothing on the main path reads them.  On CPU tensors the
wrapper runs the twin, the walk in Python over host copies of the state,
with numpy f32 scalars for the weights.  All three update ``partner`` and
``weight`` in place.  Ids outside [0, C) follow JAX's index rules: a
gather counts a negative index from the end once and clamps, a scatter
drops it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.ops import _cuda

_SOURCE = "matching.cu"
WINDOW = 256  # edges a round of the C call (csrc/matching.cu's W)
STATS = ("calls", "rounds", "max_rounds", "admitted")  # the C call's order

# C calls since the last reset_launches() (CUDA tensors only), and the
# wrapper's twin calls (CPU tensors only)
LAUNCHES: Dict[str, int] = {"matching_scan": 0}
TWIN_CALLS: Dict[str, int] = {"matching_scan": 0}
_stats: Dict[torch.device, torch.Tensor] = {}
_scratch: Dict[tuple, torch.Tensor] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


def stats(device) -> Dict[str, int]:
    """The CUDA calls' counters on ``device`` since the last reset_stats():
    calls, rounds, the most rounds in one call, edges admitted
    (synchronizes)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    t = _stats.get(dev)
    vals = [0] * len(STATS) if t is None else t.tolist()
    return dict(zip(STATS, vals))


def reset_stats() -> None:
    for t in _stats.values():
        t.zero_()


def _check(partner, weight, src, dst, val, mask) -> None:
    dev = partner.device
    if partner.dtype != torch.int32 or partner.dim() != 1 or not partner.is_contiguous():
        raise ValueError("partner must be a contiguous int32 [C] tensor")
    if partner.shape[0] < 1:
        raise ValueError("the matching needs C >= 1")
    if (weight.dtype != torch.float32 or weight.shape != partner.shape or not weight.is_contiguous()
            or weight.device != dev):
        raise ValueError(f"weight must be a contiguous float32 [C] tensor on {dev}")
    for t, name in ((src, "src"), (dst, "dst")):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape != src.shape or t.device != dev:
            raise ValueError(f"{name} must be a 1-D int32 tensor on {dev} with src's length")
    if val is not None and (val.shape != src.shape or val.device != dev):
        raise ValueError(f"val must be a tensor of src's shape on {dev}, or None")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != src.shape or mask.device != dev):
        raise ValueError(f"mask must be a bool tensor of src's shape on {dev}, or None")


def matching_scan_plain(partner, weight, src, dst, val, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX ``matching_update`` scan, edge by edge: updates ``partner``
    and ``weight`` in place, returns (events f32 [B, 3, 4], emask bool
    [B, 3]) on their device."""
    dev = partner.device
    c = partner.shape[0]
    b = src.shape[0]
    p = partner.tolist()
    w = weight.cpu().numpy().copy()
    su, sd = src.tolist(), dst.tolist()
    wv = np.ones(b, np.float32) if val is None else val.to(torch.float32).cpu().numpy()
    ok = [True] * b if mask is None else mask.tolist()
    events = np.zeros((b, 3, 4), np.float32)
    emask = np.zeros((b, 3), bool)
    zero, two = np.float32(0.0), np.float32(2.0)

    def gather(i):
        i = i + c if i < 0 else i
        return min(max(i, 0), c - 1)

    def scatter(i):
        i = i + c if i < 0 else i
        return i if 0 <= i < c else None

    for e in range(b):
        u, v, x = su[e], sd[e], wv[e]
        pu, pv = p[gather(u)], p[gather(v)]
        wu = w[gather(u)] if pu >= 0 else zero
        same_edge = pu == v and pv == u and pu >= 0
        wv_ = w[gather(v)] if pv >= 0 and not same_edge else zero
        admit = ok[e] and bool(x > two * (wu + wv_)) and u != v
        for slot, a in ((0, u), (1, v)):
            ga = gather(a)
            bp, wa = p[ga], w[ga]
            dropped = admit and bp >= 0
            bb = max(bp, 0)
            if dropped:
                for s in (scatter(a), scatter(bb)):
                    if s is not None:
                        p[s] = -1
                for s in (scatter(a), scatter(bb)):
                    if s is not None:
                        w[s] = zero
            events[e, slot] = (0.0, np.float32(min(a, bb)), np.float32(max(a, bp)), wa)
            emask[e, slot] = dropped
        if admit:
            for s, other in ((scatter(u), v), (scatter(v), u)):
                if s is not None:
                    p[s] = other
            for s in (scatter(u), scatter(v)):
                if s is not None:
                    w[s] = x
        events[e, 2] = (1.0, np.float32(u), np.float32(v), x)
        emask[e, 2] = admit
    partner.copy_(torch.tensor(p, dtype=torch.int32))
    weight.copy_(torch.from_numpy(w))
    return torch.from_numpy(events).to(dev), torch.from_numpy(emask).to(dev)


def _gather(i: np.ndarray, c: int) -> np.ndarray:
    i = np.where(i < 0, i + c, i)
    return np.clip(i, 0, c - 1)


def _scatter(i: np.ndarray, c: int) -> np.ndarray:
    """The row a scatter writes, -1 where it drops."""
    i = np.where(i < 0, i + c, i)
    return np.where((i >= 0) & (i < c), i, -1)


def matching_rounds_plain(partner, weight, src, dst, val, mask, window: int):
    """The C call's plan on the host: rounds over windows of ``window``
    edges, each lane the JAX step on the state as the round began, and
    the longest prefix committed in which no lane reads (its gather rows
    of u and v) or writes (its scatter rows of u, v and the partners it
    evicts, none unless it admits) a row that an earlier admitting lane
    of the window writes.  Updates ``partner`` and ``weight`` in place;
    returns (events f32 [B, 3, 4], emask bool [B, 3], rounds), equal to
    ``matching_scan_plain``'s; ``WINDOW`` is the C call's window."""
    if window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    dev = partner.device
    c = partner.shape[0]
    n = src.shape[0]
    p = partner.cpu().numpy().copy()
    wt = weight.cpu().numpy().copy()
    src_h = src.cpu().numpy().astype(np.int64)
    dst_h = dst.cpu().numpy().astype(np.int64)
    val_h = np.ones(n, np.float32) if val is None else val.to(torch.float32).cpu().numpy()
    ok_h = np.ones(n, bool) if mask is None else mask.cpu().numpy()
    events = np.zeros((n, 3, 4), np.float32)
    emask = np.zeros((n, 3), bool)
    none = np.iinfo(np.int64).max
    first = np.full(c, none, np.int64)  # the first admitting lane of the round that writes each row
    zero, two = np.float32(0.0), np.float32(2.0)
    pos = rounds = 0
    while pos < n:
        rounds += 1
        m = min(window, n - pos)
        u, v, x, ok = src_h[pos:pos + m], dst_h[pos:pos + m], val_h[pos:pos + m], ok_h[pos:pos + m]
        gu, gv = _gather(u, c), _gather(v, c)
        pu, pv = p[gu].astype(np.int64), p[gv].astype(np.int64)
        wgu, wgv = wt[gu], wt[gv]
        wu = np.where(pu >= 0, wgu, zero)
        same = (pu == v) & (pv == u) & (pu >= 0)
        wv = np.where((pv >= 0) & ~same, wgv, zero)
        admit = ok & (x > two * (wu + wv)) & (u != v)
        su, sv = _scatter(u, c), _scatter(v, c)
        drop0 = admit & (pu >= 0)
        bb0 = np.maximum(pu, 0)
        sb0 = _scatter(bb0, c)
        hit = drop0 & ((gv == su) | (gv == sb0))
        b1 = np.where(hit, -1, pv)
        wa1 = np.where(hit, zero, wgv)
        drop1 = admit & (b1 >= 0)
        bb1 = np.maximum(b1, 0)
        sb1 = _scatter(bb1, c)
        # the rows each lane writes ([m, 4], -1: none), then the cut
        writes = np.stack([np.where(admit, su, -1), np.where(admit, sv, -1), np.where(drop0, sb0, -1),
                           np.where(drop1, sb1, -1)], 1)
        lanes = np.arange(m)
        has = writes >= 0
        rows = writes[has]
        np.minimum.at(first, rows, np.broadcast_to(lanes[:, None], writes.shape)[has])
        touched = np.concatenate([gu[:, None], gv[:, None], np.where(has, writes, gu[:, None])], 1)
        conflict = (first[touched] < lanes[:, None]).any(1)
        cut = int(np.argmax(conflict)) if conflict.any() else m
        first[rows] = none
        # commit lanes [0, cut): their write sets are disjoint, so each step of a lane runs for all at once
        k = slice(0, cut)
        e = slice(pos, pos + cut)
        events[e, 0] = np.stack([np.zeros(cut), np.minimum(u[k], bb0[k]), np.maximum(u[k], pu[k]), wgu[k]], 1)
        events[e, 1] = np.stack([np.zeros(cut), np.minimum(v[k], bb1[k]), np.maximum(v[k], b1[k]), wa1[k]], 1)
        events[e, 2] = np.stack([np.ones(cut), u[k], v[k], x[k]], 1)
        emask[e] = np.stack([drop0[k], drop1[k], admit[k]], 1)
        # a lane's stores folded as the kernel folds them: the evicted partners unmatched, then u and v matched
        for drop, sb in ((drop0[k], sb0[k]), (drop1[k], sb1[k])):
            rows_ = sb[drop & (sb >= 0)]
            p[rows_] = -1
            wt[rows_] = zero
        for rows_, other in ((su[k], v[k]), (sv[k], u[k])):
            sel = admit[k] & (rows_ >= 0)
            p[rows_[sel]] = other[sel]
            wt[rows_[sel]] = x[k][sel]
        pos += cut
    partner.copy_(torch.from_numpy(p))
    weight.copy_(torch.from_numpy(wt))
    return torch.from_numpy(events).to(dev), torch.from_numpy(emask).to(dev), rounds


def state_in_shared(capacity: int) -> bool:
    """Whether the C call keeps the state of ``capacity`` rows in shared
    memory (on the current CUDA device)."""
    return int(_cuda.library(_SOURCE).matching_scratch_bytes(capacity)) == 0


def _call_buffers(dev: torch.device, capacity: int):
    """The stats vector of ``dev`` and the call's stamps (None where the
    state fits in shared memory), kept across calls."""
    st = _stats.get(dev)
    if st is None:
        st = _stats[dev] = torch.zeros((len(STATS),), dtype=torch.int32, device=dev)
    key = (dev, capacity)
    if key not in _scratch:
        nbytes = int(_cuda.library(_SOURCE).matching_scratch_bytes(capacity))
        if nbytes < 0:
            raise ValueError(f"no matching scan for C = {capacity}")
        _scratch[key] = torch.empty((nbytes // 4,), dtype=torch.int32, device=dev) if nbytes else None
    return st, _scratch[key]


@_cuda.on_device_of("partner")
def matching_scan(
    partner: torch.Tensor,
    weight: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    val: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a batch into the matching (partner int32 [C], -1 = unmatched;
    weight f32 [C]) in place; returns (events f32 [B, 3, 4], emask bool
    [B, 3]).  ``val`` None weighs every edge 1; ``mask`` None keeps every
    row."""
    _check(partner, weight, src, dst, val, mask)
    if partner.device.type != "cuda":
        TWIN_CALLS["matching_scan"] += 1
        return matching_scan_plain(partner, weight, src, dst, val, mask)
    dev = partner.device
    b = src.shape[0]
    st, stamps = _call_buffers(dev, partner.shape[0])
    events = torch.empty((b, 3, 4), dtype=torch.float32, device=dev)
    emask = torch.empty((b, 3), dtype=torch.bool, device=dev)
    src_c, dst_c = src.contiguous(), dst.contiguous()
    val_c = None if val is None else val.to(torch.float32).contiguous()
    mask_c = None if mask is None else mask.contiguous()
    err = _cuda.library(_SOURCE).matching_scan_launch(
        partner.data_ptr(), weight.data_ptr(), partner.shape[0], src_c.data_ptr(), dst_c.data_ptr(),
        None if val_c is None else val_c.data_ptr(), None if mask_c is None else mask_c.data_ptr(), b,
        events.data_ptr(), emask.data_ptr(), None if stamps is None else stamps.data_ptr(), st.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "matching_scan_launch")
    LAUNCHES["matching_scan"] += 1
    return events, emask
