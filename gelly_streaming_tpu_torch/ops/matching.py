"""The greedy weighted matching's batch scan: the wrapper of
``csrc/matching.cu`` and its plain twin.

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

On CUDA tensors ``matching_scan`` is one C call a batch, one thread
walking the batch (the greedy is serial).  On CPU tensors it runs the
twin, the same walk in Python over host copies of the state, with numpy
f32 scalars for the weights.  Both update ``partner`` and ``weight`` in
place.  Ids outside [0, C) follow JAX's index rules: a gather counts a
negative index from the end once and clamps, a scatter drops it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gelly_streaming_tpu_torch.ops import _cuda

_SOURCE = "matching.cu"

# C calls since the last reset_launches() (CUDA tensors only), and the
# wrapper's twin calls (CPU tensors only)
LAUNCHES: Dict[str, int] = {"matching_scan": 0}
TWIN_CALLS: Dict[str, int] = {"matching_scan": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, TWIN_CALLS):
        for name in counts:
            counts[name] = 0


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
    events = torch.empty((b, 3, 4), dtype=torch.float32, device=dev)
    emask = torch.empty((b, 3), dtype=torch.bool, device=dev)
    src_c, dst_c = src.contiguous(), dst.contiguous()
    val_c = None if val is None else val.to(torch.float32).contiguous()
    mask_c = None if mask is None else mask.contiguous()
    err = _cuda.library(_SOURCE).matching_scan_launch(
        partner.data_ptr(), weight.data_ptr(), partner.shape[0], src_c.data_ptr(), dst_c.data_ptr(),
        None if val_c is None else val_c.data_ptr(), None if mask_c is None else mask_c.data_ptr(), b,
        events.data_ptr(), emask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _cuda.check(err, "matching_scan_launch")
    LAUNCHES["matching_scan"] += 1
    return events, emask
