#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (gelly_streaming_tpu_torch).

    python3 chip_smoke.py [--baseline-cu PATH]

Needs one CUDA GPU (built for an H100, sm_90a) and nvcc.  It builds the
port's CUDA kernels from ``gelly_streaming_tpu_torch/csrc``, holds each
kernel against its plain PyTorch twin on the card (random panes from 32 to
16384 vertices, a star, a Zipf-skewed pane, a complete graph whose total
passes 2^32, an empty pane, edges on bit 31 and on word boundaries, and
unaligned inputs), then drives the port's main path, ``window_triangles``
over an event-time ``EdgeStream``, at the size of the repo's triangle bench
(16 windows of 2^17 edges over 4096 vertices, plus one 8192-vertex window
and one sparse-id window that takes the CSR path), checks every window's
count and holds both kernels against their twins on every dense window.
Tolerance: none; both kernels compute integers and must equal their twins
exactly (``max_abs_err`` 0).

Phase 5 times each kernel three ways: CUDA events around back-to-back
calls (``ms``, the host's enqueue time included when it is the longer),
events around calls enqueued while ``torch.cuda._sleep`` holds the stream
(``device_ms``, the device alone), and the host's enqueue time per call
(``host_us``).  ``--baseline-cu`` names another build of
``pane_triangles.cu`` with the C interface of the first port slice (caller
zeroes the outputs); its two kernels are then timed the same way, in turns
with the current ones (baseline, current, current, baseline).

Phase 6 holds the union-find kernels (``csrc/unionfind.cu``) against their
plain twin on the card at 2^20 vertices: uniform, star, Zipf, a 2^20-vertex
path inserted in reverse order and shuffled, self-loops, a masked tail,
ids at capacity - 1, an incoming forest whose roots are not the smallest
ids, and ``merge_parents`` of two such forests; parent and seen must be
equal exactly.  Phase 7 drives the streaming CC main path at the size of
the repo's CC bench (bench.py): 50 batches of 2^21 uniform edges over 2^20
vertices (seed 0), packed EF40 by ``pack_stream`` (untimed), through
``EdgeStream.from_wire(...).aggregate(ConnectedComponents())`` on the
card; the final labels must equal both the plain twin folding the same
batches on the card and scipy's connected components (smallest id per
component).  A ``from_arrays`` stream with ``ingest_window_edges`` set
checks every running emission the same way.  The two union-find kernels
are timed on the main path's last batch: ``ms`` by torch.profiler where it
shows them, and ``device_ms``/``host_us`` on a held stream, compress as
the call with no edges and the union kernel as the whole call minus it.

It prints timings, a ``{"kernels": [...]}`` JSON line, the GPU's name and
power limit, and as its last line ``{"ok": true, "device": {...}}``.  Any
failed phase exits non-zero without that line; so does a machine without
CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

WINDOW_MS = 1000
PANE_EDGES = 1 << 17
PANE_VERTICES = 4096
DENSE_WINDOWS = 16
TIMED_REPS = 200

# the streaming CC main path at bench.py's size (bench.py:2190-2192, 2276-2306)
CC_VERTICES = 1 << 20
CC_BATCH = 1 << 21
CC_BATCHES = 50
CC_EMIT_BATCHES = 8  # from_arrays prefix with running emissions
CC_EMIT_EVERY = 2  # batches per emission on that prefix
UF_REPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events: the device's time, or the host's when it enqueues slower."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sleep_cycles_per_ms() -> float:
    """Rate of ``torch.cuda._sleep``'s spin, in cycles per ms of the card."""
    import torch

    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def device_ms(fn, reps: int, cycles_per_ms: float, warmup: int = 3):
    """(device ms per call, host enqueue us per call) of ``fn``.

    A ``torch.cuda._sleep`` holds the stream while all ``reps`` calls are
    enqueued; events recorded after the sleep and after the last call then
    bracket the device's work alone.  The hold is checked: if the sleep
    had ended before the last call was enqueued, it is lengthened and the
    run repeated."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    hold_ms = max(2.0, 3e3 * reps * (time.perf_counter() - t0) / warmup)
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_s = time.perf_counter() - t0
        end.record()
        held = not start.query()  # the sleep still ran after the last enqueue
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps, host_s / reps * 1e6
        hold_ms *= 4
    raise RuntimeError("the host could not enqueue the timed calls inside the hold")


def profiler_device_us(fn, reps: int):
    """torch.profiler's device time per call of each kernel or memset that
    ``fn`` runs: {name: (us per call, calls)}; empty when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us and evt.count:
            rows[evt.key] = (us / evt.count, evt.count)
    return rows


# ---------------------------------------------------------------------------
# inputs


def to_dev(arrays, dev):
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def seeded_pane_words(rng, k: int, edges: int):
    """Packed words of a random pane over [0, k) with duplicates, both
    orientations and self-loops, plus garbage words past n."""
    u = rng.integers(0, k, edges)
    v = rng.integers(0, k, edges)
    dup = rng.integers(0, edges, edges // 4)
    loops = rng.integers(0, k, 16)
    return edge_words(rng, k, np.concatenate([u, v[dup], loops]), np.concatenate([v, u[dup], loops]))


def edge_words(rng, k: int, u, v):
    """Host (int32 words, int32[1] n) of an edge list, with garbage words
    past n that the kernel must ignore."""
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    w, n = dt.pack_pane(np.asarray(u), np.asarray(v))
    if int(n) == len(w):  # make room for padding that must be ignored
        w = np.concatenate([w, np.zeros_like(w)])
    w[int(n):] = (rng.integers(0, k, len(w) - int(n)) | (1 << 14)).astype(np.uint32)
    return dt.packed_host_arrays(w, n)


def star_edges(rng, k: int):
    """Vertex 0 joined to every other vertex (a row of degree k - 1, all
    of it oriented work), plus 2k random edges among the leaves."""
    leaves = np.arange(1, k)
    u = np.concatenate([np.zeros(k - 1, np.int64), rng.integers(1, k, 2 * k)])
    v = np.concatenate([leaves, rng.integers(1, k, 2 * k)])
    return u, v


def zipf_edges(rng, k: int, edges: int, a: float = 1.2):
    """Edges whose endpoints follow a Zipf law over the ids: hub rows at
    low ids, so their neighbours are nearly all above them."""
    p = 1.0 / np.arange(1, k + 1) ** a
    p /= p.sum()
    return rng.choice(k, edges, p=p), rng.choice(k, edges, p=p)


def boundary_edges(k: int):
    """A complete graph on vertices at bit 0 and bit 31 of words and at the
    ends of the row."""
    ids = sorted({x for x in (0, 1, 30, 31, 32, 33, 63, 64, 95, 96, 127, 128,
                              k - 33, k - 32, k - 31, k - 2, k - 1) if 0 <= x < k})
    pairs = [(a, b) for a in ids for b in ids if a < b]
    return np.array([a for a, _ in pairs]), np.array([b for _, b in pairs])


def adjacency(k: int, u, v) -> np.ndarray:
    adj = np.zeros((k, k), bool)
    adj[u, v] = True
    adj[v, u] = True
    np.fill_diagonal(adj, False)
    return adj


def numpy_six_triangles(adj: np.ndarray) -> int:
    """trace(A^3) = sum(A * (A @ A)) for symmetric A, in numpy (float32
    matmul: entries < 2^24 are exact)."""
    a = adj.astype(np.float32)
    return int(((a @ a) * a).sum(dtype=np.float64))


def word_err(got, want) -> int:
    """Max |difference| of two int32 bitsets, words read as uint32."""
    import torch

    torch.cuda.synchronize()
    mask = 0xFFFFFFFF
    return int(((got.long() & mask) - (want.long() & mask)).abs().max())


# ---------------------------------------------------------------------------
# phases 2-3: each kernel against its twin


def phase_adjacency(dev, rng) -> int:
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    cases = [(f"K={k}", k, seeded_pane_words(rng, k, 8 * k + 3))
             for k in (32, 96, 128, 4096, 8192, 16384)]
    cases += [
        ("star K=4096", 4096, edge_words(rng, 4096, *star_edges(rng, 4096))),
        ("Zipf K=4096, 2^17 edges", 4096, edge_words(rng, 4096, *zipf_edges(rng, 4096, PANE_EDGES))),
        ("bit 31 / word edges K=4096", 4096, edge_words(rng, 4096, *boundary_edges(4096))),
        ("bit 31 / word edges K=96", 96, edge_words(rng, 96, *boundary_edges(96))),
        ("empty pane K=4096", 4096, edge_words(rng, 4096, [], [])),
    ]
    worst = 0
    for name, k, host in cases:
        words, n = to_dev(host, dev)
        views = [("", words, n)]
        if len(words) > 1:  # a view 4 B off alignment takes the scalar loads
            views.append((", unaligned", words[1:], n - 1 if int(n[0]) > 0 else n))
        for tag, w, nn in views:
            got = dt.pane_adjacency(w, nn, k)
            err = word_err(got, dt.pane_adjacency_plain(w, nn, k))
            worst = max(worst, err)
            if err:
                raise RuntimeError(f"pane_adjacency {name}{tag}: differs from the twin")
        log(f"  pane_adjacency {name}: bit-equal to the plain twin (n={int(n[0])}, aligned and unaligned)")
    return worst


def phase_dense(dev, rng) -> int:
    import torch

    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    errs = []

    def check(name, adj_np, expect=None, with_numpy=True):
        adj = torch.from_numpy(adj_np).to(dev)
        bits = dt.pack_bits(adj)
        twin = int(dt.dense_triangles_plain(bits)[0])
        ref = numpy_six_triangles(adj_np) if with_numpy else twin
        if expect is not None and ref != expect:
            raise RuntimeError(f"dense_triangles {name}: reference {ref} != {expect}")
        # the same bits 4 B off alignment take the scalar loads
        flat = torch.empty(bits.numel() + 1, dtype=torch.int32, device=dev)
        shifted = flat[1:].view(bits.shape)
        shifted.copy_(bits)
        for tag, b in (("", bits), (" unaligned", shifted)):
            got = int(dt.dense_triangles(b)[0])
            errs.append(abs(got - twin))
            if not got == twin == ref:
                raise RuntimeError(
                    f"dense_triangles {name}{tag}: kernel {got}, twin {twin}, reference {ref}"
                )
        log(f"  dense_triangles {name}: total {twin} exact "
            f"(twin, {'numpy' if with_numpy else 'twin only'}; aligned and unaligned)")

    for k, p in ((32, 0.4), (96, 0.2), (128, 0.2), (4096, 0.01), (8192, 0.004)):
        upper = np.triu(rng.random((k, k), dtype=np.float32) < p, 1)
        check(f"K={k}", upper | upper.T, with_numpy=k <= 4096)
    kc = 2048
    check("complete K=2048", ~np.eye(kc, dtype=bool), expect=kc * (kc - 1) * (kc - 2))
    check("star K=4096", adjacency(4096, *star_edges(rng, 4096)))
    check("Zipf K=4096, 2^17 edges", adjacency(4096, *zipf_edges(rng, 4096, PANE_EDGES)),
          with_numpy=False)
    for k in (4096, 96):
        u, v = boundary_edges(k)
        m = len(set(u) | set(v))
        check(f"bit 31 / word edges K={k}", adjacency(k, u, v), expect=m * (m - 1) * (m - 2))
    check("empty K=4096", np.zeros((4096, 4096), bool), expect=0, with_numpy=False)
    k = 16384
    src = rng.integers(0, k, 16 * k)
    dst = rng.integers(0, k, 16 * k)
    adj = torch.zeros((k, k), dtype=torch.bool, device=dev)
    s, d = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    adj[s, d] = True
    adj[d, s] = True
    adj.fill_diagonal_(False)
    check("K=16384", adj.cpu().numpy(), with_numpy=False)
    return max(errs)


# ---------------------------------------------------------------------------
# phase 4: the main path


def main_path_stream(rng, dev):
    """(stream, panes) for the main-path run: the stream's windows are the
    panes, in order."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io.sources import _batched

    panes = []
    for _ in range(DENSE_WINDOWS):
        panes.append((rng.integers(0, PANE_VERTICES, PANE_EDGES),
                      rng.integers(0, PANE_VERTICES, PANE_EDGES)))
    panes.append((rng.integers(0, 8192, PANE_EDGES), rng.integers(0, 8192, PANE_EDGES)))
    # sparse ids: 12000 distinct ids spread over [0, 2^16) -> CSR path
    ids = rng.choice(1 << 16, 12000, replace=False)
    panes.append((ids[rng.integers(0, len(ids), 1 << 15)],
                  ids[rng.integers(0, len(ids), 1 << 15)]))
    panes = [(s.astype(np.int32), d.astype(np.int32)) for s, d in panes]
    times = [
        np.sort(rng.integers(w * WINDOW_MS, (w + 1) * WINDOW_MS, len(p[0])))
        for w, p in enumerate(panes)
    ]
    src = np.concatenate([p[0] for p in panes])
    dst = np.concatenate([p[1] for p in panes])
    tim = np.concatenate(times)
    cfg = StreamConfig(vertex_capacity=1 << 16, batch_size=1 << 16)
    stream = EdgeStream.from_batches(
        _batched(src, dst, None, tim, None, cfg.batch_size, dev), cfg, device=dev
    )
    return stream, panes


def plain_pane_count(src, dst, dev) -> int:
    """A pane's count with the plain twins on the card, on compacted ids."""
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    verts, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    cu, cv = inv[: len(src)], inv[len(src):]
    w, n = dt.pack_pane(cu, cv)
    words, nn = to_dev(dt.packed_host_arrays(w, n), dev)
    bits = dt.pane_adjacency_plain(words, nn, dt.pane_k(len(verts)))
    return int(dt.dense_triangles_plain(bits)[0]) // 6


def check_windows(panes, dev):
    """Both kernels against their twins on every dense window of the main
    path, as the path prepares it: (windows checked, adjacency err, total err)."""
    from gelly_streaming_tpu_torch.io.prefetch import upload
    from gelly_streaming_tpu_torch.library import triangles as tri
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    checked, adj_err, tri_err = 0, 0, 0
    for w, (src, dst) in enumerate(panes):
        meta, arrays = tri._pane_prepare((src, dst), dev)
        if meta[0] != "packed":
            continue
        words, nn = upload(arrays, dev)
        k = dt.pane_k(meta[1])
        bits = dt.pane_adjacency(words, nn, k)
        twin_bits = dt.pane_adjacency_plain(words, nn, k)
        twin = int(dt.dense_triangles_plain(twin_bits)[0])
        e_adj = word_err(bits, twin_bits)
        e_tri = max(abs(int(dt.dense_triangles(twin_bits)[0]) - twin),
                    abs(int(dt.pane_triangles(words, nn, k)[0]) - twin))
        if e_adj or e_tri:
            raise RuntimeError(f"window {w} (K={k}): kernels differ from the twins "
                               f"({e_adj}, {e_tri})")
        adj_err, tri_err = max(adj_err, e_adj), max(tri_err, e_tri)
        checked += 1
    return checked, adj_err, tri_err


# ---------------------------------------------------------------------------
# phase 5: the first port slice's kernels, for the in-turn comparison

_P, _I = ctypes.c_void_p, ctypes.c_int
BASELINE_SIGNATURES = {
    "pane_adjacency_launch": [_P, _P, _I, _P, _I, _P],
    "dense_triangles_launch": [_P, _I, _P, _P],
}


def load_baseline(path: str):
    from gelly_streaming_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(_cuda.build_all([path])[path].path))
    for name, argtypes in BASELINE_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def baseline_wrappers(lib):
    """The first slice's two wrappers over ``lib``: they zero the outputs
    with ``torch.zeros`` and launch."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    def adjacency(words, n, k):
        bits = torch.zeros((k, k // 32), dtype=torch.int32, device=words.device)
        stream = torch.cuda.current_stream(words.device).cuda_stream
        _cuda.check(lib.pane_adjacency_launch(words.data_ptr(), n.data_ptr(),
                                              words.shape[0], bits.data_ptr(), k, stream),
                    "baseline pane_adjacency")
        return bits

    def dense(bits):
        total = torch.zeros((1,), dtype=torch.int64, device=bits.device)
        stream = torch.cuda.current_stream(bits.device).cuda_stream
        _cuda.check(lib.dense_triangles_launch(bits.data_ptr(), bits.shape[0],
                                               total.data_ptr(), stream),
                    "baseline dense_triangles")
        return total

    return adjacency, dense


# ---------------------------------------------------------------------------
# phases 6-7: the union-find kernels and the streaming CC main path


def uf_bound_ms(n_edges: int, capacity: int) -> tuple:
    """Least device time (ms) of each kernel of one fold of n_edges into a
    capacity-C state at the HBM rate: (union kernel, compress kernel).  The
    union kernel reads src/dst (8 B an edge) and parent (4 B a vertex) and
    writes seen (1 B a vertex); the entries it lowers are few on a late
    batch and are counted in compress's row, which reads and writes parent
    (4 B a vertex each way).  The whole call's bound is the sum."""
    union = (8 * n_edges + 5 * capacity) / HBM_BYTES_PER_S * 1e3
    return union, 8 * capacity / HBM_BYTES_PER_S * 1e3


def uf_forest(rng, c: int) -> np.ndarray:
    """A forest over [0, c) whose roots are not the smallest ids of their
    trees: in a random order, 70% of the vertices join under a random
    earlier vertex."""
    order = rng.permutation(c)
    parent = np.arange(c, dtype=np.int32)
    k = np.nonzero(rng.random(c) < 0.7)[0]
    k = k[k > 0]
    parent[order[k]] = order[(rng.random(len(k)) * k).astype(np.int64)]
    return parent


def uf_cases(rng, c: int, n: int):
    """(name, src, dst, mask | None, starting parent) of each adversarial
    fold, at the main path's shapes."""
    ident = np.arange(c, dtype=np.int32)
    mask = np.ones(n, bool)
    mask[n - 3 * n // 8 :] = False
    hub = int(rng.integers(0, c))
    top = np.full(n // 2, c - 1)
    path = np.arange(c - 1)
    order = rng.permutation(c - 1)
    zipf = lambda: (rng.zipf(1.3, n) - 1) % c  # noqa: E731
    loops = rng.integers(0, c, n)
    return [
        ("uniform", rng.integers(0, c, n), rng.integers(0, c, n), None, ident),
        ("star", np.full(c - 1, hub), np.delete(np.arange(c), hub), None, ident),
        ("Zipf", zipf(), zipf(), None, ident),
        (f"{c}-vertex path, reverse order", path[::-1], path[::-1] + 1, None, ident),
        (f"{c}-vertex path, shuffled", order, order + 1, None, ident),
        ("self-loops", loops, loops, None, ident),
        ("masked tail", rng.integers(0, c, n), rng.integers(0, c, n), mask, ident),
        ("ids at capacity - 1", np.concatenate([top, rng.integers(0, c, n // 2)]),
         np.concatenate([rng.integers(0, c, n // 2), top]), None, ident),
        ("non-minimum-root forest", rng.integers(0, c, n), rng.integers(0, c, n), None, uf_forest(rng, c)),
    ]


def phase_union(dev, rng):
    """The union kernel against its twin on every adversarial case; returns
    (max |parent err| + |seen err|, per-case kernel ms)."""
    import torch

    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c, n = CC_VERTICES, CC_BATCH
    uf.compress(uf.init_parent(16, dev))  # load the library outside the timed calls
    worst = 0
    for name, u, v, m, parent0 in uf_cases(rng, c, n):
        s, d = to_dev((np.ascontiguousarray(u, np.int32), np.ascontiguousarray(v, np.int32)), dev)
        mask = None if m is None else to_dev((m,), dev)[0]
        p0 = torch.from_numpy(parent0).to(dev)
        seen0 = torch.zeros(c, dtype=torch.bool, device=dev)
        want = {}
        twin_ms = cuda_ms(lambda: want.update(r=uf.union_edges_with_seen_plain(p0, seen0, s, d, mask)), 1, 0)
        p, sn = p0.clone(), seen0.clone()
        kern_ms = cuda_ms(lambda: uf.union_edges_with_seen(p, sn, s, d, mask), 1, 0)
        err = int((p.long() - want["r"][0].long()).abs().max()) + int((sn != want["r"][1]).sum())
        worst = max(worst, err)
        if err:
            raise RuntimeError(f"union kernel {name}: differs from the twin ({err})")
        log(f"  union {name}: {len(u)} edges, parent and seen equal to the twin; kernel "
            f"{kern_ms:.4f} ms, twin {twin_ms:.3f} ms, {len(torch.unique(p))} roots")
    a0 = torch.from_numpy(uf_forest(rng, c)).to(dev)
    b0 = torch.from_numpy(uf_forest(rng, c)).to(dev)
    want = uf.merge_parents_plain(a0, b0)
    a = a0.clone()
    kern_ms = cuda_ms(lambda: uf.merge_parents(a, b0), 1, 0)
    err = int((a.long() - want.long()).abs().max())
    worst = max(worst, err)
    if err:
        raise RuntimeError("merge_parents kernel differs from the twin")
    log(f"  merge_parents of two non-minimum-root forests: equal to the twin; kernel {kern_ms:.4f} ms")
    return worst


def union_device_ms(parent, seen, s, d, reps: int, cycles_per_ms: float):
    """(device ms, host enqueue us) per ``union_edges_with_seen`` call,
    each call folding (s, d) into its own fresh copy of (parent, seen);
    the calls are enqueued while ``torch.cuda._sleep`` holds the stream."""
    import torch

    from gelly_streaming_tpu_torch.ops import unionfind as uf

    hold_ms = 2.0
    for _ in range(4):
        copies = [(parent.clone(), seen.clone()) for _ in range(reps)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for p, sn in copies:
            uf.union_edges_with_seen(p, sn, s, d)
        host_s = time.perf_counter() - t0
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps, host_s / reps * 1e6
        hold_ms *= 4
    raise RuntimeError("the host could not enqueue the timed folds inside the hold")


def union_kernel_profile(parent, seen, s, d, reps: int):
    """torch.profiler device us per launch of the union and compress
    kernels over ``reps`` folds into fresh state copies: {kernel: us}."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    copies = iter([(parent.clone(), seen.clone()) for _ in range(reps + 1)])
    rows = profiler_device_us(lambda: uf.union_edges_with_seen(*next(copies), s, d), reps)
    found = {}
    for key, (us, _calls) in rows.items():
        for kernel in ("union_kernel", "compress_kernel"):
            if kernel in key:
                found[kernel] = us
    return found


def cc_oracle(src, dst, capacity: int):
    """(parent, seen) the CC fold must reach, by scipy: every vertex labelled
    with the smallest id of its component; seen = touched by an edge."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    g = coo_matrix((np.ones(len(src), np.int32), (src, dst)), shape=(capacity, capacity)).tocsr()
    _, labels = connected_components(g, directed=False)
    smallest = np.full(labels.max() + 1, capacity, np.int64)
    np.minimum.at(smallest, labels, np.arange(capacity))
    seen = np.zeros(capacity, bool)
    seen[src] = True
    seen[dst] = True
    return smallest[labels].astype(np.int32), seen


def phase_cc_main(dev, cycles_per_ms: float) -> dict:
    """The streaming CC main path at bench.py's size, checked against the
    twin and scipy; returns the numbers for the report."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.io.prefetch import upload
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    num_edges = nb * batch
    rng = np.random.default_rng(0)
    src = rng.integers(0, c, num_edges).astype(np.int32)
    dst = rng.integers(0, c, num_edges).astype(np.int32)
    width = wire.replay_width(c, batch)
    t0 = time.perf_counter()
    bufs, tail = wire.pack_stream(src, dst, batch, width)
    pack_s = time.perf_counter() - t0
    if tail is not None:
        raise RuntimeError("the bench stream is whole batches")
    wire_bytes = sum(b.nbytes for b in bufs)
    log(f"  {nb} batches of {batch} edges over {c} vertices, width {width}: {wire_bytes / num_edges:.4f} "
        f"wire B/edge, packed in {pack_s:.1f} s (host numpy, untimed)")
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch)
    agg = ConnectedComponents()
    # warm the path (allocator, pinned pool, the library's first load)
    EdgeStream.from_wire(bufs[:1], batch, width, cfg, device=dev).aggregate(agg).collect()
    torch.cuda.synchronize()
    stream = EdgeStream.from_wire(bufs, batch, width, cfg, device=dev)
    if not agg._wire_eligible(stream):
        raise RuntimeError("the main path must ride the wire path")

    uf.reset_launches()
    t0 = time.perf_counter()
    records = stream.aggregate(agg).collect()
    ds = records[-1][0]
    parent, seen = ds.parent.cpu().numpy(), ds.seen.cpu().numpy()
    wall_s = time.perf_counter() - t0
    launches = dict(uf.LAUNCHES)
    if len(records) != 1:
        raise RuntimeError(f"expected one end-of-stream record, got {len(records)}")
    if min(launches.values()) < nb:
        raise RuntimeError(f"the union-find kernels were not launched per batch: {launches}")
    log(f"  from_wire(...).aggregate(ConnectedComponents()): {wall_s:.3f} s first buffer -> host "
        f"labels, {num_edges / wall_s:.6g} edges/s end to end")
    log(f"  launches on the main path: {launches}")

    # upload alone: the same buffers through the path's pinned H2D copies
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in bufs:
        upload((b,), dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    log(f"  upload alone: {wire_bytes / upload_s / 1e9:.3f} GB/s ({wire_bytes} B in {upload_s:.3f} s)")

    # reference 1: the plain twin folding the same batches (host-decoded)
    # on the card; its states at the emission points and before the last
    # batch are kept
    t_parent = uf.init_parent(c, dev)
    t_seen = torch.zeros(c, dtype=torch.bool, device=dev)
    snaps = {}
    t0 = time.perf_counter()
    for i, b in enumerate(bufs):
        if i == nb - 1:
            snaps["late"] = (t_parent.clone(), t_seen.clone())
        s, d = to_dev(wire.unpack_edges_host(b, batch, width), dev)
        t_parent, t_seen = uf.union_edges_with_seen_plain(t_parent, t_seen, s, d)
        if (i + 1) % CC_EMIT_EVERY == 0 and i + 1 <= CC_EMIT_BATCHES:
            snaps[i + 1] = (t_parent.clone(), t_seen.clone())
    torch.cuda.synchronize()
    twin_fold_s = time.perf_counter() - t0
    err = int(np.abs(parent.astype(np.int64) - t_parent.cpu().numpy()).max())
    err += int((seen != t_seen.cpu().numpy()).sum())
    if err:
        raise RuntimeError(f"final labels differ from the twin's fold ({err})")
    # reference 2: scipy, independent of both
    t0 = time.perf_counter()
    o_parent, o_seen = cc_oracle(src, dst, c)
    oracle_s = time.perf_counter() - t0
    if not (np.array_equal(parent, o_parent) and np.array_equal(seen, o_seen)):
        raise RuntimeError("final labels differ from scipy's connected components")
    n_comp = len(np.unique(parent[seen]))
    log(f"  final labels exact: equal to the twin's fold on the card ({twin_fold_s:.1f} s) and to "
        f"scipy ({oracle_s:.1f} s); {int(seen.sum())} seen vertices in {n_comp} components")

    # running emissions: a from_arrays prefix, packed on the path's thread
    k = CC_EMIT_BATCHES * batch
    ecfg = StreamConfig(vertex_capacity=c, batch_size=batch, ingest_window_edges=CC_EMIT_EVERY * batch)
    estream = EdgeStream.from_arrays(src[:k], dst[:k], ecfg, device=dev)
    if not agg._wire_eligible(estream):
        raise RuntimeError("the running-emission stream must ride the wire path")
    emitted = estream.aggregate(agg).collect()
    if len(emitted) != CC_EMIT_BATCHES // CC_EMIT_EVERY:
        raise RuntimeError(f"expected {CC_EMIT_BATCHES // CC_EMIT_EVERY} emissions, got {len(emitted)}")
    for j, (rec,) in enumerate(emitted):
        want_p, want_s = snaps[(j + 1) * CC_EMIT_EVERY]
        if not (torch.equal(rec.parent, want_p) and torch.equal(rec.seen, want_s)):
            raise RuntimeError(f"running emission {j} differs from the twin's fold")
    log(f"  from_arrays + ingest_window_edges={ecfg.ingest_window_edges}: {len(emitted)} running emissions, each equal "
        f"to the twin's fold of its prefix (width {agg._wire_width(ecfg, batch)})")

    # device time of one batch's fold, first and late
    s0, d0 = wire.unpack_edges(to_dev((bufs[0],), dev)[0], batch, width)
    sl, dl = wire.unpack_edges(to_dev((bufs[-1],), dev)[0], batch, width)
    init = (uf.init_parent(c, dev), torch.zeros(c, dtype=torch.bool, device=dev))
    late = snaps["late"]
    first_ms, first_us = union_device_ms(*init, s0, d0, UF_REPS, cycles_per_ms)
    late_ms, late_us = union_device_ms(*late, sl, dl, UF_REPS, cycles_per_ms)
    twin_first_ms = cuda_ms(lambda: uf.union_edges_with_seen_plain(*init, s0, d0), 1, 0)
    twin_late_ms = cuda_ms(lambda: uf.union_edges_with_seen_plain(*late, sl, dl), 1, 0)
    compress_twin_ms = cuda_ms(lambda: uf.compress_plain(late[0]), 1, 0)
    # each kernel's held-stream time: the call with no edges is compress
    # alone, and the union kernel is the rest of the call
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    comp_ms, comp_us = union_device_ms(*late, none, none, UF_REPS, cycles_per_ms)
    held = {"union_kernel": (late_ms - comp_ms, late_us - comp_us), "compress_kernel": (comp_ms, comp_us)}
    per_kernel, split_by = {}, "torch.profiler"
    try:
        per_kernel = union_kernel_profile(*late, sl, dl, 10)
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    if len(per_kernel) < 2:
        per_kernel = {k: ms * 1e3 for k, (ms, _) in held.items()}
        split_by = "held-stream times (the profiler showed no kernel rows)"
    buf_dev = to_dev((bufs[-1],), dev)[0]
    unpack_ms, unpack_us = device_ms(lambda: wire.unpack_edges(buf_dev, batch, width), UF_REPS, cycles_per_ms)
    b_union, b_compress = uf_bound_ms(batch, c)
    share = (first_ms + (nb - 1) * late_ms) / (wall_s * 1e3)
    busy = share + nb * unpack_ms / (wall_s * 1e3)
    log(f"  one batch's fold (uf_union_launch: union + compress), device only: first batch "
        f"{first_ms:.4f} ms, late batch {late_ms:.4f} ms; host enqueue {first_us:.2f} / {late_us:.2f} us; "
        f"bound {b_union + b_compress:.5f} ms (bytes)")
    log(f"  per kernel on the late batch, by {split_by}: union_kernel "
        f"{per_kernel['union_kernel']:.2f} us, compress_kernel {per_kernel['compress_kernel']:.2f} us a launch; "
        f"held stream: compress alone {comp_ms * 1e3:.2f} us, the call minus it "
        f"{held['union_kernel'][0] * 1e3:.2f} us; bounds {b_union * 1e3:.3f} / {b_compress * 1e3:.3f} us")
    log(f"  plain twin: first batch {twin_first_ms:.3f} ms, late batch {twin_late_ms:.3f} ms, "
        f"compress_plain {compress_twin_ms:.3f} ms (host loop, syncs included)")
    log(f"  the kernels' share of the wall time: {share * 100:.2f}% (the first batch's fold + "
        f"{nb - 1} x the late batch's, over the wall time)")
    log(f"  EF40 unpack (PyTorch ops) a batch: device {unpack_ms:.4f} ms, host enqueue {unpack_us:.1f} us; "
        f"device busy (unpack + fold) ~{busy * 100:.1f}% of the wall time, idle ~{(1 - busy) * 100:.1f}%")
    return {
        "launches": launches,
        "union_ms": per_kernel["union_kernel"] / 1e3,
        "compress_ms": per_kernel["compress_kernel"] / 1e3,
        "held": held,
        "union_plain_ms": twin_late_ms,
        "compress_plain_ms": compress_twin_ms,
        "union_bound_ms": b_union,
        "compress_bound_ms": b_compress,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-cu", default=None,
                        help="a pane_triangles.cu with the first slice's C interface, "
                             "timed in turns with the current kernels")
    args = parser.parse_args(argv)
    baseline_cu = os.path.abspath(args.baseline_cu) if args.baseline_cu else None
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    try:
        from gelly_streaming_tpu_torch.core.config import StreamConfig
        from gelly_streaming_tpu_torch.core.stream import EdgeStream
        from gelly_streaming_tpu_torch.core.windows import windowed_panes
        from gelly_streaming_tpu_torch.io.prefetch import upload
        from gelly_streaming_tpu_torch.library import triangles as tri
        from gelly_streaming_tpu_torch.ops import _cuda
        from gelly_streaming_tpu_torch.ops import dense_triangles as dt
        from gelly_streaming_tpu_torch.utils.metrics import WindowLatencyRecorder
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 1: build kernels")
    t0 = time.perf_counter()
    sources = [*_cuda.SIGNATURES, *([baseline_cu] if baseline_cu else [])]
    built = _cuda.build_all(sources)
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.2f} s")
    for src, res in built.items():
        for line in res.log.splitlines():
            if "ptxas" in line:
                log(f"  {src}: {line.strip()}")

    rng = np.random.default_rng(0)
    log("phase 2: pane_adjacency vs plain twin")
    adj_err = phase_adjacency(dev, rng)
    log("phase 3: dense_triangles vs plain twin and numpy")
    tri_err = phase_dense(dev, rng)

    log("phase 4: main path, window_triangles on the card")
    itcase = [(1, 2, 100), (1, 3, 150), (3, 2, 200), (2, 4, 250), (3, 4, 300),
              (3, 5, 350), (4, 5, 400), (4, 6, 450), (6, 5, 500), (5, 7, 550),
              (6, 7, 600), (8, 6, 650), (7, 8, 700), (7, 9, 750), (8, 9, 800),
              (10, 8, 850), (9, 10, 900), (9, 11, 950), (10, 11, 1000)]
    golden = EdgeStream.from_collection(
        [(s, d, 0, t) for s, d, t in itcase], StreamConfig(vertex_capacity=16),
        batch_size=4, with_time=True, device=dev,
    )
    got = sorted(tri.window_triangles(golden, 400).collect())
    if got != [(2, 399), (2, 1199), (3, 799)]:
        raise RuntimeError(f"ITCase golden mismatch: {got}")
    log("  ITCase golden (2,399) (3,799) (2,1199): ok")

    stream, panes = main_path_stream(rng, dev)
    expected = [
        (plain_pane_count(s, d, dev), (w + 1) * WINDOW_MS - 1)
        for w, (s, d) in enumerate(panes)
    ]
    # warm the path (allocator, pinned pool) outside the counted run
    tri.window_triangles(stream, WINDOW_MS).collect()
    torch.cuda.synchronize()
    dt.reset_launches()
    t0 = time.perf_counter()
    records = tri.window_triangles(stream, WINDOW_MS).collect()
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(dt.LAUNCHES)
    if records != expected:
        raise RuntimeError(f"window counts differ:\n got {records}\n want {expected}")
    if min(launches.values()) <= 0:
        raise RuntimeError(f"a kernel was not launched on the main path: {launches}")
    n_edges = sum(len(p[0]) for p in panes)
    log(f"  {len(records)} windows exact vs plain twins; counts {[r[0] for r in records]}")
    log(f"  launches on the main path: {launches}")
    log(f"  window_triangles: {main_s * 1e3:.1f} ms for {len(panes)} windows, "
        f"{len(panes) / main_s:.1f} panes/s, {n_edges / main_s:.4g} edges/s")
    checked, e_adj, e_tri = check_windows(panes, dev)
    adj_err, tri_err = max(adj_err, e_adj), max(tri_err, e_tri)
    log(f"  {checked} dense windows: pane_adjacency, dense_triangles and pane_triangles "
        f"bit-equal to the twins ({len(panes) - checked} CSR window runs no kernel)")

    # where a window's time goes: the host time plane (batches read back
    # and cut into panes), host pane prep, then upload + kernels + readback
    t0 = time.perf_counter()
    host_panes = list(windowed_panes(stream, WINDOW_MS))
    t_cut = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = [tri._pane_prepare((p.src, p.dst), dev) for p in host_panes]
    t_prep = time.perf_counter() - t0
    t0 = time.perf_counter()
    for meta, arrays in prepared:
        tri._pane_triangle_finish(tri._pane_dispatch(meta, upload(arrays, dev)))
    t_dev = time.perf_counter() - t0
    log(f"  per window: pane cut {t_cut / len(panes) * 1e3:.3f} ms, host prep "
        f"{t_prep / len(panes) * 1e3:.3f} ms, upload+count+readback "
        f"{t_dev / len(panes) * 1e3:.3f} ms")

    rec, dev_rec = WindowLatencyRecorder(), WindowLatencyRecorder()
    t0 = time.perf_counter()
    counts = tri.pipelined_pane_counts(
        panes, recorder=rec, warmup=1, depth=4, device_recorder=dev_rec, device=dev
    )
    pipe_s = time.perf_counter() - t0
    if counts != [c for c, _ in expected]:
        raise RuntimeError(f"pipelined counts differ: {counts}")
    log(f"  pipelined_pane_counts depth=4: {len(panes) / pipe_s:.1f} panes/s, "
        f"{n_edges / pipe_s:.4g} edges/s, close->host p50 {rec.percentile(50):.3f} ms "
        f"p95 {rec.percentile(95):.3f} ms, close->device p50 {dev_rec.percentile(50):.3f} ms")

    log("phase 5: kernel times at the main path's shapes")
    cpm = sleep_cycles_per_ms()
    log(f"  torch.cuda._sleep: {cpm:.0f} cycles per ms")
    src0, dst0 = panes[0]
    num_vertices = int(max(src0.max(), dst0.max())) + 1
    k = dt.pane_k(num_vertices)
    w, n = dt.pack_pane(src0, dst0)
    words, nn = to_dev(dt.packed_host_arrays(w, n), dev)
    bits = dt.pane_adjacency(words, nn, k)
    total = int(dt.dense_triangles(bits)[0])
    adj_err = max(adj_err, word_err(bits, dt.pane_adjacency_plain(words, nn, k)))
    tri_err = max(tri_err, abs(total - int(dt.dense_triangles_plain(bits)[0])))
    if adj_err or tri_err:
        raise RuntimeError(f"kernels disagree with their twins: {adj_err}, {tri_err}")
    adj = dt.unpack_bits(bits)
    nnz = int(adj.sum())
    # the oriented count's work: for each edge i < j, 2 ops a column above
    # j, and the bytes of row j from word j/32 on
    deg_below = torch.triu(adj, 1).sum(0, dtype=torch.int64)
    cols = torch.arange(k, device=dev)
    oriented_ops = int((2 * deg_below * (k - 1 - cols)).sum())
    suffix_bytes = int((deg_below * 4 * (k // 32 - cols // 32)).sum())

    def adj_fn():
        return dt.pane_adjacency(words, nn, k)

    def tri_fn():
        return dt.dense_triangles(bits)

    def pane_fn():
        return dt.pane_triangles(words, nn, k)

    def submit_fn():
        return dt.pane_triangles_submit_packed(words, nn, num_vertices)

    timed = {}
    for name, fn in (("pane_adjacency", adj_fn), ("dense_triangles", tri_fn),
                     ("pane_triangles", pane_fn)):
        d_ms, h_us = device_ms(fn, TIMED_REPS, cpm)
        timed[name] = (cuda_ms(fn, TIMED_REPS), d_ms, h_us)
        log(f"  K={k} {name}: device {d_ms:.5f} ms, host enqueue {h_us:.2f} us/call, "
            f"back-to-back events {timed[name][0]:.5f} ms")
    # the main path's call: its pinned readback buffer is not held under a
    # stalled stream, so it is timed back to back only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED_REPS):
        submit_fn()
    submit_us = (time.perf_counter() - t0) / TIMED_REPS * 1e6
    torch.cuda.synchronize()
    log(f"  K={k} pane_triangles_submit_packed (one C call + readback): host "
        f"{submit_us:.2f} us/call, back-to-back events {cuda_ms(submit_fn, TIMED_REPS):.5f} ms")
    adj_plain_ms = cuda_ms(lambda: dt.pane_adjacency_plain(words, nn, k), 10)
    tri_plain_ms = cuda_ms(lambda: dt.dense_triangles_plain(bits), 10)
    a8 = adj.to(torch.int8)

    def int_mm():
        return (torch._int_mm(a8, a8) * a8).sum(dtype=torch.int64)

    if int(int_mm()) != total:
        raise RuntimeError("the _int_mm yardstick disagrees with the kernel")
    lib_ms = cuda_ms(int_mm, 20)
    adj_bound = (int(n) * 4 + 4 + k * k // 8) / HBM_BYTES_PER_S * 1e3
    tri_bytes_ms = (k * k // 8 + 8) / HBM_BYTES_PER_S * 1e3
    tri_ops_ms = oriented_ops / INT8_OPS_PER_S * 1e3
    log(f"  pane K={k}, n={int(n)} words, nnz(A)={nnz}, total={total}, oriented ops "
        f"{oriented_ops} (all ordered pairs: 2*nnz*K = {2 * nnz * k}, "
        f"{2.0 * nnz * k / INT8_OPS_PER_S * 1e3:.6f} ms at the int8 peak), "
        f"row-j suffix bytes of the oriented count {suffix_bytes}")
    log(f"  plain twins: pane_adjacency {adj_plain_ms:.4f} ms, dense_triangles "
        f"{tri_plain_ms:.4f} ms; _int_mm yardstick {lib_ms:.4f} ms")
    dev_share = (timed["pane_triangles"][1] * launches["dense_triangles"]) / (main_s * 1e3)
    log(f"  the pane count's device time at K={k} x {launches['dense_triangles']} launches = "
        f"{dev_share * 100:.3f}% of window_triangles' wall time")
    try:
        rows = profiler_device_us(pane_fn, 20)
        if rows:
            for key, (us, calls) in sorted(rows.items(), key=lambda r: -r[1][0])[:6]:
                log(f"  torch.profiler: {us:.3f} us/call device time, {calls} calls: {key[:90]}")
        else:
            log("  torch.profiler: key_averages() shows no device time")
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")

    # other widths and skewed panes: (name, words, n, K)
    panes5 = [(f"K={k}", words, nn, k)]
    for kk in (8192, 16384):
        panes5.append((f"K={kk}", *to_dev(seeded_pane_words(rng, kk, PANE_EDGES), dev), kk))
    panes5.append(("star K=4096", *to_dev(edge_words(rng, 4096, *star_edges(rng, 4096)), dev), 4096))
    panes5.append(("Zipf K=4096", *to_dev(
        edge_words(rng, 4096, *zipf_edges(rng, 4096, PANE_EDGES)), dev), 4096))
    for name, wk, nk, kk in panes5[1:]:
        bk = dt.pane_adjacency(wk, nk, kk)
        a_ms, _ = device_ms(lambda: dt.pane_adjacency(wk, nk, kk), 50, cpm)
        t_ms, _ = device_ms(lambda: dt.dense_triangles(bk), 50, cpm)
        log(f"  {name}: device pane_adjacency {a_ms:.5f} ms, dense_triangles {t_ms:.5f} ms "
            f"(nnz {int(dt.unpack_bits(bk).sum())})")

    if baseline_cu:
        log(f"phase 5b: in turns with the baseline build {args.baseline_cu}")
        old_adj, old_tri = baseline_wrappers(load_baseline(baseline_cu))
        for label, wk, nk, kk in panes5:
            bk = dt.pane_adjacency(wk, nk, kk)
            if word_err(old_adj(wk, nk, kk), bk) or int(old_tri(bk)[0]) != int(dt.dense_triangles(bk)[0]):
                raise RuntimeError(f"baseline and current kernels disagree on {label}")
            pairs = {
                "pane_adjacency": (lambda: old_adj(wk, nk, kk), lambda: dt.pane_adjacency(wk, nk, kk)),
                "dense_triangles": (lambda: old_tri(bk), lambda: dt.dense_triangles(bk)),
            }
            for name, (old_fn, new_fn) in pairs.items():
                turns = []
                for tag, fn in (("baseline", old_fn), ("current", new_fn),
                                ("current", new_fn), ("baseline", old_fn)):
                    d_ms, h_us = device_ms(fn, TIMED_REPS, cpm)
                    turns.append((tag, d_ms, h_us, cuda_ms(fn, TIMED_REPS)))
                log(f"  {label} {name}: " + "; ".join(
                    f"{tag} device {d:.5f} ms host {h:.2f} us events {e:.5f} ms"
                    for tag, d, h, e in turns))

    log("phase 6: union-find kernels vs plain twin at 2^20 vertices")
    uf_err = phase_union(dev, rng)
    log("phase 7: main path, streaming CC over the EF40 wire replay on the card")
    cc = phase_cc_main(dev, cpm)

    kernels = [
        {
            "name": "pane_adjacency",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/pane_triangles.cu",
            "replaces": "gelly_streaming_tpu/ops/pallas_triangles.py:134",
            "launches": launches["pane_adjacency"],
            "max_abs_err": adj_err,
            "ms": timed["pane_adjacency"][0],
            "device_ms": timed["pane_adjacency"][1],
            "host_us": timed["pane_adjacency"][2],
            "plain_ms": adj_plain_ms,
            "bound_ms": adj_bound,
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "dense_triangles",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/pane_triangles.cu",
            "replaces": "gelly_streaming_tpu/ops/pallas_triangles.py:38",
            "launches": launches["dense_triangles"],
            "max_abs_err": tri_err,
            "ms": timed["dense_triangles"][0],
            "device_ms": timed["dense_triangles"][1],
            "host_us": timed["dense_triangles"][2],
            "plain_ms": tri_plain_ms,
            "bound_ms": max(tri_bytes_ms, tri_ops_ms),
            "bound_by": "operations" if tri_ops_ms >= tri_bytes_ms else "bytes",
            "library_ms": lib_ms,
        },
        {
            "name": "union_kernel",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/unionfind.cu",
            "replaces": "gelly_streaming_tpu/ops/unionfind.py:59",
            "launches": cc["launches"]["union_kernel"],
            "max_abs_err": uf_err,
            "ms": cc["union_ms"],
            "device_ms": cc["held"]["union_kernel"][0],
            "host_us": cc["held"]["union_kernel"][1],
            "plain_ms": cc["union_plain_ms"],
            "bound_ms": cc["union_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "compress_kernel",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/unionfind.cu",
            "replaces": "gelly_streaming_tpu/ops/unionfind.py:27",
            "launches": cc["launches"]["compress_kernel"],
            "max_abs_err": uf_err,
            "ms": cc["compress_ms"],
            "device_ms": cc["held"]["compress_kernel"][0],
            "host_us": cc["held"]["compress_kernel"][1],
            "plain_ms": cc["compress_plain_ms"],
            "bound_ms": cc["compress_bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        },
    ]
    log(f"  total smoke time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
