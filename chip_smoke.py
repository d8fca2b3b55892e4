#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (gelly_streaming_tpu_torch).

    python3 chip_smoke.py [--baseline-cu PATH] [--parent-degrees-cu PATH] [--parent-unionfind-cu PATH]
                          [--parent-sage-cu PATH] [--parent-neighborhoods-cu PATH]
                          [--parent-sage-backward-cu PATH]

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

Phases 8-10 drive the GraphStream surface on the same stream (packing
runs on host threads, untimed).  Phase 8: ``EdgeStream.from_arrays(...)
.get_degrees()`` over all 104,857,600 edges (209,715,200 records,
downloaded packed); every vertex's final degree must equal ``np.bincount``
and the first batches' records the twin's; ``get_in_degrees``,
``number_of_vertices``, ``number_of_edges`` and ``get_vertices`` on an
8-batch prefix and ``undirected().distinct()`` on a 2-batch prefix must
equal numpy.  Phase 9: ``DegreeDistributionSummary`` over the EF40 replay
(deg equal to ``np.bincount``), ``DegreeDistribution`` over 2^20 signed
events on 2^16 vertices in batches of 2^15 (equal to a host oracle written
as the reference's three keyed stages) and over a run at capacity 2^10
whose hubs pass it (equal to the CPU path), then uncut over the CC bench's
stream with signs (about 30% deletions) in batches of 2^21: events/s and
records/s end to end, every batch's records equal to the twin on the card,
the first batch's to the one-thread kernel, the final histogram to
``np.bincount`` of the final degrees.  The two-stage scan and the one-thread
kernel are timed in turns at 2^15 and 2^21 events, the two stable sorts
apart.  Phase 10: ``BipartitenessCheck`` over an even -> odd
EF40 stream of the bench's shape (bipartite; sides differ across every
edge; components equal to scipy's) and over the uniform stream
(``(false,{})``), and a timed windowed run whose every emission must equal
the CPU path's.  Each new kernel (``degree_trace``, ``degree_fold``,
``degree_dist_scan``, ``parity_union_kernel``) must launch once a batch on
its main path and equal its twin; ``index_add_`` is timed beside
``degree_fold`` as the library call.

Phases 6-10 also hold the kernels against their twins with ids -1, C and
C + 5 on some rows of the main path's batches (unvalidated streams may
carry them; the port follows JAX's index rules), and print the union
calls' hook and doubling round counts on a first and a late batch.  The
main path's first fold compresses the fresh state; later folds find it
known flat and skip the compress kernel.  Phase 11, with
``--parent-degrees-cu`` / ``--parent-unionfind-cu`` (those sources as they
were before their redesign, with that C interface), times the parent's
degree_trace (kernel alone and the whole call) and union calls (first and
late batch, CC and parity) in turns with the current ones on the held
stream, and splits the parent's degree_trace kernel: variants built from
its source with one part taken out each (the scattered record stores, the
segment searches, the int64 order read, the mask-bit loop, the counts
gather, phase 2 and its grid sync), each timed in turns with it.

Phase 12 drives ``slice()`` and windowed GraphSAGE at the repo's width (F_in
= F_out = 128, bench.py:2762) over the CC bench's vertex count: 8 count-cut
panes of 2^21 uniform edges over 2^20 vertices and one hub pane (a star of
2^17 beside Zipf edges), ``EdgeStream.from_arrays(...).slice(window,
EdgeDirection.ALL)`` into ``GraphSAGEWindows(params, features).run``.
Windows/s, edges/s and embeddings/s end to end; every pane's
``build_buckets`` (``csrc/neighborhoods.cu``) equal to its twin on the card
exactly, also with ids -1, C and C + 5, and its radix sort's order equal to
``torch.sort(stable=True)``'s; ``sage_layer`` (``csrc/sage.cu``, the fused
layer) within 2^-7 * |ref| + 2^-9 of its twin (one bf16 step of the output,
plus a one-step change of a mean carried through W ~ N(0, 1/128)), the
buckets of rows that go through the partial-sum kernel reported on their
own; windows 0 and 8 against a float64 oracle (numpy, scipy) of the
grouping and the layer at 2e-2 * (1 + |ref|); a 2-layer stack over 2 panes
against its run on the twins; a ``fold_neighbors`` degree count against
``np.bincount``; both kernels launched on the main path.  On the first
(uniform) and the hub pane it times, on a held stream, the build (radix
sort, count and scatter calls), the radix sort alone,
``torch.sort(stable=True)`` of the same keys (the build's library
yardstick, on no path), the whole call, the layer over the pane's buckets
and ``embedding_bag(mode="mean")`` + ``addmm`` (the layer's yardstick);
with ``--parent-sage-cu`` / ``--parent-neighborhoods-cu`` (those sources
as they were before the fused layer and the radix sort, with that C
interface) the parent's layer (its gather, then ``addmm`` and ReLU) and
build (``torch.sort``, then its count and scatter) in turns with the
current ones (parent, current, current, parent).  Then a window stage by
stage (host pad, upload, build, layer, readback) and the device's busy
share by torch.profiler.

Phase 13 trains GraphSAGE at F = 128 through ``sage_init_train``,
``sample_pairs`` and ``sage_train_step``: (a) the JAX bench's own batch
(bench.py:2762-2812: K = 4096, D = 32, valid with p = 0.8, 2^14 vertices,
Adam at lr 1e-2), 20 steps, step p50, pairs/s, the loss falling, the
device's idle share; (b) every bucket of phase 12's first uniform pane
through ``slice(ALL)`` (~1.03M keys over 2^20 vertices), one step a bucket
for 3 passes, the row-weighted loss a pass falling, then the hub pane's
buckets once (rows past 32 slots), peak memory, ``build_buckets``,
``sage_layer`` and ``sage_layer_backward`` launched on that run (two layer
calls and two backward calls a step); (c) ``sage_layer_backward``
(``csrc/sage.cu``, the layer's weight gradient) against its twin on every
bucket of (a) and (b), dw within 2^-7 * |A|^T |dH| and db within 2^-10 *
sum |dH| (one bf16 step of each A entry carried through the product), two
runs equal bit for bit, and a whole step's loss and gradients against
autograd of the plain twin within rtol 2e-2 and rtol 5e-2 / atol 5e-3;
(d) the backward over the uniform pane's buckets, device only on the
held stream, its bound, the twin, and ``embedding_bag(mode="mean")`` +
``mm(A^T, dH)`` as the yardstick; then over the same steps' contexts (2K
rows a bucket, D = 0; their bound counts the self half's product alone),
both calls' kernels split by torch.profiler (the reduce's share), ptxas'
registers and spills of the tensor-core instantiations, and the forward
``sage_layer`` over the contexts; with ``--parent-sage-backward-cu``
(``sage.cu`` as it was before the tensor-core backward, the same C
interface) the parent's backward over the buckets and over the contexts,
and its layer over the contexts, in turns with the current ones (parent,
current, current, parent).

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
import re
import subprocess
import sys
import threading
import time

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense int8 ops/s
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12  # dense, the tensor cores

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

# phases 8-10 on the CC bench's stream, and the signed degree-distribution runs
PROP_TWIN_BATCHES = 4  # degree trace batches held against the twin
PROP_PREFIX_BATCHES = 8  # prefix for the other property streams
PROP_DISTINCT_BATCHES = 2  # prefix for undirected().distinct()
DD_EVENTS = 1 << 20  # signed events of the DegreeDistribution run
DD_VERTICES = 1 << 16
DD_BATCH = 1 << 15
DD_CAP = 1 << 10  # the capacity run: hubs' degrees pass it
DD_CAP_EVENTS = 1 << 16
BP_WINDOW_EDGES = 1 << 18  # the timed windowed bipartiteness run
BP_WINDOW_VERTICES = 1 << 16

# phase 12, GraphSAGE's main path: the repo's width (bench.py:2762,
# examples/measurements.py:855-857) at the CC bench's vertex count
SAGE_VERTICES = 1 << 20
SAGE_FEATURES = 128
SAGE_PANE_EDGES = 1 << 21
SAGE_PANES = 8  # uniform panes, then one hub pane
SAGE_HUB = 1 << 17  # the hub pane's star
SAGE_TOL = 2e-2  # embeddings: the JAX package's bound between its GraphSAGE planes
# sage_layer against its twin: both round the mean once to bf16 (at most one
# bf16 step apart where the f32 sums' order flips a rounding; a one-step
# change of a mean carried through W ~ N(0, 1/128) stays below 2^-9) and the
# output once (one bf16 step, 2^-7 of the value, where the products' order
# flips it)
SAGE_TWIN_RTOL, SAGE_TWIN_ATOL = 2.0 ** -7, 2.0 ** -9
# the mean alone against the twin's (W = [0; I], no bias, a table of values
# >= 1): one bf16 step of the mean, which a dropped or doubled chunk of a hub
# row's sum would pass by far (the layer check above cannot see the mean at
# a hub row: there it moves the output by about its own tolerance)
SAGE_MEAN_RTOL, SAGE_MEAN_ATOL = 2.0 ** -7, 1e-6
SAGE_REPS = 20
# the layer alone at other widths (F_in, F_out) over the uniform pane's
# buckets: wgmma with W's columns padded to 64, several n-tiles, K chunks;
# the CUDA cores at the 602 features of the GraphSAGE paper's Reddit graph
SAGE_WIDTHS = ((256, 256), (640, 128), (64, 40), (602, 41))
SAGE_HUB_REPS = 10  # the hub pane's 21 buckets: keep the held stream under ~1000 launches

# phase 13, GraphSAGE training: the JAX bench's own batch (bench.py:2762-2812:
# K = 4096 keys of D = 32 slots, valid with p = 0.8, features normal over
# 2^14 vertices, F = 128, optax.adam(1e-2)), then every bucket of phase 12's
# first uniform pane and, once, of its hub pane
TRAIN_BENCH_K, TRAIN_BENCH_D, TRAIN_BENCH_C = 4096, 32, 1 << 14
TRAIN_LR = 1e-2
TRAIN_BENCH_STEPS = 20
TRAIN_PASSES = 3  # one step a bucket a pass over the uniform pane
# sage_layer_backward against its twin: both rebuild A = [x_self | mean] in
# bf16, a mean at most one bf16 step apart (the kernel multiplies by the
# count's reciprocal, the twin divides); carried through the product that
# is 2^-7 |A|^T |dH| for dw, and the f32 sums' order (blocks' partials
# against torch's reduction) stays far inside it; db sums dH alone
SAGE_BWD_RTOL, SAGE_BWD_DB_RTOL = 2.0 ** -7, 2.0 ** -10
# a whole step against the twin's autograd: the JAX package's bounds between
# its training planes (tests/test_graphsage.py:164,170-173)
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 2e-2, 5e-2, 5e-3


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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
BASELINE_SIGNATURES = {
    "pane_adjacency_launch": [_P, _P, _I, _P, _I, _P],
    "dense_triangles_launch": [_P, _I, _P, _P],
}


def load_baseline(path: str, signatures=None):
    """``path`` built (or its build reused) and loaded, with the entry
    points of ``signatures`` (default: the first slice's pane kernels)."""
    from gelly_streaming_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(_cuda.build_all([path])[path].path))
    for name, argtypes in (signatures or BASELINE_SIGNATURES).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _cuda.RESTYPES.get(name, ctypes.c_int)
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
# phase 11: the parent commit's degrees.cu and unionfind.cu (before their
# redesign), for the in-turn comparison, and the split of its degree_trace

PARENT_SIGNATURES = {
    # m, sorted keys, order (int64), n, counts, capacity, packed, maskbits, emitted, stream
    "degrees": {"degree_trace_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P]},
    # parent, seen, src, dst, mask, n, capacity, scratch uint8[24 + items], stream
    "unionfind": {"uf_union_launch": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
                  "uf_parity_union_launch": [_P, _P, _P, _P, _P, _I, _I, _P, _P]},
    # (8ebc8a0) sorted keys, n, buckets, tile table, info, offsets, totals, stream; sorted keys, order
    # (int64), n, buckets, tile table, info, offsets, src, dst, keys out, nbrs out, valid out, stream
    "neighborhoods": {"nb_count_launch": [_P, _I, _I, _P, _P, _P, _P, _P],
                      "nb_scatter_launch": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P]},
    # (8ebc8a0) table, C, F, keys, nbrs, valid, K, D, chunk, chunks, vec, out, partial sums, counts, stream
    "sage": {"sage_gather_mean_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]},
    # (ece4aae, the backward on the CUDA cores) the layer: table, C, F_in, keys, nbrs, valid, K, D, w, bias,
    # F_out, out, chunk, chunks, partial sums, counts, stream; the backward's scratch bytes (F_in, F_out);
    # the backward: table, C, F_in, keys, nbrs, valid, K, D, z, dz, F_out, dw, db, chunk, chunks, partial
    # sums, counts, scratch, scratch bytes, stream
    "sage_backward": {
        "sage_layer_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P],
        "sage_layer_backward_scratch_bytes": [_I, _I],
        "sage_layer_backward_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _L,
                                       _P],
    },
}

# The parent's degree_trace_kernel with one part taken out: (old text, new
# text) substitutions in its source, each applied exactly once.
TRACE_SPLIT = {
    "scattered record stores (written at the sorted position)": [
        ("auto* rec = reinterpret_cast<uint16_t*>(packed + 6 * i);",
         "auto* rec = reinterpret_cast<uint16_t*>(packed + 6 * (p + (i < 0)));")],
    "segment searches (rank 0, length 1)": [
        ("const int rank = static_cast<int>(p - segment_start(keys, p, key));", "const int rank = 0;"),
        ("const int len = static_cast<int>(p - segment_start(keys, p, key) + 1);", "const int len = 1;")],
    "int64 order read (a multiplicative permutation of 2^k rows)": [
        ("const int64_t i = __ldg(order + p);", "const int64_t i = (p * 2654435761LL) & (n - 1);")],
    "mask-bit loop": [("if (maskbits != nullptr) {", "if (false) {")],
    "counts gather": [("counts[clamp_index(id, capacity)]", "id")],
    "phase 2 and its grid sync": [
        ("grid.sync();\n  for (int64_t p = first; p < n; p += stride) {\n    const int key = __ldg(keys + p);\n"
         "    if ((key & 1) != 0) continue;",
         "return;\n  for (int64_t p = first; p < n; p += stride) {\n    const int key = __ldg(keys + p);\n"
         "    if ((key & 1) != 0) continue;")],
}


# The current sage.cu's tensor-core backward with one part taken out or
# changed, for the split of its time (phase 13 (d)); the same form.  A
# variant that does not build is reported and skipped.
BACKWARD_SPLIT = {
    "the product (no wgmma: the accumulators dead)": [
        ("        if (mma) {\n          asm volatile(\"wgmma.fence",
         "        if (false) {\n          asm volatile(\"wgmma.fence")],
    "the tensor work alone (the accumulators live through an empty asm)": [
        ('      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "', '      "// "'),
        ('      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "', '      "// "')],
    "the means' gather (the self rows still copied)": [
        ("gather_tile<8, true, false, kBackBatch>(a, r0, k0, kw, s_a, 0, s_red);",
         "gather_tile<8, true, true>(a, r0, k0, kw, s_a, 0, s_red);")],
    "the z and dz copies": [
        ("          copy_zdz(b, r0, rows, n0, ncols, reinterpret_cast<__nv_bfloat16*>(stage + P::kROff));\n", "")],
    "4 rows in flight a lane in the means' gather (8 instead, the forward's)": [
        ("constexpr int kBackBatch = 4;", "constexpr int kBackBatch = 8;")],
}


def split_sources(source: str, split: dict, stem: str) -> dict:
    """{part removed: path of the variant's source}: ``source`` with each
    entry of ``split`` applied, written under the port's build
    directory."""
    from gelly_streaming_tpu_torch.ops import _cuda

    text = open(source).read()
    out_dir = _cuda.BUILD_DIR / "split"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for k, (part, subs) in enumerate(split.items()):
        variant = text
        for old, new in subs:
            if variant.count(old) != 1:
                raise RuntimeError(f"{stem} split {part!r}: {old[:40]!r} found {variant.count(old)} times")
            variant = variant.replace(old, new)
        path = out_dir / f"{stem}_split_{k}.cu"
        path.write_text(variant)
        paths[part] = str(path)
    return paths


def parent_trace(lib, counts, v, m):
    """(kernel alone after a sort made once, the whole call: keys, stable
    sort, kernel) of the parent's degree_trace, packed records."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    n = v.shape[0]
    rec = torch.empty(6 * n, dtype=torch.uint8, device=v.device)
    bits = torch.empty((n + 7) // 8, dtype=torch.uint8, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream

    def launch(keys, order):
        _cuda.check(lib.degree_trace_launch(m.data_ptr(), keys.data_ptr(), order.data_ptr(), n, counts.data_ptr(),
                                            counts.shape[0], rec.data_ptr(), bits.data_ptr(), None, stream),
                    "parent degree_trace_launch")
        return rec, bits

    keys, order = torch.sort((v << 1) | (~m).to(torch.int32), stable=True)

    def call():
        k, o = torch.sort((v << 1) | (~m).to(torch.int32), stable=True)
        return launch(k, o)

    return (lambda: launch(keys, order)), call


def parent_union_fold(lib, parity: bool):
    """The parent's fold (compress, then the union) with its own scratch,
    as its wrapper called it: fold(parent, seen, src, dst)."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    entry = lib.uf_parity_union_launch if parity else lib.uf_union_launch

    def fold(parent, seen, s, d):
        n = d.shape[0]
        scratch = torch.empty(24 + (2 * n if parity else n), dtype=torch.uint8, device=parent.device)
        _cuda.check(entry(parent.data_ptr(), seen.data_ptr(), s.data_ptr(), d.data_ptr(), None, n,
                          parent.shape[0] // 2 if parity else parent.shape[0], scratch.data_ptr(),
                          torch.cuda.current_stream(parent.device).cuda_stream), "parent union")
        return parent, seen

    return fold


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
        ("ids -1, C and C + 5 (JAX's index rules)", oor_ids(rng.integers(0, c, n), c),
         oor_ids(rng.integers(0, c, n), c, 5), None, ident),
    ]


def oor_ids(ids, c: int, shift: int = 0):
    """``ids`` with a spread of rows set to -1, C and C + 5 (what an
    unvalidated stream may carry; JAX's gather and scatter rules apply)."""
    ids = np.array(ids, dtype=np.int64)
    for k, x in enumerate((-1, c, c + 5)):
        ids[shift + k :: 997] = x
    return ids


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


def fold_device_ms(fold, parent, seen, s, d, reps: int, cycles_per_ms: float, flat: bool = False):
    """(device ms, host enqueue us) per ``fold(parent, seen, s, d)`` call,
    each call folding (s, d) into its own fresh copy of (parent, seen);
    the calls are enqueued while ``torch.cuda._sleep`` holds the stream.
    ``flat``: the copies are marked flat, as the state a fold left is on
    the main path (the port's fold then skips compress)."""
    import torch

    from gelly_streaming_tpu_torch.ops import unionfind as uf

    hold_ms = 2.0
    for _ in range(4):
        copies = [((uf.mark_flat(parent.clone()) if flat else parent.clone()), seen.clone()) for _ in range(reps)]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(hold_ms * cycles_per_ms))
        start.record()
        t0 = time.perf_counter()
        for p, sn in copies:
            fold(p, sn, s, d)
        host_s = time.perf_counter() - t0
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps, host_s / reps * 1e6
        hold_ms *= 4
    raise RuntimeError("the host could not enqueue the timed folds inside the hold")


def union_kernel_profile(parent, seen, s, d, reps: int, fold=None):
    """torch.profiler device us per launch of the union and compress
    kernels over ``reps`` calls of ``fold`` (default the CC fold) into
    fresh state copies: {kernel: us}."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    fold = fold or uf.union_edges_with_seen
    copies = iter([(parent.clone(), seen.clone()) for _ in range(reps + 1)])
    rows = profiler_device_us(lambda: fold(*next(copies), s, d), reps)
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


def pack_batches(src, dst, batch: int, width) -> list:
    """Wire buffers of every whole batch, packed by ``io.wire.pack_edges``
    on a pool of host threads (numpy's sorts and copies release the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    from gelly_streaming_tpu_torch.io import wire

    def one(i):
        return wire.pack_edges(src[i * batch : (i + 1) * batch], dst[i * batch : (i + 1) * batch], width)

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(one, range(len(src) // batch)))


def cc_bench_stream() -> dict:
    """The CC bench's stream (bench.py:2190-2192): 50 batches of 2^21
    uniform edges over 2^20 vertices from numpy's default_rng(0), packed
    at ``replay_width`` (EF40) for the wire replay.  Phases 7-10 share it."""
    from gelly_streaming_tpu_torch.io import wire

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    rng = np.random.default_rng(0)
    src = rng.integers(0, c, nb * batch).astype(np.int32)
    dst = rng.integers(0, c, nb * batch).astype(np.int32)
    width = wire.replay_width(c, batch)
    t0 = time.perf_counter()
    bufs = pack_batches(src, dst, batch, width)
    return {"src": src, "dst": dst, "width": width, "bufs": bufs, "pack_s": time.perf_counter() - t0}


def phase_cc_main(dev, cycles_per_ms: float, data: dict) -> dict:
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
    src, dst, width, bufs = data["src"], data["dst"], data["width"], data["bufs"]
    wire_bytes = sum(b.nbytes for b in bufs)
    log(f"  {nb} batches of {batch} edges over {c} vertices, width {width}: {wire_bytes / num_edges:.4f} "
        f"wire B/edge, packed in {data['pack_s']:.1f} s (host numpy threads, untimed)")
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
    # the first batch compresses the fresh state; every later one finds it
    # known flat
    if launches["union_kernel"] != nb or launches["compress_kernel"] != 1:
        raise RuntimeError(f"the union-find kernels were not launched once a batch: {launches}")
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
    fold = uf.union_edges_with_seen
    # the main path's calls: the first batch on a fresh state (compress, then
    # the union), a late one on a state the last fold left flat (the union)
    first_ms, first_us = fold_device_ms(fold, *init, s0, d0, UF_REPS, cycles_per_ms)
    late_ms, late_us = fold_device_ms(fold, *late, sl, dl, UF_REPS, cycles_per_ms, flat=True)
    rounds = {}
    for name, (p0, sn0), (s_, d_), flat in (("first", init, (s0, d0), False), ("late", late, (sl, dl), True)):
        p1 = uf.mark_flat(p0.clone()) if flat else p0.clone()
        fold(p1, sn0.clone(), s_, d_)
        rounds[name] = uf.last_rounds()
    log(f"  the union call's rounds: first batch {rounds['first']}, late batch {rounds['late']}")
    twin_first_ms = cuda_ms(lambda: uf.union_edges_with_seen_plain(*init, s0, d0), 1, 0)
    twin_late_ms = cuda_ms(lambda: uf.union_edges_with_seen_plain(*late, sl, dl), 1, 0)
    compress_twin_ms = cuda_ms(lambda: uf.compress_plain(late[0]), 1, 0)
    # each kernel's held-stream time: the call with no edges is compress
    # alone, and the union kernel is the rest of the call
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    comp_ms, comp_us = fold_device_ms(fold, *late, none, none, UF_REPS, cycles_per_ms)
    held = {"union_kernel": (late_ms, late_us), "compress_kernel": (comp_ms, comp_us)}
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
    log(f"  one batch's fold (uf_union_launch), device only: first batch (compress + union) "
        f"{first_ms:.4f} ms, late batch (union, the state known flat) {late_ms:.4f} ms; host enqueue "
        f"{first_us:.2f} / {late_us:.2f} us; bounds {b_union + b_compress:.5f} / {b_union:.5f} ms (bytes)")
    log(f"  per kernel on the late batch, by {split_by}: union_kernel "
        f"{per_kernel['union_kernel']:.2f} us, compress_kernel {per_kernel['compress_kernel']:.2f} us a launch; "
        f"held stream: compress alone (a call with no edges) {comp_ms * 1e3:.2f} us; bounds "
        f"{b_union * 1e3:.3f} / {b_compress * 1e3:.3f} us")
    log(f"  plain twin: first batch {twin_first_ms:.3f} ms, late batch {twin_late_ms:.3f} ms, "
        f"compress_plain {compress_twin_ms:.3f} ms (host loop, syncs included)")
    log(f"  the kernels' share of the wall time: {share * 100:.2f}% (the first batch's fold + "
        f"{nb - 1} x the late batch's, over the wall time)")
    log(f"  EF40 unpack (PyTorch ops) a batch: device {unpack_ms:.4f} ms, host enqueue {unpack_us:.1f} us; "
        f"device busy (unpack + fold) ~{busy * 100:.1f}% of the wall time, idle ~{(1 - busy) * 100:.1f}%")
    return {
        "launches": launches,
        "first_ms": first_ms,
        "late_ms": late_ms,
        "rounds": rounds,
        "turns": {"init": init, "late": late, "first_batch": (s0, d0), "late_batch": (sl, dl)},
        "union_ms": per_kernel["union_kernel"] / 1e3,
        "compress_ms": per_kernel["compress_kernel"] / 1e3,
        "held": held,
        "union_plain_ms": twin_late_ms,
        "compress_plain_ms": compress_twin_ms,
        "union_bound_ms": b_union,
        "compress_bound_ms": b_compress,
    }


# ---------------------------------------------------------------------------
# phases 8-10: the GraphStream surface, the degree kernels and the parity union


def trace_launcher(counts, v, m):
    """A callable making one raw ``degree_trace_launch`` (packed records)
    over pre-sorted keys: the two kernels alone, without the sort."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    lib = _cuda.library("degrees.cu")
    keys, order = torch.sort((v << 1) | (~m).to(torch.int32), stable=True)
    n = v.shape[0]
    rec = torch.empty(6 * n, dtype=torch.uint8, device=v.device)
    bits = torch.empty((n + 7) // 8, dtype=torch.uint8, device=v.device)
    nbytes = lib.degree_trace_scratch_bytes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream

    def launch():
        _cuda.check(lib.degree_trace_launch(v.data_ptr(), m.data_ptr(), keys.data_ptr(), order.data_ptr(), n,
                                            counts.data_ptr(), counts.shape[0], rec.data_ptr(), bits.data_ptr(),
                                            None, scratch.data_ptr(), nbytes, stream),
                    "degree_trace_launch")
        return rec, bits

    return launch


def block_columns(out, limit=None):
    """The concatenated columns of an OutputStream's record blocks."""
    cols = None
    for k, blk in enumerate(out.blocks()):
        if limit is not None and k >= limit:
            break
        arrs = [c for c in blk.columns if isinstance(c, np.ndarray)]
        cols = [[a] for a in arrs] if cols is None else [cs + [a] for cs, a in zip(cols, arrs)]
    return [np.concatenate(cs) for cs in cols]


def phase_properties(dev, cycles_per_ms: float, data: dict) -> dict:
    """Phase 8: the degree property stream over the CC bench's 104,857,600
    edges (209,715,200 records, downloaded packed), checked against
    np.bincount and, on its first batches, the twin; the other property
    streams and ``undirected().distinct()`` on prefixes, checked against
    numpy."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream, _interleave_endpoints
    from gelly_streaming_tpu_torch.core.types import EdgeBatch
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import degrees

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    src, dst = data["src"], data["dst"]
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch)
    # warm the path (the library's first load, the pinned pool)
    EdgeStream.from_arrays(src[:batch], dst[:batch], cfg, device=dev).get_degrees().collect_last()
    torch.cuda.synchronize()

    final = np.zeros(c, np.int64)
    first_blocks, records, check_s = [], 0, 0.0
    degrees.reset_launches()
    t0 = time.perf_counter()
    for k, blk in enumerate(EdgeStream.from_arrays(src, dst, cfg, device=dev).get_degrees().blocks()):
        t_check = time.perf_counter()
        ids, vals = blk.columns
        np.maximum.at(final, ids, vals)
        records += len(ids)
        if k < PROP_TWIN_BATCHES:
            first_blocks.append((ids.copy(), vals.copy()))
        check_s += time.perf_counter() - t_check
    # the stream's own time: the smoke's checks run inside the loop
    wall_s = time.perf_counter() - t0 - check_s
    launches = degrees.LAUNCHES["degree_trace"]
    want = np.bincount(src, minlength=c) + np.bincount(dst, minlength=c)
    if launches != nb:
        raise RuntimeError(f"degree_trace launched {launches} times for {nb} batches")
    if records != 2 * nb * batch or not np.array_equal(final, want):
        raise RuntimeError("the degree trace's final degrees differ from np.bincount")
    down_bytes = nb * (6 * 2 * batch + (2 * batch + 7) // 8)
    log(f"  get_degrees over {nb * batch} edges: {records} records in {wall_s:.3f} s (the smoke's checks, "
        f"{check_s:.3f} s more, excluded), "
        f"{nb * batch / wall_s:.6g} edges/s, {records / wall_s:.6g} records/s, "
        f"{down_bytes / wall_s / 1e9:.3f} GB/s of packed records downloaded; every vertex's final "
        f"degree equal to np.bincount; degree_trace launched {launches} times")

    # the first batches' records against the twin on the card
    counts = torch.zeros(c, dtype=torch.int32, device=dev)
    worst = 0
    for k, (ids, vals) in enumerate(first_blocks):
        b = EdgeBatch.from_arrays(src[k * batch : (k + 1) * batch], dst[k * batch : (k + 1) * batch], device=dev)
        v, m = _interleave_endpoints(b)
        counts, (rec, bits) = degrees.degree_trace_plain(counts, v, m, True)
        w_ids, w_vals, w_m = wire.unpack_records48(rec.cpu().numpy(), bits.cpu().numpy(), len(v))
        if len(ids) != int(w_m.sum()):
            raise RuntimeError(f"batch {k}: {len(ids)} records, the twin {int(w_m.sum())}")
        worst = max(worst, int(np.abs(ids - w_ids[w_m]).max()), int(np.abs(vals - w_vals[w_m]).max()))
    if worst:
        raise RuntimeError(f"the degree trace differs from the twin on its first batches ({worst})")
    log(f"  the first {len(first_blocks)} batches' trace equal to the twin's, record for record")

    # times at the main path's shapes: the last batch, unpacked on the card
    bs, bd = src[-batch:], dst[-batch:]
    buf = torch.from_numpy(wire.pack_edges(bs, bd, wire.PAIR40)).to(dev)
    s, d = wire.unpack_edges(buf, batch, wire.PAIR40)
    v, m = _interleave_endpoints(EdgeBatch(src=s, dst=d, mask=torch.ones(batch, dtype=torch.bool, device=dev)))
    counts = torch.zeros(c, dtype=torch.int32, device=dev)
    launch = trace_launcher(counts, v, m)
    k_ms, k_us = device_ms(launch, UF_REPS, cycles_per_ms)
    k_events = cuda_ms(launch, UF_REPS)
    call_ms, call_us = device_ms(lambda: degrees.degree_trace(counts, v, m, True), UF_REPS, cycles_per_ms)

    def step():
        s2, d2 = wire.unpack_edges(buf, batch, wire.PAIR40)
        v2, m2 = _interleave_endpoints(EdgeBatch(src=s2, dst=d2, mask=m[:batch]))
        return degrees.degree_trace(counts, v2, m2, True)

    step_ms, step_us = device_ms(step, UF_REPS, cycles_per_ms)
    plain_ms = cuda_ms(lambda: degrees.degree_trace_plain(counts, v, m, True), 3, 1)
    n = 2 * batch
    # the kernel's own inputs: sorted keys + order read (12 B a row), the
    # mask read (1 B), record + mask bit written (6 + 1/8 B), counts read and
    # written once a vertex this batch touches (8 B)
    touched = int(torch.unique(v).numel())
    bound = (12 * n + n + 6 * n + n / 8 + 8 * touched) / HBM_BYTES_PER_S * 1e3
    rec_dev = torch.empty(6 * n + (n + 7) // 8, dtype=torch.uint8, device=dev)
    host = torch.empty(rec_dev.shape, dtype=torch.uint8, pin_memory=True)
    d2h_ms = cuda_ms(lambda: host.copy_(rec_dev, non_blocking=True), 10)
    rec_h, bits_h = (t.cpu().numpy() for t in degrees.degree_trace(counts, v, m, True))
    t0 = time.perf_counter()
    for _ in range(3):
        wire.unpack_records48(rec_h, bits_h, n)
    decode_ms = (time.perf_counter() - t0) / 3 * 1e3
    busy = nb * step_ms / (wall_s * 1e3)
    log(f"  degree_trace kernels alone (after the sort), device only: {k_ms:.4f} ms a batch of {n} rows, "
        f"host enqueue {k_us:.2f} us, back-to-back events {k_events:.4f} ms; bound {bound:.5f} ms (bytes, "
        f"{touched} vertices touched)")
    try:
        split = {(re.search(r"(\w+)\(", key) or re.search(r"(.*)", key)).group(1): round(us, 2)
                 for key, (us, _) in profiler_device_us(launch, 10).items()}
        log(f"  degree_trace by torch.profiler, us a launch: {split}")
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    log(f"  degree_trace call (keys, torch.sort, kernel): device {call_ms:.4f} ms, host enqueue {call_us:.1f} us; "
        f"the whole batch step (PAIR40 unpack, interleave, call): device {step_ms:.4f} ms, host {step_us:.1f} us")
    log(f"  plain twin {plain_ms:.3f} ms; one batch's packed records D2H alone {d2h_ms:.4f} ms "
        f"({rec_dev.numel() / d2h_ms / 1e6:.3f} GB/s)")
    log(f"  host decode of one batch's records (numpy unpack_records48): {decode_ms:.2f} ms, "
        f"{nb * decode_ms / (wall_s * 1e3) * 100:.1f}% of the wall time over {nb} batches")
    log(f"  device busy ~{busy * 100:.2f}% of the get_degrees wall time, idle ~{(1 - busy) * 100:.2f}%")

    # the kernels against the twin at the main path's shape, with ids -1, C
    # and C + 5 on some rows (JAX's index rules), packed and raw
    v_oor = torch.from_numpy(oor_ids(v.cpu().numpy(), c).astype(np.int32)).to(dev)
    m_oor = m.clone()
    m_oor[1::7] = False
    c0 = torch.from_numpy(np.random.default_rng(8).integers(0, 1 << 10, c).astype(np.int32)).to(dev)
    for packed in (True, False):
        got_c = c0.clone()
        got = degrees.degree_trace(got_c, v_oor, m_oor, packed)
        want_c, want = degrees.degree_trace_plain(c0, v_oor, m_oor, packed)
        oor_err = int((got_c - want_c).abs().max()) + sum(int((g.long() - w.long()).abs().max())
                                                          for g, w in zip(got, want))
        if oor_err:
            raise RuntimeError(f"degree_trace with out-of-range ids differs from the twin ({oor_err}, packed {packed})")
        worst = max(worst, oor_err)
    log(f"  degree_trace with ids -1, C, C + 5 on every 997th row and a mask: counts and records equal to the "
        f"twin's (packed and raw), {n} rows")

    # the other property streams over a prefix of 8 batches
    k = PROP_PREFIX_BATCHES * batch
    ps, pd = src[:k], dst[:k]
    stream = EdgeStream.from_arrays(ps, pd, cfg, device=dev)
    inter = np.stack([ps, pd], axis=1).reshape(-1)
    _, first_idx = np.unique(inter, return_index=True)
    order_v = inter[np.sort(first_idx)]
    t0 = time.perf_counter()
    ids, vals = block_columns(stream.get_in_degrees())
    fin = np.zeros(c, np.int64)
    np.maximum.at(fin, ids, vals)
    if len(ids) != k or not np.array_equal(fin, np.bincount(pd, minlength=c)):
        raise RuntimeError("get_in_degrees differs from np.bincount")
    (nv,) = block_columns(stream.number_of_vertices())
    if not np.array_equal(nv, np.arange(1, len(order_v) + 1)):
        raise RuntimeError("number_of_vertices differs from numpy")
    (ne,) = block_columns(stream.number_of_edges())
    if not np.array_equal(ne, np.arange(1, k + 1)):
        raise RuntimeError("number_of_edges differs from numpy")
    (gv,) = block_columns(stream.get_vertices())
    if not np.array_equal(gv, order_v):
        raise RuntimeError("get_vertices differs from numpy's first appearances")
    log(f"  get_in_degrees, number_of_vertices, number_of_edges, get_vertices over {PROP_PREFIX_BATCHES} "
        f"batches: equal to numpy ({len(order_v)} vertices) in {time.perf_counter() - t0:.1f} s")

    # undirected().distinct() over 2 batches against a numpy set
    k = PROP_DISTINCT_BATCHES * batch
    t0 = time.perf_counter()
    got = []
    for b in EdgeStream.from_arrays(src[:k], dst[:k], cfg, device=dev).undirected().distinct().batches():
        keep = b.mask.cpu().numpy()
        got.append(b.src.cpu().numpy()[keep].astype(np.int64) * c + b.dst.cpu().numpy()[keep])
    got = np.concatenate(got)
    seq = []
    for i in range(PROP_DISTINCT_BATCHES):
        s_i, d_i = src[i * batch : (i + 1) * batch].astype(np.int64), dst[i * batch : (i + 1) * batch].astype(np.int64)
        seq += [s_i * c + d_i, d_i * c + s_i]
    seq = np.concatenate(seq)
    _, first_idx = np.unique(seq, return_index=True)
    if not np.array_equal(got, seq[np.sort(first_idx)]):
        raise RuntimeError("undirected().distinct() differs from numpy's first occurrences")
    log(f"  undirected().distinct() over {PROP_DISTINCT_BATCHES} batches: {len(got)} distinct directed edges "
        f"of {len(seq)}, equal to numpy's first occurrences, in {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "ms": k_events, "device_ms": k_ms, "host_us": k_us, "plain_ms": plain_ms,
            "bound_ms": bound, "err": worst, "call_ms": call_ms, "turns": (v, m)}


def degree_dist_oracle(src, dst, sign):
    """The reference's three keyed stages (DegreeDistribution.java:70-132)
    as host dicts, event by event: (degree, count) records."""
    degs, hist, out = {}, {}, []
    for u, v, g in zip(src.tolist(), dst.tolist(), sign.tolist()):
        for x in (u, v):
            old = degs.get(x, 0)
            if g < 0 and old <= 0:
                continue  # deleting an absent vertex
            new = old + g
            if new > 0:
                degs[x] = new
                hist[new] = hist.get(new, 0) + 1
                out.append((new, hist[new]))
            else:
                degs.pop(x, None)
            if old > 0:
                hist[old] -= 1
                out.append((old, hist[old]))
    return out


def signed_events(rng, n: int, vertices: int, hubs: int = 0):
    """Signed events, about 30% deletions (some of absent vertices), a few
    self-loops, and with ``hubs`` a quarter of the rows on ``hubs`` vertices."""
    src = rng.integers(0, vertices, n).astype(np.int32)
    dst = rng.integers(0, vertices, n).astype(np.int32)
    dst[::97] = src[::97]
    if hubs:
        sel = rng.random(n) < 0.25
        src[sel] = rng.integers(0, hubs, int(sel.sum()))
    sign = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int8)
    return src, dst, sign


def signed_stream(src, dst, sign, cfg, batch: int, dev):
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io.sources import _batched

    return EdgeStream.from_batches(_batched(src, dst, None, None, sign, batch, dev), cfg, device=dev)


def phase_degree_dist(dev, cycles_per_ms: float, data: dict) -> dict:
    """Phase 9: DegreeDistributionSummary over the EF40 replay (degree_fold)
    and DegreeDistribution over signed streams (degree_dist_scan)."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.library.degree_distribution import DegreeDistribution, DegreeDistributionSummary
    from gelly_streaming_tpu_torch.ops import degrees

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    src, dst, width, bufs = data["src"], data["dst"], data["width"], data["bufs"]
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch)
    agg = DegreeDistributionSummary()
    EdgeStream.from_wire(bufs[:1], batch, width, cfg, device=dev).aggregate(agg).collect()
    torch.cuda.synchronize()
    degrees.reset_launches()
    t0 = time.perf_counter()
    (deg,), = EdgeStream.from_wire(bufs, batch, width, cfg, device=dev).aggregate(agg).collect()
    deg = deg.cpu().numpy()
    wall_s = time.perf_counter() - t0
    fold_launches = degrees.LAUNCHES["degree_fold"]
    want = np.bincount(src, minlength=c) + np.bincount(dst, minlength=c)
    if fold_launches != nb or not np.array_equal(deg, want):
        raise RuntimeError(f"DegreeDistributionSummary: {fold_launches} launches, deg equal: {np.array_equal(deg, want)}")
    log(f"  from_wire(...).aggregate(DegreeDistributionSummary()): {wall_s:.3f} s, {nb * batch / wall_s:.6g} edges/s; "
        f"deg equal to np.bincount; degree_fold launched {fold_launches} times")
    s, d = wire.unpack_edges(torch.from_numpy(bufs[-1]).to(dev), batch, width)
    base = torch.from_numpy(want.astype(np.int32)).to(dev)
    fold_err = int((degrees.degree_fold(base.clone(), s, d) - degrees.degree_fold_plain(base, s, d)).abs().max())
    # ids -1, C and C + 5 on some rows: JAX's scatter rule
    so, do = (torch.from_numpy(oor_ids(x.cpu().numpy(), c, k).astype(np.int32)).to(dev) for k, x in enumerate((s, d)))
    oor_err = int((degrees.degree_fold(base.clone(), so, do) - degrees.degree_fold_plain(base, so, do)).abs().max())
    if oor_err:
        raise RuntimeError(f"degree_fold with out-of-range ids differs from the twin ({oor_err})")
    acc = base.clone()
    f_ms, f_us = device_ms(lambda: degrees.degree_fold(acc, s, d), UF_REPS, cycles_per_ms)
    f_events = cuda_ms(lambda: degrees.degree_fold(acc, s, d), UF_REPS)
    f_plain = cuda_ms(lambda: degrees.degree_fold_plain(base, s, d), 5)
    idx = torch.cat([s, d]).long()
    ones = torch.ones(idx.shape, dtype=torch.int32, device=dev)
    lib_ms = cuda_ms(lambda: acc.index_add_(0, idx, ones), UF_REPS)
    f_bound = (8 * batch + 8 * c) / HBM_BYTES_PER_S * 1e3
    log(f"  degree_fold a batch: device {f_ms:.4f} ms, host enqueue {f_us:.2f} us, events {f_events:.4f} ms; "
        f"index_add_ (int64 index of both endpoints) {lib_ms:.4f} ms; plain twin {f_plain:.4f} ms; "
        f"bound {f_bound:.5f} ms (bytes); max |err| vs twin {fold_err}, with ids -1, C, C + 5 {oor_err}")

    # the fully-dynamic distribution: 2^20 signed events over 2^16 vertices
    rng = np.random.default_rng(1)
    n_ev, nv, ev_batch = DD_EVENTS, DD_VERTICES, DD_BATCH
    es, ed, eg = signed_events(rng, n_ev, nv)
    dcfg = StreamConfig(vertex_capacity=nv)
    degrees.reset_launches()
    t0 = time.perf_counter()
    dd = DegreeDistribution()
    ids, counts = block_columns(dd.run(signed_stream(es, ed, eg, dcfg, ev_batch, dev)))
    dd_s = time.perf_counter() - t0
    scan_launches = degrees.LAUNCHES["degree_dist_scan"]
    t0 = time.perf_counter()
    oracle = np.array(degree_dist_oracle(es, ed, eg), np.int64).reshape(-1, 2)
    oracle_s = time.perf_counter() - t0
    if scan_launches != n_ev // ev_batch:
        raise RuntimeError(f"degree_dist_scan launched {scan_launches} times for {n_ev // ev_batch} batches")
    if len(ids) != len(oracle) or not (np.array_equal(ids, oracle[:, 0]) and np.array_equal(counts, oracle[:, 1])):
        raise RuntimeError("DegreeDistribution differs from the keyed-stage oracle")
    deletes = int((eg < 0).sum())
    log(f"  DegreeDistribution over {n_ev} signed events ({deletes} deletions) on {nv} vertices, batches of "
        f"{ev_batch}: {len(ids)} records in {dd_s:.3f} s, equal to the three-stage dict oracle ({oracle_s:.1f} s); "
        f"degree_dist_scan launched {scan_launches} times")
    # the twin and the one-thread kernel on the first batch, and a run at
    # capacity 2^10 past which hubs' degrees go
    sl = slice(0, ev_batch)
    args = [torch.from_numpy(a[sl]).to(dev) for a in (es, ed, eg)] + [torch.ones(ev_batch, dtype=torch.bool, device=dev)]
    z = torch.zeros(nv, dtype=torch.int32, device=dev)
    got = degrees.degree_dist_scan(z.clone(), z.clone(), *args)
    serial = degrees.degree_dist_scan_serial(z.clone(), z.clone(), *args)
    want_t = degrees.degree_dist_scan_plain(z, z, *args)
    scan_err = max(scan_diff(got, want_t[2:]), scan_diff(got, serial))
    cs, cd, cg = signed_events(rng, DD_CAP_EVENTS, DD_CAP, hubs=4)
    ccfg = StreamConfig(vertex_capacity=DD_CAP)
    cap_dd = DegreeDistribution()
    cap_got = block_columns(cap_dd.run(signed_stream(cs, cd, cg, ccfg, ev_batch, dev)))
    cpu_dd = DegreeDistribution()
    cap_want = block_columns(cpu_dd.run(signed_stream(cs, cd, cg, ccfg, ev_batch, torch.device("cpu"))))
    top = int(cap_dd.final_state.deg.max())
    if top < DD_CAP or not all(np.array_equal(a, b) for a, b in zip(cap_got, cap_want)):
        raise RuntimeError(f"capacity run: max degree {top}, records equal to the twin's: "
                           f"{all(np.array_equal(a, b) for a, b in zip(cap_got, cap_want))}")
    scan_err = max(scan_err, int(not torch.equal(cap_dd.final_state.hist.cpu(), cpu_dd.final_state.hist)))
    if scan_err:
        raise RuntimeError(f"degree_dist_scan differs from its twin or the one-thread kernel ({scan_err})")
    log(f"  first batch equal to the twin and to the one-thread kernel; capacity {DD_CAP} run ({DD_CAP_EVENTS} "
        f"events, max degree {top}) equal to the CPU path's")
    small = scan_turns(dev, cycles_per_ms, es[sl], ed[sl], eg[sl], nv, reps=UF_REPS)

    # the uncut run: the CC bench's stream, signed, in batches of 2^21
    uncut = phase_degree_dist_uncut(dev, data)
    big = scan_turns(dev, cycles_per_ms, data["src"][:CC_BATCH], data["dst"][:CC_BATCH], uncut["sign"][:CC_BATCH],
                     CC_VERTICES, reps=UF_REPS)
    share = big["device_ms"] * uncut["launches"] / (uncut["wall_s"] * 1e3)
    log(f"  the scan's device time x {uncut['launches']} launches = {share * 100:.2f}% of the uncut run's wall")
    return {
        "fold": {"launches": fold_launches, "ms": f_events, "device_ms": f_ms, "host_us": f_us, "plain_ms": f_plain,
                 "bound_ms": f_bound, "library_ms": lib_ms, "err": fold_err},
        "scan": {"launches": uncut["launches"], "ms": big["ms"], "device_ms": big["device_ms"],
                 "host_us": big["host_us"], "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
                 "err": max(scan_err, uncut["err"]), "sort_ms": big["sort_ms"], "serial_ms": big["serial_ms"],
                 "batch_events": CC_BATCH, "cut_launches": scan_launches,
                 "small": {k: small[k] for k in ("ms", "device_ms", "sort_ms", "serial_ms", "plain_ms", "bound_ms")},
                 "events_per_s": uncut["events_per_s"], "records_per_s": uncut["records_per_s"]},
    }


def scan_diff(a, b) -> int:
    """Records differing by most, or flags differing, between two
    (records, record mask) pairs; 0 when equal."""
    return max(int((a[0] - b[0]).abs().max()), int((a[1] != b[1]).sum()))


def scan_turns(dev, cycles_per_ms: float, src, dst, sign, capacity: int, reps: int) -> dict:
    """degree_dist_scan on one batch at the main path's shapes: the
    two-stage kernels and the one-thread kernel in turns (two-stage,
    one-thread, one-thread, two-stage; each on its own state), the two
    stable sorts alone on this batch's keys, the twin, and the bound.  A
    call is some 25 launches (each sort several), so ``reps`` stays near
    20: more would fill the device's launch queue behind the held stream
    and block the host."""
    import torch

    from gelly_streaming_tpu_torch.ops import degrees

    n = len(src)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (src, dst, sign)]
    args.append(torch.ones(n, dtype=torch.bool, device=dev))
    fresh = lambda: torch.zeros(capacity, dtype=torch.int32, device=dev)  # noqa: E731
    par_state, ser_state = (fresh(), fresh()), (fresh(), fresh())
    recs, _ = degrees.degree_dist_scan(fresh(), fresh(), *args)
    par = lambda: degrees.degree_dist_scan(*par_state, *args)  # noqa: E731
    ser = lambda: degrees.degree_dist_scan_serial(*ser_state, *args)  # noqa: E731
    turns = {"parallel": [], "serial": []}
    for tag, fn, r in (("parallel", par, reps), ("serial", ser, 1), ("serial", ser, 1), ("parallel", par, reps)):
        turns[tag].append(device_ms(fn, r, cycles_per_ms, warmup=1))
    x = torch.stack([args[0], args[1]], 1).reshape(-1)
    k1 = torch.where(x < 0, x + capacity, x).clamp(0, capacity - 1)
    k2 = recs[..., 0].reshape(-1).clamp(0, capacity - 1)
    sort_ms, _ = device_ms(lambda: (torch.sort(k1, stable=True), torch.sort(k2, stable=True)), reps, cycles_per_ms)
    plain_ms = cuda_ms(lambda: degrees.degree_dist_scan_plain(*par_state, *args), 3, 1)
    events_ms = cuda_ms(par, reps, 1)
    # per event: src, dst (4 B each), sign, mask read; 8 int32 and 4 flags
    # written; then deg read and written once a touched vertex and hist
    # once a touched degree (4 + 4 B each), counted from this batch's keys
    touched_v, touched_d = int(torch.unique(k1).numel()), int(torch.unique(k2).numel())
    bound = (n * (10 + 36) + 8 * touched_v + 8 * touched_d) / HBM_BYTES_PER_S * 1e3
    d_ms = min(t[0] for t in turns["parallel"])
    h_us = min(t[1] for t in turns["parallel"])
    s_ms = min(t[0] for t in turns["serial"])
    log(f"  degree_dist_scan, {n} events over {capacity} vertices, in turns: two-stage device "
        + ", ".join(f"{t[0]:.4f}" for t in turns["parallel"]) + " ms; one-thread kernel "
        + ", ".join(f"{t[0]:.3f}" for t in turns["serial"]) + f" ms ({s_ms / d_ms:.0f}x); the two stable "
        f"torch.sorts alone {sort_ms:.4f} ms (kernels {d_ms - sort_ms:.4f} ms); host enqueue {h_us:.1f} us; "
        f"back-to-back events {events_ms:.4f} ms; twin on the card {plain_ms:.3f} ms; bound {bound:.5f} ms (bytes; "
        f"{touched_v} vertices and {touched_d} degrees touched)")
    try:
        rows = profiler_device_us(par, 5)
        for key, (us, calls) in sorted(rows.items(), key=lambda r: -r[1][0])[:8]:
            log(f"    torch.profiler: {us:.2f} us/call, {calls} calls: {key[:80]}")
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"    torch.profiler failed: {type(e).__name__}: {e}")
    return {"ms": events_ms, "device_ms": d_ms, "host_us": h_us, "sort_ms": sort_ms, "serial_ms": s_ms,
            "plain_ms": plain_ms, "bound_ms": bound}


def phase_degree_dist_uncut(dev, data: dict) -> dict:
    """DegreeDistribution over the CC bench's 104,857,600 edges with signs
    (about 30% deletions, numpy's default_rng(2)) in batches of 2^21 over
    2^20 vertices, end to end; then every batch again through the kernels
    and the twin on the card, records and state compared, the first batch
    also against the one-thread kernel, and the final histogram against
    np.bincount of the final degrees."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.library.degree_distribution import DegreeDistribution
    from gelly_streaming_tpu_torch.ops import degrees

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    src, dst = data["src"], data["dst"]
    rng = np.random.default_rng(2)
    sign = np.empty(len(src), np.int8)
    for i in range(nb):
        sign[i * batch : (i + 1) * batch] = np.where(rng.random(batch) < 0.3, -1, 1)
    cfg = StreamConfig(vertex_capacity=c)
    # warm the allocator and the sorts outside the counted run
    DegreeDistribution().run(signed_stream(src[:batch], dst[:batch], sign[:batch], cfg, batch, dev)).collect()
    torch.cuda.synchronize()
    degrees.reset_launches()
    t0 = time.perf_counter()
    dd = DegreeDistribution()
    n_rec, id_sum, count_sum = 0, 0, 0
    for blk in dd.run(signed_stream(src, dst, sign, cfg, batch, dev)).blocks():
        ids, counts = blk.columns
        n_rec += len(ids)
        id_sum += int(ids.sum())
        count_sum += int(counts.sum())
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = degrees.LAUNCHES["degree_dist_scan"]
    if launches != nb:
        raise RuntimeError(f"uncut run: degree_dist_scan launched {launches} times for {nb} batches")
    log(f"  DegreeDistribution over the CC bench's {nb * batch} signed events ({int((sign < 0).sum())} "
        f"deletions) on {c} vertices, batches of {batch}: {n_rec} records in {wall_s:.3f} s, "
        f"{nb * batch / wall_s:.6g} events/s, {n_rec / wall_s:.6g} records/s; degree_dist_scan launched "
        f"{launches} times")

    t0 = time.perf_counter()
    zero = lambda: torch.zeros(c, dtype=torch.int32, device=dev)  # noqa: E731
    kern, twin = (zero(), zero()), (zero(), zero())
    err, t_rec, t_id, t_count = 0, 0, 0, 0
    for i in range(nb):
        sl = slice(i * batch, (i + 1) * batch)
        args = [torch.from_numpy(a[sl]).to(dev) for a in (src, dst, sign)]
        args.append(torch.ones(batch, dtype=torch.bool, device=dev))
        if i == 0:
            serial = degrees.degree_dist_scan_serial(zero(), zero(), *args)
        got = degrees.degree_dist_scan(*kern, *args)
        new_deg, new_hist, w_recs, w_mask = degrees.degree_dist_scan_plain(*twin, *args)
        twin = (new_deg, new_hist)
        err = max(err, scan_diff(got, (w_recs, w_mask)), scan_diff(got, serial) if i == 0 else 0)
        kept = w_recs.reshape(-1, 2)[w_mask.reshape(-1)].long()
        t_rec += int(kept.shape[0])
        t_id += int(kept[:, 0].sum())
        t_count += int(kept[:, 1].sum())
    deg, hist = kern[0].cpu().numpy(), kern[1].cpu().numpy()
    state_equal = all(torch.equal(a, b) for a, b in zip(kern, twin)) and \
        torch.equal(dd.final_state.deg, kern[0]) and torch.equal(dd.final_state.hist, kern[1])
    hist_equal = np.array_equal(hist[1:], np.bincount(deg, minlength=c)[1:c])
    sums_equal = (n_rec, id_sum, count_sum) == (t_rec, t_id, t_count)
    if err or not (state_equal and hist_equal and sums_equal):
        raise RuntimeError(f"uncut run: records differ by {err}, state equal {state_equal}, hist equal to "
                           f"np.bincount {hist_equal}, record sums equal {sums_equal}")
    log(f"  every batch's records and flags equal to the twin on the card, the first batch's to the one-thread "
        f"kernel; final deg/hist equal to the twin's and the end-to-end run's; hist[1:] equal to "
        f"np.bincount(deg); max degree {int(deg.max())} ({time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "wall_s": wall_s, "events_per_s": nb * batch / wall_s,
            "records_per_s": n_rec / wall_s, "err": err, "sign": sign}


def phase_bipartite(dev, cycles_per_ms: float, data: dict) -> dict:
    """Phase 10: BipartitenessCheck over an even -> odd EF40 stream of the
    bench's shape (bipartite: sides differ across every edge, components
    equal to scipy's) and over the uniform stream ((false,{})); a timed
    windowed run against the CPU path."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.io.sources import _batched
    from gelly_streaming_tpu_torch.library.bipartiteness import BipartitenessCheck
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    c, batch, nb = CC_VERTICES, CC_BATCH, CC_BATCHES
    width = data["width"]
    bsrc = data["src"] & ~np.int32(1)
    bdst = data["dst"] | np.int32(1)
    t0 = time.perf_counter()
    bbufs = pack_batches(bsrc, bdst, batch, width)
    log(f"  even -> odd stream packed in {time.perf_counter() - t0:.1f} s (host numpy threads, untimed)")
    cfg = StreamConfig(vertex_capacity=c, batch_size=batch)
    agg = BipartitenessCheck()
    EdgeStream.from_wire(bbufs[:1], batch, width, cfg, device=dev).aggregate(agg).collect()
    torch.cuda.synchronize()
    runs = {}
    for name, bufs in (("bipartite", bbufs), ("uniform", data["bufs"])):
        uf.reset_launches()
        t0 = time.perf_counter()
        (cand,), = EdgeStream.from_wire(bufs, batch, width, cfg, device=dev).aggregate(agg).collect()
        verdict = cand.is_bipartite()
        wall_s = time.perf_counter() - t0
        runs[name] = (cand, verdict, wall_s, uf.LAUNCHES["parity_union_kernel"], uf.LAUNCHES["compress_kernel"])
        log(f"  {name}: from_wire(...).aggregate(BipartitenessCheck()) {wall_s:.3f} s first buffer -> verdict, "
            f"{nb * batch / wall_s:.6g} edges/s; is_bipartite {verdict}; launches {dict(uf.LAUNCHES)}")
    cand, verdict, _, launches, compress_launches = runs["bipartite"]
    if not verdict or launches != nb or compress_launches != 1:
        raise RuntimeError(f"the even -> odd stream: is_bipartite {verdict}, {launches} launches")
    p = cand.parent2.cpu().numpy()
    seen = cand.seen.cpu().numpy()
    if not np.all(p[2 * bsrc] != p[2 * bdst]):
        raise RuntimeError("a bipartite edge joins two vertices on one side")
    o_parent, o_seen = cc_oracle(bsrc, bdst, c)
    label = np.minimum(p[0::2], p[1::2]) // 2
    if not (np.array_equal(seen, o_seen) and np.array_equal(label[seen], o_parent[seen])):
        raise RuntimeError("the bipartite stream's components differ from scipy's")
    cand_u, verdict_u, _, launches_u, _ = runs["uniform"]
    if verdict_u or str(cand_u) != "(false,{})" or launches_u != nb:
        raise RuntimeError(f"the uniform stream: {str(cand_u)[:40]}, {launches_u} launches")
    log(f"  bipartite: sides differ across all {nb * batch} edges, {len(np.unique(label[seen]))} components equal "
        f"to scipy's; uniform: (false,{{}})")

    # one batch's parity fold: device time, twin, bound
    s, d = wire.unpack_edges(torch.from_numpy(bbufs[-1]).to(dev), batch, width)
    late = (cand.parent2.clone(), cand.seen.clone())
    init = (uf.init_parity_parent(c, dev), torch.zeros(c, dtype=torch.bool, device=dev))
    so, do = (torch.from_numpy(oor_ids(x.cpu().numpy(), c, k).astype(np.int32)).to(dev) for k, x in enumerate((s, d)))
    err = 0
    for a, b in ((s, d), (so, do)):  # the stream's rows; ids -1, C and C + 5 on some rows
        got = uf.parity_union_edges_with_seen(init[0].clone(), init[1].clone(), a, b)
        want = uf.parity_union_edges_with_seen_plain(*init, a, b)
        err += int((got[0] - want[0]).abs().max()) + int((got[1] != want[1]).sum())
    if err:
        raise RuntimeError(f"the parity union differs from its twin ({err})")
    fold = uf.parity_union_edges_with_seen
    first_ms, first_us = fold_device_ms(fold, *init, s, d, UF_REPS, cycles_per_ms)
    late_ms, late_us = fold_device_ms(fold, *late, s, d, UF_REPS, cycles_per_ms, flat=True)
    rounds = {}
    for name, (p0, sn0), flat in (("first", init, False), ("late", late, True)):
        fold(uf.mark_flat(p0.clone()) if flat else p0.clone(), sn0.clone(), s, d)
        rounds[name] = uf.last_rounds()
    log(f"  the parity call's rounds: first batch {rounds['first']}, late batch {rounds['late']}; "
        f"equal to the twin with ids -1, C, C + 5 on every 997th row")
    copies = iter([(uf.mark_flat(late[0].clone()), late[1].clone()) for _ in range(UF_REPS + 2)])
    ev_ms = cuda_ms(lambda: uf.parity_union_edges_with_seen(*next(copies), s, d), UF_REPS)
    plain_first = cuda_ms(lambda: uf.parity_union_edges_with_seen_plain(*init, s, d), 1, 0)
    plain_late = cuda_ms(lambda: uf.parity_union_edges_with_seen_plain(*late, s, d), 1, 0)
    # each kernel's held-stream time: the call with no edges is compress
    # over the 2C doubled nodes alone, and the parity union is the rest
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    comp_ms, comp_us = fold_device_ms(fold, *late, none, none, UF_REPS, cycles_per_ms)
    union_ms, union_us = late_ms, late_us
    per_kernel, split_by = {}, "torch.profiler"
    try:
        per_kernel = union_kernel_profile(*late, s, d, 10, fold=fold)
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    if len(per_kernel) < 2:
        per_kernel = {"union_kernel": union_ms * 1e3, "compress_kernel": comp_ms * 1e3}
        split_by = "held-stream times (the profiler showed no kernel rows)"
    # the parity union alone: src/dst read (8 B a row), parent2 read (4 B a
    # doubled node, 2C of them), seen written (1 B a vertex); compress of the
    # doubled space reads and writes parent2 (16 B a vertex)
    bound = (8 * batch + 9 * c) / HBM_BYTES_PER_S * 1e3
    compress_bound = 16 * c / HBM_BYTES_PER_S * 1e3
    log(f"  parity fold a batch (one C call), device only: first (compress + parity union) {first_ms:.4f} ms, "
        f"late (parity union, the state known flat) {late_ms:.4f} ms; host enqueue {first_us:.1f} / "
        f"{late_us:.1f} us; events (late) {ev_ms:.4f} ms; plain twin {plain_first:.2f} / {plain_late:.2f} ms")
    log(f"  per kernel on the late batch, by {split_by}: parity union_kernel "
        f"{per_kernel['union_kernel']:.2f} us, compress_kernel (2C nodes) {per_kernel['compress_kernel']:.2f} us "
        f"a launch; held stream: compress alone (a call with no edges) {comp_ms * 1e3:.2f} us; bounds "
        f"{bound * 1e3:.3f} / {compress_bound * 1e3:.3f} us (bytes)")

    # the windowed path at a smaller depth: panes folded in two partitions,
    # combined and merged by merge_parents on the doubled space
    rng = np.random.default_rng(3)
    wn, wc = BP_WINDOW_EDGES, BP_WINDOW_VERTICES
    ws = (rng.integers(0, wc // 2, wn) * 2).astype(np.int32)
    wd = (rng.integers(0, wc // 2, wn) * 2 + 1).astype(np.int32)
    odd = rng.choice(np.arange(wn // 2, wn), 3, replace=False)  # odd cycles after half the stream
    ws[odd] = wd[odd] - 2 * rng.integers(1, 4, 3).astype(np.int32)
    tim = np.sort(rng.integers(0, 4 * 1000, wn))
    wcfg = StreamConfig(vertex_capacity=wc, num_shards=2)

    def windowed(device):
        stream = EdgeStream.from_batches(_batched(ws, wd, None, tim, None, 1 << 14, device), wcfg, device=device)
        return [(r[0].parent2.cpu(), r[0].seen.cpu(), r[0].is_bipartite())
                for r in stream.aggregate(BipartitenessCheck(window_ms=1000)).collect()]

    t0 = time.perf_counter()
    on_card = windowed(dev)
    card_s = time.perf_counter() - t0
    on_cpu = windowed(torch.device("cpu"))
    if len(on_card) != 4 or any(not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2] == b[2])
                                for a, b in zip(on_card, on_cpu)):
        raise RuntimeError("the windowed bipartiteness check differs from the CPU path")
    log(f"  windowed: {wn} timed edges over {wc} vertices, 4 windows of 1000 ms, 2 partitions: every emission "
        f"equal to the CPU path ({card_s:.2f} s on the card); verdicts {[r[2] for r in on_card]}")
    return {"launches": launches, "compress_launches": compress_launches, "ms": per_kernel["union_kernel"] / 1e3,
            "device_ms": union_ms, "host_us": union_us, "plain_ms": plain_late, "bound_ms": bound, "err": err,
            "first_ms": first_ms, "late_ms": late_ms, "rounds": rounds,
            "turns": {"init": init, "late": late, "first_batch": (s, d), "late_batch": (s, d)}}


# ---------------------------------------------------------------------------
# phase 12: slice() and windowed GraphSAGE on the card


def sage_stream_arrays(seed: int = 3):
    """(src, dst) int32 of the GraphSAGE run: SAGE_PANES panes of uniform
    edges over SAGE_VERTICES, then the hub pane, a star of SAGE_HUB edges
    from vertex 0 beside Zipf edges over 2^16 other ids."""
    rng = np.random.default_rng(seed)
    c, e = SAGE_VERTICES, SAGE_PANE_EDGES
    src = rng.integers(0, c, SAGE_PANES * e, dtype=np.int32)
    dst = rng.integers(0, c, SAGE_PANES * e, dtype=np.int32)
    ids = rng.permutation(np.arange(1, c))[: 1 << 16]
    zs, zd = zipf_edges(rng, len(ids), e - SAGE_HUB)
    hub_src = np.concatenate([np.zeros(SAGE_HUB, np.int64), ids[zs]])
    hub_dst = np.concatenate([rng.integers(1, c, SAGE_HUB), ids[zd]])
    perm = rng.permutation(e)
    return (np.concatenate([src, hub_src[perm].astype(np.int32)]),
            np.concatenate([dst, hub_dst[perm].astype(np.int32)]))


class twins_in_place:
    """Within the block, the port's build_buckets and sage_layer are their
    plain twins (the library and the snapshot look them up at each call)."""

    def __enter__(self):
        from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
        from gelly_streaming_tpu_torch.ops import sage

        def layer_plain(table, keys, nbrs, valid, w, bias, out=None, row0=0):
            got = sage.sage_layer_plain(table, keys, nbrs, valid, w, bias)
            return got if out is None else out[row0:row0 + keys.shape[0]].copy_(got)

        self.saved = (nbh.build_buckets, sage.sage_layer)
        nbh.build_buckets, sage.sage_layer = nbh.build_buckets_plain, layer_plain

    def __exit__(self, *exc):
        from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
        from gelly_streaming_tpu_torch.ops import sage

        nbh.build_buckets, sage.sage_layer = self.saved


def directed_all(s, d):
    """slice(ALL)'s directed rows of one pane."""
    return np.concatenate([s, d]), np.concatenate([d, s])


def buckets_err(got, want) -> int:
    """0 when two bucket lists are equal exactly (shapes, keys, nbrs, valid,
    num_keys), else 1."""
    import torch

    if len(got) != len(want):
        return 1
    for g, w in zip(got, want):
        if g.num_keys != w.num_keys:
            return 1
        for a, b in ((g.keys, w.keys), (g.nbrs, w.nbrs), (g.valid, w.valid)):
            if a.shape != b.shape or not torch.equal(a, b):
                return 1
    return 0


def mean_view(table):
    """(table, w, bias) under which sage_layer writes bf16(mean): |table| + 1
    (ReLU keeps every mean), W = [0; I] and no bias."""
    import torch

    f = table.shape[1]
    eye = torch.cat([torch.zeros(f, f), torch.eye(f)]).to(table.device, torch.bfloat16)
    return (table.float().abs() + 1).to(torch.bfloat16), eye, torch.zeros(f, dtype=torch.bfloat16, device=table.device)


def layer_err(table, buckets, w, bias, mean_args) -> tuple:
    """(max |kernel - twin|, the same over the buckets whose rows of more
    than 32 slots go through the partial-sum kernel, the largest |ref|
    there, the mean's max |kernel - twin| relative to |twin|) of sage_layer
    over a pane's buckets, each output within SAGE_TWIN_RTOL * |twin| +
    SAGE_TWIN_ATOL; under ``mean_args`` (mean_view) each mean within
    SAGE_MEAN_RTOL * |twin| + SAGE_MEAN_ATOL."""
    import torch

    from gelly_streaming_tpu_torch.ops import sage

    worst = worst_chunked = mag_chunked = mean_rel = 0.0
    for b in buckets:
        if not b.num_keys:
            continue
        d = b.nbrs.shape[1]
        got = sage.sage_layer(table, b.keys, b.nbrs, b.valid, w, bias).float()
        ref = sage.sage_layer_plain(table, b.keys, b.nbrs, b.valid, w, bias).float()
        diff = (got - ref).abs()
        if bool((diff > SAGE_TWIN_RTOL * ref.abs() + SAGE_TWIN_ATOL).any()):
            raise RuntimeError(f"sage_layer differs from its twin past {SAGE_TWIN_RTOL} * |ref| + "
                               f"{SAGE_TWIN_ATOL} (D={d}, max |err| {float(diff.max()):.6g})")
        worst = max(worst, float(diff.max()))
        if d > sage._DIRECT:
            worst_chunked = max(worst_chunked, float(diff.max()))
            mag_chunked = max(mag_chunked, float(ref.abs().max()))
        got = sage.sage_layer(mean_args[0], b.keys, b.nbrs, b.valid, *mean_args[1:]).float()
        ref = sage.sage_layer_plain(mean_args[0], b.keys, b.nbrs, b.valid, *mean_args[1:]).float()
        diff = (got - ref).abs()
        if bool((diff > SAGE_MEAN_RTOL * ref.abs() + SAGE_MEAN_ATOL).any()):
            raise RuntimeError(f"sage_layer's mean differs from its twin's past {SAGE_MEAN_RTOL} * |ref| + "
                               f"{SAGE_MEAN_ATOL} (D={d}, max |err| {float(diff.max()):.6g})")
        mean_rel = max(mean_rel, float((diff / ref.abs().clamp(min=1)).max()))
    return worst, worst_chunked, mag_chunked, mean_rel


def sage_oracle_err(feats64, params, s, d, keys, emb) -> tuple:
    """A float64 oracle of one window, numpy and scipy: the grouping (every
    vertex of the pane keyed once) and the layer relu(x W_self + mean W_nbr +
    b) on the f32 features (``feats64``, as float64), the neighbor sums as a
    sparse product.  Returns (max |emb - ref|, max of |emb - ref| - SAGE_TOL *
    (1 + |ref|), keys checked)."""
    import scipy.sparse as sp

    s_dir, d_dir = directed_all(s, d)
    adj = sp.csr_matrix((np.ones(len(s_dir)), (s_dir, d_dir)), shape=(SAGE_VERTICES, SAGE_VERTICES))
    count = np.bincount(s_dir, minlength=SAGE_VERTICES)
    uniq = np.flatnonzero(count)
    order = np.argsort(keys)
    if len(keys) != len(uniq) or not np.array_equal(keys[order], uniq):
        raise RuntimeError("the window's keys are not the pane's vertices, each once")
    ws, wn, b = (p.double().cpu().numpy() for p in params)
    mean = (adj[uniq] @ feats64) / count[uniq, None]
    ref = np.maximum(feats64[uniq] @ ws + mean @ wn + b, 0.0)
    diff = np.abs(emb[order] - ref)
    return float(diff.max()), float((diff - SAGE_TOL * (1 + np.abs(ref))).max()), len(uniq)


def build_launcher(ts, td, tm):
    """(launch, sort): callables making build_buckets' C calls over one pane
    into pre-allocated outputs, without the host's read of the counts:
    the sort, count and scatter calls, and the sort alone."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh

    lib = _cuda.library("neighborhoods.cu")
    e = ts.shape[0]
    nb = len(nbh.bucket_shapes(e))
    dev = ts.device
    scratch = torch.empty(lib.nb_scratch_bytes(e, 0), dtype=torch.uint8, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    counts = [b.num_keys for b in nbh.build_buckets(ts, td, None, tm)]
    slots = sum(n << b for b, n in enumerate(counts))
    keys_out = torch.empty(sum(counts), dtype=torch.int32, device=dev)
    nbrs_out = torch.empty(slots, dtype=torch.int32, device=dev)
    valid_out = torch.empty(slots, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sp = (scratch.data_ptr(), scratch.numel())

    def sort():
        _cuda.check(lib.nb_sort_launch(ts.data_ptr(), td.data_ptr(), tm.data_ptr(), e, 0, *sp, stream),
                    "nb_sort_launch")

    def launch():
        sort()
        _cuda.check(lib.nb_count_launch(e, nb, 0, *sp, totals.data_ptr(), stream), "nb_count_launch")
        _cuda.check(lib.nb_scatter_launch(e, nb, 0, *sp, keys_out.data_ptr(), nbrs_out.data_ptr(),
                                          valid_out.data_ptr(), stream), "nb_scatter_launch")

    return launch, sort


def parent_build_launcher(lib, ts, td, tm):
    """The parent's build over one pane into pre-allocated outputs: the
    stable torch.sort of the grouping keys, then its count and scatter
    calls (its C interface)."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh

    e = ts.shape[0]
    nb = len(nbh.bucket_shapes(e))
    dev = ts.device
    tiles = (e + 1023) // 1024
    tile_base = torch.empty(nb * tiles, dtype=torch.int32, device=dev)
    info = torch.empty(2 * e, dtype=torch.int32, device=dev)
    offsets = torch.empty(2 * nb, dtype=torch.int64, device=dev)
    totals = torch.empty(nb, dtype=torch.int32, device=dev)
    counts = [b.num_keys for b in nbh.build_buckets(ts, td, None, tm)]
    slots = sum(n << b for b, n in enumerate(counts))
    keys_out = torch.empty(sum(counts), dtype=torch.int32, device=dev)
    nbrs_out = torch.empty(slots, dtype=torch.int32, device=dev)
    valid_out = torch.empty(slots, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gk = (ts << 1) | (~tm).to(torch.int32)

    def launch():
        keys, order = torch.sort(gk, stable=True)
        _cuda.check(lib.nb_count_launch(keys.data_ptr(), e, nb, tile_base.data_ptr(), info.data_ptr(),
                                        offsets.data_ptr(), totals.data_ptr(), stream), "parent nb_count_launch")
        _cuda.check(lib.nb_scatter_launch(keys.data_ptr(), order.data_ptr(), e, nb, tile_base.data_ptr(),
                                          info.data_ptr(), offsets.data_ptr(), ts.data_ptr(), td.data_ptr(),
                                          keys_out.data_ptr(), nbrs_out.data_ptr(), valid_out.data_ptr(), stream),
                    "parent nb_scatter_launch")
        return keys_out, nbrs_out, valid_out

    return launch


def parent_layer(lib, table, hoods, w, bias):
    """The parent's layer over a pane's buckets: its gather-mean kernel (and
    finish kernel for rows past 256 slots), then torch.addmm with the
    stacked weights and ReLU, a bucket at a time."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda

    c, f = table.shape
    dev = table.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    plans = []
    for b in hoods:
        k, d = b.nbrs.shape
        nch = max(1, -(-d // 256))
        part = torch.empty((k * nch, f), dtype=torch.float32, device=dev) if nch > 1 else None
        cnt = torch.empty((k * nch,), dtype=torch.int32, device=dev) if nch > 1 else None
        plans.append((b, k, d, nch, part, cnt))

    def run():
        outs = []
        for b, k, d, nch, part, cnt in plans:
            xm = torch.empty((k, 2 * f), dtype=torch.bfloat16, device=dev)
            _cuda.check(lib.sage_gather_mean_launch(
                table.data_ptr(), c, f, b.keys.data_ptr(), b.nbrs.data_ptr(), b.valid.data_ptr(), k, d, 256, nch, 1,
                xm.data_ptr(), None if part is None else part.data_ptr(), None if cnt is None else cnt.data_ptr(),
                stream), "parent sage_gather_mean_launch")
            outs.append(torch.relu_(torch.addmm(bias, xm, w)))
        return outs

    return run


def in_turns(label: str, old_fn, new_fn, reps: int, cycles_per_ms: float) -> dict:
    """Device-only ms of the parent's and the current build in turns
    (parent, current, current, parent) on the held stream."""
    got = [(tag, device_ms(fn, reps, cycles_per_ms)[0])
           for tag, fn in (("parent", old_fn), ("current", new_fn), ("current", new_fn), ("parent", old_fn))]
    old, new = (got[0][1] + got[3][1]) / 2, (got[1][1] + got[2][1]) / 2
    log(f"  {label}: " + "; ".join(f"{tag} {ms:.4f} ms" for tag, ms in got)
        + f"; mean parent {old:.4f} ms, current {new:.4f} ms, {old / new:.2f}x")
    return {"parent_ms": old, "current_ms": new, "turns": [ms for _, ms in got]}


def sage_pane_times(dev, cycles_per_ms: float, label: str, s, d, table, w, bias, parents: dict, reps: int) -> dict:
    """build_buckets and the layer at one pane's shapes, device only on the
    held stream: the build's sort, count and scatter calls, the radix sort
    alone, torch.sort(stable=True) of the same keys (the build's library
    yardstick), the whole call; sage_layer over the pane's buckets into one
    buffer, its bound, embedding_bag + addmm (the layer's yardstick); the
    parent's builds in turns where given."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import sage

    f_in, f_out = table.shape[1], w.shape[1]
    ts, td = to_dev(directed_all(s, d), dev)
    ones = torch.ones(ts.shape[0], dtype=torch.bool, device=dev)
    n = ts.shape[0]
    launch, sort = build_launcher(ts, td, ones)
    b_ms, b_us = device_ms(launch, reps, cycles_per_ms)
    b_events = cuda_ms(launch, reps)
    rs_ms, _ = device_ms(sort, reps, cycles_per_ms)
    keys32 = (ts << 1) | (~ones).to(torch.int32)
    tsort_ms, _ = device_ms(lambda: torch.sort(keys32, stable=True), reps, cycles_per_ms)
    call_ms = cuda_ms(lambda: nbh.build_buckets(ts, td, None, ones), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        nbh.build_buckets(ts, td, None, ones)
    call_host_ms = (time.perf_counter() - t0) / reps * 1e3
    build_plain_ms = cuda_ms(lambda: nbh.build_buckets_plain(ts, td, None, ones), 2, 1)
    buckets = nbh.build_buckets(ts, td, None, ones)
    counts = [b.num_keys for b in buckets]
    slots = sum(b.nbrs.numel() for b in buckets)
    build_bound = (9 * n + 4 * sum(counts) + 5 * slots) / HBM_BYTES_PER_S * 1e3
    lohi = (int(ts.min()), int(ts.max()))
    log(f"  {label} pane, build_buckets (radix sort, count, scatter), device only: {b_ms:.4f} ms for {n} rows, "
        f"{sum(counts)} keys, {slots} slots ({len(nbh.radix_plan(*lohi))} digit passes for sources in {lohi}); "
        f"{b_ms / build_bound:.2f}x the bound {build_bound:.5f} ms (bytes); host enqueue {b_us:.2f} us; "
        f"back-to-back events {b_events:.4f} ms; the radix sort alone {rs_ms:.4f} ms; torch.sort(stable=True) "
        f"of the int32 grouping keys alone {tsort_ms:.4f} ms; the whole call (with the counts' copy to the host "
        f"and the allocations) {call_ms:.4f} ms by events, {call_host_ms:.4f} ms on the host's clock, of which "
        f"not device work {call_ms - b_ms:.4f} ms; plain twin {build_plain_ms:.3f} ms")

    hoods = [b for b in buckets if b.num_keys]
    rows = sum(b.num_keys for b in hoods)
    emb = torch.empty((rows, f_out), dtype=torch.bfloat16, device=dev)

    def layer():
        row0 = 0
        for b in hoods:
            sage.sage_layer(table, b.keys, b.nbrs, b.valid, w, bias, out=emb, row0=row0)
            row0 += b.num_keys
        return emb

    l_ms, l_us = device_ms(layer, reps, cycles_per_ms)
    l_events = cuda_ms(layer, reps)
    l_plain_ms = cuda_ms(lambda: [sage.sage_layer_plain(table, b.keys, b.nbrs, b.valid, w, bias) for b in hoods], 2, 1)
    gslots = sum(b.nbrs.numel() for b in hoods)
    valid_n = sum(int(b.valid.sum()) for b in hoods)
    # each input once: ids and flags, each distinct table row that a key or a
    # valid neighbor names (under slice(ALL) the neighbors are keys too), W
    # and the bias; the output once
    distinct = int(torch.unique(torch.cat([b.keys for b in hoods] + [b.nbrs[b.valid] for b in hoods])).numel())
    l_bytes = 4 * rows + 5 * gslots + 2 * f_in * distinct + 2 * (2 * f_in * f_out + f_out) + 2 * f_out * rows
    l_ops = 2 * rows * 2 * f_in * f_out
    l_bytes_ms = l_bytes / HBM_BYTES_PER_S * 1e3
    l_ops_ms = l_ops / BF16_FLOPS_PER_S * 1e3
    l_bound = max(l_bytes_ms, l_ops_ms)
    # the yardstick: embedding_bag(mode="mean") over the valid neighbors in
    # CSR form, then addmm over [x_self | mean] (timed only; on no path)
    flat = torch.cat([b.nbrs[b.valid] for b in hoods]).long()
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(torch.cat([b.valid.sum(1) for b in hoods]), 0)[:-1]])
    keys_all = torch.cat([b.keys for b in hoods]).long()
    bag = torch.nn.functional.embedding_bag(flat, table, offs, mode="mean")
    xm = torch.cat([table[keys_all], bag.to(torch.bfloat16)], 1)
    lib_emb = torch.relu(torch.addmm(bias, xm, w))
    lib_err = float((lib_emb.float() - layer().float()).abs().max())
    bag_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(flat, table, offs, mode="mean"), reps)
    mm_ms = cuda_ms(lambda: torch.addmm(bias, xm, w), reps)
    log(f"  {label} pane, sage_layer over its {len(hoods)} buckets ({rows} rows, {valid_n} neighbor rows), device "
        f"only: {l_ms:.4f} ms, host enqueue {l_us:.1f} us ({l_us / len(hoods):.2f} us a launch); back-to-back events "
        f"{l_events:.4f} ms; bound {l_bound:.5f} ms ({'bytes' if l_bytes_ms >= l_ops_ms else 'operations'}: "
        f"{l_bytes} B, {distinct} distinct table rows, {l_bytes_ms:.5f} ms; {l_ops} bf16 operations, "
        f"{l_ops_ms:.5f} ms), {l_ms / l_bound:.3f}x it; plain twin {l_plain_ms:.3f} ms; yardstick "
        f"embedding_bag(mode='mean') {bag_ms:.4f} ms + addmm {mm_ms:.4f} ms = {bag_ms + mm_ms:.4f} ms (max |diff| "
        f"of its relu to the kernel's {lib_err:.4g})")
    out = {
        "build": {"ms": b_events, "device_ms": b_ms, "host_us": b_us, "plain_ms": build_plain_ms,
                  "bound_ms": build_bound, "sort_ms": rs_ms, "torch_sort_ms": tsort_ms, "call_ms": call_ms,
                  "call_host_ms": call_host_ms, "passes": len(nbh.radix_plan(*lohi))},
        "layer": {"ms": l_events, "device_ms": l_ms, "host_us": l_us, "plain_ms": l_plain_ms, "bound_ms": l_bound,
                  "bound_by": "bytes" if l_bytes_ms >= l_ops_ms else "operations", "bytes_ms": l_bytes_ms,
                  "ops_ms": l_ops_ms, "library_ms": bag_ms + mm_ms, "embedding_bag_ms": bag_ms, "addmm_ms": mm_ms,
                  "launches": len(hoods)},
    }
    if "sage" in parents:
        old = parent_layer(parents["sage"], table, hoods, w, bias)
        ref = torch.cat(old()).float()
        diff = (ref - layer().float()).abs()
        if bool((diff > SAGE_TWIN_RTOL * ref.abs() + SAGE_TWIN_ATOL).any()):
            raise RuntimeError(f"the parent's layer and sage_layer disagree on the {label} pane")
        out["layer"]["turns"] = in_turns(f"{label} pane, the layer (parent: gathers, addmm, relu)", old, layer,
                                         reps, cycles_per_ms)
    if "neighborhoods" in parents:
        old = parent_build_launcher(parents["neighborhoods"], ts, td, ones)
        flat_new = [torch.cat([getattr(b, a).reshape(-1) for b in buckets]) for a in ("keys", "nbrs", "valid")]
        if not all(torch.equal(x, y) for x, y in zip(old(), flat_new)):
            raise RuntimeError(f"the parent's build and build_buckets disagree on the {label} pane")
        out["build"]["turns"] = in_turns(f"{label} pane, the build (parent: torch.sort, count, scatter)", old,
                                         launch, reps, cycles_per_ms)
    return out


def sage_width_times(dev, cycles_per_ms: float, s, d) -> dict:
    """Device-only ms of sage_layer over one pane's buckets at each of
    SAGE_WIDTHS (random bf16 table, W and bias made on the card)."""
    import torch

    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import sage

    ts, td = to_dev(directed_all(s, d), dev)
    hoods = [b for b in nbh.build_buckets(ts, td, None, torch.ones_like(ts, dtype=torch.bool)) if b.num_keys]
    rows = sum(b.num_keys for b in hoods)
    out = {}
    for f_in, f_out in SAGE_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(f_in)
        table = torch.randn((SAGE_VERTICES, f_in), generator=g, device=dev).to(torch.bfloat16)
        w = (torch.randn((2 * f_in, f_out), generator=g, device=dev) / f_in ** 0.5).to(torch.bfloat16)
        bias = torch.zeros(f_out, dtype=torch.bfloat16, device=dev)
        emb = torch.empty((rows, f_out), dtype=torch.bfloat16, device=dev)

        def layer():
            row0 = 0
            for b in hoods:
                sage.sage_layer(table, b.keys, b.nbrs, b.valid, w, bias, out=emb, row0=row0)
                row0 += b.num_keys

        ms, _ = device_ms(layer, 3, cycles_per_ms)
        out[f"{f_in}->{f_out}"] = ms
        del table
    log(f"  sage_layer alone over the uniform pane's {len(hoods)} buckets at other widths, device only: "
        + ", ".join(f"F {k} {v:.4f} ms" for k, v in out.items()))
    return out


def phase_sage(dev, cycles_per_ms: float, parents: dict) -> dict:
    """Phase 12: slice(ALL) and GraphSAGEWindows.run at the repo's width over
    SAGE_PANES count-cut panes of uniform edges and one hub pane; every pane's
    build_buckets equal to its twin on the card and its sort's order equal
    to torch.sort(stable=True)'s, sage_layer within the tolerance of its
    twin, one window against a float64 numpy oracle, a 2-layer stack
    against the twins, a fold_neighbors degree count against np.bincount,
    launches counted on the main path, and the times, with the parent's
    builds (``parents``: "sage", "neighborhoods" -> loaded library) in
    turns."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeDirection
    from gelly_streaming_tpu_torch.library import graphsage as gs
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import sage

    c, f, e = SAGE_VERTICES, SAGE_FEATURES, SAGE_PANE_EDGES
    n_panes = SAGE_PANES + 1
    t0 = time.perf_counter()
    src, dst = sage_stream_arrays()
    feats = np.random.default_rng(4).standard_normal((c, f), dtype=np.float32)
    params = gs.init_params(f, f, generator=torch.Generator().manual_seed(0), device=dev)
    cfg = StreamConfig(vertex_capacity=c, batch_size=e, ingest_window_edges=e)
    model = gs.GraphSAGEWindows(params, feats, device=dev)
    log(f"  inputs (untimed, {time.perf_counter() - t0:.2f} s): {n_panes} panes of {e} edges over {c} vertices "
        f"({SAGE_PANES} uniform, one hub: a star of {SAGE_HUB} beside Zipf edges), features [{c}, {f}] f32, "
        f"F_in = F_out = {f}")

    def snapshot(s=src, d=dst):
        return EdgeStream.from_arrays(s, d, cfg, device=dev).slice(WINDOW_MS, EdgeDirection.ALL)

    for _ in model.run(snapshot(src[:e], dst[:e])):  # warm: library loads, allocator, pinned pool
        pass
    torch.cuda.synchronize()

    # the main path, counted: GraphSAGEWindows.run over slice(ALL)
    kept, sizes, window_s = {}, [], []
    check_s = 0.0
    nbh.reset_launches()
    sage.reset_launches()
    t0 = t_prev = time.perf_counter()
    for w, (keys, emb) in enumerate(model.run(snapshot())):
        t_check = time.perf_counter()
        window_s.append(t_check - t_prev)
        if emb.shape != (len(keys), f) or not np.isfinite(emb).all():
            raise RuntimeError(f"window {w}: embeddings of shape {emb.shape} or not finite")
        sizes.append(len(keys))
        if w in (0, SAGE_PANES):
            kept[w] = (keys.copy(), emb.copy())
        del keys, emb
        t_prev = time.perf_counter()
        check_s += t_prev - t_check
    wall = time.perf_counter() - t0 - check_s
    launches = {"build_buckets": nbh.LAUNCHES["build_buckets"], "sage_layer": sage.LAUNCHES["sage_layer"]}
    if len(sizes) != n_panes or launches["build_buckets"] != n_panes or launches["sage_layer"] <= 0:
        raise RuntimeError(f"{len(sizes)} windows, launches {launches}")
    for w in range(n_panes):
        s, d = src[w * e:(w + 1) * e], dst[w * e:(w + 1) * e]
        if sizes[w] != np.count_nonzero(np.bincount(np.concatenate([s, d]), minlength=c)):
            raise RuntimeError(f"window {w}: {sizes[w]} keys, not the pane's vertex count")
    n_emb = sum(sizes)
    # the same run again, for the spread
    t0 = t_prev = time.perf_counter()
    again = []
    for keys, emb in model.run(snapshot()):
        t_now = time.perf_counter()
        again.append(t_now - t_prev)
        del keys, emb
        t_prev = time.perf_counter()
    log(f"  a second run: {sum(again):.3f} s, {n_panes / sum(again):.6g} windows/s; per window "
        f"{[round(x * 1e3, 1) for x in again]} ms")
    log(f"  GraphSAGEWindows.run over slice(ALL): {n_panes} windows, {n_emb} embeddings in {wall:.3f} s "
        f"(the smoke's checks, {check_s:.3f} s more, excluded): {n_panes / wall:.6g} windows/s, "
        f"{n_panes * e / wall:.6g} edges/s, {n_emb / wall:.6g} embeddings/s; per window "
        f"{[round(x * 1e3, 1) for x in window_s]} ms; launches {launches}")

    # every pane: build_buckets against its twin on the card and its sort
    # against torch.sort(stable=True); sage_layer on the first, the hub and
    # the out-of-range pane; ids -1, C and C + 5 on the first pane
    build_err, sort_err, layer_worst, n_buckets, passes = 0, 0, (0.0, 0.0, 0.0, 0.0), [], []
    table, w_stacked, bias = model._table, model._weights[0], params.bias
    mean_args = mean_view(table)
    ones = torch.ones(2 * e, dtype=torch.bool, device=dev)
    for w in range(n_panes + 1):
        s, d = src[(w % n_panes) * e:(w % n_panes + 1) * e], dst[(w % n_panes) * e:(w % n_panes + 1) * e]
        if w == n_panes:
            s, d = oor_ids(s, c).astype(np.int32), oor_ids(d, c, 1).astype(np.int32)
        ts, td = to_dev(directed_all(s, d), dev)
        got = nbh.build_buckets(ts, td, None, ones)
        build_err = max(build_err, buckets_err(got, nbh.build_buckets_plain(ts, td, None, ones)))
        rs, rd, ri, n_pass = nbh.sort_valid_rows(ts, td, ones)
        sort_err = max(sort_err, int(not all(torch.equal(a, b) for a, b in
                                             zip((rs, rd, ri), nbh.sort_valid_rows_plain(ts, td, ones)))))
        passes.append(n_pass)
        n_buckets.append(sum(1 for b in got if b.num_keys))
        if w in (0, SAGE_PANES, n_panes):
            layer_worst = tuple(map(max, layer_worst, layer_err(table, got, w_stacked, bias, mean_args)))
    if build_err or sort_err:
        raise RuntimeError(f"build_buckets differs from its twin ({build_err}) or its sort from torch.sort's "
                           f"order ({sort_err}) on the card")
    if launches["sage_layer"] != sum(n_buckets[:n_panes]):
        raise RuntimeError(f"sage_layer launched {launches['sage_layer']} times for "
                           f"{sum(n_buckets[:n_panes])} non-empty buckets")
    log(f"  build_buckets equal to its twin on the card on all {n_panes} panes and with ids -1, C and C + 5 "
        f"(keys, nbrs, valid, num_keys); its radix sort's order equal to torch.sort(stable=True)'s on every "
        f"pane (passes a pane {passes}); sage_layer within {SAGE_TWIN_RTOL} * |ref| + {SAGE_TWIN_ATOL} of its "
        f"twin on the first, the hub and the out-of-range pane (max |err| {layer_worst[0]:.6g}; in the buckets "
        f"of rows past {sage._DIRECT} slots, which the partial-sum kernel starts, {layer_worst[1]:.6g} where the "
        f"largest |ref| is {layer_worst[2]:.6g}); its mean alone (W = [0; I], no bias, |table| + 1) within "
        f"{SAGE_MEAN_RTOL} * |ref| + {SAGE_MEAN_ATOL} of the twin's on the same buckets (max |err| / |ref| "
        f"{layer_worst[3]:.6g}, the error over max(|ref|, 1)); non-empty buckets a pane {n_buckets}")
    del mean_args

    # one window against numpy, float64; the hub window's hub row too
    t_or = time.perf_counter()
    feats64 = feats.astype(np.float64)
    oracle = sage_oracle_err(feats64, params, src[:e], dst[:e], *kept[0])
    hub = sage_oracle_err(feats64, params, src[SAGE_PANES * e:], dst[SAGE_PANES * e:], *kept[SAGE_PANES])
    del feats64
    if oracle[1] > 0 or hub[1] > 0:
        raise RuntimeError(f"embeddings differ from the float64 oracle past {SAGE_TOL} * (1 + |ref|): "
                           f"{oracle}, {hub}")
    log(f"  windows 0 and {SAGE_PANES} (hub) against a float64 oracle (numpy, scipy) of the grouping and the layer: "
        f"{oracle[2]} and {hub[2]} keys, max |emb - ref| {oracle[0]:.6g} and {hub[0]:.6g}, all within "
        f"{SAGE_TOL} * (1 + |ref|) (the largest |emb - ref| - {SAGE_TOL} * (1 + |ref|): {oracle[1]:.6g} and "
        f"{hub[1]:.6g}; {time.perf_counter() - t_or:.1f} s)")

    # two stacked layers over two panes, against the twins
    two = gs.GraphSAGEWindows(
        [params, gs.init_params(f, f, generator=torch.Generator().manual_seed(1), device=dev)], model._table,
        device=dev)
    got = list(two.run(snapshot(src[:2 * e], dst[:2 * e])))
    with twins_in_place():
        want = list(two.run(snapshot(src[:2 * e], dst[:2 * e])))
    stack_err = 0.0
    for (gk, ge), (wk, we) in zip(got, want):
        if not np.array_equal(gk, wk) or not np.all(np.abs(ge - we) <= SAGE_TOL * (1 + np.abs(we))):
            raise RuntimeError("the 2-layer stack differs from its run on the twins")
        stack_err = max(stack_err, float(np.abs(ge - we).max()))
    if len(got) != 2:
        raise RuntimeError(f"the 2-layer stack gave {len(got)} windows")
    log(f"  2 stacked layers over 2 panes: keys equal to the run on the twins, embeddings within {SAGE_TOL} "
        f"(max |err| {stack_err:.6g})")

    # a fold over the snapshot: every vertex's degree, against np.bincount
    t_fold = time.perf_counter()
    recs = snapshot(src[:e], dst[:e]).fold_neighbors((0, 0), lambda acc, vid, nbr, val: (vid, acc[1] + 1)).collect()
    fold_s = time.perf_counter() - t_fold
    deg = np.bincount(np.concatenate([src[:e], dst[:e]]), minlength=c)
    ids = np.array([r[0] for r in recs])
    if len(ids) != np.count_nonzero(deg) or not np.array_equal(np.array([r[1] for r in recs]), deg[ids]):
        raise RuntimeError("fold_neighbors' degree count differs from np.bincount")
    log(f"  fold_neighbors degree count over one pane: {len(recs)} records equal to np.bincount in {fold_s:.2f} s")

    # times at the main path's shapes: the first (uniform) pane and the hub pane
    times = {label: sage_pane_times(dev, cycles_per_ms, label, src[w * e:(w + 1) * e], dst[w * e:(w + 1) * e],
                                    table, w_stacked, bias, parents, reps)
             for label, w, reps in (("uniform", 0, SAGE_REPS), ("hub", SAGE_PANES, SAGE_HUB_REPS))}

    widths = sage_width_times(dev, cycles_per_ms, src[:e], dst[:e])

    # where a window's time goes, stage by stage on the host's clock
    snap = snapshot(src[:e], dst[:e])
    pane = next(iter(snap._panes()))
    stages = dict.fromkeys(("host pad", "upload", "build_buckets call", "layer", "readback"), 0.0)
    reps = 3
    for _ in range(reps):
        t = time.perf_counter()
        sp, dp, _v, mp = snap._padded_pane_edges(pane)
        t1 = time.perf_counter()
        up = [torch.from_numpy(a).to(dev) for a in (sp, dp, mp)]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        hb = [b for b in nbh.build_buckets(up[0], up[1], None, up[2]) if b.num_keys]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        kd, ed = model._layer_device(0, table, hb)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        kh, eh = gs._to_host(kd, ed)
        t5 = time.perf_counter()
        for k, dt_ in zip(stages, (t1 - t, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            stages[k] += dt_ / reps
        del kh, eh
    read_bytes = ed.numel() * 4 + kd.numel() * 4
    log("  one window stage by stage (host clock, synchronized): " + ", ".join(
        f"{k} {v * 1e3:.2f} ms" for k, v in stages.items())
        + f"; readback {read_bytes / stages['readback'] / 1e9:.3f} GB/s ({read_bytes} B of f32 embeddings and keys)")
    busy_ms = times["uniform"]["build"]["device_ms"] + times["uniform"]["layer"]["device_ms"]
    # a window's wall: the counted run's mean, and the second run's (its
    # pinned readback buffers already cached)
    per_window = wall / n_panes * 1e3
    warm_window = sum(again) / n_panes * 1e3
    log(f"  device compute per window ~{busy_ms:.3f} ms (the build's sort and kernels + the layer, held-stream times): "
        f"{busy_ms / per_window * 100:.2f}% of the counted run's {per_window:.2f} ms a window, "
        f"{busy_ms / warm_window * 100:.2f}% of the second run's {warm_window:.2f} ms")
    try:
        # the device's own rows: kernels and copies (aten:: rows repeat their time)
        rows_p = {k: v for k, v in profiler_device_us(lambda: [None for _ in model.run(snap)], 1).items()
                  if not k.startswith(("aten::", "Activity Buffer"))}
        total_us = sum(us * calls for us, calls in rows_p.values())
        copy_us = sum(us * calls for k, (us, calls) in rows_p.items() if k.startswith("Memcpy"))
        log(f"  torch.profiler, one window: device busy {total_us / 1e3:.3f} ms, of which copies "
            f"{copy_us / 1e3:.3f} ms: {total_us / 1e3 / per_window * 100:.2f}% of the counted run's window, "
            f"{total_us / 1e3 / warm_window * 100:.2f}% of the second run's (idle "
            f"{100 - total_us / 1e3 / warm_window * 100:.2f}%)")
        top = sorted(rows_p.items(), key=lambda r: -r[1][0] * r[1][1])[:8]
        names = [(re.search(r"(\w+)\(", k) or re.search(r"(.{0,40})", k)).group(1) for k, _ in top]
        log("  torch.profiler, top rows: " + "; ".join(
            f"{name} {us * calls:.1f} us" for name, (_, (us, calls)) in zip(names, top)))
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
    uni, hubt = times["uniform"], times["hub"]
    return {
        "build": {**uni["build"], "launches": launches["build_buckets"], "err": max(build_err, sort_err),
                  "hub": hubt["build"]},
        "layer": {**uni["layer"], "launches": launches["sage_layer"], "err": layer_worst[0],
                  "chunked_err": layer_worst[1], "mean_rel_err": layer_worst[3], "stack_err": stack_err,
                  "oracle_err": max(oracle[0], hub[0]),
                  "hub": hubt["layer"], "widths_ms": widths},
        "windows_per_s": n_panes / wall, "edges_per_s": n_panes * e / wall, "embeddings_per_s": n_emb / wall,
    }


# ---------------------------------------------------------------------------
# phase 13: GraphSAGE training on the card


def backward_err(table, b, z, dz) -> tuple:
    """(max |kernel - twin| of dw, of db) of sage_layer_backward over one
    bucket, each within SAGE_BWD_RTOL * |A|^T |dH| (db: SAGE_BWD_DB_RTOL *
    sum |dH|), and two runs of the kernel equal bit for bit."""
    import torch

    from gelly_streaming_tpu_torch.ops import sage

    f_in, f_out = table.shape[1], z.shape[1]

    def run(fn):
        dw = torch.zeros((2 * f_in, f_out), dtype=torch.float32, device=z.device)
        db = torch.zeros((f_out,), dtype=torch.float32, device=z.device)
        return fn(table, b.keys, b.nbrs, b.valid, z, dz, dw, db)

    got, again, want = run(sage.sage_layer_backward), run(sage.sage_layer_backward), \
        run(sage.sage_layer_backward_plain)
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise RuntimeError(f"sage_layer_backward gave two dw or db on one bucket (D={b.nbrs.shape[1]})")
    dh = torch.where(z > 0, dz.float(), 0.0).abs()
    a = sage.gather_mean_plain(table, b.keys, b.nbrs, b.valid).float().abs()
    errs = []
    for x, y, tol in zip(got, want, (SAGE_BWD_RTOL * (a.T @ dh) + 1e-6, SAGE_BWD_DB_RTOL * dh.sum(0) + 1e-6)):
        diff = (x - y).abs()
        if bool((diff > tol).any()):
            raise RuntimeError(f"sage_layer_backward differs from its twin past its bound (D={b.nbrs.shape[1]}, "
                               f"max |err| {float(diff.max()):.6g})")
        errs.append(float(diff.max()))
    return tuple(errs)


def step_grads_err(params, args) -> tuple:
    """(loss |rel err|, grads max |err|) of one step's loss and gradients
    through the kernels (SageLayerFn) against autograd of the plain twin on
    the same inputs, on the card, within TRAIN_LOSS_RTOL and
    TRAIN_GRAD_RTOL / TRAIN_GRAD_ATOL."""
    import torch

    from gelly_streaming_tpu_torch.library import graphsage as gs
    from gelly_streaming_tpu_torch.ops import sage

    loss = gs.sage_loss(params, *args)
    grads = torch.autograd.grad(loss, list(params))
    loss_p = gs._loss(sage.sage_layer_plain, params, *args)
    grads_p = torch.autograd.grad(loss_p, list(params))
    loss, loss_p = float(loss.detach()), float(loss_p.detach())
    rel = abs(loss - loss_p) / abs(loss_p)
    worst = 0.0
    for g, w in zip(grads, grads_p):
        diff = (g - w).abs()
        if bool((diff > TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * w.abs()).any()) or not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"a step's gradient differs from the twin's autograd (max |err| "
                               f"{float(diff.max()):.6g})")
        worst = max(worst, float(diff.max()))
    if rel > TRAIN_LOSS_RTOL:
        raise RuntimeError(f"a step's loss {loss} differs from the twin's {loss_p}")
    return rel, worst


def train_profile(fn, reps: int):
    """(device busy ms per call of ``fn`` by torch.profiler, its top six
    device rows as (name, ms per call)); (None, []) if the profiler
    fails.  Only the device's own rows (kernels, copies, sets) count: the
    autograd and optimizer ranges, and their annotations on the device's
    timeline, also carry the device time of what they launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
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
            device_row = getattr(evt, "device_type", None) == DeviceType.CUDA
            if device_row and not getattr(evt, "is_user_annotation", False) and us and evt.count:
                rows[evt.key] = (us / evt.count, evt.count)
    except Exception as e:  # the profiler is a side measurement; report and go on
        log(f"  torch.profiler failed: {type(e).__name__}: {e}")
        return None, []
    top = sorted(rows.items(), key=lambda r: -r[1][0] * r[1][1])[:6]
    names = [re.split(r"[<(]", k.replace("(anonymous namespace)::", "").removeprefix("void "))[0]
             .split("::")[-1].strip()[:40] for k, _ in top]
    return (sum(us * calls for us, calls in rows.values()) / reps / 1e3,
            [(name, round(us * calls / reps / 1e3, 4)) for name, (_, (us, calls)) in zip(names, top)])


def parent_sage_calls(lib):
    """(layer, backward): the parent's sage_layer and sage_layer_backward
    C calls over ``lib``, as their wrappers made them (the same scratch
    and partial sums): layer(table, keys, nbrs, valid, w, bias, out) and
    backward(table, keys, nbrs, valid, z, dz, dw, db)."""
    import torch

    from gelly_streaming_tpu_torch.ops import _cuda, sage

    def layer(table, keys, nbrs, valid, w, bias, out):
        (c, f_in), (k, d), f_out = table.shape, nbrs.shape, w.shape[1]
        nchunks, part, cnt = sage._partials(table, k, d)
        _cuda.check(lib.sage_layer_launch(
            table.data_ptr(), c, f_in, keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, w.data_ptr(),
            bias.data_ptr(), f_out, out.data_ptr(), sage._CHUNK, nchunks, sage._ptr(part), sage._ptr(cnt),
            torch.cuda.current_stream(table.device).cuda_stream), "parent sage_layer_launch")
        return out

    def backward(table, keys, nbrs, valid, z, dz, dw, db):
        (c, f_in), (k, d), f_out = table.shape, nbrs.shape, z.shape[1]
        nbytes = lib.sage_layer_backward_scratch_bytes(f_in, f_out)
        scratch = torch.empty((nbytes,), dtype=torch.uint8, device=table.device)
        nchunks, part, cnt = sage._partials(table, k, d)
        _cuda.check(lib.sage_layer_backward_launch(
            table.data_ptr(), c, f_in, keys.data_ptr(), nbrs.data_ptr(), valid.data_ptr(), k, d, z.data_ptr(),
            dz.data_ptr(), f_out, dw.data_ptr(), db.data_ptr(), sage._CHUNK, nchunks, sage._ptr(part),
            sage._ptr(cnt), scratch.data_ptr(), nbytes, torch.cuda.current_stream(table.device).cuda_stream),
            "parent sage_layer_backward_launch")
        return dw, db

    return layer, backward


def ptxas_report(log: str, pattern: str) -> dict:
    """{mangled kernel name: {"registers", "stack", "spill_stores",
    "spill_loads"}} of the entry functions whose name contains
    ``pattern``, from nvcc's ``-Xptxas -v`` log (their shared memory is
    dynamic: the launch asks for it, ptxas does not see it)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if pattern in m.group(1) else None
        elif cur and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                                     line)):
            out.setdefault(cur, {}).update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif cur and (m := re.search(r"Used (\d+) registers", line)):
            out.setdefault(cur, {})["registers"] = int(m[1])
    return out


def phase_train(dev, cycles_per_ms: float, parent=None, sage_log: str = "", split_cu=None) -> dict:
    """Phase 13: GraphSAGE training at F = 128 through sage_init_train,
    sample_pairs and sage_train_step: (a) the JAX bench's batch, 20 steps;
    (b) every bucket of phase 12's first uniform pane (slice(ALL) ->
    build_buckets), one step a bucket for TRAIN_PASSES passes, then the hub
    pane's buckets once, launches counted; (c) sage_layer_backward against
    its twin on every bucket of (a) and (b) and bit for bit across runs, a
    whole step against the twin's autograd; (d) the backward's times over
    the pane's buckets and their contexts, its kernels' split by
    torch.profiler and their ptxas report (``sage_log``: sage.cu's build
    log), the forward over the contexts, and with ``parent`` (a loaded
    sage.cu with the ece4aae C interface) the parent's backward and
    forward in turns with the current ones; with ``split_cu`` ({part:
    source}, BACKWARD_SPLIT's variants) each variant's backward timed
    beside the current one."""
    import torch

    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeDirection
    from gelly_streaming_tpu_torch.library import graphsage as gs
    from gelly_streaming_tpu_torch.ops import _cuda
    from gelly_streaming_tpu_torch.ops import neighborhoods as nbh
    from gelly_streaming_tpu_torch.ops import sage

    f = SAGE_FEATURES
    out = {}

    # (a) the bench's batch (bench.py's seed 9 and draws)
    rng = np.random.default_rng(9)
    k, d, c = TRAIN_BENCH_K, TRAIN_BENCH_D, TRAIN_BENCH_C
    feats = rng.normal(size=(c, f)).astype(np.float32)
    keys = rng.integers(0, c, k).astype(np.int32)
    nbrs = rng.integers(0, c, (k, d)).astype(np.int32)
    valid = rng.random((k, d)) < 0.8
    table = torch.from_numpy(feats).to(dev).to(torch.bfloat16)
    tk, tn, tv = to_dev((keys, nbrs, valid), dev)
    state = gs.sage_init_train(f, f, lr=TRAIN_LR, generator=torch.Generator().manual_seed(1), device=dev)
    pairs = gs.sample_pairs(torch.Generator(device=dev).manual_seed(2), tn, tv, c)
    args = (table, tk, tn, tv, *pairs)
    bench_step_err = step_grads_err(state.params, args)
    times, losses = [], []
    for _ in range(TRAIN_BENCH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = gs.sage_train_step(state, *args)
        losses.append(float(loss))  # synchronizes
        times.append(time.perf_counter() - t0)
    p50 = float(np.percentile(times[1:], 50)) * 1e3
    if not all(np.isfinite(losses)) or losses[-1] >= losses[0]:
        raise RuntimeError(f"the bench batch's loss did not fall: {losses}")
    busy, top = train_profile(lambda: gs.sage_train_step(state, *args), 5)
    idle = None if busy is None else 100 * (1 - busy / p50)
    log(f"  (a) the bench's batch (K = {k}, D = {d}, p = 0.8, {c} vertices, F = {f}, lr {TRAIN_LR}): "
        f"{TRAIN_BENCH_STEPS} steps, step p50 {p50:.4f} ms (host clock, synchronized; the first "
        f"{times[0] * 1e3:.2f} ms), {k / p50 * 1e3:.6g} pairs/s, loss {losses[0]:.6g} -> {losses[-1]:.6g}; "
        f"torch.profiler: device busy {busy if busy is None else round(busy, 4)} ms a step, idle "
        f"{idle if idle is None else round(idle, 2)}%; a step against the twin's autograd: loss rel err "
        f"{bench_step_err[0]:.3g}, grads max |err| {bench_step_err[1]:.3g}; top device rows a step: {top}")
    z = sage.sage_layer(table, tk, tn, tv, gs._stacked(gs._as_bf16(state.params)).detach(),
                        state.params.bias.detach().to(torch.bfloat16))
    dz = torch.randn(z.shape, generator=torch.Generator(device=dev).manual_seed(3), device=dev).to(torch.bfloat16)
    bench_bucket = nbh.NeighborhoodBucket(tk, tn, None, tv, k)
    bench_err = backward_err(table, bench_bucket, z, dz)
    out["bench"] = {"step_p50_ms": p50, "first_step_ms": times[0] * 1e3, "pairs_per_s": k / p50 * 1e3,
                    "loss_first": losses[0], "loss_last": losses[-1], "device_busy_ms": busy, "idle_pct": idle,
                    "step_loss_rel_err": bench_step_err[0], "step_grad_err": bench_step_err[1],
                    "backward_err": bench_err}
    del table, args, pairs, z, dz

    # (b) the main path at realistic scale: a uniform pane's buckets, then the hub pane's
    c, e = SAGE_VERTICES, SAGE_PANE_EDGES
    src, dst = sage_stream_arrays()
    table = torch.randn((c, f), generator=torch.Generator(device=dev).manual_seed(4), device=dev).to(torch.bfloat16)
    cfg = StreamConfig(vertex_capacity=c, batch_size=e, ingest_window_edges=e)

    def buckets(w):  # pane w's non-empty buckets, through slice(ALL)
        return list(EdgeStream.from_arrays(src[w * e:(w + 1) * e], dst[w * e:(w + 1) * e], cfg, device=dev).slice(
            WINDOW_MS, EdgeDirection.ALL)._neighborhood_panes())

    state = gs.sage_init_train(f, f, lr=TRAIN_LR, generator=torch.Generator().manual_seed(0), device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    nbh.reset_launches()
    sage.reset_launches()
    t_run = time.perf_counter()
    hoods = buckets(0)
    step_s = [0.0] * len(hoods)
    pass_loss, sample_s, steps = [], 0.0, 0
    for _ in range(TRAIN_PASSES):
        total = 0.0
        for i, h in enumerate(hoods):
            t0 = time.perf_counter()
            pairs = gs.sample_pairs(gen, h.nbrs, h.valid, c)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, loss = gs.sage_train_step(state, table, h.keys, h.nbrs, h.valid, *pairs)
            total += float(loss) * h.num_keys  # synchronizes
            step_s[i] += time.perf_counter() - t1
            sample_s += t1 - t0
            steps += 1
        pass_loss.append(total / sum(h.num_keys for h in hoods))
    hub = buckets(SAGE_PANES)
    hub_losses = []
    for h in hub:
        pairs = gs.sample_pairs(gen, h.nbrs, h.valid, c)
        state, loss = gs.sage_train_step(state, table, h.keys, h.nbrs, h.valid, *pairs)
        hub_losses.append(float(loss))
        steps += 1
    run_s = time.perf_counter() - t_run
    launches = {"build_buckets": nbh.LAUNCHES["build_buckets"], "sage_layer": sage.LAUNCHES["sage_layer"],
                "sage_layer_backward": sage.LAUNCHES["sage_layer_backward"]}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if launches != {"build_buckets": 2, "sage_layer": 2 * steps, "sage_layer_backward": 2 * steps}:
        raise RuntimeError(f"training launched {launches} for {steps} steps over 2 panes")
    if not all(np.isfinite(pass_loss + hub_losses)) or pass_loss[-1] >= pass_loss[0]:
        raise RuntimeError(f"the pane's loss did not fall over the passes: {pass_loss}")
    rows = sum(h.num_keys for h in hoods)
    train_s = sum(step_s)

    def one_pass():
        nonlocal state
        for h in hoods:
            state, _ = gs.sage_train_step(state, table, h.keys, h.nbrs, h.valid,
                                          *gs.sample_pairs(gen, h.nbrs, h.valid, c))

    pass_busy, pass_top = train_profile(one_pass, 1)
    log(f"  (b) uniform pane 0 ({rows} keys in {len(hoods)} buckets, D {[h.nbrs.shape[1] for h in hoods]}, "
        f"{c} vertices, F = {f}): {TRAIN_PASSES} passes of one step a bucket; step ms a bucket "
        f"{[round(x / TRAIN_PASSES * 1e3, 3) for x in step_s]}, a pass {train_s / TRAIN_PASSES * 1e3:.3f} ms, "
        f"{rows * TRAIN_PASSES / train_s:.6g} pairs/s (steps alone; sample_pairs {sample_s * 1e3:.2f} ms in all); "
        f"loss a pass (row-weighted) {[round(x, 5) for x in pass_loss]}; then the hub pane's {len(hub)} buckets "
        f"once (D up to {max(h.nbrs.shape[1] for h in hub)}): losses {[round(x, 4) for x in hub_losses]}; the whole "
        f"run {run_s:.3f} s with the two slice() builds; peak device memory {peak_gb:.3f} GB; launches {launches}; "
        f"torch.profiler, one more pass: device busy {pass_busy if pass_busy is None else round(pass_busy, 4)} ms "
        f"({'-' if pass_busy is None else round(100 * (1 - pass_busy / (train_s / TRAIN_PASSES * 1e3)), 2)}% idle "
        f"against a counted pass), top rows {pass_top}")

    # (c) the kernel against its twin on every bucket, the trained weights' z
    w = gs._stacked(gs._as_bf16(state.params)).detach()
    bias = state.params.bias.detach().to(torch.bfloat16)
    zs, dzs = [], []
    worst = [0.0, 0.0]
    g3 = torch.Generator(device=dev).manual_seed(6)
    for h in hoods + hub:
        z = sage.sage_layer(table, h.keys, h.nbrs, h.valid, w, bias)
        dz = torch.randn(z.shape, generator=g3, device=dev).to(torch.bfloat16)
        worst = list(map(max, worst, backward_err(table, h, z, dz)))
        if len(zs) < len(hoods):
            zs.append(z)
            dzs.append(dz)
    big = max(hoods, key=lambda h: h.num_keys)
    pane_step_err = step_grads_err(state.params, (table, big.keys, big.nbrs, big.valid,
                                                  *gs.sample_pairs(gen, big.nbrs, big.valid, c)))
    log(f"  (c) sage_layer_backward within {SAGE_BWD_RTOL} * |A|^T |dH| (db: {SAGE_BWD_DB_RTOL} * sum |dH|) of its "
        f"twin on the bench's bucket and all {len(hoods) + len(hub)} buckets of both panes, equal bit for bit "
        f"across two runs: max |err| dw {max(worst[0], bench_err[0]):.6g}, db {max(worst[1], bench_err[1]):.6g}; "
        f"a step on the largest bucket ({big.num_keys} keys) against the twin's autograd: loss rel err "
        f"{pane_step_err[0]:.3g}, grads max |err| {pane_step_err[1]:.3g}")

    # (d) the backward over the uniform pane's buckets: device only, bound, twin, library
    dws = torch.zeros((2 * f, f), dtype=torch.float32, device=dev)
    dbs = torch.zeros((f,), dtype=torch.float32, device=dev)

    def backward():
        for h, z, dz in zip(hoods, zs, dzs):
            sage.sage_layer_backward(table, h.keys, h.nbrs, h.valid, z, dz, dws, dbs)

    b_ms, b_us = device_ms(backward, SAGE_REPS, cycles_per_ms)
    b_events = cuda_ms(backward, SAGE_REPS)
    plain_ms = cuda_ms(lambda: [sage.sage_layer_backward_plain(table, h.keys, h.nbrs, h.valid, z, dz, dws, dbs)
                                for h, z, dz in zip(hoods, zs, dzs)], 2, 1)
    slots = sum(h.nbrs.numel() for h in hoods)
    distinct = int(torch.unique(torch.cat([h.keys for h in hoods] + [h.nbrs[h.valid] for h in hoods])).numel())
    # each input once: ids and flags, each distinct table row a key or a
    # valid neighbor names, z and dz; dw and db read and written once
    bytes_ = 4 * rows + 5 * slots + 2 * f * distinct + 2 * 2 * f * rows + 2 * 4 * (2 * f * f + f)
    ops = 2 * rows * 2 * f * f
    bytes_ms, ops_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops / BF16_FLOPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    # the yardstick: embedding_bag(mode="mean") over the valid neighbors,
    # then one product A^T dH (bf16, the tensor cores); on no path
    flat = torch.cat([h.nbrs[h.valid] for h in hoods]).long()
    offs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(torch.cat([h.valid.sum(1) for h in hoods]), 0)[:-1]])
    keys_all = torch.cat([h.keys for h in hoods]).long()
    bag = torch.nn.functional.embedding_bag(flat, table, offs, mode="mean")
    xm_t = torch.cat([table[keys_all], bag.to(torch.bfloat16)], 1).t()
    dh = torch.cat([torch.where(z > 0, dz, 0) for z, dz in zip(zs, dzs)])
    bag_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(flat, table, offs, mode="mean"), SAGE_REPS)
    mm_ms = cuda_ms(lambda: torch.mm(xm_t, dh), SAGE_REPS)
    ref = torch.zeros_like(dws)
    for h, z, dz in zip(hoods, zs, dzs):
        sage.sage_layer_backward(table, h.keys, h.nbrs, h.valid, z, dz, ref, torch.zeros_like(dbs))
    lib_err = float((torch.mm(xm_t, dh).float() - ref).abs().max())
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  (d) sage_layer_backward over the uniform pane's {len(hoods)} buckets ({rows} rows, {slots} slots), "
        f"device only: {b_ms:.4f} ms, host enqueue {b_us:.1f} us ({b_us / len(hoods):.2f} us a call); back-to-back "
        f"events {b_events:.4f} ms; bound {bound:.5f} ms ({bound_by}: {bytes_} B, {distinct} distinct table rows, "
        f"{bytes_ms:.5f} ms; {ops} bf16 operations, {ops_ms:.5f} ms), {b_ms / bound:.3f}x it; plain twin "
        f"{plain_ms:.3f} ms; yardstick embedding_bag(mode='mean') {bag_ms:.4f} ms + mm(A^T, dH) {mm_ms:.4f} ms = "
        f"{bag_ms + mm_ms:.4f} ms (max |diff| of its dw to the kernel's {lib_err:.4g})")
    # the step's other backward call: the contexts, 2K rows a bucket over an
    # empty neighborhood (a self row each, the W_nbr half's product all 0)
    ctx = []
    for h in hoods:
        ids = torch.cat(gs.sample_pairs(gen, h.nbrs, h.valid, c)[::2])
        empty = ids.new_empty((ids.shape[0], 0))
        cz = sage.sage_layer(table, ids, empty, empty.bool(), w, bias)
        ctx.append((ids, empty, empty.bool(), cz, torch.randn(cz.shape, generator=g3, device=dev).to(torch.bfloat16)))

    def ctx_backward():
        for ids, empty, none, cz, cdz in ctx:
            sage.sage_layer_backward(table, ids, empty, none, cz, cdz, dws, dbs)

    c_ms, c_us = device_ms(ctx_backward, SAGE_REPS, cycles_per_ms)
    c_rows = 2 * rows
    c_distinct = int(torch.unique(torch.cat([x[0] for x in ctx])).numel())
    # the self half alone: a self row, z and dz a row; dw's W_self rows and
    # db read and written once; the product x_self^T dH
    c_bytes = 4 * c_rows + 2 * f * c_distinct + 2 * 2 * f * c_rows + 2 * 4 * (f * f + f)
    c_bound = max(c_bytes / HBM_BYTES_PER_S * 1e3, 2 * c_rows * f * f / BF16_FLOPS_PER_S * 1e3)
    log(f"  (d) sage_layer_backward over the contexts of the pane's {len(hoods)} steps ({c_rows} rows, D = 0), "
        f"device only: {c_ms:.4f} ms, host enqueue {c_us / len(ctx):.2f} us a call; bound {c_bound:.5f} ms "
        f"({c_bytes} B, {c_distinct} distinct table rows; the self half's product), {c_ms / c_bound:.3f}x it")
    # the kernels' split by torch.profiler (the reduce's share), and what
    # ptxas reported for the tensor-core instantiations
    split = {}
    for label, fn in (("buckets", backward), ("contexts", ctx_backward)):
        busy_ms, top = train_profile(fn, 5)
        split[label] = {"device_busy_ms": busy_ms, "rows": top,
                        "reduce_share": None if not busy_ms else
                        sum(ms for name, ms in top if "reduce" in name) / busy_ms}
        log(f"  (d) torch.profiler over the {label}' backward: device busy {busy_ms} ms, rows {top}; the reduce's "
            f"share {split[label]['reduce_share']}")
    ptxas = ptxas_report(sage_log, "sage_backward_wgmma_kernel")
    log(f"  (d) ptxas for sage_backward_wgmma_kernel (ILb0: [x_self | mean], ILb1: the self half): {ptxas}")
    # the forward over the same contexts (its D = 0 skip of the mean half)
    ctx_out = [torch.empty_like(x[3]) for x in ctx]

    def ctx_forward():
        for (ids, empty, none, _cz, _cdz), o in zip(ctx, ctx_out):
            sage.sage_layer(table, ids, empty, none, w, bias, out=o)

    f_ms, _ = device_ms(ctx_forward, SAGE_REPS, cycles_per_ms)
    log(f"  (d) sage_layer over the same contexts (D = 0), device only: {f_ms:.4f} ms")
    turns = {}
    if parent is not None:
        p_layer, p_backward = parent_sage_calls(parent)
        got = [torch.zeros_like(dws), torch.zeros_like(dws)]
        for h, z, dz in zip(hoods, zs, dzs):
            p_backward(table, h.keys, h.nbrs, h.valid, z, dz, got[0], torch.zeros_like(dbs))
            sage.sage_layer_backward(table, h.keys, h.nbrs, h.valid, z, dz, got[1], torch.zeros_like(dbs))
        rel = float((got[0] - got[1]).abs().max() / got[1].abs().max())
        if not rel < 2.0 ** -7:
            raise RuntimeError(f"the parent's backward and sage_layer_backward disagree (max rel {rel:.3g})")

        def p_backward_all():
            for h, z, dz in zip(hoods, zs, dzs):
                p_backward(table, h.keys, h.nbrs, h.valid, z, dz, dws, dbs)

        def p_ctx_backward():
            for ids, empty, none, cz, cdz in ctx:
                p_backward(table, ids, empty, none, cz, cdz, dws, dbs)

        def p_ctx_forward():
            for (ids, empty, none, _cz, _cdz), o in zip(ctx, ctx_out):
                p_layer(table, ids, empty, none, w, bias, o)

        turns = {
            "buckets": in_turns("uniform pane's buckets, the backward (parent: ece4aae, the CUDA cores)",
                                p_backward_all, backward, SAGE_REPS, cycles_per_ms),
            "contexts": in_turns("the contexts, the backward (parent: ece4aae)", p_ctx_backward, ctx_backward,
                                 SAGE_REPS, cycles_per_ms),
            "contexts_forward": in_turns("the contexts, the forward sage_layer (parent: ece4aae)", p_ctx_forward,
                                         ctx_forward, SAGE_REPS, cycles_per_ms),
            "max_rel_diff": rel,
        }
    for part, path in (split_cu or {}).items():
        if not _cuda._target(path).exists():  # its build failed in phase 1
            log(f"  (d) split: the variant without {part} did not build; skipped")
            continue
        _, v_backward = parent_sage_calls(load_baseline(path, PARENT_SIGNATURES["sage_backward"]))

        def v_buckets():
            for h, z, dz in zip(hoods, zs, dzs):
                v_backward(table, h.keys, h.nbrs, h.valid, z, dz, dws, dbs)

        def v_contexts():
            for ids, empty, none, cz, cdz in ctx:
                v_backward(table, ids, empty, none, cz, cdz, dws, dbs)

        v = {"buckets_ms": device_ms(v_buckets, SAGE_REPS, cycles_per_ms)[0],
             "contexts_ms": device_ms(v_contexts, SAGE_REPS, cycles_per_ms)[0]}
        turns.setdefault("split", {})[part] = v
        log(f"  (d) split: without {part}: buckets {v['buckets_ms']:.4f} ms, contexts {v['contexts_ms']:.4f} ms "
            f"(the kernel as committed: {b_ms:.4f}, {c_ms:.4f})")
    out["backward"] = {"ms": b_events, "device_ms": b_ms, "host_us": b_us, "host_us_a_call": b_us / len(hoods),
                       "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "bytes_ms": bytes_ms,
                       "ops_ms": ops_ms, "ratio_to_bound": b_ms / bound, "library_ms": bag_ms + mm_ms,
                       "embedding_bag_ms": bag_ms, "mm_ms": mm_ms,
                       "launches": launches["sage_layer_backward"],
                       "err": max(worst[0], worst[1], bench_err[0], bench_err[1]),
                       "dw_err": max(worst[0], bench_err[0]), "db_err": max(worst[1], bench_err[1]),
                       "contexts": {"device_ms": c_ms, "host_us_a_call": c_us / len(ctx), "bound_ms": c_bound,
                                    "ratio_to_bound": c_ms / c_bound, "rows": c_rows, "forward_device_ms": f_ms},
                       "split": split, "ptxas": ptxas, **({"turns": turns} if turns else {})}
    out["pane"] = {"rows": rows, "buckets": len(hoods), "step_ms": [x / TRAIN_PASSES * 1e3 for x in step_s],
                   "pass_ms": train_s / TRAIN_PASSES * 1e3, "pairs_per_s": rows * TRAIN_PASSES / train_s,
                   "pass_loss": pass_loss, "hub_losses": hub_losses, "peak_gb": peak_gb, "launches": launches,
                   "pass_device_busy_ms": pass_busy,
                   "step_loss_rel_err": pane_step_err[0], "step_grad_err": pane_step_err[1]}
    return out


def phase_turns(dev, cycles_per_ms: float, parent_cu: dict, split_cu: dict, props: dict, cc: dict,
                bp: dict) -> dict:
    """Phase 11: the redesigned degree_trace and union calls in turns with
    the parent commit's builds on the main path's inputs (parent, current,
    current, parent; device only, on the held stream), and the split of the
    parent's degree_trace kernel (each part removed in turn)."""
    import torch

    from gelly_streaming_tpu_torch.ops import degrees
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    libs = {k: load_baseline(path, PARENT_SIGNATURES[k]) for k, path in parent_cu.items()}
    out = {}

    def turns(label, old_fn, new_fn, reps=UF_REPS):
        got = []
        for tag, fn in (("parent", old_fn), ("current", new_fn), ("current", new_fn), ("parent", old_fn)):
            got.append((tag, *fn(reps)))
        log(f"  {label}: " + "; ".join(f"{tag} {ms:.4f} ms" for tag, ms, _ in got))
        old = (got[0][1] + got[3][1]) / 2
        new = (got[1][1] + got[2][1]) / 2
        log(f"    mean parent {old:.4f} ms, current {new:.4f} ms, {old / new:.2f}x")
        return {"parent_ms": old, "current_ms": new, "turns": [ms for _, ms, _ in got]}

    if "degrees" in libs:
        v, m = props["turns"]
        counts = torch.zeros(CC_VERTICES, dtype=torch.int32, device=dev)
        p_kernel, p_call = parent_trace(libs["degrees"], counts, v, m)
        # both kernels' records agree on the main path's rows (ids in range)
        c_a, c_b = counts.clone(), counts.clone()
        rec_new = degrees.degree_trace(c_a, v, m, True)
        counts.copy_(c_b)
        rec_old = p_call()
        torch.cuda.synchronize()
        if not (torch.equal(rec_new[0], rec_old[0]) and torch.equal(rec_new[1], rec_old[1]) and torch.equal(c_a, counts)):
            raise RuntimeError("the parent's degree_trace and the current one disagree on the main path's rows")
        n_kernel = trace_launcher(counts, v, m)
        held = lambda fn: lambda reps: device_ms(fn, reps, cycles_per_ms)  # noqa: E731
        out["trace_kernel"] = turns(f"degree_trace kernels alone, {v.shape[0]} rows", held(p_kernel), held(n_kernel))
        out["trace_call"] = turns("degree_trace call (keys, stable sort, kernels)", held(p_call),
                                  held(lambda: degrees.degree_trace(counts, v, m, True)))
        sort_ms, _ = device_ms(lambda: torch.sort((v << 1) | (~m).to(torch.int32), stable=True), UF_REPS,
                               cycles_per_ms)
        out["trace_sort_ms"] = sort_ms
        log(f"  the keys and the stable torch.sort alone: {sort_ms:.4f} ms")
        if split_cu:
            if v.shape[0] & (v.shape[0] - 1):
                raise RuntimeError("the split's permutation variant needs 2^k rows")
            split = {}
            for part, path in split_cu.items():
                k_fn, _ = parent_trace(load_baseline(path, PARENT_SIGNATURES["degrees"]), counts, v, m)
                r = turns(f"split: parent kernel without {part}", held(p_kernel), held(k_fn))
                split[part] = {"full_ms": r["parent_ms"], "without_ms": r["current_ms"]}
            out["trace_split"] = split
    if "unionfind" in libs:
        for name, res, parity, fold in (("CC", cc, False, uf.union_edges_with_seen),
                                        ("parity", bp, True, uf.parity_union_edges_with_seen)):
            t = res["turns"]
            old_fold = parent_union_fold(libs["unionfind"], parity)
            for batch, state, edges, flat in (("first", t["init"], t["first_batch"], False),
                                              ("late", t["late"], t["late_batch"], True)):
                want = fold(uf.mark_flat(state[0].clone()) if flat else state[0].clone(), state[1].clone(), *edges)
                got = old_fold(state[0].clone(), state[1].clone(), *edges)
                if not (torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])):
                    raise RuntimeError(f"the parent's {name} union and the current one disagree ({batch} batch)")
                out[f"{name}_{batch}"] = turns(
                    f"{name} union call, {batch} batch",
                    lambda reps, f=old_fold, st=state, e=edges: fold_device_ms(f, *st, *e, reps, cycles_per_ms),
                    lambda reps, st=state, e=edges, fl=flat: fold_device_ms(fold, *st, *e, reps, cycles_per_ms, flat=fl))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--baseline-cu", default=None,
                        help="a pane_triangles.cu with the first slice's C interface, "
                             "timed in turns with the current kernels")
    parser.add_argument("--parent-degrees-cu", default=None,
                        help="degrees.cu of the commit before the degree_trace redesign (its C interface): "
                             "its degree_trace is timed in turns with the current one and split")
    parser.add_argument("--parent-unionfind-cu", default=None,
                        help="unionfind.cu of the commit before the union redesign (its C interface), "
                             "timed in turns with the current one")
    parser.add_argument("--parent-sage-cu", default=None,
                        help="sage.cu of the commit before the fused layer (its gather-mean C interface): its "
                             "gather, then addmm and relu, timed in turns with sage_layer")
    parser.add_argument("--parent-sage-backward-cu", default=None,
                        help="sage.cu of the commit before the tensor-core backward (ece4aae; the same C interface): "
                             "its backward and its layer over the contexts timed in turns with the current ones")
    parser.add_argument("--parent-neighborhoods-cu", default=None,
                        help="neighborhoods.cu of the commit before the radix sort (its C interface): "
                             "torch.sort, then its count and scatter, timed in turns with build_buckets")
    args = parser.parse_args(argv)
    baseline_cu = os.path.abspath(args.baseline_cu) if args.baseline_cu else None
    parent_backward_cu = os.path.abspath(args.parent_sage_backward_cu) if args.parent_sage_backward_cu else None
    parent_cu = {k: os.path.abspath(path) for k, path in (("degrees", args.parent_degrees_cu),
                                                           ("unionfind", args.parent_unionfind_cu)) if path}
    parent_sage_cu = {k: os.path.abspath(path) for k, path in (("sage", args.parent_sage_cu),
                                                                ("neighborhoods", args.parent_neighborhoods_cu))
                      if path}
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
    split_cu = split_sources(parent_cu["degrees"], TRACE_SPLIT, "degrees") if "degrees" in parent_cu else {}
    bwd_split_cu = split_sources(str(_cuda.CSRC_DIR / "sage.cu"), BACKWARD_SPLIT, "sage") if parent_backward_cu else {}
    sources = [*_cuda.SIGNATURES, *([baseline_cu] if baseline_cu else []), *parent_cu.values(), *split_cu.values(),
               *parent_sage_cu.values(), *([parent_backward_cu] if parent_backward_cu else [])]
    split_failed = []

    def build_split():  # beside the main build; a variant that does not build is skipped
        try:
            _cuda.build_all(list(bwd_split_cu.values()))
        except RuntimeError as e:
            split_failed.append(str(e).splitlines()[0])

    split_thread = threading.Thread(target=build_split)
    split_thread.start()
    built = _cuda.build_all(sources)
    split_thread.join()
    if split_failed:
        log(f"  backward split: {split_failed[0]} (those variants are skipped)")
    log(f"  built {len(built)} sources in {time.perf_counter() - t0:.2f} s: {sorted(built)}")
    for src, res in built.items():
        if src not in _cuda.SIGNATURES:
            continue
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
    data = cc_bench_stream()
    cc = phase_cc_main(dev, cpm, data)
    log("phase 8: property streams over the CC bench's stream on the card")
    props = phase_properties(dev, cpm, data)
    log("phase 9: degree distribution: the EF40 summary fold and the signed scan")
    dd = phase_degree_dist(dev, cpm, data)
    log("phase 10: bipartiteness over the EF40 replay, and the windowed path")
    bp = phase_bipartite(dev, cpm, data)
    log("phase 12: slice() and windowed GraphSAGE at F = 128 on the card")
    sg = phase_sage(dev, cpm, {k: load_baseline(path, PARENT_SIGNATURES[k]) for k, path in parent_sage_cu.items()})
    log("phase 13: GraphSAGE training at F = 128 on the card")
    tr = phase_train(dev, cpm, load_baseline(parent_backward_cu, PARENT_SIGNATURES["sage_backward"])
                     if parent_backward_cu else None, built["sage.cu"].log, bwd_split_cu)
    turned = {}
    if parent_cu:
        log(f"phase 11: in turns with the parent builds {sorted(parent_cu.values())}")
        turned = phase_turns(dev, cpm, parent_cu, split_cu, props, cc, bp)

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
            "first_call_ms": cc["first_ms"],
            "late_call_ms": cc["late_ms"],
            "rounds": cc["rounds"],
            **{f"turns_{b}": turned[f"CC_{b}"] for b in ("first", "late") if f"CC_{b}" in turned},
        },
        {
            "name": "compress_kernel",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/unionfind.cu",
            "replaces": "gelly_streaming_tpu/ops/unionfind.py:27",
            # the CC fold's and the parity fold's (each C call compresses first)
            "launches": cc["launches"]["compress_kernel"] + bp["compress_launches"],
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

    def entry(name, source, replaces, r, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"gelly_streaming_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
                "device_ms": r["device_ms"], "host_us": r["host_us"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": "bytes", "library_ms": library_ms}

    kernels += [
        {**entry("degree_trace", "degrees.cu", "gelly_streaming_tpu/core/stream.py:869", props),
         "call_ms": props["call_ms"],
         **{k: turned[k] for k in ("trace_kernel", "trace_call", "trace_sort_ms", "trace_split") if k in turned}},
        entry("degree_fold", "degrees.cu", "gelly_streaming_tpu/library/degree_distribution.py:247", dd["fold"],
              dd["fold"]["library_ms"]),
        {**entry("degree_dist_scan", "degrees.cu", "gelly_streaming_tpu/library/degree_distribution.py:43",
                 dd["scan"]),
         **{k: dd["scan"][k] for k in ("batch_events", "sort_ms", "serial_ms", "cut_launches", "small",
                                       "events_per_s", "records_per_s")}},
        {**entry("parity_union_kernel", "unionfind.cu", "gelly_streaming_tpu/ops/unionfind.py:145", bp),
         "first_call_ms": bp["first_ms"], "late_call_ms": bp["late_ms"], "rounds": bp["rounds"],
         **{f"turns_{b}": turned[f"parity_{b}"] for b in ("first", "late") if f"parity_{b}" in turned}},
    ]
    kernels += [
        {**entry("build_buckets", "neighborhoods.cu", "gelly_streaming_tpu/ops/neighborhoods.py:55", sg["build"],
                 sg["build"]["torch_sort_ms"]),
         "library_call": "torch.sort(stable=True) of the int32 grouping keys",
         **{k: sg["build"][k] for k in ("call_ms", "call_host_ms", "sort_ms", "passes", "hub", "turns")
            if k in sg["build"]}},
        {**entry("sage_layer", "sage.cu", "gelly_streaming_tpu/library/graphsage.py:53", sg["layer"],
                 sg["layer"]["library_ms"]),
         "bound_by": sg["layer"]["bound_by"],
         "library_call": "embedding_bag(mode='mean') + addmm (no one call computes the layer)",
         **{k: sg["layer"][k] for k in ("chunked_err", "mean_rel_err", "stack_err", "oracle_err", "embedding_bag_ms",
                                        "addmm_ms", "hub", "turns", "widths_ms") if k in sg["layer"]},
         "windows_per_s": sg["windows_per_s"],
         "edges_per_s": sg["edges_per_s"], "embeddings_per_s": sg["embeddings_per_s"]},
        {**entry("sage_layer_backward", "sage.cu", "gelly_streaming_tpu/library/graphsage.py:396", tr["backward"],
                 tr["backward"]["library_ms"]),
         "bound_by": tr["backward"]["bound_by"],
         "library_call": "embedding_bag(mode='mean') + mm(A^T, dH) (no one call computes the gradient)",
         **{k: tr["backward"][k] for k in ("host_us_a_call", "ratio_to_bound", "dw_err", "db_err",
                                           "embedding_bag_ms", "mm_ms", "contexts", "split", "ptxas", "turns")
            if k in tr["backward"]},
         "train_bench": tr["bench"], "train_pane": tr["pane"]},
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
