"""Measurement programs: throughput and latency of the port's hot paths.

Port of ``gelly_streaming_tpu/examples/measurements.py``: each subcommand
drives one workload through the port's real path (wire pack -> prefetched
upload -> device unpack and fold, as the JAX programs do) and prints ONE
JSON line of metrics, with the JAX program's keys and defaults.

  python -m gelly_streaming_tpu_torch.examples.measurements degrees       [options]
  python -m gelly_streaming_tpu_torch.examples.measurements bipartiteness [options]
  python -m gelly_streaming_tpu_torch.examples.measurements triangles     [options]
  python -m gelly_streaming_tpu_torch.examples.measurements spanner       [options]
  python -m gelly_streaming_tpu_torch.examples.measurements matching      [options]
  python -m gelly_streaming_tpu_torch.examples.measurements replay        [options]
  python -m gelly_streaming_tpu_torch.examples.measurements sage          [options]
  python -m gelly_streaming_tpu_torch.examples.measurements pagerank      [options]
  python -m gelly_streaming_tpu_torch.examples.measurements sssp          [options]
  python -m gelly_streaming_tpu_torch.examples.measurements kcore         [options]
  python -m gelly_streaming_tpu_torch.examples.measurements routing       [options]

Options: --edges N --vertices C --batch B --seed S, and --device=cuda|cpu
(default cuda; without a GPU only --device=cpu runs).  degrees adds --trace
(the running (vertex, degree) record trace through get_degrees) and, where
the host library builds, the Flink-shaped record-at-a-time baseline;
triangles takes --windows W --pane-vertices K (p50/p95 window latency);
spanner --max-degree D --k K --body auto|balls|bfs|both; sage --features F
--out-features G --max-degree D --train-steps N (N > 0 also times training
steps, the parameters drawn from a seeded torch.Generator); pagerank
--windows W --tol T; replay drives the wire-replay CC fold
(EdgeStream.from_wire) and reports the replay and pack rates and the
encoding's bytes an edge; routing --shards S --batch B --capacity K --alpha
A routes a zipf-keyed batch over an S-shard mesh of the local devices
(``parallel/routing.device_route`` against ``device_route_salted``) and
reports the drops and the per-shard receive imbalance, or ``skipped``
with fewer than S local devices, as the JAX program does.  Timings
synchronize the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from gelly_streaming_tpu_torch.device import resolve_device, synchronize

def _stream_fold(args, make_fold, init_state):
    """Synthetic edge stream through the shared wire-ingest harness."""
    from gelly_streaming_tpu_torch.utils.ingest_bench import wire_stream_fold

    if args.edges < 2:
        raise SystemExit("--edges must be at least 2")
    rng = np.random.default_rng(args.seed)
    src = rng.integers(0, args.vertices, args.edges).astype(np.int32)
    dst = rng.integers(0, args.vertices, args.edges).astype(np.int32)
    return wire_stream_fold(src, dst, args.vertices, args.batch, make_fold, init_state, device=args.dev)


def measure_degrees(args) -> dict:
    """Continuous degree fold (getDegrees' hot path,
    SimpleEdgeStream.java:461-478): the wire unpack, then ``degree_fold``."""
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import degrees

    def make_fold(batch, width):
        def fold(counts, buf):
            s, d = wire.unpack_edges(buf, batch, width)
            return degrees.degree_fold(counts, s, d)

        return fold

    eps, folded, counts = _stream_fold(
        args, make_fold, lambda: torch.zeros((args.vertices,), dtype=torch.int32)
    )
    counts_h = counts.cpu().numpy()
    out = {
        "workload": "degrees",
        "edges_per_sec": round(eps, 1),
        "edges_folded": folded,
        "degree_total": int(counts_h.sum(dtype=np.int64)),
    }
    proxy = _degree_flink_proxy(args, folded, counts_h)
    if proxy:
        out.update(proxy)
    if getattr(args, "trace", False):
        out.update(_measure_degree_trace(args))
    return out


def _degree_flink_proxy(args, folded, device_counts) -> dict:
    """The Flink-shaped denominator of the continuous degree aggregate:
    record-at-a-time Tuple2 serialization, keyBy hash and a socketpair
    shuffle, folding per-key HashMap degree counts, in C++ (the host
    library's ``flink_proxy_degrees``).  It folds exactly the prefix the
    device harness folded (full batches only), so the counts cross-check."""
    import statistics

    from gelly_streaming_tpu_torch.utils.native import load_ingest_lib

    lib = load_ingest_lib()
    if lib is None:
        return {}
    rng = np.random.default_rng(args.seed)
    src = rng.integers(0, args.vertices, args.edges).astype(np.int32)
    dst = rng.integers(0, args.vertices, args.edges).astype(np.int32)
    cnt = np.empty(args.vertices, np.int64)
    trials = []
    for _ in range(3):
        ns = lib.flink_proxy_degrees(src.ctypes.data, dst.ctypes.data, folded, cnt.ctypes.data, args.vertices)
        if ns <= 0:
            return {}
        trials.append(folded / (ns / 1e9))
    return {
        "flink_proxy_eps": round(statistics.median(trials), 1),
        # the harness folds the same seeded stream, so the counts must agree
        "flink_proxy_counts_ok": bool(np.array_equal(cnt, device_counts.astype(np.int64))),
    }


def _measure_degree_trace(args) -> dict:
    """The running-trace emission plane: the full (vertex, degree) record
    trace, two records an edge, through ``get_degrees()`` over a
    ``from_wire`` replay (buffers uploaded packed, unpacked on the card),
    with the downloads pipelined ahead of the consumer.  Reports records/s
    and the downloaded GB/s."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire

    rng = np.random.default_rng(args.seed)
    n = args.edges - args.edges % args.batch
    src = rng.integers(0, args.vertices, n).astype(np.int32)
    dst = rng.integers(0, args.vertices, n).astype(np.int32)
    cfg = StreamConfig(vertex_capacity=args.vertices, batch_size=args.batch)
    width = wire.width_for_capacity(args.vertices)
    bufs, _ = wire.pack_stream(src, dst, args.batch, width)

    def drain():
        records = nbytes = 0
        stream = EdgeStream.from_wire(bufs, args.batch, width, cfg, device=args.dev)
        for block in stream.get_degrees().blocks():
            records += len(block.columns[0])
            nbytes += sum(c.nbytes if hasattr(c, "nbytes") else 0 for c in block.columns)
        return records, nbytes

    drain()  # warm the kernels and the transfer path
    t0 = time.perf_counter()
    records, nbytes = drain()
    dt = time.perf_counter() - t0
    return {
        "trace_records": records,
        "trace_records_per_sec": round(records / dt, 1),
        "trace_host_gbps": round(nbytes / dt / 1e9, 5),
    }


def measure_bipartiteness(args) -> dict:
    """Streaming 2-coloring fold (BipartitenessCheck's hot path as the
    doubled-vertex parity union-find, ops/unionfind.py)."""
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    def make_fold(batch, width):
        def fold(state, buf):
            parent2, seen = state
            s, d = wire.unpack_edges(buf, batch, width)
            return uf.parity_union_edges_with_seen(parent2, seen, s, d)

        return fold

    eps, folded, (parent2, seen) = _stream_fold(
        args,
        make_fold,
        lambda: (uf.init_parity_parent(args.vertices, "cpu"), torch.zeros((args.vertices,), dtype=torch.bool)),
    )
    return {
        "workload": "bipartiteness",
        "edges_per_sec": round(eps, 1),
        "edges_folded": folded,
        "bipartite": bool(uf.is_bipartite(parent2, seen)),
    }


def measure_triangles(args) -> dict:
    """Per-window exact triangle count latency (WindowTriangles' hot path,
    ``library/triangles._pane_triangle_count``: the dense pane kernels)."""
    from gelly_streaming_tpu_torch.library.triangles import _pane_triangle_count
    from gelly_streaming_tpu_torch.utils.metrics import WindowLatencyRecorder

    rng = np.random.default_rng(args.seed)
    rec = WindowLatencyRecorder()
    k = args.pane_vertices
    per_pane = max(1, args.edges // max(1, args.windows))
    # an unmetered warm-up pane: the first call builds the kernels
    _pane_triangle_count(
        rng.integers(0, k, per_pane).astype(np.int32), rng.integers(0, k, per_pane).astype(np.int32), device=args.dev
    )
    total = 0
    for _ in range(args.windows):
        src = rng.integers(0, k, per_pane).astype(np.int32)
        dst = rng.integers(0, k, per_pane).astype(np.int32)
        t0 = time.perf_counter()
        total += _pane_triangle_count(src, dst, device=args.dev)  # an int: read back, so the card is done
        rec.record((time.perf_counter() - t0) * 1e3)
    return {
        "workload": "triangles",
        "windows": args.windows,
        "edges_per_window": per_pane,
        "pane_vertices": k,
        "triangles_total": int(total),
        "p50_window_ms": round(rec.percentile(50), 2),
        "p95_window_ms": round(rec.percentile(95), 2),
    }


def measure_spanner(args) -> dict:
    """Streaming k-spanner admission throughput (Spanner.java:71-77 through
    the two-phase batch admission)."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.spanner import Spanner, auto_body
    from gelly_streaming_tpu_torch.summaries import adjacency

    rng = np.random.default_rng(args.seed)
    src = rng.integers(0, args.vertices, args.edges).astype(np.int32)
    dst = rng.integers(0, args.vertices, args.edges).astype(np.int32)
    cfg = StreamConfig(vertex_capacity=args.vertices, max_degree=args.max_degree, batch_size=args.batch)

    def timed(body):
        agg = Spanner(window_ms=1000, k=args.k, body=body)

        def run():
            out = EdgeStream.from_arrays(src, dst, cfg, device=args.dev).aggregate(agg).collect()
            synchronize(args.dev)
            return out[-1][0]

        run()  # warm-up: kernels built, allocator warm
        t0 = time.perf_counter()
        final = run()
        dt = time.perf_counter() - t0
        return final, args.edges / dt

    def admitted(final) -> int:
        return int((final.nbrs >= 0).sum()) // 2

    # the analytical crossover's pick for this (k, C, D): the helper
    # body="auto" runs
    analytical_pick = auto_body(args.vertices, args.max_degree, args.k)
    if args.body != "both":
        final, eps = timed(args.body)
        out = {
            "workload": "spanner",
            "k": args.k,
            "body": args.body,
            "edges_per_sec": round(eps, 1),
            "edges_streamed": args.edges,
            "spanner_edges": admitted(final),
        }
        if args.body == "auto":
            out["auto_picked"] = analytical_pick
        return out
    # calibration: both exact bodies on the same stream must admit the same
    # spanner; the crossover's pick is checked against the measured winner
    # (at k = 2 auto runs within_two, so crossover_correct is null)
    final_balls, eps_balls = timed("balls")
    final_bfs, eps_bfs = timed("bfs")
    edges_balls = admitted(final_balls)
    edges_bfs = admitted(final_bfs)
    measured_winner = "balls" if eps_balls >= eps_bfs else "bfs"
    return {
        "workload": "spanner_body_calibration",
        "k": args.k,
        "vertices": args.vertices,
        "max_degree": args.max_degree,
        "edges_streamed": args.edges,
        "balls_eps": round(eps_balls, 1),
        "bfs_eps": round(eps_bfs, 1),
        "spanner_edges": edges_balls,
        "bodies_agree": edges_balls == edges_bfs and bool(torch.equal(final_balls.deg, final_bfs.deg)),
        "measured_winner": measured_winner,
        "analytical_pick": analytical_pick,
        "crossover_correct": (measured_winner == analytical_pick if analytical_pick in ("balls", "bfs") else None),
        "ball_cost": adjacency.ball_cost(args.max_degree, args.k),
        "bfs_cost": args.k * args.vertices * args.max_degree,
    }


def measure_replay(args) -> dict:
    """Wire-replay connected components through the product API
    (EdgeStream.from_wire -> aggregate(CC)): the replay fold rate (upload,
    device unpack, union-find), the producer's pack rate, and the
    encoding's bytes an edge."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.io import wire
    from gelly_streaming_tpu_torch.library.connected_components import ConnectedComponents

    rng = np.random.default_rng(args.seed)
    n = args.edges - args.edges % args.batch  # full batches: an all-wire stream
    if n == 0:
        raise SystemExit("--edges must be at least one full --batch")
    src = rng.integers(0, args.vertices, n).astype(np.int32)
    dst = rng.integers(0, args.vertices, n).astype(np.int32)
    width = wire.replay_width(args.vertices, args.batch)  # CC is order-free
    t0 = time.perf_counter()
    bufs, _ = wire.pack_stream(src, dst, args.batch, width)
    pack_eps = n / (time.perf_counter() - t0)
    cfg = StreamConfig(vertex_capacity=args.vertices, batch_size=args.batch)
    agg = ConnectedComponents()
    # a one-buffer prefix warms the same path without replaying the stream
    EdgeStream.from_wire(bufs[:1], args.batch, width, cfg, device=args.dev).aggregate(agg).collect()
    synchronize(args.dev)
    t0 = time.perf_counter()
    EdgeStream.from_wire(bufs, args.batch, width, cfg, device=args.dev).aggregate(agg).collect()
    synchronize(args.dev)
    dt = time.perf_counter() - t0
    nbytes = sum(b.nbytes for b in bufs)
    return {
        "workload": "wire_replay_cc",
        "edges": int(n),
        "replay_eps": round(n / dt, 1),
        "pack_eps": round(pack_eps, 1),
        "bytes_per_edge": round(nbytes / n, 2),
        "wire_gbps": round(nbytes / dt / 1e9, 3),
    }


def measure_matching(args) -> dict:
    """Centralized greedy weighted matching's net runtime (the measurement
    the reference ships, CentralizedWeightedMatching.java:62-64) over a
    synthetic weighted stream, with edges/s."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.matching import CentralizedWeightedMatching

    rng = np.random.default_rng(args.seed)
    src = rng.integers(0, args.vertices, args.edges)
    dst = rng.integers(0, args.vertices, args.edges)
    w = rng.random(args.edges).astype(np.float32)
    edges = list(zip(src.tolist(), dst.tolist(), w.tolist()))
    cfg = StreamConfig(vertex_capacity=args.vertices, batch_size=args.batch)

    def run():
        algo = CentralizedWeightedMatching()
        events = algo.run(EdgeStream.from_collection(edges, cfg, batch_size=args.batch, device=args.dev)).collect()
        synchronize(args.dev)
        return algo, events

    run()  # warm-up
    t0 = time.perf_counter()
    algo, events = run()
    net_runtime_s = time.perf_counter() - t0
    matched = int((algo.final_state.partner >= 0).sum()) // 2
    return {
        "workload": "matching",
        "net_runtime_s": round(net_runtime_s, 3),
        "edges_per_sec": round(args.edges / net_runtime_s, 1),
        "edges_streamed": args.edges,
        "matched_edges": matched,
        "events": len(events),
    }


def measure_sage(args) -> dict:
    """One-layer GraphSAGE over sliced windows: per closed window the
    degree-bucketed neighborhoods, then ``sage_kernel`` (gather, masked
    mean, both projections, bias, ReLU) a bucket.  Reports the end-to-end
    window rate, the device-only pane latency and the feature-gather
    bandwidth; ``--train-steps`` also times training steps on a fixed
    neighborhood batch."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.core.types import EdgeDirection
    from gelly_streaming_tpu_torch.library import graphsage as gs

    dev = args.dev
    rng = np.random.default_rng(args.seed)
    window_ms = 1000
    per_w = max(1, args.edges // max(1, args.windows))
    n = per_w * args.windows
    src = rng.integers(0, args.vertices, n)
    dst = rng.integers(0, args.vertices, n)
    ts = np.repeat(np.arange(args.windows) * window_ms, per_w)
    edges = [(int(s), int(d), 0.0, int(t)) for s, d, t in zip(src, dst, ts)]
    features = rng.normal(size=(args.vertices, args.features)).astype(np.float32)
    params = gs.init_params(
        args.features, args.out_features, generator=torch.Generator().manual_seed(args.seed), device=dev
    )
    cfg = StreamConfig(vertex_capacity=args.vertices, max_degree=args.max_degree, batch_size=per_w)
    sage = gs.GraphSAGEWindows(params, features, device=dev)

    def snapshot():
        return EdgeStream.from_collection(edges, cfg, batch_size=per_w, with_time=True, device=dev).slice(
            window_ms, EdgeDirection.ALL
        )

    def run():
        total_keys = windows = 0
        for keys, _ in sage.run(snapshot()):
            total_keys += len(keys)
            windows += 1
        return total_keys, windows

    run()  # warm-up
    t0 = time.perf_counter()
    total_keys, windows = run()
    wall = time.perf_counter() - t0

    # device-only pane latency and feature-gather volume on the same panes
    pane_ms: List[float] = []
    feat_rows = 0
    for hood in snapshot()._neighborhood_panes():
        gs.sage_kernel(sage.params, sage._table, hood.keys, hood.nbrs, hood.valid)  # warm this shape
        synchronize(dev)
        t1 = time.perf_counter()
        gs.sage_kernel(sage.params, sage._table, hood.keys, hood.nbrs, hood.valid)
        synchronize(dev)
        pane_ms.append((time.perf_counter() - t1) * 1e3)
        feat_rows += hood.keys.shape[0] * (1 + hood.nbrs.shape[1])
    device_s = sum(pane_ms) / 1e3
    train = {}
    if args.train_steps > 0:
        # training steps (Adam) on a fixed [K, D] neighborhood batch of the
        # measured shape
        k_rows = min(4096, args.vertices)
        keys_t = torch.from_numpy(rng.integers(0, args.vertices, k_rows).astype(np.int32)).to(dev)
        nbrs_t = torch.from_numpy(rng.integers(0, args.vertices, (k_rows, args.max_degree)).astype(np.int32)).to(dev)
        valid_t = torch.from_numpy(rng.random((k_rows, args.max_degree)) < 0.7).to(dev)
        state = gs.sage_init_train(
            args.features, args.out_features, lr=1e-2, generator=torch.Generator().manual_seed(args.seed), device=dev
        )
        pairs_gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        pos, has, neg = gs.sample_pairs(pairs_gen, nbrs_t, valid_t, args.vertices)
        feats = torch.from_numpy(features).to(dev).to(torch.bfloat16)

        def step(st):
            return gs.sage_train_step(st, feats, keys_t, nbrs_t, valid_t, pos, has, neg)

        state, loss0 = step(state)  # warm-up and the first step
        loss0 = float(loss0)
        t2 = time.perf_counter()
        for _ in range(args.train_steps):
            state, loss = step(state)
        loss = float(loss)  # read back: the steps are done
        dt = time.perf_counter() - t2
        train = {
            "train_steps_per_sec": round(args.train_steps / dt, 2),
            "train_pairs_per_sec": round(args.train_steps * k_rows / dt, 1),
            "train_loss_first": round(loss0, 4),
            "train_loss_last": round(loss, 4),
        }
    return {
        "workload": "graphsage",
        **train,
        "edges_per_sec": round(n / wall, 1),
        "embeddings_per_sec": round(total_keys / wall, 1),
        "windows": windows,
        "features_in": args.features,
        "features_out": args.out_features,
        "device_p50_pane_ms": round(float(np.percentile(pane_ms, 50)), 3),
        "device_p95_pane_ms": round(float(np.percentile(pane_ms, 95)), 3),
        # gathered [K, 1 + D, F] float32 rows a device second: a lower bound
        # on the read bandwidth of the gather and mean
        "feature_gather_gbps": round(feat_rows * args.features * 4 / max(device_s, 1e-9) / 1e9, 3),
        "feature_elements_per_sec": round(feat_rows * args.features / max(device_s, 1e-9), 1),
    }


def measure_pagerank(args) -> dict:
    """Windowed PageRank throughput (pane assembly, then the power
    iteration a window), plus one resident pane's device iteration
    latency."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream
    from gelly_streaming_tpu_torch.library.pagerank import pagerank_windows
    from gelly_streaming_tpu_torch.ops import spmv

    dev = args.dev
    rng = np.random.default_rng(args.seed)
    window_ms = 1000
    per_w = max(1, args.edges // max(1, args.windows))
    n = per_w * args.windows
    src = rng.integers(0, args.vertices, n)
    dst = rng.integers(0, args.vertices, n)
    ts = np.repeat(np.arange(args.windows) * window_ms, per_w)
    edges = [(int(s), int(d), 0.0, int(t)) for s, d, t in zip(src, dst, ts)]
    cfg = StreamConfig(vertex_capacity=args.vertices, batch_size=per_w)

    def run():
        stream = EdgeStream.from_collection(edges, cfg, batch_size=per_w, with_time=True, device=dev)
        count = sum(1 for _ in pagerank_windows(stream, window_ms, tol=args.tol))
        synchronize(dev)
        return count

    run()  # warm-up
    t0 = time.perf_counter()
    windows = run()
    wall = time.perf_counter() - t0

    # device iteration latency on one resident pane
    e_pad = max(1, 1 << (per_w - 1).bit_length())
    s_a = np.resize(src[:per_w], e_pad).astype(np.int32)
    d_a = np.resize(dst[:per_w], e_pad).astype(np.int32)
    m_a = np.arange(e_pad) < per_w
    op = spmv.prepare_pane(s_a, d_a, None, m_a, args.vertices, device=dev)

    def one_pane():
        r, _, iters = spmv.pagerank_fixpoint(op, damping=0.85, tol=args.tol, max_iters=100)
        synchronize(dev)
        return int(iters)

    one_pane()
    t1 = time.perf_counter()
    iters = one_pane()
    dev_ms = (time.perf_counter() - t1) * 1e3
    return {
        "workload": "pagerank",
        "edges_per_sec": round(n / wall, 1),
        "windows_per_sec": round(windows / wall, 2),
        "windows": windows,
        "device_pane_ms": round(dev_ms, 3),
        "device_iters": iters,
        "device_ms_per_iter": round(dev_ms / max(iters, 1), 4),
    }


def _measure_windowed_algo(args, name: str, run_windows, weighted: bool) -> dict:
    """The shared harness of the per-window fixed-point algorithms (sssp,
    kcore): timed edges, a warm-up, one timed pass; ``run_windows(stream,
    window_ms)`` yields once a window."""
    from gelly_streaming_tpu_torch.core.config import StreamConfig
    from gelly_streaming_tpu_torch.core.stream import EdgeStream

    rng = np.random.default_rng(args.seed)
    window_ms = 1000
    per_w = max(1, args.edges // max(1, args.windows))
    n = per_w * args.windows
    src = rng.integers(0, args.vertices, n)
    dst = rng.integers(0, args.vertices, n)
    w = rng.integers(1, 10, n) if weighted else np.zeros(n, np.int64)
    ts = np.repeat(np.arange(args.windows) * window_ms, per_w)
    edges = [(int(a), int(b), float(c) if weighted else 0, int(t)) for a, b, c, t in zip(src, dst, w, ts)]
    cfg = StreamConfig(vertex_capacity=args.vertices, batch_size=per_w)

    def run():
        stream = EdgeStream.from_collection(edges, cfg, batch_size=per_w, with_time=True, device=args.dev)
        count = sum(1 for _ in run_windows(stream, window_ms))
        synchronize(args.dev)
        return count

    run()  # warm-up
    t0 = time.perf_counter()
    windows = run()
    wall = time.perf_counter() - t0
    return {
        "workload": name,
        "edges_per_sec": round(n / wall, 1),
        "windows_per_sec": round(windows / wall, 2),
        "windows": windows,
    }


def measure_sssp(args) -> dict:
    """Windowed SSSP throughput (pane assembly, then the min-plus fixed
    point a window)."""
    from gelly_streaming_tpu_torch.library.sssp import sssp_windows

    return _measure_windowed_algo(args, "sssp", lambda st, wm: sssp_windows(st, 0, wm), weighted=True)


def measure_kcore(args) -> dict:
    """Windowed k-core throughput (dedupe, bucketed neighborhoods, the
    h-index fixed point a window)."""
    from gelly_streaming_tpu_torch.library.kcore import core_numbers_windows

    return _measure_windowed_algo(args, "kcore", core_numbers_windows, weighted=False)


def measure_routing(args, mesh=None) -> dict:
    """Skew robustness of the device keyBy plane: a zipf-keyed batch routed
    over the mesh by plain ``device_route`` and by ``device_route_salted``,
    their drop counts and per-shard receive imbalance.  ``mesh``: the shard
    mesh to route over (default: ``--shards`` of the local devices, or
    ``skipped`` with fewer)."""
    from gelly_streaming_tpu_torch.parallel import mesh as mesh_mod
    from gelly_streaming_tpu_torch.parallel import routing

    s_n = args.shards
    if mesh is None:
        devices = mesh_mod.local_devices(args.dev)
        if len(devices) < s_n:
            return {"skipped": f"need {s_n} devices, have {len(devices)}"}
        mesh = mesh_mod.make_mesh(s_n, devices)
    per_shard = args.batch
    # the routers pow2-bucket their capacity: report the effective one
    cap = routing.pow2_bucket(args.capacity)
    rng = np.random.default_rng(args.seed)
    # zipf keys clipped into the vertex space: a heavy head and a long tail
    keys = np.minimum(rng.zipf(args.alpha, size=(s_n, per_shard)) - 1, args.vertices - 1).astype(np.int32)
    dst = rng.integers(0, args.vertices, (s_n, per_shard)).astype(np.int32)
    src_l = [torch.from_numpy(keys[s]).to(d) for s, d in enumerate(mesh.devices)]
    dst_l = [torch.from_numpy(dst[s]).to(d) for s, d in enumerate(mesh.devices)]
    mask_l = [torch.ones(per_shard, dtype=torch.bool, device=d) for d in mesh.devices]

    def run(router):
        out = router(mesh, src_l, dst_l, mask_l, s_n, cap)
        recv = np.array([int(r.mask.sum()) for r in out])
        return sum(int(r.dropped) for r in out), recv

    plain_drop, plain_recv = run(routing.device_route)
    salt_drop, salt_recv = run(routing.device_route_salted)

    def imbalance(recv):
        mean = recv.mean()
        return float(recv.max() / mean) if mean else 0.0

    return {
        "metric": "zipf_routed_drops",
        "shards": s_n,
        "edges": int(s_n * per_shard),
        "capacity_per_pair": cap,
        "zipf_alpha": args.alpha,
        "plain_dropped": plain_drop,
        "salted_dropped": salt_drop,
        "plain_recv_imbalance": round(imbalance(plain_recv), 2),
        "salted_recv_imbalance": round(imbalance(salt_recv), 2),
    }


MEASURES = {
    "degrees": measure_degrees,
    "bipartiteness": measure_bipartiteness,
    "triangles": measure_triangles,
    "spanner": measure_spanner,
    "matching": measure_matching,
    "replay": measure_replay,
    "pagerank": measure_pagerank,
    "sssp": measure_sssp,
    "kcore": measure_kcore,
    "routing": measure_routing,
    "sage": measure_sage,
}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="measurements", description=__doc__)
    sub = p.add_subparsers(dest="workload", required=True)

    def add(name):
        sp = sub.add_parser(name)
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
        return sp

    for name in ("degrees", "bipartiteness"):
        sp = add(name)
        sp.add_argument("--edges", type=int, default=1 << 20)
        sp.add_argument("--vertices", type=int, default=1 << 17)
        sp.add_argument("--batch", type=int, default=1 << 16)
        sp.add_argument("--seed", type=int, default=0)
        if name == "degrees":
            sp.add_argument(
                "--trace", action="store_true",
                help="also drain the full (vertex, degree) record trace through get_degrees and report records/s",
            )
    sp = add("triangles")
    sp.add_argument("--edges", type=int, default=1 << 17)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--windows", type=int, default=8)
    sp.add_argument("--pane-vertices", type=int, default=1024)
    sp = add("spanner")
    sp.add_argument("--edges", type=int, default=1 << 17)
    # a saturating id space: the k=2 spanner caps near C^1.5 edges, so most
    # of the stream dies in the pre-filter
    sp.add_argument("--vertices", type=int, default=512)
    sp.add_argument("--batch", type=int, default=1 << 14)
    sp.add_argument("--max-degree", type=int, default=64)
    sp.add_argument("--k", type=int, default=2)
    sp.add_argument(
        "--body", choices=("auto", "balls", "bfs", "both"), default="auto",
        help="per-candidate distance test; 'both' runs the calibration (balls vs bfs on the same stream)",
    )
    sp.add_argument("--seed", type=int, default=0)
    sp = add("matching")
    sp.add_argument("--edges", type=int, default=1 << 16)
    sp.add_argument("--vertices", type=int, default=1 << 12)
    sp.add_argument("--batch", type=int, default=1 << 13)
    sp.add_argument("--seed", type=int, default=0)
    sp = add("replay")
    sp.add_argument("--edges", type=int, default=1 << 22)
    sp.add_argument("--vertices", type=int, default=1 << 20)
    sp.add_argument("--batch", type=int, default=1 << 20)
    sp.add_argument("--seed", type=int, default=0)
    sp = add("sage")
    sp.add_argument("--edges", type=int, default=1 << 16)
    sp.add_argument("--vertices", type=int, default=1 << 12)
    sp.add_argument("--windows", type=int, default=8)
    sp.add_argument("--features", type=int, default=128)
    sp.add_argument("--out-features", type=int, default=128)
    sp.add_argument("--max-degree", type=int, default=32)
    sp.add_argument("--train-steps", type=int, default=0, help="also measure N unsupervised training steps")
    sp.add_argument("--seed", type=int, default=0)
    sp = add("pagerank")
    sp.add_argument("--edges", type=int, default=1 << 18)
    sp.add_argument("--vertices", type=int, default=1 << 14)
    sp.add_argument("--windows", type=int, default=8)
    sp.add_argument("--tol", type=float, default=1e-8)
    sp.add_argument("--seed", type=int, default=0)
    for name in ("sssp", "kcore"):
        sp = add(name)
        sp.add_argument("--edges", type=int, default=1 << 16)
        sp.add_argument("--vertices", type=int, default=1 << 12)
        sp.add_argument("--windows", type=int, default=8)
        sp.add_argument("--seed", type=int, default=0)
    sp = add("routing")
    sp.add_argument("--shards", type=int, default=8)
    sp.add_argument("--batch", type=int, default=256, help="edges per shard")
    sp.add_argument("--capacity", type=int, default=64, help="per-(sender,receiver) bucket capacity")
    sp.add_argument("--vertices", type=int, default=1 << 12)
    sp.add_argument("--alpha", type=float, default=1.3, help="zipf exponent")
    sp.add_argument("--seed", type=int, default=0)
    return p


def run(argv: Optional[List[str]] = None) -> dict:
    """Parse ``argv``, run the mode and return its metrics."""
    args = parser().parse_args(argv)
    fn = MEASURES[args.workload]
    args.dev = resolve_device(args.device)
    return fn(args)


def main(argv: Optional[List[str]] = None) -> None:
    print(json.dumps(run(argv)))


if __name__ == "__main__":
    main(sys.argv[1:])
