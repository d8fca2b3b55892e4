#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (gelly_streaming_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU (built for an H100, sm_90a) and nvcc.  It builds the
port's CUDA kernels from ``gelly_streaming_tpu_torch/csrc``, holds each
kernel against its plain PyTorch twin on the card, then drives the port's
main path, ``window_triangles`` over an event-time ``EdgeStream``, at the
size of the repo's triangle bench (16 windows of 2^17 edges over 4096
vertices, plus one 8192-vertex window and one sparse-id window that takes
the CSR path), and checks every window's count.  Tolerance: none; both
kernels compute integers and must equal their twins exactly
(``max_abs_err`` 0).  It prints timings, a
``{"kernels": [...]}`` JSON line, the GPU's name and power limit, and as
its last line ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero without that line; so does a machine without CUDA.
"""

from __future__ import annotations

import json
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


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events."""
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


def to_dev(arrays, dev):
    import torch

    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)


def seeded_pane_words(rng, k: int, edges: int):
    """Packed words of a random pane over [0, k) with duplicates, both
    orientations and self-loops, plus garbage words past n."""
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    u = rng.integers(0, k, edges)
    v = rng.integers(0, k, edges)
    dup = rng.integers(0, edges, edges // 4)
    loops = rng.integers(0, k, 16)
    uu = np.concatenate([u, v[dup], loops])
    vv = np.concatenate([v, u[dup], loops])
    w, n = dt.pack_pane(uu, vv)
    if int(n) == len(w):  # make room for padding that must be ignored
        w = np.concatenate([w, np.zeros_like(w)])
    w[int(n):] = (rng.integers(0, k, len(w) - int(n)) | (1 << 14)).astype(np.uint32)
    return dt.packed_host_arrays(w, n)


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


def phase_adjacency(dev, rng) -> int:
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    worst = 0
    for k in (128, 4096, 8192, 16384):
        words, n = to_dev(seeded_pane_words(rng, k, 8 * k + 3), dev)
        got = dt.pane_adjacency(words, n, k)
        want = dt.pane_adjacency_plain(words, n, k)
        err = word_err(got, want)
        worst = max(worst, err)
        if err:
            bad = int((got != want).sum())
            raise RuntimeError(f"pane_adjacency K={k}: {bad} words differ from the twin")
        log(f"  pane_adjacency K={k:5d}: bit-equal to the plain twin (n={int(n[0])})")
    return worst


def phase_dense(dev, rng) -> int:
    import torch

    from gelly_streaming_tpu_torch.ops import dense_triangles as dt

    errs = []

    def check(name, adj_np, expect=None, with_numpy=True):
        adj = torch.from_numpy(adj_np).to(dev)
        bits = dt.pack_bits(adj)
        got = int(dt.dense_triangles(bits)[0])
        twin = int(dt.dense_triangles_plain(bits)[0])
        ref = numpy_six_triangles(adj_np) if with_numpy else twin
        if expect is not None and ref != expect:
            raise RuntimeError(f"dense_triangles {name}: reference {ref} != {expect}")
        errs.append(abs(got - twin))
        if not got == twin == ref:
            raise RuntimeError(
                f"dense_triangles {name}: kernel {got}, twin {twin}, numpy {ref}"
            )
        log(f"  dense_triangles {name}: total {got} exact (twin, {'numpy' if with_numpy else 'twin only'})")

    for k, p in ((128, 0.2), (4096, 0.01), (8192, 0.004)):
        upper = np.triu(rng.random((k, k), dtype=np.float32) < p, 1)
        check(f"K={k}", upper | upper.T)
    kc = 2048
    complete = ~np.eye(kc, dtype=bool)
    check("complete K=2048", complete, expect=kc * (kc - 1) * (kc - 2))
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


def main() -> int:
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
    built = _cuda.build_all()
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
    src0, dst0 = panes[0]
    k = dt.pane_k(int(max(src0.max(), dst0.max())) + 1)
    w, n = dt.pack_pane(src0, dst0)
    words, nn = to_dev(dt.packed_host_arrays(w, n), dev)
    bits = dt.pane_adjacency(words, nn, k)
    total = int(dt.dense_triangles(bits)[0])
    adj_err = max(adj_err, word_err(bits, dt.pane_adjacency_plain(words, nn, k)))
    tri_err = max(tri_err, abs(total - int(dt.dense_triangles_plain(bits)[0])))
    if adj_err or tri_err:
        raise RuntimeError(f"kernels disagree with their twins: {adj_err}, {tri_err}")
    nnz = int(dt.unpack_bits(bits).sum())
    adj_ms = cuda_ms(lambda: dt.pane_adjacency(words, nn, k), 50)
    adj_plain_ms = cuda_ms(lambda: dt.pane_adjacency_plain(words, nn, k), 10)
    tri_ms = cuda_ms(lambda: dt.dense_triangles(bits), 50)
    tri_plain_ms = cuda_ms(lambda: dt.dense_triangles_plain(bits), 10)
    a8 = dt.unpack_bits(bits).to(torch.int8)

    def int_mm():
        return (torch._int_mm(a8, a8) * a8).sum(dtype=torch.int64)

    if int(int_mm()) != total:
        raise RuntimeError("the _int_mm yardstick disagrees with the kernel")
    lib_ms = cuda_ms(int_mm, 20)
    adj_bytes = int(n) * 4 + 4 + k * k // 8
    adj_bound = adj_bytes / HBM_BYTES_PER_S * 1e3
    tri_bytes_ms = (k * k // 8 + 8) / HBM_BYTES_PER_S * 1e3
    tri_ops_ms = 2.0 * nnz * k / INT8_OPS_PER_S * 1e3
    log(f"  pane K={k}, n={int(n)} words, nnz(A)={nnz}, total={total}")
    kernel_share = (adj_ms + tri_ms) * launches["dense_triangles"] / (main_s * 1e3)
    log(f"  the two kernels at K={k} x {launches['dense_triangles']} launches = "
        f"{kernel_share * 100:.2f}% of window_triangles' wall time")
    for kk in (8192, 16384):
        wk, nk = to_dev(seeded_pane_words(rng, kk, PANE_EDGES), dev)
        bk = dt.pane_adjacency(wk, nk, kk)
        log(f"  K={kk}: pane_adjacency {cuda_ms(lambda: dt.pane_adjacency(wk, nk, kk), 20):.4f} ms, "
            f"dense_triangles {cuda_ms(lambda: dt.dense_triangles(bk), 20):.4f} ms "
            f"(nnz {int(dt.unpack_bits(bk).sum())})")

    kernels = [
        {
            "name": "pane_adjacency",
            "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/pane_triangles.cu",
            "replaces": "gelly_streaming_tpu/ops/pallas_triangles.py:134",
            "launches": launches["pane_adjacency"],
            "max_abs_err": adj_err,
            "ms": adj_ms,
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
            "ms": tri_ms,
            "plain_ms": tri_plain_ms,
            "bound_ms": max(tri_bytes_ms, tri_ops_ms),
            "bound_by": "operations" if tri_ops_ms >= tri_bytes_ms else "bytes",
            "library_ms": lib_ms,
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
