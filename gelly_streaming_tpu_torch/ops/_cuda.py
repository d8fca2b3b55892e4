"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``gelly_streaming_tpu_torch/build/`` (git-ignored), then loaded with
ctypes.  A library's file name carries a hash of its source and flags, so
an edited source is rebuilt and a built one is reused.  Nothing is built
when the module is imported: the first kernel call builds what it needs,
and ``build_all`` builds every source at once, one ``nvcc`` process each,
all started together.

``csrc/*.c`` and ``csrc/*.cpp`` sources are host code: ``host_library``
compiles one with the host C compiler (``cc -O2``) or C++ compiler (``c++
-O3 -std=c++17``) into the same directory, at first use, and loads it with
ctypes (whose foreign calls release the GIL).

A C entry point acts on the current CUDA device: a tensor's default
stream handle is 0, the null stream of whichever device is current, and
the occupancy, shared-memory attributes and ``cudaMemsetAsync`` calls
inside a launch all follow the current device.  So every wrapper that
calls an entry point is decorated with ``on_device_of`` (or calls it
inside ``device_guard``), which makes its tensors' device current for the
call: a mesh whose shards live on ``cuda:0`` .. ``cuda:S-1`` launches each
shard's kernels on its own card and its own stream.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, NamedTuple

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry points of each source: name -> argtypes (each returns an int
# cudaError_t from cudaGetLastError after the launch, unless RESTYPES says
# otherwise)
SIGNATURES: Dict[str, Dict[str, list]] = {
    "pane_triangles.cu": {
        # words, n_ptr, cap, bits, k, stream
        "pane_adjacency_launch": [_P, _P, _I, _P, _I, _P],
        # bits, k, total, stream
        "dense_triangles_launch": [_P, _I, _P, _P],
        # words, n_ptr, cap, bits, k, total, stream: both of the above
        "pane_triangles_launch": [_P, _P, _I, _P, _I, _P, _P],
    },
    "unionfind.cu": {
        # items, nodes: the scratch bytes of one call
        "uf_scratch_bytes": [_L, _L],
        # parent, seen | None, src | None, dst, mask | None, n, capacity,
        # flat, scratch, scratch bytes, stream: the compress kernel (unless
        # flat), then the union kernel
        "uf_union_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _L, _P],
        # parent2, seen | None, src, dst, mask | None, n, capacity C (parent2
        # holds 2C), flat, scratch, scratch bytes, stream: compress (unless
        # flat), then the parity union
        "uf_parity_union_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _L, _P],
    },
    "degrees.cu": {
        # n: the scratch bytes degree_trace_launch needs for n rows
        "degree_trace_scratch_bytes": [_I],
        # v, m, sorted keys, order (int64), n, counts, capacity, packed |
        # None, maskbits | None, emitted | None, scratch, scratch bytes,
        # stream: the scan kernel, then the pack kernel
        "degree_trace_launch": [_P, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _L, _P],
        # deg, src, dst, mask | None, n, capacity, stream
        "degree_fold_launch": [_P, _P, _P, _P, _I, _I, _P],
        # deg int32[size], size (a power of two), spread (0: one address),
        # count, stream: the L2 reduction-rate probe (chip_smoke.py)
        "degree_l2_probe_launch": [_P, _I, _I, _L, _P],
        # deg, hist, capacity, src, dst, sign | None, mask | None, n, recs,
        # rmask, stream: the one-thread kernel
        "degree_dist_scan_serial_launch": [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P],
        # src, dst, sign | None, mask | None, n, capacity, keys int32[2n],
        # words int32[2n], stream
        "degree_dist_keys_launch": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
        # deg, capacity, sorted keys, order (int64), words, n, recs, rmask,
        # key2, scratch, scratch bytes, stream: stage 1
        "degree_dist_rows_launch": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _L, _P],
        # hist, capacity, sorted key2, order2 (int64), rmask, n, recs,
        # scratch, scratch bytes, stream: stage 2
        "degree_dist_counts_launch": [_P, _I, _P, _P, _P, _I, _P, _P, _L, _P],
        # n: the scratch bytes both stages need for n events
        "degree_dist_scratch_bytes": [_I],
    },
    "neighborhoods.cu": {
        # n, with_idx: the scratch bytes of one build
        "nb_scratch_bytes": [_I, _I],
        # src, dst, mask, n, with_idx, scratch, scratch bytes, stream: the
        # stats and plan kernels, then the radix passes
        "nb_sort_launch": [_P, _P, _P, _I, _I, _P, _L, _P],
        # n, buckets, with_idx, scratch, scratch bytes, totals, stream: the
        # heads, carry, count and scan kernels
        "nb_count_launch": [_I, _I, _I, _P, _L, _P, _P],
        # n, buckets, with_idx, scratch, scratch bytes, keys out, nbrs out,
        # valid out, stream
        "nb_scatter_launch": [_I, _I, _I, _P, _L, _P, _P, _P, _P],
        # n, buckets, scratch, scratch bytes, leaf, leaf out, bytes a row,
        # stream
        "nb_scatter_values_launch": [_I, _I, _P, _L, _P, _P, _I, _P],
        # n, with_idx, scratch, scratch bytes, src out, dst out, index out |
        # None, meta out (lo, valid rows, passes), stream: the sorted rows
        "nb_sorted_launch": [_I, _I, _P, _L, _P, _P, _P, _P, _P],
    },
    "csr_triangles.cu": {
        # k, e, n_v: the scratch bytes of csr_triangles_launch
        "csr_scratch_bytes": [_I, _I, _I],
        # u, v, ok, k, e, n_v, lookup bytes, out int64[k], scratch, scratch
        # bytes, stream: a memset, the degree, scan, scatter and count kernels
        "csr_triangles_launch": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _L, _P],
    },
    "exact_triangles.cu": {
        # n, capacity, max_degree, chunk, trace: the scratch bytes of one call
        "exact_scratch_bytes": [_I, _I, _I, _I, _I],
        # nbrs, deg, dropped, local, glob, src, dst, mask, n, capacity,
        # max_degree, chunk, scratch, scratch bytes, stats, stream: the
        # memsets, then the prep, chain, settle and count kernels
        "triangle_block_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _L, _P, _P],
        # nbrs, deg, dropped, local, glob, src, dst, mask, n, capacity,
        # max_degree, trace_local, trace_global, scratch, scratch bytes,
        # stats, stream: the same, then the trace scan kernel
        "triangle_trace_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _L, _P, _P],
    },
    "sage.cu": {
        # table, C, F_in, keys, nbrs, valid, K, D, w, bias, F_out, out rows,
        # chunk, chunks, partial sums | None, partial counts | None, stream:
        # the partial-sum kernel (chunks > 0), then the layer
        "sage_layer_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P, _P],
        # F_in, F_out: the scratch bytes of sage_layer_backward_launch
        "sage_layer_backward_scratch_bytes": [_I, _I],
        # table, C, F_in, keys, nbrs, valid, K, D, z, dz, F_out, dw, db,
        # chunk, chunks, partial sums | None, partial counts | None,
        # scratch, scratch bytes, stream: the partial-sum kernel (chunks >
        # 0), the blocks' partials, their sum in block order
        "sage_layer_backward_launch": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _P, _P, _P, _L,
                                       _P],
    },
    "spmv.cu": {
        # n, e: the scratch bytes of one fixpoint, or of one product of a
        # min semiring, over n vertices and at most e edges
        "spmv_fixpoint_scratch_bytes": [_I, _I],
        # sem, push, off, s_dst, s_w, d_off, d_src, d_w, x, fm | None, y, n,
        # e, scratch | None (min semirings), its bytes, stream: one product
        # (a min semiring's: one cooperative launch)
        "spmv_product_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _L, _P],
        # sem, off, s_dst, s_w, d_off, d_src, d_w, n_active, n, e, x0, fm0, xs
        # [2n], fm, thr, max_iters, scratch (its first int32[24] the header),
        # its bytes, stream: a memset, then the cooperative fixpoint kernel
        "spmv_fixpoint_launch": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P, _F, _I, _P, _L, _P],
        # n, e: the scratch bytes of one PageRank call over n vertices and
        # at most e edges
        "pagerank_scratch_bytes": [_I, _I],
        # off, d_off, d_src, n, e, damping, tol, max_iters, rs [2n],
        # in_window, scratch, scratch bytes, stream: a memset, then the
        # cooperative PageRank kernel
        "pagerank_fixpoint_launch": [_P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _L, _P],
    },
    "kcore.cu": {
        # c, n, keys, nbrs, valid, k, d, h, stream: the h-index kernel, then
        # the scatter-min
        "kcore_round_launch": [_P, _I, _P, _P, _P, _I, _I, _P, _P],
        # n: the scratch bytes of one fixpoint over n vertices
        "kcore_fixpoint_scratch_bytes": [_I],
        # c, n, bucket table, buckets, max_rounds, scratch, its bytes,
        # stream: a memset, then the cooperative fixpoint kernel
        "kcore_fixpoint_launch": [_P, _I, _P, _I, _I, _P, _L, _P],
    },
    "spanner.cu": {
        # n, capacity, max_degree, k, cap, body: the scratch bytes of one
        # call (-1: none can run)
        "spanner_scratch_bytes": [_I, _I, _I, _I, _I, _I],
        # nbrs, deg, capacity, max_degree, src, dst, mask | None, n, k, cap,
        # body, scratch, scratch bytes, stats, stream: the pre-filter kernel,
        # then the one-block resolve kernel
        "spanner_admit_launch": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _L, _P, _P],
    },
    "matching.cu": {
        # capacity: the scratch bytes of a call (0: the state fits in
        # shared memory)
        "matching_scratch_bytes": [_I],
        # partner, weight, capacity, src, dst, val | None, mask | None, n,
        # events, emask, scratch | None, stats, stream: one block commits a
        # window's conflict-free prefix a round
        "matching_scan_launch": [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    },
    "sampled_triangles.cu": {
        # n, S: the scratch bytes of one call
        "sampler_scratch_bytes": [_I, _I],
        # key, edge, third, closed_a, closed_b, edges_seen, seen, S, C, src,
        # dst, mask | None, n, keys uint32[n + 1, 2] (the host chain's),
        # scratch, scratch bytes, stream: the step keys, tile scan,
        # thresholds, coin, finish, hits and seen kernels
        "sampler_scan_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _L, _P],
    },
    "sketches.cu": {
        # banks (1 or 2), m: the scratch bytes of the two HLL folds (the
        # filter's image)
        "hll_scratch_bytes": [_I, _I],
        # regs, m, keys int64 (u32 hashes), mask | None, n, scratch, scratch
        # bytes, stream: the image kernel, then the filter kernel
        "hll_fold_launch": [_P, _I, _P, _P, _I, _P, _L, _P],
        # verts, edges, m, src, dst, mask | None, n, scratch, scratch bytes,
        # stream: the image kernel, then HLLDegreeSummary's three key
        # families in one filter kernel
        "hll_degree_launch": [_P, _P, _I, _P, _P, _P, _I, _P, _L, _P],
        # grid, d, w, keys, keys_b | None (dst), counts | None, mask | None,
        # n, stream: one cluster launch
        "cm_fold_launch": [_P, _I, _I, _P, _P, _P, _P, _I, _P],
        # rows: the scratch bytes of tri_fold_launch (tickets, the
        # clusters' winners) and of tri_closures_launch (the sum, the
        # ticket, the tables past the shared-memory cap)
        "tri_fold_scratch_bytes": [_I],
        "tri_closures_scratch_bytes": [_I],
        # eh, elo, ehi, rows, regs | None, m, src, dst, mask | None, n,
        # scratch (zeroed once), scratch bytes, stream: one cluster launch
        "tri_fold_launch": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _P, _L, _P],
        # elo, ehi, rows, out int32[1], scratch (zeroed once), scratch
        # bytes, stream: one launch
        "tri_closures_launch": [_P, _P, _I, _P, _P, _L, _P],
    },
    "wire_decode.cu": {
        # n: the scratch bytes of one decode of n edges
        "bdv_decode_scratch_bytes": [_I],
        # buf, nb, n, valued, src, dst, val | None, scratch, scratch bytes,
        # stream: one cooperative launch
        "bdv_decode_launch": [_P, _L, _I, _I, _P, _P, _P, _P, _L, _P],
        # n, capacity: the scratch bytes of one EF40 unpack
        "ef40_unpack_scratch_bytes": [_I, _I],
        # buf, nb, n, capacity, src, dst, scratch, scratch bytes, stream:
        # one cooperative launch
        "ef40_unpack_launch": [_P, _L, _I, _I, _P, _P, _P, _L, _P],
        # buf, nb, n, bytes an edge (3: width 3, 5: PAIR40), src, dst,
        # stream: one launch
        "wire_unpack_launch": [_P, _L, _I, _I, _P, _P, _P],
    },
    "routing.cu": {
        # n, S: the scratch bytes of one owner_pack_launch
        "owner_pack_scratch_bytes": [_L, _I],
        # live | None, owner | None, a | None, b | None, n, S, cap, fill_a,
        # fill_b, out_a, out_b | None, ok | None, sent | None, slot | None,
        # counts, acc | None, scratch, scratch bytes, stream: the count, scan
        # and scatter kernels
        "owner_pack_launch": [_P, _P, _P, _P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P],
        # block, rows, row pointers [S], value pointers [S], S, cap, op,
        # stream: one launch
        "block_delta_fold_launch": [_P, _I, _P, _P, _I, _I, _I, _P],
        # block, rows, slab pointers [S], S, op, flag | None, stream: one
        # launch
        "slab_fold_launch": [_P, _L, _P, _I, _I, _P, _P],
    },
}

_C, _I32, _I64 = ctypes.c_char_p, ctypes.c_int32, ctypes.c_int64

# host C and C++ sources (built by the host compiler): name -> (argtypes,
# restype); pointers are addresses (numpy's ``.ctypes.data``)
HOST_SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "threefry_chain.c": {
        # k0, k1, n, keys uint32[n + 1, 2]: the key before each step, then after
        "threefry_chain": ([ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int64, _P], None),
    },
    "edge_parser.cpp": {
        # path: the data lines of an edge-list file (-1: unreadable)
        "count_rows": ([_C], _I64),
        # path, src i64, dst i64, val f64, time i64, sign i32, cap, ncols out
        "fill_edges": ([_C, _P, _P, _P, _P, _P, _I64, _P], _I64),
        # path, begin, end, the same arrays, cap, ncols out: the lines that
        # start in [begin, end)
        "fill_edges_range": ([_C, _I64, _I64, _P, _P, _P, _P, _P, _I64, _P], _I64),
        "count_rows_range": ([_C, _I64, _I64], _I64),
        # src, dst, n, width, out uint8[2 n width]
        "pack_edges": ([_P, _P, _I64, _I32, _P], _I64),
        # src, dst, n, out uint8[5 n]
        "pack_edges40": ([_P, _P, _I64, _P], _I64),
        # src, dst, n, capacity, out, out bytes
        "pack_edges_ef40": ([_P, _P, _I64, _I32, _P, _I64], _I64),
        # src, dst, n, capacity, out src, out dst: the (dst, src) stable sort
        "sort_edges_dst_src": ([_P, _P, _I64, _I32, _P, _P], _I64),
        # sorted src, dst, n, out, out bytes: the BDV payload (-1: no room)
        "encode_edges_bdv": ([_P, _P, _I64, _P, _I64], _I64),
        # src, dst, n, shards, by src, cap, out src [S, cap], out dst, counts
        "route_edges": ([_P, _P, _I64, _I32, _I32, _I64, _P, _P, _P], _I64),
        # buf, nbytes, n, width code, capacity, sort, out src, out dst
        "decode_wire_into": ([_P, _I64, _I64, _I32, _I32, _I32, _P, _P], _I64),
        # src i32, dst i32, n, out counts i64[capacity], capacity: the
        # Flink-shaped degree baseline's wall ns (-1: failed)
        "flink_proxy_degrees": ([_P, _P, _I64, _P, _I32], _I64),
    },
}
HOST_CFLAGS = ("-O2", "-shared", "-fPIC")
HOST_CXXFLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

# entry points that return something other than a cudaError_t
RESTYPES: Dict[str, type] = {
    "degree_dist_scratch_bytes": _L, "degree_trace_scratch_bytes": _L, "nb_scratch_bytes": _L,
    "uf_scratch_bytes": _L, "sage_layer_backward_scratch_bytes": _L, "csr_scratch_bytes": _L,
    "exact_scratch_bytes": _L, "pagerank_scratch_bytes": _L, "spmv_fixpoint_scratch_bytes": _L,
    "kcore_fixpoint_scratch_bytes": _L, "spanner_scratch_bytes": _L, "sampler_scratch_bytes": _L,
    "matching_scratch_bytes": _L, "tri_fold_scratch_bytes": _L, "hll_scratch_bytes": _L,
    "tri_closures_scratch_bytes": _L, "bdv_decode_scratch_bytes": _L,
    "ef40_unpack_scratch_bytes": _L, "owner_pack_scratch_bytes": _L,
}


class BuildResult(NamedTuple):
    path: Path
    seconds: float  # 0.0 when an existing build was reused
    log: str  # nvcc's output (ptxas register/shared-memory report)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def _target(source: str, flags=NVCC_FLAGS) -> Path:
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, BuildResult]:
    """Build every listed source that has no current library, one ``nvcc``
    per source, all running at once.  Raises ``RuntimeError`` with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, BuildResult] = {}
    running = {}
    for src in sources:
        out = _target(src)
        if out.exists():
            results[src] = BuildResult(out, 0.0, "")
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[src] = (proc, tmp, out, time.perf_counter())
    failed = []
    for src, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, out)
        results[src] = BuildResult(out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (built on first use), with every
    entry point's argtypes and restype declared."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            path = build_all([source])[source].path
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            _libs[source] = lib
        return lib


def host_library(source: str) -> ctypes.CDLL:
    """The loaded library of the host source ``source`` (``csrc/*.c`` by
    ``cc``, ``csrc/*.cpp`` by ``c++``), compiled on first use into the
    build directory (a temporary file a process, then an atomic rename, so
    processes racing to build it are safe), with its entry points declared.
    Raises ``RuntimeError`` when the compiler fails or is missing."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            cxx = source.endswith(".cpp")
            flags = HOST_CXXFLAGS if cxx else HOST_CFLAGS
            out = _target(source, flags)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
                if cxx:
                    cc = os.environ.get("CXX") or shutil.which("c++") or "c++"
                else:
                    cc = os.environ.get("CC") or shutil.which("cc") or "cc"
                try:
                    proc = subprocess.run([cc, *flags, "-o", str(tmp), str(CSRC_DIR / source)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                except OSError as e:
                    raise RuntimeError(f"{cc} failed for {source}: {e}") from e
                if proc.returncode != 0:
                    raise RuntimeError(f"{cc} failed for {source}:\n{proc.stdout}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            for name, (argtypes, restype) in HOST_SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[source] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def device_guard(t):
    """A context in which the device of ``t`` (a tensor or a
    ``torch.device``) is the current CUDA device; a no-op for anything not
    on a CUDA device."""
    import torch

    dev = t if isinstance(t, torch.device) else getattr(t, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def on_device_of(arg: str):
    """Decorate a kernel wrapper so that it runs inside ``device_guard`` of
    its argument named ``arg``."""

    def wrap(fn):
        pos = list(inspect.signature(fn).parameters).index(arg)

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with device_guard(args[pos] if pos < len(args) else kwargs.get(arg)):
                return fn(*args, **kwargs)

        return run

    return wrap
