"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under
``gelly_streaming_tpu_torch/build/`` (git-ignored), then loaded with
ctypes.  A library's file name carries a hash of its source and flags, so
an edited source is rebuilt and a built one is reused.  Nothing is built
when the module is imported: the first kernel call builds what it needs,
and ``build_all`` builds every source at once, one ``nvcc`` process each,
all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

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
}

# entry points that return something other than a cudaError_t
RESTYPES: Dict[str, type] = {
    "degree_dist_scratch_bytes": _L, "degree_trace_scratch_bytes": _L, "nb_scratch_bytes": _L,
    "uf_scratch_bytes": _L, "sage_layer_backward_scratch_bytes": _L,
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


def _target(source: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
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


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
