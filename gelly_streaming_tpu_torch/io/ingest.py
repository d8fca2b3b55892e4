"""Parallel host ingest: worker-pool parsing and packing.

Port of ``gelly_streaming_tpu/io/ingest.py``.  A shared thread pool shards
the two CPU-bound ingest stages across cores:

* **Parsing**: ``parse_edge_file_parallel`` splits an edge-list file into
  byte ranges and parses them concurrently through the native parser
  (``csrc/edge_parser.cpp`` ``fill_edges_range``; ctypes calls release the
  GIL, so workers overlap).  Range ownership is by line start, so adjacent
  ranges partition the file's lines exactly and the concatenated result is
  the serial parse's.  Without the native library the file's lines are
  chunked and parsed per worker by the numpy fallback parser: the same
  arrays.
* **Packing**: ``pack_rows_into`` / ``parallel_pack_stream`` pack
  consecutive edge batches into the rows of one preallocated arena in the
  transfer layout (``[g, wire_nbytes]``), each row by a pool worker writing
  into its slice; ``pack_bdv_group`` and ``pack_binned_rows_into`` do the
  same for the compressed and the binned ingest.  The numpy fallbacks hold
  the GIL, so without the library the workers take turns.

``parallel_host_route`` is the owner-shard bucketing
(``parallel/routing.host_route``) across the pool; the mesh runner's
owner-sharded windowed plane calls it for a descriptor with a route key
when binned ingest is on.  Worker count resolution (``resolve_workers``): an
explicit config value wins, then the ``GELLY_INGEST_WORKERS`` env var, then
the process's usable core count.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from gelly_streaming_tpu_torch.parallel.routing import RoutedEdges, host_route, pow2_bucket
from gelly_streaming_tpu_torch.utils import native

_LOCK = threading.Lock()
_POOLS: dict = {}  # worker count -> shared ThreadPoolExecutor

# don't shard tiny files: below this many bytes per worker the seek/attach
# overhead outweighs the parallelism
MIN_RANGE_BYTES = 1 << 18

# fallback (no native library) parse chunk: lines per pool task.  Bounded
# in-flight chunks keep memory at O(workers * chunk) lines, never the file.
FALLBACK_CHUNK_LINES = 1 << 16


def resolve_workers(requested: int = 0) -> int:
    """Effective ingest worker count: explicit request > env var > cores."""
    if requested:
        return max(1, int(requested))
    env = os.environ.get("GELLY_INGEST_WORKERS")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    try:
        return max(1, len(os.sched_getaffinity(0)))
    except AttributeError:
        return max(1, os.cpu_count() or 1)


def get_pool(workers: int) -> ThreadPoolExecutor:
    """The shared ingest pool for exactly ``workers`` threads.

    Process-wide pools cached PER WORKER COUNT (not one grown pool): the
    requested count is a real concurrency bound — a ``workers=2`` pack must
    not ride 16 threads a previous caller warmed up, or per-worker scaling
    measurements stop measuring anything.
    Pools persist because ingest runs inside the prefetcher's pack thread
    on the hot path, where spawning/reaping a pool per superbatch would
    cost more than the packing itself.
    """
    with _LOCK:
        pool = _POOLS.get(workers)
        if pool is None:
            pool = _POOLS[workers] = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix=f"gelly-ingest-{workers}"
            )
        return pool


def _run_parallel(fns, workers: int) -> list:
    """Run thunks on the ``workers``-bounded shared pool, results in order
    (first error wins)."""
    pool = get_pool(max(1, min(len(fns), workers)))
    futures = [pool.submit(fn) for fn in fns]
    return [f.result() for f in futures]


# ---------------------------------------------------------------------------
# Parallel file parsing
# ---------------------------------------------------------------------------


def _file_ranges(path: str, workers: int) -> List[Tuple[int, int]]:
    size = os.path.getsize(path)
    w = max(1, min(workers, size // MIN_RANGE_BYTES or 1))
    bounds = [size * i // w for i in range(w + 1)]
    return [(bounds[i], bounds[i + 1]) for i in range(w) if bounds[i] < bounds[i + 1]]


def _parse_range_native(lib, path: str, begin: int, end: int):
    """One worker's share: count, allocate, fill (GIL released in ctypes)."""
    n = lib.count_rows_range(path.encode(), begin, end)
    if n < 0:
        raise IOError(f"failed to scan {path} [{begin}, {end})")
    src = np.empty(n, np.int64)
    dst = np.empty(n, np.int64)
    val = np.empty(n, np.float64)
    tim = np.empty(n, np.int64)
    sign = np.empty(n, np.int32)
    ncols = np.zeros(1, np.int32)
    rows = lib.fill_edges_range(
        path.encode(), begin, end, src.ctypes.data, dst.ctypes.data, val.ctypes.data, tim.ctypes.data,
        sign.ctypes.data, n, ncols.ctypes.data,
    )
    if rows < 0:
        raise IOError(f"failed to parse {path} [{begin}, {end})")
    return (
        src[:rows],
        dst[:rows],
        val[:rows],
        tim[:rows],
        sign[:rows],
        int(ncols[0]),
    )


def _merge_parsed(parts):
    """Concatenate per-range results under the serial parser's contract."""
    src = np.concatenate([p[0] for p in parts])
    dst = np.concatenate([p[1] for p in parts])
    val = np.concatenate([p[2] for p in parts])
    tim = np.concatenate([p[3] for p in parts])
    sign = np.concatenate([p[4] for p in parts])
    # column structure is a property of the FILE, not the range: merge each
    # range's observation (max of the column count, OR of the sign bit)
    ncols = 2
    has_sign = False
    for p in parts:
        ncols = max(ncols, p[5] & 0xFF)
        has_sign = has_sign or bool(p[5] & 0x100)
    return (
        src,
        dst,
        val if (ncols >= 3 and not has_sign) else None,
        tim if ncols >= 4 else None,
        sign if has_sign else None,
    )


def _parse_chunk_lines(lines):
    """Numpy-chunked fallback worker: the pure-python line parser over one
    chunk of lines (the serial fallback of io.sources.parse_edge_file)."""
    src, dst, val, tim, sign = [], [], [], [], []
    ncols = 2
    has_sign = False
    for line in lines:
        line = line.strip()
        if not line or line[0] in "#%":
            continue
        parts = line.replace(",", " ").replace("\t", " ").split()
        if len(parts) < 2:
            continue
        src.append(int(parts[0]))
        dst.append(int(parts[1]))
        v, t, sg = 0.0, 0, 1
        if len(parts) > 2:
            if parts[2] in ("+", "-"):
                sg = -1 if parts[2] == "-" else 1
                has_sign = True
                ncols = max(ncols, 3)
            else:
                v = float(parts[2])
                ncols = max(ncols, 3)
        if len(parts) > 3:
            t = int(float(parts[3]))
            ncols = 4
        val.append(v)
        tim.append(t)
        sign.append(sg)
    return (
        np.array(src, np.int64),
        np.array(dst, np.int64),
        np.array(val, np.float64),
        np.array(tim, np.int64),
        np.array(sign, np.int32),
        ncols | (0x100 if has_sign else 0),
    )


def parse_edge_file_parallel(path: str, workers: int = 0):
    """Parse an edge-list file across the ingest worker pool.

    Same contract (and bit-identical output) as
    ``io.sources.parse_edge_file``: returns (src i64, dst i64, val f64 |
    None, time i64 | None, sign i32 | None).  Uses native byte-range workers
    when the compiled parser is available, else chunks the file's lines over
    the pure-python fallback parser.
    """
    workers = resolve_workers(workers)
    lib = native.load_ingest_lib()
    if lib is not None:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        ranges = _file_ranges(path, workers)
        if len(ranges) <= 1:
            from gelly_streaming_tpu_torch.io import sources

            return sources.parse_edge_file(path, workers=1)
        parts = _run_parallel(
            [
                lambda b=b, e=e: _parse_range_native(lib, path, b, e)
                for b, e in ranges
            ],
            workers,
        )
        return _merge_parsed(parts)
    # numpy-chunked fallback: no native module — STREAM the file in bounded
    # line chunks (never the whole file in memory) and parse chunks on the
    # pool with at most ``workers`` in flight
    import itertools

    pool = get_pool(workers)
    parts = []
    pending = []
    with open(path) as f:
        while True:
            chunk = list(itertools.islice(f, FALLBACK_CHUNK_LINES))
            if not chunk:
                break
            pending.append(pool.submit(_parse_chunk_lines, chunk))
            if len(pending) > workers:  # backpressure bounds memory
                parts.append(pending.pop(0).result())
    parts.extend(fut.result() for fut in pending)
    if not parts:
        parts = [_parse_chunk_lines([])]
    return _merge_parsed(parts)


# ---------------------------------------------------------------------------
# Parallel packing (the transfer-layout arena)
# ---------------------------------------------------------------------------


def pack_rows_into(
    src: np.ndarray,
    dst: np.ndarray,
    first_batch: int,
    group: int,
    batch: int,
    width,
    arena: np.ndarray,
    workers: int = 0,
) -> None:
    """Pack ``group`` consecutive full batches into ``arena`` rows.

    ``arena`` is ``uint8[group, wire_nbytes(batch, width)]`` — the exact
    superbatch transfer layout; each worker packs its row in place (native
    packers write through the row pointer, releasing the GIL), so the caller
    ships the arena with no further copies.
    """
    from gelly_streaming_tpu_torch.io import wire

    def one(j: int) -> None:
        i = first_batch + j
        wire.pack_edges_into(
            src[i * batch : (i + 1) * batch],
            dst[i * batch : (i + 1) * batch],
            width,
            arena[j],
        )

    workers = resolve_workers(workers)
    if workers <= 1 or group == 1:
        for j in range(group):
            one(j)
        return
    _run_parallel([lambda j=j: one(j) for j in range(group)], workers)


def fill_pane_rows_into(
    panes,
    src_k: np.ndarray,
    dst_k: np.ndarray,
    mask_k: np.ndarray,
    workers: int = 0,
) -> None:
    """Fill row ``i`` of the [K, E_pad] fold arenas with pane ``i``'s edges.

    The timed-pane extension of the arena pattern: ``src_k``/``dst_k``/
    ``mask_k`` are the exact transfer layout the superpane fold consumes
    (row per window, mask True on the real prefix), and each row fills in
    place on the shared ingest pool — no per-pane intermediate copies.
    Rows beyond ``len(panes)`` are left as the caller initialized them
    (zeroed = fully masked padding).
    """

    def one(i: int, pane) -> None:
        n = pane.num_edges
        src_k[i, :n] = pane.src
        dst_k[i, :n] = pane.dst
        mask_k[i, :n] = True

    workers = resolve_workers(workers)
    if workers <= 1 or len(panes) <= 1:
        for i, p in enumerate(panes):
            one(i, p)
        return
    _run_parallel(
        [lambda i=i, p=p: one(i, p) for i, p in enumerate(panes)], workers
    )


def pack_bdv_group(
    src: np.ndarray,
    dst: np.ndarray,
    first_batch: int,
    group: int,
    batch: int,
    capacity: int,
    workers: int = 0,
) -> np.ndarray:
    """Bin + compress ``group`` consecutive batches into one stacked arena.

    Each row is a BDV buffer (io/wire.pack_edges_bdv: (dst, src) sort +
    delta/varint encode) packed by a pool worker; rows then pad to the
    GROUP's max byte bucket — BDV buffers are data-dependent sizes, so the
    group arena buckets to its own max instead of a fixed slice width (the
    trailing zeros decode as dropped empty varint groups).  Returns
    ``uint8[group, bucket]``; bucket sizes reuse the pow2-family bucketing
    (wire.bdv_bucket_nbytes), keeping compiled scan shapes cache-stable
    across same-regime groups.
    """
    from gelly_streaming_tpu_torch.io import wire

    def one(j: int) -> np.ndarray:
        i = first_batch + j
        return wire.pack_edges_bdv(
            src[i * batch : (i + 1) * batch],
            dst[i * batch : (i + 1) * batch],
            capacity,
            record_stats=True,
        )

    workers = resolve_workers(workers)
    if workers <= 1 or group == 1:
        bufs = [one(j) for j in range(group)]
    else:
        bufs = _run_parallel([lambda j=j: one(j) for j in range(group)], workers)
    bucket = max(b.nbytes for b in bufs)
    arena = np.zeros((group, bucket), np.uint8)
    for j, b in enumerate(bufs):
        arena[j, : b.nbytes] = b
    return arena


def pack_binned_rows_into(
    src: np.ndarray,
    dst: np.ndarray,
    first_batch: int,
    group: int,
    batch: int,
    width,
    capacity: int,
    arena: np.ndarray,
    workers: int = 0,
) -> None:
    """``pack_rows_into`` with destination binning: each row's batch sorts
    by (dst, src) on its pool worker before packing at the PLAIN fixed
    width — same transfer bytes, segment-local device folds (the
    binned-without-compression half of propagation blocking)."""
    from gelly_streaming_tpu_torch.io import wire

    def one(j: int) -> None:
        i = first_batch + j
        s_b, d_b = wire.sort_edges_binned(
            src[i * batch : (i + 1) * batch],
            dst[i * batch : (i + 1) * batch],
            capacity,
            record_stats=True,
        )
        wire.pack_edges_into(s_b, d_b, width, arena[j])

    workers = resolve_workers(workers)
    if workers <= 1 or group == 1:
        for j in range(group):
            one(j)
        return
    _run_parallel([lambda j=j: one(j) for j in range(group)], workers)


def parallel_host_route(
    src: np.ndarray,
    dst: np.ndarray,
    num_shards: int,
    key: str = "src",
    capacity: Optional[int] = None,
    workers: int = 0,
):
    """``host_route`` sharded across the ingest worker pool.

    Each worker routes a contiguous chunk through the native single-pass
    router, then per-shard chunks concatenate in chunk order: arrival order
    within a shard is preserved, so the result is the serial
    ``host_route``'s.  Bucket capacities are powers of two (never the exact
    occupancy), so skewed panes resolve to the shapes of balanced ones.
    """
    workers = resolve_workers(workers)
    n = len(src)
    chunk = -(-n // workers) if workers > 1 else n
    if workers <= 1 or n < (1 << 14) or chunk == 0:
        return host_route(src, dst, num_shards, key=key, capacity=capacity)
    bounds = list(range(0, n, chunk)) + [n]
    parts = _run_parallel(
        [
            lambda b=b, e=e: host_route(
                src[b:e], dst[b:e], num_shards, key=key
            )
            for b, e in zip(bounds[:-1], bounds[1:])
        ],
        workers,
    )
    counts = [p.mask.sum(axis=1) for p in parts]
    totals = np.sum(counts, axis=0)
    # pow2 bin-arena capacity (explicit capacities honored as given)
    cap = capacity or pow2_bucket(int(totals.max()) if n else 1)
    s = np.zeros((num_shards, cap), np.int32)
    d = np.zeros((num_shards, cap), np.int32)
    m = np.zeros((num_shards, cap), bool)

    def fill(shard: int) -> None:
        o = 0
        for p, c in zip(parts, counts):
            k = min(int(c[shard]), cap - o)
            if k <= 0:
                continue
            s[shard, o : o + k] = p.src[shard, :k]
            d[shard, o : o + k] = p.dst[shard, :k]
            o += k
        m[shard, :o] = True

    _run_parallel(
        [lambda sh=sh: fill(sh) for sh in range(num_shards)], workers
    )
    return RoutedEdges(s, d, m, None)


def parallel_pack_stream(
    src: np.ndarray,
    dst: np.ndarray,
    batch: int,
    width,
    workers: int = 0,
) -> Tuple[list, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """``io.wire.pack_stream`` across the worker pool (bit-identical bufs).

    Full batches pack concurrently — one arena row per batch, returned as
    the same per-batch buffer list the serial producer yields — plus the raw
    remainder tail (or None).
    """
    from gelly_streaming_tpu_torch.io import wire

    src = np.ascontiguousarray(src, dtype=np.int32)
    dst = np.ascontiguousarray(dst, dtype=np.int32)
    n_full = len(src) // batch
    rem = len(src) - n_full * batch
    tail = (src[n_full * batch :], dst[n_full * batch :]) if rem else None
    if n_full == 0:
        return [], tail
    workers = resolve_workers(workers)
    nbytes = wire.wire_nbytes(batch, width)
    arena = np.empty((n_full, nbytes), np.uint8)
    pack_rows_into(src, dst, 0, n_full, batch, width, arena, workers)
    return [arena[i] for i in range(n_full)], tail
