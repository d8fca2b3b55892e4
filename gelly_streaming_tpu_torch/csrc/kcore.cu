// The k-core h-index fixed point over a pane's degree buckets, on Hopper
// (sm_90a), behind a plain C interface loaded with ctypes
// (gelly_streaming_tpu_torch/ops/_cuda.py, ops/spmv._kcore_fixpoint and
// ops/spmv.kcore_round).
//
// Replaces the JAX package's _build_bucket_round with _h_index_rows
// (gelly_streaming_tpu/library/kcore.py:32-56), an XLA step, and the host
// loop of core_numbers_windows that calls it once a bucket a round and
// compares the estimates after every round (:107-115): gather the
// neighbours' estimates c[nbrs] of a bucket's [K, D] rows, take each row's
// h-index over its valid entries (the largest h with at least h entries
// >= h), and scatter-min it into c at the bucket's keys; stop after a
// round that changes nothing.
//
// kcore_fixpoint_launch runs every round of a pane, and every bucket of
// each round, in one cooperative launch: no launch a bucket, no host sync
// a round.  The JAX order is kept: Jacobi within a bucket
// (every row reads the estimates as they stood before the bucket),
// Gauss-Seidel across buckets in the host's order.  One grid sync a
// bucket: the estimates live in two buffers, and the phase of bucket b
// reads one (R) and writes the other (W) at bucket b's keys, min(R[key],
// h), while it copies the keys of the bucket before from R into W, the
// only entries at which W was stale.  So after each phase W holds the
// whole state and the next phase reads it.  A round changed iff some row's
// h fell below its key's estimate (the estimates only fall, so that is
// the host's c != prev); each block ORs its rows' flags into the round's
// flag at the round's last phase, and every block reads it after the sync.
// The rounds run, whether the fixed point was reached and H go to a header
// the host reads once a pane.
//
// The h-index by counting, not by sorting or searching.  A row's h is at
// most its valid count (<= D), only min(c[key], h) is kept, and with
// distinct neighbours (a simple graph's rows: ops/spmv._kcore_fixpoint's
// one caller, library/kcore.pane_cores, builds them from the pane's
// deduplicated edges) no row's h exceeds H, the h-index of the pane's starting
// estimates (a row with h > H would need h neighbours whose estimates are
// >= h > H; the estimates only fall).  The prologue counts the starting
// estimates into kBins + 1 bins (each block's in shared memory, then
// added) and takes H from a suffix scan; H >= kBins means no cap.  Each
// value is capped at cap = min(c[key], D, H); then
//   - D <= 16: a thread a row, its values in registers, counted down from
//     cap;
//   - 32 <= D <= 1024: a warp a row, D / 32
//     values a lane in registers (the row's loads coalesced), a binary
//     search whose counts are warp reductions;
//   - D > 1024 (a hub's row, up to 2^17 wide): the values counted into
//     cap + 1 bins in shared memory (a warp's equal values merged into one
//     atomic), then one suffix scan finds the largest h with at least h
//     values >= h.  A bucket of a few such rows (at least kSpread blocks a
//     row) spreads each row over the grid: every block counts a slice and
//     adds its bins into the row's bins in device memory, and after one
//     more grid sync a block a row scans them; other buckets take a block
//     a row.  When cap >= kBins (H past the shared bins, or no H:
//     kcore_round_launch's rows may repeat a neighbour) a block's row
//     refines: the candidates [lo, hi] are counted into kBins bins of
//     width w, the bin holding the answer kept, and the row counted again
//     within it: two passes for a cap below 2^24.  Nothing is staged in
//     device memory.
// Each thread issues all the loads of its slots (kUnroll of a block's row,
// a warp's rows' D / 32) before it uses the first: a round is bound by the
// latency of its buckets' phases, not by their bytes.
// Ids outside [0, C) follow JAX's rules: the gathers c[nbrs] and c[key]
// count below 0 from the end once and clamp, the scatter drops a key still
// outside [0, C) after that.
//
// kcore_round_launch is one bucket and one round with the same row code
// and no H: the h-index kernel into h[K], then the scatter-min.
//
// Bound on the H100 (bytes), a bucket, each distinct byte once: valid
// (1 B a slot), nbrs of the valid slots (4 B each), the distinct
// estimates read (4 B a distinct neighbour or key), the keys read and c
// written at them (8 B a row); a round's bound sums its buckets.  The
// searches and counts re-read registers, shared memory or (a row's second
// pass) the L2, not device memory.  Each bucket adds a grid sync (two for
// a spread bucket).

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins = 4096;  // the counting h-index's shared bins (16 KB)
constexpr int kNoCap = INT_MAX;
constexpr int kUnroll = 8;  // slots a thread loads at once in a block's row
constexpr int kSpread = 4;  // blocks a row at least, for a bucket's rows to be spread over the grid

// the fixpoint's scratch (int32 slots): the header, the histogram of the
// starting estimates and the spread rows' bins (blocks / kSpread rows of
// kBins; all cleared by the launcher), then the second estimate buffer [n]
enum CoreSlot {
  kRounds = 0,
  kConverged = 1,
  kHIndex = 2,        // H, or -1 when no cap applies
  kBlocks = 3,        // the launch's blocks
  kChanged = 4,       // 3 rotating round flags
  kCoreHead = 8,
  kHistInts = kBins + 8,
};

// a row of the bucket table: pointers, then k | d << 32
struct Bucket {
  const int* keys;
  const int* nbrs;
  const uint8_t* valid;
  int k;
  int d;
};

template <class T>
__device__ __forceinline__ T ld_cg(const T* p) {
  return __ldcg(p);
}

__device__ __forceinline__ int gather_idx(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int scatter_idx(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// The capped values of slots j0, j0 + S, ..., j0 + (U - 1) S of a row (0
// where not valid or past d): every valid flag and neighbour id loaded,
// then every estimate, so a thread has U loads in flight at each step.  The
// estimates may be written by other blocks during the call: read from the
// L2, never from a stale L1 line.
template <int U, int S>
__device__ __forceinline__ void load_values(const int* c, int n, const int* nbrs, const uint8_t* valid, int64_t row0,
                                            int j0, int d, int cap, int* v) {
  static_assert(U <= 32, "the valid flags are one 32-bit mask");
  unsigned ok = 0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int j = j0 + u * S;
    ok |= (j < d && __ldg(valid + row0 + j) ? 1u : 0u) << u;
    v[u] = j < d ? __ldg(nbrs + row0 + j) : 0;
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int e = (ok >> u) & 1u ? ld_cg(c + gather_idx(v[u], n)) : 0;
    v[u] = e < cap ? e : cap;
  }
}

__device__ __forceinline__ int row_cap(const int* c, int n, int key, int d, int hcap) {
  int ck = ld_cg(c + gather_idx(key, n));
  ck = ck < d ? ck : d;
  return ck < hcap ? ck : hcap;
}

// ---------------------------------------------------------------------------
// block-wide helpers (every thread of the block calls them)

__device__ int block_sum(int v) {
  __shared__ int s[kWarps];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += s[w];
    total = t;
  }
  __syncthreads();
  const int out = total;
  __syncthreads();
  return out;
}

__device__ int block_max(int v) {
  __shared__ int s[kWarps];
  __shared__ int best;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_max_sync(kFull, v);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = s[0];
    for (int w = 1; w < kWarps; ++w) t = t > s[w] ? t : s[w];
    best = t;
  }
  __syncthreads();
  const int out = best;
  __syncthreads();
  return out;
}

// the exclusive prefix sum of v over the block's threads, and the total
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int s[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) s[warp] = incl;
  __syncthreads();
  int before = 0, t = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += s[w];
    t += s[w];
  }
  __syncthreads();
  *total = t;
  return before + incl - v;
}

// The largest b in [0, nb) with above + bins[b] + ... + bins[nb - 1] >=
// lo + b * w: the bin holding the h-index when the candidates [lo, ...)
// are counted into bins of width w and `above` values lie past the last
// bin.  b = 0 holds by the caller's invariant (at least lo values >= lo),
// so bins[0] never decides and need not be counted.
__device__ int top_bin(const int* bins, int nb, int above, int lo, int w) {
  const int per = (nb + kThreads - 1) / kThreads;
  const int b0 = min(nb, static_cast<int>(threadIdx.x) * per), b1 = min(nb, b0 + per);
  int mine = 0;
  for (int b = b0; b < b1; ++b) mine += bins[b];
  int total;
  const int before = block_excl_scan(mine, &total);
  int s = above + total - before - mine;  // the values in bins past this thread's
  int best = 0;
  for (int b = b1 - 1; b >= b0; --b) {
    s += bins[b];
    if (s >= lo + b * w) {
      best = b;
      break;
    }
  }
  return block_max(best);
}

// ---------------------------------------------------------------------------
// a row's h-index, min(h, cap), over the capped values of c[nbrs]

template <int D>
__device__ int thread_h(const int* c, int n, const int* nbrs, const uint8_t* valid, int64_t row0, int cap) {
  int v[D];
  load_values<D, 1>(c, n, nbrs, valid, row0, 0, D, cap, v);
  int hh = cap;
  for (; hh > 0; --hh) {
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < D; ++j) cnt += v[j] >= hh;
    if (cnt >= hh) break;
  }
  return hh;
}

template <int P>  // D = 32 * P; every lane returns h
__device__ int warp_h(const int* c, int n, const int* nbrs, const uint8_t* valid, int64_t row0, int cap) {
  const int lane = threadIdx.x & 31;
  int v[P];
  load_values<P, 32>(c, n, nbrs, valid, row0, lane, 32 * P, cap, v);
  int lo = 0, hi = cap;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    int cnt = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) cnt += v[p] >= mid;
    cnt = __reduce_add_sync(kFull, cnt);
    if (cnt >= mid)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// A block a row, by counting: the answer lies in [lo, hi]; each pass
// counts the values in (lo, hi] into bins of width w = ceil((hi - lo + 1) /
// kBins) (bins: kBins ints of shared memory) and the values past hi, and
// keeps the bin that holds the answer.  One pass when cap < kBins.  A
// thread takes kUnroll slots a step, all their loads issued before the
// first is used (a hub row's 2^15 slots are 16 steps of 256 threads, not
// 128 round trips).  Every thread returns h.
__device__ int block_h(const int* c, int n, const int* nbrs, const uint8_t* valid, int64_t row0, int d, int cap,
                       int* bins) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = cap;
  while (lo < hi) {
    const int w = (hi - lo) / kBins + 1;
    const int nb = (hi - lo) / w + 1;
    for (int b = threadIdx.x; b < nb; b += kThreads) bins[b] = 0;
    __syncthreads();
    int above = 0;
    for (int j0 = 0; j0 < d; j0 += kThreads * kUnroll) {  // the same steps in every thread
      int v[kUnroll];
      load_values<kUnroll, kThreads>(c, n, nbrs, valid, row0, j0 + threadIdx.x, d, cap, v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int bin = -1;
        if (v[u] > hi)
          ++above;
        else if (v[u] >= lo + w)
          bin = (v[u] - lo) / w;
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(bins + bin, __popc(peers));
      }
    }
    if (hi < cap)  // a later pass; in the first every value is <= hi
      above = block_sum(above);
    else
      __syncthreads();  // the bins are counted
    const int b = top_bin(bins, nb, above, lo, w);
    lo += b * w;
    hi = min(hi, lo + w - 1);
  }
  return lo;
}

// ---------------------------------------------------------------------------
// one bucket, one round (kcore_round_launch)

template <int D>
__global__ void __launch_bounds__(kThreads) h_thread_kernel(const int* c, int n, const int* keys, const int* nbrs,
                                                            const uint8_t* valid, int rows, int* h) {
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < rows; k += gridDim.x * kThreads)
    h[k] = thread_h<D>(c, n, nbrs, valid, int64_t(k) * D, row_cap(c, n, __ldg(keys + k), D, kNoCap));
}

template <int P>
__global__ void __launch_bounds__(kThreads) h_warp_kernel(const int* c, int n, const int* keys, const int* nbrs,
                                                          const uint8_t* valid, int rows, int* h) {
  constexpr int D = 32 * P;
  for (int k = blockIdx.x * kWarps + (threadIdx.x >> 5); k < rows; k += gridDim.x * kWarps) {
    const int hh = warp_h<P>(c, n, nbrs, valid, int64_t(k) * D, row_cap(c, n, __ldg(keys + k), D, kNoCap));
    if ((threadIdx.x & 31) == 0) h[k] = hh;
  }
}

__global__ void __launch_bounds__(kThreads) h_block_kernel(const int* c, int n, const int* keys, const int* nbrs,
                                                           const uint8_t* valid, int rows, int d, int* h) {
  __shared__ int bins[kBins];
  for (int k = blockIdx.x; k < rows; k += gridDim.x) {
    const int hh = block_h(c, n, nbrs, valid, int64_t(k) * d, d, row_cap(c, n, __ldg(keys + k), d, kNoCap), bins);
    if (threadIdx.x == 0) h[k] = hh;
    __syncthreads();  // bins are reused by the next row
  }
}

__global__ void scatter_min_kernel(int* c, int n, const int* keys, const int* h, int rows) {
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < rows; k += gridDim.x * kThreads) {
    const int t = scatter_idx(__ldg(keys + k), n);
    if (t >= 0) atomicMin(c + t, __ldg(h + k));
  }
}

// ---------------------------------------------------------------------------
// the fixed point (kcore_fixpoint_launch)

// writes min(R[t], hh) at the key's slot of W; hh <= R[t] by the cap
__device__ __forceinline__ void put(const int* R, int* W, int n, int key, int hh, bool* changed) {
  const int t = scatter_idx(key, n);
  if (t < 0) return;
  if (hh < ld_cg(R + t)) *changed = true;
  atomicMin(W + t, hh);
}

template <int D>
__device__ void thread_rows(const int* R, int* W, int n, const Bucket& bk, int hcap, bool* changed) {
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < bk.k; k += gridDim.x * kThreads) {
    const int key = __ldg(bk.keys + k);
    put(R, W, n, key, thread_h<D>(R, n, bk.nbrs, bk.valid, int64_t(k) * D, row_cap(R, n, key, D, hcap)), changed);
  }
}

template <int P>
__device__ void warp_rows(const int* R, int* W, int n, const Bucket& bk, int hcap, bool* changed) {
  constexpr int D = 32 * P;
  for (int k = blockIdx.x * kWarps + (threadIdx.x >> 5); k < bk.k; k += gridDim.x * kWarps) {
    const int key = __ldg(bk.keys + k);
    const int hh = warp_h<P>(R, n, bk.nbrs, bk.valid, int64_t(k) * D, row_cap(R, n, key, D, hcap));
    if ((threadIdx.x & 31) == 0) put(R, W, n, key, hh, changed);
  }
}

__device__ void block_rows(const int* R, int* W, int n, const Bucket& bk, int hcap, bool* changed, int* bins) {
  for (int k = blockIdx.x; k < bk.k; k += gridDim.x) {
    const int key = __ldg(bk.keys + k);
    const int hh = block_h(R, n, bk.nbrs, bk.valid, int64_t(k) * bk.d, bk.d, row_cap(R, n, key, bk.d, hcap), bins);
    if (threadIdx.x == 0) put(R, W, n, key, hh, changed);
    __syncthreads();  // bins are reused by the next row
  }
}

// A bucket of a few wide rows (at least kSpread blocks a row, cap < kBins):
// each row's slots split over its share of the grid's blocks, counted in
// shared memory and added into the row's bins in device memory; after a
// grid sync one block a row takes h from them by one suffix scan and
// clears them.  One extra sync instead of one block walking a hub's row
// while the rest of the grid waits.
__device__ void spread_rows(const int* R, int* W, int n, const Bucket& bk, int hcap, bool* changed, int* bins,
                            int* gbins, cg::grid_group& grid) {
  const int per = gridDim.x / bk.k, row = blockIdx.x / per, part = blockIdx.x % per;
  const int lane = threadIdx.x & 31;
  if (row < bk.k) {
    const int cap = row_cap(R, n, __ldg(bk.keys + row), bk.d, hcap);
    for (int b = threadIdx.x; b <= cap; b += kThreads) bins[b] = 0;
    __syncthreads();
    const int chunk = (bk.d + per - 1) / per, j_lo = part * chunk, j_hi = min(bk.d, j_lo + chunk);
    for (int j0 = j_lo; j0 < j_hi; j0 += kThreads * kUnroll) {  // the same steps in every thread
      int v[kUnroll];
      load_values<kUnroll, kThreads>(R, n, bk.nbrs, bk.valid, int64_t(row) * bk.d, j0 + threadIdx.x, j_hi, cap, v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int bin = v[u] > 0 ? v[u] : -1;  // bin 0 never decides
        const unsigned peers = __match_any_sync(kFull, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(bins + bin, __popc(peers));
      }
    }
    __syncthreads();
    int* g = gbins + int64_t(row) * kBins;
    for (int b = threadIdx.x + 1; b <= cap; b += kThreads)
      if (bins[b]) atomicAdd(g + b, bins[b]);
  }
  grid.sync();
  if (blockIdx.x < bk.k) {
    const int key = __ldg(bk.keys + blockIdx.x);
    const int cap = row_cap(R, n, key, bk.d, hcap);
    int* g = gbins + int64_t(blockIdx.x) * kBins;
    for (int b = threadIdx.x; b <= cap; b += kThreads) {
      bins[b] = ld_cg(g + b);
      g[b] = 0;  // clean for the bucket's next round
    }
    __syncthreads();
    const int hh = cap > 0 ? top_bin(bins, cap + 1, 0, 0, 1) : 0;
    if (threadIdx.x == 0) put(R, W, n, key, hh, changed);
  }
}

__global__ void __launch_bounds__(kThreads, 2) kcore_fixpoint_kernel(int* c, int n, const Bucket* table, int buckets,
                                                                     int max_rounds, int* scratch) {
  __shared__ int bins[kBins + 1];
  cg::grid_group grid = cg::this_grid();
  int* hdr = scratch;
  int* hist = scratch + kCoreHead;
  int* gbins = hist + kHistInts;
  int* c2 = gbins + int64_t(gridDim.x / kSpread) * kBins;
  const int64_t gtid = blockIdx.x * int64_t(kThreads) + threadIdx.x, gstride = int64_t(gridDim.x) * kThreads;

  // prologue: the second buffer, and the histogram of the estimates
  // (capped at kBins) for H
  for (int64_t v = gtid; v < n; v += gstride) c2[v] = c[v];
  {
    for (int b = threadIdx.x; b <= kBins; b += kThreads) bins[b] = 0;
    __syncthreads();
    const int lane = threadIdx.x & 31;
    for (int64_t v0 = blockIdx.x * int64_t(kThreads); v0 < n; v0 += gstride) {
      const int64_t v = v0 + threadIdx.x;
      int bin = -1;
      if (v < n) {
        const int e = c[v];
        bin = e < 0 ? 0 : (e > kBins ? kBins : e);
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) atomicAdd(bins + bin, __popc(peers));
    }
    __syncthreads();
    for (int b = threadIdx.x; b <= kBins; b += kThreads)
      if (bins[b]) atomicAdd(hist + b, bins[b]);
  }
  grid.sync();
  int hcap = kNoCap;
  {
    for (int b = threadIdx.x; b <= kBins; b += kThreads) bins[b] = ld_cg(hist + b);
    __syncthreads();
    const int h_index = top_bin(bins, kBins + 1, 0, 0, 1);
    if (h_index < kBins) hcap = h_index;
    __syncthreads();
  }

  int phase = 0, rounds = 0, converged = 0;
  for (int r = 1; r <= max_rounds; ++r) {
    bool changed = false;
    for (int b = 0; b < buckets; ++b, ++phase) {
      const int* R = (phase & 1) ? c2 : c;
      int* W = (phase & 1) ? c : c2;
      if (phase > 0) {  // the keys of the bucket before, stale in W
        const Bucket pb = table[b == 0 ? buckets - 1 : b - 1];
        for (int64_t k = gtid; k < pb.k; k += gstride) {
          const int t = scatter_idx(__ldg(pb.keys + k), n);
          if (t >= 0) atomicMin(W + t, ld_cg(R + t));
        }
      }
      const Bucket bk = table[b];
      switch (bk.d) {
        case 1: thread_rows<1>(R, W, n, bk, hcap, &changed); break;
        case 2: thread_rows<2>(R, W, n, bk, hcap, &changed); break;
        case 4: thread_rows<4>(R, W, n, bk, hcap, &changed); break;
        case 8: thread_rows<8>(R, W, n, bk, hcap, &changed); break;
        case 16: thread_rows<16>(R, W, n, bk, hcap, &changed); break;
        case 32: warp_rows<1>(R, W, n, bk, hcap, &changed); break;
        case 64: warp_rows<2>(R, W, n, bk, hcap, &changed); break;
        case 128: warp_rows<4>(R, W, n, bk, hcap, &changed); break;
        case 256: warp_rows<8>(R, W, n, bk, hcap, &changed); break;
        case 512: warp_rows<16>(R, W, n, bk, hcap, &changed); break;
        case 1024: warp_rows<32>(R, W, n, bk, hcap, &changed); break;
        default:
          if (hcap < kBins && bk.k * kSpread <= static_cast<int>(gridDim.x))
            spread_rows(R, W, n, bk, hcap, &changed, bins, gbins, grid);
          else
            block_rows(R, W, n, bk, hcap, &changed, bins);
      }
      if (b == buckets - 1 && __syncthreads_or(changed) && threadIdx.x == 0) hdr[kChanged + r % 3] = 1;
      grid.sync();
    }
    rounds = r;
    // the flag read a round ago is the one the round after next sets
    if (blockIdx.x == 0 && threadIdx.x == 0) hdr[kChanged + (r + 2) % 3] = 0;
    if (!ld_cg(hdr + kChanged + r % 3)) {
      converged = 1;
      break;
    }
  }
  // the last phase wrote c2: c lacks that bucket's keys
  if (phase > 0 && ((phase - 1) & 1) == 0) {
    const Bucket lb = table[buckets - 1];
    for (int64_t k = gtid; k < lb.k; k += gstride) {
      const int t = scatter_idx(__ldg(lb.keys + k), n);
      if (t >= 0) atomicMin(c + t, ld_cg(c2 + t));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    hdr[kRounds] = rounds;
    hdr[kConverged] = converged;
    hdr[kHIndex] = hcap == kNoCap ? -1 : hcap;
    hdr[kBlocks] = gridDim.x;
  }
}

int grid_for(int64_t items, int per_block) {
  int64_t b = (items + per_block - 1) / per_block;
  b = b < 65535 ? b : 65535;
  return static_cast<int>(b > 0 ? b : 1);
}

template <int D>
void thread_launch(const int* c, int n, const int* keys, const int* nbrs, const uint8_t* valid, int rows, int* h,
                   cudaStream_t s) {
  h_thread_kernel<D><<<grid_for(rows, kThreads), kThreads, 0, s>>>(c, n, keys, nbrs, valid, rows, h);
}

template <int P>
void warp_launch(const int* c, int n, const int* keys, const int* nbrs, const uint8_t* valid, int rows, int* h,
                 cudaStream_t s) {
  h_warp_kernel<P><<<grid_for(rows, kWarps), kThreads, 0, s>>>(c, n, keys, nbrs, valid, rows, h);
}

// the fixpoint's blocks: every block that fits on the device at once
int fixpoint_blocks(cudaError_t* err) {
  static std::mutex mu;
  static int cached_device = -1, cached_blocks = 0;
  int device = 0;
  if ((*err = cudaGetDevice(&device)) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (device == cached_device) return cached_blocks;
  int sms = 0, per_sm = 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, reinterpret_cast<const void*>(kcore_fixpoint_kernel), kThreads, 0)) != cudaSuccess)
    return 0;
  cached_device = device;
  cached_blocks = sms * per_sm;
  return cached_blocks;
}

// the scratch's int32 slots before the second estimate buffer
int64_t cleared_ints(int blocks) { return kCoreHead + kHistInts + int64_t(blocks / kSpread) * kBins; }

}  // namespace

extern "C" {

// c: int32[n], the estimates, updated in place; keys: int32[k]; nbrs:
// int32[k, d]; valid: uint8[k, d]; d: a power of two; h: int32[k] of
// scratch.  Enqueues the h-index kernel, then the scatter-min, on the
// stream, with no host sync.
int kcore_round_launch(void* c, int n, const void* keys, const void* nbrs, const void* valid, int k, int d, void* h,
                       void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || (d & (d - 1))) return static_cast<int>(cudaErrorInvalidValue);
  auto* cp = static_cast<int*>(c);
  auto* kp = static_cast<const int*>(keys);
  auto* np = static_cast<const int*>(nbrs);
  auto* vp = static_cast<const uint8_t*>(valid);
  auto* hp = static_cast<int*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: thread_launch<1>(cp, n, kp, np, vp, k, hp, s); break;
    case 2: thread_launch<2>(cp, n, kp, np, vp, k, hp, s); break;
    case 4: thread_launch<4>(cp, n, kp, np, vp, k, hp, s); break;
    case 8: thread_launch<8>(cp, n, kp, np, vp, k, hp, s); break;
    case 16: thread_launch<16>(cp, n, kp, np, vp, k, hp, s); break;
    case 32: warp_launch<1>(cp, n, kp, np, vp, k, hp, s); break;
    case 64: warp_launch<2>(cp, n, kp, np, vp, k, hp, s); break;
    case 128: warp_launch<4>(cp, n, kp, np, vp, k, hp, s); break;
    case 256: warp_launch<8>(cp, n, kp, np, vp, k, hp, s); break;
    case 512: warp_launch<16>(cp, n, kp, np, vp, k, hp, s); break;
    case 1024: warp_launch<32>(cp, n, kp, np, vp, k, hp, s); break;
    default: h_block_kernel<<<grid_for(k, 1), kThreads, 0, s>>>(cp, n, kp, np, vp, k, d, hp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_min_kernel<<<grid_for(k, kThreads), kThreads, 0, s>>>(cp, n, kp, hp, k);
  return static_cast<int>(cudaGetLastError());
}

// The scratch bytes of one kcore_fixpoint_launch over n vertices, or -1
// when the occupancy query fails.
long long kcore_fixpoint_scratch_bytes(int n) {
  cudaError_t err;
  const int blocks = fixpoint_blocks(&err);
  if (err != cudaSuccess) return -1;
  return 4 * (cleared_ints(blocks) + static_cast<long long>(n));
}

// c: int32[n], the estimates, updated in place; table: `buckets` rows of
// four int64 on the device (keys, nbrs, valid as pointers; k | d << 32),
// each bucket as for kcore_round_launch, in the order the rounds take
// them, every row's neighbours distinct (values are capped at H);
// max_rounds: the bound; scratch: kcore_fixpoint_scratch_bytes(n) bytes,
// int32 slot 0 the rounds run, 1 whether the last one changed nothing, 2 H
// (-1: no cap), 3 the blocks the launch ran.  One cooperative launch runs
// every round on the stream, with no host sync.
int kcore_fixpoint_launch(void* c, int n, const void* table, int buckets, int max_rounds, void* scratch,
                          long long scratch_bytes, void* stream) {
  if (n <= 0 || buckets < 0 || scratch_bytes < kcore_fixpoint_scratch_bytes(n))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int blocks = fixpoint_blocks(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(scratch, 0, cleared_ints(blocks) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* cp = static_cast<int*>(c);
  auto* tp = static_cast<const Bucket*>(table);
  auto* sp = static_cast<int*>(scratch);
  void* args[] = {&cp, &n, &tp, &buckets, &max_rounds, &sp};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kcore_fixpoint_kernel), dim3(blocks),
                                    dim3(kThreads), args, 0, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
