// Dense pane triangle counting on Hopper (sm_90a): two kernels behind a
// plain C interface, loaded with ctypes (gelly_streaming_tpu_torch/ops/_cuda.py).
//
// Together they replace the JAX package's dense pane count
// (gelly_streaming_tpu/ops/pallas_triangles.py): the packed-word decode and
// adjacency scatter (_count_from_packed / _adjacency_count) and the Pallas
// MXU kernel (_kernel via _count_halves), which computes sum(A * (A @ A))
// for a symmetric 0/1 adjacency A with zero diagonal; /6 on the host gives
// the triangle count.
//
// The adjacency lives as a BITSET, K/32 uint32 words per row (bit j of row
// i set iff (i, j) is an edge): 2 MB at K = 4096, 32 MB at K = 2^14, so the
// whole matrix stays resident in the H100's 50 MB L2 while it is counted.
// The launchers run on the caller's stream, allocate nothing, clear their
// outputs themselves (cudaMemsetAsync) and return the first CUDA error, so
// the Python wrapper can raise on a refused launch.  pane_triangles_launch
// enqueues the whole pane count (both clears, both kernels) in one call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIdBits = 14;  // pack_pane: word = u | v << 14, ids < 2^14
constexpr uint32_t kIdMask = (1u << kIdBits) - 1u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// pane_adjacency: packed pane words -> symmetric bitset adjacency.
//
// Replaces _count_from_packed + _adjacency_count (pallas_triangles.py:119-146).
// Each thread reads 4 words with one 16 B load (scalar loads for an
// unaligned array and for the tail past cap).  Word i < n (n is read from
// device memory, so pane sizes vary without host syncs) with u != v sets
// bits (u, v) and (v, u) with atomicOr: duplicates and both orientations
// collapse onto the same bits, which is the dedup/canonicalization the JAX
// scatter-max does.  Ids at or past k are dropped, as an out-of-bounds XLA
// scatter drops them.
//
// Bound on the H100: bytes.  It reads 4 B per edge and writes K*K/8 bytes
// (the bitset, cleared by the launcher's memset); the scattered atomics
// land in L2.  The bitset is 8x smaller than a bool matrix (32x smaller
// than the bf16 matrix the TPU kernel reads), so the clear and the count
// that follows touch L2-sized data, and the wide loads keep 2^17 edges to
// 128 blocks of 256 threads.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pane_adjacency_kernel(const uint32_t* __restrict__ words,
                      const int32_t* __restrict__ n_ptr, int cap,
                      uint32_t* __restrict__ bits, int k) {
  const int first = 4 * (blockIdx.x * kThreads + threadIdx.x);
  const int live = min(cap, __ldg(n_ptr));
  if (first >= live) return;
  uint32_t w[4];
  if (kVec && first + 4 <= cap) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(words + first));
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = first + q < cap ? __ldg(words + first + q) : 0u;
  }
  const size_t wpr = static_cast<size_t>(k) >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t u = w[q] & kIdMask;
    const uint32_t v = w[q] >> kIdBits;
    if (first + q >= live || u == v || u >= static_cast<uint32_t>(k) ||
        v >= static_cast<uint32_t>(k))
      continue;
    atomicOr(bits + u * wpr + (v >> 5), 1u << (v & 31u));
    atomicOr(bits + v * wpr + (u >> 5), 1u << (u & 31u));
  }
}

// ---------------------------------------------------------------------------
// dense_triangles: sum over i, j of A[i,j] * (A @ A)[i,j] as one uint64.
//
// Replaces the Pallas _kernel / _count_halves (pallas_triangles.py:38-87).
// For a symmetric zero-diagonal A that sum is 6x the number of triangles
// i < j < k, and the kernel counts each triangle once: for every edge
// i < j it takes popc(row_i & row_j) over the words of row j from j/32 on,
// with the bits at or below j masked off in word j/32, and multiplies the
// grand total by 6.  That reads about a sixth of the row bytes a count
// over all ordered pairs reads (each edge once, and only a row suffix).
//
// Bound on the H100: the work is data dependent.  At the main path's
// widths neither side alone bounds it: the integer pipes (AND, popc at 16
// lanes a clock an SM, masks) and the L2 bytes of the row suffixes each
// take most of the time when the other is removed; the bitset stays
// resident in L2.  The design:
//   * Work item = a slab of 32 words (1024 columns) of 8 rows, one row a
//     warp, a block per item and a persistent grid striding over them.
//     Items run slab-major, so the longest suffixes come first; item g of
//     a slab with n items takes rows g, g + n, ..., g + 7n, so neighbouring
//     hub ids fall in different blocks.  Rows whose columns in the slab
//     all lie at or below i are not enumerated at all.
//   * Each warp stages its row's words from the slab on in shared memory
//     (16 B loads), takes the slab's candidate words from them by shuffle
//     and writes its columns j > i to its list in shared memory (a warp
//     scan of the lanes' counts places them).
//   * Each warp counts its own row's pairs with row i in registers, one
//     uint4 a lane at K = 4096, four at 2^14, unless the row is a hub
//     (more than kShareAbove columns j > i in the slab): the block's 8
//     warps then count each hub row together, so a hub row is spread over
//     8 warps a slab.
//   * The row suffix left from the slab on sets the lanes per neighbour:
//     32 lanes (up to 4 uint4 each) past 64 words, 16 or 8 lanes of one
//     uint4 below, so short suffixes keep the lanes busy and 2 or 4
//     neighbours share an instruction.  Rows j are read with 16 B loads,
//     only from word j/32 on, U neighbours a group at a time, so every
//     load of a batch is in flight before any is consumed.  The mask of
//     the bits at or below j applies in the one lane that holds word j/32.
//     Scalar loads take over when K/32 is not a multiple of 4 or the
//     bitset is not 16 B aligned; a bounds check on each word covers the
//     row's tail.
//   * 32-bit popc sums per lane and item (<= 8192 pairs * 512 bits at
//     K = 2^14), 64-bit lane sums, a warp shuffle and shared-memory
//     reduction, and ONE 64-bit atomicAdd per block.  The total is
//     <= K^3 = 2^42, exact in uint64.
constexpr int kMaxWpr = (1 << 14) / 32;  // row words at K = 2^14
constexpr int kShareAbove = 64;

template <bool kVec>
__device__ __forceinline__ uint4 load_words(const uint32_t* __restrict__ row,
                                            int w, int wpr) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (kVec) {  // wpr % 4 == 0, so w < wpr puts the whole uint4 in the row
    if (w < wpr) r = __ldg(reinterpret_cast<const uint4*>(row + w));
  } else {
    if (w < wpr) r.x = __ldg(row + w);
    if (w + 1 < wpr) r.y = __ldg(row + w + 1);
    if (w + 2 < wpr) r.z = __ldg(row + w + 2);
    if (w + 3 < wpr) r.w = __ldg(row + w + 3);
  }
  return r;
}

// bits of word x that lie strictly above column c = 32 * cw + cb, where
// above_cb is the mask of the bits above cb within its word
__device__ __forceinline__ uint32_t above(int x, int cw, uint32_t above_cb) {
  return x > cw ? kFull : (x == cw ? above_cb : 0u);
}

__device__ __forceinline__ uint32_t above_bit(int cb) {
  return cb == 31 ? 0u : kFull << (cb + 1);
}

// Rows with a column above them in slab s, the block items (groups of 8
// such rows) of slab s, and the block items of all slabs.
__host__ __device__ __forceinline__ int slab_rows(int k, int s) {
  const int last = 1024 * (s + 1) - 1;  // the slab's last column
  return k < last ? k : last;
}

__host__ __device__ __forceinline__ int slab_groups(int k, int s) {
  return (slab_rows(k, s) + kWarps - 1) / kWarps;
}

__host__ __device__ __forceinline__ int block_items(int k) {
  int items = 0;
  for (int s = 0; s < ((k >> 5) + 31) >> 5; ++s) items += slab_groups(k, s);
  return items;
}

// Sum over the first n neighbours j of row `it` in the block's lists of
// popc(row_i & row_j) over the columns above j.  G lanes a neighbour, RR
// uint4 of row i a lane (from shared memory into registers), U neighbours
// a group per batch; G * 4 * RR covers the row from w0 on.  kShare: the
// block's 8 warps take turns over the row's neighbours; else the calling
// warp takes them all.
template <int G, int RR, int U, bool kVec, bool kShare>
__device__ __forceinline__ uint32_t count_row(const uint32_t* __restrict__ bits, int wpr,
                                              int w0, int warp, int lane, int it, int n,
                                              const uint16_t* lists, const uint32_t* rows) {
  constexpr int NG = 32 / G;  // neighbour groups in a warp
  constexpr int GROUPS = kShare ? kWarps * NG : NG;
  const int gl = lane % G;
  const int gid = (kShare ? warp * NG : 0) + lane / G;
  const uint16_t* list = lists + it * 1024;
  uint4 row[RR];
#pragma unroll
  for (int q = 0; q < RR; ++q) {
    const int x = w0 + 4 * gl + 4 * G * q;
    row[q] = x < wpr ? *reinterpret_cast<const uint4*>(rows + it * kMaxWpr + (x - w0))
                     : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t part = 0;
  for (int base = 0; base < n; base += U * GROUPS) {
    int js[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = base + u * GROUPS + gid;
      js[u] = p < n ? 32 * w0 + list[p] : -1;
    }
    uint4 col[U][RR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jw = js[u] >> 5;  // -1 for no neighbour
      const uint32_t* rj = bits + static_cast<size_t>(js[u] < 0 ? 0 : js[u]) * wpr;
#pragma unroll
      for (int q = 0; q < RR; ++q) {
        const int x = w0 + 4 * gl + 4 * G * q;
        col[u][q] = js[u] >= 0 && x + 3 >= jw ? load_words<kVec>(rj, x, wpr)
                                              : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jw = js[u] >> 5;
      const uint32_t above_jb = above_bit(js[u] & 31);
#pragma unroll
      for (int q = 0; q < RR; ++q) {
        const int x = w0 + 4 * gl + 4 * G * q;
        uint4 b = col[u][q];
        if (x <= jw) {  // the lane whose words hold column j
          b.x &= above(x, jw, above_jb);
          b.y &= above(x + 1, jw, above_jb);
          b.z &= above(x + 2, jw, above_jb);
          b.w &= above(x + 3, jw, above_jb);
        }
        part += __popc(row[q].x & b.x) + __popc(row[q].y & b.y) +
                __popc(row[q].z & b.z) + __popc(row[q].w & b.w);
      }
    }
  }
  return part;
}

// One block item: each warp counts its own row unless the row is a hub
// (more than kShareAbove neighbours); then the 8 warps count each hub row
// together.  Returns the warp's partial sum and whether any row was shared.
template <int G, int RR, int U, bool kVec>
__device__ __forceinline__ uint32_t count_item(const uint32_t* __restrict__ bits, int wpr,
                                               int w0, int warp, int lane, const int* counts,
                                               const uint16_t* lists, const uint32_t* rows,
                                               bool* shared) {
  uint32_t part = 0;
  if (counts[warp] <= kShareAbove)
    part = count_row<G, RR, U, kVec, false>(bits, wpr, w0, warp, lane, warp, counts[warp],
                                            lists, rows);
  *shared = false;
  for (int it = 0; it < kWarps; ++it) {
    if (counts[it] > kShareAbove) {  // the same in every warp
      part += count_row<G, RR, U, kVec, true>(bits, wpr, w0, warp, lane, it, counts[it],
                                              lists, rows);
      *shared = true;
    }
  }
  return part;
}

template <int R, bool kVec>
__global__ void __launch_bounds__(kThreads)
dense_triangles_kernel(const uint32_t* __restrict__ bits, int k,
                       unsigned long long* __restrict__ total) {
  __shared__ unsigned long long warp_sums[kWarps];
  __shared__ int counts[2][kWarps];  // by item parity
  __shared__ uint16_t lists[kWarps * 1024];
  __shared__ __align__(16) uint32_t rows[kWarps * kMaxWpr];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wpr = k >> 5;
  const int items = block_items(k);
  uint32_t* row_s = rows + warp * kMaxWpr;
  uint16_t* list = lists + warp * 1024;
  unsigned long long acc = 0;

  for (int b = blockIdx.x, parity = 0; b < items; b += gridDim.x, parity ^= 1) {
    int s = 0, g = b;
    while (g >= slab_groups(k, s)) g -= slab_groups(k, s++);
    const int w0 = 32 * s;
    const int left = wpr - w0;  // row words from the slab on
    const int i = g + warp * slab_groups(k, s);

    // stage row i from w0 on: lane l, slot q holds words w0 + 4l + 128q
    uint4 first = make_uint4(0u, 0u, 0u, 0u);
    if (i < slab_rows(k, s)) {
      const uint32_t* ri = bits + static_cast<size_t>(i) * wpr;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int off = 4 * lane + 128 * q;
        if (off < left) {
          const uint4 v = load_words<kVec>(ri, w0 + off, wpr);
          *reinterpret_cast<uint4*>(row_s + off) = v;
          if (q == 0) first = v;
        }
      }
    }
    // lane l's candidate word w0 + l is word l % 4 of lane l / 4's first uint4
    const int src = lane >> 2;
    const uint32_t cx = __shfl_sync(kFull, first.x, src);
    const uint32_t cy = __shfl_sync(kFull, first.y, src);
    const uint32_t cz = __shfl_sync(kFull, first.z, src);
    const uint32_t cw = __shfl_sync(kFull, first.w, src);
    const int c = lane & 3;
    uint32_t mine = c == 0 ? cx : (c == 1 ? cy : (c == 2 ? cz : cw));
    mine &= above(w0 + lane, i >> 5, above_bit(i & 31));
    const int own = __popc(mine);
    int end = own;  // inclusive scan of the lanes' counts
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, end, off);
      if (lane >= off) end += y;
    }
    for (int pos = end - own; mine; mine &= mine - 1u)
      list[pos++] = static_cast<uint16_t>(32 * lane + __ffs(mine) - 1);
    if (lane == 31) counts[parity][warp] = end;
    __syncthreads();

    const int* n = counts[parity];
    bool shared = false;
    uint32_t part = 0;
    if (left <= 32)
      part = count_item<8, 1, 4, kVec>(bits, wpr, w0, warp, lane, n, lists, rows, &shared);
    else if (left <= 64)
      part = count_item<16, 1, 4, kVec>(bits, wpr, w0, warp, lane, n, lists, rows, &shared);
    else if (left <= 128)
      part = count_item<32, 1, 4, kVec>(bits, wpr, w0, warp, lane, n, lists, rows, &shared);
    else if constexpr (R > 1)
      part = count_item<32, R, (R == 2 ? 2 : 1), kVec>(bits, wpr, w0, warp, lane, n, lists,
                                                       rows, &shared);
    acc += part;
    // Before the next item's barrier a warp rewrites only its own row, its
    // own list and the other parity's count, so only a shared round, which
    // reads other warps' rows and lists, must finish first.
    if (shared) __syncthreads();
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += warp_sums[w];
    if (sum) atomicAdd(total, 6ull * sum);
  }
}

// Resident blocks of `kernel` on the whole card, looked up once per
// device and kernel instance.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int* cached_device, int* cached_blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || *cached_device == dev) return err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *cached_blocks = sms * (per_sm > 0 ? per_sm : 1);
  *cached_device = dev;
  return cudaSuccess;
}

template <int R, bool kVec>
cudaError_t launch_dense(const uint32_t* bits, int k, unsigned long long* total,
                         cudaStream_t stream) {
  static int cached_device = -1, cached_blocks = 0;
  const cudaError_t err =
      resident_blocks(dense_triangles_kernel<R, kVec>, &cached_device, &cached_blocks);
  if (err != cudaSuccess) return err;
  const int needed = block_items(k);
  const int blocks = needed < cached_blocks ? needed : cached_blocks;
  dense_triangles_kernel<R, kVec><<<blocks, kThreads, 0, stream>>>(bits, k, total);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_dense_vec(const uint32_t* bits, int k, unsigned long long* total,
                             cudaStream_t stream) {
  switch (((k >> 5) + 127) >> 7) {  // R = uint4 slots a lane needs for a row
    case 1: return launch_dense<1, kVec>(bits, k, total, stream);
    case 2: return launch_dense<2, kVec>(bits, k, total, stream);
    case 3: return launch_dense<3, kVec>(bits, k, total, stream);
    case 4: return launch_dense<4, kVec>(bits, k, total, stream);
    default: return cudaErrorInvalidValue;  // k > 2^14
  }
}

}  // namespace

extern "C" {

// words: uint32[cap] packed pane words; n_ptr: int32[1] live word count on
// the device; bits: uint32[k, k/32], cleared here; k % 32 == 0, k <= 2^14.
int pane_adjacency_launch(const void* words, const void* n_ptr, int cap,
                          void* bits, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nbytes = static_cast<size_t>(k) * static_cast<size_t>(k >> 5) * sizeof(uint32_t);
  cudaError_t err = cudaMemsetAsync(bits, 0, nbytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cap > 0) {
    const int threads_needed = (cap + 3) / 4;
    const int blocks = (threads_needed + kThreads - 1) / kThreads;
    const auto* w = static_cast<const uint32_t*>(words);
    const auto* n = static_cast<const int32_t*>(n_ptr);
    auto* b = static_cast<uint32_t*>(bits);
    if ((reinterpret_cast<uintptr_t>(words) & 15u) == 0)
      pane_adjacency_kernel<true><<<blocks, kThreads, 0, s>>>(w, n, cap, b, k);
    else
      pane_adjacency_kernel<false><<<blocks, kThreads, 0, s>>>(w, n, cap, b, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// bits: uint32[k, k/32] of a symmetric zero-diagonal adjacency; total:
// uint64[1], cleared here, receives sum(A * (A @ A)).
int dense_triangles_launch(const void* bits, int k, void* total, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess || k <= 0) return static_cast<int>(err);
  const auto* b = static_cast<const uint32_t*>(bits);
  auto* t = static_cast<unsigned long long*>(total);
  const bool vec = (k >> 5) % 4 == 0 && (reinterpret_cast<uintptr_t>(bits) & 15u) == 0;
  err = vec ? launch_dense_vec<true>(b, k, t, s) : launch_dense_vec<false>(b, k, t, s);
  return static_cast<int>(err);
}

// The whole dense pane count in one call: clear bits and total, scatter
// the packed words into the bitset, count.  Arguments as above.
int pane_triangles_launch(const void* words, const void* n_ptr, int cap,
                          void* bits, int k, void* total, void* stream) {
  const int err = pane_adjacency_launch(words, n_ptr, cap, bits, k, stream);
  if (err != 0) return err;
  return dense_triangles_launch(bits, k, total, stream);
}

}  // extern "C"
