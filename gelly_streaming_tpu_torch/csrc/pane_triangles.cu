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
// Both kernels launch on the caller's stream, allocate nothing, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kIdBits = 14;  // pack_pane: word = u | v << 14, ids < 2^14
constexpr uint32_t kIdMask = (1u << kIdBits) - 1u;

// ---------------------------------------------------------------------------
// pane_adjacency: packed pane words -> symmetric bitset adjacency.
//
// Replaces _count_from_packed + _adjacency_count (pallas_triangles.py:119-146).
// One thread per word.  Word i < n (n is read from device memory, so pane
// sizes vary without host syncs) with u != v sets bits (u, v) and (v, u)
// with atomicOr: duplicates and both orientations collapse onto the same
// bits, which is the dedup/canonicalization the JAX scatter-max does.  Ids
// at or past k are dropped, as an out-of-bounds XLA scatter drops them.
//
// Bound on the H100: bytes.  It reads 4 B per edge and writes K*K/8 bytes
// (the bitset, zeroed by the wrapper); the scattered atomics land in L2.
// The design keeps the output 8x smaller than a bool matrix (32x smaller
// than the bf16 matrix the TPU kernel reads) so the memset and the
// counting pass that follows both touch L2-sized data.
__global__ void pane_adjacency_kernel(const uint32_t* __restrict__ words,
                                      const int32_t* __restrict__ n_ptr,
                                      int cap, uint32_t* __restrict__ bits,
                                      int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap || i >= __ldg(n_ptr)) return;
  const uint32_t w = __ldg(words + i);
  const uint32_t u = w & kIdMask;
  const uint32_t v = w >> kIdBits;
  if (u == v || u >= static_cast<uint32_t>(k) || v >= static_cast<uint32_t>(k))
    return;
  const size_t wpr = static_cast<size_t>(k) >> 5;
  atomicOr(bits + u * wpr + (v >> 5), 1u << (v & 31u));
  atomicOr(bits + v * wpr + (u >> 5), 1u << (u & 31u));
}

// ---------------------------------------------------------------------------
// dense_triangles: sum over i, j of A[i,j] * (A @ A)[i,j] as one uint64.
//
// Replaces the Pallas _kernel / _count_halves (pallas_triangles.py:38-87).
// A is symmetric, so (A @ A)[i, j] = popc(row_i & row_j) summed over the
// row's words, and the masked sum only needs it where A[i, j] = 1.  One
// block per row i: the block stages row_i in shared memory (<= 2 KB at
// K = 2^14), each warp takes a strided share of row_i's words and walks
// their set bits j, and the warp's 32 lanes stride over the K/32 words of
// row_j, accumulating popc(row_i & row_j).  A block reduction and ONE
// 64-bit atomicAdd per row finish it.
//
// Exactness: a lane sees at most K neighbors j and K/1024 words of each,
// so its partial is <= K^2/32; a row's sum is <= K^2 = 2^28 at K = 2^14.
// 32-bit lane and warp sums and a 64-bit block sum are therefore exact, and
// the grand total is <= K^3 = 2^42.  The
// uint64 total replaces the TPU kernel's lo/hi int32 split.
//
// Bound on the H100: the work is data dependent, nnz(A) row intersections
// of K bits each, read from the L2-resident bitset.  Skipping zero bits of
// row_i does the work only where A[i, j] = 1, instead of the dense 2*K^3
// of A @ A.  Rows with many neighbors and warps with uneven shares are the
// known slack; tensor cores or tile skipping are later work.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
dense_triangles_kernel(const uint32_t* __restrict__ bits, int k,
                       unsigned long long* __restrict__ total) {
  extern __shared__ uint32_t row[];
  __shared__ unsigned long long warp_sums[kWarps];
  const int wpr = k >> 5;
  const uint32_t* ri = bits + static_cast<size_t>(blockIdx.x) * wpr;
  for (int x = threadIdx.x; x < wpr; x += kThreads) row[x] = ri[x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t acc = 0;
  for (int w = warp; w < wpr; w += kWarps) {
    uint32_t m = row[w];
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1u;
      const uint32_t* rj = bits + static_cast<size_t>(w * 32 + b) * wpr;
      for (int x = lane; x < wpr; x += 32) acc += __popc(row[x] & __ldg(rj + x));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int i = 0; i < kWarps; ++i) s += warp_sums[i];
    if (s) atomicAdd(total, s);
  }
}

}  // namespace

extern "C" {

// words: uint32[cap] packed pane words; n_ptr: int32[1] live word count on
// the device; bits: uint32[k, k/32], zeroed by the caller; k % 32 == 0.
int pane_adjacency_launch(const void* words, const void* n_ptr, int cap,
                          void* bits, int k, void* stream) {
  if (cap > 0) {
    const int threads = 256;
    const int blocks = (cap + threads - 1) / threads;
    pane_adjacency_kernel<<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const int32_t*>(n_ptr), cap, static_cast<uint32_t*>(bits),
        k);
  }
  return static_cast<int>(cudaGetLastError());
}

// bits: uint32[k, k/32]; total: uint64[1], zeroed by the caller, receives
// sum(A * (A @ A)) (added to, never overwritten).
int dense_triangles_launch(const void* bits, int k, void* total, void* stream) {
  if (k > 0) {
    const size_t smem = static_cast<size_t>(k >> 5) * sizeof(uint32_t);
    dense_triangles_kernel<<<k, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bits), k,
        static_cast<unsigned long long*>(total));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
