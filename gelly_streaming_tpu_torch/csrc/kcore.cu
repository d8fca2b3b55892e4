// One round of the k-core h-index fixed point over one degree bucket, on
// Hopper (sm_90a), behind a plain C interface loaded with ctypes
// (gelly_streaming_tpu_torch/ops/_cuda.py, ops/spmv.kcore_round).
//
// Replaces the JAX package's _build_bucket_round with _h_index_rows
// (gelly_streaming_tpu/library/kcore.py:32-56), an XLA step that the host
// loop of core_numbers_windows (:107-115) calls once a bucket a round:
// gather the neighbours' estimates c[nbrs] of a bucket's [K, D] rows, take
// each row's h-index over its valid entries (the largest h with at least h
// entries >= h), and scatter-min it into c at the bucket's keys.
//
// One C call a bucket, two launches, kept apart: the h-index of every row
// into h[K] reads the estimates as they stood before the bucket (JAX's
// Jacobi step within a bucket), then the scatter-min writes them (Gauss-
// Seidel across buckets, in the host's bucket order).  So every round's c
// equals the JAX package's, and a bound on the rounds runs out at the same
// round.
//
// No sort: h is searched.  A row's h is at most its valid count (<= D) and
// only min(c[key], h) is kept, so each value is capped at
// cap = min(c[key], D) and the search runs over [0, cap]: the largest h
// with #(v >= h) >= h (true at 0, and false above the answer).
//   - D <= 16: a thread a row, its values in registers, counted down
//     from cap;
//   - 32 <= D <= 1024: a warp a row, D / 32 values a lane in registers
//     (the row's loads coalesced), a binary search whose counts are warp
//     reductions;
//   - D > 1024 (a hub's row, up to 2^17 wide: more than shared memory
//     holds as int32): a block a row; each thread writes its capped
//     values to the caller's stage buffer once and reads its own back at
//     every step of the binary search, whose counts are block reductions.
// Ids outside [0, C) follow JAX's rules: the gathers c[nbrs] and c[key]
// count below 0 from the end once and clamp, the scatter drops a key still
// outside [0, C) after that.
//
// Bound on the H100 (bytes), a bucket, each distinct byte once: valid
// (1 B a slot), nbrs of the valid slots (4 B each), the distinct
// estimates read (4 B a distinct neighbour or key), the keys read and c
// written at them (8 B a row); the round's bound sums its buckets.  The
// binary search's steps re-read registers (rows up to 1024) or the L2
// (hub rows), not device memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 1024;  // the hub rows' blocks

__device__ __forceinline__ int gather_idx(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int scatter_idx(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// the capped value of slot j of a row: 0 where it is not valid
__device__ __forceinline__ int slot_value(const int* c, int n, const int* nbrs, const uint8_t* valid,
                                          int64_t j, int cap) {
  if (!valid[j]) return 0;
  const int v = __ldg(c + gather_idx(__ldg(nbrs + j), n));
  return v < cap ? v : cap;
}

__device__ __forceinline__ int row_cap(const int* c, int n, const int* keys, int k, int d) {
  const int ck = __ldg(c + gather_idx(__ldg(keys + k), n));
  return ck < d ? ck : d;
}

template <int D>
__global__ void __launch_bounds__(kThreads) h_thread_kernel(const int* c, int n, const int* keys,
                                                            const int* nbrs, const uint8_t* valid,
                                                            int rows, int* h) {
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < rows; k += gridDim.x * kThreads) {
    const int cap = row_cap(c, n, keys, k, D);
    int v[D];
#pragma unroll
    for (int j = 0; j < D; ++j) v[j] = slot_value(c, n, nbrs, valid, int64_t(k) * D + j, cap);
    int hh = cap;
    for (; hh > 0; --hh) {
      int cnt = 0;
#pragma unroll
      for (int j = 0; j < D; ++j) cnt += v[j] >= hh;
      if (cnt >= hh) break;
    }
    h[k] = hh;
  }
}

template <int P>  // D = 32 * P
__global__ void __launch_bounds__(kThreads) h_warp_kernel(const int* c, int n, const int* keys,
                                                          const int* nbrs, const uint8_t* valid,
                                                          int rows, int* h) {
  constexpr int D = 32 * P;
  const int lane = threadIdx.x & 31;
  for (int k = blockIdx.x * kWarps + (threadIdx.x >> 5); k < rows; k += gridDim.x * kWarps) {
    const int cap = row_cap(c, n, keys, k, D);
    int v[P];
#pragma unroll
    for (int p = 0; p < P; ++p) v[p] = slot_value(c, n, nbrs, valid, int64_t(k) * D + p * 32 + lane, cap);
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
    if (lane == 0) h[k] = lo;
  }
}

__device__ int block_count(int x) {
  __shared__ int s[kBlockThreads / 32];
  __shared__ int total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = __reduce_add_sync(kFull, x);
  if (lane == 0) s[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kBlockThreads / 32; ++w) t += s[w];
    total = t;
  }
  __syncthreads();
  const int out = total;
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kBlockThreads) h_block_kernel(const int* c, int n, const int* keys,
                                                                const int* nbrs, const uint8_t* valid,
                                                                int rows, int d, int* stage, int* h) {
  for (int k = blockIdx.x; k < rows; k += gridDim.x) {
    const int cap = row_cap(c, n, keys, k, d);
    int* s = stage + int64_t(k) * d;
    // each thread stages the slots j = tid + m * blockDim and reads only
    // those back, so its own writes are all it needs to see
    for (int j = threadIdx.x; j < d; j += kBlockThreads) s[j] = slot_value(c, n, nbrs, valid, int64_t(k) * d + j, cap);
    int lo = 0, hi = cap;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      int cnt = 0;
      for (int j = threadIdx.x; j < d; j += kBlockThreads) cnt += s[j] >= mid;
      if (block_count(cnt) >= mid)
        lo = mid;
      else
        hi = mid - 1;
    }
    if (threadIdx.x == 0) h[k] = lo;
  }
}

__global__ void scatter_min_kernel(int* c, int n, const int* keys, const int* h, int rows) {
  for (int k = blockIdx.x * kThreads + threadIdx.x; k < rows; k += gridDim.x * kThreads) {
    const int t = scatter_idx(__ldg(keys + k), n);
    if (t >= 0) atomicMin(c + t, __ldg(h + k));
  }
}

int grid_for(int64_t items, int per_block) {
  int64_t b = (items + per_block - 1) / per_block;
  b = b < 65535 ? b : 65535;
  return static_cast<int>(b > 0 ? b : 1);
}

template <int D>
void thread_rows(const int* c, int n, const int* keys, const int* nbrs, const uint8_t* valid, int rows, int* h,
                 cudaStream_t s) {
  h_thread_kernel<D><<<grid_for(rows, kThreads), kThreads, 0, s>>>(c, n, keys, nbrs, valid, rows, h);
}

template <int P>
void warp_rows(const int* c, int n, const int* keys, const int* nbrs, const uint8_t* valid, int rows, int* h,
               cudaStream_t s) {
  h_warp_kernel<P><<<grid_for(rows, kWarps), kThreads, 0, s>>>(c, n, keys, nbrs, valid, rows, h);
}

}  // namespace

extern "C" {

// c: int32[n], the estimates, updated in place; keys: int32[k]; nbrs:
// int32[k, d]; valid: uint8[k, d]; d: a power of two; h: int32[k] of
// scratch; stage: int32[k, d] of scratch when d > 1024, else unused (may
// be null).  Enqueues the h-index kernel, then the scatter-min, on the
// stream, with no host sync.
int kcore_round_launch(void* c, int n, const void* keys, const void* nbrs, const void* valid, int k, int d,
                       void* h, void* stage, void* stream) {
  if (k <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  if (d <= 0 || (d & (d - 1)) || (d > 1024 && stage == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  auto* cp = static_cast<int*>(c);
  auto* kp = static_cast<const int*>(keys);
  auto* np = static_cast<const int*>(nbrs);
  auto* vp = static_cast<const uint8_t*>(valid);
  auto* hp = static_cast<int*>(h);
  auto s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 1: thread_rows<1>(cp, n, kp, np, vp, k, hp, s); break;
    case 2: thread_rows<2>(cp, n, kp, np, vp, k, hp, s); break;
    case 4: thread_rows<4>(cp, n, kp, np, vp, k, hp, s); break;
    case 8: thread_rows<8>(cp, n, kp, np, vp, k, hp, s); break;
    case 16: thread_rows<16>(cp, n, kp, np, vp, k, hp, s); break;
    case 32: warp_rows<1>(cp, n, kp, np, vp, k, hp, s); break;
    case 64: warp_rows<2>(cp, n, kp, np, vp, k, hp, s); break;
    case 128: warp_rows<4>(cp, n, kp, np, vp, k, hp, s); break;
    case 256: warp_rows<8>(cp, n, kp, np, vp, k, hp, s); break;
    case 512: warp_rows<16>(cp, n, kp, np, vp, k, hp, s); break;
    case 1024: warp_rows<32>(cp, n, kp, np, vp, k, hp, s); break;
    default:
      h_block_kernel<<<grid_for(k, 1), kBlockThreads, 0, s>>>(cp, n, kp, np, vp, k, d, static_cast<int*>(stage),
                                                               hp);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_min_kernel<<<grid_for(k, kThreads), kThreads, 0, s>>>(cp, n, kp, hp, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
