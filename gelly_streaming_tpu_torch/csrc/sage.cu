// The neighbor gather and masked mean of GraphSAGE on Hopper (sm_90a) behind
// a plain C interface, loaded with ctypes (gelly_streaming_tpu_torch/ops/
// _cuda.py, ops/sage.py).
//
// Replaces the gather and mean of sage_kernel
// (gelly_streaming_tpu/library/graphsage.py:53-61), an XLA program of the JAX
// package: features[keys] and features[nbrs] gathered into [K, F] and
// [K, D, F] bf16 tensors, then a masked sum over D and a division by the
// valid count.  The projections that follow stay library products
// (torch.addmm, cuBLAS), as the JAX package leaves them to XLA.
//
// For each row of one degree bucket ([K, D] keys, neighbors and valid
// flags) the kernel writes out[row] = [bf16(table[key]) | bf16(sum / max(n,
// 1))], the sum over the row's valid neighbors of their table rows in f32,
// n their count.  The table is the bf16 copy of the features (rounding
// commutes with the gather, so the values are the JAX package's bf16 casts
// and the gather's bytes halve).  Ids outside [0, C) follow JAX's gather
// rule: below 0 counts from the end once, then clamps into [0, C).
//   A warp takes one row, or one chunk of 256 of a longer row's slots.  A
//   lane reads 8 bf16 (16 B) of a table row, so L = F / 8 lanes cover a
//   128-feature row and the warp's 32 / L groups read that many neighbor
//   slots at once, four slots a group in flight.  The groups' sums are
//   added by shuffles in a fixed order.  A bucket of rows longer than one
//   chunk (the hub buckets hold a few rows of up to 2^17 neighbors) spreads
//   each row over D / 256 warps, which write f32 partial sums and counts;
//   sage_mean_finish_kernel adds a row's chunks in order and writes its
//   mean, so the result does not depend on scheduling.  Tables whose rows
//   are not 16-byte multiples take the scalar path (one bf16 a lane).
//   Bound on the H100 (bytes), for a pane's buckets: the keys, neighbor ids
//   and valid flags read (5 B a slot, 4 B a row), each distinct table row
//   that a key or a valid neighbor names read once (2F B), the output
//   written (4F B a row).  Under slice(ALL) every neighbor is a key too, so
//   for a pane of the GraphSAGE main path (about 1.03M keys, 2^22 neighbor
//   rows in about 5.3M slots, F = 128) that is about 0.82 GB, 0.25 ms at
//   3.35 TB/s.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long gather_row(int i, int size) {
  i = i < 0 ? i + size : i;  // below 0 counts from the end once
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ p, Vec<V>& out) {
  if constexpr (V == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) out.v[j] = __bfloat162float(h[j]);
  } else {
    out.v[0] = __bfloat162float(p[0]);
  }
}

template <int V>
__device__ __forceinline__ void store_row(__nv_bfloat16* __restrict__ p, const float* v) {
  if constexpr (V == 8) {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = __float2bfloat16(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    p[0] = __float2bfloat16(v[0]);
  }
}

// One warp a (row, chunk) item.  out: bf16[k, 2f]; part: f32[k * nchunks, f]
// and part_cnt: int32[k * nchunks] when nchunks > 1.
template <int V>
__global__ void __launch_bounds__(kThreads)
sage_gather_mean_kernel(const __nv_bfloat16* __restrict__ table, int c, int f, const int* __restrict__ keys,
                        const int* __restrict__ nbrs, const uint8_t* __restrict__ valid, int k, int d, int chunk,
                        int nchunks, __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ part_cnt) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(k) * nchunks) return;
  const int row = static_cast<int>(item / nchunks);
  const int ch = static_cast<int>(item % nchunks);
  // lanes a neighbor row: the smallest power of two covering f / V, at most 32
  int per = (f + V - 1) / V;
  int lanes = 1;
  while (lanes < per && lanes < 32) lanes <<= 1;
  const int groups = 32 / lanes;
  const int g = lane / lanes;
  const int li = lane % lanes;
  const int d0 = ch * chunk;
  const int d1 = d0 + chunk < d ? d0 + chunk : d;
  const long long base = static_cast<long long>(row) * d;
  const int* __restrict__ nrow = nbrs + base;
  const uint8_t* __restrict__ vrow = valid + base;
  __nv_bfloat16* __restrict__ orow = out + static_cast<long long>(row) * 2 * f;

  for (int fb = 0; fb < f; fb += lanes * V) {
    const int feat = fb + li * V;
    const bool active = feat < f;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    int cnt = 0;
    for (int s0 = d0 + g; s0 < d1; s0 += groups * kUnroll) {
      long long id[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * groups;
        ok[u] = s < d1 && __ldg(vrow + s) != 0;
        id[u] = ok[u] ? gather_row(__ldg(nrow + s), c) : 0;
      }
      Vec<V> x[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (ok[u] && active) {
          load_row<V>(table + id[u] * f + feat, x[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) x[u].v[j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        cnt += ok[u] ? 1 : 0;
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += x[u].v[j];
      }
    }
    for (int sh = lanes; sh < 32; sh <<= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] += __shfl_xor_sync(kFull, acc[j], sh);
      cnt += __shfl_xor_sync(kFull, cnt, sh);
    }
    if (g != 0 || !active) continue;
    if (nchunks == 1) {
      const float n = static_cast<float>(cnt > 1 ? cnt : 1);
      float m[V];
#pragma unroll
      for (int j = 0; j < V; ++j) m[j] = acc[j] / n;
      store_row<V>(orow + f + feat, m);
    } else {
      float* prow = part + item * f + feat;
#pragma unroll
      for (int j = 0; j < V; ++j) prow[j] = acc[j];
      if (feat == 0) part_cnt[item] = cnt;
    }
    if (ch == 0) {
      Vec<V> self;
      load_row<V>(table + gather_row(__ldg(keys + row), c) * f + feat, self);
      store_row<V>(orow + feat, self.v);
    }
  }
}

// The mean of a row spread over nchunks warps: its chunks' partial sums
// added in order.  One thread a (row, feature).
__global__ void __launch_bounds__(kThreads)
sage_mean_finish_kernel(const float* __restrict__ part, const int* __restrict__ part_cnt, int k, int f,
                        int nchunks, __nv_bfloat16* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(k) * f) return;
  const long long row = i / f;
  const int feat = static_cast<int>(i % f);
  float sum = 0.f;
  int cnt = 0;
  for (int ch = 0; ch < nchunks; ++ch) {
    sum += part[(row * nchunks + ch) * f + feat];
    cnt += part_cnt[row * nchunks + ch];
  }
  out[row * 2 * f + f + feat] = __float2bfloat16(sum / static_cast<float>(cnt > 1 ? cnt : 1));
}

}  // namespace

extern "C" {

// table: bf16[c, f]; keys: int32[k]; nbrs: int32[k, d]; valid: bool[k, d];
// nchunks = ceil(d / chunk) (at least 1); vec: 1 when f is a multiple of 8
// and the table 16-byte aligned; out: bf16[k, 2f]; part: f32[k * nchunks, f]
// and part_cnt: int32[k * nchunks] when nchunks > 1 (else unused).
int sage_gather_mean_launch(const void* table, int c, int f, const void* keys, const void* nbrs,
                            const void* valid, int k, int d, int chunk, int nchunks, int vec, void* out, void* part,
                            void* part_cnt, void* stream) {
  if (k <= 0 || f <= 0 || c <= 0 || chunk <= 0 || nchunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long items = static_cast<long long>(k) * nchunks;
  const unsigned blocks = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  const auto* t = static_cast<const __nv_bfloat16*>(table);
  auto* o = static_cast<__nv_bfloat16*>(out);
  if (vec) {
    sage_gather_mean_kernel<8><<<blocks, kThreads, 0, s>>>(
        t, c, f, static_cast<const int*>(keys), static_cast<const int*>(nbrs), static_cast<const uint8_t*>(valid),
        k, d, chunk, nchunks, o, static_cast<float*>(part), static_cast<int*>(part_cnt));
  } else {
    sage_gather_mean_kernel<1><<<blocks, kThreads, 0, s>>>(
        t, c, f, static_cast<const int*>(keys), static_cast<const int*>(nbrs), static_cast<const uint8_t*>(valid),
        k, d, chunk, nchunks, o, static_cast<float*>(part), static_cast<int*>(part_cnt));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nchunks == 1) return static_cast<int>(err);
  const long long cells = static_cast<long long>(k) * f;
  sage_mean_finish_kernel<<<static_cast<unsigned>((cells + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<const int*>(part_cnt), k, f, nchunks, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
