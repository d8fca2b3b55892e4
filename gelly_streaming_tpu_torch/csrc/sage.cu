// One GraphSAGE layer on Hopper (sm_90a) as one kernel, and its weight
// gradient, behind a plain C interface loaded with ctypes
// (gelly_streaming_tpu_torch/ops/_cuda.py, ops/sage.py).
//
// Replaces sage_kernel (gelly_streaming_tpu/library/graphsage.py:53-62), an
// XLA program of the JAX package: features[keys] and features[nbrs]
// gathered into [K, F] and [K, D, F] bf16 tensors, a masked sum over D and a
// division by the valid count, the two projections, the bias and ReLU.
// The weight gradient (sage_layer_backward, at the end of the file)
// replaces the backward that XLA derives from it for sage_train_step
// (graphsage.py:396, jax.value_and_grad of sage_loss).
//
// For one degree bucket ([K] keys, [K, D] neighbors and valid flags) the
// kernel writes out[row] = relu([bf16(table[key]) | bf16(sum * (1 / max(n,
// 1)))] @ [W_self; W_nbr] + bias) as bf16, the sum over the row's valid
// neighbors of their table rows in f32, n their count, the product
// accumulated in f32, the bias added in f32 and the result rounded once.
// The table is the bf16 copy of the features (rounding commutes with the
// gather).  Ids outside [0, C) follow JAX's gather rule: below 0 counts
// from the end once, then clamps into [0, C).
//
// Bound on the H100 (bytes), for a pane's buckets: the ids and flags read
// (4 B a key, 5 B a slot), each distinct table row that a key or a valid
// neighbor names read once (2 F_in B), W and the bias once, the output
// written once (2 F_out B a row).  For a uniform pane of the GraphSAGE
// main path (2^22 directed rows, about 1.03M keys, F = 128) that is about
// 0.56 GB, 0.17 ms at 3.35 TB/s; the product (2 * K * 2F_in * F_out, 67
// GFLOP) takes 0.07 ms at the dense bf16 rate.
//
// Design.  Persistent blocks walk a bucket's tiles of 64 rows; a block
// keeps the tile's [x_self | mean] A-tile, bf16 [64, 2 F_in] (or a K chunk
// of it, below), in shared memory: it never goes to device memory.
//   Gather.  A warp takes 8 of the tile's rows; a lane reads 16 bytes (8
//   bf16) of a table row, so F_in / 8 lanes cover a row and the warp's
//   lane groups split its rows.  A group walks its rows' (row, slot) pairs
//   flat: each lane fetches one pair's id a chunk, the group's lanes then
//   load eight neighbor rows at once (the ids by shuffles) while the next
//   eight are prefetched to L2, so short rows (most rows of a pane hold 1
//   to 8 neighbors) keep as many bytes in flight as long ones.  For D = 1,
//   2, 4, 8, 16 and 32 the rows' ends sit at compile-time positions of a
//   batch, so a row's mean costs no test a pair.  The self rows go
//   straight into the tile by 16-byte cp.async, issued once the first ids
//   are on their way; the next tile's keys, ids and flags are prefetched
//   to L2.  Sums in f32 registers; the mean, the sum times the count's
//   reciprocal, rounded once to bf16 into the tile.
//   Product.  wgmma (m64n64k16, bf16 in, f32 accumulators): each of the
//   block's two warpgroups computes 64 of an n-tile's 128 output columns
//   from the A-tile (K-major) and [W_self; W_nbr] (N-major, B transposed),
//   both in 128-byte-swizzled shared tiles, so the gather's 16-byte pieces
//   land without bank conflicts.  At the main path's 128 -> 128 the weights
//   stay resident (64 KB, copied once by each block).  wgmma and not
//   mma.sync: with mma.sync steps (warp tiles fed by ldmatrix) the product
//   held the block longer than its gather did; wgmma runs the whole 64-row
//   product asynchronously from shared memory.  Two blocks fit an SM
//   (106.5 KB each), so one block's gather overlaps the other's product.
//   Epilogue.  Bias and ReLU in f32, one rounding to bf16, staged in shared
//   memory (the A-tile's, once both warpgroups are done with it), then
//   written out whole rows a warp, into the caller's buffer at the bucket's
//   row offset.  (Writing 64-byte runs straight from the fragments cost
//   more than the product.)
//   Empty neighborhoods.  D = 0 (the training contexts): the mean half of
//   the A-tile is all zeros, so the product walks only the self half's
//   k-steps (the last may reach 8 zero mean columns), as the JAX package's
//   context is x_self @ W_self + bias.
//   Long rows.  A bucket of rows of more than 32 slots (the hub pane holds
//   rows of up to 2^17 neighbors) first runs sage_partial_kernel: one warp
//   a (row, 256-slot chunk) writes f32 partial sums and counts.  The layer
//   kernel then adds a row's chunks in a fixed order: a thread a (row, 8
//   features) for rows of up to 16 chunks, the whole block a row for more,
//   so the result does not depend on scheduling.
//   Widths.  Every width runs.  F_in and F_out multiples of 8 (and the
//   table, W and the output 16-byte aligned) take wgmma: an n-tile's
//   columns are rounded up to 64 in W's shared tile, and the padded
//   columns' results are never stored.  A layer whose A-tile and W tile do
//   not fit shared memory together (F_in above 256 at F_out = 128) walks
//   F_in in K chunks of 128 features: the chunk's self and mean columns
//   gathered, its rows of W loaded, the product accumulated in the same
//   f32 registers; with several n-tiles the chunks are gathered anew for
//   each.  Other widths take the CUDA-core instantiation: the same gather,
//   K chunks of up to 512 features, a thread a column of a 128-column
//   n-tile and 32 of the tile's rows in f32 registers, W read through the
//   cache.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kUnroll = 4;      // neighbor slots in flight a lane group (partial-sum kernel)
constexpr int kBatch = 8;       // table rows in flight a lane (layer kernel)
constexpr int kDirectSlots = 32;  // rows of up to this many slots are gathered by the layer kernel
constexpr int kFewChunks = 16;   // partial sums a row that one thread adds (more: the whole block)
constexpr int kPad = 8;      // bf16 of padding a shared row: rows land 16 B apart in the banks
constexpr int kMaxCols = 128;  // output columns an n-tile
constexpr int kChunkTensor = 128;  // features a K chunk (wgmma) where the whole width does not fit
constexpr int kChunkCore = 512;    // features a K chunk at most (CUDA cores)
constexpr int kSmemLimit = 227 * 1024;
constexpr int kMaxDevices = 64;  // devices a process may launch on
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
__device__ __forceinline__ void store_row(__nv_bfloat16* p, const float* v) {
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void prefetch_l2(const void* p) { asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p)); }

// The 128-byte lines of [p, p + bytes) into L2, one a thread.
__device__ __forceinline__ void prefetch_range(const void* p, long long bytes) {
  for (long long off = threadIdx.x * 128ll; off < bytes; off += 128ll * kThreads)
    prefetch_l2(static_cast<const char*>(p) + off);
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The layer kernel's products: the CUDA cores or wgmma.
enum Mode { kCudaCore = 0, kWgmma = 1 };

struct LayerArgs {
  const __nv_bfloat16* table;
  int c, f_in;
  const int* keys;
  const int* nbrs;
  const uint8_t* valid;
  int k, d;
  const float* part;  // nchunks > 0: f32 [k * nchunks, f_in] partial sums
  const int* part_cnt;
  int nchunks;
  const __nv_bfloat16* w;  // [2 f_in, f_out]
  const __nv_bfloat16* bias;
  int f_out;
  __nv_bfloat16* out;  // [k, f_out], already at the bucket's row offset
  // the plan (plan_layer): features a K chunk, output columns an n-tile,
  // the byte offsets of W's tile, the staged output, the partial sums'
  // scratch and the bias in the block's shared memory
  int kc, nt;
  int w_off, o_off, red_off, bias_off;
};

// Element (row, col) of a 128-byte-swizzled K-major operand for wgmma:
// atoms of 8 rows x 64 bf16 (1024 bytes, 1024-aligned), the 16-byte units
// of a row permuted by (unit ^ row % 8); the atoms of each 64-column slice
// one after another down the row groups (groups: rows / 8).
__device__ __forceinline__ int swz_index(int row, int col, int groups) {
  return ((col >> 6) * groups + (row >> 3)) * 512 + (row & 7) * 64 + ((((col >> 3) & 7) ^ (row & 7)) << 3) +
         (col & 7);
}

// Element (j, col) of the A-tile: padded rows of stride as, or swizzled.
template <bool kSwz>
__device__ __forceinline__ int a_index(int j, int col, int as) {
  if constexpr (kSwz) {
    return swz_index(j, col, kTileRows / 8);
  } else {
    return j * as + col;
  }
}

// A table row's V bf16 as loaded, converted when added.
template <int V>
using Raw = std::conditional_t<V == 8, uint4, __nv_bfloat16>;

template <int V>
__device__ __forceinline__ Raw<V> load_raw(const __nv_bfloat16* __restrict__ p) {
  if constexpr (V == 8) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    return p[0];
  }
}

template <int V>
__device__ __forceinline__ Raw<V> zero_raw() {
  if constexpr (V == 8) {
    return make_uint4(0u, 0u, 0u, 0u);
  } else {
    return __float2bfloat16(0.f);
  }
}

template <int V>
__device__ __forceinline__ void add_raw(float* acc, const Raw<V>& x) {
  if constexpr (V == 8) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      acc[2 * j] += f.x;
      acc[2 * j + 1] += f.y;
    }
  } else {
    acc[0] += __bfloat162float(x);
  }
}

// The means of features [k0, k0 + kw) of rows of more than kDirectSlots
// slots, from the partial-sum kernel's chunks, added in a fixed order (the
// result does not depend on scheduling), into the A-tile's columns
// [kw, 2 kw).  Up to kFewChunks chunks a row: a thread a (row, 8
// features), its chunks in order, all the tile's rows at once.  More (the
// hub's rows): for each of the tile's rows the whole block adds them,
// thread (cg, seg) the chunks cg, cg + ncg, ... of 8 features, then ncg
// partials in order.  s_red: kThreads * 8 floats, then kThreads ints.
template <bool kSwz>
__device__ __forceinline__ void finish_partials(const LayerArgs& a, int r0, int k0, int kw, __nv_bfloat16* s_a,
                                                int as, float* s_red) {
  const int segs = kw / 8;
  if (a.nchunks <= kFewChunks) {
    for (int i = threadIdx.x; i < kTileRows * segs; i += kThreads) {
      const int j = i / segs;
      const int sg = i - j * segs;
      if (r0 + j >= a.k) continue;
      float t[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) t[v] = 0.f;
      int n = 0;
#pragma unroll 4
      for (int ch = 0; ch < a.nchunks; ++ch) {
        const long long item = static_cast<long long>(r0 + j) * a.nchunks + ch;
        const float4* p = reinterpret_cast<const float4*>(a.part + item * a.f_in + k0 + sg * 8);
        const float4 x0 = __ldg(p);
        const float4 x1 = __ldg(p + 1);
        t[0] += x0.x, t[1] += x0.y, t[2] += x0.z, t[3] += x0.w;
        t[4] += x1.x, t[5] += x1.y, t[6] += x1.z, t[7] += x1.w;
        n += __ldg(a.part_cnt + item);
      }
      const float nf = static_cast<float>(n > 1 ? n : 1);
#pragma unroll
      for (int v = 0; v < 8; ++v) t[v] = t[v] / nf;
      store_row<8>(s_a + a_index<kSwz>(j, kw + sg * 8, as), t);
    }
    return;
  }
  const int ncg = kThreads / segs;
  const int seg = threadIdx.x % segs;
  const int cg = threadIdx.x / segs;
  int* s_n = reinterpret_cast<int*>(s_red + kThreads * 8);
  for (int j = 0; j < kTileRows && r0 + j < a.k; ++j) {
    const long long row = r0 + j;
    if (cg < ncg) {
      float s[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) s[v] = 0.f;
      int n = 0;
#pragma unroll 4
      for (int ch = cg; ch < a.nchunks; ch += ncg) {
        const long long item = row * a.nchunks + ch;
        const float4* p = reinterpret_cast<const float4*>(a.part + item * a.f_in + k0 + seg * 8);
        const float4 x0 = __ldg(p);
        const float4 x1 = __ldg(p + 1);
        s[0] += x0.x, s[1] += x0.y, s[2] += x0.z, s[3] += x0.w;
        s[4] += x1.x, s[5] += x1.y, s[6] += x1.z, s[7] += x1.w;
        n += __ldg(a.part_cnt + item);
      }
#pragma unroll
      for (int v = 0; v < 8; ++v) s_red[cg * kw + seg * 8 + v] = s[v];
      if (seg == 0) s_n[cg] = n;
    }
    __syncthreads();
    if (threadIdx.x < segs) {
      float t[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) t[v] = 0.f;
      int n = 0;
      for (int c = 0; c < ncg; ++c) {
#pragma unroll
        for (int v = 0; v < 8; ++v) t[v] += s_red[c * kw + threadIdx.x * 8 + v];
        n += s_n[c];
      }
      const float nf = static_cast<float>(n > 1 ? n : 1);
#pragma unroll
      for (int v = 0; v < 8; ++v) t[v] = t[v] / nf;
      store_row<8>(s_a + a_index<kSwz>(j, kw + threadIdx.x * 8, as), t);
    }
    __syncthreads();
  }
}

// The means of features [k0, k0 + kw) of a tile's rows of up to
// kDirectSlots slots, into the A-tile's columns [kw, 2 kw), a lane group
// gathering its rows: the group's (row, slot) pairs, flat, pair t slot
// t % d of its row t / d.  Each lane stages one pair's id (-1: not valid)
// a chunk of `lanes` pairs, the next chunk's while this one's rows load;
// the group's lanes then read kB rows at once, the ids by shuffles,
// the next batch's rows prefetched to L2.  kD > 0 (a power of two, with
// lanes % kB == 0) fixes where rows end within a batch at compile
// time, so a row's mean is written once with no test a pair; kD == 0
// takes any D.  self_rows runs once the first ids are on their way.  kB:
// the rows in flight a lane (kBatch, or fewer where other live registers
// crowd the gather).
template <int V, bool kSwz, int kD, int kB, typename SelfRows>
__device__ __forceinline__ void gather_direct(const LayerArgs& a, int r0, int k0, int kw, __nv_bfloat16* s_a, int as,
                                              int lanes, int groups, int g, int li, int j0, int nr,
                                              SelfRows&& self_rows) {
  const int d = kD > 0 ? kD : a.d;
  const int items = nr * d;
  const int max_items = ((kRowsPerWarp + groups - 1) / groups) * d;  // the same for every group
  const __nv_bfloat16* table = a.table + k0;
  for (int fb = 0; fb < kw; fb += lanes * V) {
    const int feat = fb + li * V;
    const bool active = feat < kw;
    auto stage = [&](int tc) -> int {
      const int t = tc + li;
      if (t >= items) return -1;
      const int q = t / d;
      const int row = r0 + j0 + q * groups;
      if (row >= a.k) return -1;
      const long long off = static_cast<long long>(row) * d + (t - q * d);
      const int id = __ldg(a.nbrs + off);
      const bool ok = __ldg(a.valid + off) != 0;
      return ok ? static_cast<int>(gather_row(id, a.c)) : -1;
    };
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    int cnt = 0;
    auto write_mean = [&](int q) {  // row q's mean, then the sums reset
      const float inv = __frcp_rn(static_cast<float>(cnt > 1 ? cnt : 1));
      float m[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        m[v] = acc[v] * inv;
        acc[v] = 0.f;
      }
      cnt = 0;
      if (active && q < nr) store_row<V>(s_a + a_index<kSwz>(j0 + q * groups, kw + feat, as), m);
    };
    int cur = 0, tq = 0, ts = 0;  // kD == 0: the row being summed, the next pair's row and slot
    int staged_next = stage(0);
    if (fb == 0) self_rows();
    for (int tc = 0; tc < max_items; tc += lanes) {
      const int staged = staged_next;
      staged_next = stage(tc + lanes);
      for (int u0 = 0; u0 < lanes; u0 += kB) {
        int id[kB];
        Raw<V> x[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          id[u] = __shfl_sync(kFull, staged, (u0 + u) & (lanes - 1), lanes);
          if (u0 + u >= lanes || tc + u0 + u >= items) id[u] = -2;  // past the group's pairs
          x[u] = id[u] >= 0 && active ? load_raw<V>(table + static_cast<long long>(id[u]) * a.f_in + feat)
                                      : zero_raw<V>();
        }
        if (u0 + kB < lanes) {  // the chunk's next batch of rows on their way to L2
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            const int pid = __shfl_sync(kFull, staged, (u0 + kB + u) & (lanes - 1), lanes);
            if (pid >= 0 && active && tc + u0 + kB + u < items)
              prefetch_l2(table + static_cast<long long>(pid) * a.f_in + feat);
          }
        }
        if constexpr (kD > 0 && kD <= kB) {
          const int q0 = (tc + u0) / kD;
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            add_raw<V>(acc, x[u]);
            cnt += id[u] >= 0 ? 1 : 0;
            if (u % kD == kD - 1) write_mean(q0 + u / kD);
          }
        } else if constexpr (kD > kB) {
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            add_raw<V>(acc, x[u]);
            cnt += id[u] >= 0 ? 1 : 0;
          }
          if (((tc + u0 + kB) & (kD - 1)) == 0) write_mean((tc + u0) / kD);
        } else {
#pragma unroll
          for (int u = 0; u < kB; ++u) {
            if (id[u] == -2) continue;
            if (tq != cur) {
              write_mean(cur);
              cur = tq;
            }
            add_raw<V>(acc, x[u]);
            cnt += id[u] >= 0 ? 1 : 0;
            if (++ts == d) {
              ts = 0;
              ++tq;
            }
          }
        }
      }
    }
    if constexpr (kD == 0) {
      if (items > 0) {
        write_mean(cur);
      } else {
        for (cur = 0; cur < nr; ++cur) write_mean(cur);  // rows of no slot: mean 0
      }
    }
  }
}

// Features [k0, k0 + kw) of the tile's A rows [x_self | mean] into shared
// memory, columns [0, kw) and [kw, 2 kw) (kSelfOnly: the self columns
// alone).  The self rows go by 16-byte cp.async, left in flight.  Rows
// past k get undefined values; their outputs are not stored.  Inlined, so
// that a wgmma issued before it stays in flight.  kB: as gather_direct's.
template <int V, bool kSwz, bool kSelfOnly = false, int kB = kBatch>
__device__ __forceinline__ void gather_tile(const LayerArgs& a, int r0, int k0, int kw, __nv_bfloat16* s_a, int as,
                                            float* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int segs = (kw + V - 1) / V;
  int lanes = 1;
  while (lanes < segs && lanes < 32) lanes <<= 1;
  const int groups = 32 / lanes;
  const int g = lane / lanes;
  const int li = lane % lanes;
  const int j0 = warp * kRowsPerWarp + g;  // the group's first tile row
  const int nr = g < kRowsPerWarp ? (kRowsPerWarp - g + groups - 1) / groups : 0;
  // the block's next tile's keys, ids and flags on their way to L2
  const int next = r0 + gridDim.x * kTileRows;
  if (k0 == 0 && next < a.k) {
    const long long rows = (a.k - next < kTileRows ? a.k - next : kTileRows);
    const long long slots = a.nchunks > 0 ? 0 : rows * a.d;
    prefetch_range(a.keys + next, rows * 4);
    prefetch_range(a.nbrs + static_cast<long long>(next) * a.d, slots * 4);
    prefetch_range(a.valid + static_cast<long long>(next) * a.d, slots);
  }
  // the self rows, straight into the tile: the warp's 8 keys one a lane,
  // then each group copies its rows
  auto self_rows = [&]() {
    const int krow = r0 + warp * kRowsPerWarp + (lane & (kRowsPerWarp - 1));
    const long long key_id = krow < a.k ? gather_row(__ldg(a.keys + krow), a.c) : 0;
    for (int fb = 0; fb < kw; fb += lanes * V) {
      const int feat = fb + li * V;
#pragma unroll
      for (int jj = 0; jj < kRowsPerWarp; ++jj) {
        const long long id = __shfl_sync(kFull, key_id, jj);
        const int j = warp * kRowsPerWarp + jj;
        if (jj % groups != g || r0 + j >= a.k || feat >= kw) continue;
        const __nv_bfloat16* src = a.table + id * a.f_in + k0 + feat;
        __nv_bfloat16* dst = s_a + a_index<kSwz>(j, feat, as);
        if constexpr (V == 8) {
          cp_async16(dst, src);
        } else {
          *dst = src[0];
        }
      }
    }
  };
  if constexpr (kSelfOnly) {
    self_rows();
    return;
  }
  if (a.nchunks > 0) {
    self_rows();
    if constexpr (V == 8) finish_partials<kSwz>(a, r0, k0, kw, s_a, as, s_red);
    if constexpr (V == 1) {
      // narrow tables: a group a row, its chunks in order
      for (int q = 0; q < nr; ++q) {
        const int row = r0 + j0 + q * groups;
        for (int feat = li; feat < kw; feat += lanes) {
          float s = 0.f;
          int n = 0;
          for (int ch = 0; row < a.k && ch < a.nchunks; ++ch) {
            const long long item = static_cast<long long>(row) * a.nchunks + ch;
            s += __ldg(a.part + item * a.f_in + k0 + feat);
            n += __ldg(a.part_cnt + item);
          }
          s = s / static_cast<float>(n > 1 ? n : 1);
          store_row<1>(s_a + a_index<kSwz>(j0 + q * groups, kw + feat, as), &s);
        }
      }
    }
    return;
  }
  if (lanes % kB == 0) {
    switch (a.d) {
      case 1: return gather_direct<V, kSwz, 1, kB>(a, r0, k0, kw, s_a, as, lanes, groups, g, li, j0, nr, self_rows);
      case 2: return gather_direct<V, kSwz, 2, kB>(a, r0, k0, kw, s_a, as, lanes, groups, g, li, j0, nr, self_rows);
      case 4: return gather_direct<V, kSwz, 4, kB>(a, r0, k0, kw, s_a, as, lanes, groups, g, li, j0, nr, self_rows);
      case 8: return gather_direct<V, kSwz, 8, kB>(a, r0, k0, kw, s_a, as, lanes, groups, g, li, j0, nr, self_rows);
      case 16: return gather_direct<V, kSwz, 16, kB>(a, r0, k0, kw, s_a, as, lanes, groups, g, li, j0, nr, self_rows);
      case 32: return gather_direct<V, kSwz, 32, kB>(a, r0, k0, kw, s_a, as, lanes, groups, g, li, j0, nr, self_rows);
      default: break;
    }
  }
  gather_direct<V, kSwz, 0, kB>(a, r0, k0, kw, s_a, as, lanes, groups, g, li, j0, nr, self_rows);
}

// Element (k, n) of W's 128-byte-swizzled N-major tile for wgmma's B:
// atoms of 8 rows (k) x 64 columns (n), those of a 64-column slice one
// after another down the rows (row_groups: the tile's rows / 8).
__device__ __forceinline__ int w_index(int k, int n, int row_groups) {
  return ((n >> 6) * row_groups + (k >> 3)) * 512 + (k & 7) * 64 + ((((n >> 3) & 7) ^ (k & 7)) << 3) + (n & 7);
}

// W's rows of K chunk [k0, k0 + kw) (its W_self rows, then its W_nbr
// rows: 2 kw tile rows, as the A-tile's columns) and columns [n0, n0 +
// ncols) into wgmma's swizzled tile, 16 B copies; with the chunk at k0 = 0
// the n-tile's bias in f32, 0 past ncols up to the 64-column round.
__device__ __forceinline__ void load_w(const LayerArgs& a, int k0, int kw, int n0, int ncols, __nv_bfloat16* s_w,
                                       float* s_bias) {
  const int per_row = ncols / 8;
  const int rows = 2 * kw;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c8 = (i - r * per_row) * 8;
    const long long src = r < kw ? k0 + r : a.f_in + k0 + (r - kw);
    cp_async16(s_w + w_index(r, c8, rows / 8), a.w + src * a.f_out + n0 + c8);
  }
  if (k0 == 0)
    for (int i = threadIdx.x; i < (ncols + 63) / 64 * 64; i += kThreads)
      s_bias[i] = i < ncols ? __bfloat162float(a.bias[n0 + i]) : 0.f;
}

__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// A wgmma descriptor of a 128-byte-swizzled operand at p: lbo and sbo
// in bytes (K-major: sbo between 8-row groups, lbo unused; N-major: sbo
// between 8-row groups along K, lbo between 64-column atoms).
__device__ __forceinline__ uint64_t swz_desc(const void* p, unsigned lbo, unsigned sbo) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_64x64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// wgmma: a K chunk of kw features of the tile's product for an n-tile of
// ncols columns: warpgroup wg computes the tile's 64 rows by the n-tile's
// columns wg*64.. as ksteps m64n64k16 steps along the chunk's 2 kw A
// columns (all 2 kw / 16 of them, or only the self half's where the mean
// half is all zeros), A (K-major) and W (N-major, B transposed) from the
// swizzled shared tiles, into d (overwritten where first, else added to);
// nothing for a warpgroup past ncols.  d: (row 16 w + l / 4, columns 8 i +
// 2 (l % 4) + {0, 1}) in d[4 i], d[4 i + 1], row + 8 in d[4 i + 2],
// d[4 i + 3], for warp w and lane l of the warpgroup.
__device__ __forceinline__ void wgmma_tile(int kw, int ksteps, int ncols, const __nv_bfloat16* s_a,
                                           const __nv_bfloat16* s_w, float (&d)[32], bool first) {
  const int wg = threadIdx.x >> 7;
  if (wg * 64 >= ncols) return;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
  const int row_groups = 2 * kw / 8;
  const unsigned w_atoms = row_groups * 1024;  // bytes between W's 64-column slices
  for (int ks = 0; ks < ksteps; ++ks) {
    wgmma_64x64(d, swz_desc(s_a + (ks >> 2) * (kTileRows / 8) * 512 + (ks & 3) * 16, 16, 1024),
                swz_desc(s_w + (wg * row_groups + 2 * ks) * 512, w_atoms, 1024), !first || ks > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma's results with bias (s_bias, f32, the n-tile's) and ReLU in f32,
// rounded once, into a shared tile of row stride os (a warpgroup past
// ncols writes nothing).
__device__ __forceinline__ void wgmma_stage(const float* s_bias, const float (&d)[32], int ncols, __nv_bfloat16* s_o,
                                            int os) {
  if ((threadIdx.x >> 7) * 64 >= ncols) return;
  const int lane = threadIdx.x & 31;
  const int row = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int col0 = (threadIdx.x >> 7) * 64 + 2 * (lane & 3);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int col = col0 + 8 * i;
    const float b0 = s_bias[col];
    const float b1 = s_bias[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(s_o + (row + 8 * h) * os + col) =
          pack_bf16x2(fmaxf(d[4 * i + 2 * h] + b0, 0.f), fmaxf(d[4 * i + 2 * h + 1] + b1, 0.f));
  }
}

// A staged tile's rows to the output: consecutive threads take
// consecutive 16-byte pieces of a row, so a warp writes whole rows.
__device__ __forceinline__ void copy_out(const LayerArgs& a, int r0, int n0, int ncols, const __nv_bfloat16* s_o,
                                         int os) {
  const int per_row = ncols / 8;
  for (int i = threadIdx.x; i < kTileRows * per_row; i += kThreads) {
    const int r = i / per_row;
    const int c8 = (i - r * per_row) * 8;
    if (r0 + r < a.k)
      *reinterpret_cast<uint4*>(a.out + static_cast<long long>(r0 + r) * a.f_out + n0 + c8) =
          *reinterpret_cast<const uint4*>(s_o + r * os + c8);
  }
}

// The CUDA cores: a K chunk of kw features of the tile's product for an
// n-tile of ncols (<= kMaxCols) columns, added to acc (D = 0: the self
// half alone, the mean half being all zeros).  Thread t takes column t %
// kMaxCols and rows t / kMaxCols + 2 j (acc[j]); W's entries are read
// once a thread through the cache, the A-tile's by broadcasts.
__device__ __forceinline__ void dot_tile(const LayerArgs& a, int k0, int kw, int n0, int ncols,
                                         const __nv_bfloat16* s_a, int as, float (&acc)[32]) {
  const int col = threadIdx.x % kMaxCols;
  if (col >= ncols) return;
  const __nv_bfloat16* arow = s_a + (threadIdx.x / kMaxCols) * as;
  const __nv_bfloat16* wcol = a.w + n0 + col;
  const int xs = a.d == 0 ? kw : 2 * kw;
  for (int x = 0; x < xs; ++x) {
    const long long wr = x < kw ? k0 + x : a.f_in + k0 + (x - kw);
    const float wv = __bfloat162float(__ldg(wcol + wr * a.f_out));
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += __bfloat162float(arow[2 * j * as + x]) * wv;
  }
}

// The CUDA cores' results with bias and ReLU in f32, rounded once, to the
// output (a warp writes 32 columns of a row).
__device__ __forceinline__ void dot_store(const LayerArgs& a, int r0, int n0, int ncols, const float (&acc)[32]) {
  const int col = threadIdx.x % kMaxCols;
  if (col >= ncols) return;
  const float b = __bfloat162float(a.bias[n0 + col]);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int r = r0 + threadIdx.x / kMaxCols + 2 * j;
    if (r < a.k) a.out[static_cast<long long>(r) * a.f_out + n0 + col] = __float2bfloat16(fmaxf(acc[j] + b, 0.f));
  }
}

constexpr size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

// The shared memory of an instantiation for K chunks of kc features and
// n-tiles of nt columns, in bytes from a base (1024-aligned for wgmma's
// swizzled tiles): the A-tile, bf16 [64, 2 kc] (wgmma: its columns
// rounded up to 64; CUDA cores: rows padded by kPad); wgmma: W's tile,
// bf16 [2 kc, nt rounded up to 64], and the staged output, bf16 [64, that
// + kPad], in the A-tile's memory unless one K chunk is kept over several
// n-tiles; the partial sums' scratch (kThreads * 8 floats, kThreads
// ints); wgmma: the n-tile's bias in f32.  total: with the base's
// alignment.
struct Plan {
  int kc, nt;
  size_t w_off, o_off, red_off, bias_off, total;
};

Plan plan_layer(int mode, int f_in, int f_out, int kc, int nt) {
  Plan p{kc, nt, 0, 0, 0, 0, 0};
  size_t o = 0;
  if (mode == kWgmma) {
    const size_t ntp = round_up(nt, 64);
    const size_t stage = kTileRows * (ntp + kPad) * 2;
    const bool kept = kc >= f_in && f_out > nt;
    size_t a_bytes = kTileRows * round_up(2 * kc, 64) * 2;
    if (!kept && stage > a_bytes) a_bytes = stage;
    p.w_off = round_up(a_bytes, 1024);
    o = p.w_off + 2 * kc * ntp * 2;
    p.o_off = kept ? o : 0;
    o += kept ? stage : 0;
    p.red_off = round_up(o, 16);
    p.bias_off = p.red_off + kThreads * 9 * 4;
    p.total = p.bias_off + ntp * 4 + 1024;
  } else {
    p.red_off = round_up(static_cast<size_t>(kTileRows) * (2 * kc + kPad) * 2, 16);
    p.bias_off = p.red_off + kThreads * 9 * 4;
    p.total = p.bias_off;
  }
  return p;
}

// Persistent blocks walk the bucket's 64-row tiles; a tile's n-tiles, and
// for each its K chunks (kChunked; its own instantiation, so that the
// accumulators held across a chunk's gather cost the one-chunk kernel no
// registers).  One K chunk: the A-tile gathered once a tile (and, with one
// n-tile, W resident for the whole block).
template <int V, int kMode, bool kChunked>
__global__ void __launch_bounds__(kThreads, 2) sage_layer_kernel(LayerArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kSwz = kMode == kWgmma;
  unsigned char* base = smem;
  if constexpr (kSwz) base += (1024 - (static_cast<unsigned>(__cvta_generic_to_shared(smem)) & 1023)) & 1023;
  const int as = 2 * a.kc + (kSwz ? 0 : kPad);
  const int os = (a.nt + 63) / 64 * 64 + kPad;  // the staged output's row stride
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* s_w = reinterpret_cast<__nv_bfloat16*>(base + a.w_off);
  __nv_bfloat16* s_o = reinterpret_cast<__nv_bfloat16*>(base + a.o_off);
  float* s_red = reinterpret_cast<float*>(base + a.red_off);
  float* s_bias = reinterpret_cast<float*>(base + a.bias_off);
  const int tiles = (a.k + kTileRows - 1) / kTileRows;
  const bool resident = kSwz && !kChunked && a.f_out <= a.nt;
  if (resident) load_w(a, 0, a.f_in, 0, a.f_out, s_w, s_bias);
  // a K chunk's product, once its A-tile is gathered (W's tile loaded
  // here unless resident); afterwards both may be written again
  auto chunk = [&](int k0, int kw, int n0, int ncols, float(&acc)[32], bool first) {
    if constexpr (kSwz) {
      if (!resident) load_w(a, k0, kw, n0, ncols, s_w, s_bias);
    }
    cp_async_wait_all();
    if constexpr (kSwz) fence_proxy_async();
    __syncthreads();
    if constexpr (kSwz) {
      // D = 0 (the training contexts): the mean half is all zeros, so only
      // the self half's steps (its last one may reach 8 zero mean columns)
      wgmma_tile(kw, a.d == 0 ? (kw + 15) / 16 : 2 * kw / 16, ncols, s_a, s_w, acc, first);
    } else {
      if (first)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      dot_tile(a, k0, kw, n0, ncols, s_a, as, acc);
    }
    __syncthreads();
  };
  auto epilogue = [&](int r0, int n0, int ncols, const float(&acc)[32]) {
    if constexpr (kSwz) {
      wgmma_stage(s_bias, acc, ncols, s_o, os);
      __syncthreads();
      copy_out(a, r0, n0, ncols, s_o, os);
    } else {
      dot_store(a, r0, n0, ncols, acc);
    }
    __syncthreads();
  };
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * kTileRows;
    if constexpr (!kChunked) {
      gather_tile<V, kSwz>(a, r0, 0, a.f_in, s_a, as, s_red);
      for (int n0 = 0; n0 < a.f_out; n0 += a.nt) {
        const int ncols = a.f_out - n0 < a.nt ? a.f_out - n0 : a.nt;
        float acc[32];
        chunk(0, a.f_in, n0, ncols, acc, true);
        epilogue(r0, n0, ncols, acc);
      }
    } else {
      for (int n0 = 0; n0 < a.f_out; n0 += a.nt) {
        const int ncols = a.f_out - n0 < a.nt ? a.f_out - n0 : a.nt;
        float acc[32];
        for (int k0 = 0; k0 < a.f_in; k0 += a.kc) {
          const int kw = a.f_in - k0 < a.kc ? a.f_in - k0 : a.kc;
          gather_tile<V, kSwz>(a, r0, k0, kw, s_a, as, s_red);
          chunk(k0, kw, n0, ncols, acc, k0 == 0);
        }
        epilogue(r0, n0, ncols, acc);
      }
    }
  }
}

// One warp a (row, chunk): the chunk's f32 neighbor sum and valid count.
template <int V>
__global__ void __launch_bounds__(kThreads)
sage_partial_kernel(const __nv_bfloat16* __restrict__ table, int c, int f, const int* __restrict__ nbrs,
                    const uint8_t* __restrict__ valid, int k, int d, int chunk, int nchunks,
                    float* __restrict__ part, int* __restrict__ part_cnt) {
  const int lane = threadIdx.x & 31;
  const long long item = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (item >= static_cast<long long>(k) * nchunks) return;
  const int row = static_cast<int>(item / nchunks);
  const int ch = static_cast<int>(item % nchunks);
  const int per = (f + V - 1) / V;
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
    float* prow = part + item * f + feat;
#pragma unroll
    for (int j = 0; j < V; ++j) prow[j] = acc[j];
    if (feat == 0) part_cnt[item] = cnt;
  }
}

template <int V, int kMode, bool kChunked>
cudaError_t launch_layer(LayerArgs a, const Plan& p, cudaStream_t s) {
  if (p.total > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  a.kc = p.kc;
  a.nt = p.nt;
  a.w_off = static_cast<int>(p.w_off);
  a.o_off = static_cast<int>(p.o_off);
  a.red_off = static_cast<int>(p.red_off);
  a.bias_off = static_cast<int>(p.bias_off);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  auto kernel = sage_layer_kernel<V, kMode, kChunked>;
  // per instantiation and device: the shared memory granted, the SM count,
  // and the blocks an SM holds at the shared memory last asked for
  static size_t granted[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  static size_t occ_smem[kMaxDevices] = {};
  static int occ[kMaxDevices] = {};
  if (p.total > granted[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(p.total));
    if (err != cudaSuccess) return err;
    granted[dev] = p.total;
  }
  if (sms[dev] == 0 && (err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if (occ[dev] == 0 || occ_smem[dev] != p.total) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[dev], kernel, kThreads, p.total);
    if (err != cudaSuccess) return err;
    if (occ[dev] < 1) return cudaErrorInvalidConfiguration;
    occ_smem[dev] = p.total;
  }
  const long long tiles = (a.k + kTileRows - 1) / kTileRows;
  const long long cap = static_cast<long long>(occ[dev]) * sms[dev];
  const unsigned grid = static_cast<unsigned>(tiles < cap ? tiles : cap);
  kernel<<<grid, kThreads, p.total, s>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A bucket's gather arguments into a, after launching the partial-sum
// kernel where rows pass kDirectSlots (nchunks > 0).
cudaError_t start_gather(LayerArgs& a, const void* table, int c, int f_in, const void* keys, const void* nbrs,
                         const void* valid, int k, int d, int chunk, int nchunks, void* part, void* part_cnt, bool vec,
                         cudaStream_t s) {
  a.table = static_cast<const __nv_bfloat16*>(table);
  a.c = c;
  a.f_in = f_in;
  a.keys = static_cast<const int*>(keys);
  a.nbrs = static_cast<const int*>(nbrs);
  a.valid = static_cast<const uint8_t*>(valid);
  a.k = k;
  a.d = d;
  a.part = static_cast<const float*>(part);
  a.part_cnt = static_cast<const int*>(part_cnt);
  a.nchunks = nchunks;
  if (nchunks == 0) return cudaSuccess;
  const long long items = static_cast<long long>(k) * nchunks;
  const unsigned blocks = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  if (vec) {
    sage_partial_kernel<8><<<blocks, kThreads, 0, s>>>(a.table, c, f_in, a.nbrs, a.valid, k, d, chunk, nchunks,
                                                        static_cast<float*>(part), static_cast<int*>(part_cnt));
  } else {
    sage_partial_kernel<1><<<blocks, kThreads, 0, s>>>(a.table, c, f_in, a.nbrs, a.valid, k, d, chunk, nchunks,
                                                        static_cast<float*>(part), static_cast<int*>(part_cnt));
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The layer's weight gradient (sage_layer_backward).  For one bucket:
// dw += [x_self | mean]^T . dH and db += sum_rows dH, dH = dz * [z > 0],
// from the bf16 output z and its bf16 gradient dz (dH is exact in bf16:
// dz or 0).  The A rows are rebuilt by the forward's gather (gather_tile;
// rows of more than 32 slots from sage_partial_kernel's chunks), so the
// gradient is taken at the very A the forward multiplied.  Persistent
// blocks walk the row tiles and keep a partial of dw in f32 registers;
// each block writes its partial to scratch and sage_backward_reduce_kernel
// adds the blocks' partials in block order, so dw is the same bit for bit
// from run to run (atomics would not be).
//
// Bound on the H100 (bytes), for a uniform pane's buckets of the GraphSAGE
// main path (~1.03M keys, F = 128): the ids and flags, each distinct table
// row once, z and dz (2 F_out B a row each), dw and db: about 0.82 GB,
// 0.245 ms at 3.35 TB/s; the product (2 * K * 2 F_in * F_out, 67 GFLOP)
// takes 0.068 ms at the dense bf16 rate (at least 1 ms on the f32 CUDA
// cores).  The contexts (D = 0, 2K rows a step) read a self row, z and dz
// a row; their product is the self half's alone.
//
// Design (F_in and F_out multiples of 8, 16-byte aligned operands:
// sage_backward_wgmma_kernel).  The product on the tensor cores, for each
// 64-row tile: dW^T [F_out, 2 F_in] += dH^T . A.  wgmma's A operand is dH^T
// (bf16, K-major: a dw column's 64 tile rows contiguous, written
// transposed into a 128-byte-swizzled tile); its B operand is the gathered
// [x_self | mean] tile read N-major (features contiguous): the gather
// writes the forward's swizzled 16-byte pieces, which is the layout of the
// forward's N-major W tile.  One m64n256k16 step a warpgroup covers
// [x_self | mean] at F_in = 128; the two warpgroups take 64 dw columns
// each: 128 f32 accumulators a thread, one block an SM.
//   Overlap.  Stages of (A-tile, dH^T tile, raw z and dz rows) in shared
//   memory.  A tile's wgmma steps are committed and left in flight while
//   the block gathers the next tile's means into another stage; the block
//   waits for them only before its barrier ahead of the next issue.  z and
//   dz go by cp.async one tile ahead of their turn, the self rows by
//   cp.async inside the tile's gather (their keys' loads overlap the first
//   ids'), so the means' gather is the one latency left on a tile's path.
//   The 128 live accumulators crowd the gather's registers: it keeps 4
//   rows in flight a lane (kBackBatch), not the forward's 8.
//   Rows past the bucket are zeroed in the A-tile, and dH^T is 0 there: a
//   persistent block's stage holds an older tile in those rows, wgmma
//   multiplies all 64, and NaN * 0 is NaN.
//   D = 0 (the contexts): the mean half is all zeros, so it is neither
//   gathered nor multiplied (N = F_in, m64n128k16, 64 accumulators), and
//   the reduce leaves dw's W_nbr rows as they were: the JAX package never
//   forms that half.  With no gather to hide them, its copies go two tiles
//   ahead.
//   Widths.  F_in past 128 walks K chunks of 128 features and F_out past
//   128 passes of 128 dw columns, the tiles gathered again for each.
//   Other widths: sage_backward_kernel, the product on the CUDA cores (a
//   thread 16 rows x 8 columns of a [256, 128] partial, 248 registers, one
//   block an SM).

constexpr int kBackChunk = 128;  // features a K chunk: dw tiles of 2 * 128 rows
constexpr int kBackCols = 128;   // dw columns a tile
constexpr int kBackMaxBlocksPerSm = 2;  // the scratch's sizing: at most this many blocks an SM
constexpr int kBackAs = 2 * kBackChunk + kPad;  // the A-tile's row stride (bf16)
constexpr int kBackHs = kBackCols + 4;         // dH's row stride (f32)

struct BackArgs {
  const __nv_bfloat16* z;   // [k, f_out]
  const __nv_bfloat16* dz;  // [k, f_out]
  int f_out;
  float* part_dw;  // [grid, 2 f_in, f_out]
  float* part_db;  // [grid, f_out]
};

// shared memory: the A-tile (bf16 [64, kBackAs]), dH (f32 [64, kBackHs]),
// the partial sums' scratch (kThreads * 8 floats, kThreads ints)
constexpr size_t kBackHOff = round_up(static_cast<size_t>(kTileRows) * kBackAs * 2, 16);
constexpr size_t kBackSmem =
    kBackHOff + static_cast<size_t>(kTileRows) * kBackHs * 4 + static_cast<size_t>(kThreads) * 9 * 4;

// The tile's dH = dz * [z > 0] in f32, columns [n0, n0 + ncols) into s_h
// (0 past ncols); rows past the bucket are not read.  kVec: 16-byte loads
// (f_out a multiple of 8, z and dz 16-byte aligned).
template <bool kVec>
__device__ __forceinline__ void load_dh(const BackArgs& b, int r0, int rows, int n0, int ncols, float* s_h) {
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < kTileRows * (kBackCols / 8); i += kThreads) {
      const int r = i / (kBackCols / 8);
      const int c8 = (i - r * (kBackCols / 8)) * 8;
      if (r >= rows) continue;
      float h[8];
      if (c8 < ncols) {
        const long long off = static_cast<long long>(r0 + r) * b.f_out + n0 + c8;
        const uint4 zr = __ldg(reinterpret_cast<const uint4*>(b.z + off));
        const uint4 dr = __ldg(reinterpret_cast<const uint4*>(b.dz + off));
        const __nv_bfloat16* zh = reinterpret_cast<const __nv_bfloat16*>(&zr);
        const __nv_bfloat16* dh = reinterpret_cast<const __nv_bfloat16*>(&dr);
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = __bfloat162float(zh[j]) > 0.f ? __bfloat162float(dh[j]) : 0.f;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(s_h + r * kBackHs + c8);
      dst[0] = make_float4(h[0], h[1], h[2], h[3]);
      dst[1] = make_float4(h[4], h[5], h[6], h[7]);
    }
  } else {
    for (int i = threadIdx.x; i < kTileRows * kBackCols; i += kThreads) {
      const int r = i / kBackCols;
      const int c = i - r * kBackCols;
      if (r >= rows) continue;
      float h = 0.f;
      if (c < ncols) {
        const long long off = static_cast<long long>(r0 + r) * b.f_out + n0 + c;
        h = __bfloat162float(b.z[off]) > 0.f ? __bfloat162float(b.dz[off]) : 0.f;
      }
      s_h[r * kBackHs + c] = h;
    }
  }
}

// Persistent blocks walk the bucket's 64-row tiles, for each dw tile (K
// chunk k0 of kBackChunk features: the A-tile's self columns [0, kw) and
// mean columns [kw, 2 kw) are dw rows k0.. and f_in + k0..; n-tile n0)
// in turn, the A-tile gathered anew for each.  Thread (ty, tx) keeps dw
// tile rows 16 ty.. and columns 8 tx.. in acc, adding the tile's rows in
// order; the column sums of dH (db) are taken with the first K chunk.
template <int V, bool kVecH>
__global__ void __launch_bounds__(kThreads, 1) sage_backward_kernel(LayerArgs a, BackArgs b) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem);
  float* s_h = reinterpret_cast<float*>(smem + kBackHOff);
  float* s_red = s_h + kTileRows * kBackHs;
  const int tiles = (a.k + kTileRows - 1) / kTileRows;
  const int tx = threadIdx.x % (kBackCols / 8);
  const int ty = threadIdx.x / (kBackCols / 8);
  const int m0 = ty * 16;
  const int c0 = tx * 8;
  float* pdw = b.part_dw + static_cast<long long>(blockIdx.x) * 2 * a.f_in * b.f_out;
  for (int n0 = 0; n0 < b.f_out; n0 += kBackCols) {
    const int ncols = b.f_out - n0 < kBackCols ? b.f_out - n0 : kBackCols;
    for (int k0 = 0; k0 < a.f_in; k0 += kBackChunk) {
      const int kw = a.f_in - k0 < kBackChunk ? a.f_in - k0 : kBackChunk;
      float acc[16][8];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      float dbacc = 0.f;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int r0 = tile * kTileRows;
        const int rows = a.k - r0 < kTileRows ? a.k - r0 : kTileRows;
        gather_tile<V, false>(a, r0, k0, kw, s_a, kBackAs, s_red);
        load_dh<kVecH>(b, r0, rows, n0, ncols, s_h);
        cp_async_wait_all();
        __syncthreads();
        if (k0 == 0 && threadIdx.x < ncols)
          for (int r = 0; r < rows; ++r) dbacc += s_h[r * kBackHs + threadIdx.x];
#pragma unroll 2
        for (int r = 0; r < rows; ++r) {
          const uint4* ap = reinterpret_cast<const uint4*>(s_a + r * kBackAs + m0);
          const uint4 a0 = ap[0];
          const uint4 a1 = ap[1];
          const float4* hp = reinterpret_cast<const float4*>(s_h + r * kBackHs + c0);
          const float4 h0 = hp[0];
          const float4 h1 = hp[1];
          const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
          const __nv_bfloat162* a2[2] = {reinterpret_cast<const __nv_bfloat162*>(&a0),
                                         reinterpret_cast<const __nv_bfloat162*>(&a1)};
#pragma unroll
          for (int i2 = 0; i2 < 8; ++i2) {
            const float2 av = __bfloat1622float2(a2[i2 / 4][i2 % 4]);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              acc[2 * i2][j] = fmaf(av.x, hv[j], acc[2 * i2][j]);
              acc[2 * i2 + 1][j] = fmaf(av.y, hv[j], acc[2 * i2 + 1][j]);
            }
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int m = m0 + i;
        if (m >= 2 * kw) continue;
        const long long row = m < kw ? k0 + m : a.f_in + k0 + (m - kw);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c0 + j < ncols) pdw[row * b.f_out + n0 + c0 + j] = acc[i][j];
      }
      if (k0 == 0 && threadIdx.x < ncols)
        b.part_db[static_cast<long long>(blockIdx.x) * b.f_out + n0 + threadIdx.x] = dbacc;
    }
  }
}

// wgmma steps of m64n128k16 and m64n256k16 (bf16 in, f32 accumulators),
// A K-major and B N-major (transposed) from shared memory, D = A B + (scale_d
// ? D : 0); d's layout as wgmma_tile's, over N / 8 column groups.
__device__ __forceinline__ void wgmma_64x128_tn(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_64x256_tn(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 256) {
    wgmma_64x256_tn(d, da, db, scale_d);
  } else {
    wgmma_64x128_tn(d, da, db, scale_d);
  }
}

__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

constexpr int kBackMCols = 128;  // dw columns a pass of the tensor-core kernel: 64 a warpgroup
// rows in flight a lane of the backward's mean gather: its 128 live
// accumulators leave the gather too few registers for kBatch
constexpr int kBackBatch = 4;
constexpr int kBackHBytes = kBackMCols * kTileRows * 2;  // its dH^T tile, bf16 [128, 64]

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tensor-core kernel's shared memory (from a 1024-aligned base):
// kStages stages of the A-tile (bf16 [64, kN], swizzled; kN = wgmma's N:
// the [x_self | mean] columns, or the self columns alone), the dH^T tile
// and the raw z and dz rows (bf16 [64, kBackMCols] each, 16-byte units
// swizzled), then the partial sums' scratch (kThreads * 8 floats, kThreads
// ints; also db's 16 x 128 partial sums).  A tile's copies are issued
// kDepth tiles ahead of its turn: z and dz one tile ahead where the means
// are gathered (their gather hides the copies; the self rows go inside
// it), the self rows, z and dz two tiles ahead for the self half alone.
// 174,080 and 206,848 bytes: one block an SM.
template <bool kSelf>
struct BackPlan {
  static constexpr int kN = kSelf ? 128 : 256;
  static constexpr int kDepth = kSelf ? 2 : 1;
  static constexpr int kStages = kDepth + 1;
  static constexpr int kHOff = kTileRows * kN * 2;
  static constexpr int kROff = kHOff + kBackHBytes;
  static constexpr int kStage = kROff + 2 * kTileRows * kBackMCols * 2;
  static constexpr size_t kRedOff = static_cast<size_t>(kStages) * kStage;
  static constexpr size_t kSmem = kRedOff + static_cast<size_t>(kThreads) * 9 * 4 + 1024;
};

// 16-byte unit p of raw row r (of z, or of dz after it): the units of a
// row permuted by (r / 4) % 8, so that load_dh_t's reads of 16 rows 4
// apart land on distinct banks.
__device__ __forceinline__ int raw_unit(int r, int p) { return r * (kBackMCols / 8) + (p ^ ((r >> 2) & 7)); }

// The tile's z and dz rows, columns [n0, n0 + ncols), into the raw buffer
// s_r by 16-byte cp.async (left in flight); rows past the bucket are not
// copied.
__device__ __forceinline__ void copy_zdz(const BackArgs& b, int r0, int rows, int n0, int ncols, __nv_bfloat16* s_r) {
  const int per_row = ncols / 8;
  const int n = rows * per_row;
  for (int i = threadIdx.x; i < 2 * n; i += kThreads) {
    const int dz = i >= n ? 1 : 0;
    const int r = (i - dz * n) / per_row;
    const int p = i - dz * n - r * per_row;
    cp_async16(s_r + (dz * kTileRows * (kBackMCols / 8) + raw_unit(r, p)) * 8,
               (dz ? b.dz : b.z) + static_cast<long long>(r0 + r) * b.f_out + n0 + p * 8);
  }
}

// The tile's dH = dz * [z > 0] from the raw rows, transposed into the
// K-major dH^T tile s_h (bf16 [kBackMCols, 64]: a dw column's 64 tile rows
// in one 128-byte swizzled row); 0 past ncols and past the bucket's rows.
// Thread t takes rows 4 (t % 16).. and columns 8 (t / 16)..: 16 B of z and
// of dz a row, then each column's 4 rows as one 8-byte piece (a
// half-warp's 16 pieces on distinct banks).  With_db: the thread's column
// sums, its rows in order, added to dbs.
__device__ __forceinline__ void load_dh_t(const __nv_bfloat16* s_r, int rows, int ncols, __nv_bfloat16* s_h,
                                          float (&dbs)[8], bool with_db) {
  const int rq = threadIdx.x & 15;
  const int cb = threadIdx.x >> 4;
  uint4 zr[4], dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rq + i;
    if (r < rows && cb * 8 < ncols) {
      const int u = raw_unit(r, cb);
      zr[i] = *reinterpret_cast<const uint4*>(s_r + u * 8);
      dr[i] = *reinterpret_cast<const uint4*>(s_r + (kTileRows * (kBackMCols / 8) + u) * 8);
    } else {
      zr[i] = make_uint4(0u, 0u, 0u, 0u);
      dr[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t bits[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat16 zv = reinterpret_cast<const __nv_bfloat16*>(&zr[i])[j];
      const unsigned short dv = reinterpret_cast<const unsigned short*>(&dr[i])[j];
      bits[i] = __bfloat162float(zv) > 0.f ? dv : 0u;
      if (with_db) dbs[j] += __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits[i])));
    }
    *reinterpret_cast<uint2*>(s_h + swz_index(cb * 8 + j, 4 * rq, kBackMCols / 8)) =
        make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
  }
}

// Persistent blocks walk the bucket's 64-row tiles, for each pass (dw
// columns n0.. of a 128-column pass, K chunk k0 of kBackChunk features:
// the A-tile's self columns [0, kw) and mean columns [kw, 2 kw) are dw
// rows k0.. and f_in + k0..) in turn.  A tile's turn: its self rows and
// means gathered into its stage (its z and dz already on their way there;
// kSelf: its self rows too); its copies waited for; dH^T from the raw
// rows; the previous tile's wgmma
// waited for; then its 4 k-steps issued and committed, left in flight
// over the next tile's gather, and the copies of the tile kDepth ahead
// issued (its rows past the bucket zeroed).  Warpgroup wg holds dw^T rows (dw columns) n0 +
// 64 wg.. by the A-tile's kN columns; the column sums of dH (db) are taken
// with the first K chunk.
template <bool kSelf>
__global__ void __launch_bounds__(kThreads, 1) sage_backward_wgmma_kernel(LayerArgs a, BackArgs b) {
  using P = BackPlan<kSelf>;
  constexpr int kN = P::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (static_cast<unsigned>(__cvta_generic_to_shared(smem)) & 1023)) & 1023);
  float* s_red = reinterpret_cast<float*>(base + P::kRedOff);
  const int tiles = (a.k + kTileRows - 1) / kTileRows;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  float* pdw = b.part_dw + static_cast<long long>(blockIdx.x) * 2 * a.f_in * b.f_out;
  for (int n0 = 0; n0 < b.f_out; n0 += kBackMCols) {
    const int ncols = b.f_out - n0 < kBackMCols ? b.f_out - n0 : kBackMCols;
    const bool mma = wg * 64 < ncols;
    for (int k0 = 0; k0 < a.f_in; k0 += kBackChunk) {
      const int kw = a.f_in - k0 < kBackChunk ? a.f_in - k0 : kBackChunk;
      // the copies of the block's it-th tile of the pass, one commit group
      auto issue = [&](int it) {
        const int tile = blockIdx.x + it * gridDim.x;
        if (tile < tiles) {
          unsigned char* stage = base + (it % P::kStages) * P::kStage;
          __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(stage);
          const int r0 = tile * kTileRows;
          const int rows = a.k - r0 < kTileRows ? a.k - r0 : kTileRows;
          for (int i = threadIdx.x; i < (kTileRows - rows) * (kN / 8); i += kThreads)
            *reinterpret_cast<uint4*>(s_a + swz_index(rows + i / (kN / 8), (i % (kN / 8)) * 8, kTileRows / 8)) =
                make_uint4(0u, 0u, 0u, 0u);
          if constexpr (kSelf) gather_tile<8, true, true>(a, r0, k0, kw, s_a, 0, s_red);
          copy_zdz(b, r0, rows, n0, ncols, reinterpret_cast<__nv_bfloat16*>(stage + P::kROff));
        }
        cp_async_commit();
      };
      float acc[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
      float dbs[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) dbs[j] = 0.f;
#pragma unroll
      for (int it = 0; it < P::kDepth; ++it) issue(it);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
        unsigned char* stage = base + (it % P::kStages) * P::kStage;
        __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(stage);
        __nv_bfloat16* s_h = reinterpret_cast<__nv_bfloat16*>(stage + P::kHOff);
        const int r0 = tile * kTileRows;
        const int rows = a.k - r0 < kTileRows ? a.k - r0 : kTileRows;
        if constexpr (!kSelf) {  // the self rows by cp.async once the first ids are on their way
          gather_tile<8, true, false, kBackBatch>(a, r0, k0, kw, s_a, 0, s_red);
          cp_async_commit();
        }
        cp_async_wait<kSelf ? P::kDepth - 1 : 0>();  // this tile's copies (a later tile's may be in flight)
        __syncthreads();
        load_dh_t(reinterpret_cast<const __nv_bfloat16*>(stage + P::kROff), rows, ncols, s_h, dbs, k0 == 0);
        fence_proxy_async();
        wgmma_wait_all();  // the previous tile's steps
        __syncthreads();
        if (mma) {
          asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
          for (int ks = 0; ks < kTileRows / 16; ++ks)
            wgmma_tn<kN>(acc, swz_desc(s_h + (wg * 64) * kTileRows + ks * 16, 16, 1024),
                         swz_desc(s_a + ks * 2 * 512, kTileRows * 64 * 2, 1024), 1);
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        }
        issue(it + P::kDepth);
      }
      wgmma_wait_all();
      cp_async_wait<0>();
      if (mma) {  // acc[4 i + 2 h + e]: dw column n0 + m + 8 h, A-tile column 8 i + 2 (lane % 4) + e
        const int m = wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
        const int nmax = kSelf ? kw : 2 * kw;
#pragma unroll
        for (int i = 0; i < kN / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = 8 * i + 2 * (lane & 3) + e;
            if (n >= nmax) continue;
            float* p = pdw + (n < kw ? k0 + n : a.f_in + k0 + (n - kw)) * static_cast<long long>(b.f_out) + n0;
            if (m < ncols) p[m] = acc[4 * i + e];
            if (m + 8 < ncols) p[m + 8] = acc[4 * i + 2 + e];
          }
        }
      }
      if (k0 == 0) {  // db: the 16 row groups' column sums, added in order
        const int rq = threadIdx.x & 15;
        const int c8 = (threadIdx.x >> 4) * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) s_red[rq * kBackMCols + c8 + j] = dbs[j];
        __syncthreads();
        if (threadIdx.x < ncols) {
          float t = 0.f;
          for (int q = 0; q < 16; ++q) t += s_red[q * kBackMCols + threadIdx.x];
          b.part_db[static_cast<long long>(blockIdx.x) * b.f_out + n0 + threadIdx.x] = t;
        }
      }
      __syncthreads();
    }
  }
}

// dw[e] += the blocks' partials of element e for e < n (the partials
// stride apart), added in block order, and db likewise: a thread an
// element.
__global__ void __launch_bounds__(kThreads) sage_backward_reduce_kernel(const float* __restrict__ part_dw,
                                                                       const float* __restrict__ part_db, int blocks,
                                                                       long long stride, long long n, int f_out,
                                                                       float* dw, float* db) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e < n) {
    float s = 0.f;
    for (int g = 0; g < blocks; ++g) s += part_dw[static_cast<long long>(g) * stride + e];
    dw[e] += s;
  } else if (e < n + f_out) {
    const long long c = e - n;
    float s = 0.f;
    for (int g = 0; g < blocks; ++g) s += part_db[static_cast<long long>(g) * f_out + c];
    db[c] += s;
  }
}

// A backward kernel's blocks for k rows: one a tile, at most the blocks
// the SMs hold at once (and at most kBackMaxBlocksPerSm an SM); cache:
// the kernel's own, per device (the blocks an SM holds, 0: not asked yet;
// its shared memory is fixed) and the SM count.
struct GridCache {
  int blocks_per_sm[kMaxDevices];
  int sms[kMaxDevices];
};

cudaError_t backward_grid(GridCache& cache, const void* kernel, size_t smem, int k, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache.blocks_per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&cache.sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    cache.blocks_per_sm[dev] = occ < kBackMaxBlocksPerSm ? occ : kBackMaxBlocksPerSm;
  }
  const long long tiles = (static_cast<long long>(k) + kTileRows - 1) / kTileRows;
  const long long cap = static_cast<long long>(cache.blocks_per_sm[dev]) * cache.sms[dev];
  *grid = static_cast<int>(tiles < cap ? tiles : cap);
  return cudaSuccess;
}

// The blocks' partials of kernel (at smem bytes; into scratch of `floats`
// f32), then their sum in block order into dw (its first n_add elements:
// at D = 0 the W_nbr rows are skipped) and db.
cudaError_t launch_backward(GridCache& cache, void (*kernel)(LayerArgs, BackArgs), size_t smem, const LayerArgs& a,
                            BackArgs b, float* dw, float* db, long long floats, cudaStream_t s) {
  int grid = 0;
  cudaError_t err = backward_grid(cache, reinterpret_cast<const void*>(kernel), smem, a.k, &grid);
  if (err != cudaSuccess) return err;
  const long long n_dw = 2ll * a.f_in * b.f_out;
  if (static_cast<long long>(grid) * (n_dw + b.f_out) > floats) return cudaErrorInvalidValue;
  b.part_db = b.part_dw + static_cast<long long>(grid) * n_dw;
  kernel<<<grid, kThreads, smem, s>>>(a, b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n_add = a.d == 0 ? n_dw / 2 : n_dw;
  const long long total = n_add + b.f_out;
  sage_backward_reduce_kernel<<<static_cast<unsigned>((total + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      b.part_dw, b.part_db, grid, n_dw, n_add, b.f_out, dw, db);
  return cudaGetLastError();
}

template <int V, bool kVecH>
cudaError_t launch_backward_core(const LayerArgs& a, const BackArgs& b, float* dw, float* db, long long floats,
                                 cudaStream_t s) {
  static GridCache cache;
  return launch_backward(cache, sage_backward_kernel<V, kVecH>, kBackSmem, a, b, dw, db, floats, s);
}

template <bool kSelf>
cudaError_t launch_backward_wgmma(const LayerArgs& a, const BackArgs& b, float* dw, float* db, long long floats,
                                  cudaStream_t s) {
  static GridCache cache;
  return launch_backward(cache, sage_backward_wgmma_kernel<kSelf>, BackPlan<kSelf>::kSmem, a, b, dw, db, floats, s);
}

}  // namespace

extern "C" {

// table: bf16[c, f_in]; keys: int32[k]; nbrs: int32[k, d]; valid: bool[k, d];
// w: bf16[2 f_in, f_out]; bias: bf16[f_out]; out: bf16 rows [k, f_out] (at
// the bucket's row offset); nchunks = ceil(d / chunk) when d > 32 (the
// partial-sum kernel first), else 0 (the layer kernel gathers the rows
// itself); part: f32[k * nchunks, f_in] and part_cnt: int32[k * nchunks]
// when nchunks > 0 (else unused).  wgmma where f_in and f_out are
// multiples of 8 and the table, w and out 16-byte aligned, else the CUDA
// cores; 16-byte table loads where f_in is a multiple of 8 and the table
// 16-byte aligned.
int sage_layer_launch(const void* table, int c, int f_in, const void* keys, const void* nbrs, const void* valid,
                      int k, int d, const void* w, const void* bias, int f_out, void* out, int chunk, int nchunks,
                      void* part, void* part_cnt, void* stream) {
  if (k <= 0 || f_in <= 0 || f_out <= 0 || c <= 0 || d < 0 || chunk <= 0 || nchunks < 0 ||
      (nchunks == 0) != (d <= kDirectSlots))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = f_in % 8 == 0 && aligned16(table);
  const bool tensor = vec && f_out % 8 == 0 && aligned16(w) && aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LayerArgs a{};
  cudaError_t err = start_gather(a, table, c, f_in, keys, nbrs, valid, k, d, chunk, nchunks, part, part_cnt, vec, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const __nv_bfloat16*>(bias);
  a.f_out = f_out;
  a.out = static_cast<__nv_bfloat16*>(out);
  if (!tensor) {
    const Plan p = plan_layer(kCudaCore, f_in, f_out, f_in < kChunkCore ? f_in : kChunkCore, kMaxCols);
    if (p.kc < f_in) {
      err = vec ? launch_layer<8, kCudaCore, true>(a, p, s) : launch_layer<1, kCudaCore, true>(a, p, s);
    } else {
      err = vec ? launch_layer<8, kCudaCore, false>(a, p, s) : launch_layer<1, kCudaCore, false>(a, p, s);
    }
    return static_cast<int>(err);
  }
  // the whole width in one K chunk where it fits beside W's tile, else
  // chunks of kChunkTensor features
  const int nt = f_out < kMaxCols ? f_out : kMaxCols;
  Plan p = plan_layer(kWgmma, f_in, f_out, f_in, nt);
  if (p.total > static_cast<size_t>(kSmemLimit)) p = plan_layer(kWgmma, f_in, f_out, kChunkTensor, nt);
  err = p.kc < f_in ? launch_layer<8, kWgmma, true>(a, p, s) : launch_layer<8, kWgmma, false>(a, p, s);
  return static_cast<int>(err);
}

// The scratch sage_layer_backward_launch needs, in bytes: f32 partials of
// dw [2 f_in, f_out] and db [f_out] for as many blocks as the SMs can hold
// (-1 if the device cannot be read).
long long sage_layer_backward_scratch_bytes(int f_in, int f_out) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  return static_cast<long long>(kBackMaxBlocksPerSm) * sms * (2ll * f_in * f_out + f_out) * 4;
}

// table, c, f_in, keys, nbrs, valid, k, d, chunk, nchunks, part, part_cnt:
// as sage_layer_launch (the same gather, partial sums first when d > 32);
// z, dz: bf16 [k, f_out], the layer's output and its gradient; dw: f32
// [2 f_in, f_out] and db: f32 [f_out], added to; scratch: f32, at least
// sage_layer_backward_scratch_bytes.  Three kernels: the partial sums
// (nchunks > 0), the blocks' partials, their sum in block order.
int sage_layer_backward_launch(const void* table, int c, int f_in, const void* keys, const void* nbrs,
                               const void* valid, int k, int d, const void* z, const void* dz, int f_out, void* dw,
                               void* db, int chunk, int nchunks, void* part, void* part_cnt, void* scratch,
                               long long scratch_bytes, void* stream) {
  if (k <= 0 || f_in <= 0 || f_out <= 0 || c <= 0 || d < 0 || chunk <= 0 || nchunks < 0 ||
      (nchunks == 0) != (d <= kDirectSlots) || !aligned16(scratch))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = f_in % 8 == 0 && aligned16(table);
  const bool vec_h = f_out % 8 == 0 && aligned16(z) && aligned16(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  LayerArgs a{};
  cudaError_t err = start_gather(a, table, c, f_in, keys, nbrs, valid, k, d, chunk, nchunks, part, part_cnt, vec, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  BackArgs b{};
  b.z = static_cast<const __nv_bfloat16*>(z);
  b.dz = static_cast<const __nv_bfloat16*>(dz);
  b.f_out = f_out;
  b.part_dw = static_cast<float*>(scratch);
  const long long floats = scratch_bytes / 4;
  auto* fdw = static_cast<float*>(dw);
  auto* fdb = static_cast<float*>(db);
  if (vec && vec_h) {  // the tensor cores
    err = d == 0 ? launch_backward_wgmma<true>(a, b, fdw, fdb, floats, s)
                 : launch_backward_wgmma<false>(a, b, fdw, fdb, floats, s);
  } else if (vec) {
    err = launch_backward_core<8, false>(a, b, fdw, fdb, floats, s);
  } else {
    err = vec_h ? launch_backward_core<1, true>(a, b, fdw, fdb, floats, s)
                : launch_backward_core<1, false>(a, b, fdw, fdb, floats, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
