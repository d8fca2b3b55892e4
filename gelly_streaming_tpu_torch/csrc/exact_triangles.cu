// The streaming exact triangle fold on Hopper (sm_90a) behind a plain C
// interface, loaded with ctypes (gelly_streaming_tpu_torch/ops/_cuda.py,
// ops/exact_triangles.py).
//
// Replaces the two XLA loops of the JAX package that fold an edge batch
// into ExactTriangleCount's state (gelly_streaming_tpu/library/
// triangles.py): triangle_update (:450-501), a lax.scan one edge a step,
// and triangle_update_block (:504-622), a lax.scan over chunks of r edges.
// The state is an undirected neighbor table nbrs int32[C, D] (-1 empty)
// with deg int32[C] and an overflow counter, per-vertex counts local
// int32[C] and the global count.  Per chunk (r = 1 is the per-edge scan):
//   which edges count: ok = mask, lo != hi, hi not in any of the D slots
//   of lo's row, and the first of the chunk's (lo, hi) among the edges
//   that passed the first two tests;
//   old-old: the pairs of valid slots of row(lo) and row(hi) that hold
//   the same id, with multiplicity, and +1 on each slot of row(lo) that
//   has a match;
//   old-new: an earlier chunk edge e_i that shares lo (hi), its other end
//   w in the valid slots of row(hi) (row(lo)): +1, and +1 on w;
//   new-new: two earlier chunk edges meeting lo and hi at the same w:
//   +1 each pair, weight on w;
//   counters: lo and hi += the edge's c, global += c (int32, wrapping);
//   insert: the 2r entries [lo..., hi...] -> [hi..., lo...] of the ok
//   edges, each at slot deg[src] + its occurrence rank among them, dropped
//   (and counted) at slot D or past.
// Ids outside [0, C) follow JAX's rules: gathers normalize (below 0 counts
// from the end once) and clamp, scatters normalize and drop; the insert's
// flat slot index is src * D + pos in int32, so a negative id lands in the
// last rows.
//
// Design (simple first): one thread block folds the whole batch, chunk
// after chunk, with __syncthreads() between the phases above.  The table
// stays in global memory: each chunk reads the rows the previous chunk
// wrote, so no grid-wide sync is needed, and the chain is ceil(B / r)
// dependent chunk steps a batch.  A chunk's rows are staged in shared
// memory where 2 r D ints fit kStageCap, else read from global memory in
// the same loops.  Phases are loops of independent items over the block's
// threads: (edge, slot) items for the membership test and the old-old
// count, (edge, earlier edge) items for the old-new and new-new terms,
// counters by atomics.  The trace kernel is the same loop at r = 1, one
// edge a step, writing (local[lo], local[hi]) and the running global
// after each edge.
//   Bound on the H100 (bytes): the batch's edges read once (9 B an edge),
// the two rows each valid edge needs read once, the new slots, degrees
// and counters written once.  What holds this design back is the chain:
// each chunk step is a handful of block-wide barriers and dependent loads,
// so its time follows ceil(B / r), not the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;  // ops/exact_triangles.MAX_CHUNK
constexpr int kBlockThreads = 1024;
constexpr int kTraceThreads = 256;
constexpr int kStageCap = 160 * 1024;  // staged rows' bytes at most

__device__ __forceinline__ int jax_index(int i, int size) { return i < 0 ? i + size : i; }

// a JAX gather's index: normalized, then clamped
__device__ __forceinline__ int gather_index(int i, int size) {
  i = jax_index(i, size);
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// a JAX scatter-add: normalized, dropped outside [0, size)
__device__ __forceinline__ void scatter_add(int* a, int i, int size, int v) {
  i = jax_index(i, size);
  if (static_cast<unsigned>(i) < static_cast<unsigned>(size)) atomicAdd(a + i, v);
}

struct Fold {
  int* nbrs;
  int* deg;
  int* dropped;
  int* local;
  int* glob;
  const int* src;
  const int* dst;
  const uint8_t* mask;
  int n;
  int capacity;
  int max_degree;
  int* trace_local;  // int32[n, 2], null in block mode
  int* trace_global;  // int32[n]
};

__global__ void __launch_bounds__(kBlockThreads) triangle_fold_kernel(Fold f, int r, int staged) {
  __shared__ int s_lo[kMaxChunk], s_hi[kMaxChunk], s_glo[kMaxChunk], s_ghi[kMaxChunk];
  __shared__ int s_dlo[kMaxChunk], s_dhi[kMaxChunk], s_c[kMaxChunk];
  __shared__ uint8_t s_ok0[kMaxChunk], s_ok[kMaxChunk], s_found[kMaxChunk];
  __shared__ int s_pos[2 * kMaxChunk];
  __shared__ uint8_t s_ins[2 * kMaxChunk];  // 0 not inserted, 1 inserted, 2 dropped
  __shared__ int s_glob, s_dropped;
  extern __shared__ int s_rows[];  // staged rows: [r][2][D] (lo's, hi's)
  const int tid = threadIdx.x, nt = blockDim.x;
  const int C = f.capacity, D = f.max_degree;
  if (tid == 0) {
    s_glob = *f.glob;
    s_dropped = 0;
  }
  // edge j's row of lo (side 0) or hi (side 1)
  auto row = [&](int j, int side) -> const int* {
    return staged ? s_rows + (2 * j + side) * D : f.nbrs + static_cast<long long>(side ? s_ghi[j] : s_glo[j]) * D;
  };
  auto member = [&](const int* rw, int deg, int w) {
    const int d = min(deg, D);
    for (int b = 0; b < d; ++b)
      if (rw[b] == w) return true;
    return false;
  };
  const int chunks = (f.n + r - 1) / r;
  for (int k = 0; k < chunks; ++k) {
    const int base = k * r;
    for (int j = tid; j < r; j += nt) {
      const int e = base + j;
      const bool in = e < f.n;
      const int u = in ? f.src[e] : 0, v = in ? f.dst[e] : 0;
      const int lo = min(u, v), hi = max(u, v);
      const int glo = gather_index(lo, C), ghi = gather_index(hi, C);
      s_lo[j] = lo;
      s_hi[j] = hi;
      s_glo[j] = glo;
      s_ghi[j] = ghi;
      s_dlo[j] = f.deg[glo];
      s_dhi[j] = f.deg[ghi];
      s_ok0[j] = in && f.mask[e] && lo != hi;
      s_found[j] = 0;
      s_c[j] = 0;
    }
    __syncthreads();
    // membership of hi in all D slots of lo's row; stage both rows
    for (int x = tid; x < r * D; x += nt) {
      const int j = x / D, a = x - j * D;
      if (!s_ok0[j]) continue;
      const int y = f.nbrs[static_cast<long long>(s_glo[j]) * D + a];
      if (staged) {
        s_rows[2 * j * D + a] = y;
        s_rows[(2 * j + 1) * D + a] = f.nbrs[static_cast<long long>(s_ghi[j]) * D + a];
      }
      if (y == s_hi[j]) s_found[j] = 1;
    }
    __syncthreads();
    // the first occurrence among the edges that passed mask and lo != hi
    for (int j = tid; j < r; j += nt) {
      bool ok = s_ok0[j] && !s_found[j];
      for (int i = 0; ok && i < j; ++i)
        if (s_ok0[i] && s_lo[i] == s_lo[j] && s_hi[i] == s_hi[j]) ok = false;
      s_ok[j] = ok;
    }
    __syncthreads();
    // old-old: (edge, slot of lo's row) items
    for (int x = tid; x < r * D; x += nt) {
      const int j = x / D, a = x - j * D;
      if (!s_ok[j] || a >= s_dlo[j]) continue;
      const int* rh = row(j, 1);
      const int y = row(j, 0)[a];
      const int dh = min(s_dhi[j], D);
      int cnt = 0;
      for (int b = 0; b < dh; ++b) cnt += rh[b] == y;
      if (cnt) {
        atomicAdd(&s_c[j], cnt);
        scatter_add(f.local, y, C, 1);
      }
    }
    // old-new and new-new: (edge j, earlier edge i) items
    for (int x = tid; x < r * r; x += nt) {
      const int j = x / r, i = x - j * r;
      if (i >= j || !s_ok[j] || !s_ok[i]) continue;
      const int loj = s_lo[j], hij = s_hi[j], loi = s_lo[i], hii = s_hi[i];
      const bool shares_lo = loi == loj || hii == loj;
      const bool shares_hi = loi == hij || hii == hij;
      const int w_lo = loi == loj ? hii : loi;  // e_i's other end
      const int w_hi = loi == hij ? hii : loi;
      int add = 0;
      if (shares_lo && member(row(j, 1), s_dhi[j], w_lo)) {
        ++add;
        scatter_add(f.local, w_lo, C, 1);
      }
      if (shares_hi && member(row(j, 0), s_dlo[j], w_hi)) {
        ++add;
        scatter_add(f.local, w_hi, C, 1);
      }
      if (shares_lo) {
        int cnt = 0;
        for (int q = 0; q < j; ++q) {
          if (!s_ok[q]) continue;
          const int loq = s_lo[q], hiq = s_hi[q];
          cnt += (loq == hij || hiq == hij) && (loq == hij ? hiq : loq) == w_lo;
        }
        if (cnt) {
          add += cnt;
          scatter_add(f.local, w_lo, C, cnt);
        }
      }
      if (add) atomicAdd(&s_c[j], add);
    }
    __syncthreads();
    // counters, and the insert's slots: rank among the ok entries of
    // [lo..., hi...] with the same source, read before any degree moves
    for (int j = tid; j < r; j += nt) {
      const int c = s_c[j];
      if (!s_ok[j] || !c) continue;
      scatter_add(f.local, s_lo[j], C, c);
      scatter_add(f.local, s_hi[j], C, c);
      atomicAdd(&s_glob, c);
    }
    for (int x = tid; x < 2 * r; x += nt) {
      const int j = x < r ? x : x - r;
      uint8_t st = 0;
      int pos = 0;
      if (s_ok[j]) {
        const int key = x < r ? s_lo[j] : s_hi[j];
        int rank = 0;
        for (int y = 0; y < min(x, r); ++y) rank += s_ok[y] && s_lo[y] == key;
        for (int y = r; y < x; ++y) rank += s_ok[y - r] && s_hi[y - r] == key;
        pos = (x < r ? s_dlo[j] : s_dhi[j]) + rank;
        st = pos < D ? 1 : 2;
      }
      s_pos[x] = pos;
      s_ins[x] = st;
    }
    __syncthreads();
    for (int x = tid; x < 2 * r; x += nt) {
      const uint8_t st = s_ins[x];
      if (st == 2) atomicAdd(&s_dropped, 1);
      if (st != 1) continue;
      const int j = x < r ? x : x - r;
      const int s = x < r ? s_lo[j] : s_hi[j], d = x < r ? s_hi[j] : s_lo[j];
      const int flat = static_cast<int>(static_cast<unsigned>(s) * static_cast<unsigned>(D) +
                                        static_cast<unsigned>(s_pos[x]));
      const long long slots = static_cast<long long>(C) * D;
      const long long fi = flat < 0 ? flat + slots : flat;
      if (fi >= 0 && fi < slots) f.nbrs[fi] = d;
      scatter_add(f.deg, s, C, 1);
    }
    __syncthreads();
    if (f.trace_local && tid == 0) {  // r = 1: edge `base`, after its insert
      f.trace_local[2 * base] = f.local[gather_index(s_lo[0], C)];
      f.trace_local[2 * base + 1] = f.local[gather_index(s_hi[0], C)];
      f.trace_global[base] = s_glob;
    }
  }
  if (tid == 0) {
    *f.glob = s_glob;
    *f.dropped += s_dropped;
  }
}

cudaError_t launch(const Fold& f, int r, int threads, void* stream) {
  if (f.n < 0 || f.capacity < 1 || f.max_degree < 1 || r < 1 || r > kMaxChunk ||
      static_cast<long long>(f.capacity) * f.max_degree >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (f.n == 0) return cudaSuccess;
  const long long rows_bytes = 2LL * r * f.max_degree * static_cast<long long>(sizeof(int));
  const int staged = rows_bytes <= kStageCap;
  const int smem = staged ? static_cast<int>(rows_bytes) : 0;
  cudaError_t err = cudaFuncSetAttribute(triangle_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  triangle_fold_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(f, r, staged);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// nbrs int32[C, D], deg int32[C], dropped int32[1], local int32[C], glob
// int32[1]: the state, updated in place.  src, dst int32[n]; mask bool[n].
// chunk: r in [1, kMaxChunk], the edges a step.  One launch.
int triangle_block_launch(void* nbrs, void* deg, void* dropped, void* local, void* glob, const void* src,
                          const void* dst, const void* mask, int n, int capacity, int max_degree, int chunk,
                          void* stream) {
  const Fold f{static_cast<int*>(nbrs), static_cast<int*>(deg), static_cast<int*>(dropped),
               static_cast<int*>(local), static_cast<int*>(glob), static_cast<const int*>(src),
               static_cast<const int*>(dst), static_cast<const uint8_t*>(mask), n, capacity, max_degree,
               nullptr, nullptr};
  return static_cast<int>(launch(f, chunk, kBlockThreads, stream));
}

// The same state and batch, one edge a step; trace_local int32[n, 2] gets
// (local[lo], local[hi]) and trace_global int32[n] the global count after
// each edge.  One launch.
int triangle_trace_launch(void* nbrs, void* deg, void* dropped, void* local, void* glob, const void* src,
                          const void* dst, const void* mask, int n, int capacity, int max_degree,
                          void* trace_local, void* trace_global, void* stream) {
  const Fold f{static_cast<int*>(nbrs), static_cast<int*>(deg), static_cast<int*>(dropped),
               static_cast<int*>(local), static_cast<int*>(glob), static_cast<const int*>(src),
               static_cast<const int*>(dst), static_cast<const uint8_t*>(mask), n, capacity, max_degree,
               static_cast<int*>(trace_local), static_cast<int*>(trace_global)};
  return static_cast<int>(launch(f, 1, kTraceThreads, stream));
}

}  // extern "C"
