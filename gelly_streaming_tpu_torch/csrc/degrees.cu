// Degree kernels on Hopper (sm_90a) behind a plain C interface, loaded with
// ctypes (gelly_streaming_tpu_torch/ops/_cuda.py, ops/degrees.py).
//
// degree_trace_kernel replaces the kernel of the continuous degree stream
// (gelly_streaming_tpu/core/stream.py:869-884, EdgeStream._degree_stream),
// an XLA loop of the JAX package: the within-key occurrence rank of every
// endpoint (occurrence_rank: a stable argsort, segment heads, a cummax and
// a scatter), emitted = counts[v] + rank + 1, the scatter-add of the counts,
// then pack_records48 and pack_mask_bits.  The sort of the grouping keys
// stays a library sort (torch.sort, stable), as the JAX package leaves it to
// XLA's argsort; everything after the sort is this one cooperative launch.
//   Phase 1, one thread a sorted position p: the segment start is found by a
//   galloping search back from p over the sorted keys (one load when the key
//   changes at p, O(log rank) on a hub), so no scan runs; the vertex id is the
//   key's upper bits (key >> 1), so v itself is never read; the record of the
//   row order[p] is written at its place in arrival order (6 bytes as three
//   16-bit stores, or the raw emitted int32), and the mask bits are packed
//   one byte a thread from m, read in order.  Phase 2, after a grid-wide
//   sync: the last position of every valid segment writes counts[v] += its
//   length, one write a vertex and no atomics; the sync keeps every read of
//   counts in phase 1 before it.
//   Bound on the H100 (bytes), for the bench's 2^21-edge batch in the ALL
//   direction (n = 2^22 endpoints, about 2^20 vertices touched): keys and
//   order read (12 B a row), the mask read (1 B), 6 B of record and 1/8 B of
//   mask bit written, counts read and written once a touched vertex (8 B):
//   about 88 MB, 26 us at 3.35 TB/s.  The record writes land scattered
//   (order[p] is a permutation), so each 6-byte record costs a 32-byte L2
//   sector write; that is the known slack.
//
// degree_fold_kernel replaces DegreeDistributionSummary.update
// (gelly_streaming_tpu/library/degree_distribution.py:247-251): deg[src] += 1
// and deg[dst] += 1 for every valid row, by atomicAdd on the 4 MiB degree
// vector, which stays in the 50 MB L2.  Bound: src and dst read once (8 B an
// edge), deg read and written once.
//
// degree_dist_scan_kernel replaces the lax.scan of degree_dist_update
// (gelly_streaming_tpu/library/degree_distribution.py:43-84): per event in
// order, the u then v vertex change, each emitting a (new degree, count) and
// an (old degree, count) histogram record.  The scan is inherently
// sequential (each event reads the histogram the previous one wrote), so
// this first design is one thread walking the batch with deg and hist in
// global memory: its time is a chain of dependent L2 round trips, about ten
// an event.  JAX's index semantics are kept at the edge of the array: the
// histogram scatter-add of a degree >= capacity is dropped and its gather
// clamps to hist[C - 1]; deleting an absent vertex is a no-op; a transition
// to degree 0 emits only the old-degree record; a self-loop changes u, then
// v.  A parallel form (per-vertex clamped scans, per-degree prefix sums over
// the record order) is later work.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRecordValue = (1 << 28) - 1;

// int32 addition with two's-complement wrap (XLA's int32 semantics)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int clamp_index(int i, int size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// First position of `key` in sorted keys[0..p] (keys[p] == key).
__device__ __forceinline__ int64_t segment_start(const int* __restrict__ keys, int64_t p,
                                                 int key) {
  if (p == 0 || __ldg(keys + p - 1) != key) return p;
  int64_t hi = p - 1;  // keys[hi] == key
  int64_t lo = -1;     // keys[lo] < key, or before the array
  for (int64_t step = 1;; step <<= 1) {
    const int64_t probe = hi - step;
    if (probe < 0) break;
    if (__ldg(keys + probe) != key) {
      lo = probe;
      break;
    }
    hi = probe;
  }
  while (hi - lo > 1) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid) == key)
      hi = mid;
    else
      lo = mid;
  }
  return hi;
}

// packed: uint8[6n] records (id | (val & 0xFFF) << 20, val >> 12), or null;
// maskbits: uint8[(n + 7) / 8], or null; emitted: int32[n] raw, or null.
__global__ void __launch_bounds__(kThreads)
degree_trace_kernel(const uint8_t* __restrict__ m, const int* __restrict__ keys, const int64_t* __restrict__ order, int n,
                    int* __restrict__ counts, int capacity, uint8_t* __restrict__ packed,
                    uint8_t* __restrict__ maskbits, int* __restrict__ emitted) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p = first; p < n; p += stride) {
    const int key = __ldg(keys + p);
    const int rank = static_cast<int>(p - segment_start(keys, p, key));
    const int64_t i = __ldg(order + p);
    const int id = key >> 1;  // the row's vertex id (keys are 2 * v + !m)
    const int e = wrap_add(wrap_add(counts[clamp_index(id, capacity)], rank), 1);
    if (packed != nullptr) {
      const unsigned val = static_cast<unsigned>(e < 0 ? 0 : (e > kMaxRecordValue ? kMaxRecordValue : e));
      const unsigned lo = static_cast<unsigned>(id) | ((val & 0xFFFu) << 20);
      const unsigned hi = val >> 12;
      auto* rec = reinterpret_cast<uint16_t*>(packed + 6 * i);
      rec[0] = static_cast<uint16_t>(lo & 0xFFFFu);
      rec[1] = static_cast<uint16_t>(lo >> 16);
      rec[2] = static_cast<uint16_t>(hi & 0xFFFFu);
    } else {
      emitted[i] = e;
    }
  }
  if (maskbits != nullptr) {
    const int64_t nbytes = (static_cast<int64_t>(n) + 7) / 8;
    for (int64_t j = first; j < nbytes; j += stride) {
      unsigned byte = 0;
      for (int b = 0; b < 8; ++b) {
        const int64_t i = 8 * j + b;
        if (i < n && m[i] != 0) byte |= 1u << b;
      }
      maskbits[j] = static_cast<uint8_t>(byte);
    }
  }
  grid.sync();
  for (int64_t p = first; p < n; p += stride) {
    const int key = __ldg(keys + p);
    if ((key & 1) != 0) continue;  // padding rows count nothing
    if (p + 1 < n && __ldg(keys + p + 1) == key) continue;
    const int id = key >> 1;
    if (id < 0 || id >= capacity) continue;  // XLA drops out-of-range scatters
    const int len = static_cast<int>(p - segment_start(keys, p, key) + 1);
    counts[id] = wrap_add(counts[id], len);
  }
}

__global__ void __launch_bounds__(kThreads)
degree_fold_kernel(int* __restrict__ deg, const int* __restrict__ src,
                   const int* __restrict__ dst, const uint8_t* __restrict__ mask, int n,
                   int capacity) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
    if (mask != nullptr && mask[i] == 0) continue;
    const int s = __ldg(src + i);
    const int d = __ldg(dst + i);
    if (static_cast<unsigned>(s) < static_cast<unsigned>(capacity)) atomicAdd(deg + s, 1);
    if (static_cast<unsigned>(d) < static_cast<unsigned>(capacity)) atomicAdd(deg + d, 1);
  }
}

// One vertex change of degree_dist_update: recs gets (new, hist[new]) then
// (old, hist[old]); rmask their emit flags.
__device__ __forceinline__ void vertex_change(int* __restrict__ deg, int* __restrict__ hist,
                                              int capacity, int v, int delta, bool ok,
                                              int* __restrict__ recs, uint8_t* __restrict__ rmask) {
  const int old = deg[clamp_index(v, capacity)];
  ok = ok && !(delta < 0 && old <= 0);
  int next = wrap_add(old, delta);
  next = next < 0 ? 0 : next;
  if (static_cast<unsigned>(v) < static_cast<unsigned>(capacity)) deg[v] = ok ? next : old;
  const bool emit_new = ok && next > 0;
  const bool emit_old = ok && old > 0;
  if (emit_new && next < capacity) hist[next] = wrap_add(hist[next], 1);
  recs[0] = next;
  recs[1] = hist[clamp_index(next, capacity)];
  if (emit_old && old < capacity) hist[old] = wrap_add(hist[old], -1);
  recs[2] = old;
  recs[3] = hist[clamp_index(old, capacity)];
  rmask[0] = emit_new;
  rmask[1] = emit_old;
}

// recs: int32[n, 4, 2]; rmask: uint8[n, 4]; sign: int8[n] or null (all +1);
// mask: uint8[n] or null (all valid).  One thread.
__global__ void degree_dist_scan_kernel(int* __restrict__ deg, int* __restrict__ hist, int capacity,
                                        const int* __restrict__ src, const int* __restrict__ dst,
                                        const int8_t* __restrict__ sign,
                                        const uint8_t* __restrict__ mask, int n,
                                        int* __restrict__ recs, uint8_t* __restrict__ rmask) {
  for (int64_t e = 0; e < n; ++e) {
    const bool ok = mask == nullptr || mask[e] != 0;
    const int delta = sign == nullptr ? 1 : static_cast<int>(sign[e]);
    vertex_change(deg, hist, capacity, src[e], delta, ok, recs + 8 * e, rmask + 4 * e);
    vertex_change(deg, hist, capacity, dst[e], delta, ok, recs + 8 * e + 4, rmask + 4 * e + 2);
  }
}

int grid_for(const void* kernel, int64_t items, bool cooperative, cudaError_t* err) {
  int device = 0, sms = 0, per_sm = 0;
  if ((*err = cudaGetDevice(&device)) != cudaSuccess ||
      (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) !=
          cudaSuccess)
    return 0;
  // a cooperative grid must be co-resident; a plain one loops over the rest
  const int64_t fit = static_cast<int64_t>(sms) * (cooperative ? per_sm : 4 * per_sm);
  int64_t blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < fit ? blocks : fit;
  return static_cast<int>(blocks > 0 ? blocks : 1);
}

}  // namespace

extern "C" {

// m: uint8[n]; keys: int32[n], the grouping keys 2 * v + !m of the vertex
// ids v (|v| < 2^30) in stable sorted order; order: int64[n], the sort's
// permutation; counts:
// int32[capacity], updated in place; packed: uint8[6n] and maskbits:
// uint8[(n + 7) / 8] (both null for the raw form); emitted: int32[n] (null
// for the packed form).  One cooperative launch on the stream, no host sync.
int degree_trace_launch(const void* m, const void* keys, const void* order, int n, void* counts,
                        int capacity, void* packed, void* maskbits, void* emitted, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  const void* kernel = reinterpret_cast<const void*>(degree_trace_kernel);
  const int blocks = grid_for(kernel, n, true, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* m_b = static_cast<const uint8_t*>(m);
  auto* k_i = static_cast<const int*>(keys);
  auto* o_l = static_cast<const int64_t*>(order);
  auto* c_i = static_cast<int*>(counts);
  auto* p_b = static_cast<uint8_t*>(packed);
  auto* mb_b = static_cast<uint8_t*>(maskbits);
  auto* e_i = static_cast<int*>(emitted);
  void* args[] = {&m_b, &k_i, &o_l, &n, &c_i, &capacity, &p_b, &mb_b, &e_i};
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, 0, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// deg: int32[capacity], updated in place; src, dst: int32[n]; mask: uint8[n]
// or null.
int degree_fold_launch(void* deg, const void* src, const void* dst, const void* mask, int n,
                       int capacity, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  const int blocks = grid_for(reinterpret_cast<const void*>(degree_fold_kernel), n, false, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  degree_fold_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<int*>(deg), static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const uint8_t*>(mask), n, capacity);
  return static_cast<int>(cudaGetLastError());
}

// deg, hist: int32[capacity], updated in place; src, dst: int32[n]; sign:
// int8[n] or null; mask: uint8[n] or null; recs: int32[n * 8]; rmask:
// uint8[n * 4].
int degree_dist_scan_launch(void* deg, void* hist, int capacity, const void* src, const void* dst,
                            const void* sign, const void* mask, int n, void* recs, void* rmask,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  degree_dist_scan_kernel<<<1, 1, 0, s>>>(
      static_cast<int*>(deg), static_cast<int*>(hist), capacity, static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const int8_t*>(sign),
      static_cast<const uint8_t*>(mask), n, static_cast<int*>(recs), static_cast<uint8_t*>(rmask));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
