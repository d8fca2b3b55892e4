// The mesh plane's routing kernels for the H100: the owner-bucket pack, the
// block-delta fold and the slab fold.  Each is a plain C entry point that
// enqueues on the caller's stream and returns cudaGetLastError().
//
// owner_pack: port of gelly_streaming_tpu/parallel/routing.py
// pack_slab_deltas (:347-395) and of owner_rank + _exchange_by_owner
// (:138-250), bit for bit.  n items, each with an owner in [0, S) (given, or
// i % S) and a live flag (given, or every item), are compacted into [S, cap]
// slots: an item's rank is the number of live items of its owner before it
// in input order (the JAX cumsum), and it lands in slot owner * cap + rank
// when the rank is below cap.  Its payload is a (given, or i / S: the block
// row) and b; empty slots hold fill_a and fill_b (and 0 in ok).  sent[i] says
// whether item i landed and slot[i] where (-1: nowhere); counts[o] is owner
// o's live items before capping; acc accumulates the high-water of counts (atomicMax), the rows past cap
// (atomicAdd) and the live items (atomicAdd), so a caller's loop reads one
// buffer a round.  Items whose owner lies outside [0, S) are not live.
// Three launches, no memset:
//   1. count: a warp takes a chunk of 256 items, 32 at a time in order, and
//      tallies each owner's live items with __match_any_sync into its own
//      shared counters; the chunk's counts go to scratch [chunks, S];
//   2. scan: a block an owner scans its column of chunk counts (exclusive,
//      in place), writes counts[o], the fill of its slots past min(count,
//      cap), and its share of acc;
//   3. scatter: the warps walk their chunks again from the scanned offsets,
//      each item's rank the offset plus the live lanes of its owner below
//      it, and write the payloads of the items that fit.
// Bound: the inputs read twice in the worst case, against once (bytes: n
// live flags, owners and payloads, S * cap slots written).
//
// block_delta_fold: port of apply_block_deltas (routing.py:426-446).  S
// senders' (row, value) buffers of cap slots each fold into a [R] block by
// min, max or add; a DELTA_PAD (-1) row is empty, a row below -1 counts
// from the end once, a row outside [0, R) after that is dropped (JAX's
// mode="drop" scatter).  One thread a slot, an atomic a live slot.
//
// slab_fold: the dense slab reconcile (connected_components.py:245-247,
// degree_distribution.py:179-187) and the elementwise reductions of
// pmin / pmax / psum.  block[i] = op(block[i], recv_0[i], ..., recv_{S-1}[i])
// over S received slabs of R rows; each block of threads that changed an
// entry adds one to *flag (when given), so a caller reads whether anything
// changed since its last read without a reset.  Grid-stride, four rows a
// thread an iteration (16-byte loads where every pointer is aligned).
//
// The senders' and slabs' pointers travel by value in the launch's
// parameters (at most kMaxShards of each), so buffers of shards that share
// a device are read in place.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxShards = 64;
constexpr int kPackWarps = 8;
constexpr int kPackThreads = kPackWarps * 32;
constexpr int kChunkIters = 8;  // 32-item steps a warp's chunk holds
constexpr int kChunk = 32 * kChunkIters;
constexpr int kMaxPackOwners = 1024;
constexpr int kScanThreads = 1024;
constexpr int kFoldThreads = 256;

enum Op { kMin = 0, kMax = 1, kAdd = 2 };

struct Ptrs {
  const int* p[kMaxShards];
};

__device__ __forceinline__ bool item_live(const uint8_t* live, long long i) { return live == nullptr || live[i]; }

__device__ __forceinline__ int item_owner(const int* owner, long long i, int s) {
  return owner == nullptr ? static_cast<int>(i % s) : owner[i];
}

// Each lane's owner for one 32-item step (-1: not live or out of range).
__device__ __forceinline__ int step_owner(const uint8_t* live, const int* owner, long long i, long long n, int s) {
  if (i >= n || !item_live(live, i)) return -1;
  const int o = item_owner(owner, i, s);
  return (o >= 0 && o < s) ? o : -1;
}

__global__ void __launch_bounds__(kPackThreads) pack_count_kernel(const uint8_t* live, const int* owner, long long n,
                                                                 int s, int* chunk_counts) {
  extern __shared__ int cnt[];  // [kPackWarps][s]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* mine = cnt + warp * s;
  for (int o = lane; o < s; o += 32) mine[o] = 0;
  __syncwarp();
  const long long chunk = static_cast<long long>(blockIdx.x) * kPackWarps + warp;
  const long long base = chunk * kChunk;
  if (base >= n) return;
  for (int it = 0; it < kChunkIters; ++it) {
    const long long i = base + it * 32 + lane;
    const int o = step_owner(live, owner, i, n, s);
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    if (o >= 0 && (peers & ((1u << lane) - 1)) == 0) mine[o] += __popc(peers);
    __syncwarp();
  }
  for (int o = lane; o < s; o += 32) chunk_counts[chunk * s + o] = mine[o];
}

__global__ void __launch_bounds__(kScanThreads) pack_scan_kernel(int* chunk_counts, long long chunks, int s, int cap,
                                                                int* out_a, int fill_a, int* out_b, int fill_b,
                                                                uint8_t* out_ok, int* counts, int* acc) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int o = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long c0 = 0; c0 < chunks; c0 += kScanThreads) {
    const long long c = c0 + threadIdx.x;
    const int v = c < chunks ? chunk_counts[c * s + o] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sums[warp - 1] : 0) + x - v;
    if (c < chunks) chunk_counts[c * s + o] = before;
    __syncthreads();
    if (threadIdx.x == 0) carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();
  }
  const int count = carry;
  const int used = count < cap ? count : cap;
  const long long slot0 = static_cast<long long>(o) * cap;
  for (int j = used + threadIdx.x; j < cap; j += kScanThreads) {
    out_a[slot0 + j] = fill_a;
    if (out_b != nullptr) out_b[slot0 + j] = fill_b;
    if (out_ok != nullptr) out_ok[slot0 + j] = 0;
  }
  if (threadIdx.x == 0) {
    counts[o] = count;
    if (acc != nullptr) {
      atomicMax(acc, count);
      atomicAdd(acc + 1, count - used);
      atomicAdd(acc + 2, count);
    }
  }
}

__global__ void __launch_bounds__(kPackThreads) pack_scatter_kernel(const uint8_t* live, const int* owner,
                                                                   const int* a, const int* b, long long n, int s,
                                                                   int cap, const int* chunk_offsets, int* out_a,
                                                                   int* out_b, uint8_t* out_ok, uint8_t* sent,
                                                                   int* slot_out) {
  extern __shared__ int off[];  // [kPackWarps][s]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long chunk = static_cast<long long>(blockIdx.x) * kPackWarps + warp;
  const long long base = chunk * kChunk;
  if (base >= n) return;
  int* mine = off + warp * s;
  for (int o = lane; o < s; o += 32) mine[o] = chunk_offsets[chunk * s + o];
  __syncwarp();
  for (int it = 0; it < kChunkIters; ++it) {
    const long long i = base + it * 32 + lane;
    const int o = step_owner(live, owner, i, n, s);
    const unsigned peers = __match_any_sync(0xffffffffu, o);
    bool landed = false;
    long long slot = -1;
    if (o >= 0) {
      const int rank = mine[o] + __popc(peers & ((1u << lane) - 1));
      if (rank < cap) {
        slot = static_cast<long long>(o) * cap + rank;
        out_a[slot] = a == nullptr ? static_cast<int>(i / s) : a[i];
        if (out_b != nullptr) out_b[slot] = b[i];
        if (out_ok != nullptr) out_ok[slot] = 1;
        landed = true;
      }
    }
    __syncwarp();
    if (o >= 0 && (peers & ((1u << lane) - 1)) == 0) mine[o] += __popc(peers);
    __syncwarp();
    if (sent != nullptr && i < n) sent[i] = landed;
    if (slot_out != nullptr && i < n) slot_out[i] = static_cast<int>(slot);
  }
}

template <int OP>
__device__ __forceinline__ int combine(int x, int y) {
  if (OP == kMin) return x < y ? x : y;
  if (OP == kMax) return x > y ? x : y;
  return static_cast<int>(static_cast<unsigned>(x) + static_cast<unsigned>(y));  // wraps, as int32 adds do
}

template <int OP>
__global__ void __launch_bounds__(kFoldThreads) block_delta_fold_kernel(int* block, int rows, Ptrs row_ptrs,
                                                                       Ptrs val_ptrs, int s, int cap) {
  const long long t = static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (t >= static_cast<long long>(s) * cap) return;
  const int sender = static_cast<int>(t / cap), j = static_cast<int>(t % cap);
  int r = row_ptrs.p[sender][j];
  if (r == -1) return;  // DELTA_PAD: an empty slot
  if (r < 0) r += rows;
  if (r < 0 || r >= rows) return;
  const int v = val_ptrs.p[sender][j];
  if (OP == kMin)
    atomicMin(block + r, v);
  else if (OP == kMax)
    atomicMax(block + r, v);
  else
    atomicAdd(block + r, v);
}

template <int OP, bool VEC>
__global__ void __launch_bounds__(kFoldThreads) slab_fold_kernel(int* block, long long rows, Ptrs slabs, int s,
                                                                int* flag) {
  bool changed = false;
  const long long stride = static_cast<long long>(gridDim.x) * kFoldThreads;
  if (VEC) {
    const long long quads = rows / 4;
    for (long long q = static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x; q < quads; q += stride) {
      int4 v = reinterpret_cast<const int4*>(block)[q];
      const int4 old = v;
      for (int k = 0; k < s; ++k) {
        const int4 r = reinterpret_cast<const int4*>(slabs.p[k])[q];
        v.x = combine<OP>(v.x, r.x);
        v.y = combine<OP>(v.y, r.y);
        v.z = combine<OP>(v.z, r.z);
        v.w = combine<OP>(v.w, r.w);
      }
      if (v.x != old.x || v.y != old.y || v.z != old.z || v.w != old.w) {
        changed = true;
        reinterpret_cast<int4*>(block)[q] = v;
      }
    }
  } else {
    for (long long i = static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x; i < rows; i += stride) {
      int v = block[i];
      const int old = v;
      for (int k = 0; k < s; ++k) v = combine<OP>(v, slabs.p[k][i]);
      if (v != old) {
        changed = true;
        block[i] = v;
      }
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0 && flag != nullptr) atomicAdd(flag, 1);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

}  // namespace

extern "C" {

// n, S: the scratch bytes of one owner_pack_launch (the chunk counts).
long long owner_pack_scratch_bytes(long long n, int s) {
  const long long chunks = (n + kChunk - 1) / kChunk;
  return (chunks > 0 ? chunks : 1) * static_cast<long long>(s) * 4;
}

// live: uint8[n] | null (every item live); owner: int32[n] | null (i % S);
// a: int32[n] | null (i / S); b: int32[n], or null with out_b null;
// out_a: int32[S * cap]; out_b: int32[S * cap] | null; out_ok: uint8[S *
// cap] | null; sent: uint8[n] | null; slot: int32[n] | null; counts:
// int32[S]; acc: int32[3] | null, accumulated (high-water, spilled, live); scratch: at least
// owner_pack_scratch_bytes(n, S).  cap may be 0 (a count alone).
int owner_pack_launch(const void* live, const void* owner, const void* a, const void* b, long long n, int s, int cap,
                      int fill_a, int fill_b, void* out_a, void* out_b, void* out_ok, void* sent, void* slot,
                      void* counts, void* acc, void* scratch, long long scratch_bytes, void* stream) {
  if (n < 0 || s < 1 || s > kMaxPackOwners || cap < 0 || counts == nullptr) return cudaErrorInvalidValue;
  if (n > 0 && out_b != nullptr && b == nullptr) return cudaErrorInvalidValue;
  if (cap > 0 && out_a == nullptr) return cudaErrorInvalidValue;
  if (scratch_bytes < owner_pack_scratch_bytes(n, s)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* lv = static_cast<const uint8_t*>(live);
  const auto* ow = static_cast<const int*>(owner);
  int* cc = static_cast<int*>(scratch);
  const long long chunks = (n + kChunk - 1) / kChunk;
  const unsigned blocks = static_cast<unsigned>((chunks + kPackWarps - 1) / kPackWarps);
  const size_t smem = static_cast<size_t>(kPackWarps) * s * sizeof(int);
  if (chunks > 0) pack_count_kernel<<<blocks, kPackThreads, smem, st>>>(lv, ow, n, s, cc);
  pack_scan_kernel<<<s, kScanThreads, 0, st>>>(cc, chunks, s, cap, static_cast<int*>(out_a), fill_a,
                                               static_cast<int*>(out_b), fill_b, static_cast<uint8_t*>(out_ok),
                                               static_cast<int*>(counts), static_cast<int*>(acc));
  if (static_cast<long long>(s) * cap > (1LL << 31) - 1) return cudaErrorInvalidValue;
  if (chunks > 0 && (cap > 0 || sent != nullptr || slot != nullptr))
    pack_scatter_kernel<<<blocks, kPackThreads, smem, st>>>(
        lv, ow, static_cast<const int*>(a), static_cast<const int*>(b), n, s, cap, cc, static_cast<int*>(out_a),
        static_cast<int*>(out_b), static_cast<uint8_t*>(out_ok), static_cast<uint8_t*>(sent),
        static_cast<int*>(slot));
  return static_cast<int>(cudaGetLastError());
}

// block: int32[rows]; row_ptrs, val_ptrs: S host-side pointers each to an
// int32[cap] buffer on the block's device; op: 0 min, 1 max, 2 add.
int block_delta_fold_launch(void* block, int rows, const long long* row_ptrs, const long long* val_ptrs, int s,
                            int cap, int op, void* stream) {
  if (rows < 0 || s < 1 || s > kMaxShards || cap < 0 || op < 0 || op > 2) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(s) * cap;
  if (total == 0) return 0;
  Ptrs rp{}, vp{};
  for (int k = 0; k < s; ++k) {
    rp.p[k] = reinterpret_cast<const int*>(row_ptrs[k]);
    vp.p[k] = reinterpret_cast<const int*>(val_ptrs[k]);
  }
  const unsigned blocks = static_cast<unsigned>((total + kFoldThreads - 1) / kFoldThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* blk = static_cast<int*>(block);
  if (op == kMin)
    block_delta_fold_kernel<kMin><<<blocks, kFoldThreads, 0, st>>>(blk, rows, rp, vp, s, cap);
  else if (op == kMax)
    block_delta_fold_kernel<kMax><<<blocks, kFoldThreads, 0, st>>>(blk, rows, rp, vp, s, cap);
  else
    block_delta_fold_kernel<kAdd><<<blocks, kFoldThreads, 0, st>>>(blk, rows, rp, vp, s, cap);
  return static_cast<int>(cudaGetLastError());
}

// block: int32[rows]; slab_ptrs: S host-side pointers each to an int32[rows]
// slab on the block's device; op: 0 min, 1 max, 2 add; flag: int32 | null.
int slab_fold_launch(void* block, long long rows, const long long* slab_ptrs, int s, int op, void* flag,
                     void* stream) {
  if (rows < 0 || s < 0 || s > kMaxShards || op < 0 || op > 2) return cudaErrorInvalidValue;
  if (rows == 0 || s == 0) return 0;
  Ptrs sp{};
  bool vec = aligned16(block) && rows % 4 == 0;
  for (int k = 0; k < s; ++k) {
    sp.p[k] = reinterpret_cast<const int*>(slab_ptrs[k]);
    vec = vec && aligned16(sp.p[k]);
  }
  const long long items = vec ? rows / 4 : rows;
  long long want = (items + kFoldThreads - 1) / kFoldThreads;
  const long long most = 8LL * sm_count();
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* blk = static_cast<int*>(block);
  int* fl = static_cast<int*>(flag);
#define SLAB_FOLD(OPV)                                                                    \
  if (vec)                                                                                \
    slab_fold_kernel<OPV, true><<<blocks, kFoldThreads, 0, st>>>(blk, rows, sp, s, fl);  \
  else                                                                                    \
    slab_fold_kernel<OPV, false><<<blocks, kFoldThreads, 0, st>>>(blk, rows, sp, s, fl);
  if (op == kMin) {
    SLAB_FOLD(kMin)
  } else if (op == kMax) {
    SLAB_FOLD(kMax)
  } else {
    SLAB_FOLD(kAdd)
  }
#undef SLAB_FOLD
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
