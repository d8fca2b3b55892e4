// Degree kernels on Hopper (sm_90a) behind a plain C interface, loaded with
// ctypes (gelly_streaming_tpu_torch/ops/_cuda.py, ops/degrees.py).
//
// degree_trace replaces the kernel of the continuous degree stream
// (gelly_streaming_tpu/core/stream.py:869-884, EdgeStream._degree_stream),
// an XLA loop of the JAX package: the within-key occurrence rank of every
// endpoint (occurrence_rank: a stable argsort, segment heads, a cummax and
// a scatter), emitted = counts[v] + rank + 1, the scatter-add of the counts,
// then pack_records48 and pack_mask_bits.  The sort of the grouping keys
// 2v + !m stays a library sort (torch.sort, stable), as the JAX package
// leaves it to XLA's argsort; after it come two kernels.
//   degree_trace_scan_kernel, in sorted order: one 1024-row tile a block, 4
//   rows a thread.  The rank is a segmented count and counts[v] a value
//   carried from the head of v's rows (valid and padding rows of one id are
//   adjacent), so the block scans (base, count, id head, key head) with
//   __shfl_up_sync and warp totals, and tiles are chained by a decoupled
//   look-back (degree_dist_rows_kernel's skeleton), which stops at the
//   nearest tile holding an id head; a hub's rows may span any number of
//   tiles.  counts[v] is read once, at v's head, and written once, at the
//   end of v's valid rows, with no atomics: the end's tile saw the head's
//   tile publish, which read the cell before.  emitted goes to arrival
//   order by one aligned 4-byte store a row (order[p] is the sort's
//   permutation), into an int32[n] staging buffer (16 MiB at 2^22 rows)
//   or, for raw records, the output itself.  Those scattered stores set
//   the pace (taking the three 2-byte scattered stores a row out of the
//   one-kernel design this replaced took 71% of its time, PERF.md §6), so
//   they carry an L2 evict-last hint and the streamed inputs evict-first
//   loads, which keeps the staging buffer in the 50 MB L2 for the pack
//   kernel.
//   degree_trace_pack_kernel, in arrival order: 8 rows a thread; it reads v,
//   the staged emitted values and m coalesced and writes the 48 records as
//   three 16-byte stores and their mask byte.
// JAX's index rules hold for ids outside [0, C) (streams that validate
// nothing): the gather of counts counts an id below 0 from the end once and
// then clamps, the scatter-add drops what is still outside, the rank groups
// by the raw id and the record packs it (-1 packs as (2^20 - 1, 4095)).
// Two ids may then share a cell (-1 and C - 1; C, C + 5 and the clamp to C -
// 1), so when the sorted keys show any id outside [0, C) the scan writes no
// counts and the pack kernel adds every valid row by atomicAdd (the raw form
// launches it for that alone), after every read of the scan.
//   Bound on the H100 (bytes), for the bench's 2^21-edge batch in the ALL
//   direction (n = 2^22 endpoint rows, about 2^20 vertices touched), counted
//   on the kernels' own inputs: keys and order read (12 B
//   a row), the mask read (1 B), 6 B of record and 1/8 B of mask bit
//   written, counts read and written once a touched vertex (8 B): about 88
//   MB, 26 us at 3.35 TB/s.  The design moves more: v read again (4 B a
//   row) and the staging buffer written at random and read back (8 B a row,
//   in L2).
//
// degree_fold_kernel replaces DegreeDistributionSummary.update
// (gelly_streaming_tpu/library/degree_distribution.py:247-251): deg[src] += 1
// and deg[dst] += 1 for every valid row, in int32 with wrap, by reductions
// (red.global.add) on the degree vector, which stays in the 50 MB L2.
// Bound (bytes): src and dst read once (8 B an edge), deg read and written
// once (8 B a vertex): 25.2 MB, 7.51 us for 2^21 edges into 2^20 vertices.
// What binds it is the L2's reduction rate: about 8.6e10 random reductions
// a second into a 4 MiB vector (chip_smoke.py phase 9 measures it with
// degree_l2_probe_kernel), so a batch's 2^21 random dst ids alone take some
// 24 us, and on one address about 1.3e9 a second, so a hub's ids serialize.
// Partitioning the ids by vertex range into shared-memory counters cost
// more than it saved on the card (three passes of shared atomics and the
// ranges' offsets), so the kernel keeps one reduction an id and feeds the
// L2 fewer of them (PERF.md §6 has its split, chip_smoke.py FOLD_SPLIT):
//   a persistent grid, kFoldBlocksPerSm blocks an SM; a warp takes 128
//   consecutive rows, 4 a lane: 16-byte loads of src and dst
//   (evict-first) and a 4-byte load of the mask, the next chunk's loads
//   issued before this one's reductions;
//   runs of one id over those rows (a src-grouped batch, as the EF40 wire
//   decodes, holds each vertex's rows together) are added once, by the
//   lane that holds the run's first row: lengths inside a lane, then
//   across lanes by a segmented suffix sum over shuffles;
//   an id that two lanes of a warp hold at once is admitted into the
//   block's cache of hot ids (kHotSlots shared counters, two probes); a
//   hot id is counted there by shared atomics and added to deg once per
//   block at the end, so a hub costs a reduction a block, not one a row;
//   blocks whose cache is empty skip the lookups;
//   the reductions carry an L2 evict-last hint.
//
// The degree_dist_* kernels replace the lax.scan of degree_dist_update
// (gelly_streaming_tpu/library/degree_distribution.py:43-84): per event in
// order, the u then v vertex change, each emitting a (new degree, count) and
// an (old degree, count) histogram record.  JAX's index semantics are kept
// at the edge of the arrays: an index below 0 counts from the end once
// (i + C), a gather then clamps into [0, C) and a scatter outside it is
// dropped; so the histogram add of a degree >= C is dropped and its read
// clamps to hist[C - 1].  Deleting an absent vertex is a no-op; a transition
// to degree 0 emits only the old-degree record; a self-loop changes u, then
// v.
//
// The scan looks sequential, but each event touches the state only through
// two keyed cells, so it is two segmented scans.  Rows r = 2e + j (j = 0 for
// u, 1 for v) go through f_r(d) = max(d + a, 0): a is the event's sign, or 0
// where the row is masked or its vertex lies outside [0, C) (such a row
// still reads deg at its clamped index and writes nothing).  Grouped by
// that index, stably, f composes in closed form: with T the segmented
// inclusive sum of a seeded with d0 = deg[key] at the group's head and M the
// running minimum of T, the degree after a row is T - min(0, M).
//   degree_dist_keys_kernel: the grouping key of every row and a word of
//   its sign, mask bit and range bit; torch.sort (stable) groups the keys.
//   degree_dist_rows_kernel (stage 1): one 1024-row tile a block, 4 sorted
//   rows a thread in registers.  The block scans the (T, M, Q, head)
//   prefix with __shfl_up_sync and warp totals in shared memory; tiles are
//   chained by a decoupled look-back (tiles taken by ticket, each
//   publishing its aggregate, then its inclusive prefix), so a hub's group
//   may cross any number of tiles and the input is read once.  A tile that
//   holds a group head publishes its inclusive prefix at once, so the
//   look-back stops at the nearest such tile.  Each row gets its old and
//   new degrees and two emit flags, written in arrival order with the
//   records' degree fields and stage 2's keys.  deg is read at
//   each group head and written once at each group end, without atomics:
//   the end's tile waits on the head's tile, which read the cell before it
//   published.
//   degree_dist_counts_kernel (stage 2): the same skeleton over the 4B
//   record slots s = 4e + 2j + {0 new, 1 old}, grouped by their clamped
//   degree after a second stable torch.sort: each record's count is
//   hist[key] plus the segmented inclusive sum of the adds (+1 or -1
//   where stage 1 flagged the record, 0 for a degree >= C), in int32 with
//   wrap, and hist is written once at each group end.
// JAX adds in int32 and wraps at 2^31 before clamping to 0, which the
// closed form (int64) does not.  Q, d0 plus the group's additions, bounds
// every degree a group reaches; a group whose Q passes 2^31 - 1, or whose
// d0 is negative, is listed and walked in order by one thread after the
// scan (degree_dist_walk_kernel, the serial vertex change), so the result
// stays JAX's bit for bit there too.
//   Bound on the H100 (bytes): src, dst, sign and mask read (10 B an
// event), 8 int32 and 4 flags written (36 B an event), deg read and
// written once a touched vertex and hist once a touched degree (8 B each).
// For the bench's 2^21-event batch over 2^20 vertices (about 1.03M touched)
// that is about 105 MB, 31 us at 3.35 TB/s.  The two sorts, the sorted keys
// and the gathers through the sorts' permutations are the design's overhead
// over that bound.
//
// degree_dist_scan_serial_kernel is the first design: one thread walking
// the batch with deg and hist in global memory, a chain of dependent L2
// round trips, about ten an event.  It is on no main path; chip_smoke.py
// and the CUDA tests hold the two-stage kernels against it.

#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRecordValue = (1 << 28) - 1;
constexpr unsigned kFull = 0xffffffffu;

// int32 addition with two's-complement wrap (XLA's int32 semantics)
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// JAX's index normalisation: i < 0 counts from the end once
__device__ __forceinline__ int jax_index(int i, int size) { return i < 0 ? i + size : i; }

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

// ---------------------------------------------------------------------------
// the degree fold

constexpr int kHotLog = 10;
constexpr int kHotSlots = 1 << kHotLog;  // a block's cache of hot ids
constexpr int kFoldBlocksPerSm = 2;

__device__ __forceinline__ void red_hint(int* p, int v, uint64_t policy) {
  asm volatile("red.global.add.L2::cache_hint.s32 [%0], %1, %2;" ::"l"(p), "r"(v), "l"(policy) : "memory");
}

__device__ __forceinline__ int hot_slot(int id) {
  return static_cast<int>((static_cast<unsigned>(id) * 2654435761u) >> (32 - kHotLog));
}

// A lane's 4 consecutive rows of one array (x: ids after JAX's rule, ok:
// valid and in [0, C)): cnt[k] = the rows the lane adds for slot k, the
// length of the run of one id that starts there, or 0 where the slot
// continues a run that an earlier slot adds (in this lane or one to its
// left; runs end at the warp's 128 rows).
__device__ __forceinline__ void run_counts(const int* x, const bool* ok, int* cnt) {
  const int lane = threadIdx.x & 31;
  const int px = __shfl_up_sync(kFull, x[3], 1);
  const bool pok = __shfl_up_sync(kFull, ok[3], 1);
  bool cont[4];
  cont[0] = lane > 0 && ok[0] && pok && px == x[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) cont[k] = ok[k] && ok[k - 1] && x[k] == x[k - 1];
  int len = 0;
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    len = ok[k] ? ((k < 3 && cont[k + 1]) ? len + 1 : 1) : 0;
    cnt[k] = (ok[k] && !cont[k]) ? len : 0;
  }
  // lanes whose first rows continue the lane to their left
  const int lead = cont[0] ? (cont[1] ? (cont[2] ? (cont[3] ? 4 : 3) : 2) : 1) : 0;
  const int next_lead = __shfl_down_sync(kFull, lead, 1);
  const bool open = lane < 31 && next_lead > 0;
  if (!__any_sync(kFull, open)) return;
  // acc: the rows to the right that continue this lane's last run (a
  // segmented suffix sum: a lane continued whole passes on the next one's)
  int acc = open ? next_lead : 0;
  bool more = open && next_lead == 4;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int acc_n = __shfl_down_sync(kFull, acc, d);
    const bool more_n = __shfl_down_sync(kFull, more, d);
    if (more && lane + d < 32) acc += acc_n, more = more_n;
  }
  // the lane's last head takes them when its run reaches slot 3
  int last = -1;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (ok[k] && !cont[k]) last = k;
  bool reaches = last >= 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (k > last && !cont[k]) reaches = false;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (k == last && reaches) cnt[k] += acc;
}

// A warp's 128 rows from chunk c: a lane's 4 src then 4 dst ids and its
// 4 mask bytes (16-byte and 4-byte loads where aligned and whole).
__device__ __forceinline__ void load_rows(const int* __restrict__ src, const int* __restrict__ dst,
                                          const uint8_t* __restrict__ mask, int n, int64_t c, bool vec, int* ids,
                                          unsigned* mb) {
  const int64_t e0 = 128 * c + 4 * (threadIdx.x & 31);
  if (vec && e0 + 4 <= n) {
    const int4 s4 = __ldcs(reinterpret_cast<const int4*>(src + e0));
    const int4 d4 = __ldcs(reinterpret_cast<const int4*>(dst + e0));
    ids[0] = s4.x, ids[1] = s4.y, ids[2] = s4.z, ids[3] = s4.w;
    ids[4] = d4.x, ids[5] = d4.y, ids[6] = d4.z, ids[7] = d4.w;
    *mb = mask == nullptr ? 0x01010101u : __ldcs(reinterpret_cast<const unsigned*>(mask + e0));
    return;
  }
  *mb = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool in = e0 + k < n;
    ids[k] = in ? __ldg(src + e0 + k) : 0;
    ids[4 + k] = in ? __ldg(dst + e0 + k) : 0;
    if (in && (mask == nullptr || mask[e0 + k] != 0)) *mb |= 1u << (8 * k);
  }
}

// A persistent grid; a warp folds 128 rows at a time, the next chunk's
// loads in flight under this one's reductions.
__global__ void __launch_bounds__(kThreads)
degree_fold_kernel(int* __restrict__ deg, const int* __restrict__ src, const int* __restrict__ dst,
                   const uint8_t* __restrict__ mask, int n, int capacity) {
  __shared__ int hot_keys[kHotSlots];
  __shared__ unsigned hot_counts[kHotSlots];
  __shared__ int any_hot;
  for (int h = threadIdx.x; h < kHotSlots; h += kThreads) hot_keys[h] = -1, hot_counts[h] = 0;
  if (threadIdx.x == 0) any_hot = 0;
  __syncthreads();
  uint64_t keep;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  const int lane = threadIdx.x & 31;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(mask) & 3) == 0;
  const int64_t chunks = (static_cast<int64_t>(n) + 127) / 128;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  int64_t c = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) + (threadIdx.x >> 5);
  int next[8];
  unsigned next_mb = 0;
  if (c < chunks) load_rows(src, dst, mask, n, c, vec, next, &next_mb);
  for (; c < chunks; c += warps) {
    int ids[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) ids[k] = next[k];
    const unsigned mb = next_mb;
    if (c + warps < chunks) load_rows(src, dst, mask, n, c + warps, vec, next, &next_mb);
    // JAX's scatter rule: below 0 counts from the end once, then drop
    int v[8], cnt[8];
    bool ok[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = jax_index(ids[k], capacity);
      ok[k] = ((mb >> (8 * (k & 3))) & 0xffu) != 0 && static_cast<unsigned>(v[k]) < static_cast<unsigned>(capacity);
    }
    run_counts(v, ok, cnt);
    run_counts(v + 4, ok + 4, cnt + 4);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const bool has = cnt[k] > 0;
      // an id that two lanes hold in this slot is admitted to the cache
      const unsigned act = __ballot_sync(kFull, has);
      if (act != 0) {
        const int leader = __ffs(act) - 1;
        const int cand = __shfl_sync(kFull, v[k], leader);
        const unsigned peers = __ballot_sync(kFull, has && v[k] == cand);
        if (lane == leader && __popc(peers) > 1) {
          const int h = hot_slot(cand);
          const int was = atomicCAS(hot_keys + h, -1, cand);
          if (was == -1 || was == cand || atomicCAS(hot_keys + (h ^ (kHotSlots / 2)), -1, cand) == -1)
            any_hot = 1;
        }
        __syncwarp();
      }
      if (!has) continue;
      if (*static_cast<volatile int*>(&any_hot)) {
        const int h = hot_slot(v[k]);
        if (hot_keys[h] == v[k]) {
          atomicAdd(hot_counts + h, static_cast<unsigned>(cnt[k]));
          continue;
        }
        if (hot_keys[h ^ (kHotSlots / 2)] == v[k]) {
          atomicAdd(hot_counts + (h ^ (kHotSlots / 2)), static_cast<unsigned>(cnt[k]));
          continue;
        }
      }
      red_hint(deg + v[k], cnt[k], keep);
    }
  }
  __syncthreads();
  for (int h = threadIdx.x; h < kHotSlots; h += kThreads)
    if (hot_counts[h] != 0) red_hint(deg + hot_keys[h], static_cast<int>(hot_counts[h]), keep);
}

// The L2's reduction rate, for chip_smoke.py: `count` reductions of 1 into
// deg at hashed indices (mask = size - 1, a power of two; 0 puts every one
// on deg[0]).  On no path.
__global__ void __launch_bounds__(kThreads)
degree_l2_probe_kernel(int* __restrict__ deg, unsigned mask, long long count) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < count; i += stride)
    atomicAdd(deg + ((static_cast<unsigned>(i) * 2654435761u) & mask), 1);
}

// One vertex change of degree_dist_update on the degree cell alone: the
// old and new degrees, whether the cell takes the new one, the emit flags.
struct Change {
  int old, next;
  bool ok, emit_new, emit_old;
};

__device__ __forceinline__ Change degree_change(int old, int delta, bool ok) {
  ok = ok && !(delta < 0 && old <= 0);
  int next = wrap_add(old, delta);
  next = next < 0 ? 0 : next;
  return {old, next, ok, ok && next > 0, ok && old > 0};
}

// One vertex change of degree_dist_update: recs gets (new, hist[new]) then
// (old, hist[old]); rmask their emit flags.
__device__ __forceinline__ void vertex_change(int* __restrict__ deg, int* __restrict__ hist,
                                              int capacity, int v, int delta, bool ok,
                                              int* __restrict__ recs, uint8_t* __restrict__ rmask) {
  v = jax_index(v, capacity);
  const int old = deg[clamp_index(v, capacity)];
  const Change c = degree_change(old, delta, ok);
  if (static_cast<unsigned>(v) < static_cast<unsigned>(capacity))
    deg[v] = c.ok ? c.next : old;
  if (c.emit_new && c.next < capacity) hist[c.next] = wrap_add(hist[c.next], 1);
  recs[0] = c.next;
  recs[1] = hist[clamp_index(c.next, capacity)];
  if (c.emit_old && old < capacity) hist[old] = wrap_add(hist[old], -1);
  recs[2] = old;
  recs[3] = hist[clamp_index(jax_index(old, capacity), capacity)];
  rmask[0] = c.emit_new;
  rmask[1] = c.emit_old;
}

// recs: int32[n, 4, 2]; rmask: uint8[n, 4]; sign: int8[n] or null (all +1);
// mask: uint8[n] or null (all valid).  One thread.
__global__ void degree_dist_scan_serial_kernel(int* __restrict__ deg, int* __restrict__ hist, int capacity,
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

// ---------------------------------------------------------------------------
// the two-stage scan

constexpr int kScanItems = 4;                     // sorted rows a thread holds
constexpr int kTile = kThreads * kScanItems;      // rows a block scans
constexpr int kWarps = kThreads / 32;
constexpr long long kInf = 1LL << 62;             // the empty prefix's minimum
constexpr long long kUnsafe = 1LL << 40;          // Q of a group with d0 < 0
constexpr long long kInt32Max = 2147483647LL;

// Stage 1's prefix: t = T (seeded with d0 at the head), m = min T, q = Q,
// h = a head lies inside.  combine(a, b) is a followed by b.
struct Walk {
  long long t, m, q;
  int h;
};

__device__ __forceinline__ Walk walk_identity() { return {0, kInf, 0, 0}; }

__device__ __forceinline__ Walk combine(const Walk& a, const Walk& b) {
  if (b.h) return b;
  return {a.t + b.t, a.m < a.t + b.m ? a.m : a.t + b.m, a.q + b.q, a.h};
}

__device__ __forceinline__ Walk shfl_up(const Walk& v, int d) {
  return {__shfl_up_sync(kFull, v.t, d), __shfl_up_sync(kFull, v.m, d), __shfl_up_sync(kFull, v.q, d),
          __shfl_up_sync(kFull, v.h, d)};
}

// a tile status written by another block: read past the L1
__device__ __forceinline__ Walk load_cg(const Walk* p) {
  return {__ldcg(&p->t), __ldcg(&p->m), __ldcg(&p->q), __ldcg(&p->h)};
}

// the degree after a prefix that holds its group's head
__device__ __forceinline__ long long walk_degree(const Walk& w) { return w.t - (w.m < 0 ? w.m : 0); }

// Stage 2's prefix: the segmented int32 sum (seeded with hist[key]).
struct Count {
  int s, h;
};

__device__ __forceinline__ Count count_identity() { return {0, 0}; }

__device__ __forceinline__ Count combine(const Count& a, const Count& b) {
  if (b.h) return b;
  return {wrap_add(a.s, b.s), a.h};
}

__device__ __forceinline__ Count shfl_up(const Count& v, int d) {
  return {__shfl_up_sync(kFull, v.s, d), __shfl_up_sync(kFull, v.h, d)};
}

__device__ __forceinline__ Count load_cg(const Count* p) { return {__ldcg(&p->s), __ldcg(&p->h)}; }

// Exclusive scan of one value a thread across the block, in thread order;
// *total gets the block's reduction.  warp_tot: shared, kWarps entries.
template <typename S>
__device__ __forceinline__ S block_exclusive(S v, S identity, S* warp_tot, S* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  S inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const S up = shfl_up(inc, d);
    if (lane >= d) inc = combine(up, inc);
  }
  S exc = shfl_up(inc, 1);
  if (lane == 0) exc = identity;
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  S pre = identity;
  S all = identity;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) pre = all;
    all = combine(all, warp_tot[w]);
  }
  *total = all;
  return combine(pre, exc);
}

// The tiles' statuses for the decoupled look-back, in the caller's scratch
// (flags zeroed before the launch): flag 1 = aggregate published, 2 =
// inclusive prefix published.
template <typename S>
struct Tiles {
  int* ticket;  // the next tile to hand out, in launch order
  int* flags;
  S* aggs;
  S* incls;
};

// Thread 0 of each block: publish the tile's total and return the prefix
// of the tiles before it.  A tile holding a group head publishes its
// inclusive prefix at once (a head resets the scan), so the look-back
// stops at the nearest such tile; only a group across many tiles (a hub)
// walks further.  Tiles are taken by ticket, so every tile waited on is
// held by a block that already runs.
template <typename S>
__device__ S tile_prefix(const Tiles<S>& st, int tile, const S& total, S identity) {
  volatile int* flags = st.flags;
  if (tile == 0 || total.h) {
    st.incls[tile] = total;
    __threadfence();
    flags[tile] = 2;
    if (tile == 0) return identity;
  } else {
    st.aggs[tile] = total;
    __threadfence();
    flags[tile] = 1;
  }
  S prefix = identity;
  for (int j = tile - 1; j >= 0; --j) {
    int f;
    while ((f = flags[j]) == 0) {
    }
    __threadfence();
    if (f == 2) {
      prefix = combine(load_cg(st.incls + j), prefix);
      break;
    }
    prefix = combine(load_cg(st.aggs + j), prefix);
  }
  if (!total.h) {
    st.incls[tile] = combine(prefix, total);
    __threadfence();
    flags[tile] = 2;
  }
  return prefix;
}

// One sorted row of stage 1.  words[r]: the row's sign (low byte), mask
// (bit 8) and whether its vertex lies in [0, C) (bit 9).
struct Row {
  int key, r, a, d0;
  bool valid, ok_mask, in_range, head, end;
};

__device__ __forceinline__ Row load_row(int64_t p, int rows, const int* __restrict__ keys,
                                        const int64_t* __restrict__ order, const int* __restrict__ words,
                                        const int* __restrict__ deg, bool read_head) {
  Row w{};
  w.valid = p < rows;
  if (!w.valid) return w;
  w.key = __ldg(keys + p);
  w.r = static_cast<int>(__ldg(order + p));
  const int word = __ldg(words + w.r);
  w.a = static_cast<int>(static_cast<int8_t>(word & 0xff));
  w.ok_mask = (word & 0x100) != 0;
  w.in_range = (word & 0x200) != 0;
  w.head = p == 0 || __ldg(keys + p - 1) != w.key;
  w.end = p + 1 == rows || __ldg(keys + p + 1) != w.key;
  w.d0 = (read_head && w.head) ? deg[w.key] : 0;
  return w;
}

__device__ __forceinline__ Walk row_walk(const Row& w) {
  if (!w.valid) return walk_identity();
  const long long a = (w.ok_mask && w.in_range) ? w.a : 0;
  const long long seed = w.head ? w.d0 : 0;
  const long long qseed = w.head ? (w.d0 < 0 ? kUnsafe : w.d0) : 0;
  return {a + seed, a + seed, (a > 0 ? a : 0) + qseed, w.head ? 1 : 0};
}

// A row's outputs: the records' degree fields (the count fields are stage
// 2's, written later) and flags in arrival order, and stage 2's keys.
__device__ __forceinline__ void row_out(const Row& w, const Change& c, int capacity, int* __restrict__ recs,
                                        uint8_t* __restrict__ rmask, int* __restrict__ key2) {
  const int r = w.r;
  reinterpret_cast<int4*>(recs)[r] = make_int4(c.next, 0, c.old, 0);
  reinterpret_cast<uint16_t*>(rmask)[r] =
      static_cast<uint16_t>((c.emit_new ? 1u : 0u) | (c.emit_old ? 0x100u : 0u));
  reinterpret_cast<int2*>(key2)[r] =
      make_int2(clamp_index(c.next, capacity), clamp_index(jax_index(c.old, capacity), capacity));
}

// Stage 1, one tile a block.  keys: int32[rows] sorted, order: int64[rows]
// the sort's permutation of the rows r = 2e + j; words: int32[rows];
// recs/rmask as the serial kernel's; key2: int32[2 * rows]; list: int32[rows], the last sorted positions of the
// groups left to degree_dist_walk_kernel, *listed of them.
__global__ void __launch_bounds__(kThreads)
degree_dist_rows_kernel(int* __restrict__ deg, int capacity, const int* __restrict__ keys,
                        const int64_t* __restrict__ order, const int* __restrict__ words, int rows,
                        int* __restrict__ recs, uint8_t* __restrict__ rmask, int* __restrict__ key2,
                        Tiles<Walk> st, int* __restrict__ listed,
                        int* __restrict__ list) {
  __shared__ Walk warp_tot[kWarps];
  __shared__ Walk prefix;
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(st.ticket, 1);
  __syncthreads();
  const int64_t base = static_cast<int64_t>(tile_s) * kTile + threadIdx.x * kScanItems;
  Row w[kScanItems];
  Walk mine = walk_identity();
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    w[i] = load_row(base + i, rows, keys, order, words, deg, true);
    mine = combine(mine, row_walk(w[i]));
  }
  Walk total;
  const Walk exc = block_exclusive(mine, walk_identity(), warp_tot, &total);
  if (threadIdx.x == 0) prefix = tile_prefix(st, tile_s, total, walk_identity());
  __syncthreads();
  Walk state = combine(prefix, exc);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (!w[i].valid) continue;
    const int old = w[i].head ? w[i].d0 : static_cast<int>(walk_degree(state));
    state = combine(state, row_walk(w[i]));
    row_out(w[i], degree_change(old, w[i].a, w[i].ok_mask), capacity, recs, rmask, key2);
    if (!w[i].end) continue;
    // the group's head tile read deg[key] before it published, and this
    // tile saw that publication: the one write comes after the one read
    if (state.q > kInt32Max)
      list[atomicAdd(listed, 1)] = static_cast<int>(base + i);
    else
      deg[w[i].key] = static_cast<int>(walk_degree(state));
  }
}

// The groups degree_dist_rows_kernel listed, each walked in order by one
// thread from its deg cell, which no one wrote: JAX's int32 vertex change.
__global__ void __launch_bounds__(kThreads)
degree_dist_walk_kernel(int* __restrict__ deg, int capacity, const int* __restrict__ keys,
                        const int64_t* __restrict__ order, const int* __restrict__ words, int rows,
                        int* __restrict__ recs, uint8_t* __restrict__ rmask, int* __restrict__ key2,
                        const int* __restrict__ listed, const int* __restrict__ list) {
  const int count = *listed;
  for (int g = blockIdx.x * kThreads + threadIdx.x; g < count; g += gridDim.x * kThreads) {
    const int64_t last = list[g];
    const int key = __ldg(keys + last);
    int d = deg[key];
    for (int64_t p = segment_start(keys, last, key); p <= last; ++p) {
      const Row w = load_row(p, rows, keys, order, words, deg, false);
      const Change c = degree_change(d, w.a, w.ok_mask);
      row_out(w, c, capacity, recs, rmask, key2);
      if (w.in_range && c.ok) d = c.next;
    }
    deg[key] = d;
  }
}

// A slot's histogram add: +1 (new) or -1 (old) where emitted, 0 where the
// degree is >= C (JAX drops the scatter); the degree is read only where
// the clamped key leaves it open.
__device__ __forceinline__ int slot_add(int s, int key, int capacity, const uint8_t* __restrict__ rmask,
                                        const int* __restrict__ recs) {
  if (__ldg(rmask + s) == 0) return 0;
  if (key == capacity - 1 && recs[2 * s] >= capacity) return 0;
  return (s & 1) ? -1 : 1;
}

// Stage 2, one tile a block.  keys: int32[slots] sorted (the clamped
// degrees), order: int64[slots] the sort's permutation of the slots; rmask:
// stage 1's flags; recs: stage 1's degree fields read, the count fields
// written here.
__global__ void __launch_bounds__(kThreads)
degree_dist_counts_kernel(int* __restrict__ hist, int capacity, const int* __restrict__ keys,
                          const int64_t* __restrict__ order, const uint8_t* __restrict__ rmask, int slots,
                          int* __restrict__ recs, Tiles<Count> st) {
  __shared__ Count warp_tot[kWarps];
  __shared__ Count prefix;
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(st.ticket, 1);
  __syncthreads();
  const int64_t base = static_cast<int64_t>(tile_s) * kTile + threadIdx.x * kScanItems;
  int key[kScanItems], s[kScanItems];
  bool end[kScanItems];
  Count c[kScanItems];
  Count mine = count_identity();
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t p = base + i;
    c[i] = count_identity();
    end[i] = false;
    if (p < slots) {
      key[i] = __ldg(keys + p);
      s[i] = static_cast<int>(__ldg(order + p));
      const bool head = p == 0 || __ldg(keys + p - 1) != key[i];
      end[i] = p + 1 == slots || __ldg(keys + p + 1) != key[i];
      c[i] = {wrap_add(slot_add(s[i], key[i], capacity, rmask, recs), head ? hist[key[i]] : 0), head ? 1 : 0};
    }
    mine = combine(mine, c[i]);
  }
  Count total;
  const Count exc = block_exclusive(mine, count_identity(), warp_tot, &total);
  if (threadIdx.x == 0) prefix = tile_prefix(st, tile_s, total, count_identity());
  __syncthreads();
  Count state = combine(prefix, exc);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    if (base + i >= slots) continue;
    state = combine(state, c[i]);
    recs[2 * s[i] + 1] = state.s;
    if (end[i]) hist[key[i]] = state.s;
  }
}

__device__ __forceinline__ int range_bit(int x, int size) {
  return static_cast<unsigned>(x) < static_cast<unsigned>(size) ? 0x200 : 0;
}

// grouping keys and row words of the rows r = 2e + j
__global__ void __launch_bounds__(kThreads)
degree_dist_keys_kernel(const int* __restrict__ src, const int* __restrict__ dst, const int8_t* __restrict__ sign,
                        const uint8_t* __restrict__ mask, int n, int capacity, int* __restrict__ keys,
                        int* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; e < n; e += stride) {
    const int u = jax_index(__ldg(src + e), capacity);
    const int v = jax_index(__ldg(dst + e), capacity);
    const int a = (sign == nullptr ? 1 : static_cast<int>(__ldg(sign + e))) & 0xff;
    const int m = (mask == nullptr || __ldg(mask + e) != 0) ? 0x100 : 0;
    reinterpret_cast<int2*>(keys)[e] = make_int2(clamp_index(u, capacity), clamp_index(v, capacity));
    reinterpret_cast<int2*>(words)[e] = make_int2(a | m | range_bit(u, capacity), a | m | range_bit(v, capacity));
  }
}

// ---------------------------------------------------------------------------
// the degree trace

// The trace scan's prefix: base = counts[v] read at the last id head, c =
// rows since the last key head (the rank + 1), h / k = an id head / a key
// head lies inside.  combine(a, b) is a followed by b.
struct Trace {
  int base, c, h, k;
};

__device__ __forceinline__ Trace trace_identity() { return {0, 0, 0, 0}; }

__device__ __forceinline__ Trace combine(const Trace& a, const Trace& b) {
  return {b.h ? b.base : a.base, b.k ? b.c : a.c + b.c, a.h | b.h, a.k | b.k};
}

__device__ __forceinline__ Trace shfl_up(const Trace& v, int d) {
  return {__shfl_up_sync(kFull, v.base, d), __shfl_up_sync(kFull, v.c, d), __shfl_up_sync(kFull, v.h, d),
          __shfl_up_sync(kFull, v.k, d)};
}

__device__ __forceinline__ Trace load_cg(const Trace* p) {
  return {__ldcg(&p->base), __ldcg(&p->c), __ldcg(&p->h), __ldcg(&p->k)};
}

// Every id of the sorted keys lies in [0, C): no two ids share a counts
// cell, and the scan may write counts itself.
__device__ __forceinline__ bool ids_in_range(const int* __restrict__ keys, int n, int capacity) {
  return __ldg(keys) >= 0 && (__ldg(keys + n - 1) >> 1) < capacity;
}

// keys: int32[n], the grouping keys 2v + !m in stable sorted order; order:
// int64[n], the sort's permutation; counts: int32[capacity], read at each
// id's head and (ids in range) written at the end of its valid rows;
// emitted: int32[n] in arrival order.
__global__ void __launch_bounds__(kThreads)
degree_trace_scan_kernel(const int* __restrict__ keys, const int64_t* __restrict__ order, int n,
                         int* __restrict__ counts, int capacity, int* __restrict__ emitted, Tiles<Trace> st) {
  __shared__ Trace warp_tot[kWarps];
  __shared__ Trace prefix;
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(st.ticket, 1);
  __syncthreads();
  const bool write = ids_in_range(keys, n, capacity);
  const int64_t base = static_cast<int64_t>(tile_s) * kTile + threadIdx.x * kScanItems;
  int key[kScanItems + 1];  // key[i + 1] is row base + i's; key[0] the row before
  key[0] = base > 0 && base <= n ? __ldg(keys + base - 1) : 0;
  if (base + kScanItems <= n && (reinterpret_cast<uintptr_t>(keys) & 15) == 0) {
    const int4 k4 = __ldg(reinterpret_cast<const int4*>(keys + base));
    key[1] = k4.x, key[2] = k4.y, key[3] = k4.z, key[4] = k4.w;
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) key[i + 1] = base + i < n ? __ldg(keys + base + i) : 0;
  }
  uint64_t keep;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
  int64_t ord[kScanItems];
  if (base + kScanItems <= n && (reinterpret_cast<uintptr_t>(order) & 15) == 0) {
    const longlong2 o0 = __ldcs(reinterpret_cast<const longlong2*>(order + base));
    const longlong2 o1 = __ldcs(reinterpret_cast<const longlong2*>(order + base + 2));
    ord[0] = o0.x, ord[1] = o0.y, ord[2] = o1.x, ord[3] = o1.y;
  } else {
#pragma unroll
    for (int i = 0; i < kScanItems; ++i) ord[i] = base + i < n ? __ldcs(order + base + i) : 0;
  }
  Trace t[kScanItems];
  Trace mine = trace_identity();
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t p = base + i;
    t[i] = trace_identity();
    if (p < n) {
      const int k = key[i + 1];
      const bool id_head = p == 0 || (key[i] >> 1) != (k >> 1);
      t[i] = {id_head ? counts[clamp_index(jax_index(k >> 1, capacity), capacity)] : 0, 1, id_head ? 1 : 0,
              (p == 0 || key[i] != k) ? 1 : 0};
    }
    mine = combine(mine, t[i]);
  }
  Trace total;
  const Trace exc = block_exclusive(mine, trace_identity(), warp_tot, &total);
  if (threadIdx.x == 0) prefix = tile_prefix(st, tile_s, total, trace_identity());
  __syncthreads();
  Trace state = combine(prefix, exc);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    const int64_t p = base + i;
    if (p >= n) break;
    state = combine(state, t[i]);
    const int e = wrap_add(state.base, state.c);  // counts[v] + rank + 1
    asm volatile("st.global.L2::cache_hint.b32 [%0], %1, %2;" ::"l"(emitted + ord[i]), "r"(e), "l"(keep) : "memory");
    // the last valid row of an id: its cell takes the rows' count; the
    // id's head tile read the cell before it published, and this tile saw
    // that publication
    const int k = key[i + 1];
    if (write && (k & 1) == 0 && (p + 1 == n || __ldg(keys + p + 1) != k)) counts[k >> 1] = e;
  }
}

__device__ __forceinline__ unsigned record_lo(int id, int e) {
  const unsigned val = static_cast<unsigned>(e < 0 ? 0 : (e > kMaxRecordValue ? kMaxRecordValue : e));
  return static_cast<unsigned>(id) | ((val & 0xFFFu) << 20);
}

__device__ __forceinline__ unsigned record_hi(int e) {
  return static_cast<unsigned>(e < 0 ? 0 : (e > kMaxRecordValue ? kMaxRecordValue : e)) >> 12;
}

// In arrival order, 8 rows a thread: the records (packed: uint8[6n], or
// null for the raw form) and mask bits (uint8[(n + 7) / 8]) of v, m and the
// scan's emitted values; with an id outside [0, C) in the batch, the counts
// adds (JAX's scatter rule) after every read of the scan.
__global__ void __launch_bounds__(kThreads)
degree_trace_pack_kernel(const int* __restrict__ v, const uint8_t* __restrict__ m, const int* __restrict__ keys,
                         const int* __restrict__ emitted, int n, int* __restrict__ counts, int capacity,
                         uint8_t* __restrict__ packed, uint8_t* __restrict__ maskbits) {
  const bool add = !ids_in_range(keys, n, capacity);
  if (packed == nullptr && !add) return;
  const bool vec = ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(emitted)) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(m) & 7) == 0;
  const int64_t groups = (static_cast<int64_t>(n) + 7) / 8;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups; g += stride) {
    const int64_t r0 = 8 * g;
    int id[8], e[8];
    uint8_t mb[8];
    if (vec && r0 + 8 <= n) {
      const int4 v0 = __ldcs(reinterpret_cast<const int4*>(v + r0));
      const int4 v1 = __ldcs(reinterpret_cast<const int4*>(v + r0 + 4));
      const int4 e0 = __ldcs(reinterpret_cast<const int4*>(emitted + r0));
      const int4 e1 = __ldcs(reinterpret_cast<const int4*>(emitted + r0 + 4));
      const uint2 m8 = __ldcs(reinterpret_cast<const uint2*>(m + r0));
      id[0] = v0.x, id[1] = v0.y, id[2] = v0.z, id[3] = v0.w, id[4] = v1.x, id[5] = v1.y, id[6] = v1.z, id[7] = v1.w;
      e[0] = e0.x, e[1] = e0.y, e[2] = e0.z, e[3] = e0.w, e[4] = e1.x, e[5] = e1.y, e[6] = e1.z, e[7] = e1.w;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        mb[b] = static_cast<uint8_t>(m8.x >> (8 * b));
        mb[b + 4] = static_cast<uint8_t>(m8.y >> (8 * b));
      }
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const bool in = r0 + b < n;
        id[b] = in ? __ldg(v + r0 + b) : 0;
        e[b] = in ? __ldcg(emitted + r0 + b) : 0;
        mb[b] = in ? __ldg(m + r0 + b) : 0;
      }
    }
    if (add) {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int c = jax_index(id[b], capacity);
        if (mb[b] != 0 && static_cast<unsigned>(c) < static_cast<unsigned>(capacity)) atomicAdd(counts + c, 1);
      }
    }
    if (packed == nullptr) continue;
    unsigned bits = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) bits |= (mb[b] != 0 ? 1u : 0u) << b;
    maskbits[g] = static_cast<uint8_t>(bits);
    if (r0 + 8 <= n) {
      // records 2j and 2j + 1 fill three 32-bit words: lo0, hi0 | lo1 << 16,
      // lo1 >> 16 | hi1 << 16
      unsigned w[12];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned lo0 = record_lo(id[2 * j], e[2 * j]), lo1 = record_lo(id[2 * j + 1], e[2 * j + 1]);
        w[3 * j] = lo0;
        w[3 * j + 1] = record_hi(e[2 * j]) | (lo1 << 16);
        w[3 * j + 2] = (lo1 >> 16) | (record_hi(e[2 * j + 1]) << 16);
      }
      auto* out = reinterpret_cast<uint4*>(packed + 6 * r0);
      __stcs(out, make_uint4(w[0], w[1], w[2], w[3]));
      __stcs(out + 1, make_uint4(w[4], w[5], w[6], w[7]));
      __stcs(out + 2, make_uint4(w[8], w[9], w[10], w[11]));
    } else {
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (r0 + b >= n) break;
        const unsigned lo = record_lo(id[b], e[b]), hi = record_hi(e[b]);
        uint8_t* rec = packed + 6 * (r0 + b);
        rec[0] = lo & 0xFF, rec[1] = (lo >> 8) & 0xFF, rec[2] = (lo >> 16) & 0xFF, rec[3] = lo >> 24;
        rec[4] = hi & 0xFF, rec[5] = hi >> 8;
      }
    }
  }
}

// The SM count and `kernel`'s blocks an SM (kThreads a block) on the
// current device, queried once a kernel and device: they do not change,
// and the queries cost more host time than a launch.
int resident_blocks(const void* kernel, int* sms, cudaError_t* err) {
  struct Fit {
    const void* kernel;
    int device, sms, per_sm;
  };
  static std::mutex mu;
  static Fit cache[64];
  static int cached = 0;
  int device = 0;
  if ((*err = cudaGetDevice(&device)) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < cached; ++i) {
    if (cache[i].kernel == kernel && cache[i].device == device) {
      *sms = cache[i].sms;
      return cache[i].per_sm;
    }
  }
  int per_sm = 0;
  if ((*err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) != cudaSuccess)
    return 0;
  if (cached < 64) cache[cached++] = {kernel, device, *sms, per_sm};
  return per_sm;
}

int grid_for(const void* kernel, int64_t items, cudaError_t* err) {
  int sms = 0;
  const int per_sm = resident_blocks(kernel, &sms, err);
  if (*err != cudaSuccess) return 0;
  // a grid-stride loop covers what does not fit
  const int64_t fit = static_cast<int64_t>(sms) * 4 * per_sm;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < fit ? blocks : fit;
  return static_cast<int>(blocks > 0 ? blocks : 1);
}

// The look-back scratch of a scan over `items`: the ticket and the listed
// count (8 B), one flag a tile, then (32 B aligned) the tiles' aggregates
// and inclusive prefixes.  header: the bytes to zero before the launch;
// used: where the caller's own part (stage 1's list) starts.
struct Layout {
  int64_t tiles, header, used;
};

template <typename S>
Layout layout_of(int64_t items) {
  const int64_t tiles = (items + kTile - 1) / kTile;
  const int64_t header = (8 + 4 * tiles + 31) / 32 * 32;
  return {tiles, header, header + 2 * tiles * static_cast<int64_t>(sizeof(S))};
}

template <typename S>
Layout tiles_in(void* scratch, int64_t items, Tiles<S>* st, int** listed) {
  const Layout l = layout_of<S>(items);
  auto* base = static_cast<uint8_t*>(scratch);
  st->ticket = reinterpret_cast<int*>(base);
  *listed = reinterpret_cast<int*>(base + 4);
  st->flags = reinterpret_cast<int*>(base + 8);
  st->aggs = reinterpret_cast<S*>(base + l.header);
  st->incls = st->aggs + l.tiles;
  return l;
}

// The scratch both stages of n events need: stage 1's look-back over 2n
// rows and its list of up to 2n rows, or stage 2's over 4n slots.
int64_t scan_scratch_bytes(int64_t n) {
  const int64_t one = layout_of<Walk>(2 * n).used + 4 * (2 * n);
  const int64_t two = layout_of<Count>(4 * n).used;
  return one > two ? one : two;
}

}  // namespace

extern "C" {

// The bytes of scratch degree_trace_launch needs for n rows: the scan's
// look-back, then the staged emitted values (int32[n]).
long long degree_trace_scratch_bytes(int n) {
  return n > 0 ? layout_of<Trace>(n).used + 4 * static_cast<int64_t>(n) : 0;
}

// v: int32[n] (|v| < 2^30); m: uint8[n]; keys: int32[n], the grouping keys
// 2v + !m in stable sorted order; order: int64[n], the sort's permutation;
// counts: int32[capacity], updated in place; packed: uint8[6n] and
// maskbits: uint8[(n + 7) / 8] (both null for the raw form); emitted:
// int32[n] (null for the packed form); scratch: degree_trace_scratch_bytes(n)
// bytes.  The scan kernel, then the pack kernel, on the stream, no host
// sync.
int degree_trace_launch(const void* v, const void* m, const void* keys, const void* order, int n, void* counts,
                        int capacity, void* packed, void* maskbits, void* emitted, void* scratch,
                        long long scratch_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  if (scratch_bytes < degree_trace_scratch_bytes(n) || (packed == nullptr) == (emitted == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Tiles<Trace> st;
  int* unused;
  const Layout l = tiles_in(scratch, n, &st, &unused);
  int* out = packed != nullptr ? reinterpret_cast<int*>(static_cast<uint8_t*>(scratch) + l.used)
                               : static_cast<int*>(emitted);
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.header, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* keys_i = static_cast<const int*>(keys);
  auto* counts_i = static_cast<int*>(counts);
  degree_trace_scan_kernel<<<(n + kTile - 1) / kTile, kThreads, 0, s>>>(
      keys_i, static_cast<const int64_t*>(order), n, counts_i, capacity, out, st);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int blocks = grid_for(reinterpret_cast<const void*>(degree_trace_pack_kernel), (n + 7) / 8, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  degree_trace_pack_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int*>(v), static_cast<const uint8_t*>(m), keys_i, out, n, counts_i, capacity,
      static_cast<uint8_t*>(packed), static_cast<uint8_t*>(maskbits));
  return static_cast<int>(cudaGetLastError());
}

// deg: int32[capacity], updated in place; src, dst: int32[n]; mask: uint8[n]
// or null.  One launch, kFoldBlocksPerSm blocks an SM (fewer blocks leave
// more rows to each block's cache of hot ids), fewer for a small batch.
int degree_fold_launch(void* deg, const void* src, const void* dst, const void* mask, int n,
                       int capacity, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  int sms = 0;
  resident_blocks(reinterpret_cast<const void*>(degree_fold_kernel), &sms, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t chunks = (static_cast<int64_t>(n) + 127) / 128;
  int64_t blocks = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t most = static_cast<int64_t>(sms) * kFoldBlocksPerSm;
  blocks = blocks < most ? blocks : most;
  degree_fold_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<int*>(deg), static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const uint8_t*>(mask), n, capacity);
  return static_cast<int>(cudaGetLastError());
}

// deg: int32[size] (size a power of two); `count` reductions of 1 at
// hashed indices (`spread` 0: all on deg[0]).  The L2 reduction-rate probe.
int degree_l2_probe_launch(void* deg, int size, int spread, long long count, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (size <= 0 || (size & (size - 1)) != 0 || count <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  const int blocks = grid_for(reinterpret_cast<const void*>(degree_l2_probe_kernel), count, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  degree_l2_probe_kernel<<<blocks, kThreads, 0, s>>>(static_cast<int*>(deg), spread ? size - 1u : 0u, count);
  return static_cast<int>(cudaGetLastError());
}

// deg, hist: int32[capacity], updated in place; src, dst: int32[n]; sign:
// int8[n] or null; mask: uint8[n] or null; recs: int32[n * 8]; rmask:
// uint8[n * 4].  The first design, one thread.
int degree_dist_scan_serial_launch(void* deg, void* hist, int capacity, const void* src, const void* dst,
                                   const void* sign, const void* mask, int n, void* recs, void* rmask,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  degree_dist_scan_serial_kernel<<<1, 1, 0, s>>>(
      static_cast<int*>(deg), static_cast<int*>(hist), capacity, static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const int8_t*>(sign),
      static_cast<const uint8_t*>(mask), n, static_cast<int*>(recs), static_cast<uint8_t*>(rmask));
  return static_cast<int>(cudaGetLastError());
}

// Stage 1: the keys and row words, then (after the caller's stable sort
// of the keys) the scan.  src, dst: int32[n]; sign: int8[n] or null; mask:
// uint8[n] or null; keys, words: int32[2n].
int degree_dist_keys_launch(const void* src, const void* dst, const void* sign, const void* mask, int n,
                            int capacity, void* keys, void* words, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  const int blocks = grid_for(reinterpret_cast<const void*>(degree_dist_keys_kernel), n, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  degree_dist_keys_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const int*>(src), static_cast<const int*>(dst), static_cast<const int8_t*>(sign),
      static_cast<const uint8_t*>(mask), n, capacity, static_cast<int*>(keys), static_cast<int*>(words));
  return static_cast<int>(cudaGetLastError());
}

// The bytes of scratch that degree_dist_rows_launch and
// degree_dist_counts_launch need for a batch of n events.
long long degree_dist_scratch_bytes(int n) { return n > 0 ? scan_scratch_bytes(n) : 0; }

// deg: int32[capacity], updated in place; keys: int32[2n] sorted, order:
// int64[2n] the stable sort's permutation; words: int32[2n]; recs, rmask as
// the serial launch's (the degree fields and the flags written here);
// key2: int32[4n]; scratch: degree_dist_scratch_bytes(n) bytes.
int degree_dist_rows_launch(void* deg, int capacity, const void* keys, const void* order, const void* words,
                            int n, void* recs, void* rmask, void* key2, void* scratch,
                            long long scratch_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  if (scratch_bytes < scan_scratch_bytes(n)) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = 2 * n;
  Tiles<Walk> st;
  int* listed;
  const Layout l = tiles_in(scratch, rows, &st, &listed);
  int* list = reinterpret_cast<int*>(static_cast<uint8_t*>(scratch) + l.used);
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.header, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* deg_i = static_cast<int*>(deg);
  auto* keys_i = static_cast<const int*>(keys);
  auto* order_l = static_cast<const int64_t*>(order);
  auto* words_i = static_cast<const int*>(words);
  auto* recs_i = static_cast<int*>(recs);
  auto* rmask_b = static_cast<uint8_t*>(rmask);
  auto* key2_i = static_cast<int*>(key2);
  degree_dist_rows_kernel<<<(rows + kTile - 1) / kTile, kThreads, 0, s>>>(
      deg_i, capacity, keys_i, order_l, words_i, rows, recs_i, rmask_b, key2_i, st, listed, list);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  degree_dist_walk_kernel<<<4, kThreads, 0, s>>>(deg_i, capacity, keys_i, order_l, words_i, rows, recs_i,
                                                 rmask_b, key2_i, listed, list);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2.  hist: int32[capacity], updated in place; keys: int32[4n] the
// sorted key2, order: int64[4n] the stable sort's permutation; rmask and
// recs: stage 1's, the count fields written here; scratch as stage 1's.
int degree_dist_counts_launch(void* hist, int capacity, const void* keys, const void* order, const void* rmask,
                              int n, void* recs, void* scratch, long long scratch_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || capacity <= 0) return static_cast<int>(cudaGetLastError());
  if (scratch_bytes < scan_scratch_bytes(n)) return static_cast<int>(cudaErrorInvalidValue);
  const int slots = 4 * n;
  Tiles<Count> st;
  int* listed;
  const Layout l = tiles_in(scratch, slots, &st, &listed);
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.header, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  degree_dist_counts_kernel<<<(slots + kTile - 1) / kTile, kThreads, 0, s>>>(
      static_cast<int*>(hist), capacity, static_cast<const int*>(keys), static_cast<const int64_t*>(order),
      static_cast<const uint8_t*>(rmask), slots, static_cast<int*>(recs), st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
