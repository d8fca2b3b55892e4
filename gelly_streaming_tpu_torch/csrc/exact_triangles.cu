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
// Design: the batch is folded in parallel against arrival-stamped rows,
// not chunk after chunk.  The sequential definition reduces to facts that
// need no chain (tests/test_torch_exact_plan.py models them in numpy and
// holds them equal to the JAX folds):
//   - rows only fill, so the entries that land in row x are the first
//     D - deg[x] of its ok entries in the JAX insert's order (chunk, role
//     (lo's entries before hi's), index), at slot deg[x] + their ordinal;
//   - hi enters lo's row only through the pair (lo, hi) itself, so a copy
//     of a pair is ok when it is the first of its pair in its chunk, the
//     pre-batch row lacks hi, and either it is the pair's first such copy
//     in the batch or that first copy did not land in lo's row (the row
//     was full: a repeat is counted again and lands in hi's row again);
//   - a repeat's entries sit after its lo row's fill point, and its hi
//     entry only moves rows of larger ids, so the repeats' ok set is the
//     least fixed point of "a repeat is ok when its pair's first copy did
//     not land", reached from "no repeat ok" in passes that only add
//     (one pass without overflow; a cascade over k ids takes k + 1);
//   - an edge's table at its chunk is the final table cut at deg + the ok
//     entries of earlier chunks, so once the slots are written each edge
//     counts alone.
// One C call a batch, its launches on the caller's stream:
//   memsets of the control words and the pair hash;
//   prep_kernel: canonical pairs, the first of each pair in its chunk
//   (shared memory), the membership of hi in lo's pre-batch row (a warp an
//   edge, lanes over the slots), the pair's first copy by a hash
//   (atomicMin), two stamped entries an edge; and the flag (below);
//   chain_kernel: one block walking the chunks in order (the fold's first,
//   simple form), run only on a flagged batch (it counts which path each
//   batch took);
//   settle_kernel (cooperative, grid-wide syncs between phases): a stable
//   LSD radix sort of the entries by row, 8-bit digits (per-tile
//   histograms, one block's scan, a scatter ranked by __match_any_sync);
//   then the fixed point, each pass a segmented scan of the ok entries
//   (a tile's scan, one block's scan of the tiles, the carries) and the
//   repeats' update; then the slots, deg, dropped, and each edge's valid
//   counts at its chunk (the ok entries of its row before its chunk's run);
//   count_kernel: the chunks' edges in shared memory, a warp an edge:
//   old-old by lane-held slots against shuffled slots of the other row,
//   old-new and new-new against the earlier edges of its chunk, counters
//   by atomics (wrapping adds commute);
//   trace only, trace_scan_kernel (cooperative): each edge's counter moves
//   as events (the common neighbors, then its two endpoints), radix-sorted
//   by vertex and scanned per vertex: (local[lo], local[hi]) after each
//   edge is the pre-batch counter plus the scan at its endpoint events;
//   the global trace is the scan of c.
// The flag: a batch in which some edge with mask and lo != hi has an id
// outside [0, C), a row of negative degree, or hi in lo's row past its
// degree takes the chain kernel, the exact path for JAX's odd index
// corners (-1 aliases C - 1; a stored -1 reads as empty); every other
// kernel exits at once on it.  The choice is made on the device; nothing
// is read back.
//   Bound on the H100 (bytes): the batch's edges read once (9 B an edge),
// the two rows each valid edge needs read once, the new slots, degrees
// and counters written once.  The design moves more: the sort's entries,
// the scans, and a row read by every edge that needs it.

#include <atomic>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <mutex>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxChunk = 256;  // ops/exact_triangles.MAX_CHUNK
constexpr int kChainThreads = 1024;
constexpr int kChainTraceThreads = 256;
constexpr int kStageCap = 160 * 1024;  // the chain kernel's staged rows' bytes at most
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;  // items a tile of the sort and the scans, 4 a thread
constexpr int kItems = kTile / kThreads;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;  // one a thread in the digit loops
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kEmpty = ~0ull;
constexpr int kCtrlWords = 64;
constexpr int kMaxDevices = 64;

static_assert(kDigits == kThreads, "the digit loops take one digit a thread");
static_assert(kMaxChunk <= kThreads, "a count block holds a whole chunk");

// the control words (cleared each call)
enum Ctrl { kFlag = 0, kValid = 1, kChanged = 2 /* 3 slots */, kGlobPre = 5 };
// the caller's counters across calls: batches by path, fixed-point passes
enum Stats { kParallel = 0, kChain = 1, kPassSum = 2, kPassMax = 3 };
// an edge's flags
enum { kCand = 1, kRepeat = 2 };

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

__device__ __forceinline__ int load_volatile(const int* p) { return *reinterpret_cast<const volatile int*>(p); }

// ---------------------------------------------------------------------------
// the scratch

struct Layout {
  size_t ctrl, hkeys, hvals, e_lo, e_hi, e_dlo, e_dhi, e_f, e_vlo, e_vhi, e_c, e_lpre, e_flags, e_ok, e_land, keys_in,
      skeys[2], svals[2], incl, hist, base, t_head, t_sum, t_carry, total;
  int padded, items, tiles, hslots;
};

// n edges in chunks of r (a trace: r = 1 and D + 2 events an edge); every
// piece 256-byte aligned (ops/exact_triangles.plan mirrors this)
Layout layout(int n, int max_degree, int r, int trace) {
  auto up = [](size_t x) { return (x + 255) & ~static_cast<size_t>(255); };
  Layout l;
  l.padded = n + (r - n % r) % r;
  const long long entries = 2LL * l.padded;
  const long long events = trace ? static_cast<long long>(l.padded) * (max_degree + 2) : 0;
  const long long items = entries > events ? entries : events;
  l.items = items < (1LL << 31) - kTile ? static_cast<int>(items) : -1;
  l.tiles = static_cast<int>((items + kTile - 1) / kTile);
  l.hslots = 64;
  while (l.hslots < 2 * l.padded) l.hslots *= 2;
  const size_t pe = static_cast<size_t>(l.padded) * 4, it = static_cast<size_t>(items) * 4,
               ti = static_cast<size_t>(l.tiles) * 4;
  size_t o = 0;
  auto take = [&](size_t bytes) {
    const size_t at = o;
    o += up(bytes);
    return at;
  };
  l.ctrl = take(kCtrlWords * 4);
  l.hkeys = take(static_cast<size_t>(l.hslots) * 8);
  l.hvals = take(static_cast<size_t>(l.hslots) * 4);
  l.e_lo = take(pe);
  l.e_hi = take(pe);
  l.e_dlo = take(pe);
  l.e_dhi = take(pe);
  l.e_f = take(pe);
  l.e_vlo = take(pe);
  l.e_vhi = take(pe);
  l.e_c = take(trace ? pe : 0);
  l.e_lpre = take(trace ? 2 * pe : 0);
  l.e_flags = take(l.padded);
  l.e_ok = take(l.padded);
  l.e_land = take(l.padded);
  l.keys_in = take(it);
  for (int b = 0; b < 2; ++b) {
    l.skeys[b] = take(it);
    l.svals[b] = take(it);
  }
  l.incl = take(it);
  l.hist = take(ti * kDigits);
  l.base = take(kDigits * 4);
  l.t_head = take(ti);
  l.t_sum = take(ti);
  l.t_carry = take(ti);
  l.total = o;
  return l;
}

// LSD radix passes over keys in [0, capacity)
int sort_passes(int capacity) {
  const unsigned span = static_cast<unsigned>(capacity - 1);
  int bits = 0;
  while (bits < 32 && (span >> bits) != 0) ++bits;
  const int p = (bits + kDigitBits - 1) / kDigitBits;
  return p > 1 ? p : 1;
}

struct State {
  int* nbrs;
  int* deg;
  int* dropped;
  int* local;
  int* glob;
};

struct Batch {
  const int* src;
  const int* dst;
  const uint8_t* mask;
  int n, padded, r, capacity, max_degree;
};

// the scratch's pieces, and the call's outputs
struct Work {
  int* ctrl;
  unsigned long long* hkeys;
  int* hvals;
  int hmask;
  int *e_lo, *e_hi, *e_dlo, *e_dhi, *e_f, *e_vlo, *e_vhi, *e_c, *e_lpre;
  uint8_t *e_flags, *e_ok, *e_land;
  int* keys_in;
  int* skeys[2];
  int* svals[2];
  unsigned* incl;
  int* hist;
  int* base;
  int* t_head;
  unsigned* t_sum;
  unsigned* t_carry;
  int passes;  // the sort's
  int* stats;
  int* trace_local;  // trace only
  int* trace_global;
};

Work work(const Layout& l, void* scratch, int capacity, int* stats) {
  char* s = static_cast<char*>(scratch);
  auto at = [&](size_t off) { return reinterpret_cast<int*>(s + off); };
  Work w;
  w.ctrl = at(l.ctrl);
  w.hkeys = reinterpret_cast<unsigned long long*>(s + l.hkeys);
  w.hvals = at(l.hvals);
  w.hmask = l.hslots - 1;
  w.e_lo = at(l.e_lo), w.e_hi = at(l.e_hi), w.e_dlo = at(l.e_dlo), w.e_dhi = at(l.e_dhi), w.e_f = at(l.e_f);
  w.e_vlo = at(l.e_vlo), w.e_vhi = at(l.e_vhi), w.e_c = at(l.e_c), w.e_lpre = at(l.e_lpre);
  w.e_flags = reinterpret_cast<uint8_t*>(s + l.e_flags);
  w.e_ok = reinterpret_cast<uint8_t*>(s + l.e_ok);
  w.e_land = reinterpret_cast<uint8_t*>(s + l.e_land);
  w.keys_in = at(l.keys_in);
  for (int b = 0; b < 2; ++b) {
    w.skeys[b] = at(l.skeys[b]);
    w.svals[b] = at(l.svals[b]);
  }
  w.incl = reinterpret_cast<unsigned*>(s + l.incl);
  w.hist = at(l.hist);
  w.base = at(l.base);
  w.t_head = at(l.t_head);
  w.t_sum = reinterpret_cast<unsigned*>(s + l.t_sum);
  w.t_carry = reinterpret_cast<unsigned*>(s + l.t_carry);
  w.passes = sort_passes(capacity);
  w.stats = stats;
  w.trace_local = w.trace_global = nullptr;
  return w;
}

// ---------------------------------------------------------------------------
// block-wide helpers (kThreads threads)

// Exclusive sum over the block; total = the block's sum.  Ends synchronized.
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    total += c;
  }
  __syncthreads();
  return before + x - v;
}

// A segmented sum's element: whether a segment starts in it, and the sum
// since its last start (or all of it).  Sums wrap.
struct Seg {
  int head;
  unsigned sum;
};

__device__ __forceinline__ Seg seg_op(Seg a, Seg b) { return {a.head | b.head, b.head ? b.sum : a.sum + b.sum}; }

// Exclusive segmented scan over the block; total = the block's.  Ends
// synchronized.
__device__ __forceinline__ Seg block_seg_exclusive(Seg v, Seg* s_warp, Seg& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Seg x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Seg y{__shfl_up_sync(kFull, x.head, d), __shfl_up_sync(kFull, x.sum, d)};
    if (lane >= d) x = seg_op(y, x);
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  Seg before{0, 0};
  total = Seg{0, 0};
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const Seg c = s_warp[w];
    if (w < warp) before = seg_op(before, c);
    total = seg_op(total, c);
  }
  __syncthreads();
  Seg lane_before{__shfl_up_sync(kFull, x.head, 1), __shfl_up_sync(kFull, x.sum, 1)};
  if (lane == 0) lane_before = Seg{0, 0};
  return seg_op(before, lane_before);
}

// Whether any earlier thread of the block has `v`.  Ends synchronized.
__device__ __forceinline__ bool block_any_before(bool v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(kFull, v);
  if (lane == 0) s_warp[warp] = bal != 0;
  __syncthreads();
  bool any = (bal & ((1u << lane) - 1u)) != 0;
  for (int w = 0; w < warp; ++w) any |= s_warp[w] != 0;
  __syncthreads();
  return any;
}

__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
  return v;
}

struct CoopSmem {
  int wcnt[kWarps][kDigits];
  int off[kDigits];
  int hist[kDigits];
  int ints[kWarps];
  Seg segs[kWarps];
};

// ---------------------------------------------------------------------------
// grid-wide pieces of the cooperative kernels

// One pass of the stable LSD radix sort: pass 0 reads keys_in[0, n) (a
// key below 0 is no item; an item's value is its index), a later pass the
// ctrl[kValid] items the pass before left; pass p writes skeys, svals[p & 1].
__device__ void radix_pass(cg::grid_group& grid, const Work& w, int pass, int n, CoopSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = pass == 0 ? n : load_volatile(w.ctrl + kValid);
  const int tiles = (rows + kTile - 1) / kTile;
  const int shift = pass * kDigitBits;
  const int* kin = pass == 0 ? w.keys_in : w.skeys[(pass + 1) & 1];
  const int* vin = w.svals[(pass + 1) & 1];
  int* kout = w.skeys[pass & 1];
  int* vout = w.svals[pass & 1];
  // each tile's digit counts
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    sm.hist[tid] = 0;
    __syncthreads();
    for (int q = 0; q < kItems; ++q) {
      const int p = t * kTile + q * kThreads + tid;
      const int key = p < rows ? kin[p] : -1;
      if (key >= 0) atomicAdd(&sm.hist[(key >> shift) & (kDigits - 1)], 1);
    }
    __syncthreads();
    w.hist[t * kDigits + tid] = sm.hist[tid];
    __syncthreads();
  }
  grid.sync();
  // one block: each digit's start in each tile
  if (blockIdx.x == 0) {
    int run = 0;
#pragma unroll 4
    for (int t = 0; t < tiles; ++t) {
      int* h = w.hist + t * kDigits + tid;
      const int c = *h;
      *h = run;
      run += c;
    }
    int total;
    w.base[tid] = block_exclusive_sum(run, sm.ints, total);
    if (pass == 0 && tid == 0) w.ctrl[kValid] = total;
  }
  grid.sync();
  // the scatter: a warp ranks its 128 rows in order, 32 a round, a round's
  // equal digits by __match_any_sync, rounds chained by per-warp counters
  const unsigned lt = (1u << lane) - 1u;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int i = tid; i < kWarps * kDigits; i += kThreads) (&sm.wcnt[0][0])[i] = 0;
    sm.off[tid] = w.base[tid] + w.hist[t * kDigits + tid];
    __syncthreads();
    int key[kItems], val[kItems], dg[kItems], rk[kItems];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int p = t * kTile + warp * (kTile / kWarps) + q * 32 + lane;
      key[q] = p < rows ? kin[p] : -1;
      const bool ok = key[q] >= 0;
      val[q] = ok ? (pass == 0 ? p : vin[p]) : 0;
      const int d = ok ? (key[q] >> shift) & (kDigits - 1) : -1;
      const unsigned peers = __match_any_sync(kFull, d);
      const int before = ok ? sm.wcnt[warp][d] : 0;
      __syncwarp();
      if (ok && (peers & lt) == 0) sm.wcnt[warp][d] = before + __popc(peers);
      __syncwarp();
      dg[q] = d;
      rk[q] = before + __popc(peers & lt);
    }
    __syncthreads();
    int run = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const int c = sm.wcnt[v][tid];
      sm.wcnt[v][tid] = run;
      run += c;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (dg[q] < 0) continue;
      const int pos = sm.off[dg[q]] + sm.wcnt[warp][dg[q]] + rk[q];
      kout[pos] = key[q];
      vout[pos] = val[q];
    }
    __syncthreads();
  }
  grid.sync();
}

// Inclusive segmented scan over items [0, n): a segment starts where
// key(i) differs from key(i - 1); w.incl[i] gets the scan; emit(i, v) is
// called with each final value.  Three grid-wide syncs.
template <class Key, class Val, class Emit>
__device__ void seg_scan(cg::grid_group& grid, const Work& w, int n, Key key, Val val, Emit emit, CoopSmem& sm) {
  const int tid = threadIdx.x;
  const int tiles = (n + kTile - 1) / kTile;
  // each tile alone
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = t * kTile + tid * kItems;
    unsigned s = 0, loc[kItems];
    int heads = 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int i = i0 + q;
      loc[q] = 0;
      if (i >= n) continue;
      const int k = key(i);
      if (i == 0 || key(i - 1) != k) {
        heads |= 1 << q;
        s = 0;
      }
      s += val(i);
      loc[q] = s;
    }
    Seg total;
    const Seg before = block_seg_exclusive(Seg{heads != 0, s}, sm.segs, total);
    bool seen = false;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      seen |= (heads >> q) & 1;
      if (i0 + q < n) w.incl[i0 + q] = loc[q] + (seen ? 0u : before.sum);
    }
    if (tid == 0) {
      w.t_head[t] = total.head;
      w.t_sum[t] = total.sum;
    }
  }
  grid.sync();
  // one block: the sum each tile's first segment carries in
  if (blockIdx.x == 0) {
    Seg run{0, 0};
    for (int t0 = 0; t0 < tiles; t0 += kThreads) {
      const int t = t0 + tid;
      const Seg a = t < tiles ? Seg{w.t_head[t], w.t_sum[t]} : Seg{0, 0};
      Seg total;
      const Seg before = seg_op(run, block_seg_exclusive(a, sm.segs, total));
      if (t < tiles) w.t_carry[t] = before.sum;
      run = seg_op(run, total);
    }
  }
  grid.sync();
  // the carries into the items before each tile's first start
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i0 = t * kTile + tid * kItems;
    int heads = 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int i = i0 + q;
      if (i < n && (i == 0 || key(i - 1) != key(i))) heads |= 1 << q;
    }
    bool seen = block_any_before(heads != 0, sm.ints);
    const unsigned carry = w.t_carry[t];
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int i = i0 + q;
      seen |= (heads >> q) & 1;
      if (i >= n) continue;
      const unsigned v = w.incl[i] + (seen ? 0u : carry);
      w.incl[i] = v;
      emit(i, v);
    }
  }
  grid.sync();
}

// ---------------------------------------------------------------------------
// the kernels

__device__ __forceinline__ unsigned long long pair_key(int lo, int hi) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(lo)) << 32) | static_cast<unsigned>(hi);
}

__device__ __forceinline__ int hash_slot(unsigned long long key, int mask) {
  return static_cast<int>((key * 0x9E3779B97F4A7C15ull) >> 32) & mask;
}

// The prepass: a block takes whole chunks (per_block edges).  See the
// head note.
__global__ void __launch_bounds__(kThreads)
prep_kernel(Batch bt, State st, Work w, int per_block, int trace) {
  __shared__ int s_lo[kThreads], s_hi[kThreads], s_dlo[kThreads];
  __shared__ uint8_t s_ok0[kThreads], s_first[kThreads];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = bt.capacity, D = bt.max_degree, r = bt.r;
  const int e = blockIdx.x * per_block + tid;
  const bool in = tid < per_block && e < bt.padded;
  const bool real = in && e < bt.n;
  const int u = real ? bt.src[e] : 0, v = real ? bt.dst[e] : 0;
  const int lo = min(u, v), hi = max(u, v);
  const bool ok0 = real && bt.mask[e] && lo != hi;
  bool bad = ok0 && (lo < 0 || hi >= C);
  int dlo = 0, dhi = 0;
  if (ok0 && !bad) {
    dlo = st.deg[lo];
    dhi = st.deg[hi];
    bad = dlo < 0 || dhi < 0;
  }
  s_lo[tid] = lo;
  s_hi[tid] = hi;
  s_ok0[tid] = ok0;
  s_dlo[tid] = dlo;
  __syncthreads();
  bool first = ok0 && !bad;
  for (int i = (tid / r) * r; first && i < tid; ++i)
    if (s_ok0[i] && s_lo[i] == lo && s_hi[i] == hi) first = false;
  s_first[tid] = first;
  __syncthreads();
  // hi in lo's pre-batch row: a warp an edge, lanes over the slots
  bool contains = false;
  for (int q = 0; q < 32; ++q) {
    const int t = warp * 32 + q;
    if (!s_first[t]) continue;
    const int* row = st.nbrs + static_cast<long long>(s_lo[t]) * D;
    const int h = s_hi[t], dl = s_dlo[t];
    bool valid_hit = false, past_hit = false;
    for (int a = lane; a < D; a += 32) {
      if (row[a] != h) continue;
      if (a < dl)
        valid_hit = true;
      else
        past_hit = true;
    }
    const bool vh = __any_sync(kFull, valid_hit), ph = __any_sync(kFull, past_hit);
    if (lane == q) {
      contains = vh;
      bad |= ph;
    }
  }
  if (bad) atomicOr(w.ctrl + kFlag, 1);
  if (blockIdx.x == 0 && tid == 0) w.ctrl[kGlobPre] = *st.glob;
  if (!in) return;
  const bool cand = first && !contains;
  w.e_lo[e] = lo;
  w.e_hi[e] = hi;
  w.e_dlo[e] = dlo;
  w.e_dhi[e] = dhi;
  w.e_flags[e] = cand ? kCand : 0;
  w.e_ok[e] = 0;
  const int k = e / r, j = e - k * r;
  w.keys_in[2 * k * r + j] = cand ? lo : -1;
  w.keys_in[2 * k * r + r + j] = cand ? hi : -1;
  if (cand) {
    const unsigned long long key = pair_key(lo, hi);
    for (int h = hash_slot(key, w.hmask);; h = (h + 1) & w.hmask) {
      const unsigned long long prev = atomicCAS(w.hkeys + h, kEmpty, key);
      if (prev == kEmpty || prev == key) {
        atomicMin(w.hvals + h, e);
        break;
      }
    }
  }
  if (trace && real) {
    w.e_lpre[2 * e] = st.local[gather_index(lo, C)];
    w.e_lpre[2 * e + 1] = st.local[gather_index(hi, C)];
  }
}

// The sort, the fixed point, the slots and each edge's valid counts (see
// the head note).  Cooperative.
__global__ void __launch_bounds__(kThreads) settle_kernel(Batch bt, State st, Work w) {
  __shared__ CoopSmem sm;
  __shared__ int s_dropped;
  if (load_volatile(w.ctrl + kFlag)) return;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int D = bt.max_degree, r = bt.r, padded = bt.padded;
  const int stride = gridDim.x * kThreads;
  const int gid = blockIdx.x * kThreads + tid;
  for (int pass = 0; pass < w.passes; ++pass) radix_pass(grid, w, pass, 2 * padded, sm);
  const int nv = load_volatile(w.ctrl + kValid);
  const int* skeys = w.skeys[(w.passes - 1) & 1];
  const int* svals = w.svals[(w.passes - 1) & 1];
  auto edge_of = [r](int id) {
    const int k = id / (2 * r), rem = id - k * 2 * r;
    return k * r + (rem < r ? rem : rem - r);
  };
  // each candidate's pair's first copy; the repeats start not ok
  for (int e = gid; e < padded; e += stride) {
    const uint8_t fl = w.e_flags[e];
    if (!(fl & kCand)) continue;
    const unsigned long long key = pair_key(w.e_lo[e], w.e_hi[e]);
    int h = hash_slot(key, w.hmask);
    while (w.hkeys[h] != key) h = (h + 1) & w.hmask;
    const int f = w.hvals[h];
    w.e_f[e] = f;
    if (f != e) w.e_flags[e] = fl | kRepeat;
    w.e_ok[e] = f == e;
  }
  grid.sync();
  int passes = 0;
  for (;; ++passes) {
    if (gid == 0) w.ctrl[kChanged + (passes + 1) % 3] = 0;
    // the ok entries' ordinals in their rows; the lo entries that land
    seg_scan(
        grid, w, nv, [&](int i) { return skeys[i]; },
        [&](int i) { return static_cast<unsigned>(w.e_ok[edge_of(svals[i])]); },
        [&](int i, unsigned v) {
          const int id = svals[i];
          if (id % (2 * r) >= r) return;  // a hi entry
          const int e = edge_of(id);
          w.e_land[e] = w.e_ok[e] && w.e_dlo[e] + static_cast<int>(v) - 1 < D;
        },
        sm);
    bool changed = false;
    for (int e = gid; e < padded; e += stride) {
      if ((w.e_flags[e] & kRepeat) && !w.e_ok[e] && !w.e_land[w.e_f[e]]) {
        w.e_ok[e] = 1;
        changed = true;
      }
    }
    if (changed) atomicAdd(w.ctrl + kChanged + passes % 3, 1);
    grid.sync();
    if (load_volatile(w.ctrl + kChanged + passes % 3) == 0) break;
  }
  ++passes;
  if (gid == 0) {
    atomicAdd(w.stats + kPassSum, passes);
    atomicMax(w.stats + kPassMax, passes);
  }
  // the slots, deg and dropped; each edge's valid counts at its chunk
  if (tid == 0) s_dropped = 0;
  __syncthreads();
  int dropped = 0;
  for (int i = gid; i < nv; i += stride) {
    const int id = svals[i], e = edge_of(id);
    if (!w.e_ok[e]) continue;
    const int row = skeys[i], k = id / (2 * r);
    const bool role = id - k * 2 * r >= r;
    const int dpre = role ? w.e_dhi[e] : w.e_dlo[e];
    const int ordinal = static_cast<int>(w.incl[i]) - 1;
    if (dpre + ordinal < D) {
      st.nbrs[static_cast<long long>(row) * D + dpre + ordinal] = role ? w.e_lo[e] : w.e_hi[e];
      atomicAdd(st.deg + row, 1);
    } else {
      ++dropped;
    }
    int h = i;
    while (h > 0 && skeys[h - 1] == row && svals[h - 1] / (2 * r) == k) --h;
    const int before = static_cast<int>(w.incl[h]) - w.e_ok[edge_of(svals[h])];
    const int room = D - dpre > 0 ? D - dpre : 0;
    const int valid = dpre + (before < room ? before : room);
    (role ? w.e_vhi : w.e_vlo)[e] = valid < D ? valid : D;
  }
  if (dropped) atomicAdd(&s_dropped, dropped);
  __syncthreads();
  if (tid == 0 && s_dropped) atomicAdd(st.dropped, s_dropped);
}

// Whether w is among the first `valid` slots of a row (a lane's walk).
__device__ __forceinline__ bool row_has(const int* row, int valid, int w) {
  for (int b = 0; b < valid; ++b)
    if (row[b] == w) return true;
  return false;
}

// The counts: a block takes whole chunks (per_block edges) into shared
// memory, a warp an edge.  kTrace (r = 1): also each edge's events, and
// its c.
template <bool kTrace>
__global__ void __launch_bounds__(kThreads) count_kernel(Batch bt, State st, Work w, int per_block) {
  __shared__ int s_lo[kThreads], s_hi[kThreads];
  __shared__ uint8_t s_ok[kThreads];
  __shared__ int s_glob;
  if (load_volatile(w.ctrl + kFlag)) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = bt.capacity, D = bt.max_degree, r = bt.r;
  if (tid == 0) s_glob = 0;
  for (int base = blockIdx.x * per_block; base < bt.padded; base += gridDim.x * per_block) {
    __syncthreads();
    const int m = min(per_block, bt.padded - base);
    if (tid < m) {
      s_lo[tid] = w.e_lo[base + tid];
      s_hi[tid] = w.e_hi[base + tid];
      s_ok[tid] = w.e_ok[base + tid];
    }
    __syncthreads();
    for (int t = warp; t < m; t += kWarps) {
      const int e = base + t;
      const int lo = s_lo[t], hi = s_hi[t];
      unsigned c = 0;
      if (s_ok[t]) {
        const int vl = w.e_vlo[e], vh = w.e_vhi[e];
        const int* rl = st.nbrs + static_cast<long long>(lo) * D;
        const int* rh = st.nbrs + static_cast<long long>(hi) * D;
        // old-old: each lane a slot of lo's row against hi's row, 32 slots a step by shuffles
        for (int a0 = 0; a0 < vl; a0 += 32) {
          const int a = a0 + lane;
          const int y = a < vl ? rl[a] : 0;
          int cnt = 0;
          for (int b0 = 0; b0 < vh; b0 += 32) {
            const int hv = b0 + lane < vh ? rh[b0 + lane] : 0;
            const int nb = min(32, vh - b0);
            for (int q = 0; q < nb; ++q) cnt += __shfl_sync(kFull, hv, q) == y;
          }
          if (a < vl && cnt) {
            c += cnt;
            scatter_add(st.local, y, C, 1);
          }
          if (kTrace && a < vl) {
            const int yn = jax_index(y, C);
            w.keys_in[static_cast<long long>(e) * (D + 2) + a] =
                cnt && static_cast<unsigned>(yn) < static_cast<unsigned>(C) ? yn : -1;
          }
        }
        // old-new and new-new: lanes over the earlier ok edges of the chunk
        for (int i = (t / r) * r + lane; i < t; i += 32) {
          if (!s_ok[i]) continue;
          const int li = s_lo[i], hi_i = s_hi[i];
          if (li == lo || hi_i == lo) {
            const int x = li == lo ? hi_i : li;
            if (row_has(rh, vh, x)) {
              ++c;
              scatter_add(st.local, x, C, 1);
            }
            int n3 = 0;
            for (int q = (t / r) * r; q < t; ++q) {
              if (!s_ok[q] || (s_lo[q] != hi && s_hi[q] != hi)) continue;
              n3 += (s_lo[q] == hi ? s_hi[q] : s_lo[q]) == x;
            }
            if (n3) {
              c += n3;
              scatter_add(st.local, x, C, n3);
            }
          }
          if (li == hi || hi_i == hi) {
            const int x = li == hi ? hi_i : li;
            if (row_has(rl, vl, x)) {
              ++c;
              scatter_add(st.local, x, C, 1);
            }
          }
        }
        c = warp_sum(c);
        if (lane == 0 && c) {
          scatter_add(st.local, lo, C, static_cast<int>(c));
          scatter_add(st.local, hi, C, static_cast<int>(c));
          atomicAdd(&s_glob, static_cast<int>(c));
        }
      }
      if (kTrace) {
        int* ev = w.keys_in + static_cast<long long>(e) * (D + 2);
        const int from = s_ok[t] ? w.e_vlo[e] : 0;
        for (int a = from + lane; a < D; a += 32) ev[a] = -1;
        if (lane == 0) {
          ev[D] = gather_index(lo, C);
          ev[D + 1] = gather_index(hi, C);
          w.e_c[e] = static_cast<int>(c);
        }
      }
    }
  }
  __syncthreads();
  if (tid == 0 && s_glob) atomicAdd(st.glob, s_glob);
}

// The trace: the events by vertex, scanned; then the global trace.
// Cooperative.
__global__ void __launch_bounds__(kThreads) trace_scan_kernel(Batch bt, Work w) {
  __shared__ CoopSmem sm;
  if (load_volatile(w.ctrl + kFlag)) return;
  cg::grid_group grid = cg::this_grid();
  const int D2 = bt.max_degree + 2, D = bt.max_degree;
  const int n_ev = bt.padded * D2;
  for (int pass = 0; pass < w.passes; ++pass) radix_pass(grid, w, pass, n_ev, sm);
  const int nv = load_volatile(w.ctrl + kValid);
  const int* skeys = w.skeys[(w.passes - 1) & 1];
  const int* svals = w.svals[(w.passes - 1) & 1];
  seg_scan(
      grid, w, nv, [&](int i) { return skeys[i]; },
      [&](int i) {
        const int p = svals[i], e = p / D2;
        return p - e * D2 < D ? 1u : static_cast<unsigned>(w.e_c[e]);
      },
      [&](int i, unsigned v) {
        const int p = svals[i], e = p / D2, t = p - e * D2;
        if (t >= D) w.trace_local[2 * e + t - D] = w.e_lpre[2 * e + t - D] + static_cast<int>(v);
      },
      sm);
  const int glob_pre = w.ctrl[kGlobPre];
  seg_scan(
      grid, w, bt.n, [](int) { return 0; }, [&](int i) { return static_cast<unsigned>(w.e_c[i]); },
      [&](int i, unsigned v) { w.trace_global[i] = glob_pre + static_cast<int>(v); }, sm);
}

// ---------------------------------------------------------------------------
// the chain kernel: one block walking the chunks in order, each reading
// the rows the chunk before wrote; the exact path of a flagged batch.
// trace_local, trace_global: null in block mode.

__global__ void __launch_bounds__(kChainThreads)
chain_kernel(State st, Batch bt, int* trace_local, int* trace_global, int staged, const int* flag, int* stats) {
  __shared__ int s_lo[kMaxChunk], s_hi[kMaxChunk], s_glo[kMaxChunk], s_ghi[kMaxChunk];
  __shared__ int s_dlo[kMaxChunk], s_dhi[kMaxChunk], s_c[kMaxChunk];
  __shared__ uint8_t s_ok0[kMaxChunk], s_ok[kMaxChunk], s_found[kMaxChunk];
  __shared__ int s_pos[2 * kMaxChunk];
  __shared__ uint8_t s_ins[2 * kMaxChunk];  // 0 not inserted, 1 inserted, 2 dropped
  __shared__ int s_glob, s_dropped;
  extern __shared__ int s_rows[];  // staged rows: [r][2][D] (lo's, hi's)
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool flagged = *flag != 0;
  if (tid == 0) atomicAdd(stats + (flagged ? kChain : kParallel), 1);
  if (!flagged) return;
  const int C = bt.capacity, D = bt.max_degree, r = bt.r;
  if (tid == 0) {
    s_glob = *st.glob;
    s_dropped = 0;
  }
  // edge j's row of lo (side 0) or hi (side 1)
  auto row = [&](int j, int side) -> const int* {
    return staged ? s_rows + (2 * j + side) * D : st.nbrs + static_cast<long long>(side ? s_ghi[j] : s_glo[j]) * D;
  };
  auto member = [&](const int* rw, int deg, int w) {
    const int d = min(deg, D);
    for (int b = 0; b < d; ++b)
      if (rw[b] == w) return true;
    return false;
  };
  const int chunks = (bt.n + r - 1) / r;
  for (int k = 0; k < chunks; ++k) {
    const int base = k * r;
    for (int j = tid; j < r; j += nt) {
      const int e = base + j;
      const bool in = e < bt.n;
      const int u = in ? bt.src[e] : 0, v = in ? bt.dst[e] : 0;
      const int lo = min(u, v), hi = max(u, v);
      const int glo = gather_index(lo, C), ghi = gather_index(hi, C);
      s_lo[j] = lo;
      s_hi[j] = hi;
      s_glo[j] = glo;
      s_ghi[j] = ghi;
      s_dlo[j] = st.deg[glo];
      s_dhi[j] = st.deg[ghi];
      s_ok0[j] = in && bt.mask[e] && lo != hi;
      s_found[j] = 0;
      s_c[j] = 0;
    }
    __syncthreads();
    // membership of hi in all D slots of lo's row; stage both rows
    for (int x = tid; x < r * D; x += nt) {
      const int j = x / D, a = x - j * D;
      if (!s_ok0[j]) continue;
      const int y = st.nbrs[static_cast<long long>(s_glo[j]) * D + a];
      if (staged) {
        s_rows[2 * j * D + a] = y;
        s_rows[(2 * j + 1) * D + a] = st.nbrs[static_cast<long long>(s_ghi[j]) * D + a];
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
        scatter_add(st.local, y, C, 1);
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
        scatter_add(st.local, w_lo, C, 1);
      }
      if (shares_hi && member(row(j, 0), s_dlo[j], w_hi)) {
        ++add;
        scatter_add(st.local, w_hi, C, 1);
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
          scatter_add(st.local, w_lo, C, cnt);
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
      scatter_add(st.local, s_lo[j], C, c);
      scatter_add(st.local, s_hi[j], C, c);
      atomicAdd(&s_glob, c);
    }
    for (int x = tid; x < 2 * r; x += nt) {
      const int j = x < r ? x : x - r;
      uint8_t ins = 0;
      int pos = 0;
      if (s_ok[j]) {
        const int key = x < r ? s_lo[j] : s_hi[j];
        int rank = 0;
        for (int y = 0; y < min(x, r); ++y) rank += s_ok[y] && s_lo[y] == key;
        for (int y = r; y < x; ++y) rank += s_ok[y - r] && s_hi[y - r] == key;
        pos = (x < r ? s_dlo[j] : s_dhi[j]) + rank;
        ins = pos < D ? 1 : 2;
      }
      s_pos[x] = pos;
      s_ins[x] = ins;
    }
    __syncthreads();
    for (int x = tid; x < 2 * r; x += nt) {
      const uint8_t ins = s_ins[x];
      if (ins == 2) atomicAdd(&s_dropped, 1);
      if (ins != 1) continue;
      const int j = x < r ? x : x - r;
      const int s = x < r ? s_lo[j] : s_hi[j], d = x < r ? s_hi[j] : s_lo[j];
      const int flat = static_cast<int>(static_cast<unsigned>(s) * static_cast<unsigned>(D) +
                                        static_cast<unsigned>(s_pos[x]));
      const long long slots = static_cast<long long>(C) * D;
      const long long fi = flat < 0 ? flat + slots : flat;
      if (fi >= 0 && fi < slots) st.nbrs[fi] = d;
      scatter_add(st.deg, s, C, 1);
    }
    __syncthreads();
    if (trace_local && tid == 0) {  // r = 1: edge `base`, after its insert
      trace_local[2 * base] = st.local[gather_index(s_lo[0], C)];
      trace_local[2 * base + 1] = st.local[gather_index(s_hi[0], C)];
      trace_global[base] = s_glob;
    }
  }
  if (tid == 0) {
    *st.glob = s_glob;
    *st.dropped += s_dropped;
  }
}

// ---------------------------------------------------------------------------
// launch

// What the launches need of the current device, found at its first call:
// its SMs and the blocks of each cooperative kernel that fit on it at
// once; the chain kernel's dynamic shared memory is raised to kStageCap
// then too.
struct DeviceInfo {
  int sms;
  int settle_blocks;
  int scan_blocks;
};

cudaError_t device_info(const DeviceInfo** out) {
  static std::mutex mu;
  static DeviceInfo cache[kMaxDevices];
  static std::atomic<bool> ready[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!ready[device].load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lock(mu);
    if (!ready[device].load(std::memory_order_relaxed)) {
      DeviceInfo d{};
      int settle = 0, scan = 0;
      if ((err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
          (err = cudaFuncSetAttribute(chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageCap)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&settle, settle_kernel, kThreads, 0)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&scan, trace_scan_kernel, kThreads, 0)) !=
              cudaSuccess)
        return err;
      d.settle_blocks = d.sms * settle;
      d.scan_blocks = d.sms * scan;
      cache[device] = d;
      ready[device].store(true, std::memory_order_release);
    }
  }
  *out = &cache[device];
  return cudaSuccess;
}

// `want` blocks of `kernel`, at most the `fit` that are resident at once.
cudaError_t launch_cooperative(const void* kernel, int fit, long long want, void** args, cudaStream_t s) {
  if (fit < 1) return cudaErrorCooperativeLaunchTooLarge;
  long long blocks = want < fit ? want : fit;
  blocks = blocks > 0 ? blocks : 1;
  return cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0, s);
}

cudaError_t launch(const State& st, const void* src, const void* dst, const void* mask, int n, int C, int D, int r,
                   int* trace_local, int* trace_global, void* scratch, long long scratch_bytes, int* stats,
                   cudaStream_t s) {
  if (n < 0 || C < 1 || D < 1 || r < 1 || r > kMaxChunk || static_cast<long long>(C) * D >= (1LL << 31) ||
      !stats)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const bool trace = trace_local != nullptr;
  const Layout l = layout(n, D, r, trace);
  if (l.items < 0 || !scratch || scratch_bytes < static_cast<long long>(l.total)) return cudaErrorInvalidValue;
  const DeviceInfo* dev;
  cudaError_t err;
  if ((err = device_info(&dev)) != cudaSuccess) return err;
  Work w = work(l, scratch, C, stats);
  w.trace_local = trace_local;
  w.trace_global = trace_global;
  const Batch bt{static_cast<const int*>(src), static_cast<const int*>(dst), static_cast<const uint8_t*>(mask), n,
                 l.padded, r, C, D};
  char* base = static_cast<char*>(scratch);
  if ((err = cudaMemsetAsync(base + l.ctrl, 0, kCtrlWords * 4, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(base + l.hkeys, 0xff, static_cast<size_t>(l.hslots) * 8, s)) != cudaSuccess ||
      (err = cudaMemsetAsync(base + l.hvals, 0x7f, static_cast<size_t>(l.hslots) * 4, s)) != cudaSuccess)
    return err;
  const int per_block = (kThreads / r) * r;
  const int groups = (l.padded + per_block - 1) / per_block;
  prep_kernel<<<groups, kThreads, 0, s>>>(bt, st, w, per_block, trace);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long rows_bytes = 2LL * r * D * static_cast<long long>(sizeof(int));
  const int staged = rows_bytes <= kStageCap;
  const int smem = staged ? static_cast<int>(rows_bytes) : 0;
  chain_kernel<<<1, trace ? kChainTraceThreads : kChainThreads, smem, s>>>(st, bt, trace_local, trace_global, staged,
                                                                           w.ctrl + kFlag, stats);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  Batch bt_arg = bt;
  State st_arg = st;
  void* settle_args[] = {&bt_arg, &st_arg, &w};
  const long long want = (l.padded + kThreads - 1) / kThreads > (2LL * l.padded + kTile - 1) / kTile
                             ? (l.padded + kThreads - 1) / kThreads
                             : (2LL * l.padded + kTile - 1) / kTile;
  if ((err = launch_cooperative(reinterpret_cast<const void*>(settle_kernel), dev->settle_blocks, want, settle_args,
                                s)) != cudaSuccess)
    return err;
  const int count_blocks = groups < 8 * dev->sms ? groups : 8 * dev->sms;
  if (trace)
    count_kernel<true><<<count_blocks, kThreads, 0, s>>>(bt, st, w, per_block);
  else
    count_kernel<false><<<count_blocks, kThreads, 0, s>>>(bt, st, w, per_block);
  if ((err = cudaGetLastError()) != cudaSuccess || !trace) return err;
  void* scan_args[] = {&bt_arg, &w};
  return launch_cooperative(reinterpret_cast<const void*>(trace_scan_kernel), dev->scan_blocks,
                            (static_cast<long long>(l.items) + kTile - 1) / kTile, scan_args, s);
}

}  // namespace

extern "C" {

// The scratch bytes of one call: n edges, the table's C and D, chunks of
// `chunk` edges (1 for a trace), trace 0 or 1.
long long exact_scratch_bytes(int n, int capacity, int max_degree, int chunk, int trace) {
  if (n < 1 || capacity < 1 || max_degree < 1 || chunk < 1) return 0;
  const Layout l = layout(n, max_degree, trace ? 1 : chunk, trace);
  return l.items < 0 ? -1 : static_cast<long long>(l.total);
}

// nbrs int32[C, D], deg int32[C], dropped int32[1], local int32[C], glob
// int32[1]: the state, updated in place.  src, dst int32[n]; mask bool[n].
// chunk: r in [1, kMaxChunk], the edges a step.  scratch: the bytes
// exact_scratch_bytes gives; stats int32[4] (batches on the parallel path,
// on the chain path, fixed-point passes summed, most passes), added to.
// The memsets, then prep, chain, settle and count kernels.
int triangle_block_launch(void* nbrs, void* deg, void* dropped, void* local, void* glob, const void* src,
                          const void* dst, const void* mask, int n, int capacity, int max_degree, int chunk,
                          void* scratch, long long scratch_bytes, void* stats, void* stream) {
  const State st{static_cast<int*>(nbrs), static_cast<int*>(deg), static_cast<int*>(dropped),
                 static_cast<int*>(local), static_cast<int*>(glob)};
  return static_cast<int>(launch(st, src, dst, mask, n, capacity, max_degree, chunk, nullptr, nullptr, scratch,
                                 scratch_bytes, static_cast<int*>(stats), static_cast<cudaStream_t>(stream)));
}

// The same state and batch, one edge a step; trace_local int32[n, 2] gets
// (local[lo], local[hi]) and trace_global int32[n] the global count after
// each edge.  The memsets, then prep, chain, settle, count and trace scan
// kernels.
int triangle_trace_launch(void* nbrs, void* deg, void* dropped, void* local, void* glob, const void* src,
                          const void* dst, const void* mask, int n, int capacity, int max_degree,
                          void* trace_local, void* trace_global, void* scratch, long long scratch_bytes,
                          void* stats, void* stream) {
  const State st{static_cast<int*>(nbrs), static_cast<int*>(deg), static_cast<int*>(dropped),
                 static_cast<int*>(local), static_cast<int*>(glob)};
  return static_cast<int>(launch(st, src, dst, mask, n, capacity, max_degree, 1, static_cast<int*>(trace_local),
                                 static_cast<int*>(trace_global), scratch, scratch_bytes, static_cast<int*>(stats),
                                 static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
