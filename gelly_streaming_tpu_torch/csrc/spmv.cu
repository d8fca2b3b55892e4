// The masked-semiring SpMV core on Hopper (sm_90a): the direction-optimized
// fixpoint, the PageRank iteration and the one-shot products, behind a
// plain C interface loaded with ctypes (gelly_streaming_tpu_torch/ops/
// _cuda.py, ops/spmv.py).
//
// Replaces two XLA loops of the JAX package (gelly_streaming_tpu/ops/
// spmv.py), not Pallas kernels:
//   - _build_run (:344-408), driven by fixpoint (:427-505): the semiring
//     while_loop x = combine(x, A^T x) whose every iteration picks push
//     (_push_product, :225-242: the frontier's CSR rows scattered) or pull
//     (_pull_product, :245-252: a gather over the dst-sorted copy and a
//     sorted segment reduce) by frontier density against a threshold;
//   - pagerank_fixpoint's while_loop (:513-583): the damped power
//     iteration with dangling mass, to an L1 tolerance.
// PyTorch has no device-side loop and a host loop would sync on every
// iteration, so each loop is one cooperative launch (a persistent grid of
// co-resident blocks) whose phases are separated by grid-wide syncs; the
// loop's own decisions (the frontier's size, the delta) are reduced on the
// card and read there.  One C call runs a whole fixpoint.
//
// The pane (ops/spmv.prepare_pane): the masked edges sorted stably by src
// (s_dst, s_w and the CSR offsets off[C + 1]) and by dst (d_src, d_w and
// d_off[C + 1]).  Masked-out rows sort past every real key, so the rows
// and segments [off[v], off[v + 1]) and [d_off[d], d_off[d + 1]) hold
// masked edges only and no mask is read.
//
// The min semirings' products (the fixpoint's, and the one-shot
// spmv_product_launch's, so spmv_dense and spmsv_frontier on the card run
// the fixpoint's own code) are balanced over the edges, not over the
// vertices: Graph500's hubs hold in-segments and out-rows of ~17,500 edges,
// which one warp walked alone while ~1,000 others waited at the grid sync.
//   - pull: the merge path (Merrill and Garland, SC16) of the segment ends
//     d_off[1..C] with the edges of [d_off[0], d_off[C]) is cut into tiles
//     of kTile items (a block's, staged in shared memory: the ends, and
//     each edge's candidate mul(x[d_src[e]], d_w[e])), and each thread
//     takes kItems consecutive items.  A segment that begins and ends in
//     one thread's items is stored by it; a piece of a longer one (a hub's
//     segment spans tiles) is min-combined into the target by a guarded
//     atomic, the trailing pieces of a warp merged across its lanes first.
//     min is exact in any order.  The tiles' starting coordinates are
//     searched once a launch (the pane does not change).
//   - push: the frontier phase that counts the frontier also queues its
//     vertices with out-edges and the prefix sum of their row lengths (one
//     64-bit atomic a block reserving rows and edges together, so the
//     offsets rise with the queue, and a block scan); the next push splits
//     those edges evenly over the warps, 32 consecutive edges a warp a step,
//     each lane finding its edge's row among 32 queue rows by a search over
//     the lanes.  A candidate is combined into the target by atomicMin,
//     issued only where a read shows it would lower the entry.  The f32 min
//     is an int atomicMin for a non-negative candidate and an unsigned
//     atomicMax for a negative one: both orders agree with the float order
//     for every sign.
// The fixpoint's target buffer holds min(x, identity) when an iteration
// starts, so a destination with no candidate needs no write.  PageRank's
// spread (a sum, whose bits depend on the order of its adds) is balanced
// over the same merge-path tiles, its pieces combined in an order that the
// plan alone fixes, with no float atomics (the PageRank section below).
// The one-shot PLUS_TIMES / PLUS_ONE products, which no main path calls,
// keep the vertex-parallel ordered segment sum (pull_group: a warp takes
// 32 consecutive destinations, a segment of up to kShort edges walked by
// its own lane, a longer one by the whole warp; their push is the pull's
// ordered sum over the edges whose source is in the frontier).
// Index rules (streams that validate nothing): a gather of x at an id
// below 0 counts from the end once, then clamps; a push's scatter target
// counts from the end once and is dropped when still outside [0, C); a
// pull segment exists only for d in [0, C).  Each is the rule of the JAX
// lowering it replaces.
//
// Bound on the H100 (bytes): a pull iteration reads d_src and d_w (8 B
// an edge), d_off and x and writes x and the frontier (13 B a vertex); a
// push iteration reads the frontier's rows (8 B an edge) and their
// offsets (8 B a frontier vertex), and reads and writes x and the
// frontier (10 B a vertex).  A PageRank iteration reads d_src (4 B an
// edge), off, d_off and r and writes r (16 B a vertex).  At Graph500 scale
// 20 a window of 4,194,304 edges over 2^20 vertices is ~47.2 MB a pull
// iteration, ~0.014 ms at 3.35 TB/s.  Each fixpoint iteration takes two
// grid-wide syncs, which the design needs (the product's atomics land
// before the frontier is read; the frontier, its count and queue before
// the next product); the queue and the tiles add none; so does a PageRank
// iteration (the tiles' pieces before the vertex phase reads them; c and
// the partials before the next tiles).  Both grids are a block a pull tile
// or a thread a vertex, whichever is more, at most the blocks that fit: a
// pane of few vertices and many edges still gets a block a tile, and more
// blocks than that only add to every grid sync's cost (chip_smoke.py phase
// 16 (e) times the alternatives in turns).

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBins = 8;    // metrics.SPMV_DENSITY_BINS
constexpr int kShort = 32;  // a segment or row up to this long is walked by one lane (pull_group)
constexpr int kItems = 8;   // merge-path items a thread takes in a pull tile
constexpr int kTile = kThreads * kItems;
constexpr int kGroup = 4;  // vertices a thread loads at once in a frontier pass

// the scratch of a balanced product or a fixpoint (int32 slots): the
// header (cleared by the launcher), then the frontier queue [n], its row
// offsets [n], and the pull tiles' coordinates [tiles + 1] (int2)
enum FixSlot {
  kStats = 0,  // 3 rotating slots of the frontier's size
  kIters = 3,
  kPushIters = 4,
  kPullIters = 5,
  kSwitches = 6,
  kHist = 7,  // kBins bins
  kFixHeaderInts = kHist + kBins,
  kQueueSlots = 16,  // 3 rotating uint64: (queued rows << 32) | their edges
  kBlocks = 22,      // the launch's blocks
  kPlanHead = 24,
};

// the PageRank header (int32 slots, cleared by the launcher; the rest of
// its scratch: RankPlan)
enum RankSlot { kWindowCount = 0, kRankIters = 1, kRankBlocks = 2, kRankHeaderInts = 32 };

enum SemId { kMinPlus = 0, kPlusTimes = 1, kMinMin = 2, kPlusOne = 3 };

// ---------------------------------------------------------------------------
// semirings: add's identity, mul (with or without the edge weight), add.
// Explicit _rn intrinsics: no FMA contraction, IEEE rounding of each step.

struct MinPlus {
  using T = float;
  static constexpr bool kMin = true, kWeighted = true;
  static __host__ __device__ __forceinline__ T ident() { return 1e30f; }
  static __device__ __forceinline__ T mul(T x, float w) { return __fadd_rn(x, w); }
  static __device__ __forceinline__ T add(T a, T b) { return b < a ? b : a; }
};

struct PlusTimes {
  using T = float;
  static constexpr bool kMin = false, kWeighted = true;
  static __host__ __device__ __forceinline__ T ident() { return 0.0f; }
  static __device__ __forceinline__ T mul(T x, float w) { return __fmul_rn(x, w); }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
};

struct MinMin {
  using T = int;
  static constexpr bool kMin = true, kWeighted = true;
  static __host__ __device__ __forceinline__ T ident() { return 0x7fffffff; }
  // the weight truncated to int32, as JAX's astype (saturating here)
  static __device__ __forceinline__ T mul(T x, float w) {
    const int wi = __float2int_rz(w);
    return wi < x ? wi : x;
  }
  static __device__ __forceinline__ T add(T a, T b) { return b < a ? b : a; }
};

struct PlusOne {
  using T = int;
  static constexpr bool kMin = false, kWeighted = false;
  static __host__ __device__ __forceinline__ T ident() { return 0; }
  static __device__ __forceinline__ T mul(T, float) { return 1; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};

// ---------------------------------------------------------------------------
// helpers

// data written by other blocks during the call is read from the L2, never
// from a stale L1 line
template <class T>
__device__ __forceinline__ T ld_cg(const T* p) {
  return __ldcg(p);
}

__device__ __forceinline__ int gather_idx(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int scatter_idx(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

__device__ __forceinline__ void atomic_min(float* a, float v) {
  if (v >= 0.0f)
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_min(int* a, int v) { atomicMin(a, v); }

template <class T>
__device__ __forceinline__ T shfl_xor(T v, int o) {
  return __shfl_xor_sync(kFull, v, o);
}

// One edge's candidate from the dst-sorted copy, or the identity when the
// restriction to the frontier (push of a sum semiring) drops it: the JAX
// push expands only rows v in [0, C) that are in the frontier.
template <class S, bool kRestrict>
__device__ __forceinline__ typename S::T candidate(const int* d_src, const float* d_w,
                                                   const typename S::T* x, const uint8_t* fm,
                                                   int n, int e) {
  const int raw = __ldg(d_src + e);
  if (kRestrict && (raw < 0 || raw >= n || !ld_cg(fm + raw))) return S::ident();
  const float w = S::kWeighted ? __ldg(d_w + e) : 1.0f;
  return S::mul(ld_cg(x + gather_idx(raw, n)), w);
}

// Pull: the reduction of each of the 32 destinations of group g (lane l
// owns g * 32 + l; the identity past n or for an empty segment).  Short
// segments in order by their own lane; long ones by the warp: lane l sums
// e = lo + l, lo + l + 32, ... in order, then a butterfly, whose result
// every lane holds bit for bit (IEEE addition commutes).
template <class S, bool kRestrict>
__device__ typename S::T pull_group(const int* d_off, const int* d_src, const float* d_w,
                                      const typename S::T* x, const uint8_t* fm, int n, int g,
                                      int lane) {
  using T = typename S::T;
  const int d = g * 32 + lane;
  int lo = 0, hi = 0;
  if (d < n) {
    lo = __ldg(d_off + d);
    hi = __ldg(d_off + d + 1);
  }
  T acc = S::ident();
  if (hi - lo <= kShort)
    for (int e = lo; e < hi; ++e) acc = S::add(acc, candidate<S, kRestrict>(d_src, d_w, x, fm, n, e));
  unsigned longs = __ballot_sync(kFull, hi - lo > kShort);
  while (longs) {
    const int owner = __ffs(longs) - 1;
    longs &= longs - 1;
    const int l2 = __shfl_sync(kFull, lo, owner), h2 = __shfl_sync(kFull, hi, owner);
    T part = S::ident();
    // unrolled: four edges' loads in flight before their in-order adds
#pragma unroll 4
    for (int e = l2 + lane; e < h2; e += 32) part = S::add(part, candidate<S, kRestrict>(d_src, d_w, x, fm, n, e));
    for (int o = 16; o > 0; o >>= 1) part = S::add(part, shfl_xor(part, o));
    if (lane == owner) acc = part;
  }
  return acc;
}

template <class S>
__device__ __forceinline__ void relax_at(typename S::T* target, int t, typename S::T c) {
  if (c < ld_cg(target + t)) atomic_min(target + t, c);
}

template <class S>
__device__ __forceinline__ void relax(typename S::T* target, int n, int t_raw, typename S::T c) {
  const int t = scatter_idx(t_raw, n);
  if (t >= 0) relax_at<S>(target, t, c);
}

// ---------------------------------------------------------------------------
// the balanced products (min semirings)

struct Plan {
  int* hdr;                  // FixSlot
  unsigned long long* qctr;  // kQueueSlots
  int* queue;                // the frontier's vertices with an out-edge
  int* qoff;                 // each one's first position among the frontier's edges
  int2* tiles;               // tile t's first merge-path item as (segment ends, edges) passed
};

__host__ __device__ inline int64_t plan_ints(int64_t n, int64_t e) {
  return kPlanHead + 2 * n + 2 * ((n + e + kTile - 1) / kTile + 1);
}

__device__ inline Plan make_plan(int* scratch, int n) {
  return {scratch, reinterpret_cast<unsigned long long*>(scratch + kQueueSlots), scratch + kPlanHead,
          scratch + kPlanHead + n, reinterpret_cast<int2*>(scratch + kPlanHead + 2 * int64_t(n))};
}

// the vertices [vlo, vhi) of this block: a contiguous share of [0, n)
__device__ inline int2 block_range(int n) {
  const int64_t chunk = (int64_t(n) + gridDim.x - 1) / gridDim.x;
  const int64_t lo = blockIdx.x * chunk;
  return make_int2(static_cast<int>(lo < n ? lo : n), static_cast<int>(lo + chunk < n ? lo + chunk : n));
}

__device__ __forceinline__ int out_degree(const int* off, int v) { return __ldg(off + v + 1) - __ldg(off + v); }

// Exclusive block scan of (a, b) over the block's threads in order, with
// the block's totals.  Every thread calls it.
__device__ void block_scan2(int a, int b, int* ea, int* eb, int* ta, int* tb) {
  __shared__ int sa[kWarps], sb[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
  for (int o = 1; o < 32; o <<= 1) {
    const int ua = __shfl_up_sync(kFull, ia, o), ub = __shfl_up_sync(kFull, ib, o);
    if (lane >= o) {
      ia += ua;
      ib += ub;
    }
  }
  if (lane == 31) {
    sa[warp] = ia;
    sb[warp] = ib;
  }
  __syncthreads();
  int wa = 0, wb = 0, sum_a = 0, sum_b = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) {
      wa += sa[w];
      wb += sb[w];
    }
    sum_a += sa[w];
    sum_b += sb[w];
  }
  *ea = wa + ia - a;
  *eb = wb + ib - b;
  *ta = sum_a;
  *tb = sum_b;
  __syncthreads();
}

// Counts this block's frontier into *stat and appends its vertices with
// an out-edge to the queue: one 64-bit atomic reserves the block's rows and
// their edges together (rows in the high word), so the queue's row offsets
// rise with its rows; one block scan gives each thread its place, and each
// thread then writes its own vertices in order.  cnt, rows, edges: this
// thread's counts over v = range.x + threadIdx.x + m * kThreads, whose fm it
// wrote (or reads).
__device__ void enqueue(const uint8_t* fm, const int* off, int2 range, int cnt, int rows, int edges, int* stat,
                        unsigned long long* qctr, int* queue, int* qoff) {
  __shared__ unsigned long long s_base;
  int unused, total_cnt, mine_rows, mine_edges, total_rows, total_edges;
  block_scan2(cnt, rows, &unused, &mine_rows, &total_cnt, &total_rows);
  block_scan2(edges, 0, &mine_edges, &unused, &total_edges, &unused);
  if (threadIdx.x == 0) {
    if (total_cnt) atomicAdd(stat, total_cnt);
    if (total_rows)
      s_base = atomicAdd(qctr, (static_cast<unsigned long long>(total_rows) << 32) |
                                   static_cast<unsigned>(total_edges));
  }
  __syncthreads();
  if (rows == 0) return;
  int q = static_cast<int>(s_base >> 32) + mine_rows, e = static_cast<int>(s_base & 0xffffffffull) + mine_edges;
  for (int v0 = range.x + threadIdx.x; v0 < range.y; v0 += kThreads * kGroup) {
    int d[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int v = v0 + u * kThreads;
      d[u] = v < range.y && fm[v] ? out_degree(off, v) : 0;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u)
      if (d[u] > 0) {
        queue[q] = v0 + u * kThreads;
        qoff[q++] = e;
        e += d[u];
      }
  }
}

// The merge-path coordinate (segment ends passed, edges passed) of item
// `diag` of the merge of the segment ends end[r] = d_off[r + 1] - e0
// (r < n) with the edges 0 .. edges - 1 of [e0, d_off[n]): edge j comes
// before the end of segment r iff j < end[r].
__device__ int2 path_split(const int* d_off, int e0, int n, int edges, int64_t diag) {
  int lo = static_cast<int>(diag > edges ? diag - edges : 0);
  int hi = static_cast<int>(diag < n ? diag : n);
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(d_off + mid + 1) - e0 <= diag - mid - 1)
      lo = mid + 1;
    else
      hi = mid;
  }
  return make_int2(lo, static_cast<int>(diag - lo));
}

// the pull tiles' coordinates, tiles + 1 of them (every thread of the grid
// calls it)
__device__ void plan_tiles(const int* d_off, int e0, int n, int edges, int tiles, int2* out) {
  const int64_t len = int64_t(n) + edges;
  for (int64_t t = blockIdx.x * int64_t(kThreads) + threadIdx.x; t <= tiles; t += int64_t(gridDim.x) * kThreads) {
    const int64_t diag = t * kTile;
    out[t] = path_split(d_off, e0, n, edges, diag < len ? diag : len);
  }
}

// One tile of the balanced pull, from coordinate c0 to c1: the segment
// ends and the edges' candidates staged in shared memory, then kItems
// consecutive merge-path items a thread.  xn[d] holds min(x[d], identity)
// on entry and takes each segment's reduction: stored where the segment
// lies within one thread's items, else min-combined piece by piece.  Every
// thread of the block calls it.
template <class S>
__device__ void pull_tile(const int* d_off, const int* d_src, const float* d_w, const typename S::T* x,
                          typename S::T* xn, int n, int e0, int2 c0, int2 c1, int* s_end, typename S::T* s_val,
                          typename S::T* s_cur) {
  using T = typename S::T;
  __shared__ int s_start;
  const int tid = threadIdx.x, lane = tid & 31;
  const int na = c1.x - c0.x, ne = c1.y - c0.y;
  // the segment ends and starts as positions among the tile's edges, the
  // segments' current values (a segment open at the tile's end included),
  // and the edges' candidates: each thread's loads issued before the first
  // is used
  {
    int src[kItems];
    float w[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int k = tid + u * kThreads;
      if (k < na) s_end[k] = __ldg(d_off + c0.x + k + 1) - e0 - c0.y;
      if (k <= na && c0.x + k < n) s_cur[k] = ld_cg(xn + c0.x + k);
      src[u] = k < ne ? __ldg(d_src + e0 + c0.y + k) : 0;
      w[u] = k < ne && S::kWeighted ? __ldg(d_w + e0 + c0.y + k) : 1.0f;
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int k = tid + u * kThreads;
      if (k < ne) s_val[k] = S::mul(ld_cg(x + gather_idx(src[u], n)), w[u]);
    }
  }
  if (tid == 0) s_start = __ldg(d_off + c0.x) - e0 - c0.y;
  __syncthreads();
  const int len = na + ne;
  const int diag = min(tid * kItems, len), dend = min(diag + kItems, len);
  int lo = max(0, diag - ne), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_end[mid] <= diag - mid - 1)
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo, j = diag - lo;
  bool whole = j == (i == 0 ? s_start : s_end[i - 1]);  // segment i begins in these items
  bool open = false;                                           // acc holds edges of segment i
  T acc = S::ident();
  for (int k = diag; k < dend; ++k) {
    if (j < ne && (i >= na || j < s_end[i])) {
      acc = S::add(acc, s_val[j]);
      ++j;
      open = true;
    } else {
      if (open && acc < s_cur[i]) {  // a stale s_cur costs an atomic at most, never a value
        if (whole)
          xn[c0.x + i] = acc;
        else
          atomic_min(xn + c0.x + i, acc);
      }
      acc = S::ident();
      open = false;
      whole = true;
      ++i;
    }
  }
  // a segment still open after these items: its piece, merged with the
  // pieces of the same segment on the next lanes (lanes holding one
  // segment are consecutive), one atomic from the first of them
  const int row = open ? i : -1;
  for (int o = 1; o < 32; o <<= 1) {
    const T v = __shfl_down_sync(kFull, acc, o);
    const int r = __shfl_down_sync(kFull, row, o);
    if (lane + o < 32 && r == row) acc = S::add(acc, v);
  }
  const int prev = __shfl_up_sync(kFull, row, 1);
  if (row >= 0 && (lane == 0 || prev != row) && acc < s_cur[row]) atomic_min(xn + c0.x + row, acc);
  __syncthreads();  // the next tile reuses the shared arrays
}

// a tile's shared arrays
template <class T>
struct TileSmem {
  int end[kTile];
  T val[kTile];
  T cur[kTile + 1];
};

template <class S>
__device__ void pull_tiles(const int* d_off, const int* d_src, const float* d_w, const typename S::T* x,
                           typename S::T* xn, int n, int e0, int tiles, const int2* coords,
                           TileSmem<typename S::T>& sm) {
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    pull_tile<S>(d_off, d_src, d_w, x, xn, n, e0, ld_cg(coords + t), ld_cg(coords + t + 1), sm.end, sm.val,
                 sm.cur);
}

// The balanced push: the frontier's edges, positions [0, fe) of the queued
// rows laid end to end, split evenly over the grid's warps.  A warp takes
// 32 consecutive positions a step; lane l holds queue row k + l (each has
// an edge, so 32 positions span at most 32 rows), and each lane finds its
// position's row by a binary search over the lanes.
template <class S>
__device__ void push_queue(const int* off, const int* s_dst, const float* s_w, const typename S::T* x,
                           typename S::T* xn, int n, const int* queue, const int* qoff, unsigned long long qc) {
  using T = typename S::T;
  const int q = static_cast<int>(qc >> 32);
  const int64_t fe = static_cast<int64_t>(qc & 0xffffffffull);
  const int lane = threadIdx.x & 31;
  const int64_t warps = int64_t(gridDim.x) * kWarps, w = blockIdx.x * int64_t(kWarps) + (threadIdx.x >> 5);
  const int p0 = static_cast<int>(fe * w / warps), p1 = static_cast<int>(fe * (w + 1) / warps);
  if (p0 >= p1) return;
  int lo = 0, hi = q - 1;  // the row of p0: the last k with qoff[k] <= p0
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (ld_cg(qoff + mid) <= p0)
      lo = mid;
    else
      hi = mid - 1;
  }
  int k = lo;
  for (int base = p0; base < p1; base += 32) {
    const int kk = k + lane;
    int qo = INT_MAX, first = 0;
    T xv = S::ident();
    if (kk < q) {
      qo = ld_cg(qoff + kk);
      const int v = ld_cg(queue + kk);
      first = __ldg(off + v);
      xv = ld_cg(x + v);
    }
    const int p = base + lane;
    int r = 0;  // the last lane whose row starts at or before p
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
      if (__shfl_sync(kFull, qo, r + s) <= p) r += s;
    const int e = __shfl_sync(kFull, first, r) + (p - __shfl_sync(kFull, qo, r));
    const T xr = __shfl_sync(kFull, xv, r);
    if (p < p1) relax<S>(xn, n, __ldg(s_dst + e), S::mul(xr, S::kWeighted ? __ldg(s_w + e) : 1.0f));
    k += __shfl_sync(kFull, r, 31);
  }
}

// A block-wide int sum, added to *dst by one atomic.  Every thread of the
// block calls it.
__device__ void block_add(int a, int* dst) {
  __shared__ int sa[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = __reduce_add_sync(kFull, a);
  if (lane == 0) sa[warp] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < kWarps; ++w) t += sa[w];
    if (t) atomicAdd(dst, t);
  }
  __syncthreads();
}

// A block's f64 sum in a fixed order: each lane's value, a butterfly in
// each warp, then the warps' sums in warp order.  Every thread gets it.
__device__ double block_sum(double v) {
  __shared__ double s[kWarps];
  __shared__ double total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, shfl_xor(v, o));
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t = __dadd_rn(t, s[w]);
    total = t;
  }
  __syncthreads();
  const double out = total;
  __syncthreads();
  return out;
}

// The sum of the grid's block partials p[0..nb) in a fixed order, the same
// bits in every block: lane l adds p[l], p[l + 32], ... in order, then a
// butterfly.  Every thread of the block calls it and gets the sum.
__device__ double grid_sum(const double* p, int nb) {
  __shared__ double total;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    double v = 0.0;
    for (int i = lane; i < nb; i += 32) v = __dadd_rn(v, ld_cg(p + i));
    for (int o = 16; o > 0; o >>= 1) v = __dadd_rn(v, shfl_xor(v, o));
    if (lane == 0) total = v;
  }
  __syncthreads();
  const double out = total;
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------------------
// one-shot products (spmv_dense, spmsv_frontier)

// Sum semirings: y = the ordered segment sum over every destination, or
// (push) over the edges whose source is in the frontier fm.
template <class S, bool kPush>
__global__ void __launch_bounds__(kThreads) product_kernel(const int* d_off, const int* d_src, const float* d_w,
                                                           const typename S::T* x, const uint8_t* fm,
                                                           typename S::T* y, int n) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  const int groups = (n + 31) / 32;
  for (int g = blockIdx.x * kWarps + (threadIdx.x >> 5); g < groups; g += warps) {
    const typename S::T acc = pull_group<S, kPush>(d_off, d_src, d_w, x, fm, n, g, lane);
    const int d = g * 32 + lane;
    if (d < n) y[d] = S::add(S::ident(), acc);
  }
}

// Min semirings: y = combine(identity, the balanced pull or push), as one
// iteration of the fixpoint computes it (a cooperative launch: the plan,
// then the product).
template <class S, bool kPush>
__global__ void __launch_bounds__(kThreads) product_min_kernel(const int* off, const int* s_dst, const float* s_w,
                                                               const int* d_off, const int* d_src, const float* d_w,
                                                               const typename S::T* x, const uint8_t* fm,
                                                               typename S::T* y, int n, int* scratch) {
  using T = typename S::T;
  cg::grid_group grid = cg::this_grid();
  const Plan pl = make_plan(scratch, n);
  const int2 range = block_range(n);
  const int e0 = __ldg(d_off), edges = __ldg(d_off + n) - e0;
  const int tiles = static_cast<int>((int64_t(n) + edges + kTile - 1) / kTile);
  int cnt = 0, rows = 0, fe = 0;
  for (int v = range.x + threadIdx.x; v < range.y; v += kThreads) {
    y[v] = S::ident();
    if (kPush && fm[v]) {
      const int d = out_degree(off, v);
      ++cnt;
      rows += d > 0;
      fe += d;
    }
  }
  if constexpr (kPush) {
    enqueue(fm, off, range, cnt, rows, fe, pl.hdr + kStats, pl.qctr, pl.queue, pl.qoff);
  } else {
    plan_tiles(d_off, e0, n, edges, tiles, pl.tiles);
  }
  grid.sync();
  if constexpr (kPush) {
    push_queue<S>(off, s_dst, s_w, x, y, n, pl.queue, pl.qoff, ld_cg(pl.qctr));
  } else {
    __shared__ TileSmem<T> sm;
    pull_tiles<S>(d_off, d_src, d_w, x, y, n, e0, tiles, pl.tiles, sm);
  }
}

// ---------------------------------------------------------------------------
// the direction-optimized fixpoint (min semirings)
//
// xs: two buffers of n.  Iteration `it` reads buffer it & 1 (x) and writes
// buffer (it & 1) ^ 1 (xn), which holds min(x, identity) when the
// iteration starts: the prologue sets buffer 1 so, and each iteration's
// frontier phase copies xn into the buffer it read, which is the next
// iteration's target.  So after the last iteration both buffers hold the
// result, and the caller reads buffer 0 (x0 itself when no iteration ran).
//
// Each iteration: read the frontier's size (reduced in the last phase of
// the iteration before, or the prologue), stop on an empty frontier or at
// max_iters, else dens = size / max(n_active, 1) in f32 and pull iff
// dens > thr (thr 2 forces push, -1 pull); the balanced product; grid
// sync; the frontier xn != x, its size and queue into the next slots;
// grid sync.  Block 0's thread 0 keeps the counters of the JAX loop (push
// and pull iterations, switches, the density histogram).  The JAX
// package's host loop also escalates through frontier-capacity buckets (a
// shape device of XLA); the largest bucket holds every frontier, and no
// bucket changes an iteration or its direction, so this loop runs the
// same iterations.

template <class S>
__global__ void __launch_bounds__(kThreads, 4) fixpoint_kernel(
    const int* off, const int* s_dst, const float* s_w, const int* d_off, const int* d_src,
    const float* d_w, const int* n_active, int n, const typename S::T* x0, const uint8_t* fm0,
    typename S::T* xs, uint8_t* fm, float thr, int max_iters, int* scratch) {
  using T = typename S::T;
  __shared__ TileSmem<T> sm;
  cg::grid_group grid = cg::this_grid();
  const Plan pl = make_plan(scratch, n);
  int* hdr = pl.hdr;
  const int2 range = block_range(n);
  const int e0 = __ldg(d_off), edges = __ldg(d_off + n) - e0;
  const int tiles = static_cast<int>((int64_t(n) + edges + kTile - 1) / kTile);

  // prologue: x, the push target, the frontier, its size and queue; the
  // pull tiles
  {
    int cnt = 0, rows = 0, fe = 0;
    for (int v = range.x + threadIdx.x; v < range.y; v += kThreads) {
      const T x = x0[v];
      xs[v] = x;
      xs[n + v] = S::add(x, S::ident());
      const uint8_t f = fm0[v] ? 1 : 0;
      fm[v] = f;
      if (f) {
        const int d = out_degree(off, v);
        ++cnt;
        rows += d > 0;
        fe += d;
      }
    }
    enqueue(fm, off, range, cnt, rows, fe, hdr + kStats, pl.qctr, pl.queue, pl.qoff);
    plan_tiles(d_off, e0, n, edges, tiles, pl.tiles);
  }
  grid.sync();
  const int act = *n_active;
  const float denom = __int2float_rn(act > 1 ? act : 1);
  int push_i = 0, pull_i = 0, switches = 0, last_dir = -1;
  int it = 0;
  for (;; ++it) {
    const int slot = it % 3, next = (it + 1) % 3;
    const int cnt = ld_cg(hdr + kStats + slot);
    if (cnt == 0 || it >= max_iters) break;
    const float dens = __fdiv_rn(__int2float_rn(cnt), denom);
    const bool pull = dens > thr;
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      // the slots read two iterations ago are the ones the next frontier fills
      hdr[kStats + (it + 2) % 3] = 0;
      pl.qctr[(it + 2) % 3] = 0;
      const int d = pull ? 1 : 0;
      if (last_dir >= 0 && d != last_dir) ++switches;
      last_dir = d;
      pull ? ++pull_i : ++push_i;
      const float scaled = __fmul_rn(dens, float(kBins));
      const int b = scaled >= float(kBins - 1) ? kBins - 1 : static_cast<int>(scaled);
      ++hdr[kHist + b];
    }
    const T* x = xs + (it & 1) * int64_t(n);
    T* xn = xs + ((it & 1) ^ 1) * int64_t(n);
    if (pull)
      pull_tiles<S>(d_off, d_src, d_w, x, xn, n, e0, tiles, pl.tiles, sm);
    else
      push_queue<S>(off, s_dst, s_w, x, xn, n, pl.queue, pl.qoff, ld_cg(pl.qctr + slot));
    grid.sync();
    {
      int c2 = 0, rows = 0, fe = 0;
      T* xw = xs + (it & 1) * int64_t(n);
      for (int v0 = range.x + threadIdx.x; v0 < range.y; v0 += kThreads * kGroup) {
        T a[kGroup], b[kGroup];
        int lo[kGroup], hi[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {  // every load before the stores (xw is x)
          const int v = v0 + u * kThreads;
          if (v < range.y) {
            a[u] = ld_cg(xn + v);
            b[u] = ld_cg(x + v);
            lo[u] = __ldg(off + v);
            hi[u] = __ldg(off + v + 1);
          }
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int v = v0 + u * kThreads;
          if (v < range.y) {
            const uint8_t f = a[u] != b[u];
            fm[v] = f;
            xw[v] = a[u];  // the next iteration's push target
            if (f) {
              const int d = hi[u] - lo[u];
              ++c2;
              rows += d > 0;
              fe += d;
            }
          }
        }
      }
      enqueue(fm, off, range, c2, rows, fe, hdr + kStats + next, pl.qctr + next, pl.queue, pl.qoff);
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    hdr[kBlocks] = gridDim.x;
    hdr[kIters] = it;
    hdr[kPushIters] = push_i;
    hdr[kPullIters] = pull_i;
    hdr[kSwitches] = switches;
  }
}

// ---------------------------------------------------------------------------
// PageRank (pagerank_fixpoint's loop)
//
// in_window[v]: v has a masked out- or in-edge (off, d_off); n_win = their
// count; r0 = 1 / max(n_win, 1) on the window.  An iteration: c[v] = r[v] /
// max(out_deg[v], 1) (the division each edge of the JAX loop makes, once a
// source); the spread of d, the sum of c over d's in-segment; r_new = base
// + damping * (spread + dm on the window), dm the r of the window's
// vertices with no out-edge summed, over n_win; the L1 delta.  Loop while
// delta > tol and it < max_iters.  The three sums (spread, dangling mass,
// delta) accumulate in f64 and round to f32 once, so they are the exact
// sums' roundings up to the f64 error: the twin (ops/spmv.
// pagerank_fixpoint_plain, atomics in no fixed order on the card) agrees to
// an ulp and takes the same iterations.
//
// The spread is balanced over the edges: the merge path of the segment
// ends d_off[1..C] with the edges (plan_tiles, searched once a launch) cut
// into tiles of kTile items, a block a tile, kItems consecutive items a
// thread.  A thread adds its items' c in f64 in edge order and stores
// r_new of a segment that begins and ends in its items.  The pieces of a
// longer segment combine in an order that the plan alone fixes:
//   - within a tile: a segmented inclusive scan of the threads' open pieces
//     (Kogge-Stone over a warp's lanes, then the warps' totals folded in
//     warp order); the scan through the thread before the one holding the
//     segment's end, plus that thread's head piece, is the sum;
//   - across tiles: a tile writes its head piece (its items before its
//     first segment end) and its tail piece (after its last end; both are
//     the whole tile where it holds no end) to two carry slots, and in the
//     next vertex phase the destination's owner adds the tail of the tile
//     where its segment begins and the heads of the tiles after it, up to
//     the one holding its end, in tile order.
// No float atomics: the bits depend on the data and kTile alone, never on
// the grid's size or on timing, so push, pull and a second run agree.  A
// hub of ~17,500 in-edges at Graph500 scale 20 spans ~9 tiles, which ~9
// blocks sum at once.  What is left on the H100 is the tiles' random 4-byte
// gathers of c, a 32-byte L2 sector each, which take most of an iteration
// (chip_smoke.py phase 16 (b) splits it), not the bytes bound (above).
//
// A launch: in_window, its count and the tiles' coordinates; grid sync;
// the vertex phase (below) with r = r0; grid sync; then each iteration:
// delta and dm from the partials in chunk order (grid_sum, the same bits in
// every block), the tiles, grid sync, the vertex phase, grid sync.  Two
// grid syncs an iteration: the fix-up of segments spanning tiles rides in
// the next vertex phase, whose owner finalizes r and then computes c from
// it.  The vertex phase takes a chunk of kTile vertices a block at a time,
// so its f64 partials (the dangling r, |r_new - r|) are the chunks' in
// chunk order, whatever the grid.

// the scratch: the header, c [n] (padded to 8 bytes), the chunks' partials
// (the dangling mass's [chunks], then the delta's [chunks]), the tiles'
// coordinates [tiles + 1] (int2) and carries (head, tail: two a tile)
struct RankPlan {
  int* hdr;  // RankSlot
  float* c;
  double* partials;
  int2* tiles;
  double* carries;
};

__host__ __device__ inline int64_t rank_chunks(int64_t n) { return (n + kTile - 1) / kTile; }
__host__ __device__ inline int64_t rank_tiles(int64_t n, int64_t e) { return (n + e + kTile - 1) / kTile; }

__host__ __device__ inline int64_t rank_bytes(int64_t n, int64_t e) {
  return 4 * (kRankHeaderInts + ((n + 1) & ~int64_t(1))) + 16 * rank_chunks(n) + 8 * (rank_tiles(n, e) + 1) +
         16 * rank_tiles(n, e);
}

__device__ inline RankPlan make_rank_plan(int* scratch, int n, int chunks, int tiles) {
  float* c = reinterpret_cast<float*>(scratch + kRankHeaderInts);
  double* partials = reinterpret_cast<double*>(c + ((int64_t(n) + 1) & ~int64_t(1)));
  int2* coords = reinterpret_cast<int2*>(partials + 2 * int64_t(chunks));
  return {scratch, c, partials, coords, reinterpret_cast<double*>(coords + tiles + 1)};
}

// r_new of a destination from its f32 spread: the JAX loop's f32 steps
__device__ __forceinline__ float new_rank(float sp, bool w, float base_in, float damping, float dm) {
  return __fadd_rn(w ? base_in : 0.0f, __fmul_rn(damping, __fadd_rn(sp, w ? dm : 0.0f)));
}

// a rank tile's shared arrays
struct RankSmem {
  int end[kTile];
  float val[kTile];
  double warp_v[kWarps];
  int warp_f[kWarps];
  int start;
};

// Tile t of the spread, from coordinate c0 to c1: the segment ends and the
// edges' c staged in shared memory, then kItems consecutive items a
// thread.  Stores r_new (into rn) of each non-empty segment that lies in
// the tile, and the tile's head and tail pieces into carries[2t],
// carries[2t + 1].  Every thread of the block calls it.
__device__ void rank_tile(const int* d_off, const int* d_src, const float* c, float* rn, int n, int e0, int t,
                          int2 c0, int2 c1, float base_in, float damping, float dm, double* carries, RankSmem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int na = c1.x - c0.x, ne = c1.y - c0.y;
  {
    int src[kItems];
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int k = tid + u * kThreads;
      if (k < na) sm.end[k] = __ldg(d_off + c0.x + k + 1) - e0 - c0.y;
      src[u] = k < ne ? __ldg(d_src + e0 + c0.y + k) : 0;
    }
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int k = tid + u * kThreads;
      if (k < ne) sm.val[k] = ld_cg(c + gather_idx(src[u], n));
    }
  }
  if (tid == 0) sm.start = __ldg(d_off + c0.x) - e0 - c0.y;
  __syncthreads();
  const int len = na + ne;
  const int diag = min(tid * kItems, len), dend = min(diag + kItems, len);
  int lo = max(0, diag - ne), hi = min(diag, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sm.end[mid] <= diag - mid - 1)
      lo = mid + 1;
    else
      hi = mid;
  }
  int i = lo, j = diag - lo;
  const bool starts = j == (i == 0 ? sm.start : sm.end[i - 1]);  // segment i begins at these items
  bool whole = starts, any = false, ends = false;
  int head_row = -1;  // the segment begun before these items that ends in them
  double acc = 0.0, head = 0.0;
  for (int k = diag; k < dend; ++k) {
    if (j < ne && (i >= na || j < sm.end[i])) {
      acc = __dadd_rn(acc, static_cast<double>(sm.val[j]));
      ++j;
      any = true;
    } else {
      if (!whole) {
        head = acc;
        head_row = i;
      } else if (any) {
        rn[c0.x + i] = new_rank(__double2float_rn(acc), true, base_in, damping, dm);
      }
      acc = 0.0;
      whole = ends = true;
      any = false;
      ++i;
    }
  }
  // the segmented scan of the open pieces (acc): f marks a piece whose
  // segment begins in its thread's items; a thread with no items passes
  // the scan through
  int f = ends || (starts && diag < dend);
  double v = acc;
  for (int o = 1; o < 32; o <<= 1) {
    const double vu = __shfl_up_sync(kFull, v, o);
    const int fu = __shfl_up_sync(kFull, f, o);
    if (lane >= o) {
      if (!f) v = __dadd_rn(vu, v);
      f |= fu;
    }
  }
  if (lane == 31) {
    sm.warp_v[warp] = v;
    sm.warp_f[warp] = f;
  }
  __syncthreads();
  double pv = 0.0;  // the warps before this one, folded in warp order
  int pf = 0;
  for (int w = 0; w < warp; ++w) {
    pv = sm.warp_f[w] ? sm.warp_v[w] : __dadd_rn(pv, sm.warp_v[w]);
    pf |= sm.warp_f[w];
  }
  if (!f) v = __dadd_rn(pv, v);
  f |= pf;
  double qv = __shfl_up_sync(kFull, v, 1);  // the scan through the thread before this one
  int qf = __shfl_up_sync(kFull, f, 1);
  if (lane == 0) {
    qv = pv;
    qf = pf;
  }
  if (head_row >= 0) {
    const double s = __dadd_rn(qv, head);
    if (qf)  // the segment begins in this tile
      rn[c0.x + head_row] = new_rank(__double2float_rn(s), true, base_in, damping, dm);
    else
      carries[2 * int64_t(t)] = s;
  }
  if (tid == kThreads - 1) {
    carries[2 * int64_t(t) + 1] = v;
    if (!f) carries[2 * int64_t(t)] = v;  // no segment ends in the tile
  }
  __syncthreads();  // the next tile reuses the shared arrays
}

// The vertex phase over this block's chunks of kTile vertices (kItems a
// thread): r finalized into rn (kFirst: r0 on the window; else the tile's
// store, the carries' sum for a segment spanning tiles, or r_new of an
// empty segment), c = r / max(out_deg, 1), and each chunk's f64 partials of
// the dangling r and of |r - r_prev| (a thread's vertices in order, then
// block_sum).  Every thread of the block calls it.
template <bool kFirst>
__device__ void rank_vertices(const int* off, const int* d_off, const uint8_t* in_window, const RankPlan& rp,
                              const float* r, float* rn, int n, int e0, int chunks, float r0, float base_in,
                              float damping, float dm) {
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    const int v0 = ch * kTile, vn = min(kTile, n - v0);
    double dang = 0.0, dl = 0.0;
    for (int m0 = 0; m0 < kItems; m0 += kGroup) {
      int od[kGroup], lo[kGroup], hi[kGroup];
      bool w[kGroup];
      float prev[kGroup], got[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {  // every load before the first use
        const int k = (m0 + u) * kThreads + threadIdx.x, v = v0 + k;
        if (k < vn) {
          od[u] = __ldg(off + v + 1) - __ldg(off + v);
          lo[u] = __ldg(d_off + v) - e0;
          hi[u] = __ldg(d_off + v + 1) - e0;
          w[u] = ld_cg(in_window + v);
          if (!kFirst) {
            prev[u] = ld_cg(r + v);
            got[u] = ld_cg(rn + v);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int k = (m0 + u) * kThreads + threadIdx.x, v = v0 + k;
        if (k >= vn) continue;
        float rv;
        if (kFirst) {
          rv = w[u] ? r0 : 0.0f;
          rn[v] = rv;
        } else {
          const int64_t t0 = (int64_t(v) + lo[u]) / kTile, t1 = (int64_t(v) + hi[u]) / kTile;
          if (lo[u] == hi[u]) {
            rv = new_rank(0.0f, w[u], base_in, damping, dm);
            rn[v] = rv;
          } else if (t0 == t1) {
            rv = got[u];
          } else {
            double s = ld_cg(rp.carries + 2 * t0 + 1);
            for (int64_t t = t0 + 1; t <= t1; ++t) s = __dadd_rn(s, ld_cg(rp.carries + 2 * t));
            rv = new_rank(__double2float_rn(s), true, base_in, damping, dm);
            rn[v] = rv;
          }
          dl = __dadd_rn(dl, static_cast<double>(fabsf(__fsub_rn(rv, prev[u]))));
        }
        rp.c[v] = __fdiv_rn(rv, fmaxf(__int2float_rn(od[u]), 1.0f));
        if (od[u] == 0 && w[u]) dang = __dadd_rn(dang, static_cast<double>(rv));
      }
    }
    dang = block_sum(dang);
    if (!kFirst) dl = block_sum(dl);
    if (threadIdx.x == 0) {
      rp.partials[ch] = dang;
      rp.partials[chunks + ch] = dl;
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4) pagerank_kernel(const int* off, const int* d_off,
                                                               const int* d_src, int n, float damping,
                                                               float tol, int max_iters, float* rs,
                                                               uint8_t* in_window, int* scratch) {
  __shared__ RankSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int e0 = __ldg(d_off), edges = __ldg(d_off + n) - e0;
  const int chunks = static_cast<int>(rank_chunks(n)), tiles = static_cast<int>(rank_tiles(n, edges));
  const RankPlan rp = make_rank_plan(scratch, n, chunks, tiles);
  {
    int cnt = 0;
    for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
      const int v0 = ch * kTile, vn = min(kTile, n - v0);
      for (int k = threadIdx.x; k < vn; k += kThreads) {
        const int v = v0 + k;
        const bool w = __ldg(off + v + 1) > __ldg(off + v) || __ldg(d_off + v + 1) > __ldg(d_off + v);
        in_window[v] = w;
        cnt += w;
      }
    }
    block_add(cnt, rp.hdr + kWindowCount);
    plan_tiles(d_off, e0, n, edges, tiles, rp.tiles);
  }
  grid.sync();
  const float nf = fmaxf(__int2float_rn(ld_cg(rp.hdr + kWindowCount)), 1.0f);
  const float base_in = __fdiv_rn(__fsub_rn(1.0f, damping), nf);
  const float r0 = __fdiv_rn(1.0f, nf);
  rank_vertices<true>(off, d_off, in_window, rp, nullptr, rs, n, e0, chunks, r0, base_in, damping, 0.0f);
  grid.sync();
  int it = 0;
  for (;; ++it) {
    const float delta = it == 0 ? __int_as_float(0x7f800000)  // +inf
                                : __double2float_rn(grid_sum(rp.partials + chunks, chunks));
    if (!(delta > tol && it < max_iters)) break;
    const float dm = __fdiv_rn(__double2float_rn(grid_sum(rp.partials, chunks)), nf);
    const float* r = rs + (it & 1) * int64_t(n);
    float* rn = rs + ((it & 1) ^ 1) * int64_t(n);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      rank_tile(d_off, d_src, rp.c, rn, n, e0, t, ld_cg(rp.tiles + t), ld_cg(rp.tiles + t + 1), base_in, damping,
                dm, rp.carries, sm);
    grid.sync();
    rank_vertices<false>(off, d_off, in_window, rp, r, rn, n, e0, chunks, r0, base_in, damping, dm);
    grid.sync();
  }
  if (it & 1)
    for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
      const int v0 = ch * kTile, vn = min(kTile, n - v0);
      for (int k = threadIdx.x; k < vn; k += kThreads) rs[v0 + k] = ld_cg(rs + int64_t(n) + v0 + k);
    }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    rp.hdr[kRankIters] = it;
    rp.hdr[kRankBlocks] = gridDim.x;
  }
}

// ---------------------------------------------------------------------------
// launch plumbing

// The blocks of `kernel` (kThreads a block) that fit on the current device
// at once, queried once a kernel and device.
int resident_blocks(const void* kernel, cudaError_t* err) {
  struct Fit {
    const void* kernel;
    int device, blocks;
  };
  static std::mutex mu;
  static Fit cache[64];
  static int cached = 0;
  int device = 0;
  if ((*err = cudaGetDevice(&device)) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < cached; ++i)
    if (cache[i].kernel == kernel && cache[i].device == device) return cache[i].blocks;
  int sms = 0, per_sm = 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) != cudaSuccess)
    return 0;
  if (cached < 64) cache[cached++] = {kernel, device, sms * per_sm};
  return sms * per_sm;
}

// A cooperative launch of `kernel` over `items` threads' worth of work (at
// most the blocks that fit on the card at once).
cudaError_t launch_cooperative(const void* kernel, int64_t items, void** args, cudaStream_t s) {
  cudaError_t err;
  const int64_t fit = resident_blocks(kernel, &err);
  if (err != cudaSuccess) return err;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < fit ? blocks : fit;
  blocks = blocks > 0 ? blocks : 1;
  return cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0, s);
}

// The balanced products' work in threads (launch_cooperative's items): a
// block a pull tile over the pane's padded edges e, or a thread a vertex.
int64_t product_items(int n, int e) {
  const int64_t tiles = (int64_t(n) + e + kTile - 1) / kTile;
  return tiles * kThreads > n ? tiles * kThreads : n;
}

int product_blocks(int n) {
  const int64_t groups = (static_cast<int64_t>(n) + 31) / 32;
  int64_t blocks = (groups + kWarps - 1) / kWarps;
  blocks = blocks < 4096 ? blocks : 4096;
  return static_cast<int>(blocks > 0 ? blocks : 1);
}

template <class S, bool kPush>
int min_product(const int* off, const int* s_dst, const float* s_w, const int* d_off, const int* d_src,
                const float* d_w, const typename S::T* x, const uint8_t* fm, typename S::T* y, int n, int e,
                int* scratch, cudaStream_t s) {
  void* args[] = {&off, &s_dst, &s_w, &d_off, &d_src, &d_w, &x, &fm, &y, &n, &scratch};
  const cudaError_t err = launch_cooperative(reinterpret_cast<const void*>(product_min_kernel<S, kPush>),
                                             product_items(n, e), args, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <class S>
int product_launch(int push, const void* off, const void* s_dst, const void* s_w, const void* d_off,
                   const void* d_src, const void* d_w, const void* x, const void* fm, void* y, int n, int e,
                   void* scratch, long long scratch_bytes, cudaStream_t s) {
  using T = typename S::T;
  auto* d_off_p = static_cast<const int*>(d_off);
  auto* d_src_p = static_cast<const int*>(d_src);
  auto* d_w_p = static_cast<const float*>(d_w);
  auto* x_p = static_cast<const T*>(x);
  auto* fm_p = static_cast<const uint8_t*>(fm);
  auto* y_p = static_cast<T*>(y);
  if constexpr (S::kMin) {
    if (scratch_bytes < 4 * plan_ints(n, e)) return static_cast<int>(cudaErrorInvalidValue);
    auto* sc = static_cast<int*>(scratch);
    const cudaError_t err = cudaMemsetAsync(sc, 0, kPlanHead * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    auto* off_p = static_cast<const int*>(off);
    auto* s_dst_p = static_cast<const int*>(s_dst);
    auto* s_w_p = static_cast<const float*>(s_w);
    return push ? min_product<S, true>(off_p, s_dst_p, s_w_p, d_off_p, d_src_p, d_w_p, x_p, fm_p, y_p, n, e, sc, s)
                : min_product<S, false>(off_p, s_dst_p, s_w_p, d_off_p, d_src_p, d_w_p, x_p, fm_p, y_p, n, e, sc,
                                        s);
  } else {
    const int blocks = product_blocks(n);
    if (push)
      product_kernel<S, true><<<blocks, kThreads, 0, s>>>(d_off_p, d_src_p, d_w_p, x_p, fm_p, y_p, n);
    else
      product_kernel<S, false><<<blocks, kThreads, 0, s>>>(d_off_p, d_src_p, d_w_p, x_p, fm_p, y_p, n);
    return static_cast<int>(cudaGetLastError());
  }
}

template <class S>
int fixpoint_launch(const void* off, const void* s_dst, const void* s_w, const void* d_off, const void* d_src,
                    const void* d_w, const void* n_active, int n, int e, const void* x0, const void* fm0, void* xs,
                    void* fm, float thr, int max_iters, int* scratch, cudaStream_t s) {
  using T = typename S::T;
  cudaError_t err = cudaMemsetAsync(scratch, 0, kPlanHead * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* off_p = static_cast<const int*>(off);
  auto* s_dst_p = static_cast<const int*>(s_dst);
  auto* s_w_p = static_cast<const float*>(s_w);
  auto* d_off_p = static_cast<const int*>(d_off);
  auto* d_src_p = static_cast<const int*>(d_src);
  auto* d_w_p = static_cast<const float*>(d_w);
  auto* act_p = static_cast<const int*>(n_active);
  auto* x0_p = static_cast<const T*>(x0);
  auto* fm0_p = static_cast<const uint8_t*>(fm0);
  auto* xs_p = static_cast<T*>(xs);
  auto* fm_p = static_cast<uint8_t*>(fm);
  void* args[] = {&off_p, &s_dst_p, &s_w_p, &d_off_p, &d_src_p, &d_w_p, &act_p, &n,
                  &x0_p, &fm0_p, &xs_p, &fm_p, &thr, &max_iters, &scratch};
  err = launch_cooperative(reinterpret_cast<const void*>(fixpoint_kernel<S>), product_items(n, e), args, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The scratch bytes of one spmv_fixpoint_launch, or of one
// spmv_product_launch of a min semiring, over n vertices and at most e
// edges: the header, the frontier queue and the pull tiles.
long long spmv_fixpoint_scratch_bytes(int n, int e) { return 4 * plan_ints(n, e); }

// sem: 0 min_plus (f32 x, y), 1 plus_times (f32), 2 min_min (int32),
// 3 plus_one (int32); push: 0 pull over every destination, 1 the push
// lowering restricted to fm (uint8[n]); off, d_off: int32[n + 1]; s_dst,
// d_src: int32[E]; s_w, d_w: f32[E] (unit weights when the pane has
// none); x: the semiring's type [n]; y: the same [n], written whole; e:
// the pane's padded edge count (E <= e); scratch: a min semiring's
// spmv_fixpoint_scratch_bytes(n, e) bytes (unused by a sum semiring, may
// be null).  Enqueues one product on the stream (a min semiring: one
// cooperative launch, the balanced product; a sum semiring: the ordered
// segment sums), with no host sync.
int spmv_product_launch(int sem, int push, const void* off, const void* s_dst, const void* s_w,
                        const void* d_off, const void* d_src, const void* d_w, const void* x,
                        const void* fm, void* y, int n, int e, void* scratch, long long scratch_bytes,
                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  switch (sem) {
    case kMinPlus:
      return product_launch<MinPlus>(push, off, s_dst, s_w, d_off, d_src, d_w, x, fm, y, n, e, scratch,
                                     scratch_bytes, s);
    case kPlusTimes:
      return product_launch<PlusTimes>(push, off, s_dst, s_w, d_off, d_src, d_w, x, fm, y, n, e, scratch,
                                       scratch_bytes, s);
    case kMinMin:
      return product_launch<MinMin>(push, off, s_dst, s_w, d_off, d_src, d_w, x, fm, y, n, e, scratch,
                                    scratch_bytes, s);
    case kPlusOne:
      return product_launch<PlusOne>(push, off, s_dst, s_w, d_off, d_src, d_w, x, fm, y, n, e, scratch,
                                     scratch_bytes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// sem: 0 min_plus or 2 min_min; the pane as for spmv_product_launch;
// n_active: int32 on the device (the density's denominator); x0, fm0: the
// start (x0 the semiring's type [n], fm0 uint8[n]), unchanged; xs: two
// buffers [2n], the result in the first n; fm: uint8[n], the last
// frontier; thr: the density above which an iteration pulls (2 forces
// push, -1 pull); scratch: spmv_fixpoint_scratch_bytes(n, e) bytes, whose
// first int32[24] are the header (after the call: slot 3 the iterations,
// 4 push and 5 pull iterations, 6 direction switches, 7-14 the density
// histogram, 22 the launch's blocks).  One cooperative launch runs the
// whole loop on the stream, with no host sync.
int spmv_fixpoint_launch(int sem, const void* off, const void* s_dst, const void* s_w, const void* d_off,
                         const void* d_src, const void* d_w, const void* n_active, int n, int e, const void* x0,
                         const void* fm0, void* xs, void* fm, float thr, int max_iters, void* scratch,
                         long long scratch_bytes, void* stream) {
  if (scratch_bytes < 4 * plan_ints(n, e)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto* sc = static_cast<int*>(scratch);
  auto s = static_cast<cudaStream_t>(stream);
  switch (sem) {
    case kMinPlus:
      return fixpoint_launch<MinPlus>(off, s_dst, s_w, d_off, d_src, d_w, n_active, n, e, x0, fm0, xs, fm, thr,
                                      max_iters, sc, s);
    case kMinMin:
      return fixpoint_launch<MinMin>(off, s_dst, s_w, d_off, d_src, d_w, n_active, n, e, x0, fm0, xs, fm, thr,
                                     max_iters, sc, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The scratch bytes of one pagerank_fixpoint_launch over n vertices and
// at most e edges: the header, c, the chunks' partials, the tiles'
// coordinates and carries.
long long pagerank_scratch_bytes(int n, int e) { return rank_bytes(n, e); }

// off, d_off: int32[n + 1]; d_src: int32[E], ids in [0, n); e: the pane's
// padded edge count (E <= e); rs: f32[2n], the ranks in the first n;
// in_window: uint8[n]; scratch: pagerank_scratch_bytes(n, e) bytes (int32
// slot 1 = the iterations run, 2 = the launch's blocks).  A memset, then
// one cooperative launch, with no host sync.
int pagerank_fixpoint_launch(const void* off, const void* d_off, const void* d_src, int n, int e, float damping,
                             float tol, int max_iters, void* rs, void* in_window, void* scratch,
                             long long scratch_bytes, void* stream) {
  if (scratch_bytes < rank_bytes(n, e)) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(sc, 0, kRankHeaderInts * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* off_p = static_cast<const int*>(off);
  auto* d_off_p = static_cast<const int*>(d_off);
  auto* d_src_p = static_cast<const int*>(d_src);
  auto* rs_p = static_cast<float*>(rs);
  auto* w_p = static_cast<uint8_t*>(in_window);
  void* args[] = {&off_p, &d_off_p, &d_src_p, &n, &damping, &tol, &max_iters, &rs_p, &w_p, &sc};
  err = launch_cooperative(reinterpret_cast<const void*>(pagerank_kernel), product_items(n, e), args, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
