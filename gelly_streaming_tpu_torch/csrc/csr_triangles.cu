// Masked-CSR triangle count of K panes on Hopper (sm_90a) behind a plain C
// interface, loaded with ctypes (gelly_streaming_tpu_torch/ops/_cuda.py,
// ops/csr_triangles.py).
//
// Replaces two XLA programs of the JAX package (gelly_streaming_tpu/library/
// triangles.py): _superpane_count_fn (:229-259), the superbatch plane's
// vmapped count over K panes, and _count_kernel_impl (:322-338), the same
// count for one pane past the dense kernels' vertex bound.  Both build a
// padded neighbor table [n_v, D] of the pane's edges in both directions and
// reduce, for every ok slot (u, v), an [E, D, D] equality tensor: the sum of
// |N(u) & N(v)| (multisets: a neighbor w adds m(u, w) * m(v, w)) is three
// times the pane's triangle count.  That is E * D^2 work and bytes of
// intermediates in XLA; a hub row of 2^17 neighbors cannot be counted.
//
// Here all K panes go through one C call, five launches:
//   a memset of the counters;
//   csr_degree_kernel: the histogram of the K * n_v rows (row = pane * n_v +
//   id) of the valid slots (ok, both ids in [0, n_v); others are dropped),
//   lanes that add to one row adding once;
//   csr_scan_kernel: the row offsets, an exclusive scan with a decoupled
//   look-back (tiles by ticket), and the list of rows longer than kWarpRow;
//   csr_scatter_kernel: each valid slot (u, v) is given to its owner L, the
//   endpoint with the longer row (ties: the larger id; a self-loop's u-side
//   entry), and writes the entry L -> S at the front of L's row and S -> L
//   at the back of S's, so a row's first own[L] entries are the slots it
//   owns and the whole row is N(L).  No order inside a row is needed, so the
//   CSR is built by counting, not sorting.  A long owner adds d(S) to its
//   work, and the last block to finish cuts the long rows into chunks;
//   csr_count_kernel (persistent): each owner stages N(L) in shared memory
//   once and streams the rows N(S) of its owned slots past it, coalesced
//   from L2, one lookup an entry: a slot costs min(d_u, d_v) lookups.  A
//   warp's 32 owned slots have their rows laid end to end and walked 32
//   positions a step, so short rows fill the lanes as well as long ones.
//   Long rows (past kWarpRow entries) come first, a block a chunk: a bitmap
//   over the pane's ids (n_v / 8 bytes: 512 B at n_v = 4096, 22 KB at
//   175,957), rebuilt by each chunk's block; a chunk takes about
//   w / max(d, kMinChunkWork) of the row's owned slots (w their rows' total
//   length), so the rebuild stays below its streaming, and at most
//   kChunkOwned of them, so a star's leaves spread over many blocks.  A row
//   whose build finds a repeated neighbor (atomicOr returns the bit set) is
//   redone with 32-bit counts.  Where the ids pass the block's shared memory
//   (n_v past 8 * kLookupCap, ~1.5M), the lookup runs in passes over ranges
//   of ids, each pass streaming the chunk's rows again: right, not fast.
//   Then the short rows, a warp each: a filter of kFilterBits bits (the ids
//   themselves where n_v fits it) and, where the filter alone cannot count
//   (hashed ids, or a repeated neighbor), an (id, count) hash sized to the
//   row.  Sums are 64-bit, one atomic a warp or chunk and pane; the last
//   block to finish writes each pane's sum / 3.
// The count is a function of the masked slot multiset alone and equals the
// JAX form's on every input whose rows fit its table's D.
//   Why not a bitmap over n_v for the warps too, as the design began: it is
// n_v / 8 bytes a warp, 22 KB at the hub pane's n_v, which would cut the
// warps resident on an SM to a handful where most rows have a few entries;
// the filter and hash take 4 KB a warp at any n_v.
//   Bound on the H100 (bytes): u, v and ok read once (9 B a slot) and K
// int64 counts written.  The design moves more: each valid slot is read
// twice more (degree, scatter), writes two 4-byte entries, and the count
// reads each owner's row once a chunk and 4 B a lookup (from L2 at these
// sizes); its time follows the lookups and the launches.
//   Scratch (csr_scratch_bytes; ops/csr_triangles.plan mirrors it): the
// zeroed counters (row degrees, owned counts, 64-bit owned work, scan tile
// states, K 64-bit sums, control words), then the row offsets, the long-row
// list and its chunks' starts, and the 2 K E entries, each piece 256-byte
// aligned.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // the build kernels
constexpr int kCountThreads = 512;  // the count kernel
constexpr int kCountWarps = kCountThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpRow = 128;  // rows up to this length: a warp's
constexpr int kFilterLog2 = 14;
constexpr int kFilterBits = 1 << kFilterLog2;  // a warp's filter: 2 KB
constexpr int kHashSlots = 2 * kWarpRow;  // a warp's hash, load <= 1/2: int32 keys, then int32 counts
constexpr int kWarpLookupBytes = kFilterBits / 8 + kHashSlots * 8;
constexpr int kLookupMin = kCountWarps * kWarpLookupBytes;  // 64 KB: every warp's filter and hash
constexpr int kLookupCap = 192 * 1024;
constexpr int kScanItems = 8;
constexpr int kTileRows = kThreads * kScanItems;
constexpr int kUnroll = 8;  // loads in flight a lane, streaming
constexpr int kBuildUnroll = 16;  // the same, building a long row's bitmap
constexpr int kMinChunkWork = 32768;  // lookups a block chunk streams at least, where it can
constexpr int kChunkOwned = 1024;  // owned slots a block chunk takes at most, where it can
constexpr int kGridCap = 132 * 16;
constexpr int kMaxClaims = 16384;  // short-row claims on one counter, about

// control words
constexpr int kTicket = 0, kBig = 1, kScattered = 2, kChunks = 3, kNextChunk = 4, kDone = 5,
              kNextRow = 8 /* 64 bits */, kCtl = 16;

constexpr unsigned long long kAgg = 1ull << 62, kIncl = 2ull << 62, kValueMask = (1ull << 62) - 1;

struct Layout {
  size_t cnt, own, work, status, acc, ctl, zeroed, start, big, chunk, cols, total;
  long long rows, max_big;
  int tiles;
};

Layout layout(int k, int e, int n_v) {
  auto up = [](size_t x) { return (x + 255) & ~static_cast<size_t>(255); };
  Layout l;
  l.rows = static_cast<long long>(k) * n_v;
  const long long entries = 2ll * k * e;
  l.max_big = (l.rows < entries / (kWarpRow + 1) ? l.rows : entries / (kWarpRow + 1)) + 1;
  l.tiles = static_cast<int>((l.rows + kTileRows - 1) / kTileRows);
  size_t o = 0;
  l.cnt = o;
  o += up(l.rows * 4);
  l.own = o;
  o += up(l.rows * 4);
  l.work = o;
  o += up(l.rows * 8);
  l.status = o;
  o += up(static_cast<size_t>(l.tiles) * 8);
  l.acc = o;
  o += up(static_cast<size_t>(k) * 8);
  l.ctl = o;
  o += up(kCtl * 4);
  l.zeroed = o;
  l.start = o;
  o += up((l.rows + 1) * 4);
  l.big = o;
  o += up(l.max_big * 4);
  l.chunk = o;
  o += up((l.max_big + 1) * 4);
  l.cols = o;
  o += up(entries * 4);
  l.total = o;
  return l;
}

template <typename T>
T* at(void* base, size_t offset) {
  return reinterpret_cast<T*>(static_cast<char*>(base) + offset);
}

__device__ __forceinline__ bool slot_valid(const int* __restrict__ u, const int* __restrict__ v,
                                           const uint8_t* __restrict__ ok, int i, int n_v) {
  const int a = u[i], b = v[i];
  return ok[i] != 0 && a >= 0 && a < n_v && b >= 0 && b < n_v;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
  return x;
}

__device__ __forceinline__ int warp_inclusive(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Lanes that add to one row add once, through their leader (a hub's row
// takes one atomic a warp, not one a lane); returns, for ctr[row] += n
// (n > 0, the front) or -= n (the back), the lane's own slot in the run.
__device__ __forceinline__ int reserve(int* ctr, long long row, bool live, bool front) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFull, live ? row : -1ll);
  const int leader = __ffs(peers) - 1, rank = __popc(peers & ((1u << lane) - 1u)), n = __popc(peers);
  int old = 0;
  if (live && lane == leader) old = front ? atomicAdd(ctr + row, n) : atomicSub(ctr + row, n);
  old = __shfl_sync(kFull, old, leader);
  return front ? old + rank : old - 1 - rank;
}

// The degree of each row: two aggregated atomics a valid slot.  The loop's
// bound is the warp's, so every lane reaches the shuffles.
__global__ void __launch_bounds__(kThreads)
csr_degree_kernel(const int* __restrict__ u, const int* __restrict__ v, const uint8_t* __restrict__ ok, int slots,
                  int e, int n_v, int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i - lane < slots; i += gridDim.x * kThreads) {
    const bool live = i < slots && slot_valid(u, v, ok, i, n_v);
    const long long base = live ? static_cast<long long>(i / e) * n_v : 0;
    reserve(cnt, live ? base + u[i] : 0, live, true);
    reserve(cnt, live ? base + v[i] : 0, live, true);
  }
}

// start[r] = the entries before row r (start[rows] = all), by tiles of
// kTileRows taken by ticket, so every tile a look-back waits on is held by a
// block that already runs; rows longer than kWarpRow are appended to big.
__global__ void __launch_bounds__(kThreads)
csr_scan_kernel(const int* __restrict__ cnt, long long rows, int* __restrict__ start, int* __restrict__ big,
                int* __restrict__ ctl, unsigned long long* __restrict__ status) {
  __shared__ int s_tile, s_warp[kThreads / 32];
  __shared__ long long s_before;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ctl + kTicket, 1);
  __syncthreads();
  const int tile = s_tile;
  const long long r0 = static_cast<long long>(tile) * kTileRows + static_cast<long long>(tid) * kScanItems;
  int x[kScanItems], sum = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    x[j] = r0 + j < rows ? cnt[r0 + j] : 0;
    if (x[j] > kWarpRow) big[atomicAdd(ctl + kBig, 1)] = static_cast<int>(r0 + j);
    sum += x[j];
  }
  const int incl = warp_inclusive(sum);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? s_warp[lane] : 0;
    const int wi = warp_inclusive(w);
    if (lane < kThreads / 32) s_warp[lane] = wi - w;  // exclusive over the warps
    const int total = __shfl_sync(kFull, wi, 31);
    volatile unsigned long long* st = status;
    if (lane == 0) st[tile] = (tile == 0 ? kIncl + 0ull : kAgg + 0ull) | static_cast<unsigned long long>(total);
    long long before = 0;
    for (int j = tile - 1; j >= 0; j -= 32) {
      const int jj = j - lane;
      unsigned long long s = jj >= 0 ? st[jj] : kIncl + 0ull;  // before tile 0: none
      while (__any_sync(kFull, s == 0ull)) {
        if (s == 0ull) s = st[jj];
      }
      const unsigned inc = __ballot_sync(kFull, (s & kIncl) != 0ull);
      const int stop = inc ? __ffs(inc) - 1 : 31;
      unsigned long long c = lane <= stop ? (s & kValueMask) : 0ull;
      c = warp_sum(c);
      before += static_cast<long long>(c);
      if (inc) break;
    }
    if (lane == 0) {
      if (tile > 0) st[tile] = kIncl | static_cast<unsigned long long>(before + total);
      s_before = before;
    }
  }
  __syncthreads();
  long long run = s_before + s_warp[warp] + incl - sum;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (r0 + j < rows) start[r0 + j] = static_cast<int>(run);
    run += x[j];
    if (r0 + j == rows - 1) start[rows] = static_cast<int>(run);
  }
}

// A long row's chunks: its length d, owned slots o and their rows' total
// length w give about w / max(d, kMinChunkWork) chunks, so a chunk's
// rebuild (d reads) stays below its streaming, and at least one a
// kChunkOwned owned slots, so that no warp walks more than a few batches of
// short rows (each batch a few dependent loads).
__device__ __forceinline__ int chunks_of(int d, int o, unsigned long long w) {
  if (o == 0) return 0;
  const unsigned long long c = max(w / max(d, kMinChunkWork), static_cast<unsigned long long>(o / kChunkOwned));
  return c < 1 ? 1 : (c > static_cast<unsigned long long>(o) ? o : static_cast<int>(c));
}

// Each valid slot's two entries: L -> S at the front of the owner L's row,
// S -> L at the back of S's; a long owner adds d(S) to its work.  The last
// block then plans the long rows' chunks.
__global__ void __launch_bounds__(kThreads)
csr_scatter_kernel(const int* __restrict__ u, const int* __restrict__ v, const uint8_t* __restrict__ ok, int slots,
                   int e, int n_v, const int* __restrict__ start, int* __restrict__ cnt, int* __restrict__ own,
                   unsigned long long* __restrict__ work, int* __restrict__ cols, const int* __restrict__ big,
                   int* __restrict__ chunk, int* __restrict__ ctl) {
  const int lane = threadIdx.x & 31;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i - lane < slots; i += gridDim.x * kThreads) {
    const bool live = i < slots && slot_valid(u, v, ok, i, n_v);
    long long base = 0;
    int l = 0, s = 0, sl = 0, ss = 0, dl = 0, ds = 0;
    if (live) {
      base = static_cast<long long>(i / e) * n_v;
      const int a = u[i], b = v[i];
      const int sa = start[base + a], da = start[base + a + 1] - sa;
      const int sb = start[base + b], db = start[base + b + 1] - sb;
      const bool a_owns = da > db || (da == db && a >= b);  // a self-loop: its u side owns
      l = a_owns ? a : b;
      s = a_owns ? b : a;
      sl = a_owns ? sa : sb;
      ss = a_owns ? sb : sa;
      dl = a_owns ? da : db;
      ds = a_owns ? db : da;
    }
    const int front = reserve(own, base + l, live, true);
    const int back = reserve(cnt, base + s, live, false);
    if (live) {
      cols[sl + front] = s;
      cols[ss + back] = l;
    }
    const bool big = live && dl > kWarpRow;
    const unsigned peers = __match_any_sync(kFull, big ? base + l : -1ll);
    if (big) {  // the peers' d(S) summed in two halves: 32 of them could pass 32 bits
      const unsigned lo = __reduce_add_sync(peers, static_cast<unsigned>(ds) & 0xffffu);
      const unsigned hi = __reduce_add_sync(peers, static_cast<unsigned>(ds) >> 16);
      if (lane == __ffs(peers) - 1)
        atomicAdd(work + base + l, lo + (static_cast<unsigned long long>(hi) << 16));
    }
  }
  // the last block to finish: each long row's chunks and where they start
  // in the list of all (chunk[i], chunk[n_big] = the total)
  __shared__ int s_last, s_warp[kThreads / 32];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ctl + kScattered, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int n_big = __ldcg(ctl + kBig), warp = threadIdx.x >> 5;
  int run = 0;
  for (int b0 = 0; b0 < n_big; b0 += kThreads) {
    const int i = b0 + threadIdx.x;
    int n = 0;
    if (i < n_big) {
      const int row = big[i];
      n = chunks_of(start[row + 1] - start[row], __ldcg(own + row), __ldcg(work + row));
    }
    const int incl = warp_inclusive(n);
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = run, total = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (i < n_big) chunk[i] = before + incl - n;
    run += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    chunk[n_big] = run;
    ctl[kChunks] = run;
  }
}

struct Count {
  const int* start;
  const int* own;
  const int* cols;
  const unsigned long long* work;
  const int* big;
  const int* chunk;
  int* ctl;
  unsigned long long* acc;
  long long* out;
  long long rows;
  int k, n_v, words, row_batch;
};

__device__ __forceinline__ unsigned hash_slot(int w, int bits) {
  return (static_cast<unsigned>(w) * 0x9E3779B1u) >> (32 - bits);
}

// A block's lookup of a long row over the ids [lo, hi): a bitmap, or 32-bit
// counts where the row repeats a neighbor.
struct BlockLook {
  const unsigned* table;
  int lo, hi;
  bool counts;
  __device__ __forceinline__ unsigned operator()(int w) const {
    if (w < lo || w >= hi) return 0u;
    const int x = w - lo;
    return counts ? table[x] : (table[x >> 5] >> (x & 31)) & 1u;
  }
};

// A warp's lookup of a short row: a filter of kFilterBits bits (the id
// itself where n_v fits it, so exact; else a hash of it), then, on a hit
// that is not known to be 1, the row's (id, count) hash.
struct WarpLook {
  const unsigned* filter;
  const int* keys;
  const int* counts;
  int bits;
  bool exact, probe;
  __device__ __forceinline__ unsigned operator()(int w) const {
    const unsigned i = exact ? static_cast<unsigned>(w) : hash_slot(w, kFilterLog2);
    if (!((filter[i >> 5] >> (i & 31)) & 1u)) return 0u;
    if (!probe) return 1u;
    for (unsigned h = hash_slot(w, bits);; h = (h + 1) & ((1u << bits) - 1u)) {
      const int key = keys[h];
      if (key == w) return static_cast<unsigned>(counts[h]);
      if (key == -1) return 0u;
    }
  }
};

// One warp: the lane's part of the sum, over the owned slots first, first +
// stride, ... (per <= 32 at a time, below end) of row L (entries at cols + s), of
// look(w) for every entry w of each owned slot's row.  The batch's rows are
// laid end to end, 32 positions a step: the row holding a position is the
// last that starts at or before the step's first (a ballot) plus the rows
// that start inside the step before it (one bit each, or-reduced), since
// every owned slot's row holds at least the slot's own entry.
template <typename Look>
__device__ __forceinline__ unsigned long long stream_rows(const Count& c, long long pbase, int s, int first, int end,
                                                         int per, int stride, const Look& look) {
  const int lane = threadIdx.x & 31;
  unsigned long long part = 0;
  for (int b0 = first; b0 < end; b0 += stride) {
    int len = 0, beg = 0;
    if (lane < per && b0 + lane < end) {
      const long long rs = pbase + __ldg(c.cols + s + b0 + lane);
      beg = c.start[rs];
      len = c.start[rs + 1] - beg;
    }
    const int incl = warp_inclusive(len);
    const int excl = incl - len;
    const int total = __shfl_sync(kFull, incl, 31);
    for (int f0 = 0; f0 < total; f0 += kUnroll * 32) {
      int w[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int at0 = f0 + q * 32;
        const unsigned before = __ballot_sync(kFull, excl <= at0);
        const unsigned inside =
            __reduce_or_sync(kFull, len > 0 && excl > at0 && excl < at0 + 32 ? 1u << (excl - at0) : 0u);
        const int j = 31 - __clz(before) + __popc(inside & ((2u << lane) - 1u));
        const int f = at0 + lane;
        const int at = __shfl_sync(kFull, beg, j) + f - __shfl_sync(kFull, excl, j);
        w[q] = f < total ? __ldg(c.cols + at) : -1;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        if (w[q] >= 0) part += look(w[q]);
    }
  }
  return part;
}

// Warp 0 of a block: the next (row, chunk) of the long rows, or row -1: a
// chunk id from one counter, its row by a 32-way search of the chunks'
// starts (the largest i with chunk[i] <= id; rows with no chunk share the
// next row's start, so the largest is the row that holds it).
__device__ int3 claim_chunk(const Count& c, int n_big, int chunks) {
  const int lane = threadIdx.x & 31;
  int id = 0;
  if (lane == 0) id = atomicAdd(c.ctl + kNextChunk, 1);
  id = __shfl_sync(kFull, id, 0);
  if (id >= chunks) return make_int3(-1, 0, 0);
  int lo = 0, hi = n_big;  // chunk[lo] <= id < chunk[hi]
  while (hi - lo > 1) {
    const int step = (hi - lo + 31) / 32, at = lo + lane * step;
    const unsigned le = __ballot_sync(kFull, at < hi && c.chunk[at] <= id);
    lo += (31 - __clz(le)) * step;
    hi = min(lo + step, hi);
  }
  const int row = c.big[lo], first = c.chunk[lo], n = c.chunk[lo + 1] - first, o = c.own[row], j = id - first;
  return make_int3(row, static_cast<int>(static_cast<long long>(j) * o / n),
                   static_cast<int>(static_cast<long long>(j + 1) * o / n));
}

// One chunk of a long row L (entries cols[s, s + d), owned [ob, oe)) by the
// whole block, each warp streaming every kCountWarps-th batch of up to 32
// owned slots (fewer where the chunk has fewer than 32 a warp): returns the
// lane's part of the chunk's sum.
__device__ unsigned long long block_item(const Count& c, int row, int ob, int oe, unsigned* lookup, int* s_flag) {
  const int tid = threadIdx.x, warp = tid >> 5;
  const int s = c.start[row], d = c.start[row + 1] - s;
  const long long pbase = static_cast<long long>(row / c.n_v) * c.n_v;
  for (int counts = 0;; counts = 1) {
    const long long span = counts ? c.words : 32ll * c.words;
    unsigned long long part = 0;
    bool repeat = false;
    for (long long lo = 0; lo < c.n_v; lo += span) {
      const int hi = static_cast<int>(lo + span < c.n_v ? lo + span : c.n_v);
      const int used = counts ? hi - static_cast<int>(lo) : (hi - static_cast<int>(lo) + 31) / 32;
      for (int i = tid; i < used; i += kCountThreads) lookup[i] = 0u;
      if (tid == 0) *s_flag = 0;
      __syncthreads();
      for (int t0 = tid; t0 < d; t0 += kBuildUnroll * kCountThreads) {
        int w[kBuildUnroll];
#pragma unroll
        for (int q = 0; q < kBuildUnroll; ++q) {
          const int t = t0 + q * kCountThreads;
          w[q] = t < d ? __ldg(c.cols + s + t) : -1;
        }
#pragma unroll
        for (int q = 0; q < kBuildUnroll; ++q) {
          if (w[q] < lo || w[q] >= hi) continue;
          const int x = w[q] - static_cast<int>(lo);
          if (counts) {
            atomicAdd(lookup + x, 1u);
          } else {
            const unsigned bit = 1u << (x & 31);
            if (atomicOr(lookup + (x >> 5), bit) & bit) *s_flag = 1;
          }
        }
      }
      __syncthreads();
      if (!counts && *s_flag) {
        repeat = true;
        break;
      }
      const int per = min(32, max(1, (oe - ob + kCountWarps - 1) / kCountWarps));
      part += stream_rows(c, pbase, s, ob + per * warp, oe, per, per * kCountWarps,
                          BlockLook{lookup, static_cast<int>(lo), hi, counts != 0});
      __syncthreads();
    }
    if (!repeat) return part;
    __syncthreads();  // every thread has read the flag
  }
}

// A short row L (entries cols[s, s + d), its first o owned) by one warp,
// in its filter and hash: returns the lane's part of the sum.
__device__ unsigned long long warp_item(const Count& c, long long row, int s, int d, int o, unsigned* filter,
                                        int* keys, int* counts) {
  const int lane = threadIdx.x & 31;
  const bool exact = c.n_v <= kFilterBits;
  bool rep = false;
  for (int t = lane; t < d; t += 32) {
    const int w = __ldg(c.cols + s + t);
    const unsigned i = exact ? static_cast<unsigned>(w) : hash_slot(w, kFilterLog2), bit = 1u << (i & 31);
    rep |= (atomicOr(filter + (i >> 5), bit) & bit) != 0u;
  }
  // the hash, where the filter alone cannot count: hashed ids, or a repeat
  const bool probe = !exact || __any_sync(kFull, rep);
  int bits = 5;
  while ((1 << bits) < 2 * d) ++bits;
  const unsigned mask = (1u << bits) - 1u;
  if (probe) {
    for (int t = lane; t < d; t += 32) {
      const int w = __ldg(c.cols + s + t);
      for (unsigned h = hash_slot(w, bits);; h = (h + 1) & mask) {
        const int old = atomicCAS(keys + h, -1, w);
        if (old == -1 || old == w) {
          atomicAdd(counts + h, 1);
          break;
        }
      }
    }
  }
  __syncwarp();
  const unsigned long long part =
      stream_rows(c, (row / c.n_v) * c.n_v, s, 0, o, 32, 32, WarpLook{filter, keys, counts, bits, exact, probe});
  __syncwarp();
  for (int t = lane; t < d; t += 32) {
    const int w = __ldg(c.cols + s + t);
    filter[(exact ? static_cast<unsigned>(w) : hash_slot(w, kFilterLog2)) >> 5] = 0u;
  }
  if (probe) {
    for (unsigned t = lane; t <= mask; t += 32) {
      keys[t] = -1;
      counts[t] = 0;
    }
  }
  __syncwarp();
  return part;
}

// Persistent: the long rows' chunks (a block each, claimed one at a time),
// then the short rows (a warp each, claimed row_batch at a time); the last
// block to finish writes out[p] = acc[p] / 3.
__global__ void __launch_bounds__(kCountThreads, 2) csr_count_kernel(Count c) {
  extern __shared__ unsigned lookup[];
  __shared__ int s_flag, s_last;
  __shared__ int3 s_item;
  __shared__ unsigned long long s_red[kCountWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_big = c.ctl[kBig], chunks = c.ctl[kChunks];
  for (;;) {
    if (warp == 0) {
      const int3 item = claim_chunk(c, n_big, chunks);
      if (lane == 0) s_item = item;
    }
    __syncthreads();
    const int3 item = s_item;
    if (item.x < 0) break;
    const unsigned long long part = warp_sum(block_item(c, item.x, item.y, item.z, lookup, &s_flag));
    if (lane == 0) s_red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      unsigned long long sum = 0;
      for (int w = 0; w < kCountWarps; ++w) sum += s_red[w];
      if (sum) atomicAdd(c.acc + item.x / c.n_v, sum);
    }
  }
  // every warp's filter and hash, empty
  unsigned* filter = lookup + warp * (kWarpLookupBytes / 4);
  int* keys = reinterpret_cast<int*>(filter + kFilterBits / 32);
  int* counts = keys + kHashSlots;
  for (int t = lane; t < kFilterBits / 32; t += 32) filter[t] = 0u;
  for (int t = lane; t < kHashSlots; t += 32) {
    keys[t] = -1;
    counts[t] = 0;
  }
  __syncwarp();
  long long pane = -1;
  unsigned long long part = 0;
  auto* next = reinterpret_cast<unsigned long long*>(c.ctl + kNextRow);
  for (;;) {
    unsigned long long claimed = 0;
    if (lane == 0) claimed = atomicAdd(next, static_cast<unsigned long long>(c.row_batch));
    const long long b = static_cast<long long>(__shfl_sync(kFull, claimed, 0));
    if (b >= c.rows) break;
    const long long row = b + lane;
    int s = 0, d = 0, o = 0;
    if (lane < c.row_batch && row < c.rows) {
      s = c.start[row];
      d = c.start[row + 1] - s;
      o = c.own[row];
    }
    for (unsigned todo = __ballot_sync(kFull, o > 0 && d <= kWarpRow); todo; todo &= todo - 1) {
      const int l = __ffs(todo) - 1;
      const long long p = (b + l) / c.n_v;
      if (p != pane) {
        const unsigned long long w = warp_sum(part);
        if (lane == 0 && w) atomicAdd(c.acc + pane, w);
        pane = p;
        part = 0;
      }
      part += warp_item(c, b + l, __shfl_sync(kFull, s, l), __shfl_sync(kFull, d, l),
                        __shfl_sync(kFull, o, l), filter, keys, counts);
    }
  }
  const unsigned long long w = warp_sum(part);
  if (lane == 0 && w) atomicAdd(c.acc + pane, w);
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(c.ctl + kDone, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  volatile unsigned long long* acc = c.acc;
  for (int p = tid; p < c.k; p += kCountThreads) c.out[p] = static_cast<long long>(acc[p] / 3ull);
}

int grid_for(long long items, int per_block, int cap) {
  const long long g = (items + per_block - 1) / per_block;
  return static_cast<int>(g < 1 ? 1 : (g < cap ? g : cap));
}

bool valid_shape(int k, int e, int n_v) {
  return k > 0 && e > 0 && n_v > 0 && static_cast<long long>(k) * e < (1ll << 30) &&
         static_cast<long long>(k) * n_v < (1ll << 31) - 1;
}

// Blocks of csr_count_kernel resident on the device at lookup_bytes of
// dynamic shared memory (cached for the last device and size asked; the
// kernel may take up to kLookupCap on every device it ran on).
int count_blocks(int lookup_bytes, cudaError_t& err) {
  static int last_bytes = -1, last_blocks = 0, last_device = -1;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return 0;
  if (device == last_device && lookup_bytes == last_bytes) return last_blocks;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(csr_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kLookupCap);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, csr_count_kernel, kCountThreads, lookup_bytes);
  if (err != cudaSuccess) return 0;
  last_device = device;
  last_bytes = lookup_bytes;
  last_blocks = sms * (per_sm < 1 ? 1 : per_sm);
  return last_blocks;
}

}  // namespace

extern "C" {

// The scratch bytes of csr_triangles_launch over k panes of e slots with
// ids in [0, n_v) (0 for a shape it does not take).
long long csr_scratch_bytes(int k, int e, int n_v) {
  return valid_shape(k, e, n_v) ? static_cast<long long>(layout(k, e, n_v).total) : 0;
}

// u, v: int32[k, e]; ok: bool[k, e]; lookup_bytes: the count kernel's
// dynamic shared memory (a multiple of 16 in [64 KB, 192 KB]: every warp's
// filter and hash; a long row's bitmap, or its counts, over that many bytes
// of ids a pass).  out: int64[k], each pane's triangles (the sum over its valid
// slots of |N(u) & N(v)|, over 3); scratch: csr_scratch_bytes(k, e, n_v).
int csr_triangles_launch(const void* u, const void* v, const void* ok, int k, int e, int n_v, int lookup_bytes,
                         void* out, void* scratch, long long bytes, void* stream) {
  if (!valid_shape(k, e, n_v) || lookup_bytes < kLookupMin || lookup_bytes > kLookupCap || lookup_bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(k, e, n_v);
  if (bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSuccess;
  const int blocks = count_blocks(lookup_bytes, err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* up = static_cast<const int*>(u);
  const auto* vp = static_cast<const int*>(v);
  const auto* okp = static_cast<const uint8_t*>(ok);
  int* cnt = at<int>(scratch, l.cnt);
  int* own = at<int>(scratch, l.own);
  auto* work = at<unsigned long long>(scratch, l.work);
  int* start = at<int>(scratch, l.start);
  int* ctl = at<int>(scratch, l.ctl);
  const int slots = k * e;
  err = cudaMemsetAsync(scratch, 0, l.zeroed, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_degree_kernel<<<grid_for(slots, kThreads, kGridCap), kThreads, 0, st>>>(up, vp, okp, slots, e, n_v, cnt);
  csr_scan_kernel<<<l.tiles, kThreads, 0, st>>>(cnt, l.rows, start, at<int>(scratch, l.big), ctl,
                                                 at<unsigned long long>(scratch, l.status));
  csr_scatter_kernel<<<grid_for(slots, kThreads, kGridCap), kThreads, 0, st>>>(
      up, vp, okp, slots, e, n_v, start, cnt, own, work, at<int>(scratch, l.cols), at<int>(scratch, l.big),
      at<int>(scratch, l.chunk), ctl);
  // short rows claimed a few at a time, so that one counter takes at most
  // about kMaxClaims atomics; no more blocks than a warp a row
  long long batch = (l.rows + kMaxClaims - 1) / kMaxClaims;
  batch = batch < 1 ? 1 : (batch > 32 ? 32 : batch);
  const long long need = (l.rows + kCountWarps - 1) / kCountWarps;
  Count c{start, own, at<int>(scratch, l.cols), work, at<int>(scratch, l.big), at<int>(scratch, l.chunk), ctl,
          at<unsigned long long>(scratch, l.acc), static_cast<long long*>(out), l.rows, k, n_v, lookup_bytes / 4,
          static_cast<int>(batch)};
  csr_count_kernel<<<static_cast<int>(need < blocks ? need : blocks), kCountThreads, lookup_bytes, st>>>(c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
