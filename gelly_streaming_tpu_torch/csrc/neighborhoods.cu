// Degree-bucketed neighborhood build on Hopper (sm_90a) behind a plain C
// interface, loaded with ctypes (gelly_streaming_tpu_torch/ops/_cuda.py,
// ops/neighborhoods.py).
//
// Replaces build_buckets (gelly_streaming_tpu/ops/neighborhoods.py:55-135),
// an XLA program of the JAX package: a stable argsort of the grouping keys
// 2 * src + !mask, a cumsum of segment heads, a cummax of head positions,
// per-key degree and key scatters, then, for each of the ~log2(E) degree
// buckets, a cumsum of the bucket's keys and scatters of every edge into
// zero-filled [K_b, D_b] tensors whose static shapes hold about 2E slots
// each.
//
// The sort (nb_sort_launch): a stable LSD radix sort of the valid rows
// only, 8-bit digits, (key, dst) rows of 8 bytes (12 with the arrival
// index, carried only when value leaves exist).  rs_stats_kernel and
// rs_plan_kernel find the valid rows' count and smallest and largest
// source, lo and hi; the key is src - lo over the bits that hi - lo spans,
// so a pane of 2^20 vertices sorts 20 bits in 3 passes, not 32 bits in 4.
// rs_ghist_kernel counts every pass's digits at once (the counts do not
// depend on the order).  The number of passes is decided on the device:
// a pass past it returns at once, and the later kernels find the buffer
// that holds the result from it, so nothing is read back.  A pass is one
// kernel, rs_onesweep_kernel, over 2048-row tiles taken by ticket: each
// warp walks its 256 rows in order, 32 a round, ranking a round's equal
// digits by one ballot a digit bit and chaining rounds and warps by
// per-warp digit counters (stable); the tile publishes its digit counts
// and looks back over the tiles before it, 16 at a step, for the counts
// that precede it (a decoupled look-back); it stages its rows in digit
// order in shared memory and writes them out, so each digit's run of the
// tile goes out in consecutive 4-byte stores.  Masked rows never reach a
// bucket: the first pass reads the raw rows and drops them.  8 bits and
// not wider: a tile of 2048 rows keeps runs of ~8 rows a digit (a 32-byte
// sector a stream), where 11-bit digits (2 passes) would leave runs of
// ~1, each store a partly written sector, and per-warp counters of 2048
// digits.  (Tiles of 4096 rows ran a little slower: twice the registers a
// thread, so fewer blocks an SM.)
//
// The buckets, over the sorted rows (nb_count_launch, nb_scatter_launch):
//   nb_count_kernel, 1024-row tiles taken by ticket: a segment head is a
//   row whose key differs from the row before it.  The tile counts its
//   heads and finds its last, and warp 0 looks back 32 tiles at a step
//   for the heads before the tile and where the segment running into it
//   began (kept for the scatter).  One block scan of the heads over the
//   tile's four rounds then gives each row its segment and the segment's
//   start; a row at a segment's end knows the key's degree and bucket
//   (integer ceil-log2, as the JAX package's clz).  The segment's row
//   within its bucket is the count of earlier segments of that bucket in
//   sorted order: ballots rank the ends of each warp and round, and a
//   shared per-bucket table over (round, warp) chains them; (degree, rank
//   in tile) is stored by segment.  Each
//   tile's <= 32-wide histogram goes to a [bucket][tile] table.
//   nb_scan_kernel, a block a bucket, scans that table across tiles
//   (exclusive, in place) and writes the bucket's rows.  The wrapper
//   copies the <= 32 bucket totals to the host and allocates exactly the
//   real rows.
//   nb_scatter_kernel: each sorted row finds its segment and start by the
//   same block scan, reads (degree, rank) and the tile base of the
//   segment's end, and writes its neighbor into slot (row, col), col its
//   arrival rank, and its valid flag; rows and their dst are read
//   coalesced, and a key's slots are written along its row.  The buckets
//   lie one after another (key and slot offsets, 64-bit, from the totals).
//   The same row also writes the padding slot col + degree when that lies
//   below D_b (a key's degree exceeds D_b / 2, so every padding slot is
//   written once) and the head writes the key, max(src, 0) as the JAX
//   package's scatter-max against zeros gives it.  Every output cell is
//   written exactly once, so the outputs need no memset.
//   nb_scatter_values_kernel does the same for one value leaf, as bytes,
//   gathered through the arrival index.
// Slot offsets are row * D_b + col in 64 bits.
//   Bound on the H100 (bytes), for one pane of the GraphSAGE main path
// (2^21 edges in the ALL direction: n = 2^22 directed rows, about 1.03M
// keys): src, dst and mask read once (9 B a row), keys written (4 B a
// key), nbrs and valid written (5 B a slot, at most 2 slots a row): about
// 68 MB, 20 us at 3.35 TB/s.  The design moves more: the stats and
// histogram kernels read src and mask once each, each sort pass reads and
// writes the 8-byte rows, and the bucket kernels read the sorted rows
// twice.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the sort
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;  // one a thread in the digit loops
constexpr int kSortRows = 8;              // rows a thread
constexpr int kSortTile = kThreads * kSortRows;
constexpr int kWarpRows = kSortTile / kWarps;  // kSortRows rounds of 32
constexpr int kStatRows = 16;                  // rows a thread of the stats kernel
constexpr int kStatTile = kThreads * kStatRows;
constexpr int kMaxPasses = 4;                  // 32 bits
constexpr int kMaxDevices = 64;                 // devices a process may launch on
constexpr int kPlanThreads = 1024;
constexpr int kGhistBlocks = 132 * 4;
// the buckets
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;  // ops/neighborhoods.py _TILE
constexpr int kMaxBuckets = 32;

static_assert(kDigits == kThreads, "the digit loops take one digit a thread");

// header: the valid rows' smallest source, their count, the passes
enum { kLo = 0, kValid = 1, kPasses = 2 };

// ceil(log2(deg)) for deg >= 1: the bucket of a key of that degree
__device__ __forceinline__ int ceil_log2(int deg) { return deg <= 1 ? 0 : 32 - __clz(deg - 1); }

// The scratch of one build: every piece 256-byte aligned, the arrival
// index buffers last (present only for a sort with value leaves).
struct Layout {
  size_t header, stats, zeroed, ghist, tickets, status, head_ticket, head_status, zeroed_end, keys[2], dst[2], heads, tile_hist, info, totals,
      idx[2], total;
};

Layout layout(int n, int with_idx) {
  auto up = [](size_t x) { return (x + 255) & ~static_cast<size_t>(255); };
  const size_t st = (static_cast<size_t>(n) + kSortTile - 1) / kSortTile;
  const size_t sst = (static_cast<size_t>(n) + kStatTile - 1) / kStatTile;
  const size_t nt = (static_cast<size_t>(n) + kTile - 1) / kTile;
  const size_t rows = static_cast<size_t>(n) * 4;
  Layout l;
  size_t o = 0;
  l.header = o;
  o += up(16 * 4);
  l.stats = o;
  o += up(3 * sst * 4);
  l.zeroed = o;  // zeroed before the sort: the digit counts, tickets, statuses
  l.ghist = o;
  o += up(kMaxPasses * kDigits * 4);
  l.tickets = o;
  o += up(kMaxPasses * 4);
  l.status = o;
  o += up(kMaxPasses * st * kDigits * 4);
  l.head_ticket = o;
  o += up(4);
  l.head_status = o;
  o += up(nt * 8);
  l.zeroed_end = o;
  for (int b = 0; b < 2; ++b) {
    l.keys[b] = o;
    o += up(rows);
    l.dst[b] = o;
    o += up(rows);
  }
  l.heads = o;
  o += up(2 * nt * 4);
  l.tile_hist = o;
  o += up(kMaxBuckets * nt * 4);
  l.info = o;
  o += up(static_cast<size_t>(n) * 8);
  l.totals = o;
  o += up(kMaxBuckets * 4);
  for (int b = 0; b < 2; ++b) {
    l.idx[b] = o;
    o += with_idx ? up(rows) : 0;
  }
  l.total = o;
  return l;
}

// The sort's two row buffers (pass p writes buffer p & 1).
struct Buffers {
  unsigned* keys[2];
  int* dst[2];
  int* idx[2];  // null without value leaves
};

// The sorted rows, as the last pass left them.
struct Sorted {
  const unsigned* keys[2];
  const int* dst[2];
  const int* idx[2];
  const int* header;
};

__device__ __forceinline__ int last_buffer(const int* header) { return (header[kPasses] - 1) & 1; }

// Exclusive sum over the block's 256 threads; total = the block's sum.
// s_warp: kWarps ints.  Ends synchronized (s_warp reusable).
__device__ __forceinline__ int block_exclusive_sum(int v, int* s_warp, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += up;
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

// ---------------------------------------------------------------------------
// the sort

// Each 4096-row tile's valid count, smallest and largest source (st: the
// tiles).
__global__ void __launch_bounds__(kThreads)
rs_stats_kernel(const int* __restrict__ src, const uint8_t* __restrict__ mask, int n, int st,
                int* __restrict__ stats) {
  __shared__ int s_red[3][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = blockIdx.x * kStatTile;
  int cnt = 0, lo = INT_MAX, hi = INT_MIN;
  const int p0 = base + threadIdx.x * kStatRows;  // 16 consecutive rows a thread
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(mask)) & 15) == 0;
  if (aligned && p0 + kStatRows <= n) {
    static_assert(kStatRows == 16, "one 16-byte load of a thread's mask bytes");
    const uint4 m = __ldg(reinterpret_cast<const uint4*>(mask + p0));
    const uint8_t* mb = reinterpret_cast<const uint8_t*>(&m);
    int4 v[kStatRows / 4];
#pragma unroll
    for (int q = 0; q < kStatRows / 4; ++q) v[q] = __ldg(reinterpret_cast<const int4*>(src + p0) + q);
    const int* sv = reinterpret_cast<const int*>(v);
#pragma unroll
    for (int r = 0; r < kStatRows; ++r) {
      if (!mb[r]) continue;
      ++cnt;
      lo = min(lo, sv[r]);
      hi = max(hi, sv[r]);
    }
  } else {
    for (int p = p0; p < n && p < p0 + kStatRows; ++p) {
      if (!__ldg(mask + p)) continue;
      const int s = __ldg(src + p);
      ++cnt;
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, d);
    lo = min(lo, __shfl_xor_sync(kFull, lo, d));
    hi = max(hi, __shfl_xor_sync(kFull, hi, d));
  }
  if (lane == 0) {
    s_red[0][warp] = cnt;
    s_red[1][warp] = lo;
    s_red[2][warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      cnt += s_red[0][w];
      lo = min(lo, s_red[1][w]);
      hi = max(hi, s_red[2][w]);
    }
    stats[blockIdx.x] = cnt;
    stats[st + blockIdx.x] = lo;
    stats[2 * st + blockIdx.x] = hi;
  }
}

// One block: lo, the valid count and the number of passes that hi - lo
// needs (at least one: the first pass also drops the masked rows).
__global__ void __launch_bounds__(kPlanThreads)
rs_plan_kernel(const int* __restrict__ stats, int st, int* __restrict__ header) {
  __shared__ int s_red[3][kPlanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long cnt = 0;
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x; i < st; i += kPlanThreads) {
    cnt += stats[i];
    lo = min(lo, stats[st + i]);
    hi = max(hi, stats[2 * st + i]);
  }
  int c = static_cast<int>(cnt);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    c += __shfl_xor_sync(kFull, c, d);
    lo = min(lo, __shfl_xor_sync(kFull, lo, d));
    hi = max(hi, __shfl_xor_sync(kFull, hi, d));
  }
  if (lane == 0) {
    s_red[0][warp] = c;
    s_red[1][warp] = lo;
    s_red[2][warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPlanThreads / 32; ++w) {
      c += s_red[0][w];
      lo = min(lo, s_red[1][w]);
      hi = max(hi, s_red[2][w]);
    }
    if (c == 0) lo = hi = 0;
    const unsigned span = static_cast<unsigned>(hi) - static_cast<unsigned>(lo);
    const int bits = span == 0 ? 0 : 32 - __clz(static_cast<int>(span));
    const int passes = (bits + kDigitBits - 1) / kDigitBits;
    header[kLo] = lo;
    header[kValid] = c;
    header[kPasses] = passes > 1 ? passes : 1;
  }
}

// Every pass's global digit counts at once (they do not depend on the
// order): ghist[pass][digit], zeroed before the launch.
__global__ void __launch_bounds__(kThreads)
rs_ghist_kernel(const int* __restrict__ src, const uint8_t* __restrict__ mask, int n,
                const int* __restrict__ header, int* __restrict__ ghist) {
  __shared__ int s_hist[kMaxPasses][kDigits];
  const int passes = header[kPasses];
  const unsigned lo = static_cast<unsigned>(header[kLo]);
  for (int i = threadIdx.x; i < kMaxPasses * kDigits; i += kThreads) (&s_hist[0][0])[i] = 0;
  __syncthreads();
  // 4 consecutive rows a thread a step
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(mask)) & 15) == 0;
  for (int p = (blockIdx.x * kThreads + threadIdx.x) * 4; p < n; p += gridDim.x * kThreads * 4) {
    int s4[4];
    bool m4[4];
    if (aligned && p + 4 <= n) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(src + p));
      const uchar4 m = __ldg(reinterpret_cast<const uchar4*>(mask + p));
      s4[0] = v.x, s4[1] = v.y, s4[2] = v.z, s4[3] = v.w;
      m4[0] = m.x, m4[1] = m.y, m4[2] = m.z, m4[3] = m.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        m4[q] = p + q < n && __ldg(mask + p + q);
        s4[q] = m4[q] ? __ldg(src + p + q) : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!m4[q]) continue;
      const unsigned key = static_cast<unsigned>(s4[q]) - lo;
      for (int pass = 0; pass < passes; ++pass)
        atomicAdd(&s_hist[pass][(key >> (pass * kDigitBits)) & (kDigits - 1)], 1);
    }
  }
  __syncthreads();
  for (int pass = 0; pass < passes; ++pass) {
    const int c = s_hist[pass][threadIdx.x];
    if (c) atomicAdd(ghist + pass * kDigits + threadIdx.x, c);
  }
}

// The rows a pass sorts: the raw rows (the first pass), else the valid
// rows the last pass left.
__device__ __forceinline__ int pass_rows(int pass, int n, const int* header) {
  return pass == 0 ? n : header[kValid];
}

// A digit's tile status for the decoupled look-back: the count in the low
// 30 bits, and whether it is the tile's own (kAgg) or the tile's inclusive
// prefix (kIncl); 0 while the tile is not done.
constexpr unsigned kAgg = 1u << 30;
constexpr unsigned kIncl = 2u << 30;
constexpr unsigned kCount = kAgg - 1u;
constexpr int kLook = 16;  // tiles a look-back step reads at once

// One pass over one 2048-row tile (see the head note).  Tiles are taken
// by ticket, so every tile a look-back waits on is held by a block that
// already runs.  Dynamic shared memory: the staged keys, dst and (kIdx)
// arrival indices.
template <bool kIdx>
__global__ void __launch_bounds__(kThreads)
rs_onesweep_kernel(int pass, const int* __restrict__ src, const int* __restrict__ dst,
                   const uint8_t* __restrict__ mask, int n, Buffers b, const int* __restrict__ header, int st,
                   const int* __restrict__ ghist, unsigned* __restrict__ status, int* __restrict__ tickets) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_wcnt[kWarps][kDigits];
  __shared__ int s_off[kDigits];
  __shared__ int s_start[kDigits];
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  if (pass >= header[kPasses]) return;
  const int rows = pass_rows(pass, n, header);
  const int tid = threadIdx.x;
  if (tid == 0) s_tile = atomicAdd(tickets + pass, 1);
  __syncthreads();
  const int tile = s_tile;
  const int base = tile * kSortTile;
  if (base >= rows) return;
  unsigned* s_key = reinterpret_cast<unsigned*>(smem);
  int* s_dst = reinterpret_cast<int*>(s_key + kSortTile);
  int* s_idx = s_dst + kSortTile;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned lt = (1u << lane) - 1u;
  const unsigned lo = static_cast<unsigned>(header[kLo]);
  const int shift = pass * kDigitBits;
  const int in = (pass + 1) & 1;
  const int out = pass & 1;

  // where each digit starts in the output
  int total;
  s_off[tid] = block_exclusive_sum(__ldg(ghist + pass * kDigits + tid), s_warp, total);
  for (int i = tid; i < kWarps * kDigits; i += kThreads) (&s_wcnt[0][0])[i] = 0;
  __syncthreads();

  // load: each warp's 256 rows, 32 a round
  unsigned key[kSortRows];
  int dv[kSortRows], ix[kSortRows], dg[kSortRows], rk[kSortRows];
#pragma unroll
  for (int r = 0; r < kSortRows; ++r) {
    const int p = base + warp * kWarpRows + r * 32 + lane;
    bool ok;
    if (pass == 0) {
      ok = p < rows && __ldg(mask + p);
      key[r] = ok ? static_cast<unsigned>(__ldg(src + p)) - lo : 0u;
      dv[r] = ok ? __ldg(dst + p) : 0;
      ix[r] = p;
    } else {
      ok = p < rows;
      key[r] = ok ? b.keys[in][p] : 0u;
      dv[r] = ok ? b.dst[in][p] : 0;
      ix[r] = (kIdx && ok) ? b.idx[in][p] : 0;
    }
    dg[r] = ok ? 0 : kDigits;
  }

  // rank: each warp walks its rows in order, 32 a round; a lane's peers
  // (the round's lanes of its digit) by one ballot a digit bit
#pragma unroll
  for (int r = 0; r < kSortRows; ++r) {
    const bool ok = dg[r] == 0;
    const int d = static_cast<int>((key[r] >> shift) & (kDigits - 1));
    unsigned peers = __ballot_sync(kFull, ok);
#pragma unroll
    for (int bit = 0; bit < kDigitBits; ++bit) {
      const bool set = (d >> bit) & 1;
      const unsigned bal = __ballot_sync(kFull, set);
      peers &= set ? bal : ~bal;
    }
    const int before = ok ? s_wcnt[warp][d] : 0;
    __syncwarp();
    if (ok && (peers & lt) == 0) s_wcnt[warp][d] = before + __popc(peers);
    __syncwarp();
    dg[r] = ok ? d : kDigits;
    rk[r] = before + __popc(peers & lt);
  }
  __syncthreads();

  // per digit: the warps' offsets and the tile's count, then the count of
  // the tiles before (look-back), then the tile's digit starts
  int run = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_wcnt[w][tid];
    s_wcnt[w][tid] = run;
    run += c;
  }
  volatile unsigned* stat = status + (static_cast<long long>(pass) * st) * kDigits + tid;
  int prefix = 0;
  if (tile == 0) {
    stat[0] = kIncl | static_cast<unsigned>(run);
  } else {
    stat[static_cast<long long>(tile) * kDigits] = kAgg | static_cast<unsigned>(run);
    // kLook tiles back at once; before tile 0 reads as an inclusive 0
    bool done = false;
    for (int j = tile - 1; !done; j -= kLook) {
      unsigned v[kLook];
#pragma unroll
      for (int q = 0; q < kLook; ++q) v[q] = j - q >= 0 ? stat[static_cast<long long>(j - q) * kDigits] : kIncl + 0u;
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        while (v[q] == 0u) v[q] = stat[static_cast<long long>(j - q) * kDigits];
      }
#pragma unroll
      for (int q = 0; q < kLook; ++q) {
        if (done) continue;
        prefix += static_cast<int>(v[q] & kCount);
        done = (v[q] & kIncl) != 0;
      }
    }
    stat[static_cast<long long>(tile) * kDigits] = kIncl | static_cast<unsigned>(prefix + run);
  }
  int tile_rows;
  const int start = block_exclusive_sum(run, s_warp, tile_rows);
  s_start[tid] = start;
  s_off[tid] += prefix - start;  // output row of staged row i (digit tid): s_off[tid] + i
  __syncthreads();

  // stage the tile in digit order, then write it out
#pragma unroll
  for (int r = 0; r < kSortRows; ++r) {
    if (dg[r] == kDigits) continue;
    const int pos = s_start[dg[r]] + s_wcnt[warp][dg[r]] + rk[r];
    s_key[pos] = key[r];
    s_dst[pos] = dv[r];
    if (kIdx) s_idx[pos] = ix[r];
  }
  __syncthreads();
  for (int i = tid; i < tile_rows; i += kThreads) {
    const unsigned k = s_key[i];
    const int g = s_off[(k >> shift) & (kDigits - 1)] + i;
    b.keys[out][g] = k;
    b.dst[out][g] = s_dst[i];
    if (kIdx) b.idx[out][g] = s_idx[i];
  }
}

// The sorted valid rows, for checks: src (key + lo), dst, arrival index,
// and the header.
__global__ void __launch_bounds__(kThreads)
rs_copy_kernel(Sorted s, int* __restrict__ src_out, int* __restrict__ dst_out, int* __restrict__ idx_out,
               int* __restrict__ meta) {
  const int nv = s.header[kValid];
  const int buf = last_buffer(s.header);
  const unsigned lo = static_cast<unsigned>(s.header[kLo]);
  if (blockIdx.x == 0 && threadIdx.x < 3) meta[threadIdx.x] = s.header[threadIdx.x];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < nv; i += gridDim.x * kThreads) {
    src_out[i] = static_cast<int>(s.keys[buf][i] + lo);
    dst_out[i] = s.dst[buf][i];
    if (idx_out) idx_out[i] = s.idx[buf][i];
  }
}

// ---------------------------------------------------------------------------
// the buckets


// A round's sorted row: its key, and whether it heads or ends a segment.
struct SortedRow {
  unsigned key;
  bool ok, head, end;
};

// The block's rows of a 1024-row tile, all rounds loaded at once.
__device__ __forceinline__ void load_rows(const unsigned* __restrict__ keys, int base, int nv,
                                          SortedRow (&rows)[kRounds]) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = base + r * kThreads + threadIdx.x;
    SortedRow& w = rows[r];
    w.ok = p < nv;
    w.key = w.ok ? __ldg(keys + p) : 0u;
    const unsigned prev = (w.ok && p > 0) ? __ldg(keys + p - 1) : ~w.key;
    const unsigned next = (w.ok && p + 1 < nv) ? __ldg(keys + p + 1) : ~w.key;
    w.head = w.ok && prev != w.key;
    w.end = w.ok && next != w.key;
  }
}

// The lanes of the warp holding the same value v in [0, 2^bits), by one
// ballot a bit.
template <int kBits>
__device__ __forceinline__ unsigned peers_of(int v) {
  unsigned peers = kFull;
#pragma unroll
  for (int bit = 0; bit < kBits; ++bit) {
    const bool set = (v >> bit) & 1;
    const unsigned bal = __ballot_sync(kFull, set);
    peers &= set ? bal : ~bal;
  }
  return peers;
}

// The block's scan of segment heads over a 1024-row tile, all rounds at
// once, continued from the carry (the heads before the tile and the last
// of them): each row's segment and the segment's start.  s_c, s_m:
// kRounds * kWarps ints each, in (round, warp) order, the rows' order.
__device__ __forceinline__ void tile_segments(const SortedRow (&rows)[kRounds], int base, int carry_cnt,
                                              int carry_pos, int* s_c, int* s_m, int (&seg)[kRounds],
                                              int (&start)[kRounds]) {
  static_assert(kRounds * kWarps == 32, "one warp scans the (round, warp) totals");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int c[kRounds], m[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    c[r] = rows[r].head ? 1 : 0;
    m[r] = rows[r].head ? base + r * kThreads + static_cast<int>(threadIdx.x) : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int uc = __shfl_up_sync(kFull, c[r], d);
      const int um = __shfl_up_sync(kFull, m[r], d);
      if (lane >= d) {
        c[r] += uc;
        m[r] = max(m[r], um);
      }
    }
    if (lane == 31) {
      s_c[r * kWarps + warp] = c[r];
      s_m[r * kWarps + warp] = m[r];
    }
  }
  __syncthreads();
  if (warp == 0) {  // exclusive over the (round, warp) totals
    int x = s_c[lane], y = s_m[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int ux = __shfl_up_sync(kFull, x, d);
      const int uy = __shfl_up_sync(kFull, y, d);
      if (lane >= d) {
        x += ux;
        y = max(y, uy);
      }
    }
    const int px = __shfl_up_sync(kFull, x, 1);
    const int py = __shfl_up_sync(kFull, y, 1);
    s_c[lane] = lane > 0 ? px : 0;
    s_m[lane] = lane > 0 ? py : -1;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int i = r * kWarps + warp;
    seg[r] = carry_cnt + s_c[i] + c[r] - 1;
    start[r] = max(carry_pos, max(s_m[i], m[r]));
  }
}

// A tile's segment heads for the look-back across tiles, 64 bits: a flag
// (kHeadAgg: the tile's own, kHeadIncl: with every tile before it), the
// count of heads (31 bits) and the last head + 1 (31 bits, 0 for none);
// 0 while the tile is not done.
constexpr unsigned long long kHeadAgg = 1ull << 62;
constexpr unsigned long long kHeadIncl = 2ull << 62;

__device__ __forceinline__ unsigned long long head_word(unsigned long long flag, int cnt, int last) {
  return flag | (static_cast<unsigned long long>(cnt) << 31) | static_cast<unsigned long long>(last + 1);
}

// Warp 0: publish the tile's (heads, last head), look back 32 tiles at a
// step to the nearest inclusive one, publish the inclusive word and
// return (heads before the tile, last head before it) in every lane.
__device__ __forceinline__ int2 heads_before(volatile unsigned long long* status, int tile, int cnt, int last) {
  const int lane = threadIdx.x & 31;
  if (lane == 0) status[tile] = head_word(tile == 0 ? kHeadIncl + 0ull : kHeadAgg + 0ull, cnt, last);
  int before = 0, before_last = -1;
  for (int j = tile - 1; j >= 0; j -= 32) {
    const int jj = j - lane;
    unsigned long long v = jj >= 0 ? status[jj] : kHeadIncl + 0ull;  // before tile 0: none
    while (__any_sync(kFull, v == 0ull)) {
      if (v == 0ull) v = status[jj];
    }
    const unsigned incl = __ballot_sync(kFull, (v & kHeadIncl) != 0ull);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    int c = lane <= stop ? static_cast<int>((v >> 31) & 0x7FFFFFFFull) : 0;
    int m = lane <= stop ? static_cast<int>(v & 0x7FFFFFFFull) - 1 : -1;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      c += __shfl_xor_sync(kFull, c, d);
      m = max(m, __shfl_xor_sync(kFull, m, d));
    }
    before += c;
    before_last = max(before_last, m);
    if (incl) break;
  }
  if (lane == 0 && tile > 0) status[tile] = head_word(kHeadIncl, before + cnt, max(before_last, last));
  return make_int2(before, before_last);
}

// Tiles by ticket, so every tile a look-back waits on is held by a block
// that already runs.  heads[2 tile], heads[2 tile + 1]: the heads before
// the tile and the last of them (-1: none), for nb_scatter_kernel;
// tile_hist: int32[nb][tiles]; info: int2 by segment, (degree, rank in the
// end's tile, or -1 for a class with no bucket).
__global__ void __launch_bounds__(kThreads)
nb_count_kernel(Sorted s, int nb, int tiles, int* __restrict__ ticket, unsigned long long* __restrict__ status,
                int* __restrict__ heads, int* __restrict__ tile_hist, int2* __restrict__ info) {
  __shared__ int s_bc[kRounds * kWarps][kMaxBuckets];  // ends by (round, warp) and bucket
  __shared__ int s_c[kRounds * kWarps], s_m[kRounds * kWarps];
  __shared__ int s_tile, s_carry[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) s_tile = atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int nv = s.header[kValid];
  const int base = tile * kTile;
  if (base >= nv) {
    if (tid < nb) tile_hist[tid * tiles + tile] = 0;
    return;
  }
  SortedRow rows[kRounds];
  load_rows(s.keys[last_buffer(s.header)], base, nv, rows);
  for (int i = tid; i < kRounds * kWarps * kMaxBuckets; i += kThreads) (&s_bc[0][0])[i] = 0;
  // the tile's heads, then those before it
  int cnt = 0, last = -1;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (!rows[r].head) continue;
    ++cnt;
    last = base + r * kThreads + tid;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    cnt += __shfl_xor_sync(kFull, cnt, d);
    last = max(last, __shfl_xor_sync(kFull, last, d));
  }
  if (lane == 0) {
    s_c[warp] = cnt;
    s_m[warp] = last;
  }
  __syncthreads();
  if (warp == 0) {
    cnt = lane < kWarps ? s_c[lane] : 0;
    last = lane < kWarps ? s_m[lane] : -1;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      cnt += __shfl_xor_sync(kFull, cnt, d);
      last = max(last, __shfl_xor_sync(kFull, last, d));
    }
    const int2 before = heads_before(status, tile, cnt, last);
    if (lane == 0) {
      heads[2 * tile] = s_carry[0] = before.x;
      heads[2 * tile + 1] = s_carry[1] = before.y;
    }
  }
  __syncthreads();
  int seg[kRounds], start[kRounds];
  tile_segments(rows, base, s_carry[0], s_carry[1], s_c, s_m, seg, start);
  // each end's bucket, ranked within its warp and round by ballots
  int bk[kRounds], deg[kRounds], rank[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    bk[r] = -1;
    deg[r] = 0;
    if (rows[r].end) {
      deg[r] = base + r * kThreads + tid - start[r] + 1;
      bk[r] = ceil_log2(deg[r]);
      if (bk[r] >= nb) {
        info[seg[r]] = make_int2(deg[r], -1);
        bk[r] = -1;
      }
    }
    const unsigned peers = peers_of<6>(bk[r] < 0 ? kMaxBuckets : bk[r]);
    const unsigned below = peers & ((1u << lane) - 1u);
    rank[r] = __popc(below);
    if (bk[r] >= 0 && below == 0) s_bc[r * kWarps + warp][bk[r]] = __popc(peers);
  }
  __syncthreads();
  if (tid < nb) {  // per bucket, exclusive over (round, warp), and the tile's total
    int run = 0;
    for (int i2 = 0; i2 < kRounds * kWarps; ++i2) {
      const int v = s_bc[i2][tid];
      s_bc[i2][tid] = run;
      run += v;
    }
    tile_hist[tid * tiles + tile] = run;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    if (bk[r] >= 0) info[seg[r]] = make_int2(deg[r], s_bc[r * kWarps + warp][bk[r]] + rank[r]);
}

// A block a bucket: tile_hist[b][*] scanned across tiles (exclusive, in
// place); totals[b] its sum, the bucket's rows.
__global__ void __launch_bounds__(kPlanThreads)
nb_scan_kernel(int* __restrict__ tile_hist, int tiles, int* __restrict__ totals, int* __restrict__ totals_out) {
  __shared__ int s_warp[kPlanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* row = tile_hist + static_cast<long long>(blockIdx.x) * tiles;
  int carry = 0;
  for (int t0 = 0; t0 < tiles; t0 += kPlanThreads) {
    const int t = t0 + threadIdx.x;
    const int v = t < tiles ? row[t] : 0;
    int x = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x += up;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int before = 0, sum = 0;
    for (int w = 0; w < kPlanThreads / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      sum += s_warp[w];
    }
    if (t < tiles) row[t] = carry + before + x - v;
    carry += sum;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = totals_out[blockIdx.x] = carry;
}

// Each bucket's first key and first slot, from the buckets' totals.
__device__ __forceinline__ void bucket_offsets(const int* __restrict__ totals, int nb, long long* s_off) {
  if (threadIdx.x == 0) {
    long long k0 = 0, s0 = 0;
    for (int b = 0; b < nb; ++b) {
      s_off[b] = k0;
      s_off[kMaxBuckets + b] = s0;
      k0 += totals[b];
      s0 += static_cast<long long>(totals[b]) << b;
    }
  }
  __syncthreads();
}

// Where each of the block's sorted rows lands (all rounds): false for a
// row past the valid ones or a key with no bucket; else its slot, the
// key's degree, D_b, its column and its bucket's key row.  The segments
// by block scans first, then the loads that depend on them, each for all
// rounds at once.
struct Place {
  long long slot, key_slot;
  int deg, d_b, col;
  bool ok;
};

__device__ __forceinline__ void place_rows(const SortedRow (&rows)[kRounds], int base, int tiles,
                                           const int* __restrict__ heads, const int* __restrict__ tile_base,
                                           const int2* __restrict__ info, const long long* s_off, int* s_c,
                                           int* s_m, Place (&at)[kRounds]) {
  int seg[kRounds], start[kRounds];
  tile_segments(rows, base, heads[2 * blockIdx.x], heads[2 * blockIdx.x + 1], s_c, s_m, seg, start);
  int2 in[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) in[r] = rows[r].ok ? info[seg[r]] : make_int2(0, -1);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    at[r].ok = in[r].y >= 0;
    if (!at[r].ok) continue;
    const int b = ceil_log2(in[r].x);
    const int end_tile = (start[r] + in[r].x - 1) / kTile;
    const long long row = __ldg(tile_base + b * tiles + end_tile) + in[r].y;
    at[r].deg = in[r].x;
    at[r].d_b = 1 << b;
    at[r].col = base + r * kThreads + threadIdx.x - start[r];
    at[r].slot = s_off[kMaxBuckets + b] + (row << b) + at[r].col;
    at[r].key_slot = s_off[b] + row;
  }
}

__global__ void __launch_bounds__(kThreads)
nb_scatter_kernel(Sorted s, int nb, int tiles, const int* __restrict__ heads, const int* __restrict__ tile_base,
                  const int2* __restrict__ info, const int* __restrict__ totals, int* __restrict__ keys_out,
                  int* __restrict__ nbrs_out, uint8_t* __restrict__ valid_out) {
  __shared__ int s_c[kRounds * kWarps], s_m[kRounds * kWarps];
  __shared__ long long s_off[2 * kMaxBuckets];
  const int nv = s.header[kValid];
  const int base = blockIdx.x * kTile;
  if (base >= nv) return;
  const int buf = last_buffer(s.header);
  const unsigned lo = static_cast<unsigned>(s.header[kLo]);
  SortedRow rows[kRounds];
  load_rows(s.keys[buf], base, nv, rows);
  int dv[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) dv[r] = rows[r].ok ? __ldg(s.dst[buf] + base + r * kThreads + threadIdx.x) : 0;
  Place at[kRounds];
  bucket_offsets(totals, nb, s_off);
  place_rows(rows, base, tiles, heads, tile_base, info, s_off, s_c, s_m, at);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (!at[r].ok) continue;
    nbrs_out[at[r].slot] = dv[r];
    valid_out[at[r].slot] = 1;
    if (at[r].col + at[r].deg < at[r].d_b) {
      nbrs_out[at[r].slot + at[r].deg] = 0;
      valid_out[at[r].slot + at[r].deg] = 0;
    }
    if (at[r].col == 0) {
      const int src = static_cast<int>(rows[r].key + lo);
      keys_out[at[r].key_slot] = src > 0 ? src : 0;
    }
  }
}

__device__ __forceinline__ void copy_bytes(char* __restrict__ to, const char* __restrict__ from, int elem) {
  if (elem == 4) {
    *reinterpret_cast<int*>(to) = *reinterpret_cast<const int*>(from);
  } else if (elem == 8) {
    *reinterpret_cast<long long*>(to) = *reinterpret_cast<const long long*>(from);
  } else {
    for (int i = 0; i < elem; ++i) to[i] = from[i];
  }
}

__device__ __forceinline__ void zero_bytes(char* __restrict__ to, int elem) {
  if (elem == 4) {
    *reinterpret_cast<int*>(to) = 0;
  } else if (elem == 8) {
    *reinterpret_cast<long long*>(to) = 0;
  } else {
    for (int i = 0; i < elem; ++i) to[i] = 0;
  }
}

// One value leaf of elem bytes a row, gathered through the arrival index
// (a leaf of 4 or 8 bytes a row is copied as one word; the allocations
// are aligned to 256 bytes).
__global__ void __launch_bounds__(kThreads)
nb_scatter_values_kernel(Sorted s, int nb, int tiles, const int* __restrict__ heads,
                         const int* __restrict__ tile_base, const int2* __restrict__ info,
                         const int* __restrict__ totals, const char* __restrict__ leaf,
                         char* __restrict__ leaf_out, int elem) {
  __shared__ int s_c[kRounds * kWarps], s_m[kRounds * kWarps];
  __shared__ long long s_off[2 * kMaxBuckets];
  const int nv = s.header[kValid];
  const int base = blockIdx.x * kTile;
  if (base >= nv) return;
  const int buf = last_buffer(s.header);
  SortedRow rows[kRounds];
  load_rows(s.keys[buf], base, nv, rows);
  Place at[kRounds];
  bucket_offsets(totals, nb, s_off);
  place_rows(rows, base, tiles, heads, tile_base, info, s_off, s_c, s_m, at);
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (!at[r].ok) continue;
    const long long i = __ldg(s.idx[buf] + base + r * kThreads + threadIdx.x);
    copy_bytes(leaf_out + at[r].slot * elem, leaf + i * elem, elem);
    if (at[r].col + at[r].deg < at[r].d_b) zero_bytes(leaf_out + (at[r].slot + at[r].deg) * elem, elem);
  }
}

template <typename T>
T* at(void* scratch, size_t off) {
  return reinterpret_cast<T*>(static_cast<char*>(scratch) + off);
}

Buffers buffers(void* scratch, const Layout& l, bool with_idx) {
  Buffers b;
  for (int i = 0; i < 2; ++i) {
    b.keys[i] = at<unsigned>(scratch, l.keys[i]);
    b.dst[i] = at<int>(scratch, l.dst[i]);
    b.idx[i] = with_idx ? at<int>(scratch, l.idx[i]) : nullptr;
  }
  return b;
}

Sorted sorted(void* scratch, const Layout& l, bool with_idx) {
  const Buffers b = buffers(scratch, l, with_idx);
  Sorted s;
  for (int i = 0; i < 2; ++i) {
    s.keys[i] = b.keys[i];
    s.dst[i] = b.dst[i];
    s.idx[i] = b.idx[i];
  }
  s.header = at<int>(scratch, l.header);
  return s;
}

bool fits(int n, int with_idx, long long bytes) {
  return n > 0 && bytes >= static_cast<long long>(layout(n, with_idx).total);
}

template <bool kIdx>
cudaError_t launch_onesweep(int pass, const int* src, const int* dst, const uint8_t* mask, int n, const Buffers& b,
                            const int* header, int st, const int* ghist, unsigned* status, int* tickets,
                            cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kSortTile) * 4 * (kIdx ? 3 : 2);
  static bool granted[kMaxDevices] = {};  // the attribute is set for each device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!granted[dev]) {
    err = cudaFuncSetAttribute(rs_onesweep_kernel<kIdx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    granted[dev] = true;
  }
  rs_onesweep_kernel<kIdx><<<st, kThreads, smem, s>>>(pass, src, dst, mask, n, b, header, st, ghist, status,
                                                      tickets);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The scratch bytes of one build of n rows (with_idx: value leaves).
long long nb_scratch_bytes(int n, int with_idx) {
  return n > 0 ? static_cast<long long>(layout(n, with_idx).total) : 0;
}

// src, dst: int32[n]; mask: bool[n].  The stable radix sort of the valid
// rows by source into the scratch: the stats and plan kernels, then
// kMaxPasses one-sweep kernels (those past the plan return at once).
int nb_sort_launch(const void* src, const void* dst, const void* mask, int n, int with_idx, void* scratch,
                   long long bytes, void* stream) {
  if (!fits(n, with_idx, bytes)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(n, with_idx);
  const int st = (n + kSortTile - 1) / kSortTile;
  const auto* sp = static_cast<const int*>(src);
  const auto* dp = static_cast<const int*>(dst);
  const auto* mp = static_cast<const uint8_t*>(mask);
  int* header = at<int>(scratch, l.header);
  int* stats = at<int>(scratch, l.stats);
  int* ghist = at<int>(scratch, l.ghist);
  int* tickets = at<int>(scratch, l.tickets);
  unsigned* status = at<unsigned>(scratch, l.status);
  const Buffers b = buffers(scratch, l, with_idx != 0);
  cudaError_t err = cudaMemsetAsync(at<char>(scratch, l.zeroed), 0, l.zeroed_end - l.zeroed, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sst = (n + kStatTile - 1) / kStatTile;
  rs_stats_kernel<<<sst, kThreads, 0, s>>>(sp, mp, n, sst, stats);
  rs_plan_kernel<<<1, kPlanThreads, 0, s>>>(stats, sst, header);
  rs_ghist_kernel<<<st < kGhistBlocks ? st : kGhistBlocks, kThreads, 0, s>>>(sp, mp, n, header, ghist);
  err = cudaGetLastError();
  for (int pass = 0; pass < kMaxPasses && err == cudaSuccess; ++pass) {
    err = with_idx ? launch_onesweep<true>(pass, sp, dp, mp, n, b, header, st, ghist, status, tickets, s)
                   : launch_onesweep<false>(pass, sp, dp, mp, n, b, header, st, ghist, status, tickets, s);
  }
  return static_cast<int>(err);
}

// After nb_sort_launch: the heads, carry, count and scan kernels; totals:
// int32[nb], the rows of each bucket.
int nb_count_launch(int n, int nb, int with_idx, void* scratch, long long bytes, void* totals, void* stream) {
  if (!fits(n, with_idx, bytes) || nb <= 0 || nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout l = layout(n, with_idx);
  const int tiles = (n + kTile - 1) / kTile;
  const Sorted so = sorted(scratch, l, with_idx != 0);
  int* heads = at<int>(scratch, l.heads);
  int* tile_hist = at<int>(scratch, l.tile_hist);
  nb_count_kernel<<<tiles, kThreads, 0, s>>>(so, nb, tiles, at<int>(scratch, l.head_ticket),
                                              at<unsigned long long>(scratch, l.head_status), heads, tile_hist,
                                              at<int2>(scratch, l.info));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nb_scan_kernel<<<nb, kPlanThreads, 0, s>>>(tile_hist, tiles, at<int>(scratch, l.totals), static_cast<int*>(totals));
  return static_cast<int>(cudaGetLastError());
}

// After nb_count_launch: keys_out: int32[total keys]; nbrs_out:
// int32[total slots]; valid_out: bool[total slots].
int nb_scatter_launch(int n, int nb, int with_idx, void* scratch, long long bytes, void* keys_out, void* nbrs_out,
                      void* valid_out, void* stream) {
  if (!fits(n, with_idx, bytes) || nb <= 0 || nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n, with_idx);
  const int tiles = (n + kTile - 1) / kTile;
  nb_scatter_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted(scratch, l, with_idx != 0), nb, tiles, at<int>(scratch, l.heads), at<int>(scratch, l.tile_hist),
      at<int2>(scratch, l.info), at<int>(scratch, l.totals), static_cast<int*>(keys_out),
      static_cast<int*>(nbrs_out), static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}

// The same placement for one value leaf (a sort with value leaves): leaf
// holds n rows of elem bytes in arrival order, leaf_out total-slots rows.
int nb_scatter_values_launch(int n, int nb, void* scratch, long long bytes, const void* leaf, void* leaf_out,
                             int elem, void* stream) {
  if (!fits(n, 1, bytes) || nb <= 0 || nb > kMaxBuckets || elem <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n, 1);
  const int tiles = (n + kTile - 1) / kTile;
  nb_scatter_values_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted(scratch, l, true), nb, tiles, at<int>(scratch, l.heads), at<int>(scratch, l.tile_hist),
      at<int2>(scratch, l.info), at<int>(scratch, l.totals), static_cast<const char*>(leaf),
      static_cast<char*>(leaf_out), elem);
  return static_cast<int>(cudaGetLastError());
}

// After nb_sort_launch, for checks: the sorted valid rows' src, dst and
// (with_idx) arrival index into int32[n] outputs (the first `valid` rows
// written), and meta: int32[3] = (lo, valid rows, passes).
int nb_sorted_launch(int n, int with_idx, void* scratch, long long bytes, void* src_out, void* dst_out,
                     void* idx_out, void* meta, void* stream) {
  if (!fits(n, with_idx, bytes) || (idx_out && !with_idx)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(n, with_idx);
  rs_copy_kernel<<<132 * 4, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted(scratch, l, with_idx != 0), static_cast<int*>(src_out), static_cast<int*>(dst_out),
      static_cast<int*>(idx_out), static_cast<int*>(meta));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
