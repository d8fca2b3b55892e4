// The wire decodes for the H100: the BDV group-varint batch and the EF40
// multiset, each one cooperative launch that turns a wire buffer into int32
// src, dst (and val) columns.
//
// bdv_decode: port of gelly_streaming_tpu/ops/wire_decode.py (decode_varints,
// decode_bdv), bit for bit.  A BDV buffer of n edges holds per = 2 (or 3,
// valued) varints an edge: an unsigned dst delta, a zigzag global src delta
// (and a zigzag value).  Its head is a control block of ceil(per * n / 4)
// bytes, four 2-bit byte lengths (minus one) a byte; the value bytes follow,
// little-endian.  dst is the wrapping int32 sum of the dst deltas, src that
// of the unzigzagged src deltas.  Every byte read at or past the buffer's
// end reads its last byte, as the JAX decode's clipped gathers do, so
// bucket padding and arbitrary bytes decode as they decode there.
//
// The kernel: a block an SM (1,024 threads, 16 edges a thread: a chunk of
// 16,384 edges a block a round; a CC batch of 2^21 edges is one round of
// 128 blocks).  Two reductions chain the chunks, each across one grid-wide
// sync and with no flags, so the launch needs no memset and no ticket:
//   1. each thread sums its edges' byte lengths from its control bytes (8 or
//      12, kept in registers), the block scans the sums and publishes its
//      chunk's byte total; grid sync;
//   2. each block adds the totals of the chunks before it (one read a
//      thread) to find where its bytes start, stages them in shared memory
//      by 16-byte loads, decodes its varints into registers (a varint is two
//      aligned 4-byte shared reads and a funnel shift), scans its (dst, src)
//      delta sums, publishes the chunk's sums and writes its running sums
//      (and values) into shared memory; grid sync;
//   3. each block adds the sums of the chunks before it and writes its
//      edges from shared memory, a warp 128 contiguous bytes a store.
// Larger batches take more rounds, each carrying the totals of the last.
//
// ef40_unpack: port of gelly_streaming_tpu/io/wire.py unpack_edges_ef40,
// bit for bit.  An EF40 buffer of n edges over C ids holds a unary src
// histogram of n + C bits (LSB first; the i-th one, at position p, gives
// src[i] = p - i), then the 20-bit dsts, two to 5 bytes.  Ranks the
// bitvector lacks decode to 0, ones at rank >= n are dropped, bits past
// n + C are ignored.  One cooperative launch: each block counts the ones of
// its pieces (512 words of 32 bits a piece) and decodes tiles of dst pairs
// (staged in shared memory by 16-byte loads, written as 16-byte stores);
// grid sync; each block adds the counts of the blocks before it, then, a
// piece at a time, scans the words' counts, writes each one bit's p - rank
// into shared memory at its rank (a piece's ranks are contiguous) and copies
// them out coalesced; the blocks then zero the ranks past the last one.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlocks = 1024;  // a launch's blocks: at most the scratch's slots

// ---------------------------------------------------------------------------
// shared helpers

__device__ __forceinline__ uint32_t unzigzag(uint32_t z) { return (z >> 1) ^ (0u - (z & 1u)); }

__device__ __forceinline__ uint2 add(uint2 a, uint2 b) { return make_uint2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ int shfl_up(int v, int d) { return __shfl_up_sync(0xffffffffu, v, d); }
__device__ __forceinline__ uint2 shfl_up(uint2 v, int d) {
  return make_uint2(__shfl_up_sync(0xffffffffu, v.x, d), __shfl_up_sync(0xffffffffu, v.y, d));
}
__device__ __forceinline__ int add(int a, int b) { return a + b; }

__device__ __forceinline__ long long shfl_down(long long v, int d) { return __shfl_down_sync(0xffffffffu, v, d); }
__device__ __forceinline__ uint2 shfl_down(uint2 v, int d) {
  return make_uint2(__shfl_down_sync(0xffffffffu, v.x, d), __shfl_down_sync(0xffffffffu, v.y, d));
}

// The exclusive block scan of each thread's `mine`; *total gets the sum.
// warp_tot: kThreads / 32 slots of shared memory.
template <int kThreads, typename T>
__device__ T block_exclusive(T mine, T identity, T* warp_tot, T* total) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = shfl_up(inc, d);
    if (lane >= d) inc = add(inc, up);
  }
  __syncthreads();  // warp_tot's last readers are done
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  T pre = identity, all = identity;
#pragma unroll 8
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) pre = all;
    all = add(all, warp_tot[w]);
  }
  *total = all;
  const T exc = shfl_up(inc, 1);
  return add(pre, lane == 0 ? identity : exc);
}

// Over the grid's published totals tot[0, G): (the sum of those before
// block b, the sum of all).  Every thread gets both.  red: kThreads / 32 * 2
// slots of shared memory.
template <int kThreads, typename T, typename Sum>
__device__ void grid_prefix(const T* tot, int G, int b, T identity, Sum sum, T* red, T* before, T* all) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T pre = identity, tot_all = identity;
  for (int i = threadIdx.x; i < G; i += kThreads) {
    const T v = __ldcg(tot + i);  // written by other blocks before the grid sync: bypass L1
    tot_all = sum(tot_all, v);
    if (i < b) pre = sum(pre, v);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    pre = sum(pre, shfl_down(pre, d));
    tot_all = sum(tot_all, shfl_down(tot_all, d));
  }
  __syncthreads();  // red's last readers are done
  if (lane == 0) {
    red[warp] = pre;
    red[kWarps + warp] = tot_all;
  }
  __syncthreads();
  T p = identity, a = identity;
#pragma unroll 8
  for (int w = 0; w < kWarps; ++w) {
    p = sum(p, red[w]);
    a = sum(a, red[kWarps + w]);
  }
  *before = p;
  *all = a;
}

// Bytes [start, start + len) of buf (reads at or past nb read byte nb - 1)
// into s, the byte at `start` landing at s[lead], lead the address's offset
// in its 16-byte word: whole words inside the buffer by 16-byte loads,
// words past its end as the last byte repeated, the words that straddle
// either end byte by byte.  s holds lead + len rounded up to 16 bytes.
__device__ int stage(uint8_t* s, const uint8_t* __restrict__ buf, long long nb, long long start, long long len,
                     int threads) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(buf);
  const uintptr_t end = base + static_cast<uintptr_t>(nb);
  const uintptr_t a = base + static_cast<uintptr_t>(start);
  const int lead = static_cast<int>(a & 15);
  const uintptr_t a0 = a - lead;
  const long long words = (lead + len + 15) / 16;
  const uint32_t last = buf[nb - 1];
  for (long long w = threadIdx.x; w < words; w += threads) {
    const uintptr_t g = a0 + 16 * static_cast<uintptr_t>(w);
    uint4 v;
    if (g >= base && g + 16 <= end) {
      v = __ldg(reinterpret_cast<const uint4*>(g));
    } else if (g >= end) {
      const uint32_t x = last * 0x01010101u;
      v = make_uint4(x, x, x, x);
    } else {
      uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uintptr_t p = g + j;
        const uint32_t byte = p < base ? 0u : (p < end ? static_cast<uint32_t>(__ldg(buf + (p - base))) : last);
        x[j >> 2] |= byte << (8 * (j & 3));
      }
      v = make_uint4(x[0], x[1], x[2], x[3]);
    }
    reinterpret_cast<uint4*>(s)[w] = v;
  }
  return lead;
}

// ---------------------------------------------------------------------------
// bdv_decode

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                 // edges a thread a round, a multiple of 4
constexpr int kChunk = kThreads * kItems;  // edges a block a round
constexpr int kRow = kItems + 1;           // a thread's edges in a shared column, padded: no bank conflicts
constexpr int kCol = kThreads * kRow;      // a column's words

// the dynamic shared bytes: a chunk's value bytes at 4 a varint, a word of
// lead and the 8 bytes a funnel read may touch past the last; then, in the
// same bytes, the chunk's kPer output columns
constexpr int bdv_smem(int per) {
  return per * kChunk * 4 + 32 > per * kCol * 4 ? per * kChunk * 4 + 32 : per * kCol * 4;
}

struct Totals {
  long long* bytes;  // [G]: each chunk's value bytes this round
  uint2* deltas;     // [G]: each chunk's (dst, src) delta sums this round
};

template <int kPer>
__global__ void __launch_bounds__(kThreads, 1)
bdv_decode_kernel(const uint8_t* __restrict__ buf, long long nb, int n, long long ctrl, int* __restrict__ src,
                  int* __restrict__ dst, int* __restrict__ val, Totals tot) {
  constexpr int kVals = kPer * kItems;  // varints a thread
  constexpr int kCtrl = kVals / 4;      // its control bytes
  extern __shared__ uint4 smem4[];
  uint8_t* bytes = reinterpret_cast<uint8_t*>(smem4);
  const uint32_t* words = reinterpret_cast<const uint32_t*>(smem4);
  uint32_t* cols = reinterpret_cast<uint32_t*>(smem4);  // [kPer][kCol]: the dst, src (and val) columns
  __shared__ int warp_int[kWarps];
  __shared__ uint2 warp_pair[kWarps];
  __shared__ long long red_ll[2 * kWarps];
  __shared__ uint2 red_pair[2 * kWarps];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const bool aligned = (reinterpret_cast<uintptr_t>(buf) & 3) == 0;
  long long byte_base = 0;
  uint2 delta_base = make_uint2(0u, 0u);

  for (long long round = 0; round < n; round += static_cast<long long>(G) * kChunk) {
    const long long c0 = round + static_cast<long long>(b) * kChunk;  // the chunk's first edge
    const long long e0 = c0 + static_cast<long long>(threadIdx.x) * kItems;
    const long long left = n - e0;
    const int m = left <= 0 ? 0 : (left >= kItems ? kItems : static_cast<int>(left));
    const int count = kPer * m;

    // 1. the byte lengths from this thread's control bytes (varint k = kPer
    // * e0 + i, and kPer * e0 is a multiple of 4)
    const long long cbase = kPer * e0 / 4;
    uint32_t cw[kCtrl / 4];
    if (aligned && cbase + kCtrl <= nb) {
#pragma unroll
      for (int c = 0; c < kCtrl / 4; ++c) cw[c] = __ldg(reinterpret_cast<const uint32_t*>(buf + cbase) + c);
    } else {
#pragma unroll
      for (int c = 0; c < kCtrl / 4; ++c) {
        uint32_t x = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const long long at = cbase + 4 * c + q;
          x |= static_cast<uint32_t>(__ldg(buf + (at < nb ? at : nb - 1))) << (8 * q);
        }
        cw[c] = x;
      }
    }
    int mine = 0;
#pragma unroll
    for (int i = 0; i < kVals; ++i) mine += i < count ? static_cast<int>((cw[i >> 4] >> (2 * (i & 15))) & 3u) + 1 : 0;
    int chunk_bytes;
    const int excl = block_exclusive<kThreads, int>(mine, 0, warp_int, &chunk_bytes);
    if (threadIdx.x == 0) tot.bytes[b] = chunk_bytes;
    grid.sync();

    // 2. where the chunk's bytes start; stage them; decode; the delta sums
    long long bytes_before, bytes_all;
    grid_prefix<kThreads, long long>(tot.bytes, G, b, 0LL, [](long long x, long long y) { return x + y; }, red_ll,
                                     &bytes_before, &bytes_all);
    const int lead = stage(bytes, buf, nb, ctrl + byte_base + bytes_before, chunk_bytes, kThreads);
    __syncthreads();
    uint32_t dsum[kItems], ssum[kItems], vals[kItems];  // vals: the valued layout's
    uint2 run = make_uint2(0u, 0u);
    int off = lead + excl;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      uint32_t v[kPer];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = kPer * q + r;
        const int len = i < count ? static_cast<int>((cw[i >> 4] >> (2 * (i & 15))) & 3u) + 1 : 0;
        const uint32_t lo = words[off >> 2], hi = words[(off >> 2) + 1];
        const uint32_t x = __funnelshift_r(lo, hi, 8 * (off & 3));
        v[r] = len == 4 ? x : x & ((1u << (8 * len)) - 1u);
        off += len;
      }
      run.x += v[0];  // 0 past the thread's m edges
      run.y += unzigzag(v[1]);
      dsum[q] = run.x;
      ssum[q] = run.y;
      vals[q] = unzigzag(v[kPer - 1]);
    }
    uint2 chunk_sums;
    const uint2 dexcl = block_exclusive<kThreads, uint2>(run, make_uint2(0u, 0u), warp_pair, &chunk_sums);
    if (threadIdx.x == 0) tot.deltas[b] = chunk_sums;
    // the scan's barriers passed: every thread's reads of the staged bytes
    // are done, so the columns take their place
    uint32_t* row = cols + threadIdx.x * kRow;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      row[q] = dexcl.x + dsum[q];
      row[kCol + q] = dexcl.y + ssum[q];
      if (kPer == 3) row[2 * kCol + q] = vals[q];
    }
    grid.sync();

    // 3. the sums of the chunks before; the edges, coalesced
    uint2 deltas_before, deltas_all;
    grid_prefix<kThreads, uint2>(tot.deltas, G, b, make_uint2(0u, 0u), [](uint2 x, uint2 y) { return add(x, y); },
                                 red_pair, &deltas_before, &deltas_all);
    const uint2 p = add(delta_base, deltas_before);
    const long long here = n - c0;
    const int edges = here <= 0 ? 0 : (here >= kChunk ? kChunk : static_cast<int>(here));
    for (int i = threadIdx.x; i < edges; i += kThreads) {
      const int at = (i / kItems) * kRow + i % kItems;
      dst[c0 + i] = static_cast<int>(p.x + cols[at]);
      src[c0 + i] = static_cast<int>(p.y + cols[kCol + at]);
      if (kPer == 3) val[c0 + i] = static_cast<int>(cols[2 * kCol + at]);
    }
    byte_base += bytes_all;
    delta_base = add(delta_base, deltas_all);
  }
}

// ---------------------------------------------------------------------------
// ef40_unpack

constexpr int kBitThreads = 512;
constexpr int kPairs = 4;                          // dst pairs a thread a tile
constexpr int kPairTile = kBitThreads * kPairs;    // pairs a tile
constexpr int kEfSmem = kBitThreads * 32 * 4;      // a piece's ranks (all ones); holds a pair tile too
static_assert(kPairTile * 5 + 32 <= kEfSmem, "a pair tile's staging fits the piece buffer");

// the 32 bits of bitvector word w (bytes 4w..4w+3, little endian) that lie
// below bit L
__device__ __forceinline__ uint32_t bit_word(const uint8_t* __restrict__ buf, long long w, long long L) {
  uint32_t x = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long at = 4 * w + q;
    if (8 * at < L) x |= static_cast<uint32_t>(__ldg(buf + at)) << (8 * q);
  }
  const long long rest = L - 32 * w;
  return rest >= 32 ? x : x & ((1u << rest) - 1u);
}

__global__ void __launch_bounds__(kBitThreads)
ef40_unpack_kernel(const uint8_t* __restrict__ buf, long long nb, int n, int capacity, int* __restrict__ src,
                   int* __restrict__ dst, long long* __restrict__ counts) {
  extern __shared__ uint4 smem4[];
  uint8_t* staged = reinterpret_cast<uint8_t*>(smem4);
  int* ranks = reinterpret_cast<int*>(smem4);
  __shared__ int warp_int[kBitThreads / 32];
  __shared__ long long red_ll[2 * (kBitThreads / 32)];
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x;
  const long long L = static_cast<long long>(n) + capacity;  // bits
  const long long bvbytes = (L + 7) / 8;
  const long long W = (L + 31) / 32;  // bitvector words, the last partial
  const long long pieces = (W + kBitThreads - 1) / kBitThreads;
  const long long p0 = pieces * b / G, p1 = pieces * (b + 1) / G;
  const long long w_end = p1 * kBitThreads < W ? p1 * kBitThreads : W;

  // the ones in this block's pieces
  int mine = 0;
  for (long long w = p0 * kBitThreads + threadIdx.x; w < w_end; w += kBitThreads) mine += __popc(bit_word(buf, w, L));
  int block_ones;
  block_exclusive<kBitThreads, int>(mine, 0, warp_int, &block_ones);
  if (threadIdx.x == 0) counts[b] = block_ones;

  // the dst pairs, a tile a block in turn: (lo, hi) = the 40 bits' low and
  // high 20
  const long long npairs = (static_cast<long long>(n) + 1) / 2;
  const long long tiles = (npairs + kPairTile - 1) / kPairTile;
  for (long long t = b; t < tiles; t += G) {
    const long long first = t * kPairTile;
    const long long in_tile = npairs - first < kPairTile ? npairs - first : kPairTile;
    __syncthreads();  // the last tile's readers are done
    const int lead = stage(staged, buf, nb, bvbytes + 5 * first, 5 * in_tile, kBitThreads);
    __syncthreads();
    const long long e0 = 2 * (first + static_cast<long long>(threadIdx.x) * kPairs);  // this thread's first edge
    int out[2 * kPairs];
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int at = lead + 5 * (threadIdx.x * kPairs + k);
      uint64_t v = 0;
#pragma unroll
      for (int j = 0; j < 5; ++j) v |= static_cast<uint64_t>(staged[at + j]) << (8 * j);
      out[2 * k] = static_cast<int>(v & 0xFFFFFu);
      out[2 * k + 1] = static_cast<int>((v >> 20) & 0xFFFFFu);
    }
    if (e0 + 2 * kPairs <= n) {  // 16-byte aligned: e0 is a multiple of 2 * kPairs, itself of 4
#pragma unroll
      for (int q = 0; q < kPairs / 2; ++q)
        reinterpret_cast<int4*>(dst + e0)[q] = make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 2 * kPairs; ++k)
        if (e0 + k < n) dst[e0 + k] = out[k];
    }
  }
  grid.sync();

  // the ranks: a piece at a time, each one bit's p - rank written at its
  // rank in shared memory, then copied out
  long long rank0, ones;
  grid_prefix<kBitThreads, long long>(counts, G, b, 0LL, [](long long x, long long y) { return x + y; }, red_ll,
                                      &rank0, &ones);
  for (long long piece = p0; piece < p1; ++piece) {
    const long long w = piece * kBitThreads + threadIdx.x;
    uint32_t x = w < W ? bit_word(buf, w, L) : 0u;
    int piece_ones;
    int r = block_exclusive<kBitThreads, int>(__popc(x), 0, warp_int, &piece_ones);
    // ranks' last readers passed the scan's barriers
    while (x) {
      const int j = __ffs(x) - 1;
      x &= x - 1;
      ranks[r] = static_cast<int>(32 * w + j - (rank0 + r));  // int32 arithmetic, as JAX's wraps
      ++r;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < piece_ones; i += kBitThreads) {
      const long long rank = rank0 + i;
      if (rank < n) src[rank] = ranks[i];
    }
    rank0 += piece_ones;
  }
  // the ranks the bitvector lacks
  for (long long rank = (ones < n ? ones : n) + static_cast<long long>(b) * kBitThreads + threadIdx.x; rank < n;
       rank += static_cast<long long>(G) * kBitThreads)
    src[rank] = 0;
}

// ---------------------------------------------------------------------------
// launches

constexpr int kMaxDevices = 32;

struct Device {
  int sms = 0;
  int fit[3] = {0, 0, 0};  // co-resident blocks a launch of kernel slot k may take
};

Device devices[kMaxDevices];

template <typename K>
cudaError_t fit_of(int slot, K kernel, int threads, int smem, int* fit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Device& d = devices[dev];
  if (d.fit[slot] == 0) {
    if (d.sms == 0 && (err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) != cudaSuccess)
      return err;
    int per_sm = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    d.fit[slot] = per_sm * d.sms < kMaxBlocks ? per_sm * d.sms : kMaxBlocks;
  }
  *fit = d.fit[slot];
  return cudaSuccess;
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

extern "C" {

// The scratch bytes of one bdv_decode_launch over n edges: each block's
// totals (its chunk's byte total, its delta sums), written before they are
// read, so never zeroed.
long long bdv_decode_scratch_bytes(int n) { return n > 0 ? 16LL * kMaxBlocks : 0; }

// buf: uint8[nb] (nb >= 1); n edges; valued: the 3-stream layout; src, dst
// (and val when valued): int32[n], 16-byte aligned; scratch: at least
// bdv_decode_scratch_bytes(n) bytes; stream: the caller's stream.  One
// cooperative launch, at most a block an SM.
int bdv_decode_launch(const void* buf, long long nb, int n, int valued, void* src, void* dst, void* val,
                      void* scratch, long long scratch_bytes, void* stream) {
  if (n <= 0) return 0;
  if (nb < 1 || scratch_bytes < bdv_decode_scratch_bytes(n) || (valued && val == nullptr) || misaligned(src) ||
      misaligned(dst) || (valued && misaligned(val)))
    return cudaErrorInvalidValue;
  const int per = valued ? 3 : 2;
  const int smem = bdv_smem(per);
  const void* kernel = valued ? reinterpret_cast<const void*>(bdv_decode_kernel<3>)
                              : reinterpret_cast<const void*>(bdv_decode_kernel<2>);
  int fit = 0;
  cudaError_t err = valued ? fit_of(1, bdv_decode_kernel<3>, kThreads, smem, &fit)
                           : fit_of(0, bdv_decode_kernel<2>, kThreads, smem, &fit);
  if (err != cudaSuccess) return err;
  const long long want = (static_cast<long long>(n) + kChunk - 1) / kChunk;
  const int blocks = static_cast<int>(want < fit ? want : fit);
  Totals tot;
  tot.bytes = static_cast<long long*>(scratch);
  tot.deltas = reinterpret_cast<uint2*>(tot.bytes + kMaxBlocks);
  long long ctrl = (static_cast<long long>(per) * n + 3) / 4;
  const auto* b = static_cast<const uint8_t*>(buf);
  int* s = static_cast<int*>(src);
  int* d = static_cast<int*>(dst);
  int* v = static_cast<int*>(val);
  void* args[] = {&b, &nb, &n, &ctrl, &s, &d, &v, &tot};
  return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, static_cast<size_t>(smem),
                                     static_cast<cudaStream_t>(stream));
}

// The scratch bytes of one ef40_unpack_launch over n edges: each block's
// count of ones, written before it is read.
long long ef40_unpack_scratch_bytes(int n, int capacity) {
  return n > 0 && capacity >= 0 ? 8LL * kMaxBlocks : 0;
}

// buf: uint8[nb], nb >= ef40_nbytes(n, capacity) = ceil((n + capacity) / 8)
// + 5 ceil(n / 2); src, dst: int32[n], 16-byte aligned; scratch: at least
// ef40_unpack_scratch_bytes(n, capacity) bytes; stream: the caller's.  One
// cooperative launch.
int ef40_unpack_launch(const void* buf, long long nb, int n, int capacity, void* src, void* dst, void* scratch,
                       long long scratch_bytes, void* stream) {
  if (n <= 0) return n < 0 || capacity < 0 ? cudaErrorInvalidValue : 0;
  const long long need = (static_cast<long long>(n) + capacity + 7) / 8 + 5 * ((static_cast<long long>(n) + 1) / 2);
  if (capacity < 0 || nb < need || scratch_bytes < ef40_unpack_scratch_bytes(n, capacity) || misaligned(src) ||
      misaligned(dst))
    return cudaErrorInvalidValue;
  int fit = 0;
  cudaError_t err = fit_of(2, ef40_unpack_kernel, kBitThreads, kEfSmem, &fit);
  if (err != cudaSuccess) return err;
  const long long words = ((static_cast<long long>(n) + capacity) + 31) / 32;
  const long long pieces = (words + kBitThreads - 1) / kBitThreads;
  const long long tiles = ((static_cast<long long>(n) + 1) / 2 + kPairTile - 1) / kPairTile;
  long long want = pieces > tiles ? pieces : tiles;
  const int blocks = static_cast<int>(want < fit ? want : fit);
  const auto* b = static_cast<const uint8_t*>(buf);
  int* s = static_cast<int*>(src);
  int* d = static_cast<int*>(dst);
  long long* counts = static_cast<long long*>(scratch);
  void* args[] = {&b, &nb, &n, &capacity, &s, &d, &counts};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(ef40_unpack_kernel), dim3(blocks),
                                     dim3(kBitThreads), args, static_cast<size_t>(kEfSmem),
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
