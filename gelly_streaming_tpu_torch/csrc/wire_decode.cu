// BDV wire decode for the H100: one launch turns a group-varint delta
// buffer into int32 src, dst (and val) columns.
//
// Port of gelly_streaming_tpu/ops/wire_decode.py (decode_varints,
// decode_bdv), bit for bit.  A BDV buffer of n edges holds per = 2 (or 3,
// valued) varints an edge: an unsigned dst delta, a zigzag global src delta
// (and a zigzag value).  Its head is a control block of ceil(per * n / 4)
// bytes, four 2-bit byte lengths (minus one) a byte; the value bytes follow,
// little-endian.  dst is the wrapping int32 sum of the dst deltas, src that
// of the unzigzagged src deltas.  Every byte read at or past the buffer's
// end reads its last byte, as the JAX decode's clipped gathers do, so
// bucket padding and arbitrary bytes decode as they decode there.
//
// The kernel: one tile of kTile edges a block, tiles taken by ticket in
// launch order.  A thread takes kItems consecutive edges (per * kItems
// varints, a multiple of 4, so no other thread reads its control bytes),
// sums their byte lengths, and the block scans the sums.  Two decoupled
// look-backs chain the tiles: the first gives the tile's byte offset, which
// depends on the control block alone; the block then stages its value bytes
// in shared memory by coalesced reads, decodes its varints into registers
// and scans its (dst, src) delta sums; the second look-back gives the delta
// sums of the tiles before it, and every thread writes its edges.  Each
// look-back is one warp reading 32 predecessors' flags a step.  Every tile
// waited on holds a ticket taken earlier, so it is running and its own
// waits end.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;                  // edges a thread, a multiple of 4
constexpr int kTile = kThreads * kItems;   // edges a tile

struct Tiles {
  int* ticket;          // the next tile to hand out
  int* byte_flags;      // 1: aggregate published, 2: inclusive prefix published
  int* delta_flags;
  long long* byte_aggs;
  long long* byte_incls;
  uint2* delta_aggs;    // (dst, src) wrapping sums
  uint2* delta_incls;
};

__device__ __forceinline__ uint32_t unzigzag(uint32_t z) { return (z >> 1) ^ (0u - (z & 1u)); }

__device__ __forceinline__ long long add(long long a, long long b) { return a + b; }
__device__ __forceinline__ uint2 add(uint2 a, uint2 b) { return make_uint2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ long long shfl_up(long long v, int d) { return __shfl_up_sync(0xffffffffu, v, d); }
__device__ __forceinline__ uint2 shfl_up(uint2 v, int d) {
  return make_uint2(__shfl_up_sync(0xffffffffu, v.x, d), __shfl_up_sync(0xffffffffu, v.y, d));
}

__device__ __forceinline__ long long shfl_down(long long v, int d) { return __shfl_down_sync(0xffffffffu, v, d); }
__device__ __forceinline__ uint2 shfl_down(uint2 v, int d) {
  return make_uint2(__shfl_down_sync(0xffffffffu, v.x, d), __shfl_down_sync(0xffffffffu, v.y, d));
}
__device__ __forceinline__ long long shfl0(long long v) { return __shfl_sync(0xffffffffu, v, 0); }
__device__ __forceinline__ uint2 shfl0(uint2 v) {
  return make_uint2(__shfl_sync(0xffffffffu, v.x, 0), __shfl_sync(0xffffffffu, v.y, 0));
}

__device__ __forceinline__ long long load_cg(const long long* p) { return __ldcg(p); }
__device__ __forceinline__ uint2 load_cg(const uint2* p) { return __ldcg(p); }

// The exclusive block scan of each thread's `mine`; *total gets the sum.
template <typename T>
__device__ T block_exclusive(T mine, T identity, T* warp_tot, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T up = shfl_up(inc, d);
    if (lane >= d) inc = add(inc, up);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  T pre = identity, all = identity;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w == warp) pre = all;
    all = add(all, warp_tot[w]);
  }
  *total = all;
  const T exc = shfl_up(inc, 1);
  return add(pre, lane == 0 ? identity : exc);
}

// Warp 0: publish the tile's total and return the sum of the tiles before
// it.  The lanes read 32 predecessors' flags at once (lane l: tile - 1 - l
// past the window's start); the window ends at the nearest tile with its
// inclusive prefix published, and the lanes up to it are summed.
template <typename T>
__device__ T look_back(int tile, T total, T identity, int* flags_p, T* aggs, T* incls) {
  volatile int* flags = flags_p;
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) {
      incls[0] = total;
      __threadfence();
      flags[0] = 2;
    }
    return identity;
  }
  if (lane == 0) {
    aggs[tile] = total;
    __threadfence();
    flags[tile] = 1;
  }
  T prefix = identity;
  for (int j = tile - 1;; j -= 32) {
    const int idx = j - lane;
    int f = idx >= 0 ? flags[idx] : 2;
    while (__any_sync(0xffffffffu, f == 0)) {
      if (f == 0) f = flags[idx];
    }
    __threadfence();
    const unsigned done = __ballot_sync(0xffffffffu, f == 2);
    const int stop = done ? __ffs(done) - 1 : 32;
    T v = identity;
    if (lane <= stop && idx >= 0) v = f == 2 ? load_cg(incls + idx) : load_cg(aggs + idx);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v = add(v, shfl_down(v, d));
    prefix = add(prefix, shfl0(v));
    if (done) break;
  }
  if (lane == 0) {
    incls[tile] = add(prefix, total);
    __threadfence();
    flags[tile] = 2;
  }
  return prefix;
}

template <int kPer>
__global__ void __launch_bounds__(kThreads)
bdv_decode_kernel(const uint8_t* __restrict__ buf, long long nb, int n, long long ctrl, int* __restrict__ src,
                  int* __restrict__ dst, int* __restrict__ val, Tiles st) {
  constexpr int kVals = kPer * kItems;  // varints a thread, a multiple of 4
  __shared__ uint8_t bytes[kTile * kPer * 4];
  __shared__ long long warp_bytes[kWarps];
  __shared__ uint2 warp_deltas[kWarps];
  __shared__ long long byte_prefix;
  __shared__ uint2 delta_prefix;
  __shared__ int tile_s;
  if (threadIdx.x == 0) tile_s = atomicAdd(st.ticket, 1);
  __syncthreads();
  const int tile = tile_s;
  const long long e0 = static_cast<long long>(tile) * kTile + static_cast<long long>(threadIdx.x) * kItems;
  const long long left = n - e0;
  const int m = left <= 0 ? 0 : (left >= kItems ? kItems : static_cast<int>(left));
  const int count = kPer * m;

  // byte lengths from this thread's control bytes (k = kPer * e0 + i, and
  // kPer * e0 is a multiple of 4)
  const long long cbase = kPer * e0 / 4;
  int len[kVals];
  long long mine = 0;
#pragma unroll
  for (int c = 0; c < kVals / 4; ++c) {
    long long at = cbase + c;
    at = at < nb ? at : nb - 1;
    const uint32_t cb = __ldg(buf + at);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * c + q;
      len[i] = i < count ? static_cast<int>((cb >> (2 * q)) & 3u) + 1 : 0;
      mine += len[i];
    }
  }
  long long tile_bytes;
  const long long excl = block_exclusive<long long>(mine, 0, warp_bytes, &tile_bytes);
  if (threadIdx.x < 32) {
    const long long p = look_back<long long>(tile, tile_bytes, 0, st.byte_flags, st.byte_aggs, st.byte_incls);
    if (threadIdx.x == 0) byte_prefix = p;
  }
  __syncthreads();

  // stage the tile's value bytes, each read clipped to the buffer's last byte
  const long long start = ctrl + byte_prefix;
  for (int i = threadIdx.x; i < tile_bytes; i += kThreads) {
    const long long at = start + i;
    bytes[i] = __ldg(buf + (at < nb ? at : nb - 1));
  }
  __syncthreads();

  uint32_t v[kVals];
  int off = static_cast<int>(excl);
#pragma unroll
  for (int i = 0; i < kVals; ++i) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < len[i]) x |= static_cast<uint32_t>(bytes[off + j]) << (8 * j);
    off += len[i];
    v[i] = x;
  }
  uint2 sums = make_uint2(0u, 0u);
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    if (q < m) {
      sums.x += v[kPer * q];
      sums.y += unzigzag(v[kPer * q + 1]);
    }
  }
  uint2 tile_sums;
  const uint2 dexcl = block_exclusive<uint2>(sums, make_uint2(0u, 0u), warp_deltas, &tile_sums);
  if (threadIdx.x < 32) {
    const uint2 p = look_back<uint2>(tile, tile_sums, make_uint2(0u, 0u), st.delta_flags, st.delta_aggs,
                                     st.delta_incls);
    if (threadIdx.x == 0) delta_prefix = p;
  }
  __syncthreads();

  uint2 run = add(delta_prefix, dexcl);
  int d_out[kItems], s_out[kItems], v_out[kItems];
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    run.x += q < m ? v[kPer * q] : 0u;
    run.y += q < m ? unzigzag(v[kPer * q + 1]) : 0u;
    d_out[q] = static_cast<int>(run.x);
    s_out[q] = static_cast<int>(run.y);
    v_out[q] = kPer == 3 ? static_cast<int>(unzigzag(v[kPer * q + (kPer - 1)])) : 0;
  }
  if (m == kItems) {  // 16-byte aligned: e0 is a multiple of kItems, itself of 4
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      const int k = 4 * q;
      reinterpret_cast<int4*>(dst + e0)[q] = make_int4(d_out[k], d_out[k + 1], d_out[k + 2], d_out[k + 3]);
      reinterpret_cast<int4*>(src + e0)[q] = make_int4(s_out[k], s_out[k + 1], s_out[k + 2], s_out[k + 3]);
      if (kPer == 3)
        reinterpret_cast<int4*>(val + e0)[q] = make_int4(v_out[k], v_out[k + 1], v_out[k + 2], v_out[k + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (q < m) {
        dst[e0 + q] = d_out[q];
        src[e0 + q] = s_out[q];
        if (kPer == 3) val[e0 + q] = v_out[q];
      }
    }
  }
}

struct Layout {
  long long tiles, header, total;
};

// ticket and the two flag arrays (zeroed before each launch), then (16 B
// aligned) the byte sums and the delta sums of every tile
Layout layout_of(int n) {
  const long long tiles = (static_cast<long long>(n) + kTile - 1) / kTile;
  const long long header = (4 + 8 * tiles + 15) / 16 * 16;
  return {tiles, header, header + 32 * tiles};
}

}  // namespace

extern "C" {

// The scratch bytes of one bdv_decode_launch over n edges.
long long bdv_decode_scratch_bytes(int n) { return n > 0 ? layout_of(n).total : 0; }

// buf: uint8[nb] (nb >= 1); n edges; valued: the 3-stream layout; src, dst
// (and val when valued): int32[n], 16-byte aligned; scratch: at least
// bdv_decode_scratch_bytes(n) bytes; stream: the caller's stream.  A memset
// of the scratch's header, then the one decode kernel.
int bdv_decode_launch(const void* buf, long long nb, int n, int valued, void* src, void* dst, void* val,
                      void* scratch, long long scratch_bytes, void* stream) {
  if (n <= 0) return 0;
  const Layout l = layout_of(n);
  const auto misaligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  if (nb < 1 || scratch_bytes < l.total || (valued && val == nullptr) || misaligned(src) || misaligned(dst) ||
      (valued && misaligned(val)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* base = static_cast<uint8_t*>(scratch);
  Tiles st;
  st.ticket = reinterpret_cast<int*>(base);
  st.byte_flags = st.ticket + 1;
  st.delta_flags = st.byte_flags + l.tiles;
  st.byte_aggs = reinterpret_cast<long long*>(base + l.header);
  st.byte_incls = st.byte_aggs + l.tiles;
  st.delta_aggs = reinterpret_cast<uint2*>(st.byte_incls + l.tiles);
  st.delta_incls = st.delta_aggs + l.tiles;
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.header, s);
  if (err != cudaSuccess) return err;
  const int per = valued ? 3 : 2;
  const long long ctrl = (static_cast<long long>(per) * n + 3) / 4;
  const auto* b = static_cast<const uint8_t*>(buf);
  const int grid = static_cast<int>(l.tiles);
  if (valued)
    bdv_decode_kernel<3><<<grid, kThreads, 0, s>>>(b, nb, n, ctrl, static_cast<int*>(src), static_cast<int*>(dst),
                                                   static_cast<int*>(val), st);
  else
    bdv_decode_kernel<2><<<grid, kThreads, 0, s>>>(b, nb, n, ctrl, static_cast<int*>(src), static_cast<int*>(dst),
                                                   nullptr, st);
  return cudaGetLastError();
}

}  // extern "C"
