// Degree-bucketed neighborhood build on Hopper (sm_90a) behind a plain C
// interface, loaded with ctypes (gelly_streaming_tpu_torch/ops/_cuda.py,
// ops/neighborhoods.py).
//
// Replaces build_buckets (gelly_streaming_tpu/ops/neighborhoods.py:55-135),
// an XLA program of the JAX package: a stable argsort of the grouping keys,
// a cumsum of segment heads, a cummax of head positions, per-key degree and
// key scatters, then, for each of the ~log2(E) degree buckets, a cumsum of
// the bucket's keys and scatters of every edge into zero-filled [K_b, D_b]
// tensors whose static shapes hold about 2E slots each.  The sort of the
// int32 grouping keys 2 * src + !mask stays a library sort (torch.sort,
// stable), as the JAX package leaves it to XLA.  After it:
//   nb_count_kernel, in sorted order, one 1024-row tile a block, 4 rows a
//   thread: a row at the end of a valid segment finds the segment's head by
//   a galloping search back over the sorted keys (O(log degree) cached
//   reads), so it knows the key's degree and bucket (integer ceil-log2, as
//   the JAX package's clz).  The segment's row within its bucket is the
//   count of earlier valid segments of that bucket in sorted order: within
//   the tile, __match_any_sync ranks the ends of each warp and a shared
//   per-bucket histogram chains the warps and the four rounds; (degree,
//   rank in tile) goes to the segment's head.  Each tile's <= 32-wide
//   histogram goes to a [bucket][tile] table.
//   nb_scan_kernel, one block: a warp a bucket scans that table across
//   tiles (exclusive, in place), and thread 0 lays the buckets out one
//   after another (key and slot offsets, 64-bit).  The wrapper copies the
//   <= 32 bucket totals to the host and allocates exactly the real rows.
//   nb_scatter_kernel, in sorted order: each valid row finds its head
//   again, reads (degree, rank) there and the tile base of the segment's
//   end, and writes its neighbor into slot (row, col) with col its arrival
//   rank, and its valid flag; a key's rows are contiguous in sorted order,
//   so these writes coalesce along a row.  The same row also writes the
//   padding slot col + degree when that lies below D_b (a key's degree
//   exceeds D_b / 2, so every padding slot is written once) and the head
//   writes the key, max(src, 0) as the JAX package's scatter-max against
//   zeros gives it.  Every output cell is written exactly once, so the
//   outputs need no memset.  nb_scatter_values_kernel does the same for
//   one value leaf, as bytes.
// Slot offsets are row * D_b + col in 64 bits.
//   Bound on the H100 (bytes), for one pane of the GraphSAGE main path
// (2^21 edges in the ALL direction: n = 2^22 directed rows, about 1.03M
// keys): src, dst and mask read once (9 B a row), keys written (4 B a key),
// nbrs and valid written (5 B a slot, at most 2 slots a row): at most about
// 80 MB, 24 us at 3.35 TB/s.  The design moves more: the sorted keys (4 B a
// row, read twice, plus the galloping searches, cached), the sort's int64
// permutation (8 B a row) and dst gathered through it at random.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;
constexpr int kTile = kThreads * kRounds;  // ops/neighborhoods.py _TILE
constexpr int kMaxBuckets = 32;
constexpr unsigned kFull = 0xffffffffu;

// ceil(log2(deg)) for deg >= 1: the bucket of a key of that degree
__device__ __forceinline__ int ceil_log2(int deg) { return deg <= 1 ? 0 : 32 - __clz(deg - 1); }

// First position of `key` in sorted keys[0..p] (keys[p] == key): gallop
// back by doubling steps, then bisect.
__device__ __forceinline__ int segment_start(const int* __restrict__ keys, int p, int key) {
  if (p == 0 || __ldg(keys + p - 1) != key) return p;
  int hi = p - 1;  // keys[hi] == key
  int lo = -1;     // keys[lo] != key, or before the array
  for (int step = 1;; step <<= 1) {
    const int q = hi - step;
    if (q < 0) break;
    if (__ldg(keys + q) != key) {
      lo = q;
      break;
    }
    hi = q;
  }
  while (hi - lo > 1) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(keys + mid) == key) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return hi;
}

// tile_hist: int32[nb][tiles]; info: int2[n], (degree, rank in the end's
// tile, or -1 for a class with no bucket) at each valid segment's head.
__global__ void __launch_bounds__(kThreads)
nb_count_kernel(const int* __restrict__ keys, int n, int nb, int tiles, int* __restrict__ tile_hist,
                int2* __restrict__ info) {
  __shared__ int s_warp[kWarps][kMaxBuckets];
  __shared__ int s_run[kMaxBuckets];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kWarps * kMaxBuckets; i += kThreads) (&s_warp[0][0])[i] = 0;
  if (tid < kMaxBuckets) s_run[tid] = 0;
  __syncthreads();
  const int tile = blockIdx.x;
  for (int round = 0; round < kRounds; ++round) {
    const int p = tile * kTile + round * kThreads + tid;
    int b = -1;
    int start = 0;
    int deg = 0;
    if (p < n) {
      const int key = __ldg(keys + p);
      if (!(key & 1) && (p + 1 == n || __ldg(keys + p + 1) != key)) {
        start = segment_start(keys, p, key);
        deg = p - start + 1;
        b = ceil_log2(deg);
        if (b >= nb) {
          info[start] = make_int2(deg, -1);
          b = -1;
        }
      }
    }
    const unsigned peers = __match_any_sync(kFull, b < 0 ? kMaxBuckets : b);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (b >= 0 && lane == __ffs(peers) - 1) s_warp[warp][b] = __popc(peers);
    __syncthreads();
    if (b >= 0) {
      int off = s_run[b] + rank;
      for (int w = 0; w < warp; ++w) off += s_warp[w][b];
      info[start] = make_int2(deg, off);
    }
    __syncthreads();
    if (tid < nb) {
      int sum = 0;
      for (int w = 0; w < kWarps; ++w) {
        sum += s_warp[w][tid];
        s_warp[w][tid] = 0;
      }
      s_run[tid] += sum;
    }
    __syncthreads();
  }
  if (tid < nb) tile_hist[tid * tiles + tile] = s_run[tid];
}

// One block of 32 warps: warp b scans tile_hist[b][*] (exclusive, in place)
// and writes totals[b]; then offsets[b] = first key of bucket b and
// offsets[nb + b] = its first slot.
__global__ void __launch_bounds__(1024)
nb_scan_kernel(int* __restrict__ tile_hist, int nb, int tiles, long long* __restrict__ offsets,
               int* __restrict__ totals) {
  __shared__ int s_tot[kMaxBuckets];
  const int lane = threadIdx.x & 31;
  const int b = threadIdx.x >> 5;
  if (b < nb) {
    int* row = tile_hist + static_cast<long long>(b) * tiles;
    int run = 0;
    for (int t0 = 0; t0 < tiles; t0 += 32) {
      const int t = t0 + lane;
      const int v = t < tiles ? row[t] : 0;
      int x = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, x, d);
        if (lane >= d) x += up;
      }
      if (t < tiles) row[t] = run + x - v;
      run += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) s_tot[b] = run;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long k0 = 0;
    long long s0 = 0;
    for (int i = 0; i < nb; ++i) {
      offsets[i] = k0;
      offsets[nb + i] = s0;
      totals[i] = s_tot[i];
      k0 += s_tot[i];
      s0 += static_cast<long long>(s_tot[i]) << i;
    }
  }
}

// Where sorted row p lands: false for a masked row or a key with no bucket;
// else its slot, the key's degree, D_b, its column and its bucket's key row.
struct Place {
  long long slot, key_slot;
  int deg, d_b, col;
};

__device__ __forceinline__ bool place_row(const int* __restrict__ keys, int p, int n, int nb, int tiles,
                                          const int* __restrict__ tile_base, const int2* __restrict__ info,
                                          const long long* __restrict__ offsets, Place* out) {
  const int key = __ldg(keys + p);
  if (key & 1) return false;
  const int start = segment_start(keys, p, key);
  const int2 in = info[start];
  if (in.y < 0) return false;
  const int b = ceil_log2(in.x);
  const int end_tile = (start + in.x - 1) / kTile;
  const long long row = __ldg(tile_base + b * tiles + end_tile) + in.y;
  out->deg = in.x;
  out->d_b = 1 << b;
  out->col = p - start;
  out->slot = __ldg(offsets + nb + b) + (row << b) + out->col;
  out->key_slot = __ldg(offsets + b) + row;
  return true;
}

__global__ void __launch_bounds__(kThreads)
nb_scatter_kernel(const int* __restrict__ keys, const long long* __restrict__ order, int n, int nb, int tiles,
                  const int* __restrict__ tile_base, const int2* __restrict__ info,
                  const long long* __restrict__ offsets, const int* __restrict__ src,
                  const int* __restrict__ dst, int* __restrict__ keys_out, int* __restrict__ nbrs_out,
                  uint8_t* __restrict__ valid_out) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n; p += gridDim.x * kThreads) {
    Place at;
    if (!place_row(keys, p, n, nb, tiles, tile_base, info, offsets, &at)) continue;
    const long long r = __ldg(order + p);
    nbrs_out[at.slot] = __ldg(dst + r);
    valid_out[at.slot] = 1;
    if (at.col + at.deg < at.d_b) {
      nbrs_out[at.slot + at.deg] = 0;
      valid_out[at.slot + at.deg] = 0;
    }
    if (at.col == 0) {
      const int s = __ldg(src + r);
      keys_out[at.key_slot] = s > 0 ? s : 0;
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

// One value leaf of elem bytes a row (a leaf of 4 or 8 bytes a row is
// copied as one word; the allocations are aligned to 256 bytes).
__global__ void __launch_bounds__(kThreads)
nb_scatter_values_kernel(const int* __restrict__ keys, const long long* __restrict__ order, int n, int nb,
                         int tiles, const int* __restrict__ tile_base, const int2* __restrict__ info,
                         const long long* __restrict__ offsets, const char* __restrict__ leaf,
                         char* __restrict__ leaf_out, int elem) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < n; p += gridDim.x * kThreads) {
    Place at;
    if (!place_row(keys, p, n, nb, tiles, tile_base, info, offsets, &at)) continue;
    const long long r = __ldg(order + p);
    copy_bytes(leaf_out + at.slot * elem, leaf + r * elem, elem);
    if (at.col + at.deg < at.d_b) zero_bytes(leaf_out + (at.slot + at.deg) * elem, elem);
  }
}

int scatter_blocks(int n) {
  const int blocks = (n + kThreads - 1) / kThreads;
  return blocks < 132 * 16 ? blocks : 132 * 16;
}

}  // namespace

extern "C" {

// keys: int32[n] sorted grouping keys; nb <= 32 buckets; tile_hist:
// int32[nb * ceil(n / 1024)]; info: int32[2n]; offsets: int64[2nb]; totals:
// int32[nb].  The count pass, then the scan across tiles.
int nb_count_launch(const void* keys, int n, int nb, void* tile_hist, void* info, void* offsets, void* totals,
                    void* stream) {
  if (n <= 0 || nb <= 0 || nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  nb_count_kernel<<<tiles, kThreads, 0, s>>>(static_cast<const int*>(keys), n, nb, tiles,
                                              static_cast<int*>(tile_hist), static_cast<int2*>(info));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nb_scan_kernel<<<1, 1024, 0, s>>>(static_cast<int*>(tile_hist), nb, tiles, static_cast<long long*>(offsets),
                                    static_cast<int*>(totals));
  return static_cast<int>(cudaGetLastError());
}

// keys, order (int64), n, nb, tile_hist, info, offsets as left by
// nb_count_launch; src, dst: int32[n]; keys_out: int32[total keys];
// nbrs_out: int32[total slots]; valid_out: bool[total slots].
int nb_scatter_launch(const void* keys, const void* order, int n, int nb, const void* tile_hist,
                      const void* info, const void* offsets, const void* src, const void* dst, void* keys_out,
                      void* nbrs_out, void* valid_out, void* stream) {
  if (n <= 0 || nb <= 0 || nb > kMaxBuckets) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  nb_scatter_kernel<<<scatter_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const long long*>(order), n, nb, tiles,
      static_cast<const int*>(tile_hist), static_cast<const int2*>(info), static_cast<const long long*>(offsets),
      static_cast<const int*>(src), static_cast<const int*>(dst), static_cast<int*>(keys_out),
      static_cast<int*>(nbrs_out), static_cast<uint8_t*>(valid_out));
  return static_cast<int>(cudaGetLastError());
}

// The same placement for one value leaf: leaf holds n rows of elem bytes,
// leaf_out total-slots rows.
int nb_scatter_values_launch(const void* keys, const void* order, int n, int nb, const void* tile_hist,
                             const void* info, const void* offsets, const void* leaf, void* leaf_out, int elem,
                             void* stream) {
  if (n <= 0 || nb <= 0 || nb > kMaxBuckets || elem <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + kTile - 1) / kTile;
  nb_scatter_values_kernel<<<scatter_blocks(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(keys), static_cast<const long long*>(order), n, nb, tiles,
      static_cast<const int*>(tile_hist), static_cast<const int2*>(info), static_cast<const long long*>(offsets),
      static_cast<const char*>(leaf), static_cast<char*>(leaf_out), elem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
