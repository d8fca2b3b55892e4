// The reservoir triangle samplers' batch scan on Hopper (sm_90a), behind a
// plain C interface.
//
// Replaces the `lax.scan` of `sampler_update` (gelly_streaming_tpu/library/
// sampled_triangles.py:56-98; reference example/BroadcastTriangleCount.java:
// 200-207): at every step the key is split in three (next key, coin key,
// third-vertex key); each of S lanes replaces its sampled edge with the
// step's edge when its `uniform` coin falls below 1 / i (i the valid edges so
// far), then draws a `randint` third vertex in [0, C) and clears its closing
// flags; a valid edge closes a lane's side a (b) when it joins the sampled
// edge's first (second) endpoint with the third vertex.  The draws are
// threefry2x32 as `jax.random` computes it (JAX 0.9, partitionable), so the
// bits are the JAX package's.
//
// Key t of a stream depends on the seed and t alone (the key is split at
// every step, masked rows included), so the chain of B dependent hashes is
// computed on a host core ahead of the batch (csrc/threefry_chain.c) and
// comes in as the call's `keys`: the key before each step, then the key
// after the batch.  Given the step keys, each lane evolves on its own, and
// only its last replacement in the batch matters: the edge, third vertex
// and flags it leaves are those of its last coin that fell, and the flags
// then gather the closing edges from that step on.  So the call is seven
// kernels:
//  1. step_keys_kernel, a thread a step: the coin key and randint's two
//     keys, and each tile of 256 steps' valid rows.
//  2. tile_scan_kernel, one block: the valid rows before each tile (a block
//     scan of the tiles' counts), the state's new edges_seen and key.
//  3. thresholds_kernel, a thread a step: i, the valid edges so far (a
//     ballot scan within the tile), and the f32 threshold 1 / max(i, 1)
//     (IEEE division; this file must not be built with --use_fast_math).
//  4. coin_kernel, a thread a (lane, tile of 256 steps): the tile's last
//     step whose coin fell, walking back from its end (the tile's keys and
//     thresholds staged in shared memory).  S x B hashes: the bulk of the
//     work, spread over the card.
//  5. finish_kernel, a thread a lane: its last replacement over the tiles;
//     there, the new edge, the randint third vertex and cleared flags.
//  6. hits_kernel, a thread a (lane, tile): the closing edges from that step
//     on (the tile's edges staged in shared memory).
//  7. seen_kernel, a thread an edge: the endpoints' presence.
// What bounds it: the coins' S x B hashes (~80 integer operations each);
// the bytes are small (the batch, its keys and the lanes' state).
//
// Ids: the sampled edge and the closing tests use the raw ids; `seen`
// follows JAX's scatter rule (a negative id counts from the end once, an id
// still outside [0, C) is dropped).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;   // steps a coin / hits block walks
constexpr int LANES = 128;  // lanes a coin / hits block holds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint2 threefry(uint2 key, unsigned x0, unsigned x1) {
    const unsigned k0 = key.x, k1 = key.y, k2 = key.x ^ key.y ^ 0x1BD11BDAu;
    x0 += k0;
    x1 += k1;
#define TF_ROUND(r)                          \
    x0 += x1;                                \
    x1 = __funnelshift_l(x1, x1, r) ^ x0;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k1;
    x1 += k2 + 1u;
    TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    x0 += k2;
    x1 += k0 + 2u;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k0;
    x1 += k1 + 3u;
    TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
    x0 += k1;
    x1 += k2 + 4u;
    TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
    x0 += k2;
    x1 += k0 + 5u;
#undef TF_ROUND
    return make_uint2(x0, x1);
}

// lane `lane` of jax.random's 32-bit random_bits under `key`
__device__ __forceinline__ unsigned lane_bits(uint2 key, unsigned lane) {
    const uint2 h = threefry(key, 0u, lane);
    return h.x ^ h.y;
}

__device__ __forceinline__ float bits_to_uniform(unsigned bits) {
    return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

constexpr int SCAN_THREADS = 1024;

// a thread a step, a block a tile of TILE steps: the coin key and randint's
// two keys of the step, and the tile's valid rows
__global__ void __launch_bounds__(TILE)
step_keys_kernel(const uint2* __restrict__ keys, const bool* __restrict__ mask, int n, uint2* __restrict__ coin_keys,
                 uint2* __restrict__ rand_keys, unsigned* __restrict__ tile_counts) {
    const int b = blockIdx.x * TILE + threadIdx.x;
    const bool ok = b < n && (mask == nullptr || mask[b]);
    const int count = __syncthreads_count(ok);
    if (threadIdx.x == 0) tile_counts[blockIdx.x] = (unsigned)count;
    if (b >= n) return;
    const uint2 k = keys[b];
    coin_keys[b] = threefry(k, 0u, 1u);
    const uint2 third = threefry(k, 0u, 2u);
    rand_keys[2 * b] = threefry(third, 0u, 0u);      // randint's higher bits
    rand_keys[2 * b + 1] = threefry(third, 0u, 1u);  // and its lower bits
}

// one block: each tile's valid rows before it (edges_seen included), the
// state's new edges_seen (wrapping as int32) and its new key
__global__ void __launch_bounds__(SCAN_THREADS)
tile_scan_kernel(unsigned* __restrict__ tile_counts, int tiles, int n, const uint2* __restrict__ keys, unsigned* key,
                 int* edges_seen) {
    __shared__ unsigned warp_sums[SCAN_THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int per = (tiles + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = min(tiles, tid * per), hi = min(tiles, lo + per);
    unsigned mine = 0;
    for (int t = lo; t < hi; ++t) mine += tile_counts[t];
    unsigned incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += x;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const unsigned w = warp_sums[lane];
        unsigned wi = w;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned x = __shfl_up_sync(FULL, wi, o);
            if (lane >= o) wi += x;
        }
        warp_sums[lane] = wi - w;
    }
    __syncthreads();
    unsigned base = (unsigned)edges_seen[0] + warp_sums[warp] + incl - mine;
    for (int t = lo; t < hi; ++t) {
        const unsigned c = tile_counts[t];
        tile_counts[t] = base;  // now the tile's valid rows before it
        base += c;
    }
    __syncthreads();  // every thread has read edges_seen
    if (tid == SCAN_THREADS - 1) {
        edges_seen[0] = (int)base;  // the last segment ends at the last tile (empty segments too)
        const uint2 k = keys[n];
        key[0] = k.x;
        key[1] = k.y;
    }
}

// a thread a step, a block a tile: i, the valid rows so far, and the f32
// threshold 1 / max(i, 1) (IEEE division; this file must not be built with
// --use_fast_math)
__global__ void __launch_bounds__(TILE)
thresholds_kernel(const bool* __restrict__ mask, int n, const unsigned* __restrict__ tile_base,
                  float* __restrict__ thresholds) {
    __shared__ unsigned warp_sums[TILE / 32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int b = blockIdx.x * TILE + threadIdx.x;
    const unsigned ok = b < n && (mask == nullptr || mask[b]) ? 1u : 0u;
    const unsigned bal = __ballot_sync(FULL, ok);
    if (lane == 0) warp_sums[warp] = __popc(bal);
    __syncthreads();
    unsigned count = tile_base[blockIdx.x] + __popc(bal & (0xffffffffu >> (31 - lane)));
    for (int w = 0; w < warp; ++w) count += warp_sums[w];
    if (b >= n) return;
    const int i = (int)count;
    thresholds[b] = __fdiv_rn(1.0f, __int2float_rn(i > 1 ? i : 1));
}

__global__ void __launch_bounds__(LANES) coin_kernel(const uint2* __restrict__ coin_keys,
                                                     const float* __restrict__ thresholds,
                                                     const bool* __restrict__ mask, int n, int s_lanes,
                                                     int* __restrict__ last) {
    __shared__ uint2 s_keys[TILE];
    __shared__ float s_thr[TILE];
    __shared__ bool s_ok[TILE];
    const int lo = blockIdx.y * TILE;
    const int hi = min(n, lo + TILE);
    for (int j = threadIdx.x; j < hi - lo; j += blockDim.x) {
        s_keys[j] = coin_keys[lo + j];
        s_thr[j] = thresholds[lo + j];
        s_ok[j] = mask == nullptr || mask[lo + j];
    }
    __syncthreads();
    const int s = blockIdx.x * LANES + threadIdx.x;
    if (s >= s_lanes) return;
    int found = -1;
    for (int j = hi - lo - 1; j >= 0; --j) {
        if (!s_ok[j]) continue;
        if (bits_to_uniform(lane_bits(s_keys[j], (unsigned)s)) < s_thr[j]) {
            found = lo + j;
            break;
        }
    }
    last[(long long)blockIdx.y * s_lanes + s] = found;
}

__global__ void finish_kernel(const int* __restrict__ last, int tiles, int s_lanes, const uint2* __restrict__ rand_keys,
                              const int* __restrict__ src, const int* __restrict__ dst, int capacity, int* edge,
                              int* third, bool* closed_a, bool* closed_b, int* __restrict__ start) {
    const int s = blockIdx.x * blockDim.x + threadIdx.x;
    if (s >= s_lanes) return;
    int r = -1;
    for (int t = tiles - 1; t >= 0 && r < 0; --t) r = last[(long long)t * s_lanes + s];
    if (r < 0) {
        start[s] = 0;
        return;
    }
    start[s] = r;
    // jax.random.randint(key, (S,), 0, C): two draws reduced by its span arithmetic (uint32, wrapping)
    const unsigned span = (unsigned)capacity;
    const unsigned higher = lane_bits(rand_keys[2 * r], (unsigned)s);
    const unsigned lower = lane_bits(rand_keys[2 * r + 1], (unsigned)s);
    unsigned mult = 65536u % span;
    mult = (mult * mult) % span;
    const unsigned off = ((higher % span) * mult + lower % span) % span;
    edge[2 * s] = src[r];
    edge[2 * s + 1] = dst[r];
    third[s] = (int)off;
    closed_a[s] = false;
    closed_b[s] = false;
}

__global__ void __launch_bounds__(LANES) hits_kernel(const int* __restrict__ src, const int* __restrict__ dst,
                                                     const bool* __restrict__ mask, int n, int s_lanes,
                                                     const int* __restrict__ edge, const int* __restrict__ third,
                                                     const int* __restrict__ start, bool* closed_a,
                                                     bool* closed_b) {
    __shared__ int s_u[TILE];
    __shared__ int s_v[TILE];
    __shared__ bool s_ok[TILE];
    const int lo = blockIdx.y * TILE;
    const int hi = min(n, lo + TILE);
    for (int j = threadIdx.x; j < hi - lo; j += blockDim.x) {
        s_u[j] = src[lo + j];
        s_v[j] = dst[lo + j];
        s_ok[j] = mask == nullptr || mask[lo + j];
    }
    __syncthreads();
    const int s = blockIdx.x * LANES + threadIdx.x;
    if (s >= s_lanes) return;
    const int from = start[s];
    if (from >= hi) return;
    const int eu = edge[2 * s], ev = edge[2 * s + 1], th = third[s];
    bool ha = false, hb = false;
    for (int j = max(from - lo, 0); j < hi - lo; ++j) {
        if (!s_ok[j]) continue;
        const int u = s_u[j], v = s_v[j];
        ha |= (eu == u && th == v) || (eu == v && th == u);
        hb |= (ev == u && th == v) || (ev == v && th == u);
    }
    if (ha) closed_a[s] = true;
    if (hb) closed_b[s] = true;
}

__global__ void seen_kernel(const int* __restrict__ src, const int* __restrict__ dst, const bool* __restrict__ mask,
                            int n, int capacity, bool* seen) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n || (mask != nullptr && !mask[b])) return;
    int ends[2] = {src[b], dst[b]};
    for (int x : ends) {
        if (x < 0) x += capacity;
        if (x >= 0 && x < capacity) seen[x] = true;
    }
}

struct Layout {
    long long coin_keys, rand_keys, thresholds, tile_counts, last, start, bytes;
    int tiles;
};

inline long long align(long long x) { return (x + 255) & ~255ll; }

Layout layout(int n, int s_lanes) {
    Layout l{};
    l.tiles = (n + TILE - 1) / TILE;
    long long o = 0;
    l.coin_keys = o;
    o = align(o + 8ll * n);
    l.rand_keys = o;
    o = align(o + 16ll * n);
    l.thresholds = o;
    o = align(o + 4ll * n);
    l.tile_counts = o;
    o = align(o + 4ll * l.tiles);
    l.last = o;
    o = align(o + 4ll * l.tiles * s_lanes);
    l.start = o;
    o = align(o + 4ll * s_lanes);
    l.bytes = o;
    return l;
}

}  // namespace

extern "C" {

// n, S: the scratch bytes of one call
long long sampler_scratch_bytes(int n, int s_lanes) {
    if (n < 0 || s_lanes < 1) return -1;
    return layout(n, s_lanes).bytes;
}

// key uint32[2], edge int32[S, 2], third int32[S], closed_a, closed_b bool[S],
// edges_seen int32[1], seen bool[C] (all updated in place), S, C, src, dst
// int32[n], mask bool[n] or null, n, keys uint32[n + 1, 2] (the key before
// each step, then after the batch: csrc/threefry_chain.c's), scratch of
// sampler_scratch_bytes, stream: the step keys, tile scan, thresholds,
// coin, finish, hits and seen kernels
int sampler_scan_launch(unsigned* key, int* edge, int* third, bool* closed_a, bool* closed_b, int* edges_seen,
                        bool* seen, int s_lanes, int capacity, const int* src, const int* dst, const bool* mask,
                        int n, const unsigned* keys, void* scratch, long long scratch_bytes, cudaStream_t stream) {
    if (s_lanes < 1 || capacity < 1 || n < 0) return (int)cudaErrorInvalidValue;
    const Layout l = layout(n, s_lanes);
    if (scratch_bytes < l.bytes || l.tiles > 65535) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    char* base = static_cast<char*>(scratch);
    const uint2* step = reinterpret_cast<const uint2*>(keys);
    uint2* coin_keys = reinterpret_cast<uint2*>(base + l.coin_keys);
    uint2* rand_keys = reinterpret_cast<uint2*>(base + l.rand_keys);
    float* thresholds = reinterpret_cast<float*>(base + l.thresholds);
    unsigned* tile_counts = reinterpret_cast<unsigned*>(base + l.tile_counts);
    int* last = reinterpret_cast<int*>(base + l.last);
    int* start = reinterpret_cast<int*>(base + l.start);
    step_keys_kernel<<<l.tiles, TILE, 0, stream>>>(step, mask, n, coin_keys, rand_keys, tile_counts);
    tile_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(tile_counts, l.tiles, n, step, key, edges_seen);
    thresholds_kernel<<<l.tiles, TILE, 0, stream>>>(mask, n, tile_counts, thresholds);
    const dim3 grid((s_lanes + LANES - 1) / LANES, l.tiles);
    coin_kernel<<<grid, LANES, 0, stream>>>(coin_keys, thresholds, mask, n, s_lanes, last);
    finish_kernel<<<(s_lanes + 127) / 128, 128, 0, stream>>>(last, l.tiles, s_lanes, rand_keys, src, dst, capacity,
                                                              edge, third, closed_a, closed_b, start);
    hits_kernel<<<grid, LANES, 0, stream>>>(src, dst, mask, n, s_lanes, edge, third, start, closed_a, closed_b);
    seen_kernel<<<(n + 255) / 256, 256, 0, stream>>>(src, dst, mask, n, capacity, seen);
    return (int)cudaGetLastError();
}

}  // extern "C"
