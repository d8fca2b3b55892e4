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
// Given the step keys, each lane evolves on its own, and only its last
// replacement in the batch matters: the edge, third vertex and flags it
// leaves are those of its last coin that fell, and the flags then gather the
// closing edges from that step on.  So the call is six kernels:
//  1. key_chain_kernel, one thread: the B dependent hashes of the key chain
//     (the key before each step), the valid-edge counts i, the new key and
//     edges_seen.  Serial by nature: ~B x 0.1-0.2 us.
//  2. step_keys_kernel, a thread a step: the coin key, randint's two keys
//     and the f32 threshold 1 / max(i, 1) (IEEE division; this file must not
//     be built with --use_fast_math).
//  3. coin_kernel, a thread a (lane, tile of 256 steps): the tile's last
//     step whose coin fell, walking back from its end (the tile's keys and
//     thresholds staged in shared memory).  S x B hashes: the bulk of the
//     work, spread over the card.
//  4. finish_kernel, a thread a lane: its last replacement over the tiles;
//     there, the new edge, the randint third vertex and cleared flags.
//  5. hits_kernel, a thread a (lane, tile): the closing edges from that step
//     on (the tile's edges staged in shared memory).
//  6. seen_kernel, a thread an edge: the endpoints' presence.
// What bounds it: the key chain's serial hashes, then the coins' S x B
// hashes (~80 integer operations each); the bytes are small (the batch and
// the lanes' state).
//
// Ids: the sampled edge and the closing tests use the raw ids; `seen`
// follows JAX's scatter rule (a negative id counts from the end once, an id
// still outside [0, C) is dropped).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 256;   // steps a coin / hits block walks
constexpr int LANES = 128;  // lanes a coin / hits block holds

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

__global__ void key_chain_kernel(unsigned* key, int* edges_seen, const bool* __restrict__ mask, int n,
                                 uint2* __restrict__ keys, int* __restrict__ counts) {
    uint2 k = make_uint2(key[0], key[1]);
    unsigned count = (unsigned)edges_seen[0];
    for (int b = 0; b < n; ++b) {
        keys[b] = k;
        count += (mask == nullptr || mask[b]) ? 1u : 0u;
        counts[b] = (int)count;
        k = threefry(k, 0u, 0u);
    }
    key[0] = k.x;
    key[1] = k.y;
    edges_seen[0] = (int)count;
}

__global__ void step_keys_kernel(const uint2* __restrict__ keys, const int* __restrict__ counts, int n,
                                 uint2* __restrict__ coin_keys, uint2* __restrict__ rand_keys,
                                 float* __restrict__ thresholds) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= n) return;
    const uint2 k = keys[b];
    coin_keys[b] = threefry(k, 0u, 1u);
    const uint2 third = threefry(k, 0u, 2u);
    rand_keys[2 * b] = threefry(third, 0u, 0u);      // randint's higher bits
    rand_keys[2 * b + 1] = threefry(third, 0u, 1u);  // and its lower bits
    const int i = counts[b];
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
    long long keys, counts, coin_keys, rand_keys, thresholds, last, start, bytes;
    int tiles;
};

inline long long align(long long x) { return (x + 255) & ~255ll; }

Layout layout(int n, int s_lanes) {
    Layout l{};
    l.tiles = (n + TILE - 1) / TILE;
    long long o = 0;
    l.keys = o;
    o = align(o + 8ll * n);
    l.counts = o;
    o = align(o + 4ll * n);
    l.coin_keys = o;
    o = align(o + 8ll * n);
    l.rand_keys = o;
    o = align(o + 16ll * n);
    l.thresholds = o;
    o = align(o + 4ll * n);
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
// int32[n], mask bool[n] or null, n, scratch of sampler_scratch_bytes,
// stream: the key chain, step keys, coin, finish, hits and seen kernels
int sampler_scan_launch(unsigned* key, int* edge, int* third, bool* closed_a, bool* closed_b, int* edges_seen,
                        bool* seen, int s_lanes, int capacity, const int* src, const int* dst, const bool* mask,
                        int n, void* scratch, long long scratch_bytes, cudaStream_t stream) {
    if (s_lanes < 1 || capacity < 1 || n < 0) return (int)cudaErrorInvalidValue;
    const Layout l = layout(n, s_lanes);
    if (scratch_bytes < l.bytes || l.tiles > 65535) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    char* base = static_cast<char*>(scratch);
    uint2* keys = reinterpret_cast<uint2*>(base + l.keys);
    int* counts = reinterpret_cast<int*>(base + l.counts);
    uint2* coin_keys = reinterpret_cast<uint2*>(base + l.coin_keys);
    uint2* rand_keys = reinterpret_cast<uint2*>(base + l.rand_keys);
    float* thresholds = reinterpret_cast<float*>(base + l.thresholds);
    int* last = reinterpret_cast<int*>(base + l.last);
    int* start = reinterpret_cast<int*>(base + l.start);
    key_chain_kernel<<<1, 1, 0, stream>>>(key, edges_seen, mask, n, keys, counts);
    step_keys_kernel<<<(n + 255) / 256, 256, 0, stream>>>(keys, counts, n, coin_keys, rand_keys, thresholds);
    const dim3 grid((s_lanes + LANES - 1) / LANES, l.tiles);
    coin_kernel<<<grid, LANES, 0, stream>>>(coin_keys, thresholds, mask, n, s_lanes, last);
    finish_kernel<<<(s_lanes + 127) / 128, 128, 0, stream>>>(last, l.tiles, s_lanes, rand_keys, src, dst, capacity,
                                                              edge, third, closed_a, closed_b, start);
    hits_kernel<<<grid, LANES, 0, stream>>>(src, dst, mask, n, s_lanes, edge, third, start, closed_a, closed_b);
    seen_kernel<<<(n + 255) / 256, 256, 0, stream>>>(src, dst, mask, n, capacity, seen);
    return (int)cudaGetLastError();
}

}  // extern "C"
