// The spanner's batch admission on Hopper (sm_90a), behind a plain C interface.
//
// Replaces the JAX package's `_admit_batch` (gelly_streaming_tpu/library/
// spanner.py:90-144): the `lax.map` pre-filter `_within_k_prefilter`
// (:63-87) and the `while_loop` that resolves the surviving candidates one
// after another with an exact distance test (summaries/adjacency.py:
// `within_two`, `within_k_balls` or `bounded_bfs`) and `add_undirected_edge`.
//
// One C call a batch, two kernels:
//  * prefilter_kernel, a warp an edge (grid-stride): the ball of radius
//    ceil(k/2) around u and the one of radius k - ceil(k/2) around v, built
//    in shared memory round by round as `expand_balls` builds them (each
//    round appends the row of every entry, an entry below 0 giving -1s, one
//    at or past C row C - 1, then keeps the first `cap`), then whether an
//    id >= 0 lies in both.  The candidates are exactly the JAX package's.
//  * resolve_kernel, one block of 1024 threads: the batch's candidate flags
//    compacted a chunk of 1024 edges at a time (a ballot scan, arrival order
//    kept), then each candidate in order: the exact test over the block
//    (`within_two` as a D x D row comparison; `balls` as both full balls in
//    scratch and a block-wide membership test; `bfs` as k frontier sweeps of
//    the [C, D] table over bitmaps, a warp a frontier word), the insert by
//    one thread under `add_undirected_edge`'s rules, and a block barrier.
//
// What bounds it: the pre-filter reads two capped balls an edge (at k = 2,
// cap 128, D = 64: 65 + 65 row entries an edge, ~0.5 KB; the batch's
// 2^14 edges ~8.6 MB, held in the L2 with the 128 KB table); the
// resolution is a serial chain, one candidate after another, each a few
// block barriers (~1 us) plus its test's reads.  The design keeps the chain
// in one block on one SM (its barriers are the cheapest sync there is) and
// gives every other edge to the parallel pre-filter, which the JAX
// package's own docstring reports kills most of a warm stream.
//
// Ids: the pre-filter uses the raw ids; the resolution clamps them below at
// 0 (`jnp.maximum`), gathers clamp to C - 1 and scatters past C drop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RESOLVE_THREADS = 1024;   // == the compaction chunk
constexpr int PRE_WARPS_MAX = 8;        // warps a pre-filter block
constexpr int PRE_BLOCKS_MAX = 2048;
constexpr int PRE_GLOBAL_WARPS = 528;   // warps when the balls live in global scratch
constexpr long long SMEM_LIMIT = 200 * 1024;
constexpr long long BALL_LIMIT = 1ll << 28;  // entries a full ball may hold

enum Body { WITHIN_TWO = 0, BALLS = 1, BFS = 2 };

__host__ __device__ inline long long ball_size(int radius, long long cap, int d) {
    long long n = 1;
    for (int t = 0; t < radius; ++t) {
        long long m = n * (long long)(d + 1);
        n = m < cap ? m : cap;
    }
    return n;
}

// sum_{i <= radius} D^i, the JAX package's "exact" cap, saturated
inline long long full_cap(int radius, int d) {
    long long s = 0, p = 1;
    for (int i = 0; i <= radius; ++i) {
        s += p;
        if (s > BALL_LIMIT) return BALL_LIMIT + 1;
        p *= d;
        if (p > BALL_LIMIT) p = BALL_LIMIT + 1;
    }
    return s;
}

// expand the ball of `start` in place: ball[0] = start, then `radius`
// rounds of appending rows and truncating to `cap`; `sync` orders the
// group's rounds.  Returns the ball's size.
template <class Sync>
__device__ long long expand_ball(int* ball, int start, int radius, long long cap, const int* nbrs, int c, int d,
                                 int tid, int nthreads, Sync sync) {
    if (tid == 0) ball[0] = start;
    sync();
    long long n = 1;
    for (int t = 0; t < radius; ++t) {
        long long m = n * (long long)(d + 1);
        if (m > cap) m = cap;
        for (long long p = n + tid; p < m; p += nthreads) {
            long long q = p - n;
            int x = ball[q / d];
            ball[p] = x >= 0 ? nbrs[(long long)min(x, c - 1) * d + (int)(q % d)] : -1;
        }
        n = m;
        sync();
    }
    return n;
}

__global__ void prefilter_kernel(const int* __restrict__ nbrs, int c, int d, const int* __restrict__ src,
                                 const int* __restrict__ dst, const bool* __restrict__ mask, int n, int k, int cap,
                                 int nu, int nv, int* balls_global, int* __restrict__ cand) {
    extern __shared__ int smem[];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5, wpb = blockDim.x >> 5;
    const long long gw = (long long)blockIdx.x * wpb + wib, nw = (long long)gridDim.x * wpb;
    int* bu = balls_global ? balls_global + gw * (nu + nv) : smem + (long long)wib * (nu + nv);
    int* bv = bu + nu;
    const int a = (k + 1) / 2;
    auto sync = [] { __syncwarp(); };
    for (long long e = gw; e < n; e += nw) {
        if (mask && !mask[e]) {
            if (lane == 0) cand[e] = 0;
            continue;
        }
        long long su = expand_ball(bu, src[e], a, cap, nbrs, c, d, lane, 32, sync);
        long long sv = expand_ball(bv, dst[e], k - a, cap, nbrs, c, d, lane, 32, sync);
        bool hit = false;
        for (long long i0 = 0; i0 < su; i0 += 32) {
            long long i = i0 + lane;
            if (i < su) {
                int x = bu[i];
                if (x >= 0)
                    for (long long j = 0; j < sv; ++j)
                        if (bv[j] == x) {
                            hit = true;
                            break;
                        }
            }
            if (__any_sync(FULL, hit)) {
                hit = true;
                break;
            }
        }
        if (lane == 0) cand[e] = hit ? 0 : 1;
        __syncwarp();  // the next edge overwrites the balls
    }
}

__device__ inline bool bit(const unsigned* b, int i) { return (b[i >> 5] >> (i & 31)) & 1u; }

__global__ void __launch_bounds__(RESOLVE_THREADS)
resolve_kernel(int* nbrs, int* deg, int c, int d, const int* __restrict__ src, const int* __restrict__ dst,
               const int* __restrict__ cand, int n, int k, int body, long long cap_u, long long cap_v, int* ball_u,
               unsigned* bits_global, int words, int* stats) {
    extern __shared__ unsigned smem_bits[];
    __shared__ int list[RESOLVE_THREADS];
    __shared__ int offsets[RESOLVE_THREADS / 32];
    __shared__ int s_count;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int a = (k + 1) / 2;
    unsigned* reach = bits_global ? bits_global : smem_bits;
    unsigned* front = reach + words;
    unsigned* next = front + words;
    int* ball_v = ball_u + cap_u;
    auto sync = [] { __syncthreads(); };
    int total = 0, admitted = 0;
    for (int base = 0; base < n; base += RESOLVE_THREADS) {
        const int e = base + tid;
        const int flag = e < n ? cand[e] : 0;
        const unsigned bal = __ballot_sync(FULL, flag);
        if (lane == 0) offsets[warp] = __popc(bal);
        __syncthreads();
        if (tid == 0) {
            int s = 0;
            for (int w = 0; w < RESOLVE_THREADS / 32; ++w) {
                int t = offsets[w];
                offsets[w] = s;
                s += t;
            }
            s_count = s;
        }
        __syncthreads();
        if (flag) list[offsets[warp] + __popc(bal & ((1u << lane) - 1u))] = e;
        __syncthreads();
        const int m = s_count;
        total += m;
        for (int i = 0; i < m; ++i) {
            const int ed = list[i];
            const int u = max(src[ed], 0), v = max(dst[ed], 0);
            const int gu = min(u, c - 1), gv = min(v, c - 1);
            const int* ru = nbrs + (long long)gu * d;
            const int* rv = nbrs + (long long)gv * d;
            int within = 0;
            if (body == WITHIN_TWO) {
                if (u == v) within = 1;
                for (int s = tid; s < d && !within; s += RESOLVE_THREADS)
                    if (ru[s] == v) within = 1;
                for (long long p = tid; p < (long long)d * d && !within; p += RESOLVE_THREADS) {
                    int x = ru[p / d];
                    if (x >= 0 && x == rv[p % d]) within = 1;
                }
                within = __syncthreads_or(within);
            } else if (body == BALLS) {
                long long su = expand_ball(ball_u, u, a, cap_u, nbrs, c, d, tid, RESOLVE_THREADS, sync);
                long long sv = expand_ball(ball_v, v, k - a, cap_v, nbrs, c, d, tid, RESOLVE_THREADS, sync);
                for (long long p = tid; p < su && !within; p += RESOLVE_THREADS) {
                    int x = ball_u[p];
                    if (x < 0) continue;
                    for (long long j = 0; j < sv; ++j)
                        if (ball_v[j] == x) {
                            within = 1;
                            break;
                        }
                }
                within = __syncthreads_or(within);
            } else {
                for (int w = tid; w < words; w += RESOLVE_THREADS) reach[w] = front[w] = 0u;
                __syncthreads();
                if (tid == 0 && u < c) {
                    reach[u >> 5] |= 1u << (u & 31);
                    front[u >> 5] |= 1u << (u & 31);
                }
                __syncthreads();
                for (int r = 0; r < k; ++r) {
                    if (bit(reach, gv)) break;  // every thread reads the same bitmap
                    for (int w = tid; w < words; w += RESOLVE_THREADS) next[w] = 0u;
                    __syncthreads();
                    // a warp a frontier word, its lanes over each row's slots
                    for (int w = warp; w < words; w += RESOLVE_THREADS / 32) {
                        unsigned f = front[w];
                        while (f) {
                            const int x = (w << 5) + __ffs(f) - 1;
                            f &= f - 1u;
                            const int* row = nbrs + (long long)x * d;
                            for (int s = lane; s < d; s += 32) {
                                const int y = row[s];
                                if (y >= 0 && y < c && !bit(reach, y)) atomicOr(&next[y >> 5], 1u << (y & 31));
                            }
                        }
                    }
                    __syncthreads();
                    int grew = 0;
                    for (int w = tid; w < words; w += RESOLVE_THREADS) {
                        const unsigned nw = next[w] & ~reach[w];
                        reach[w] |= nw;
                        front[w] = nw;
                        grew |= nw != 0u;
                    }
                    if (!__syncthreads_or(grew)) break;
                }
                within = bit(reach, gv);
                __syncthreads();  // the bitmaps are rewritten by the next candidate
            }
            if (within) continue;  // uniform across the block
            // add_undirected_edge: present in either row (or u == v), or no room in one
            int present = u == v;
            for (int s = tid; s < d && !present; s += RESOLVE_THREADS)
                if (ru[s] == v || rv[s] == u) present = 1;
            present = __syncthreads_or(present);
            if (tid == 0 && !present) {
                const int du = deg[gu], dv = deg[gv];
                if (du < d && dv < d) {
                    if (u < c) nbrs[(long long)u * d + du] = v;
                    if (v < c) nbrs[(long long)v * d + dv] = u;
                    if (u < c) deg[u] += 1;
                    if (v < c) deg[v] += 1;
                    ++admitted;
                }
            }
            __syncthreads();
        }
    }
    if (tid == 0) {
        atomicAdd(&stats[0], 1);
        atomicAdd(&stats[1], total);
        atomicAdd(&stats[2], admitted);
        atomicMax(&stats[3], total);
    }
}

struct Plan {
    long long nu, nv;            // the pre-filter's capped ball sizes
    int pre_warps, pre_blocks;   // warps a block, blocks
    long long pre_smem;          // dynamic shared bytes a pre-filter block
    long long cand_off, pre_off, ball_off, bits_off, bytes;  // scratch layout (bytes)
    long long cap_u, cap_v;      // the resolution's full-ball sizes (body BALLS)
    int words;                   // bitmap words (body BFS)
    long long res_smem;          // dynamic shared bytes of the resolve block
    bool ok;
};

inline long long align(long long x) { return (x + 255) & ~255ll; }

Plan plan(int n, int c, int d, int k, int cap, int body) {
    Plan p{};
    p.ok = n >= 0 && c >= 1 && d >= 1 && k >= 0 && cap >= 0 && body >= 0 && body <= 2;
    if (!p.ok) return p;
    const int a = (k + 1) / 2;
    p.nu = ball_size(a, cap, d);
    p.nv = ball_size(k - a, cap, d);
    if (p.nu + p.nv > BALL_LIMIT) {
        p.ok = false;
        return p;
    }
    const long long per_warp = 4 * (p.nu + p.nv);
    long long w = SMEM_LIMIT / per_warp;
    p.cand_off = 0;
    p.pre_off = align(4ll * (n > 0 ? n : 1));
    long long pre_bytes = 0;
    if (w >= 1) {
        p.pre_warps = (int)(w < PRE_WARPS_MAX ? w : PRE_WARPS_MAX);
        long long blocks = (n + p.pre_warps - 1) / p.pre_warps;
        p.pre_blocks = (int)(blocks < 1 ? 1 : (blocks < PRE_BLOCKS_MAX ? blocks : PRE_BLOCKS_MAX));
        p.pre_smem = per_warp * p.pre_warps;
    } else {
        p.pre_warps = 4;
        p.pre_blocks = PRE_GLOBAL_WARPS / 4;
        p.pre_smem = 0;
        pre_bytes = per_warp * PRE_GLOBAL_WARPS;
    }
    p.ball_off = align(p.pre_off + pre_bytes);
    long long ball_bytes = 0;
    p.cap_u = p.cap_v = 0;
    if (body == BALLS) {
        long long fu = full_cap(a, d), fv = full_cap(k - a, d);
        if (fu > BALL_LIMIT || fv > BALL_LIMIT) {
            p.ok = false;
            return p;
        }
        p.cap_u = ball_size(a, fu, d);
        p.cap_v = ball_size(k - a, fv, d);
        ball_bytes = 4 * (p.cap_u + p.cap_v);
    }
    p.bits_off = align(p.ball_off + ball_bytes);
    p.words = (c + 31) / 32;
    long long bits_bytes = 0;
    p.res_smem = 0;
    if (body == BFS) {
        long long b = 12ll * p.words;
        if (b <= SMEM_LIMIT) p.res_smem = b;
        else bits_bytes = b;
    }
    p.bytes = align(p.bits_off + bits_bytes);
    return p;
}

}  // namespace

extern "C" {

// n, capacity, max_degree, k, cap, body: the scratch bytes of one call, or
// -1 where no call can run (its balls pass 2^28 entries, or bad arguments)
long long spanner_scratch_bytes(int n, int capacity, int max_degree, int k, int cap, int body) {
    Plan p = plan(n, capacity, max_degree, k, cap, body);
    return p.ok ? p.bytes : -1;
}

// nbrs int32[C, D] and deg int32[C] (updated in place), src, dst int32[n],
// mask bool[n] or null, k, cap, body (0 within_two, 1 balls, 2 bfs),
// scratch of spanner_scratch_bytes, stats int32[4] (calls, candidates,
// admitted, most candidates in a call; added to), stream
int spanner_admit_launch(int* nbrs, int* deg, int capacity, int max_degree, const int* src, const int* dst,
                         const bool* mask, int n, int k, int cap, int body, void* scratch, long long scratch_bytes,
                         int* stats, cudaStream_t stream) {
    Plan p = plan(n, capacity, max_degree, k, cap, body);
    if (!p.ok || scratch_bytes < p.bytes) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    char* base = static_cast<char*>(scratch);
    int* cand = reinterpret_cast<int*>(base + p.cand_off);
    int* pre_balls = p.pre_smem ? nullptr : reinterpret_cast<int*>(base + p.pre_off);
    if (p.pre_smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(prefilter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)p.pre_smem);
        if (e != cudaSuccess) return (int)e;
    }
    prefilter_kernel<<<p.pre_blocks, 32 * p.pre_warps, (size_t)p.pre_smem, stream>>>(
        nbrs, capacity, max_degree, src, dst, mask, n, k, cap, (int)p.nu, (int)p.nv, pre_balls, cand);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (p.res_smem > 48 * 1024) {
        e = cudaFuncSetAttribute(resolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.res_smem);
        if (e != cudaSuccess) return (int)e;
    }
    int* balls = reinterpret_cast<int*>(base + p.ball_off);
    unsigned* bits = p.res_smem || body != BFS ? nullptr : reinterpret_cast<unsigned*>(base + p.bits_off);
    resolve_kernel<<<1, RESOLVE_THREADS, (size_t)p.res_smem, stream>>>(
        nbrs, deg, capacity, max_degree, src, dst, cand, n, k, body, p.cap_u, p.cap_v, balls, bits, p.words, stats);
    return (int)cudaGetLastError();
}

}  // extern "C"
