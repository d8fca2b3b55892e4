// The fixed-state sketches' folds and the sampled closure count on Hopper
// (sm_90a), behind a plain C interface.
//
// Replaces four XLA loops of gelly_streaming_tpu/summaries/sketches.py:
//   hll_fold (:112-126)       a salted u32 hash a key: register = its low
//                             log2(m) bits, rank = clz(h >> p) - p + 1;
//                             scatter-max into int32 registers [m]
//   cm_fold (:175-183)        d salted hashes a key, a scatter-add of the
//                             key's count into each of the d rows [d * w]
//   tri_fold + tri_merge      a bucket a canonical edge, the lexicographic
//     (:226-287)              argmin of (u32 sample hash, int32 lo, int32 hi)
//                             a bucket, merged rowwise into the R-row sample
//   tri_sampled_closures      per ordered row pair sharing a vertex, is the
//     (:296-368)              closing edge's member hash among the sample's?
//
// The hashes are murmur3's fmix32 with the JAX package's salts, computed
// here from the ids: every kernel reads each edge (or key) once.  A
// descriptor's update is one C call a batch: HLLDegreeSummary's three key
// families (src and dst vertex hashes, the canonical edge hash) in one
// launch, count-min's src and dst rows in one, and SketchTriangleCount's
// sample with its distinct-edge registers in one (plus a second pass and
// a rowwise merge).
//
// What bounds them: the folds read 8-9 bytes an edge and do ~20-40 integer
// operations; their writes are scatter-max or scatter-add into a few KB to
// 256 KB of registers, so the limit is the rate of atomic updates, not
// device memory.  Where a fold's register arrays fit PRIVATE_BYTES of
// shared memory, each block folds into its own copy with shared-memory
// atomics and merges the copy into the global array at its end (only the
// entries that raise it, for a max); otherwise the updates go to the global
// array directly.  The limit is 128 KB: count-min's (d, w) = (5, 4096)
// grid, 80 KB, folds a batch of 2^21 edges several times faster in private
// copies than as 21M L2 atomics (chip_smoke.py phase 18 times both).  An
// HLL update reads the register first and issues its atomicMax only where
// its rank is larger, which after warm-up is almost never.  Max and
// wrapping integer addition commute, so every order gives the JAX
// package's bits.
//
// tri_fold: pass 1 packs (u64(hash) << 32) | u32(lo ^ 0x80000000) so that
// one unsigned 64-bit atomicMin a bucket gives the least (hash, lo) with lo
// compared signed (the R keys in shared memory, merged to global); pass 2
// takes the least hi, biased the same way, among the edges equal to their
// bucket's (hash, lo); pass 3 merges each bucket's winner into its state
// row with _row_take's order (the hash unsigned, lo and hi signed).  A
// masked edge, a self-loop and an edge whose sample hash is 0xFFFFFFFF
// (JAX's won = bmin != EMPTY_HASH) take no part.
//
// tri_sampled_closures: a block a strip of 32 rows i (the JAX package's
// TRI_CLOSURE_BLOCK), the sample's lo and hi in shared memory, a thread a
// column j.  JAX looks each closing edge's member hash up in the sorted
// member hashes by searchsorted; here each block builds an open-addressing
// set of the valid rows' member hashes in shared memory.  The two are the
// same test: "ckey is among the valid rows' member hashes and ckey !=
// EMPTY_HASH" (an invalid row's key is EMPTY_HASH, which the test excludes,
// so the set leaves it out and uses it as its empty slot).  Sums are int32
// block reductions added into one counter; a last kernel halves it.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr uint32_t GOLDEN = 0x9E3779B9u;
constexpr uint32_t EMPTY_HASH = 0xFFFFFFFFu;
constexpr uint32_t SALT_BUCKET = 0x2545F491u;
constexpr uint32_t SALT_SAMPLE = 0x9E4C1B3Bu;
constexpr uint32_t SALT_MEMBER = 0x61C88647u;
constexpr uint32_t SALT_CM_ROW = 0x7FEB352Du;
constexpr uint32_t SALT_EDGE_HLL = 0x45D9F3B5u;
constexpr uint32_t SALT_VERTEX_HLL = 0x119DE1F3u;
constexpr uint32_t SIGN = 0x80000000u;
constexpr unsigned long long NO_KEY = ~0ull;

constexpr int THREADS = 512;                  // threads a fold block
constexpr int EDGES_A_THREAD = 8;             // a block's share of the batch before another block pays off
constexpr size_t PRIVATE_BYTES = 128 * 1024;  // a fold's registers this small are folded in shared memory first
constexpr int STRIP = 32;                     // closure rows a block (TRI_CLOSURE_BLOCK)
constexpr int CLOSURE_THREADS = 256;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
    x ^= x >> 16;
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return x;
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x, uint32_t salt) { return mix32(x ^ (salt * GOLDEN)); }

__device__ __forceinline__ uint32_t hash_pair(int lo, int hi, uint32_t salt) {
    return mix32(mix32((uint32_t)lo ^ (salt * GOLDEN)) ^ ((uint32_t)hi * GOLDEN));
}

// rank clz(h >> p) - p + 1 (clz(0) = 32: the saturating 33 - p) into
// register h & (m - 1), issued only where it raises the register
__device__ __forceinline__ void hll_put(int* regs, int p, uint32_t h) {
    int idx = (int)(h & ((1u << p) - 1));
    int rank = __clz((int)(h >> p)) - p + 1;
    if (rank > regs[idx]) atomicMax(regs + idx, rank);
}

__device__ __forceinline__ void fill(int* a, int n, int v) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = v;
}

// a block's private registers into the global ones: the entries that raise them
__device__ __forceinline__ void merge_max(int* regs, const int* mine, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        int v = mine[i];
        if (v > regs[i]) atomicMax(regs + i, v);
    }
}

__device__ __forceinline__ bool kept(const bool* mask, int e) { return mask == nullptr || mask[e]; }

// hll_fold: precomputed u32 hashes (int64 lanes, the port's hash type)
template <bool PRIVATE>
__global__ void __launch_bounds__(THREADS) hll_keys_kernel(int* regs, int p, const long long* keys,
                                                           const bool* mask, int n) {
    extern __shared__ int smem[];
    const int m = 1 << p;
    int* r = PRIVATE ? smem : regs;
    if (PRIVATE) {
        fill(smem, m, 0);
        __syncthreads();
    }
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x)
        if (kept(mask, e)) hll_put(r, p, (uint32_t)keys[e]);
    if (PRIVATE) {
        __syncthreads();
        merge_max(regs, smem, m);
    }
}

// HLLDegreeSummary.update: the src and dst vertex hashes into verts, the
// canonical edge's hash into edges, under the mask (self-loops included)
template <bool PRIVATE>
__global__ void __launch_bounds__(THREADS) hll_degree_kernel(int* verts, int* edges, int p, const int* src,
                                                             const int* dst, const bool* mask, int n) {
    extern __shared__ int smem[];
    const int m = 1 << p;
    int* rv = PRIVATE ? smem : verts;
    int* re = PRIVATE ? smem + m : edges;
    if (PRIVATE) {
        fill(smem, 2 * m, 0);
        __syncthreads();
    }
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
        if (!kept(mask, e)) continue;
        int u = src[e], v = dst[e];
        hll_put(rv, p, hash_u32((uint32_t)u, SALT_VERTEX_HLL));
        hll_put(rv, p, hash_u32((uint32_t)v, SALT_VERTEX_HLL));
        hll_put(re, p, hash_pair(min(u, v), max(u, v), SALT_EDGE_HLL));
    }
    if (PRIVATE) {
        __syncthreads();
        merge_max(verts, smem, m);
        merge_max(edges, smem + m, m);
    }
}

// cm_fold: each kept key's count into its column of every row; keys_b (the
// degree fold's dst) folds after keys_a with the same count
template <bool PRIVATE>
__global__ void __launch_bounds__(THREADS) cm_kernel(int* grid, int d, int logw, const int* keys_a,
                                                     const int* keys_b, const int* counts, const bool* mask, int n) {
    extern __shared__ int smem[];
    const int w = 1 << logw;
    int* g = PRIVATE ? smem : grid;
    if (PRIVATE) {
        fill(smem, d * w, 0);
        __syncthreads();
    }
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
        if (!kept(mask, e)) continue;
        int c = counts ? counts[e] : 1;
        if (c == 0) continue;
        for (int k = 0; k < (keys_b ? 2 : 1); ++k) {
            uint32_t key = (uint32_t)(k ? keys_b[e] : keys_a[e]);
            for (int r = 0; r < d; ++r)
                atomicAdd(g + r * w + (int)(hash_u32(key, SALT_CM_ROW + (uint32_t)r) & (uint32_t)(w - 1)), c);
        }
    }
    if (PRIVATE) {
        __syncthreads();
        for (int i = threadIdx.x; i < d * w; i += blockDim.x) {
            int v = smem[i];
            if (v != 0) atomicAdd(grid + i, v);
        }
    }
}

// a canonical non-self-loop edge's bucket and (hash, lo) key; false where
// its sample hash is 0xFFFFFFFF (JAX: won = bmin != EMPTY_HASH)
__device__ __forceinline__ bool tri_key(int lo, int hi, int rows, int& bucket, unsigned long long& key) {
    uint32_t s = hash_pair(lo, hi, SALT_SAMPLE);
    if (s == EMPTY_HASH) return false;
    bucket = (int)(hash_pair(lo, hi, SALT_BUCKET) & (uint32_t)(rows - 1));
    key = ((unsigned long long)s << 32) | ((uint32_t)lo ^ SIGN);
    return true;
}

// pass 1: the least (hash, lo) key a bucket, and the distinct-edge
// registers (regs may be null) under mask & lo != hi
template <bool PRIVATE>
__global__ void __launch_bounds__(THREADS) tri_keys_kernel(unsigned long long* gkey, int rows, int* regs, int p,
                                                           const int* src, const int* dst, const bool* mask, int n) {
    extern __shared__ unsigned long long skey[];
    int* sregs = reinterpret_cast<int*>(skey + rows);
    const int m = regs ? 1 << p : 0;
    int* r = PRIVATE ? sregs : regs;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) skey[i] = NO_KEY;
    if (PRIVATE) fill(sregs, m, 0);
    __syncthreads();
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
        if (!kept(mask, e)) continue;
        int u = src[e], v = dst[e];
        int lo = min(u, v), hi = max(u, v);
        if (lo == hi) continue;  // self-loops close no wedges
        if (regs) hll_put(r, p, hash_pair(lo, hi, SALT_EDGE_HLL));
        int b;
        unsigned long long key;
        if (tri_key(lo, hi, rows, b, key) && key < skey[b]) atomicMin(skey + b, key);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        unsigned long long k = skey[i];
        if (k < gkey[i]) atomicMin(gkey + i, k);
    }
    if (PRIVATE) merge_max(regs, sregs, m);
}

// pass 2: the least hi (biased) among the edges equal to their bucket's key
__global__ void __launch_bounds__(THREADS) tri_hi_kernel(const unsigned long long* gkey, unsigned* ghi, int rows,
                                                         const int* src, const int* dst, const bool* mask, int n) {
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
        if (!kept(mask, e)) continue;
        int u = src[e], v = dst[e];
        int lo = min(u, v), hi = max(u, v), b;
        unsigned long long key;
        if (lo != hi && tri_key(lo, hi, rows, b, key) && key == gkey[b]) atomicMin(ghi + b, (uint32_t)hi ^ SIGN);
    }
}

// pass 3: each bucket's winner (EMPTY_HASH, -1, -1 where none) merged into
// its row where it precedes it on (hash unsigned, lo, hi signed)
__global__ void tri_merge_kernel(long long* eh, int* elo, int* ehi, const unsigned long long* gkey,
                                 const unsigned* ghi, int rows) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rows) return;
    unsigned long long k = gkey[i];
    long long wh = EMPTY_HASH;
    int wlo = -1, whi = -1;
    if (k != NO_KEY) {
        wh = (long long)(k >> 32);
        wlo = (int)((uint32_t)k ^ SIGN);
        whi = (int)(ghi[i] ^ SIGN);
    }
    long long ah = eh[i];
    int alo = elo[i], ahi = ehi[i];
    if (wh < ah || (wh == ah && (wlo < alo || (wlo == alo && whi < ahi)))) {
        eh[i] = wh;
        elo[i] = wlo;
        ehi[i] = whi;
    }
}

__device__ __forceinline__ void set_insert(uint32_t* set, int tmask, uint32_t key) {
    for (int slot = (int)(key & (uint32_t)tmask);; slot = (slot + 1) & tmask) {
        uint32_t prev = atomicCAS(set + slot, EMPTY_HASH, key);
        if (prev == EMPTY_HASH || prev == key) return;
    }
}

__device__ __forceinline__ bool set_has(const uint32_t* set, int tmask, uint32_t key) {
    for (int slot = (int)(key & (uint32_t)tmask);; slot = (slot + 1) & tmask) {
        uint32_t k = set[slot];
        if (k == key) return true;
        if (k == EMPTY_HASH) return false;
    }
}

// a block: rows [STRIP * blockIdx.x, + STRIP) against every row; shared:
// lo [R], hi [R], the member-hash set [2R]
__global__ void __launch_bounds__(CLOSURE_THREADS) closures_kernel(const int* elo, const int* ehi, int rows,
                                                                   int* total) {
    extern __shared__ int sm[];
    int* slo = sm;
    int* shi = sm + rows;
    uint32_t* set = reinterpret_cast<uint32_t*>(sm + 2 * rows);
    const int tmask = 2 * rows - 1;
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        slo[i] = elo[i];
        shi[i] = ehi[i];
    }
    for (int i = threadIdx.x; i <= tmask; i += blockDim.x) set[i] = EMPTY_HASH;
    __syncthreads();
    for (int i = threadIdx.x; i < rows; i += blockDim.x)
        if (slo[i] != -1) {
            uint32_t key = hash_pair(slo[i], shi[i], SALT_MEMBER);
            if (key != EMPTY_HASH) set_insert(set, tmask, key);
        }
    __syncthreads();
    int count = 0;
    const int first = blockIdx.x * STRIP, last = min(first + STRIP, rows);
    for (int i = first; i < last; ++i) {
        const int li = slo[i], hi_i = shi[i];
        if (li == -1) continue;
        for (int j = threadIdx.x; j < rows; j += blockDim.x) {
            const int lj = slo[j], hj = shi[j];
            if (j == i || lj == -1) continue;
            // the four incidence cases in JAX's priority, each naming the closing pair
            int a, b;
            if (li == lj) {
                a = hi_i;
                b = hj;
            } else if (li == hj) {
                a = hi_i;
                b = lj;
            } else if (hi_i == lj) {
                a = li;
                b = hj;
            } else if (hi_i == hj) {
                a = li;
                b = lj;
            } else {
                continue;
            }
            if (a == b) continue;
            uint32_t key = hash_pair(min(a, b), max(a, b), SALT_MEMBER);
            count += key != EMPTY_HASH && set_has(set, tmask, key);
        }
    }
    for (int off = 16; off; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
    __shared__ int warp_sums[CLOSURE_THREADS / 32];
    if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
        int sum = 0;
        for (int w = 0; w < CLOSURE_THREADS / 32; ++w) sum += warp_sums[w];
        if (sum) atomicAdd(total, sum);
    }
}

// each ordered pair was counted twice
__global__ void closures_finish_kernel(const int* total, int* out) { *out = *total / 2; }

int log2_exact(int x) {
    if (x <= 0 || (x & (x - 1))) return -1;
    int p = 0;
    while ((1 << p) < x) ++p;
    return p;
}

struct Device {
    int sms = 0;
    size_t smem[8] = {};  // the dynamic shared-memory bytes each kernel is configured for
};

cudaError_t device(Device** out) {
    static Device devices[MAX_DEVICES];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    Device& d = devices[dev];
    if (d.sms == 0 && (err = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return err;
    *out = &d;
    return cudaSuccess;
}

// raise kernel's dynamic shared-memory limit (slot: its index in
// Device::smem) to bytes, once a device
template <typename K>
cudaError_t allow(Device* d, int slot, K kernel, size_t bytes) {
    if (bytes <= 48 * 1024 || bytes <= d->smem[slot]) return cudaSuccess;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) d->smem[slot] = bytes;
    return err;
}

// blocks for n items: one a THREADS * EDGES_A_THREAD items, at most one an
// SM for private copies (each merges its copy) and four an SM otherwise
int fold_blocks(const Device* d, int n, bool priv) {
    long long want = ((long long)n + THREADS * EDGES_A_THREAD - 1) / (THREADS * EDGES_A_THREAD);
    long long cap = priv ? d->sms : 4LL * d->sms;
    return (int)(want < 1 ? 1 : (want > cap ? cap : want));
}

}  // namespace

extern "C" {

// regs int32[m] (m a power of two; updated in place), keys int64[n] (u32
// hashes), mask bool[n] or null, n, stream
int hll_fold_launch(int* regs, int m, const long long* keys, const bool* mask, int n, cudaStream_t stream) {
    int p = log2_exact(m);
    if (p < 0 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Device* d;
    cudaError_t err = device(&d);
    if (err != cudaSuccess) return (int)err;
    size_t bytes = (size_t)m * 4;
    if (bytes <= PRIVATE_BYTES) {
        if ((err = allow(d, 0, hll_keys_kernel<true>, bytes)) != cudaSuccess) return (int)err;
        hll_keys_kernel<true><<<fold_blocks(d, n, true), THREADS, bytes, stream>>>(regs, p, keys, mask, n);
    } else {
        hll_keys_kernel<false><<<fold_blocks(d, n, false), THREADS, 0, stream>>>(regs, p, keys, mask, n);
    }
    return (int)cudaGetLastError();
}

// verts, edges int32[m] (updated in place), m, src, dst int32[n], mask
// bool[n] or null, n, stream: the three key families in one launch
int hll_degree_launch(int* verts, int* edges, int m, const int* src, const int* dst, const bool* mask, int n,
                      cudaStream_t stream) {
    int p = log2_exact(m);
    if (p < 0 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Device* d;
    cudaError_t err = device(&d);
    if (err != cudaSuccess) return (int)err;
    size_t bytes = (size_t)m * 8;  // both banks
    if (bytes <= PRIVATE_BYTES) {
        if ((err = allow(d, 1, hll_degree_kernel<true>, bytes)) != cudaSuccess) return (int)err;
        hll_degree_kernel<true><<<fold_blocks(d, n, true), THREADS, bytes, stream>>>(verts, edges, p, src, dst, mask,
                                                                                     n);
    } else {
        hll_degree_kernel<false><<<fold_blocks(d, n, false), THREADS, 0, stream>>>(verts, edges, p, src, dst, mask,
                                                                                   n);
    }
    return (int)cudaGetLastError();
}

// grid int32[d * w] (updated in place), d, w (a power of two), keys_a
// int32[n], keys_b int32[n] or null (folded after keys_a with the same
// counts), counts int32[n] or null (1 each), mask bool[n] or null, n,
// stream
int cm_fold_launch(int* grid, int d, int w, const int* keys_a, const int* keys_b, const int* counts,
                   const bool* mask, int n, cudaStream_t stream) {
    int logw = log2_exact(w);
    if (logw < 0 || d < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Device* dv;
    cudaError_t err = device(&dv);
    if (err != cudaSuccess) return (int)err;
    size_t bytes = (size_t)d * w * 4;
    if (bytes <= PRIVATE_BYTES) {
        if ((err = allow(dv, 2, cm_kernel<true>, bytes)) != cudaSuccess) return (int)err;
        cm_kernel<true><<<fold_blocks(dv, n, true), THREADS, bytes, stream>>>(grid, d, logw, keys_a, keys_b, counts,
                                                                              mask, n);
    } else {
        cm_kernel<false><<<fold_blocks(dv, n, false), THREADS, 0, stream>>>(grid, d, logw, keys_a, keys_b, counts,
                                                                            mask, n);
    }
    return (int)cudaGetLastError();
}

// rows: the scratch bytes of tri_fold_launch (the keys u64[R], then the
// biased hi u32[R])
long long tri_fold_scratch_bytes(int rows) {
    if (log2_exact(rows) < 0) return -1;
    return (long long)rows * 12;
}

// eh int64[R], elo, ehi int32[R] (updated in place), R (a power of two),
// regs int32[m] or null (the distinct-edge registers, folded under mask &
// lo != hi), m, src, dst int32[n], mask bool[n] or null, n, scratch,
// scratch bytes, stream: a memset, then the key, hi and merge kernels
int tri_fold_launch(long long* eh, int* elo, int* ehi, int rows, int* regs, int m, const int* src, const int* dst,
                    const bool* mask, int n, void* scratch, long long scratch_bytes, cudaStream_t stream) {
    int p = regs ? log2_exact(m) : 0;
    if (log2_exact(rows) < 0 || p < 0 || n < 0 || !scratch || scratch_bytes < (long long)rows * 12)
        return (int)cudaErrorInvalidValue;
    Device* d;
    cudaError_t err = device(&d);
    if (err != cudaSuccess) return (int)err;
    unsigned long long* gkey = static_cast<unsigned long long*>(scratch);
    unsigned* ghi = reinterpret_cast<unsigned*>(gkey + rows);
    if ((err = cudaMemsetAsync(scratch, 0xFF, (size_t)rows * 12, stream)) != cudaSuccess) return (int)err;
    if (n > 0) {
        bool priv = regs && (size_t)rows * 8 + (size_t)m * 4 <= PRIVATE_BYTES;
        size_t bytes = (size_t)rows * 8 + (priv ? (size_t)m * 4 : 0);
        if (priv) {
            if ((err = allow(d, 3, tri_keys_kernel<true>, bytes)) != cudaSuccess) return (int)err;
            tri_keys_kernel<true><<<fold_blocks(d, n, true), THREADS, bytes, stream>>>(gkey, rows, regs, p, src, dst,
                                                                                       mask, n);
        } else {
            if ((err = allow(d, 4, tri_keys_kernel<false>, bytes)) != cudaSuccess) return (int)err;
            tri_keys_kernel<false><<<fold_blocks(d, n, true), THREADS, bytes, stream>>>(gkey, rows, regs, p, src,
                                                                                        dst, mask, n);
        }
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        tri_hi_kernel<<<fold_blocks(d, n, false), THREADS, 0, stream>>>(gkey, ghi, rows, src, dst, mask, n);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    tri_merge_kernel<<<(rows + 255) / 256, 256, 0, stream>>>(eh, elo, ehi, gkey, ghi, rows);
    return (int)cudaGetLastError();
}

// elo, ehi int32[R] (R a power of two), R, out int32[1] (the closed-wedge
// count // 2), scratch int32[1] (the counter), stream: a memset, the strip
// kernel, the halving kernel
int tri_closures_launch(const int* elo, const int* ehi, int rows, int* out, int* scratch, cudaStream_t stream) {
    if (log2_exact(rows) < 0 || !out || !scratch) return (int)cudaErrorInvalidValue;
    Device* d;
    cudaError_t err = device(&d);
    if (err != cudaSuccess) return (int)err;
    size_t bytes = (size_t)rows * 16;
    if ((err = allow(d, 5, closures_kernel, bytes)) != cudaSuccess) return (int)err;
    if ((err = cudaMemsetAsync(scratch, 0, 4, stream)) != cudaSuccess) return (int)err;
    closures_kernel<<<(rows + STRIP - 1) / STRIP, CLOSURE_THREADS, bytes, stream>>>(elo, ehi, rows, scratch);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    closures_finish_kernel<<<1, 1, 0, stream>>>(scratch, out);
    return (int)cudaGetLastError();
}

}  // extern "C"
