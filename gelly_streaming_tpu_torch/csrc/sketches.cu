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
// What bounds them: the folds read 8-9 bytes an edge and do ~20-130
// integer operations; their writes are scatter-max or scatter-add into a
// few KB to 256 KB of registers, so the limit is the traffic of register
// reads and atomic updates and the hashing, not device memory.  Max and wrapping integer
// addition commute, so every order gives the JAX package's bits.
//
// hll_fold (both launches): each block (one an SM) holds a filter of the
// registers as they stood at the launch, a nibble a register (the register
// plus one, clamped to [0, 15]: ranks reach 33 - p, but a warm register
// rarely passes 14), so both banks at m = 2^16 take 64 KB.  One
// cooperative launch: the blocks write the nibbles to scratch (the image);
// after a grid-wide sync each block copies it into shared memory by TMA
// bulk copies, hashing its threads' first STASH edges while it lands.
// An update whose rank is below its nibble is done: after warm-up nearly
// every one, with no read of the registers in L2 (in 609487c those reads,
// 6.3M a batch of 2^21 edges, took ~68% of the kernel).  Otherwise it reads
// the register, issues atomicMax where the rank still raises it, and
// stores the larger value's nibble.  The filter only holds values the
// register had, so it never passes it; a racing store to the same byte may
// put back an older nibble, which is lower (one more read, never a lost
// raise).  A masked row is rank 0, as in the JAX package (it raises a
// register below 0).  Registers past 2 * FILTER_BYTES (m above the
// descriptors' cap) are read in L2 every time.  The image in a kernel of
// its own, a filter filled over DSMEM in clusters, and the image multicast
// over a cluster measured slower (chip_smoke.py phase 18).
//
// cm_fold: each block folds into a private grid in shared memory (the
// first CM_PRIVATE_BYTES of the grid; counters past it take global
// atomics), two blocks an SM: the shared atomics, not the merge, bound the
// fold (in 609487c the merge was ~5% of the kernel), and 32 warps hide
// more of them.  The blocks run in clusters of CM_CLUSTER: after the edges
// each member sums a 1/CM_CLUSTER slice of the members' grids over DSMEM
// and adds each nonzero sum to the global grid, one global add a counter a
// cluster instead of one a block.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

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
constexpr int FILTER_THREADS = 1024;          // threads an HLL filter block
constexpr int STASH = 4;                      // edges a thread hashes before its filter is whole
constexpr int FILTER_BYTES = 96 * 1024;       // an HLL block's filter, a nibble a register (m = 2^16: 64 KB)
constexpr int CM_THREADS = 512;               // threads a count-min block
constexpr size_t CM_PRIVATE_BYTES = 96 * 1024;  // a count-min block's private grid (its first counters)
constexpr int CM_CLUSTER = 8;                 // blocks a cluster summing their private grids
constexpr int CM_BLOCKS_AN_SM = 2;            // count-min blocks an SM: 32 warps to hide the shared atomics
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

// An HLL register's nibble in a filter: the register plus one, clamped to
// [0, 15].  A rank below the nibble is not above the register; 0 says
// nothing (a register below 0, or not read yet).
__device__ __forceinline__ uint32_t reg_nibble(int v) { return v >= 14 ? 15u : (uint32_t)max(v + 1, 0); }

// This block's share of the filter's image in scratch: the nibbles of
// bank0's registers, then bank1's (m each), as they stand at the launch,
// two to a byte (the even register low), len registers in all.
__device__ void write_image(const int* bank0, const int* bank1, int m, int len, uint8_t* image) {
    for (int i = 2 * (blockIdx.x * blockDim.x + threadIdx.x); i < len; i += 2 * gridDim.x * blockDim.x) {
        uint32_t b = reg_nibble(__ldcg(i < m ? bank0 + i : bank1 + (i - m)));
        if (i + 1 < len) b |= reg_nibble(__ldcg(i + 1 < m ? bank0 + i + 1 : bank1 + (i + 1 - m))) << 4;
        image[i / 2] = (uint8_t)b;
    }
}

// the image's bytes (bytes, a multiple of 16) into the block's filter: one
// thread issues TMA bulk copies that complete on the shared-memory barrier
// landed (after a proxy fence: the image was written by ordinary stores);
// the block waits on it in wait_filter
__device__ void copy_filter(uint8_t* filt, const uint8_t* image, int bytes, unsigned long long* landed) {
    const unsigned bar = (unsigned)__cvta_generic_to_shared(landed);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        asm volatile("fence.proxy.async.global;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
        for (int off = 0; off < bytes; off += 32768)
            asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                         ::"r"((unsigned)__cvta_generic_to_shared(filt + off)), "l"(image + off),
                           "r"(min(32768, bytes - off)), "r"(bar) : "memory");
    }
    __syncthreads();  // the barrier is set before any thread waits on it
}

__device__ void wait_filter(unsigned long long* landed) {
    const unsigned bar = (unsigned)__cvta_generic_to_shared(landed);
    unsigned done = 0;
    while (!done)
        asm volatile("{\n .reg .pred q;\n mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;\n"
                     " selp.u32 %0, 1, 0, q;\n}" : "=r"(done) : "r"(bar) : "memory");
}

// An HLL update through the block's filter (f: the register's place among
// both banks; past flen, no filter).  A masked row is rank 0 (the JAX
// package's where(mask, rank, 0): it raises a register below 0).  A rank
// below its nibble is done: the nibble holds a value the register already
// had, plus one.  Otherwise the update reads the register, raises it where
// the rank still does, and stores the larger of the two into the nibble.
// A racing store to the byte may put back an older nibble: lower, so one
// more read later, never a lost raise.
__device__ __forceinline__ void hll_filtered_put(int* regs, uint8_t* filt, int flen, int off, int p, uint32_t h,
                                                 bool keep) {
    const int idx = (int)(h & ((1u << p) - 1));
    const int rank = keep ? __clz((int)(h >> p)) - p + 1 : 0;
    const int f = off + idx, shift = (f & 1) * 4;
    uint32_t byte = 0;
    if (f < flen) {
        byte = filt[f >> 1];
        if (rank < (int)((byte >> shift) & 15)) return;
    }
    const int g = __ldcg(regs + idx);
    if (rank > g) atomicMax(regs + idx, rank);
    if (f < flen) filt[f >> 1] = (uint8_t)((byte & (0xF0u >> shift)) | reg_nibble(max(rank, g)) << shift);
}

// an edge's hashes: DEGREE, HLLDegreeSummary.update's three (the src and
// dst vertex hashes into bank0, the canonical edge's hash into bank1);
// otherwise hll_fold's precomputed u32 hash (int64 lanes, the port's hash
// type) into bank0
template <bool DEGREE>
__device__ __forceinline__ void edge_hashes(int e, const int* __restrict__ src, const int* __restrict__ dst,
                                            const long long* __restrict__ keys, uint32_t* h) {
    if (DEGREE) {
        const int u = src[e], v = dst[e];
        h[0] = hash_u32((uint32_t)u, SALT_VERTEX_HLL);
        h[1] = hash_u32((uint32_t)v, SALT_VERTEX_HLL);
        h[2] = hash_pair(min(u, v), max(u, v), SALT_EDGE_HLL);
    } else {
        h[0] = (uint32_t)keys[e];
    }
}

template <bool DEGREE>
__device__ __forceinline__ void edge_puts(int* bank0, int* bank1, uint8_t* filt, int flen, int p, const uint32_t* h,
                                          bool keep) {
    hll_filtered_put(bank0, filt, flen, 0, p, h[0], keep);
    if (DEGREE) {
        hll_filtered_put(bank0, filt, flen, 0, p, h[1], keep);
        hll_filtered_put(bank1, filt, flen, 1 << p, p, h[2], keep);
    }
}

// the edges from e = start on, a grid stride apart, under the mask (a
// masked row is rank 0; HLLDegreeSummary folds self-loops)
template <bool DEGREE>
__device__ __forceinline__ void hll_edges(int* bank0, int* bank1, uint8_t* filt, int flen, int p, int start,
                                          const int* __restrict__ src, const int* __restrict__ dst,
                                          const long long* __restrict__ keys, const bool* __restrict__ mask, int n) {
    uint32_t h[3];
#pragma unroll 2
    for (int e = start; e < n; e += gridDim.x * blockDim.x) {
        edge_hashes<DEGREE>(e, src, dst, keys, h);
        edge_puts<DEGREE>(bank0, bank1, filt, flen, p, h, kept(mask, e));
    }
}

// One cooperative launch, a block an SM: each block writes its share of
// the filter's image (flen registers); after a grid-wide sync each copies
// the whole image (bytes, a multiple of 16) into its filter, hashing its
// threads' first STASH edges while the copy lands, then folds its edges
// through it
template <bool DEGREE>
__global__ void __launch_bounds__(FILTER_THREADS, 1) hll_filter_kernel(int* bank0, int* bank1, int p, int flen,
                                                                       uint8_t* image, int bytes, const int* src,
                                                                       const int* dst, const long long* keys,
                                                                       const bool* mask, int n) {
    extern __shared__ __align__(16) uint8_t hll_filter[];
    __shared__ __align__(8) unsigned long long landed;
    constexpr int K = DEGREE ? 3 : 1, S = STASH > 0 ? STASH : 1;
    const int first = blockIdx.x * blockDim.x + threadIdx.x, stride = gridDim.x * blockDim.x;
    write_image(bank0, bank1, 1 << p, flen, image);
    asm volatile("fence.proxy.async.global;" ::: "memory");
    cg::this_grid().sync();  // the image is whole
    copy_filter(hll_filter, image, bytes, &landed);
    uint32_t h[S][K];
#pragma unroll
    for (int k = 0; k < STASH; ++k)
        if (first + k * stride < n) edge_hashes<DEGREE>(first + k * stride, src, dst, keys, h[k]);
    wait_filter(&landed);
#pragma unroll
    for (int k = 0; k < STASH; ++k)
        if (first + k * stride < n)
            edge_puts<DEGREE>(bank0, bank1, hll_filter, flen, p, h[k], kept(mask, first + k * stride));
    hll_edges<DEGREE>(bank0, bank1, hll_filter, flen, p, first + STASH * stride, src, dst, keys, mask, n);
}

// cm_fold: each kept key's count into its column of each of the D rows (d
// where D is 0); keys_b (the degree fold's dst) after keys_a with the same
// count.  Counters [0, priv) gather in the block's private grid in shared
// memory; PARTIAL (a grid past CM_PRIVATE_BYTES) sends the rest to the
// global grid, a branch the whole-grid kernels leave out (the compiler
// merges its two atomics into one slow generic atomic).  After the edges
// member r of the cluster sums its slice of the members' private grids,
// read over DSMEM, and adds each nonzero sum to the global grid: one global
// add a counter a cluster.  Wrapping int32 sums keep their bits in any
// order.
template <int D, bool PARTIAL>
__global__ void __launch_bounds__(CM_THREADS) cm_cluster_kernel(int* grid, int d, int logw, int priv,
                                                                const int* __restrict__ keys_a,
                                                                const int* __restrict__ keys_b,
                                                                const int* __restrict__ counts,
                                                                const bool* __restrict__ mask, int n) {
    extern __shared__ __align__(16) int cm_grid[];
    cg::cluster_group cl = cg::this_cluster();
    const int w = 1 << logw;
    fill(cm_grid, priv, 0);
    __syncthreads();
#pragma unroll 2
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
        if (!kept(mask, e)) continue;
        const int c = counts ? counts[e] : 1;
        if (c == 0) continue;
        for (int k = 0; k < (keys_b ? 2 : 1); ++k) {
            const uint32_t key = (uint32_t)(k ? keys_b[e] : keys_a[e]);
#pragma unroll
            for (int r = 0; r < (D ? D : d); ++r) {
                const int i = r * w + (int)(hash_u32(key, SALT_CM_ROW + (uint32_t)r) & (uint32_t)(w - 1));
                if (!PARTIAL || i < priv)
                    atomicAdd(cm_grid + i, c);
                else
                    atomicAdd(grid + i, c);
            }
        }
    }
    cl.sync();  // every member's grid is whole
    const int cs = (int)cl.num_blocks();
    const int per = (priv + cs - 1) / cs, first = (int)cl.block_rank() * per, last = min(priv, first + per);
    for (int i = first + threadIdx.x; i < last; i += blockDim.x) {
        uint32_t sum = 0;
        for (int t = 0; t < cs; ++t) sum += (uint32_t)cl.map_shared_rank(cm_grid, t)[i];
        if (sum) atomicAdd(grid + i, (int)sum);
    }
    cl.sync();  // no member leaves while its grid is read
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
    size_t smem[20] = {};          // the dynamic shared-memory bytes each kernel is configured for
    int fit[20] = {};              // the clusters (or blocks) the card holds at once, for fit_smem[slot] bytes
    size_t fit_smem[20] = {};
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

// kernel (slot: its index in Device's arrays) in clusters of c blocks of
// threads, smem dynamic bytes each: one cluster a c * threads *
// EDGES_A_THREAD items, as many as the card holds at once and at most
// blocks_an_sm * SMs / c.  A cluster shape or size the card refuses is an
// error (cudaErrorInvalidConfiguration where it holds no cluster).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(Device* d, int slot, void (*kernel)(Params...), int c, int threads, size_t smem,
                            long long items, int blocks_an_sm, cudaStream_t stream, Args... args) {
    cudaError_t err = allow(d, slot, kernel, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = c;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (d->fit_smem[slot] != smem || d->fit[slot] == 0) {
        int held = 0;
        if ((err = cudaOccupancyMaxActiveClusters(&held, kernel, &cfg)) != cudaSuccess) return err;
        if (held < 1) return cudaErrorInvalidConfiguration;
        d->fit[slot] = held;
        d->fit_smem[slot] = smem;
    }
    const long long share = (long long)c * threads * EDGES_A_THREAD;
    long long clusters = (items + share - 1) / share, cap = (long long)blocks_an_sm * d->sms / c;
    if (cap > d->fit[slot]) cap = d->fit[slot];
    if (clusters > cap) clusters = cap;
    cfg.gridDim = dim3((unsigned)(c * (clusters < 1 ? 1 : clusters)));
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// blocks for n items: one a THREADS * EDGES_A_THREAD items, at most one an
// SM for private copies (each merges its copy) and four an SM otherwise
int fold_blocks(const Device* d, int n, bool priv) {
    long long want = ((long long)n + THREADS * EDGES_A_THREAD - 1) / (THREADS * EDGES_A_THREAD);
    long long cap = priv ? d->sms : 4LL * d->sms;
    return (int)(want < 1 ? 1 : (want > cap ? cap : want));
}

// the registers of nb banks of m that the filter covers, and its image's
// bytes (a nibble a register, rounded up to 16 for the bulk copy)
int filter_len(int nb, int m) { return (long long)nb * m < 2LL * FILTER_BYTES ? nb * m : 2 * FILTER_BYTES; }

int image_bytes(int nb, int m) { return (filter_len(nb, m) + 31) / 32 * 16; }

// the filter kernel's cooperative launch on a block an SM (fewer where n
// needs fewer)
template <bool DEGREE>
cudaError_t hll_launch(int slot, int* bank0, int* bank1, int nb, int m, const int* src, const int* dst,
                       const long long* keys, const bool* mask, int n, void* scratch, long long scratch_bytes,
                       cudaStream_t stream) {
    int p = log2_exact(m);
    if (p < 0 || n < 0 || !scratch || scratch_bytes < image_bytes(nb, m)) return cudaErrorInvalidValue;
    if (n == 0) return cudaSuccess;
    Device* d;
    cudaError_t err = device(&d);
    if (err != cudaSuccess) return err;
    int flen = filter_len(nb, m), bytes = image_bytes(nb, m);
    const void* kernel = reinterpret_cast<const void*>(hll_filter_kernel<DEGREE>);
    if ((err = allow(d, slot, hll_filter_kernel<DEGREE>, (size_t)bytes)) != cudaSuccess) return err;
    if (d->fit_smem[slot] != (size_t)bytes || d->fit[slot] == 0) {
        int per_sm = 0;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, FILTER_THREADS, bytes)) !=
            cudaSuccess)
            return err;
        if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
        d->fit[slot] = per_sm * d->sms;
        d->fit_smem[slot] = bytes;
    }
    const long long share = (long long)FILTER_THREADS * EDGES_A_THREAD, want = ((long long)n + share - 1) / share;
    const int blocks = (int)(want < d->sms ? want : d->sms);
    if (blocks > d->fit[slot]) return cudaErrorCooperativeLaunchTooLarge;
    uint8_t* image = static_cast<uint8_t*>(scratch);
    void* args[] = {&bank0, &bank1, &p, &flen, &image, &bytes, &src, &dst, &keys, &mask, &n};
    return cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(FILTER_THREADS), args, (size_t)bytes, stream);
}

}  // namespace

extern "C" {

// m: the scratch bytes of hll_fold_launch (nb = 1) and hll_degree_launch
// (nb = 2): the filter's image
long long hll_scratch_bytes(int nb, int m) {
    if (log2_exact(m) < 0 || nb < 1 || nb > 2) return -1;
    return image_bytes(nb, m);
}

// regs int32[m] (m a power of two; updated in place), keys int64[n] (u32
// hashes), mask bool[n] or null, n, scratch, scratch bytes, stream: the
// image kernel, then the filter kernel
int hll_fold_launch(int* regs, int m, const long long* keys, const bool* mask, int n, void* scratch,
                    long long scratch_bytes, cudaStream_t stream) {
    return (int)hll_launch<false>(0, regs, nullptr, 1, m, nullptr, nullptr, keys, mask, n, scratch, scratch_bytes,
                                  stream);
}

// verts, edges int32[m] (updated in place), m, src, dst int32[n], mask
// bool[n] or null, n, scratch, scratch bytes, stream: the image kernel,
// then the three key families in one filter kernel
int hll_degree_launch(int* verts, int* edges, int m, const int* src, const int* dst, const bool* mask, int n,
                      void* scratch, long long scratch_bytes, cudaStream_t stream) {
    return (int)hll_launch<true>(1, verts, edges, 2, m, src, dst, nullptr, mask, n, scratch, scratch_bytes, stream);
}

// grid int32[d * w] (updated in place), d, w (a power of two), keys_a
// int32[n], keys_b int32[n] or null (folded after keys_a with the same
// counts), counts int32[n] or null (1 each), mask bool[n] or null, n,
// stream: one cluster launch
int cm_fold_launch(int* grid, int d, int w, const int* keys_a, const int* keys_b, const int* counts,
                   const bool* mask, int n, cudaStream_t stream) {
    int logw = log2_exact(w);
    if (logw < 0 || d < 1 || n < 0 || (long long)d * w > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    Device* dv;
    cudaError_t err = device(&dv);
    if (err != cudaSuccess) return (int)err;
    const long long cells = (long long)d * w, room = (long long)(CM_PRIVATE_BYTES / 4);
    const int priv = (int)(cells < room ? cells : room);
    const size_t bytes = (size_t)priv * 4;
    if (priv < cells) {  // the rows not unrolled
        err = launch_clusters(dv, 16, cm_cluster_kernel<0, true>, CM_CLUSTER, CM_THREADS, bytes, n, CM_BLOCKS_AN_SM,
                              stream, grid, d, logw, priv, keys_a, keys_b, counts, mask, n);
    } else {
        switch (d) {  // the rows unrolled (the descriptors' d is at most 8): D independent hashes a key
#define CM_ROWS(D)                                                                                              \
    case D:                                                                                                     \
        err = launch_clusters(dv, 7 + D, cm_cluster_kernel<D, false>, CM_CLUSTER, CM_THREADS, bytes, n,         \
                              CM_BLOCKS_AN_SM, stream, grid, d, logw, priv, keys_a, keys_b, counts, mask, n);    \
        break;
            CM_ROWS(1) CM_ROWS(2) CM_ROWS(3) CM_ROWS(4) CM_ROWS(5) CM_ROWS(6) CM_ROWS(7) CM_ROWS(8)
#undef CM_ROWS
            default:
                err = launch_clusters(dv, 7, cm_cluster_kernel<0, false>, CM_CLUSTER, CM_THREADS, bytes, n,
                                      CM_BLOCKS_AN_SM, stream, grid, d, logw, priv, keys_a, keys_b, counts, mask, n);
        }
    }
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
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
