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
// here from the ids: every kernel reads each edge (or key) once (tri_fold
// twice for a batch past what its threads hold).  A
// descriptor's update is one C call a batch: HLLDegreeSummary's three key
// families (src and dst vertex hashes, the canonical edge hash) in one
// launch, count-min's src and dst rows in one, and SketchTriangleCount's
// sample with its distinct-edge registers in one; an emission's closure
// count is one launch.
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
// tri_fold: one cluster launch, no memset, each edge read and hashed once
// where the batch fits the threads' registers.  An edge's key is (u64(hash)
// << 32) | u32(lo ^ 0x80000000), so that one unsigned 64-bit atomicMin a
// bucket gives the least (hash, lo) with lo compared signed.  The batch
// spreads over clusters of TRI_CLUSTER blocks, one edge a thread or more,
// up to one block an SM.  Each block folds its edges into the R keys in
// shared memory and into private edge registers (a masked row or a
// self-loop as rank 0, as in the JAX package), each thread keeping its
// first TRI_HELD edges' bucket, key and hi in registers.  Then the
// block's edges equal to the block's least key of their bucket atomicMin
// their biased hi into a second table in shared memory.  After a cluster sync member r owns
// 1/TRI_CLUSTER of the buckets: it takes their lexicographic least (key,
// hi) over the members by DSMEM, and max-merges its slice of the members'
// registers into regs (one global update a register that rises), and
// merges each winner into its row with _row_take's order (the hash
// unsigned, lo and hi signed); with more than one cluster each owner
// writes its winners to scratch and the last block of its rank (an atomic
// ticket) merges the clusters' lexicographic least.  Edges past the held
// ones (a 2^21-edge batch) are read and hashed again for the hi step.  A
// masked edge, a self-loop and an edge whose sample hash is 0xFFFFFFFF
// (JAX's won = bmin != EMPTY_HASH) take no part in the sample.  At 2^16
// edges the call is set by launches and merges, not by its 512 KB of
// edges: hence one launch and no global merge of keys.
//
// tri_sampled_closures: pairs of rows that share a vertex, not every row
// pair (all R^2 are ~16.7M at R = 4096, ~7,700 of them share one).  One
// cooperative launch.  Block 0 builds, in shared memory (past CLOSURE_CAP
// rows in scratch), by counting: each valid row's incidences (one at lo,
// one at hi unless hi == lo) into R buckets by a hash of their vertex,
// and the valid rows' member hashes (JAX's sorted keys and searchsorted:
// the same test) into R buckets; scans of the counts and of each bucket's
// unordered pairs; the scatters.  Where the pairs call for more blocks it
// publishes the tables; after a grid-wide sync those blocks copy them into
// their shared memory and the blocks split the pairs evenly (a star
// sample's one bucket of R spreads over every SM).  A pair of one bucket
// counts where both incidences are on one vertex and JAX's first holding
// case (lo lo, lo hi, hi lo, hi hi) names that vertex, so a pair sharing
// two vertices counts once; JAX's ordered pairs give each unordered one
// twice, alike, so its total is twice the count.  The block sums add into
// a counter that the last block (an atomic ticket) halves into the output
// and zeroes: no memset, no second kernel.  One build, not one a block:
// each block's atomics would order the incidences its own way, and the
// blocks' slices would not partition one enumeration.  Counting, not a
// hash table claimed by compare-and-swap: shared-memory CAS is slow (~19
// us of the build at R = 4096).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <limits.h>
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

constexpr int EDGES_A_THREAD = 8;             // a block's share of the batch before another block pays off
constexpr int FILTER_THREADS = 1024;          // threads an HLL filter block
constexpr int STASH = 4;                      // edges a thread hashes before its filter is whole
constexpr int FILTER_BYTES = 96 * 1024;       // an HLL block's filter, a nibble a register (m = 2^16: 64 KB)
constexpr int CM_THREADS = 512;               // threads a count-min block
constexpr size_t CM_PRIVATE_BYTES = 96 * 1024;  // a count-min block's private grid (its first counters)
constexpr int CM_CLUSTER = 8;                 // blocks a cluster summing their private grids
constexpr int CM_BLOCKS_AN_SM = 2;            // count-min blocks an SM: 32 warps to hide the shared atomics
constexpr int TRI_THREADS = 1024;             // threads a tri_fold block
constexpr int TRI_HELD = 8;                   // edges a tri_fold thread keeps in registers for the hi step
constexpr int TRI_CLUSTER = 8;                // tri_fold blocks a cluster (each owns 1/8 of the buckets)
constexpr int TRI_EDGES_A_THREAD = 1;         // a tri_fold thread's edges before another cluster pays off
constexpr size_t TRI_SMEM = 200 * 1024;       // tri_fold's shared bytes, at most: keys and hi (R <= 16384), registers
constexpr int TRI_PRIVATE_EDGES = 16;         // a batch's edges a register before each block folds its own
constexpr int TRI_TICKETS = 16;               // the tickets at the head of tri_fold's scratch (one a member rank)
constexpr int CLOSURE_THREADS = 1024;         // threads a closure-count block
constexpr int CLOSURE_ROWS_A_BLOCK = 32;      // sample rows a closure-count block (at most one an SM)
constexpr uint32_t CLOSURE_PAIRS_A_BLOCK = 1024;  // pairs that pay for a block's copy of the tables
constexpr int CLOSURE_CAP = 4096;             // rows whose tables fit in a block's shared memory (the descriptors' cap)
constexpr int CLOSURE_MAX = 8192;             // rows the closure count takes (past the cap, the tables in scratch)
constexpr int NO_SLOT = 0xFFFF;
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

__device__ __forceinline__ void fill(int* a, int n, int v) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = v;
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

// edge e's canonical (lo, hi), and whether it takes part in the sample
// (kept by the mask, not a self-loop)
__device__ __forceinline__ bool tri_edge(int e, const int* __restrict__ src, const int* __restrict__ dst,
                                         const bool* __restrict__ mask, int& lo, int& hi) {
    const int u = src[e], v = dst[e];
    lo = min(u, v);
    hi = max(u, v);
    return kept(mask, e) && lo != hi;
}

// an edge register's update: rank clz(h >> p) - p + 1 where the edge takes
// part, 0 where it does not (JAX's where(mask, rank, 0): a masked row or a
// self-loop raises a register below 0 to 0), issued where it raises r[idx]
template <bool PRIVATE>
__device__ __forceinline__ void edge_reg_put(int* r, int p, uint32_t h, bool in) {
    const int idx = (int)(h & ((1u << p) - 1));
    const int rank = in ? __clz((int)(h >> p)) - p + 1 : 0;
    if (rank > (PRIVATE ? r[idx] : __ldcg(r + idx))) atomicMax(r + idx, rank);
}

// edge e into the block's keys and edge registers (r: private, or regs
// itself; null: none); its bucket (-1: no part in the sample), key and
// biased hi out
template <bool PRIVATE>
__device__ __forceinline__ void tri_fold_edge(int e, const int* src, const int* dst, const bool* mask, int rows,
                                              int* r, int p, unsigned long long* keys, int& b,
                                              unsigned long long& key, unsigned& bhi) {
    int lo, hi;
    const bool in = tri_edge(e, src, dst, mask, lo, hi);
    if (r) edge_reg_put<PRIVATE>(r, p, hash_pair(lo, hi, SALT_EDGE_HLL), in);
    b = -1;
    if (in && tri_key(lo, hi, rows, b, key)) {
        if (key < keys[b]) atomicMin(keys + b, key);
        bhi = (uint32_t)hi ^ SIGN;
    } else {
        b = -1;
    }
}

// an edge's hi offered to its block's bucket where its key is the block's
// least
__device__ __forceinline__ void tri_offer_hi(const unsigned long long* keys, unsigned* shi, int b,
                                             unsigned long long key, unsigned bhi) {
    if (key == keys[b]) atomicMin(shi + b, bhi);
}

// bucket b's winner (key NO_KEY: none, the row (EMPTY_HASH, -1, -1))
// merged into its row (ah, alo, ahi, read by the caller ahead) where it
// precedes it on (hash unsigned, lo, hi signed): _row_take's order
__device__ __forceinline__ void tri_take(long long* eh, int* elo, int* ehi, int b, unsigned long long k,
                                         unsigned bhi, long long ah, int alo, int ahi) {
    long long wh = EMPTY_HASH;
    int wlo = -1, whi = -1;
    if (k != NO_KEY) {
        wh = (long long)(k >> 32);
        wlo = (int)((uint32_t)k ^ SIGN);
        whi = (int)(bhi ^ SIGN);
    }
    if (wh < ah || (wh == ah && (wlo < alo || (wlo == alo && whi < ahi)))) {
        eh[b] = wh;
        elo[b] = wlo;
        ehi[b] = whi;
    }
}

// tri_fold: G clusters of TRI_CLUSTER blocks; member me owns buckets [me *
// per, + per) and registers [mfirst, mlast).  Shared: the R keys, each
// bucket's least biased hi among the block's edges equal to its key [R],
// then (PRIVATE) the block's edge registers [m] (INT_MIN: untouched).  Two
// cluster syncs: the members' keys, hi and registers whole; the owners'
// reads done.  With G > 1 each owner writes its buckets' (key, hi) to
// scratch row c, and the last of the G blocks of rank me (a ticket, reset
// by it) merges the lexicographic least of the G rows.
template <bool PRIVATE>
__global__ void __launch_bounds__(TRI_THREADS, 1) tri_cluster_kernel(long long* eh, int* elo, int* ehi, int rows,
                                                                     int* regs, int p, const int* __restrict__ src,
                                                                     const int* __restrict__ dst,
                                                                     const bool* __restrict__ mask, int n,
                                                                     unsigned long long* wkey, unsigned* whi,
                                                                     unsigned* tickets) {
    constexpr int cs = TRI_CLUSTER;
    extern __shared__ __align__(16) unsigned long long tri_keys[];
    __shared__ bool last;
    cg::cluster_group cl = cg::this_cluster();
    const int me = (int)cl.block_rank();
    const int per = rows > cs ? rows / cs : 1, base = me * per, end = min(rows, base + per);
    const int m = regs ? 1 << p : 0, mper = (m + cs - 1) / cs, mfirst = min(m, me * mper);
    const int mlast = min(m, mfirst + mper);
    const int g = gridDim.x / cs;
    unsigned* shi = reinterpret_cast<unsigned*>(tri_keys + rows);
    int* sregs = reinterpret_cast<int*>(shi + rows);
    for (int i = threadIdx.x; i < rows; i += blockDim.x) {
        tri_keys[i] = NO_KEY;
        shi[i] = ~0u;
    }
    if (PRIVATE) fill(sregs, m, INT_MIN);
    __syncthreads();
    int* r = PRIVATE ? sregs : regs;
    const int stride = gridDim.x * blockDim.x, first = blockIdx.x * blockDim.x + threadIdx.x;
    int hb[TRI_HELD];
    unsigned long long hk[TRI_HELD];
    unsigned hh[TRI_HELD];
#pragma unroll
    for (int k = 0; k < TRI_HELD; ++k) {
        hb[k] = -1;
        if (first + k * stride < n)
            tri_fold_edge<PRIVATE>(first + k * stride, src, dst, mask, rows, r, p, tri_keys, hb[k], hk[k], hh[k]);
    }
    for (int e = first + TRI_HELD * stride; e < n; e += stride) {
        int b;
        unsigned long long key;
        unsigned bhi;
        tri_fold_edge<PRIVATE>(e, src, dst, mask, rows, r, p, tri_keys, b, key, bhi);
    }
    __syncthreads();  // the block's keys whole
#pragma unroll
    for (int k = 0; k < TRI_HELD; ++k)
        if (hb[k] >= 0) tri_offer_hi(tri_keys, shi, hb[k], hk[k], hh[k]);
    for (int e = first + TRI_HELD * stride; e < n; e += stride) {  // past the held edges: read and hashed again
        int lo, hi, b;
        unsigned long long key;
        if (tri_edge(e, src, dst, mask, lo, hi) && tri_key(lo, hi, rows, b, key))
            tri_offer_hi(tri_keys, shi, b, key, (uint32_t)hi ^ SIGN);
    }
    cl.sync();  // every member's keys, hi and registers whole
    const size_t row = (size_t)(blockIdx.x / cs) * rows;
    const int span = max(end - base, mlast - mfirst);
    for (int x = threadIdx.x; x < span; x += blockDim.x) {
        if (x < end - base) {  // the cluster's lexicographic least (key, hi) of bucket b
            const int b = base + x;
            long long ah = 0;
            int alo = 0, ahi = 0;
            if (g == 1) {  // the row, read ahead of the members' keys
                ah = eh[b];
                alo = elo[b];
                ahi = ehi[b];
            }
            unsigned long long kt[cs];
            unsigned ht[cs];
#pragma unroll
            for (int t = 0; t < cs; ++t) {
                kt[t] = cl.map_shared_rank(tri_keys, t)[b];
                ht[t] = cl.map_shared_rank(shi, t)[b];
            }
            unsigned long long k = kt[0];
            unsigned h = ht[0];
#pragma unroll
            for (int t = 1; t < cs; ++t)
                if (kt[t] < k || (kt[t] == k && ht[t] < h)) {
                    k = kt[t];
                    h = ht[t];
                }
            if (g == 1) {
                tri_take(eh, elo, ehi, b, k, h, ah, alo, ahi);
            } else {
                wkey[row + b] = k;
                whi[row + b] = h;
            }
        }
        if (PRIVATE && x < mlast - mfirst) {  // the members' registers into regs
            const int i = mfirst + x;
            int vt[cs];
#pragma unroll
            for (int t = 0; t < cs; ++t) vt[t] = cl.map_shared_rank(sregs, t)[i];
            const int now = __ldcg(regs + i);
            int v = INT_MIN;
#pragma unroll
            for (int t = 0; t < cs; ++t) v = max(v, vt[t]);
            if (v > now) atomicMax(regs + i, v);
        }
    }
    cl.sync();  // no member's shared memory is read by another after this
    if (g == 1 || base >= end) return;  // one cluster, or no buckets and no ticket
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(tickets + me, 1u) == (unsigned)(g - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int b = base + threadIdx.x; b < end; b += blockDim.x) {
        const long long ah = eh[b];  // the row, read ahead of the clusters' winners
        const int alo = elo[b], ahi = ehi[b];
        unsigned long long k = NO_KEY;
        unsigned h = ~0u;
#pragma unroll 4
        for (int c = 0; c < g; ++c) {
            const unsigned long long kc = __ldcg(wkey + (size_t)c * rows + b);
            const unsigned hc = __ldcg(whi + (size_t)c * rows + b);
            if (kc < k || (kc == k && hc < h)) {
                k = kc;
                h = hc;
            }
        }
        tri_take(eh, elo, ehi, b, k, h, ah, alo, ahi);
    }
    if (threadIdx.x == 0) tickets[me] = 0;
}

// a read of the closure count's tables: through L2 where they are in
// device memory (atomics update them there, so an L1 line may be stale)
template <bool GLOBAL, typename T>
__device__ __forceinline__ T rd(const T* p) {
    if (GLOBAL) return __ldcg(p);
    return *p;
}

// The closure count's tables for R rows: I = 2R incidences (row i's lo is
// incidence 2i, its hi 2i + 1) in R buckets by a hash of their vertex,
// the member hashes in R buckets by their low bits.  Built by counting
// (shared atomic adds, no compare-and-swap: a swap loop over 8,192
// incidences and 4,096 member hashes took ~19 us of one SM).  In words:
// lo, hi, bstart, bpref, mstart, mset, then grp (u16), which the pair loop
// reads (its first 7R + 4 words, the part copied to every block); then
// irank, ibucket and mrank (u16), which only the build uses; 40R + 16
// bytes.
struct ClosureTables {
    int* lo;           // [R] the sample's rows
    int* hi;           // [R]
    uint32_t* bstart;  // [R + 1] a bucket's incidences (counts, then the first's place; [R] the total)
    uint32_t* bpref;   // [R + 1] the unordered pairs of the buckets before it ([R] the total)
    uint32_t* mstart;  // [R + 1] a member bucket's hashes (counts, then the first's place)
    uint32_t* mset;    // [R] the valid rows' member hashes (not EMPTY_HASH), bucket by bucket
    uint16_t* grp;     // [I] the incidences, bucket by bucket
    uint16_t* irank;   // [I] an incidence's place in its bucket (NO_SLOT: no incidence)
    uint16_t* ibucket; // [I] an incidence's bucket
    uint16_t* mrank;   // [R] a member hash's place in its bucket (NO_SLOT: none)
};

__host__ __device__ constexpr size_t closure_table_bytes(int rows) { return (size_t)rows * 40 + 16; }

__host__ __device__ constexpr size_t closure_read_bytes(int rows) { return (size_t)rows * 28 + 16; }

__device__ __forceinline__ ClosureTables closure_tables(void* base, int rows) {
    ClosureTables t;
    uint32_t* w = static_cast<uint32_t*>(base);
    t.lo = reinterpret_cast<int*>(w);
    t.hi = t.lo + rows;
    t.bstart = w + 2 * rows;
    t.bpref = t.bstart + rows + 1;
    t.mstart = t.bpref + rows + 1;
    t.mset = t.mstart + rows + 1;
    t.grp = reinterpret_cast<uint16_t*>(w + 6 * rows + 4);
    t.irank = reinterpret_cast<uint16_t*>(w + 7 * rows + 4);
    t.ibucket = reinterpret_cast<uint16_t*>(w + 8 * rows + 4);
    t.mrank = reinterpret_cast<uint16_t*>(w + 9 * rows + 4);
    return t;
}

// vertex v's incidence bucket of R
__device__ __forceinline__ int vertex_bucket(int v, int rows) { return (int)(mix32((uint32_t)v) & (uint32_t)(rows - 1)); }

// exclusive scans in place of two count arrays over the same n buckets
// (each count's start; [n]: the total): the incidences' (cnt, with the
// exclusive scan of c (c - 1) / 2 into pref[0, n]) and the member
// hashes' (mcnt).  Each warp a segment in order, 32 entries a step (no
// bank conflict).
template <bool GLOBAL>
__device__ __forceinline__ void block_scan_counts(uint32_t* cnt, uint32_t* pref, uint32_t* mcnt, int n) {
    __shared__ uint32_t wsum[CLOSURE_THREADS / 32][3], total[3];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int seg = ((n + nw - 1) / nw + 31) & ~31, first = min(n, w * seg), last = min(n, first + seg);
    uint32_t s[3] = {0, 0, 0};
    for (int i = first + lane; i < last; i += 32) {
        const uint32_t c = rd<GLOBAL>(cnt + i);
        s[0] += c;
        s[1] += c * (c - 1) / 2;
        s[2] += rd<GLOBAL>(mcnt + i);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        for (int off = 16; off; off >>= 1) s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
        if (lane == 0) wsum[w][k] = s[k];
    }
    __syncthreads();
    if (w == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            uint32_t x = lane < nw ? wsum[lane][k] : 0;
            const uint32_t own = x;
            for (int off = 1; off < 32; off <<= 1) {
                const uint32_t y = __shfl_up_sync(0xffffffffu, x, off);
                if (lane >= off) x += y;
            }
            if (lane < nw) wsum[lane][k] = x - own;
            if (lane == 31) total[k] = x;
        }
    }
    __syncthreads();
    uint32_t r[3] = {wsum[w][0], wsum[w][1], wsum[w][2]};
    for (int step = first; step < last; step += 32) {
        const int i = step + lane;
        uint32_t v[3] = {0, 0, 0};
        if (i < last) {
            v[0] = rd<GLOBAL>(cnt + i);
            v[1] = v[0] * (v[0] - 1) / 2;
            v[2] = rd<GLOBAL>(mcnt + i);
        }
        uint32_t x[3] = {v[0], v[1], v[2]};
#pragma unroll
        for (int k = 0; k < 3; ++k)
            for (int off = 1; off < 32; off <<= 1) {
                const uint32_t y = __shfl_up_sync(0xffffffffu, x[k], off);
                if (lane >= off) x[k] += y;
            }
        if (i < last) {
            cnt[i] = r[0] + x[0] - v[0];
            pref[i] = r[1] + x[1] - v[1];
            mcnt[i] = r[2] + x[2] - v[2];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) r[k] += __shfl_sync(0xffffffffu, x[k], 31);
    }
    if (threadIdx.x == 0) {
        cnt[n] = total[0];
        pref[n] = total[1];
        mcnt[n] = total[2];
    }
}

// key among the valid rows' member hashes (key is not EMPTY_HASH)
template <bool GLOBAL>
__device__ __forceinline__ bool is_member(const ClosureTables& t, int rows, uint32_t key) {
    const int mb = (int)(key & (uint32_t)(rows - 1));
    for (uint32_t i = rd<GLOBAL>(t.mstart + mb), e = rd<GLOBAL>(t.mstart + mb + 1); i < e; ++i)
        if (rd<GLOBAL>(t.mset + i) == key) return true;
    return false;
}

// the unordered pair of incidences a and b of one bucket (distinct rows):
// 1 where both are on one vertex x, JAX's ordered pair (i, j), i the lower
// row, shares x by its first holding case (lo lo, lo hi, hi lo, hi hi),
// its other endpoints differ, and their edge's member hash is a valid
// row's.  (i, j) and (j, i) give the same answer (their first cases
// differ only where lo_i == hi_j and hi_i == lo_j, and then the other
// endpoints are equal), so the unordered pairs count half of JAX's total.
template <bool GLOBAL>
__device__ __forceinline__ uint32_t pair_closes(const ClosureTables& t, int rows, int a, int b) {
    const int ra = a >> 1, rb = b >> 1;
    const int x = rd<GLOBAL>((a & 1 ? t.hi : t.lo) + ra);
    if (rd<GLOBAL>((b & 1 ? t.hi : t.lo) + rb) != x) return 0;  // another vertex of the bucket
    const int i = min(ra, rb), j = max(ra, rb);
    const int li = rd<GLOBAL>(t.lo + i), hi_i = rd<GLOBAL>(t.hi + i);
    const int lj = rd<GLOBAL>(t.lo + j), hj = rd<GLOBAL>(t.hi + j);
    int u, v, shared;
    if (li == lj) {
        u = hi_i, v = hj, shared = li;
    } else if (li == hj) {
        u = hi_i, v = lj, shared = li;
    } else if (hi_i == lj) {
        u = li, v = hj, shared = hi_i;
    } else {  // hi_i == hj: both rows hold x, so one of the four holds
        u = li, v = lj, shared = hi_i;
    }
    if (shared != x || u == v) return 0;
    const uint32_t key = hash_pair(min(u, v), max(u, v), SALT_MEMBER);
    return key != EMPTY_HASH && is_member<GLOBAL>(t, rows, key);
}

// the tables built by one block, by counting: the rows; each valid row's
// incidences (one at lo, one at hi unless hi == lo) counted into their
// vertex's bucket and each member hash into its bucket, each taking its
// place from the count's atomic add; one scan of both counts (and of the
// buckets' pairs); the scatter into buckets.  The totals land in
// bstart[R], bpref[R] (block-visible after a __syncthreads).
template <bool GLOBAL>
__device__ __forceinline__ void closure_build(const ClosureTables& t, const int* __restrict__ elo,
                                              const int* __restrict__ ehi, int rows) {
    const int nthreads = blockDim.x, tid = threadIdx.x, incidences = 2 * rows;
    for (int i = tid; i < rows; i += nthreads) {
        t.lo[i] = elo[i];
        t.hi[i] = ehi[i];
        t.bstart[i] = 0;
        t.mstart[i] = 0;
    }
    __syncthreads();
    for (int id = tid; id < incidences; id += nthreads) {
        const int row = id >> 1, l = rd<GLOBAL>(t.lo + row), h = rd<GLOBAL>(t.hi + row);
        int rank = NO_SLOT;
        if (l != -1 && !((id & 1) && h == l)) {  // a valid row; a row with lo == hi has one incidence
            const int b = vertex_bucket(id & 1 ? h : l, rows);
            rank = (int)atomicAdd(t.bstart + b, 1u);
            t.ibucket[id] = (uint16_t)b;
        }
        t.irank[id] = (uint16_t)rank;
    }
    for (int row = tid; row < rows; row += nthreads) {
        const int l = rd<GLOBAL>(t.lo + row), h = rd<GLOBAL>(t.hi + row);
        int rank = NO_SLOT;
        if (l != -1) {
            const uint32_t key = hash_pair(l, h, SALT_MEMBER);
            if (key != EMPTY_HASH) rank = (int)atomicAdd(t.mstart + (key & (uint32_t)(rows - 1)), 1u);
        }
        t.mrank[row] = (uint16_t)rank;
    }
    __syncthreads();
    block_scan_counts<GLOBAL>(t.bstart, t.bpref, t.mstart, rows);
    __syncthreads();
    for (int id = tid; id < incidences; id += nthreads) {
        const int rank = rd<GLOBAL>(t.irank + id);
        if (rank != NO_SLOT) t.grp[rd<GLOBAL>(t.bstart + rd<GLOBAL>(t.ibucket + id)) + rank] = (uint16_t)id;
    }
    for (int row = tid; row < rows; row += nthreads) {
        const int rank = rd<GLOBAL>(t.mrank + row);
        if (rank == NO_SLOT) continue;
        const uint32_t key = hash_pair(rd<GLOBAL>(t.lo + row), rd<GLOBAL>(t.hi + row), SALT_MEMBER);
        t.mset[rd<GLOBAL>(t.mstart + (key & (uint32_t)(rows - 1))) + rank] = key;
    }
}

// the blocks that test pairs: one a CLOSURE_PAIRS_A_BLOCK pairs (a block
// below that would spend more on copying the tables than on its pairs), at
// most the grid
__device__ __forceinline__ int closure_blocks(uint32_t pairs, int grid) {
    return min(grid, max(1, (int)((pairs + CLOSURE_PAIRS_A_BLOCK - 1) / CLOSURE_PAIRS_A_BLOCK)));
}

// tri_sampled_closures: one cooperative launch.  Block 0 builds the tables
// (in its shared memory, or past CLOSURE_CAP rows in scratch) and, where
// other blocks will test pairs, publishes what the pair loop reads; after
// a grid-wide sync each of closure_blocks(pairs) blocks holds that one
// copy (in shared memory, or reads scratch) and tests its slice of the
// unordered pairs of the buckets, a thread a run of consecutive pairs (a
// search for the first's bucket, then a walk); the others leave.  One
// build, not one a block: a block's atomics order its incidences, so
// slices of tables built apart would not partition one enumeration.  The
// block sums go into head[0] (u32, wrapping as JAX's int32 sum), and the
// last block (ticket head[1]) writes JAX's total // 2 (the total is twice
// the unordered count, mod 2^32) and zeroes both; head[2]: the pairs.
template <bool GLOBAL>
__global__ void __launch_bounds__(CLOSURE_THREADS, 1) closures_kernel(const int* __restrict__ elo,
                                                                      const int* __restrict__ ehi, int rows, int* out,
                                                                      unsigned* head, uint8_t* published) {
    extern __shared__ __align__(16) uint32_t closure_smem[];
    __shared__ uint32_t sums[CLOSURE_THREADS / 32];
    const ClosureTables t = closure_tables(GLOBAL ? published : reinterpret_cast<uint8_t*>(closure_smem), rows);
    const int nthreads = blockDim.x, tid = threadIdx.x, buckets = rows;
    const int words = (int)(closure_read_bytes(rows) / 16);
    if (blockIdx.x == 0) {
        closure_build<GLOBAL>(t, elo, ehi, rows);
        __syncthreads();
        const uint32_t all = rd<GLOBAL>(t.bpref + buckets);
        if (tid == 0) head[2] = all;
        if (!GLOBAL && closure_blocks(all, gridDim.x) > 1) {  // others will read the tables
            const uint4* from = reinterpret_cast<const uint4*>(closure_smem);
            for (int i = tid; i < words; i += nthreads) reinterpret_cast<uint4*>(published)[i] = from[i];
        }
        __threadfence();
    }
    cg::this_grid().sync();  // the tables are whole
    const uint32_t pairs = __ldcg(head + 2);
    const int active = closure_blocks(pairs, gridDim.x);
    if ((int)blockIdx.x >= active) return;
    if (!GLOBAL && blockIdx.x != 0) {
        const uint4* from = reinterpret_cast<const uint4*>(published);
        for (int i = tid; i < words; i += nthreads) reinterpret_cast<uint4*>(closure_smem)[i] = __ldcg(from + i);
        __syncthreads();
    }
    const uint32_t qa = (uint32_t)((unsigned long long)pairs * blockIdx.x / active);
    const uint32_t span = (uint32_t)((unsigned long long)pairs * (blockIdx.x + 1) / active) - qa;
    const uint32_t each = (span + nthreads - 1) / nthreads;
    uint32_t q = qa + min(span, tid * each);
    const uint32_t qend = qa + min(span, (tid + 1) * each);
    uint32_t count = 0;
    if (q < qend) {
        int k = 0;  // the last bucket whose pairs start at or before q (the one holding it)
        for (int top = buckets - 1; k < top;) {
            const int mid = (k + top + 1) >> 1;
            if (rd<GLOBAL>(t.bpref + mid) <= q)
                k = mid;
            else
                top = mid - 1;
        }
        const uint32_t r = q - rd<GLOBAL>(t.bpref + k);  // r = v (v - 1) / 2 + u, 0 <= u < v
        uint32_t v = (uint32_t)((1.0f + sqrtf(8.0f * (float)r + 1.0f)) * 0.5f);
        while (v * (v - 1) / 2 > r) --v;
        while ((v + 1) * v / 2 <= r) ++v;
        uint32_t u = r - v * (v - 1) / 2, start = rd<GLOBAL>(t.bstart + k);
        uint32_t g = rd<GLOBAL>(t.bstart + k + 1) - start;
        for (;;) {
            count += pair_closes<GLOBAL>(t, rows, rd<GLOBAL>(t.grp + start + u), rd<GLOBAL>(t.grp + start + v));
            if (++q == qend) break;
            if (++u == v) {
                u = 0;
                if (++v == g) {  // the next bucket with a pair
                    do {
                        start = rd<GLOBAL>(t.bstart + ++k);
                        g = rd<GLOBAL>(t.bstart + k + 1) - start;
                    } while (g < 2);
                    v = 1;
                }
            }
        }
    }
    for (int off = 16; off; off >>= 1) count += __shfl_down_sync(0xffffffffu, count, off);
    if ((tid & 31) == 0) sums[tid >> 5] = count;
    __syncthreads();
    if (tid == 0) {
        uint32_t sum = 0;
        for (int w = 0; w < nthreads / 32; ++w) sum += sums[w];
        if (sum) atomicAdd(head, sum);
        __threadfence();
        if (atomicAdd(head + 1, 1u) == (unsigned)active - 1) {
            __threadfence();
            const uint32_t total = atomicExch(head, 0u);
            head[1] = 0;
            *out = (int)(2u * total) >> 1;  // JAX's int32 total (twice the unordered count) // 2, flooring
        }
    }
}

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
    if (bytes <= 40 * 1024 || bytes <= d->smem[slot]) return cudaSuccess;  // 48 KB less room for static shared
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) d->smem[slot] = bytes;
    return err;
}

// kernel (slot: its index in Device's arrays) in clusters of c blocks of
// threads, smem dynamic bytes each: one cluster a c * threads *
// items_a_thread items, as many as the card holds at once and at most
// blocks_an_sm * SMs / c.  A cluster shape or size the card refuses is an
// error (cudaErrorInvalidConfiguration where it holds no cluster).
template <typename... Params, typename... Args>
cudaError_t launch_clusters(Device* d, int slot, void (*kernel)(Params...), int c, int threads, size_t smem,
                            long long items, int items_a_thread, int blocks_an_sm, cudaStream_t stream,
                            Args... args) {
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
    const long long share = (long long)c * threads * items_a_thread;
    long long clusters = (items + share - 1) / share, cap = (long long)blocks_an_sm * d->sms / c;
    if (cap > d->fit[slot]) cap = d->fit[slot];
    if (clusters > cap) clusters = cap;
    cfg.gridDim = dim3((unsigned)(c * (clusters < 1 ? 1 : clusters)));
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// the most clusters one tri_fold launch takes: launch_clusters' cap at one
// block an SM
int tri_clusters_max(const Device* d) { return d->sms / TRI_CLUSTER > 1 ? d->sms / TRI_CLUSTER : 1; }

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
        err = launch_clusters(dv, 16, cm_cluster_kernel<0, true>, CM_CLUSTER, CM_THREADS, bytes, n, EDGES_A_THREAD,
                              CM_BLOCKS_AN_SM, stream, grid, d, logw, priv, keys_a, keys_b, counts, mask, n);
    } else {
        switch (d) {  // the rows unrolled (the descriptors' d is at most 8): D independent hashes a key
#define CM_ROWS(D)                                                                                              \
    case D:                                                                                                     \
        err = launch_clusters(dv, 7 + D, cm_cluster_kernel<D, false>, CM_CLUSTER, CM_THREADS, bytes, n,         \
                              EDGES_A_THREAD, CM_BLOCKS_AN_SM, stream, grid, d, logw, priv, keys_a, keys_b,      \
                              counts, mask, n);                                                                 \
        break;
            CM_ROWS(1) CM_ROWS(2) CM_ROWS(3) CM_ROWS(4) CM_ROWS(5) CM_ROWS(6) CM_ROWS(7) CM_ROWS(8)
#undef CM_ROWS
            default:
                err = launch_clusters(dv, 7, cm_cluster_kernel<0, false>, CM_CLUSTER, CM_THREADS, bytes, n,
                                      EDGES_A_THREAD, CM_BLOCKS_AN_SM, stream, grid, d, logw, priv, keys_a, keys_b,
                                      counts, mask, n);
        }
    }
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// rows: the scratch bytes of tri_fold_launch on the current device: the
// tickets, then each cluster's winners (keys u64[R], then the biased hi
// u32[R]), for as many clusters as one launch takes (-1: R not a power of
// two, or no device)
long long tri_fold_scratch_bytes(int rows) {
    Device* d;
    if (log2_exact(rows) < 0 || device(&d) != cudaSuccess) return -1;
    return TRI_TICKETS * 4 + (long long)tri_clusters_max(d) * rows * 12;
}

// eh int64[R], elo, ehi int32[R] (updated in place), R (a power of two),
// regs int32[m] or null (the distinct-edge registers: rank 0 for a masked
// row or a self-loop), m, src, dst int32[n], mask bool[n] or null, n,
// scratch (its tickets zero), scratch bytes, stream: one cluster launch
int tri_fold_launch(long long* eh, int* elo, int* ehi, int rows, int* regs, int m, const int* src, const int* dst,
                    const bool* mask, int n, void* scratch, long long scratch_bytes, cudaStream_t stream) {
    const int p = regs ? log2_exact(m) : 0;
    Device* d;
    cudaError_t err = device(&d);
    if (err != cudaSuccess) return (int)err;
    const int clusters = tri_clusters_max(d);
    if (log2_exact(rows) < 0 || p < 0 || n < 0 || !scratch ||
        scratch_bytes < TRI_TICKETS * 4 + (long long)clusters * rows * 12)
        return (int)cudaErrorInvalidValue;
    const size_t keys = (size_t)rows * 12;
    if (keys > TRI_SMEM) return (int)cudaErrorInvalidValue;
    // private registers pay for their merge where the batch is large beside them; a smaller batch folds
    // into regs directly (a read in L2 an edge, an atomic where a rank rises)
    const bool priv = regs && keys + (size_t)m * 4 <= TRI_SMEM && (long long)n >= (long long)TRI_PRIVATE_EDGES * m;
    const size_t bytes = keys + (priv ? (size_t)m * 4 : 0);
    unsigned* tickets = static_cast<unsigned*>(scratch);
    unsigned long long* wkey = reinterpret_cast<unsigned long long*>(tickets + TRI_TICKETS);
    unsigned* whi = reinterpret_cast<unsigned*>(wkey + (size_t)clusters * rows);
    err = priv ? launch_clusters(d, 3, tri_cluster_kernel<true>, TRI_CLUSTER, TRI_THREADS, bytes, n,
                                 TRI_EDGES_A_THREAD, 1, stream, eh, elo, ehi, rows, regs, p, src, dst, mask, n, wkey,
                                 whi, tickets)
               : launch_clusters(d, 4, tri_cluster_kernel<false>, TRI_CLUSTER, TRI_THREADS, bytes, n,
                                 TRI_EDGES_A_THREAD, 1, stream, eh, elo, ehi, rows, regs, p, src, dst, mask, n, wkey,
                                 whi, tickets);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// rows: the scratch bytes of tri_closures_launch: the sum, the ticket and
// the pairs, then the tables as one block built them (-1: R not a power of
// two, or past CLOSURE_MAX)
long long tri_closures_scratch_bytes(int rows) {
    if (log2_exact(rows) < 0 || rows > CLOSURE_MAX) return -1;
    return 16 + (long long)closure_table_bytes(rows);
}

// elo, ehi int32[R] (R a power of two, at most CLOSURE_MAX), R, out
// int32[1] (the closed-wedge count // 2), scratch (its first 8 bytes
// zero; the last block leaves them so), scratch bytes, stream: one
// cooperative launch, R / CLOSURE_ROWS_A_BLOCK blocks, at most one an SM
int tri_closures_launch(const int* elo, const int* ehi, int rows, int* out, void* scratch, long long scratch_bytes,
                        cudaStream_t stream) {
    const long long need = tri_closures_scratch_bytes(rows);
    if (need < 0 || !out || !scratch || scratch_bytes < need) return (int)cudaErrorInvalidValue;
    Device* d;
    cudaError_t err = device(&d);
    if (err != cudaSuccess) return (int)err;
    const bool global = rows > CLOSURE_CAP;
    const int slot = global ? 6 : 5;
    const size_t bytes = global ? 0 : closure_table_bytes(rows);
    const void* kernel = global ? reinterpret_cast<const void*>(closures_kernel<true>)
                                : reinterpret_cast<const void*>(closures_kernel<false>);
    if (!global && (err = allow(d, slot, closures_kernel<false>, bytes)) != cudaSuccess) return (int)err;
    if (d->fit_smem[slot] != bytes || d->fit[slot] == 0) {
        int per_sm = 0;
        if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, CLOSURE_THREADS, bytes)) !=
            cudaSuccess)
            return (int)err;
        if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
        d->fit[slot] = per_sm * d->sms;
        d->fit_smem[slot] = bytes;
    }
    const int blocks = min(max(1, min(d->sms, rows / CLOSURE_ROWS_A_BLOCK)), d->fit[slot]);
    unsigned* head = static_cast<unsigned*>(scratch);
    uint8_t* published = static_cast<uint8_t*>(scratch) + 16;
    void* args[] = {&elo, &ehi, &rows, &out, &head, &published};
    return (int)cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(CLOSURE_THREADS), args, bytes, stream);
}

}  // extern "C"
