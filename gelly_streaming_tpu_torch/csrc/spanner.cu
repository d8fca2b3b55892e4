// The spanner's batch admission on Hopper (sm_90a), behind a plain C interface.
//
// Replaces the JAX package's `_admit_batch` (gelly_streaming_tpu/library/
// spanner.py:90-144): the `lax.map` pre-filter `_within_k_prefilter`
// (:63-87) and the `while_loop` that resolves the surviving candidates one
// after another with an exact distance test (summaries/adjacency.py:
// `within_two`, `within_k_balls` or `bounded_bfs`) and `add_undirected_edge`.
//
// One C call a batch, two kernels:
//  * prepass_kernel, a warp an edge (grid-stride), both tests against the
//    table T0 as it stood before the batch:
//     - the capped test, as the JAX package's pre-filter computes it on the
//       raw ids: the ball of radius ceil(k/2) around u and the one of radius
//       k - ceil(k/2) around v, each `expand_balls` under `cap` (each round
//       appends the row of every entry, an entry below 0 giving -1s, one at
//       or past C row C - 1, then keeps the first `cap`); an id >= 0 in
//       both kills the edge.  The rest are the JAX package's candidates.
//     - on a candidate, the walk's own exact test (`within_two`, the balls
//       under their "exact" caps sum_{i <= r} D^i, truncation included, or
//       `bounded_bfs`) on the ids as the walk takes them (clamped below at
//       0).  The table only grows (`add_undirected_edge` appends at `deg`),
//       so a ball's positions only turn from -1 into ids and every body's
//       answer only turns from "not within" to "within": an edge within k
//       on T0 is rejected by the walk whatever the batch admits before it.
//       The others, the survivors, are flagged.
//  * walk_kernel, one block: the survivors in arrival order (a chunk of
//    1024 flags compacted by a scan, its ids loaded while the chunk before
//    is walked), each the exact test on the table as the batch has changed
//    it, then the insert by one thread under `add_undirected_edge`'s rules.
//    The table and the deg array sit in shared memory where they fit (C x
//    D x 4 + C x 4 bytes beside the test's scratch), else in the L2.
//    `within_two` runs on one warp (warp syncs only); the balls and the BFS
//    on the whole block.
//
// Every test sizes its work by what the rows hold: a ball keeps the
// positions of its rounds but the last (at radius 2, u and its row), and
// reads the rows of the last round's live parents only; membership goes
// through an open-addressing hash in shared memory (the set side: v's
// ball), or a bitmap of [0, C) (`within_two`'s v row, up to C = 2^16, else
// the hash; the BFS, with the list of the ids it reached, which also
// clears the bitmap).  A test stops reading rows once one thread has found
// a hit.
//
// What bounds it: the pre-pass reads two balls' rows an edge (at k = 3, D =
// 64, 1 + 64 rows for u's radius-2 ball), all in parallel; the walk is a
// serial chain, one survivor after another, each a few syncs plus its
// rows' latency.
//
// Ids: the capped test uses the raw ids; the exact tests and the inserts
// clamp them below at 0 (`jnp.maximum`), then gathers clamp to C - 1 and
// scatters past C drop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WALK_THREADS = 256;
constexpr int WALK_FLAGS = 4;  // survivor flags a walk thread compacts a chunk
constexpr int WALK_CHUNK = WALK_THREADS * WALK_FLAGS;
constexpr int PRE_WARPS_MAX = 8;      // warps a pre-pass block
constexpr int PRE_BLOCKS_MAX = 2048;
constexpr int PRE_GLOBAL_WARPS = 528;  // most warps when their scratch lives in global memory
constexpr long long SMEM_LIMIT = 200 * 1024;       // dynamic shared bytes of a pre-pass block
constexpr long long WALK_SMEM_LIMIT = 216 * 1024;  // of the walk block (its 8 KB of static arrays beside)
constexpr long long GLOBAL_SCRATCH_LIMIT = 1ll << 28;  // bytes of pre-pass scratch in global memory
constexpr long long BALL_LIMIT = 1ll << 28;  // entries a full ball may hold
constexpr int UNROLL = 4;                    // row loads a thread keeps in flight
constexpr int BITMAP_IDS = 1 << 16;          // within_two's bitmap of [0, C) up to this C

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

// A group that runs one test: a warp (the pre-pass, the walk's within_two)
// or the walk's block.  `flag` is the group's hit flag.
struct Warp {
    int tid;
    int* flag;
    static constexpr int n = 32;
    __device__ void sync() const { __syncwarp(); }
    __device__ bool any(bool p) const { return __any_sync(FULL, p); }
};

struct Block {
    int tid;
    int* flag;
    static constexpr int n = WALK_THREADS;
    __device__ void sync() const { __syncthreads(); }
    __device__ bool any(bool p) const { return __syncthreads_or(p); }
};

// A group's scratch, carved from one region (shared or global memory).
struct Dims {
    int bu, bv;      // entries of u's and v's ball before its last round
    int live;        // last-round parents a ball keeps
    int hslots;      // hash slots (a power of two)
    int words;       // bitmap words of [0, C) (body BFS; within_two at C <= BITMAP_IDS), else 0
    int lcap;        // BFS list entries (0 unless body BFS)
    long long bytes;  // of the whole region
};

struct Scratch {
    int* count;  // [0] live parents, [1] BFS list length, [2] the hit flag
    int* hash;
    int* buf_u;
    int* buf_v;
    int2* live;
    unsigned* bits;
    int* list;
    unsigned hmask;
    int words;
};

__host__ __device__ inline long long align16(long long x) { return (x + 15) & ~15ll; }

__host__ __device__ inline Scratch carve(char* base, const Dims& m) {
    Scratch s;
    long long o = 0;
    s.count = reinterpret_cast<int*>(base);
    o += 16;
    s.live = reinterpret_cast<int2*>(base + o);
    o += 8ll * m.live;
    s.hash = reinterpret_cast<int*>(base + o);
    o += 4ll * m.hslots;
    s.buf_u = reinterpret_cast<int*>(base + o);
    o += 4ll * m.bu;
    s.buf_v = reinterpret_cast<int*>(base + o);
    o += 4ll * m.bv;
    s.bits = reinterpret_cast<unsigned*>(base + o);
    o += 4ll * m.words;
    s.list = reinterpret_cast<int*>(base + o);
    s.hmask = (unsigned)m.hslots - 1u;
    s.words = m.words;
    return s;
}

inline long long region_bytes(const Dims& m) {
    return align16(16 + 8ll * m.live + 4ll * (m.hslots + m.bu + m.bv + m.words + m.lcap));
}

// the region's invariant state: an empty hash, a clear bitmap, no hit
template <class G>
__device__ void init_scratch(const G& g, const Scratch& s, const Dims& m) {
    for (int i = g.tid; i < m.hslots; i += G::n) s.hash[i] = -1;
    for (int i = g.tid; i < m.words; i += G::n) s.bits[i] = 0u;
    if (g.tid == 0) s.count[0] = s.count[1] = s.count[2] = 0;
}

__device__ inline unsigned slot_of(int x, unsigned mask) {
    unsigned h = (unsigned)x * 0x9E3779B1u;
    return (h ^ (h >> 15)) & mask;
}

__device__ inline void hash_insert(int* t, unsigned mask, int x) {
    for (unsigned s = slot_of(x, mask);; s = (s + 1u) & mask) {
        const int old = atomicCAS(&t[s], -1, x);
        if (old == -1 || old == x) return;
    }
}

__device__ inline bool hash_contains(const int* t, unsigned mask, int x) {
    for (unsigned s = slot_of(x, mask);; s = (s + 1u) & mask) {
        const int y = t[s];
        if (y == x) return true;
        if (y == -1) return false;
    }
}

template <class G>
__device__ void hash_clear(const G& g, const Scratch& s) {
    for (unsigned i = g.tid; i <= s.hmask; i += G::n) s.hash[i] = -1;
}

__device__ inline bool hit_seen(const int* flag) { return *reinterpret_cast<const volatile int*>(flag) != 0; }

// ball[0] = start, then `rounds` rounds of appending every entry's row and
// truncating to `cap`; returns the ball's size (the group synced).
template <class G>
__device__ long long expand_ball(const G& g, int* ball, int start, int rounds, long long cap, const int* nbrs, int c,
                                 int d) {
    if (g.tid == 0) ball[0] = start;
    g.sync();
    long long n = 1;
    for (int t = 0; t < rounds; ++t) {
        long long m = n * (long long)(d + 1);
        if (m > cap) m = cap;
        for (long long p = n + g.tid; p < m; p += G::n) {
            const long long q = p - n;
            const int x = ball[q / d];
            ball[p] = x >= 0 ? nbrs[(long long)min(x, c - 1) * d + (int)(q % d)] : -1;
        }
        n = m;
        g.sync();
    }
    return n;
}

// f(y) for slot s < e.y of row e.x of each entry e = rows[q], q < count,
// UNROLL loads in flight a thread; f returns true on a hit, which sets the
// group's flag and stops the scan.
template <class G, class F>
__device__ void scan_rows(const G& g, const int* nbrs, int d, const int2* rows, int count, F f) {
    const long long total = (long long)count * d;
    for (long long i0 = g.tid; i0 < total; i0 += (long long)UNROLL * G::n) {
        if (hit_seen(g.flag)) break;
        int y[UNROLL];
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) {
            const long long i = i0 + (long long)j * G::n;
            y[j] = -1;
            if (i < total) {
                const int q = (int)(i / d), s = (int)(i - (long long)q * d);
                const int2 e = rows[q];
                if (s < e.y) y[j] = nbrs[(long long)e.x * d + s];
            }
        }
#pragma unroll
        for (int j = 0; j < UNROLL; ++j)
            if (y[j] >= 0 && f(y[j])) *g.flag = 1;
    }
}

// f(x) for every id x >= 0 of the ball of radius r around `start`
// (`expand_balls` under `cap`): the ball before its last round is built in
// `buf`, the last round reads the rows of its live parents only.  A hit
// (f true) sets the flag; the caller syncs after.
template <class G, class F>
__device__ void visit_ball(const G& g, const Scratch& s, const int* nbrs, int c, int d, int start, int r,
                           long long cap, int* buf, F f) {
    if (r == 0) {
        if (g.tid == 0 && start >= 0 && f(start)) *g.flag = 1;
        return;
    }
    if (g.tid == 0) s.count[0] = 0;  // ordered by expand_ball's syncs
    const long long n = expand_ball(g, buf, start, r - 1, cap, nbrs, c, d);
    const long long full = n * (long long)(d + 1);
    const long long size = full < cap ? full : cap;  // after the last round (cap 0 keeps nothing)
    const long long keep = n < size ? n : size;
    const long long m = size - keep;            // the last round's entries
    const long long parents = (m + d - 1) / d;  // the positions it expands
    for (long long p = g.tid; p < keep; p += G::n) {
        const int x = buf[p];
        if (x < 0) continue;
        if (f(x)) *g.flag = 1;
        if (p < parents) {
            const long long lim = m - p * d;
            s.live[atomicAdd(&s.count[0], 1)] = make_int2(min(x, c - 1), (int)(lim < d ? lim : d));
        }
    }
    g.sync();
    scan_rows(g, nbrs, d, s.live, s.count[0], f);
}

// the hit flag after the group's last writes; the test clears it for the
// next one after a later sync (every thread has read it by then, and no
// thread sets it before the next test's first sync)
template <class G>
__device__ bool take_flag(const G& g, const Scratch& s) {
    g.sync();
    return s.count[2] != 0;
}

// Does a ball of radius a around u meet the one of radius k - a around v
// (ids >= 0 only)?  The v side goes into the hash, the u side probes it.
template <class G>
__device__ bool balls_meet(const G& g, const Scratch& s, const int* nbrs, int c, int d, int u, int v, int k,
                           long long cap_u, long long cap_v) {
    const int a = (k + 1) / 2;
    visit_ball(g, s, nbrs, c, d, v, k - a, cap_v, s.buf_v, [&](int x) {
        hash_insert(s.hash, s.hmask, x);
        return false;
    });
    g.sync();
    visit_ball(g, s, nbrs, c, d, u, a, cap_u, s.buf_u, [&](int x) { return hash_contains(s.hash, s.hmask, x); });
    const bool hit = take_flag(g, s);
    hash_clear(g, s);
    g.sync();
    if (g.tid == 0) s.count[2] = 0;
    return hit;
}

__device__ inline bool bit(const unsigned* b, int i) { return (b[i >> 5] >> (i & 31)) & 1u; }

// `within_two`: u == v, v in u's row, or the rows share an id >= 0.
// Returns 1 when within, else 2 when u already lies in v's row (the edge
// is present, so the insert writes nothing), else 0.  v's row goes into
// the bitmap of [0, C) where the scratch has one (its ids past C, which
// only out-of-range inserts leave, are looked up in u's row directly),
// else into the hash.
template <class G>
__device__ int within_two(const G& g, const Scratch& s, const int* nbrs, int c, int d, int u, int v) {
    const int* ru = nbrs + (long long)min(u, c - 1) * d;
    const int* rv = nbrs + (long long)min(v, c - 1) * d;
    const bool bitmap = s.words > 0;
    bool has_u = false, big = false;
    for (int j = g.tid; j < d; j += G::n) {
        const int y = rv[j];
        if (y >= 0) {
            if (!bitmap) hash_insert(s.hash, s.hmask, y);
            else if (y < c) atomicOr(&s.bits[y >> 5], 1u << (y & 31));
            else big = true;
        }
        has_u |= y == u;
    }
    g.sync();
    bool hit = g.tid == 0 && u == v;
    for (int j = g.tid; j < d && !hit; j += G::n) {
        const int y = ru[j];
        hit = y == v || (y >= 0 && (bitmap ? y < c && bit(s.bits, y) : hash_contains(s.hash, s.hmask, y)));
    }
    if (g.any(big))
        for (int j = g.tid; j < d && !hit; j += G::n) {
            const int y = rv[j];
            if (y >= c)
                for (int q = 0; q < d && !hit; ++q) hit = ru[q] == y;
        }
    hit = g.any(hit);
    has_u = g.any(has_u);
    if (bitmap) {
        for (int j = g.tid; j < d; j += G::n) {
            const int y = rv[j];
            if (y >= 0 && y < c) s.bits[y >> 5] = 0u;
        }
    } else {
        hash_clear(g, s);
    }
    g.sync();
    return hit ? 1 : (has_u ? 2 : 0);
}

// `bounded_bfs`: reached = {u} (u < C), then k rounds over the reached
// rows' ids in [0, C); is v (clamped to C - 1) reached?  The frontier of
// round r is the list's slice of the ids first reached at round r - 1; the
// last round only looks for v in the frontier's rows.
template <class G>
__device__ bool bounded_bfs(const G& g, const Scratch& s, const int* nbrs, int c, int d, int u, int v, int k) {
    const int gv = min(v, c - 1);
    if (g.tid == 0) {
        s.count[1] = 0;
        if (u < c) {
            s.bits[u >> 5] |= 1u << (u & 31);
            s.list[0] = u;
            s.count[1] = 1;
        }
    }
    bool hit = false;
    int lo = 0;
    for (int r = 0;; ++r) {
        g.sync();
        const int hi = s.count[1];
        hit = bit(s.bits, gv);
        g.sync();  // every thread has read the list's end before it grows
        if (hit || r == k || lo == hi) break;
        int2* rows = s.live;
        for (int q = lo + g.tid; q < hi; q += G::n) rows[q - lo] = make_int2(s.list[q], d);
        g.sync();
        if (r == k - 1) {
            scan_rows(g, nbrs, d, rows, hi - lo, [&](int y) { return y == gv; });
            hit = take_flag(g, s);
            break;
        }
        scan_rows(g, nbrs, d, rows, hi - lo, [&](int y) {
            if (y < c) {
                const unsigned b = 1u << (y & 31);
                if (!(atomicOr(&s.bits[y >> 5], b) & b)) s.list[atomicAdd(&s.count[1], 1)] = y;
            }
            return false;
        });
        lo = hi;
    }
    g.sync();
    const int reached = s.count[1];
    for (int q = g.tid; q < reached; q += G::n) s.bits[s.list[q] >> 5] = 0u;
    g.sync();
    if (g.tid == 0) s.count[2] = 0;
    return hit;
}

struct Caps {
    int k, body;
    long long cap;           // the capped test's
    long long cap_u, cap_v;  // the exact balls' (body BALLS)
};

template <class G>
__device__ bool exact_within(const G& g, const Scratch& s, const int* nbrs, int c, int d, int u, int v,
                             const Caps& cp) {
    if (cp.body == WITHIN_TWO) return within_two(g, s, nbrs, c, d, u, v) == 1;
    if (cp.body == BALLS) return balls_meet(g, s, nbrs, c, d, u, v, cp.k, cp.cap_u, cp.cap_v);
    return bounded_bfs(g, s, nbrs, c, d, u, v, cp.k);
}

__global__ void prepass_kernel(const int* __restrict__ nbrs, int c, int d, const int* __restrict__ src,
                               const int* __restrict__ dst, const bool* __restrict__ mask, int n, Caps cp, Dims dims,
                               char* global_scratch, int* __restrict__ flags, int* __restrict__ counters) {
    extern __shared__ __align__(16) char smem[];
    const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5, wpb = blockDim.x >> 5;
    const long long gw = (long long)blockIdx.x * wpb + wib, nw = (long long)gridDim.x * wpb;
    char* base = global_scratch ? global_scratch + gw * dims.bytes : smem + (long long)wib * dims.bytes;
    const Scratch s = carve(base, dims);
    const Warp g{lane, s.count + 2};
    init_scratch(g, s, dims);
    g.sync();
    int cands = 0, survivors = 0;
    for (long long e = gw; e < n; e += nw) {
        if (mask && !mask[e]) {
            if (lane == 0) flags[e] = 0;
            continue;
        }
        bool within = balls_meet(g, s, nbrs, c, d, src[e], dst[e], cp.k, cp.cap, cp.cap);
        if (!within) {
            ++cands;
            within = exact_within(g, s, nbrs, c, d, max(src[e], 0), max(dst[e], 0), cp);
            survivors += within ? 0 : 1;
        }
        if (lane == 0) flags[e] = within ? 0 : 1;
    }
    if (lane == 0 && (cands | survivors)) {
        atomicAdd(&counters[0], cands);
        atomicAdd(&counters[1], survivors);
    }
}

// add_undirected_edge after the test said "not within" (so u != v): one
// thread writes unless the edge is present (known, or found in either row)
// or a row has no room
template <class G>
__device__ int insert_edge(const G& g, int* nbrs, int* deg, int c, int d, int u, int v, int known = -1) {
    const int gu = min(u, c - 1), gv = min(v, c - 1);
    bool present = known > 0;
    if (known < 0) {
        for (int j = g.tid; j < d && !present; j += G::n)
            present = nbrs[(long long)gu * d + j] == v || nbrs[(long long)gv * d + j] == u;
        present = g.any(present);
    }
    int added = 0;
    if (g.tid == 0 && !present) {
        const int du = deg[gu], dv = deg[gv];
        if (du < d && dv < d) {
            if (u < c) nbrs[(long long)u * d + du] = v;
            if (v < c) nbrs[(long long)v * d + dv] = u;
            if (u < c) deg[u] += 1;
            if (v < c) deg[v] += 1;
            added = 1;
        }
    }
    g.sync();
    return added;
}

// n ints from `from` to `to` by the block, 16 bytes a load where both are
// aligned, UNROLL loads in flight a thread
__device__ void block_copy(int* to, const int* from, long long n) {
    const int tid = threadIdx.x;
    if ((((uintptr_t)to | (uintptr_t)from) & 15) == 0) {
        const long long q = n / 4;
        const int4* f4 = reinterpret_cast<const int4*>(from);
        int4* t4 = reinterpret_cast<int4*>(to);
        for (long long i0 = tid; i0 < q; i0 += (long long)UNROLL * WALK_THREADS) {
            int4 v[UNROLL];
#pragma unroll
            for (int j = 0; j < UNROLL; ++j)
                if (i0 + j * WALK_THREADS < q) v[j] = f4[i0 + j * WALK_THREADS];
#pragma unroll
            for (int j = 0; j < UNROLL; ++j)
                if (i0 + j * WALK_THREADS < q) t4[i0 + j * WALK_THREADS] = v[j];
        }
        for (long long i = 4 * q + tid; i < n; i += WALK_THREADS) to[i] = from[i];
    } else {
        for (long long i = tid; i < n; i += WALK_THREADS) to[i] = from[i];
    }
}

__global__ void __launch_bounds__(WALK_THREADS)
walk_kernel(int* nbrs, int* deg, int c, int d, const int* __restrict__ src, const int* __restrict__ dst,
            const int* __restrict__ flags, int n, Caps cp, Dims dims, int table_in_smem, char* global_scratch,
            const int* __restrict__ counters, int* stats) {
    extern __shared__ __align__(16) char smem[];
    __shared__ int list_u[WALK_CHUNK], list_v[WALK_CHUNK];
    __shared__ int offsets[WALK_THREADS / 32];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long cells = (long long)c * d;
    int* tab = nbrs;
    int* dg = deg;
    char* rest = smem;
    if (table_in_smem) {
        tab = reinterpret_cast<int*>(smem);
        dg = tab + align16(cells * 4) / 4;
        block_copy(tab, nbrs, cells);
        block_copy(dg, deg, c);
        rest = smem + align16(4 * cells) + align16(4ll * c);
    }
    const Scratch s = carve(global_scratch ? global_scratch : rest, dims);
    const Block gb{tid, s.count + 2};
    const Warp gw{lane, s.count + 2};
    init_scratch(gb, s, dims);
    const bool wide = cp.body != WITHIN_TWO;
    int total = 0, admitted = 0;
    // a chunk of WALK_CHUNK edges, WALK_FLAGS a thread: its flags and ids are loaded while the chunk before
    // is walked, then compacted in arrival order by a warp scan and the warps' offsets
    int flag[WALK_FLAGS], eu[WALK_FLAGS], ev[WALK_FLAGS];
    auto load = [&](int base) {
#pragma unroll
        for (int j = 0; j < WALK_FLAGS; ++j) {
            const int e = base + WALK_FLAGS * tid + j;
            flag[j] = e < n ? flags[e] : 0;
            eu[j] = flag[j] ? max(src[e], 0) : 0;
            ev[j] = flag[j] ? max(dst[e], 0) : 0;
        }
    };
    load(0);
    for (int base = 0; base < n; base += WALK_CHUNK) {
        int mine = 0;
#pragma unroll
        for (int j = 0; j < WALK_FLAGS; ++j) mine += flag[j];
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int x = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += x;
        }
        if (lane == 31) offsets[warp] = incl;
        __syncthreads();
        int at = incl - mine, m = 0;
        for (int w = 0; w < WALK_THREADS / 32; ++w) {
            at += w < warp ? offsets[w] : 0;
            m += offsets[w];
        }
#pragma unroll
        for (int j = 0; j < WALK_FLAGS; ++j)
            if (flag[j]) {
                list_u[at] = eu[j];
                list_v[at] = ev[j];
                ++at;
            }
        load(base + WALK_CHUNK);
        __syncthreads();  // the list is whole; every thread has read the offsets
        total += m;
        if (wide) {
            for (int i = 0; i < m; ++i) {
                const int u = list_u[i], v = list_v[i];
                // balls that miss (k >= 2) hold u and its row, v and its row: the edge is not present
                if (!exact_within(gb, s, tab, c, d, u, v, cp))
                    admitted += insert_edge(gb, tab, dg, c, d, u, v, cp.body == BALLS && cp.k >= 2 ? 0 : -1);
            }
        } else if (warp == 0) {
            for (int i = 0; i < m; ++i) {
                const int u = list_u[i], v = list_v[i];
                const int w = within_two(gw, s, tab, c, d, u, v);  // 0 or 2: v not in u's row, u != v
                if (w != 1) admitted += insert_edge(gw, tab, dg, c, d, u, v, w == 2);
            }
        }
    }
    __syncthreads();
    if (table_in_smem) {
        block_copy(nbrs, tab, cells);
        block_copy(deg, dg, c);
    }
    if (tid == 0) {
        const int cands = counters[0];
        atomicAdd(&stats[0], 1);
        atomicAdd(&stats[1], cands);
        atomicAdd(&stats[2], admitted);
        atomicMax(&stats[3], cands);
        atomicAdd(&stats[4], total);
        atomicMax(&stats[5], total);
    }
}

struct Plan {
    Caps cp;
    Dims dims;                 // one group's scratch
    int pre_warps, pre_blocks;  // warps a pre-pass block, blocks
    long long pre_smem;         // its dynamic shared bytes (0: its scratch in global memory)
    long long walk_smem;        // the walk block's dynamic shared bytes
    int table_in_smem;
    long long flags_off, counters_off, pre_off, walk_off, bytes;  // scratch layout (bytes)
    bool ok;
};

inline long long align(long long x) { return (x + 255) & ~255ll; }

inline int pow2_at_least(long long x) {
    int h = 32;
    while (h < x) h <<= 1;
    return h;
}

Plan plan(int n, int c, int d, int k, int cap, int body) {
    Plan p{};
    p.ok = n >= 0 && c >= 1 && d >= 1 && k >= 0 && cap >= 0 && body >= 0 && body <= 2;
    if (!p.ok) return p;
    const int a = (k + 1) / 2;
    p.cp.k = k;
    p.cp.body = body;
    p.cp.cap = cap;
    // the balls' sizes before their last round, and the v side's whole (the hash's entries)
    long long bu = a > 0 ? ball_size(a - 1, cap, d) : 1;
    long long bv = k - a > 0 ? ball_size(k - a - 1, cap, d) : 1;
    long long set = ball_size(k - a, cap, d);
    if (body == BALLS) {
        const long long fu = full_cap(a, d), fv = full_cap(k - a, d);
        if (fu > BALL_LIMIT || fv > BALL_LIMIT) {
            p.ok = false;
            return p;
        }
        p.cp.cap_u = fu;
        p.cp.cap_v = fv;
        if (a > 0 && ball_size(a - 1, fu, d) > bu) bu = ball_size(a - 1, fu, d);
        if (k - a > 0 && ball_size(k - a - 1, fv, d) > bv) bv = ball_size(k - a - 1, fv, d);
        if (ball_size(k - a, fv, d) > set) set = ball_size(k - a, fv, d);
    }
    if (body == WITHIN_TWO && d > set) set = d;
    long long lcap = 0, words = 0;
    if (body == BFS) {
        const long long reach = full_cap(k > 0 ? k - 1 : 0, d);
        lcap = reach < c ? reach : c;
        words = (c + 31) / 32;
    } else if (body == WITHIN_TWO && c <= BITMAP_IDS) {
        words = (c + 31) / 32;
    }
    long long live = bu > bv ? bu : bv;
    if (lcap > live) live = lcap;  // the BFS hands its frontier to the row scan in the live array
    if (bu + bv + 2 * set + 2 * live + lcap + words > BALL_LIMIT) {
        p.ok = false;
        return p;
    }
    p.dims.bu = (int)bu;
    p.dims.bv = (int)bv;
    p.dims.live = (int)live;
    p.dims.hslots = pow2_at_least(2 * set);
    p.dims.words = (int)words;
    p.dims.lcap = (int)lcap;
    p.dims.bytes = region_bytes(p.dims);
    const long long pw = p.dims.bytes;
    long long pre_global = 0;
    if (pw <= SMEM_LIMIT) {
        const long long w = SMEM_LIMIT / pw;
        p.pre_warps = (int)(w < PRE_WARPS_MAX ? w : PRE_WARPS_MAX);
        const long long blocks = (n + p.pre_warps - 1) / p.pre_warps;
        p.pre_blocks = (int)(blocks < 1 ? 1 : (blocks < PRE_BLOCKS_MAX ? blocks : PRE_BLOCKS_MAX));
        p.pre_smem = pw * p.pre_warps;
    } else {
        long long w = GLOBAL_SCRATCH_LIMIT / pw;
        if (w > PRE_GLOBAL_WARPS) w = PRE_GLOBAL_WARPS;
        if (w < 4) w = 4;
        p.pre_warps = 4;
        p.pre_blocks = (int)(w / 4);
        p.pre_smem = 0;
        pre_global = pw * w;
    }
    const long long table = align16(4ll * c * d) + align16(4ll * c);
    long long walk_global = 0;
    if (table + pw <= WALK_SMEM_LIMIT) {
        p.table_in_smem = 1;
        p.walk_smem = table + pw;
    } else if (pw <= WALK_SMEM_LIMIT) {
        p.walk_smem = pw;
    } else {
        walk_global = pw;
    }
    p.flags_off = 0;
    p.counters_off = align(4ll * (n > 0 ? n : 1));
    p.pre_off = align(p.counters_off + 16);
    p.walk_off = align(p.pre_off + pre_global);
    p.bytes = align(p.walk_off + walk_global);
    if (!pre_global) p.pre_off = -1;
    if (!walk_global) p.walk_off = -1;
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
// scratch of spanner_scratch_bytes, stats int32[6] (calls, candidates of
// the capped test, admitted, most candidates in a call, survivors of the
// exact pre-pass, most survivors in a call; added to), stream
int spanner_admit_launch(int* nbrs, int* deg, int capacity, int max_degree, const int* src, const int* dst,
                         const bool* mask, int n, int k, int cap, int body, void* scratch, long long scratch_bytes,
                         int* stats, cudaStream_t stream) {
    Plan p = plan(n, capacity, max_degree, k, cap, body);
    if (!p.ok || scratch_bytes < p.bytes) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    char* base = static_cast<char*>(scratch);
    int* flags = reinterpret_cast<int*>(base + p.flags_off);
    int* counters = reinterpret_cast<int*>(base + p.counters_off);
    char* pre_scratch = p.pre_off >= 0 ? base + p.pre_off : nullptr;
    char* walk_scratch = p.walk_off >= 0 ? base + p.walk_off : nullptr;
    cudaError_t e = cudaMemsetAsync(counters, 0, 16, stream);
    if (e != cudaSuccess) return (int)e;
    if (p.pre_smem > 48 * 1024) {
        e = cudaFuncSetAttribute(prepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.pre_smem);
        if (e != cudaSuccess) return (int)e;
    }
    prepass_kernel<<<p.pre_blocks, 32 * p.pre_warps, (size_t)p.pre_smem, stream>>>(
        nbrs, capacity, max_degree, src, dst, mask, n, p.cp, p.dims, pre_scratch, flags, counters);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (p.walk_smem > 48 * 1024) {
        e = cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.walk_smem);
        if (e != cudaSuccess) return (int)e;
    }
    walk_kernel<<<1, WALK_THREADS, (size_t)p.walk_smem, stream>>>(nbrs, deg, capacity, max_degree, src, dst, flags,
                                                                  n, p.cp, p.dims, p.table_in_smem, walk_scratch,
                                                                  counters, stats);
    return (int)cudaGetLastError();
}

}  // extern "C"
