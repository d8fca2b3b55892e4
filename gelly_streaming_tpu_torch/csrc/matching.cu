// The greedy weighted matching's batch scan on Hopper (sm_90a), behind a
// plain C interface.
//
// Replaces the `lax.scan` of `matching_update` (gelly_streaming_tpu/library/
// matching.py:38-96; reference example/CentralizedWeightedMatching.java:
// 68-108): for each edge in arrival order, the matched edges at u and at v
// are evicted and (u, v) admitted when its weight exceeds twice their sum
// (the shared edge counted once), with three event rows an edge: REMOVE at
// u, REMOVE at v (canonical (min, max) ids), ADD.  Event rows are f32, ids
// included, written for every edge as the JAX scan writes them; emask marks
// the ones that happened.
//
// What bounds it: the greedy is serial by nature, but a step writes state
// only when it admits, and after warm-up almost every edge is rejected.  So
// one block tests a window of W edges at once, lane k the edge pos + k, each
// against the state as the round began: its read set is {gather(u),
// gather(v)}, its write set (empty unless it admits) the scatter rows of u,
// v and of the partners it evicts.  Every admitting lane stamps its write
// set; the round commits the longest prefix of lanes in which no lane reads
// or writes a row that an earlier admitting lane of the window writes.  Each
// lane of that prefix saw exactly the state the serial scan would have shown
// it, and their write sets are disjoint, so their stores need no order.  The
// lanes from the cut on redo their step in the next round; lane 0 never
// conflicts, so a round commits at least one edge.  A stamp is epoch_round *
// W + (W - 1 - lane) under atomicMax, so the smallest lane wins and any
// stamp of the current round beats every stale one: set once a call, never
// cleared between rounds.
//
// W = 256, one block of 256 threads: a wider window commits more a round
// where admissions are rare, but costs more a round where every lane
// conflicts and leaves less shared memory for the state.  A round costs
// three block barriers and a chain of dependent shared-memory accesses and
// ALU steps a lane (~1.04 us on the H100), written without branches; the
// committed lanes' event rows are staged in shared memory and written out
// as one coalesced run.  The state
// (partner, weight, stamps: 12 C bytes) sits in shared memory where it fits
// beside the edge ring, else the same rounds run on the global arrays with
// the stamps in a scratch buffer.  The next window's edges are loaded while
// the round's barriers run, into a ring of 2 W slots.  Worst case: every
// lane conflicts (each admission touches the next edge's rows), one edge a
// round, ~2.2x the one-thread walk's time.
//
// Ids follow JAX's rules: a gather counts a negative index from the end once
// and clamps, a scatter drops an index outside [0, C) after that.

#include <cuda_runtime.h>

namespace {

constexpr int W = 256;                            // edges a round: one block of W threads
constexpr int RING = 2 * W;                       // the edge ring's slots
constexpr int EPOCH_ROUNDS = 0x7fffffff / W - 1;  // rounds a stamp epoch counts before the stamps restart

__device__ inline int gather_index(int i, int c) {
    if (i < 0) i += c;
    return i < 0 ? 0 : (i >= c ? c - 1 : i);
}

// the row a scatter writes, or -1 where it drops
__device__ inline int scatter_index(int i, int c) {
    if (i < 0) i += c;
    return (i >= 0 && i < c) ? i : -1;
}

// dynamic shared memory: the cut's two slots (by round parity), the
// committed lanes' event rows (12 floats a lane), the edge ring (src, dst,
// val), then, in the shared-state kernel, partner, weight and the stamps,
// and last the bytes: the committed lanes' emask rows and the ring's mask
constexpr size_t RING_BYTES = 16 + (size_t)W * (48 + 3) + (size_t)RING * 13;

template <bool SHARED_STATE>
__global__ void __launch_bounds__(W)
    matching_kernel(int* g_partner, float* g_weight, int c, const int* __restrict__ src, const int* __restrict__ dst,
                    const float* __restrict__ val, const bool* __restrict__ mask, int n,
                    float* __restrict__ events, bool* __restrict__ emask, int* g_stamp, int* stats) {
    extern __shared__ __align__(16) unsigned char smem[];
    int* s_cut = reinterpret_cast<int*>(smem);
    float4* s_ev = reinterpret_cast<float4*>(smem + 16);
    int* r_src = reinterpret_cast<int*>(s_ev + 3 * W);
    int* r_dst = r_src + RING;
    float* r_val = reinterpret_cast<float*>(r_dst + RING);
    int* partner = g_partner;
    float* weight = g_weight;
    int* stamp = g_stamp;
    unsigned char* s_em;
    const int k = threadIdx.x;
    if (SHARED_STATE) {
        partner = reinterpret_cast<int*>(r_val + RING);
        weight = reinterpret_cast<float*>(partner + c);
        stamp = reinterpret_cast<int*>(weight + c);
        s_em = reinterpret_cast<unsigned char*>(stamp + c);
        for (int i = k; i < c; i += W) {
            partner[i] = g_partner[i];
            weight[i] = g_weight[i];
        }
    } else {
        s_em = reinterpret_cast<unsigned char*>(r_val + RING);
    }
    unsigned char* r_ok = s_em + 3 * W;
    for (int i = k; i < c; i += W) stamp[i] = 0;
    for (int i = k; i < RING && i < n; i += W) {
        r_src[i] = src[i];
        r_dst[i] = dst[i];
        r_val[i] = val ? val[i] : 1.0f;
        r_ok[i] = mask ? mask[i] : true;
    }
    if (k == 0) s_cut[0] = s_cut[1] = W;
    __syncthreads();

    // the ring holds edges [pos, hi) (slot of edge i: i % RING); every thread keeps the same pos, hi and counts
    int pos = 0, hi = min(RING, n), pos_slot = 0, hi_slot = hi % RING;
    int rounds = 0, epoch_round = 0, admitted = 0;
    while (pos < n) {
        ++rounds;
        if (++epoch_round > EPOCH_ROUNDS) {  // a new epoch: every stamp stale again
            for (int i = k; i < c; i += W) stamp[i] = 0;
            __syncthreads();
            epoch_round = 1;
        }
        const int parity = rounds & 1;
        if (k == 0) s_cut[parity ^ 1] = W;  // read last round, next written after this round's last barrier
        const int m = min(W, n - pos);
        // edges [hi, fetch_end) into registers now, into the ring at the end of the round
        const int fetch_end = min(pos + RING, n);
        const int f = hi + k;
        const bool fetch = f < fetch_end;
        int f_src = 0, f_dst = 0;
        float f_val = 1.0f;
        bool f_ok = true;
        if (fetch) {
            f_src = src[f];
            f_dst = dst[f];
            if (val) f_val = val[f];
            if (mask) f_ok = mask[f];
        }

        // the lane's step on the state as the round began
        const bool active = k < m;
        const int slot = pos_slot + k >= RING ? pos_slot + k - RING : pos_slot + k;
        const int u = active ? r_src[slot] : 0, v = active ? r_dst[slot] : 0;
        const float w = active ? r_val[slot] : 0.0f;
        const bool ok = active && r_ok[slot];
        const int gu = gather_index(u, c), gv = gather_index(v, c);
        const int su = scatter_index(u, c), sv = scatter_index(v, c);
        const int pu = partner[gu], pv = partner[gv];
        const float wgu = weight[gu], wgv = weight[gv];
        const float wu = pu >= 0 ? wgu : 0.0f;
        const bool same_edge = (pu == v) & (pv == u) & (pu >= 0);
        const float wv = ((pv >= 0) & !same_edge) ? wgv : 0.0f;
        const bool admit = ok & (w > __fmul_rn(2.0f, __fadd_rn(wu, wv))) & (u != v);
        // evict the matched edge at u, then at v on the lane's updated view
        const bool drop0 = admit & (pu >= 0);
        const int bb0 = pu > 0 ? pu : 0;
        const int sb0 = scatter_index(bb0, c);
        const bool hit = drop0 & ((gv == su) | (gv == sb0));
        const int b1 = hit ? -1 : pv;
        const float wa1 = hit ? 0.0f : wgv;
        const bool drop1 = admit & (b1 >= 0);
        const int bb1 = b1 > 0 ? b1 : 0;
        const int sb1 = scatter_index(bb1, c);
        // the rows the lane writes besides su, sv (the evicted partners), else a row it reads
        const bool w0 = drop0 & (sb0 >= 0), w1 = drop1 & (sb1 >= 0);
        const int x0 = w0 ? sb0 : gu, x1 = w1 ? sb1 : gv;

        const int mine = epoch_round * W + (W - 1 - k);
        if (admit & (su >= 0)) atomicMax(&stamp[su], mine);
        if (admit & (sv >= 0)) atomicMax(&stamp[sv], mine);
        if (w0) atomicMax(&stamp[sb0], mine);
        if (w1) atomicMax(&stamp[sb1], mine);
        __syncthreads();
        // a conflict: a row the lane reads or writes carries an earlier lane's stamp of this round
        const int t0 = stamp[gu], t1 = stamp[gv], t2 = stamp[x0], t3 = stamp[x1];
        const bool conflict = active & ((t0 > mine) | (t1 > mine) | (t2 > mine) | (t3 > mine));
        const unsigned ballot = __ballot_sync(0xffffffffu, conflict);
        if (ballot && (k & 31) == __ffs(ballot) - 1) atomicMin(&s_cut[parity], k);
        __syncthreads();
        const int cut = min(s_cut[parity], m);
        const bool commit = k < cut;
        if (commit) {
            s_ev[3 * k] = make_float4(0.0f, __int2float_rn(u < bb0 ? u : bb0), __int2float_rn(u > pu ? u : pu), wgu);
            s_ev[3 * k + 1] =
                make_float4(0.0f, __int2float_rn(v < bb1 ? v : bb1), __int2float_rn(v > b1 ? v : b1), wa1);
            s_ev[3 * k + 2] = make_float4(1.0f, __int2float_rn(u), __int2float_rn(v), w);
            s_em[3 * k] = drop0;
            s_em[3 * k + 1] = drop1;
            s_em[3 * k + 2] = admit;
            // the scan's stores in its order, folded: the evicted partners unmatched, then u and v matched
            if (w0) {
                partner[sb0] = -1;
                weight[sb0] = 0.0f;
            }
            if (w1) {
                partner[sb1] = -1;
                weight[sb1] = 0.0f;
            }
            if (admit & (su >= 0)) {
                partner[su] = v;
                weight[su] = w;
            }
            if (admit & (sv >= 0)) {
                partner[sv] = u;
                weight[sv] = w;
            }
        }
        if (fetch) {  // slots of edges before pos: no lane of this round reads them
            const int fs = hi_slot + k >= RING ? hi_slot + k - RING : hi_slot + k;
            r_src[fs] = f_src;
            r_dst[fs] = f_dst;
            r_val[fs] = f_val;
            r_ok[fs] = f_ok;
        }
        admitted += __syncthreads_count(commit & admit);
        // the committed rows out, coalesced: events [pos, pos + cut) are 3 cut float4s and 3 cut bytes; the
        // staging is next written after the next round's second barrier
        float4* ev_out = reinterpret_cast<float4*>(events) + (long long)pos * 3;
        bool* em_out = emask + (long long)pos * 3;
        for (int i = k; i < 3 * cut; i += W) {
            ev_out[i] = s_ev[i];
            em_out[i] = s_em[i];
        }
        hi_slot += fetch_end - hi;
        if (hi_slot >= RING) hi_slot -= RING;
        hi = fetch_end;
        pos_slot += cut;
        if (pos_slot >= RING) pos_slot -= RING;
        pos += cut;
    }
    if (SHARED_STATE) {
        for (int i = k; i < c; i += W) {
            g_partner[i] = partner[i];
            g_weight[i] = weight[i];
        }
    }
    if (k == 0) {
        atomicAdd(&stats[0], 1);
        atomicAdd(&stats[1], rounds);
        atomicMax(&stats[2], rounds);
        atomicAdd(&stats[3], admitted);
    }
}

size_t shared_state_bytes(int capacity) { return RING_BYTES + (size_t)capacity * 12; }

bool state_fits(int capacity) {
    int dev = 0, optin = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
        return false;
    return shared_state_bytes(capacity) <= (size_t)optin;
}

// one branch's launch; the shared-memory attribute raised once a device to
// the most bytes asked so far
template <bool SHARED_STATE>
cudaError_t launch(size_t bytes, cudaStream_t stream, int* partner, float* weight, int capacity, const int* src,
                   const int* dst, const float* val, const bool* mask, int n, float* events, bool* emask,
                   int* scratch, int* stats) {
    static size_t configured[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (bytes > 48 * 1024 && bytes > configured[dev]) {
        err = cudaFuncSetAttribute(matching_kernel<SHARED_STATE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
        if (err != cudaSuccess) return err;
        configured[dev] = bytes;
    }
    matching_kernel<SHARED_STATE><<<1, W, bytes, stream>>>(partner, weight, capacity, src, dst, val, mask, n, events,
                                                          emask, scratch, stats);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// capacity: the scratch bytes of a call (the stamps, int32 [C] on the
// card), 0 where the state fits in shared memory
long long matching_scratch_bytes(int capacity) {
    if (capacity < 1) return -1;
    return state_fits(capacity) ? 0 : (long long)capacity * 4;
}

// partner int32[C], weight f32[C] (updated in place), C, src, dst int32[n],
// val f32[n] or null (weight 1), mask bool[n] or null, n, events f32[n, 3,
// 4], emask bool[n, 3], scratch (the stamps; null where
// matching_scratch_bytes gives 0), stats int32[4] (calls, rounds, most
// rounds in a call, admissions; added to), stream: one block runs the
// rounds
int matching_scan_launch(int* partner, float* weight, int capacity, const int* src, const int* dst,
                         const float* val, const bool* mask, int n, float* events, bool* emask, int* scratch,
                         int* stats, cudaStream_t stream) {
    if (capacity < 1 || n < 0 || !stats) return (int)cudaErrorInvalidValue;
    if (state_fits(capacity))
        return (int)launch<true>(shared_state_bytes(capacity), stream, partner, weight, capacity, src, dst, val,
                                 mask, n, events, emask, nullptr, stats);
    if (!scratch) return (int)cudaErrorInvalidValue;
    return (int)launch<false>(RING_BYTES, stream, partner, weight, capacity, src, dst, val, mask, n, events, emask,
                              scratch, stats);
}

}  // extern "C"
