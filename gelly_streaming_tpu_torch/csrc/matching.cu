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
// What bounds it: the greedy is serial by nature, every admission depends on
// all earlier ones, so one thread walks the batch: a step is a chain of
// dependent loads of partner and weight (at u, v, then at their partners)
// and the stores that follow, about four round trips to the L2 (~0.3 us) an
// edge.  The state stays in global memory, which the L2 holds (C = 2^12:
// 32 KB); nothing else can run ahead of the chain.
//
// Ids follow JAX's rules: a gather counts a negative index from the end once
// and clamps, a scatter drops an index outside [0, C) after that.

#include <cuda_runtime.h>

namespace {

__device__ inline int gather_index(int i, int c) {
    if (i < 0) i += c;
    return i < 0 ? 0 : (i >= c ? c - 1 : i);
}

// the row a scatter writes, or -1 where it drops
__device__ inline int scatter_index(int i, int c) {
    if (i < 0) i += c;
    return (i >= 0 && i < c) ? i : -1;
}

__global__ void matching_kernel(int* partner, float* weight, int c, const int* __restrict__ src,
                                const int* __restrict__ dst, const float* __restrict__ val,
                                const bool* __restrict__ mask, int n, float* __restrict__ events,
                                bool* __restrict__ emask) {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
    for (int e = 0; e < n; ++e) {
        const int u = src[e], v = dst[e];
        const float w = val ? val[e] : 1.0f;
        const bool ok = mask ? mask[e] : true;
        const int gu = gather_index(u, c), gv = gather_index(v, c);
        const int pu = partner[gu], pv = partner[gv];
        const float wu = pu >= 0 ? weight[gu] : 0.0f;
        const bool same_edge = pu == v && pv == u && pu >= 0;
        const float wv = (pv >= 0 && !same_edge) ? weight[gv] : 0.0f;
        const bool admit = ok && (w > __fmul_rn(2.0f, __fadd_rn(wu, wv))) && u != v;
        float* ev = events + (long long)e * 12;
        bool* em = emask + (long long)e * 3;
        // evict the matched edge at u, then at v on the updated state
        for (int slot = 0; slot < 2; ++slot) {
            const int a = slot == 0 ? u : v;
            const int ga = gather_index(a, c);
            const int b = partner[ga];
            const float wa = weight[ga];
            const bool dropped = admit && b >= 0;
            const int bb = b > 0 ? b : 0;
            if (dropped) {
                const int sa = scatter_index(a, c), sb = scatter_index(bb, c);
                if (sa >= 0) partner[sa] = -1;
                if (sb >= 0) partner[sb] = -1;
                if (sa >= 0) weight[sa] = 0.0f;
                if (sb >= 0) weight[sb] = 0.0f;
            }
            ev[slot * 4 + 0] = 0.0f;
            ev[slot * 4 + 1] = __int2float_rn(a < bb ? a : bb);
            ev[slot * 4 + 2] = __int2float_rn(a > b ? a : b);
            ev[slot * 4 + 3] = wa;
            em[slot] = dropped;
        }
        if (admit) {
            const int su = scatter_index(u, c), sv = scatter_index(v, c);
            if (su >= 0) partner[su] = v;
            if (sv >= 0) partner[sv] = u;
            if (su >= 0) weight[su] = w;
            if (sv >= 0) weight[sv] = w;
        }
        ev[8] = 1.0f;
        ev[9] = __int2float_rn(u);
        ev[10] = __int2float_rn(v);
        ev[11] = w;
        em[2] = admit;
    }
}

}  // namespace

extern "C" {

// partner int32[C], weight f32[C] (updated in place), C, src, dst int32[n],
// val f32[n] or null (weight 1), mask bool[n] or null, n, events f32[n, 3, 4],
// emask bool[n, 3], stream: one thread walks the batch
int matching_scan_launch(int* partner, float* weight, int capacity, const int* src, const int* dst,
                         const float* val, const bool* mask, int n, float* events, bool* emask,
                         cudaStream_t stream) {
    if (capacity < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    matching_kernel<<<1, 32, 0, stream>>>(partner, weight, capacity, src, dst, val, mask, n, events, emask);
    return (int)cudaGetLastError();
}

}  // extern "C"
