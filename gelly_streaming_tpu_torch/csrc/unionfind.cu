// Batched union-find on Hopper (sm_90a): a compress kernel and a union
// kernel behind a plain C interface, loaded with ctypes
// (gelly_streaming_tpu_torch/ops/_cuda.py, ops/unionfind.py).
//
// Replaces the JAX package's union fold (gelly_streaming_tpu/ops/unionfind.py):
// the pointer-doubling while loop of compress (:27-44) and the hook/compress
// while loop of union_edges (:59-91).  Those are XLA code, not Pallas: two
// nested lax.while_loops that iterate on the device.  PyTorch has no
// device-side loop, and a host loop would sync on every hook round and
// every doubling round; here each loop lives inside one cooperative launch
// (a persistent grid of co-resident blocks) whose rounds are separated by
// grid-wide syncs, and a flag in the caller's scratch says whether a round
// changed anything, so no round trip to the host decides when to stop.
// One C call folds a whole batch.
//
// State: parent int32[C] (a forest; parent[r] == r marks a root) and seen
// uint8[C] (the bool tensor's bytes).  Both are updated in place.
//
// compress_kernel: doubling rounds, parent[v] = parent[parent[v]] for all
// v, until a round moves nothing.  Rounds are in place (a read may see an
// entry another thread already advanced in the same round, which only
// jumps further), so a forest of depth d is flat after at most
// ceil(log2 d) + 1 rounds: two on the forests a live stream leaves, about
// 21 on a 2^20-vertex path.
//
// union_kernel: the JAX loop on a flat forest (compress_kernel runs first,
// as the JAX loop compresses first).  A hook round reads both endpoints'
// roots (one load each: the forest is flat) for every edge and, where they
// differ, lowers the larger root's entry to the smaller root with
// atomicMin, the scatter-min of the JAX body; then doubling rounds flatten
// the forest again; rounds repeat until no edge's roots differ.  Rows whose
// mask byte is 0 are skipped (the JAX fold turns them into (0, 0)
// self-loops, which change nothing), as are edges with an id outside
// [0, C); the first hook round marks seen for both endpoints.  Entries
// only ever decrease and only to ids of the same component, so the loop
// ends, and the smallest root a component came in with is never lowered:
// every vertex ends pointing at it, the JAX fixed point bit for bit (after
// init_parent and unions, the component's smallest vertex id).  A hook
// round may see a root lowered earlier in the same round and lower its
// stale entry, cutting the link that lowering made; the edge that made it
// differed in that round, so it is looked at again and relinks the two
// trees: the loop stops only when no edge it looks at differs.
//
// An edge whose roots agree is marked done in a scratch byte and skipped
// by later rounds: it stays agreed, because a link older than the current
// round is never cut (only a round's own roots are lowered), and a link
// the round made is restored as above.  So the last round of a batch of a
// live stream, which finds nothing to do, reads one byte an edge instead
// of the edge and two roots.
//
// The first design hooked by atomicCAS from find walks with path halving
// (ECL-CC's scheme).  It was exact, but a walk can start at the top of a
// chain that other threads built one link each, and one thread then walks
// the whole chain: a 2^20-vertex path inserted in reverse order took 25 ms
// on the H100 against 0.25 ms shuffled; in rounds it takes 0.43 ms
// (chip_smoke.py phase 6).  Rounds bound every find to one load, and the
// work by the number of rounds.
//
// The parity union (uf_parity_union_launch) is the same union kernel on the
// doubled vertex space of the bipartiteness check: node 2v is "v on side A",
// 2v + 1 "v on side B", and a row (u, w) asserts opposite sides, the edges
// (2u, 2w + 1) and (2u + 1, 2w).  The JAX package concatenates those into
// two [2n] arrays before its union; here each thread forms its edge from the
// row it reads, and seen is marked in the original space.  Its fixed point
// is the JAX one for the same reason as above.  Bound (bytes), 2^21 rows at
// C = 2^20: src and dst read once (8 B a row), parent2 read (8 B a vertex),
// seen written (1 B a vertex): 26.2 MB, 7.8 us.
//
// Bound on the H100 (bytes), for a 2^21-edge batch at C = 2^20 and 3.35
// TB/s: union_kernel reads src and dst (8 B an edge) and parent (4 B a
// vertex) and writes seen (1 B a vertex): 16.8 MB + 4.2 MB + 1.0 MB = 22.0
// MB, 6.57 us.  The few entries a late batch lowers are left to
// compress_kernel's bound, which reads and writes parent: 8.4 MB, 2.50 us.
// The whole call's bound is 9.08 us.  Each extra round re-reads src and
// dst (hook) or parent (doubling); parent (4 MiB) and seen (1 MiB) stay
// resident in the 50 MB L2, where the root loads and atomics land.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kFlagsPerKernel = 3;

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One round's bookkeeping (every phase of a kernel counts rounds with one
// counter).  flags: int32[3] with flags[0] cleared before the launch.
// Round r clears flags[(r + 1) % 3], the slot of round r - 2, which every
// thread read before the sync that ended round r - 1; a thread that changed
// anything sets flags[r % 3]; after the grid-wide sync every thread reads
// it, so all agree whether the round changed anything.
__device__ __forceinline__ void round_begin(int* flags, int round, int64_t first) {
  if (first == 0) store_relaxed(flags + (round + 1) % 3, 0);
}

__device__ __forceinline__ bool round_end(cg::grid_group& grid, int* flags, int& round,
                                          bool changed) {
  if (changed) store_relaxed(flags + round % 3, 1);
  grid.sync();
  const bool any = load_relaxed(flags + round % 3) != 0;
  ++round;
  return any;
}

// Doubling rounds until one moves nothing.
__device__ void flatten(cg::grid_group& grid, int* parent, int capacity, int* flags, int& round,
                        int64_t first, int64_t stride) {
  bool moved_any = true;
  while (moved_any) {
    round_begin(flags, round, first);
    bool moved = false;
    for (int64_t i = first; i < capacity; i += stride) {
      const int p = load_relaxed(parent + i);
      const int gp = load_relaxed(parent + p);
      if (gp != p) {
        store_relaxed(parent + i, gp);
        moved = true;
      }
    }
    moved_any = round_end(grid, flags, round, moved);
  }
}

__global__ void __launch_bounds__(kThreads)
compress_kernel(int* __restrict__ parent, int capacity, int* __restrict__ flags) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int round = 0;
  flatten(grid, parent, capacity, flags, round, first, stride);
}

// done: uint8[items] scratch, written by the first hook round for every
// edge (1 = skipped row or agreeing roots), then read and set by later
// rounds.  kParity: the doubled space of the bipartiteness check, where
// parent has 2 * vcap entries and each row (u, w) is two edges, (2u, 2w + 1)
// at item row and (2u + 1, 2w) at item n + row, formed here from one read of
// the row; seen stays in the original space.  Otherwise items = n and
// vcap = capacity.
template <bool kParity>
__global__ void __launch_bounds__(kThreads)
union_kernel(int* __restrict__ parent, uint8_t* __restrict__ seen,
             const int* __restrict__ src, const int* __restrict__ dst,
             const uint8_t* __restrict__ mask, int n, int vcap, int* __restrict__ flags,
             uint8_t* __restrict__ done) {
  cg::grid_group grid = cg::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t items = kParity ? 2 * static_cast<int64_t>(n) : n;
  int round = 0;
  for (bool first_pass = true;; first_pass = false) {
    round_begin(flags, round, first);
    bool differ = false;
    for (int64_t i = first; i < items; i += stride) {
      if (!first_pass && done[i]) continue;
      const int side = kParity && i >= n ? 1 : 0;
      const int64_t row = i - side * static_cast<int64_t>(n);
      // src == nullptr: the edges (v, dst[v]) of merge_parents
      const int u = src != nullptr ? __ldg(src + row) : static_cast<int>(row);
      const int v = __ldg(dst + row);
      if ((mask != nullptr && mask[row] == 0) ||
          static_cast<unsigned>(u) >= static_cast<unsigned>(vcap) ||
          static_cast<unsigned>(v) >= static_cast<unsigned>(vcap)) {
        done[i] = 1;
        continue;
      }
      if (first_pass && seen != nullptr && side == 0) {
        seen[u] = 1;
        seen[v] = 1;
      }
      const int a = kParity ? 2 * u + side : u;
      const int b = kParity ? 2 * v + 1 - side : v;
      const int ra = load_relaxed(parent + a);
      const int rb = load_relaxed(parent + b);
      if (ra != rb) {
        differ = true;
        atomicMin(parent + max(ra, rb), min(ra, rb));
      }
      if (first_pass || ra == rb) done[i] = ra == rb;
    }
    if (!round_end(grid, flags, round, differ)) return;
    flatten(grid, parent, kParity ? 2 * vcap : vcap, flags, round, first, stride);
  }
}

// A cooperative launch of `kernel` over `items` (at most the blocks that
// fit on the card at once; the kernels loop over the rest).
cudaError_t launch_cooperative(const void* kernel, int64_t items, void** args, cudaStream_t s) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) !=
          cudaSuccess)
    return err;
  const int64_t fit = static_cast<int64_t>(sms) * per_sm;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < fit ? blocks : fit;
  blocks = blocks > 0 ? blocks : 1;
  return cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                     args, 0, s);
}

// The compress kernel over `capacity` entries, then (items > 0) the union
// kernel; flags in the caller's scratch are cleared first.
template <bool kParity>
int union_launch(void* parent, void* seen, const void* src, const void* dst, const void* mask,
                 int n, int vcap, int capacity, void* scratch, cudaStream_t s) {
  int* p = static_cast<int*>(parent);
  int* flags = static_cast<int*>(scratch);
  cudaError_t err = cudaMemsetAsync(flags, 0, 2 * kFlagsPerKernel * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* compress_args[] = {&p, &capacity, &flags};
  err = launch_cooperative(reinterpret_cast<const void*>(compress_kernel), capacity,
                           compress_args, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  auto* seen_b = static_cast<uint8_t*>(seen);
  auto* src_i = static_cast<const int*>(src);
  auto* dst_i = static_cast<const int*>(dst);
  auto* mask_b = static_cast<const uint8_t*>(mask);
  int* union_flags = flags + kFlagsPerKernel;
  auto* done = reinterpret_cast<uint8_t*>(flags + 2 * kFlagsPerKernel);
  void* union_args[] = {&p, &seen_b, &src_i, &dst_i, &mask_b, &n, &vcap, &union_flags, &done};
  const int64_t items = kParity ? 2 * static_cast<int64_t>(n) : n;
  err = launch_cooperative(reinterpret_cast<const void*>(union_kernel<kParity>),
                           items > capacity ? items : capacity, union_args, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// parent: int32[capacity], updated in place; seen: uint8[capacity] or null;
// src: int32[n] or null (then src[i] = i); dst: int32[n]; mask: uint8[n]
// or null; scratch: 24 + n bytes of device memory, 4-byte aligned (the
// kernels' round flags, cleared here, then the union kernel's done bytes).
// Enqueues the compress kernel and, when n > 0, the union kernel on the
// stream, with no host sync.  n = 0 is compress alone.
int uf_union_launch(void* parent, void* seen, const void* src, const void* dst,
                    const void* mask, int n, int capacity, void* scratch, void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaGetLastError());
  return union_launch<false>(parent, seen, src, dst, mask, n, capacity, capacity, scratch,
                             static_cast<cudaStream_t>(stream));
}

// The parity union of the bipartiteness check (replaces the JAX package's
// parity_union_edges, gelly_streaming_tpu/ops/unionfind.py:145-162, and the
// seen update of BipartitenessCheck.update): parent2: int32[2 * capacity],
// updated in place; seen: uint8[capacity] or null, marked in the original
// vertex space; src, dst: int32[n]; mask: uint8[n] or null (masked rows are
// the JAX fold's (0, 0) self-unions, which change nothing); scratch: 24 + 2n
// bytes.  The concatenated [2n] edge arrays of the JAX function are never
// built: the kernel forms both doubled edges of a row from one read.
int uf_parity_union_launch(void* parent2, void* seen, const void* src, const void* dst,
                           const void* mask, int n, int capacity, void* scratch, void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaGetLastError());
  return union_launch<true>(parent2, seen, src, dst, mask, n, capacity, 2 * capacity, scratch,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
