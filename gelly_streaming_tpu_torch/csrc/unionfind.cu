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
// grid-wide syncs, and counters in the caller's scratch say whether a round
// changed anything, so no round trip to the host decides when to stop.
// One C call folds a whole batch.
//
// State: parent int32[C] (a forest; parent[r] == r marks a root) and seen
// uint8[C] (the bool tensor's bytes).  Both are updated in place.
//
// Ids outside [0, C) (streams that validate nothing) follow JAX's index
// rules: an endpoint's root is read at the index JAX's gather reads (below
// 0 counts from the end once, then clamps into [0, C)), and seen is a
// scatter (below 0 counts from the end, an index still outside is dropped).
//
// compress_kernel: one ordinary pass, four nodes a thread (a 16-byte load
// of parent): each node follows its pointer at most kWalk steps and stops
// at its root, and its entry is written only where it moved.  A flat state
// (init_parent, or a state some other writer left flat) is one read of
// parent and one gather a node, with no write.  A node whose walk did not
// reach a root flags the call: header[kCompressEpoch] = the call's epoch,
// a number the launcher never used before (the header is not cleared: any
// other value there, stale or garbage, reads as "not flagged", and a stale
// value equal to the epoch would only cost a round that moves nothing).
// The pass clears the rest of the header.  Flagged, the doubling rounds
// (parent[v] = parent[parent[v]] for all v, in place, until a round moves
// nothing; a read may see an entry already advanced in the same round,
// which only jumps further, so depth d is flat after ceil(log2 d) + 1
// rounds) run in the cooperative kernel that follows on the stream: the
// union kernel, before its first hook, or for a call with no edges
// compress_rounds_kernel, which returns at once when the pass did not flag
// the call.  So no round trip to the host decides, and a flat or shallow
// state pays one pass.  The split that chose this (chip_smoke.py phase 7
// with the parent's source): the parent's compress was a memset of the
// header, a cooperative launch, one full round and one grid-wide sync even
// on a flat state.  The compress kernels run only when the caller does not
// know the state to be flat: every union call leaves it flat, and the
// wrappers skip them on a state no one else wrote since (ops/unionfind.py).

// union_kernel: the JAX loop on a flat forest, in rounds.
//   Round 0 is one pass over every item (edge): it reads both endpoints'
//   roots (one load each: the forest is flat), marks seen (a byte read
//   first and written only where it is 0: on a late batch nearly every
//   vertex is seen, and a read costs less than a scattered store), and
//   where the roots differ lowers the larger root's entry to the smaller
//   with atomicMin (the scatter-min of the JAX body), issued only where a
//   read shows it would lower: many edges of a round may meet one root, and
//   atomics on one address serialize.  Items whose roots differ are
//   compacted into a worklist as node pairs, and roots an atomicMin takes
//   from root to non-root into a list of lowered roots (one atomicAdd a
//   block and 256 items, offsets by warp ballots); order is free, as the
//   fixed point is unique.
//   Between rounds, doubling runs until nothing moves, over the lowered
//   roots alone, or over every node in order (coalesced) once the lowered
//   roots are more than a quarter of the nodes (a fresh state's first
//   batch).  Only roots are ever lowered, so a vertex that was not a root
//   when the call began still points at an old root, and every lowered
//   root points at a current root after the doubling: a find is two loads,
//   vertex -> old root -> its root, and no pass over all C entries is
//   needed between rounds on a late batch.
//   Round r > 0 hooks only round r - 1's worklist and compacts the pairs
//   that still differ.  The loop ends when a round finds no pair whose
//   roots differ; one full pass then points every entry at its root (two
//   levels at most), so the state leaves the call flat.  A call that lowers
//   nothing (a late batch of a live stream) is one pass over the items.
//   Rows whose mask byte is 0 are skipped (the JAX fold turns them into
//   (0, 0) self-loops, which change nothing).
// Why the fixed point is JAX's, bit for bit: entries only ever decrease and
// only to ids of the same component, so the loop ends, and the smallest
// root a component came in with is never lowered: every vertex ends
// pointing at it (after init_parent and unions, the component's smallest
// vertex id).  Why the worklist loses no edge: a find in round r returns a
// root of round r's start or a root lowered during round r, never an entry
// lowered in an earlier round (doubling made those point past themselves).
// So a round lowers only its own roots, and a link older than the round is
// never cut.  A hook may lower a root that another hook of the same round
// already lowered, cutting the link that lowering made; the item that made
// it differed in that round, so it is on the worklist, is looked at again
// and relinks the two trees.  An item whose roots agreed therefore stays
// agreed once every link its agreement rests on is re-examined, and the
// loop stops only when no item on the worklist differs.
//
// The first design hooked by atomicCAS from find walks with path halving
// (ECL-CC's scheme).  It was exact, but a walk can start at the top of a
// chain that other threads built one link each, and one thread then walks
// the whole chain: a 2^20-vertex path inserted in reverse order took 25 ms
// on the H100 against 0.25 ms shuffled; in rounds it took 0.43 ms
// (chip_smoke.py phase 6).  Rounds bound every find to two loads, and the
// work by the number of rounds.
// The hook and doubling round counts land in the scratch header
// (chip_smoke.py prints them): a fresh 2^20-vertex state's first 2^21-edge
// batch takes 4 hook rounds and 10-13 doubling rounds, a late batch one
// hook round and none.
//
// The parity union (uf_parity_union_launch) is the same union kernel on the
// doubled vertex space of the bipartiteness check: node 2v is "v on side A",
// 2v + 1 "v on side B", and a row (u, w) asserts opposite sides, the edges
// (2u, 2w + 1) and (2u + 1, 2w).  The JAX package concatenates those into
// two [2n] arrays before its union; here each item forms its edge from the
// row it reads (int32 arithmetic with wrap, then JAX's gather rule over the
// 2C nodes), and seen is marked in the original space.
//
// Bound on the H100 (bytes), for a 2^21-edge batch at C = 2^20 and 3.35
// TB/s: the union reads src and dst (8 B an edge) and parent (4 B a
// vertex) and writes seen (1 B a vertex): 16.8 MB + 4.2 MB + 1.0 MB = 22.0
// MB, 6.57 us.  The parity union: src and dst (8 B a row), parent2 read (8
// B a vertex), seen (1 B): 26.2 MB, 7.83 us.  compress reads and writes
// parent: 8.4 MB, 2.50 us (2C nodes: 5.01 us); on a flat state its pass
// reads parent alone, and a kernel launch costs more than the bytes.  Each later round reads
// its worklist (8 B a pair) and the lowered roots; parent (4 MiB, 8 MiB doubled)
// and seen (1 MiB) stay resident in the 50 MB L2, where the root loads and
// atomics land.

#include <atomic>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWalk = 8;  // pointer steps a node takes in the compress pass

// The scratch header (int32 slots, cleared by the launcher), then the
// lowered roots (one slot a node), then two worklists (one slot an item).
enum Slot {
  kCompressFlags = 0,  // 3 round flags of the compress rounds
  kUnionFlags = 3,     // 3 round flags of the union's doubling rounds
  kCounts = 6,         // 3 worklist counts, used in turn
  kLowered = 9,        // roots lowered so far
  kHookRounds = 10,    // written at the end: hook rounds run
  kDoublingRounds = 11,
  kCompressRounds = 12,  // 1 + the doubling rounds after the pass; 0 when compress did not run
  kCompressEpoch = 13,   // the call's epoch where the pass left a node short of its root
  kHeaderInts = 16,
};

__device__ __forceinline__ int load_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// JAX's index rules: below 0 counts from the end once; a gather then
// clamps into [0, size)
__device__ __forceinline__ int jax_index(int i, int size) { return i < 0 ? i + size : i; }

__device__ __forceinline__ int clamp_index(int i, int size) {
  return i < 0 ? 0 : (i >= size ? size - 1 : i);
}

// One round's bookkeeping (every phase of a kernel counts rounds with one
// counter).  flags: int32[3], cleared before the launch.  Round r clears
// flags[(r + 1) % 3], the slot of round r - 2, which every thread read
// before the sync that ended round r - 1; a thread that changed anything
// sets flags[r % 3]; after the grid-wide sync every thread reads it, so all
// agree whether the round changed anything.
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

// The pass: four nodes a thread, each walked at most kWalk steps to its
// root.  A stale read (an entry another thread advanced) is an older
// ancestor, still on the node's path, and a root's entry never changes, so
// the root test is exact.
__global__ void __launch_bounds__(kThreads)
compress_kernel(int* __restrict__ parent, int nodes, int* __restrict__ header, int epoch) {
  if (blockIdx.x == 0 && threadIdx.x < kHeaderInts && threadIdx.x != kCompressEpoch) header[threadIdx.x] = 0;
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  if (i0 >= nodes) return;
  int p[4];
  if (i0 + 4 <= nodes && (reinterpret_cast<uintptr_t>(parent) & 15) == 0) {
    const int4 v = *reinterpret_cast<const int4*>(parent + i0);
    p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = i0 + k < nodes ? parent[i0 + k] : 0;
  }
  int q[4];
  bool open[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) q[k] = p[k], open[k] = i0 + k < nodes;
#pragma unroll 1
  for (int s = 0; s < kWalk; ++s) {
    int up[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) up[k] = open[k] ? parent[q[k]] : q[k];
    bool any = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (up[k] == q[k]) open[k] = false;
      q[k] = up[k];
      any |= open[k];
    }
    if (!any) break;
  }
  bool deep = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (i0 + k < nodes && q[k] != p[k]) parent[i0 + k] = q[k];
    deep |= open[k];
  }
  if (deep) store_relaxed(header + kCompressEpoch, epoch);
}

// Where the pass flagged the call: doubling rounds over every node until
// one moves nothing.  header[kCompressRounds] = 1 + the rounds run.  Every
// thread of a cooperative grid calls it.
__device__ void compress_rounds(cg::grid_group& grid, int* __restrict__ parent, int nodes, int* __restrict__ header,
                                int epoch) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int* flags = header + kCompressFlags;
  int round = 0;
  if (load_relaxed(header + kCompressEpoch) == epoch) {
    for (bool moved_any = true; moved_any;) {
      round_begin(flags, round, first);
      bool moved = false;
      for (int64_t i = first; i < nodes; i += stride) {
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
  if (first == 0) header[kCompressRounds] = 1 + round;
}

// A call with no edges: the rounds alone (nothing to do unless flagged).
__global__ void __launch_bounds__(kThreads)
compress_rounds_kernel(int* __restrict__ parent, int nodes, int* __restrict__ header, int epoch) {
  cg::grid_group grid = cg::this_grid();
  compress_rounds(grid, parent, nodes, header, epoch);
}

// Append x where take, to list at *count: one atomicAdd for the block, the
// offsets from warp ballots.  Every thread of the block calls it.  s:
// shared, kWarps + 1 ints.
template <typename T>
__device__ __forceinline__ void block_append(bool take, T x, T* list, int* count, int* s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(kFull, take);
  if (lane == 0) s[warp] = __popc(bal);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = s[w];
      s[w] = total;
      total += c;
    }
    s[kWarps] = total > 0 ? atomicAdd(count, total) : 0;
  }
  __syncthreads();
  if (take) list[s[kWarps] + s[warp] + __popc(bal & ((1u << lane) - 1u))] = x;
  __syncthreads();
}

// Item i's edge in node space: a, b, and whether the row is live.  kParity:
// rows are 2-item pairs, (2u, 2w + 1) at item row and (2u + 1, 2w) at item
// n + row; nodes = 2 * vcap.  Otherwise nodes = vcap.
struct Edge {
  int u, w, a, b;
  bool live, side0;
};

template <bool kParity>
__device__ __forceinline__ Edge item_edge(int64_t i, const int* __restrict__ src,
                                          const int* __restrict__ dst,
                                          const uint8_t* __restrict__ mask, int n, int nodes) {
  Edge e;
  const int side = kParity && i >= n ? 1 : 0;
  const int64_t row = i - side * static_cast<int64_t>(n);
  e.side0 = side == 0;
  e.live = mask == nullptr || mask[row] != 0;
  // src == nullptr: the edges (v, dst[v]) of merge_parents
  e.u = src != nullptr ? __ldg(src + row) : static_cast<int>(row);
  e.w = __ldg(dst + row);
  int a = e.u, b = e.w;
  if (kParity) {  // int32 arithmetic with wrap, as the JAX function's
    a = static_cast<int>(2u * static_cast<unsigned>(e.u) + side);
    b = static_cast<int>(2u * static_cast<unsigned>(e.w) + 1 - side);
  }
  e.a = clamp_index(jax_index(a, nodes), nodes);
  e.b = clamp_index(jax_index(b, nodes), nodes);
  return e;
}

// One hook: the roots of a and b (one load each on a flat forest, else
// two); where they differ, the larger lowered to the smaller.  *lowered:
// whether this hook took a root to a non-root (it is listed once).
__device__ __forceinline__ bool hook(int* parent, int a, int b, bool flat, bool* lowered, int* hi) {
  int ra = load_relaxed(parent + a);
  int rb = load_relaxed(parent + b);
  if (!flat) {
    ra = load_relaxed(parent + ra);
    rb = load_relaxed(parent + rb);
  }
  *lowered = false;
  if (ra == rb) return false;
  *hi = max(ra, rb);
  const int lo = min(ra, rb);
  // the atomic only where it lowers: many edges of one round may meet the
  // same root, and a read does not serialize on it as an atomic does
  if (load_relaxed(parent + *hi) > lo) *lowered = atomicMin(parent + *hi, lo) == *hi;
  return true;
}

// Where the two worklists start: after the header and the lowered list,
// 8-byte aligned.
__host__ __device__ __forceinline__ int64_t work_offset(int64_t nodes) {
  return (kHeaderInts + nodes + 1) / 2 * 2;
}

// items: n, or 2n for kParity; nodes: vcap, or 2 * vcap.  header:
// kHeaderInts cleared slots, then the lowered list (nodes) and the two
// worklists (items edges each, as node pairs).  epoch: the compress pass's
// (its rounds run first), or 0 where compress did not run.
template <bool kParity>
__global__ void __launch_bounds__(kThreads)
union_kernel(int* __restrict__ parent, uint8_t* __restrict__ seen,
             const int* __restrict__ src, const int* __restrict__ dst,
             const uint8_t* __restrict__ mask, int n, int vcap, int* __restrict__ header, int epoch) {
  __shared__ int s_work[kWarps + 1];
  __shared__ int s_low[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int nodes = kParity ? 2 * vcap : vcap;
  const int items = kParity ? 2 * n : n;
  int* flags = header + kUnionFlags;
  int* counts = header + kCounts;
  int* lowered = header + kHeaderInts;
  int2* work0 = reinterpret_cast<int2*>(header + work_offset(nodes));
  int2* work1 = work0 + items;
  if (epoch != 0) compress_rounds(grid, parent, nodes, header, epoch);

  // round 0: every item, on the flat forest
  for (int64_t c = blockIdx.x; c * kThreads < items; c += gridDim.x) {
    const int64_t i = c * kThreads + threadIdx.x;
    bool differ = false, low = false;
    int hi = 0;
    Edge e{};
    if (i < items) {
      e = item_edge<kParity>(i, src, dst, mask, n, nodes);
      if (e.live) {
        if (seen != nullptr && e.side0) {  // JAX's scatter rule
          const int su = jax_index(e.u, vcap), sw = jax_index(e.w, vcap);
          if (static_cast<unsigned>(su) < static_cast<unsigned>(vcap) && seen[su] == 0) seen[su] = 1;
          if (static_cast<unsigned>(sw) < static_cast<unsigned>(vcap) && seen[sw] == 0) seen[sw] = 1;
        }
        differ = hook(parent, e.a, e.b, true, &low, &hi);
      }
    }
    block_append(differ, make_int2(e.a, e.b), work1, counts + 1, s_work);
    block_append(low, hi, lowered, header + kLowered, s_low);
  }
  grid.sync();

  int r = 0;          // the hook round just run
  int dround = 0;     // doubling rounds run
  bool flat = false;  // the last doubling rounds went over every node
  for (;;) {
    const int pending = __ldcg(counts + (r + 1) % 3);  // round r's items that differed
    if (pending == 0) break;
    // doubling until none moves: over the lowered roots, or over every node
    // (in order, coalesced) once they are more than a quarter of them
    const int nl = __ldcg(header + kLowered);
    flat = nl > nodes / 4;
    for (bool moved_any = true; moved_any;) {
      round_begin(flags, dround, first);
      bool moved = false;
      for (int64_t k = first; k < (flat ? nodes : nl); k += stride) {
        const int x = flat ? static_cast<int>(k) : __ldcg(lowered + k);
        const int p = load_relaxed(parent + x);
        const int gp = load_relaxed(parent + p);
        if (gp != p) {
          store_relaxed(parent + x, gp);
          moved = true;
        }
      }
      moved_any = round_end(grid, flags, dround, moved);
    }
    // hook round r over round r - 1's worklist; counts[(r + 2) % 3], which
    // round r + 1 fills, was last read before round r - 1 ended
    ++r;
    if (first == 0) store_relaxed(counts + (r + 2) % 3, 0);
    const int2* in = r % 2 ? work1 : work0;
    int2* out = r % 2 ? work0 : work1;
    for (int64_t c = blockIdx.x; c * kThreads < pending; c += gridDim.x) {
      const int64_t k = c * kThreads + threadIdx.x;
      bool differ = false, low = false;
      int hi = 0;
      int2 ab = make_int2(0, 0);
      if (k < pending) {
        ab = __ldcg(in + k);
        differ = hook(parent, ab.x, ab.y, flat, &low, &hi);
      }
      block_append(differ, ab, out, counts + (r + 1) % 3, s_work);
      block_append(low, hi, lowered, header + kLowered, s_low);
    }
    grid.sync();
  }
  // every entry to its root: a lowered root points at one, any other entry
  // at an old root (nothing to do when nothing was lowered, or when the
  // last doubling rounds went over every node and the hook round after
  // them lowered nothing)
  if (!flat && __ldcg(header + kLowered) > 0) {
    for (int64_t v = first; v < nodes; v += stride) {
      const int p = load_relaxed(parent + v);
      const int gp = load_relaxed(parent + p);
      if (gp != p) store_relaxed(parent + v, gp);
    }
  }
  if (first == 0) {
    header[kHookRounds] = r + 1;
    header[kDoublingRounds] = dround;
  }
}

// The blocks of `kernel` (kThreads a block) that fit on the current device
// at once, queried once a kernel and device: the SM count and the
// occupancy do not change, and the queries cost more host time than the
// launch.
int resident_blocks(const void* kernel, cudaError_t* err) {
  struct Fit {
    const void* kernel;
    int device, blocks;
  };
  static std::mutex mu;
  static Fit cache[64];
  static int cached = 0;
  int device = 0;
  if ((*err = cudaGetDevice(&device)) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < cached; ++i)
    if (cache[i].kernel == kernel && cache[i].device == device) return cache[i].blocks;
  int sms = 0, per_sm = 0;
  if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0)) != cudaSuccess)
    return 0;
  if (cached < 64) cache[cached++] = {kernel, device, sms * per_sm};
  return sms * per_sm;
}

// A cooperative launch of `kernel` over `items` (at most the blocks that
// fit on the card at once; the kernels loop over the rest).
cudaError_t launch_cooperative(const void* kernel, int64_t items, void** args, cudaStream_t s) {
  cudaError_t err;
  const int64_t fit = resident_blocks(kernel, &err);
  if (err != cudaSuccess) return err;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  blocks = blocks < fit ? blocks : fit;
  blocks = blocks > 0 ? blocks : 1;
  return cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
                                     args, 0, s);
}

int64_t scratch_bytes_for(int64_t items, int64_t nodes) {
  return 4 * work_offset(nodes) + 2 * items * static_cast<int64_t>(sizeof(int2));
}

// An epoch no earlier call of this library used (never 0).
int next_epoch() {
  static std::atomic<unsigned> epochs{0};
  unsigned e = ++epochs;
  if (e == 0) e = ++epochs;
  return static_cast<int>(e);
}

// The compress pass over `nodes` entries unless the caller knows them flat
// (else the header cleared), then the union kernel (items > 0) or the
// compress rounds (items == 0, compress ran).
template <bool kParity>
int union_launch(void* parent, void* seen, const void* src, const void* dst, const void* mask,
                 int n, int vcap, int flat, void* scratch, long long scratch_bytes,
                 cudaStream_t s) {
  const int64_t nodes = kParity ? 2 * static_cast<int64_t>(vcap) : vcap;
  const int64_t items = kParity ? 2 * static_cast<int64_t>(n) : n;
  if (n < 0 || nodes > 0x7fffffff || items > 0x7fffffff ||
      scratch_bytes < scratch_bytes_for(items, nodes))
    return static_cast<int>(cudaErrorInvalidValue);
  int* p = static_cast<int*>(parent);
  int* header = static_cast<int*>(scratch);
  int nodes_i = static_cast<int>(nodes);
  int epoch = 0;
  cudaError_t err;
  if (flat) {
    err = cudaMemsetAsync(header, 0, kHeaderInts * sizeof(int), s);
  } else {
    epoch = next_epoch();
    compress_kernel<<<static_cast<unsigned>((nodes + 4 * kThreads - 1) / (4 * kThreads)), kThreads, 0, s>>>(
        p, nodes_i, header, epoch);
    err = cudaGetLastError();
    if (err == cudaSuccess && n == 0) {
      void* rounds_args[] = {&p, &nodes_i, &header, &epoch};
      err = launch_cooperative(reinterpret_cast<const void*>(compress_rounds_kernel), nodes, rounds_args, s);
    }
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  auto* seen_b = static_cast<uint8_t*>(seen);
  auto* src_i = static_cast<const int*>(src);
  auto* dst_i = static_cast<const int*>(dst);
  auto* mask_b = static_cast<const uint8_t*>(mask);
  void* union_args[] = {&p, &seen_b, &src_i, &dst_i, &mask_b, &n, &vcap, &header, &epoch};
  err = launch_cooperative(reinterpret_cast<const void*>(union_kernel<kParity>),
                           items > nodes ? items : nodes, union_args, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The scratch bytes of one call: `items` edges (n, or 2n for the parity
// union) into `nodes` entries (C, or 2C).
long long uf_scratch_bytes(long long items, long long nodes) {
  return scratch_bytes_for(items, nodes);
}

// parent: int32[capacity], updated in place; seen: uint8[capacity] or null;
// src: int32[n] or null (then src[i] = i); dst: int32[n]; mask: uint8[n]
// or null; flat: nonzero when the caller knows parent is flat (the compress
// kernels are then skipped); scratch: uf_scratch_bytes(n, capacity) bytes
// of device memory, 4-byte aligned (its header holds the round counts
// after the call: int32 slots 10, 11, 12 = hook, doubling and compress
// rounds, the last 1 + the doubling rounds after the pass, 0 when compress
// did not run).  Enqueues the compress pass (unless flat) and the union
// kernel, or for n = 0 (compress alone) the compress rounds kernel, on the
// stream, with no host sync.
int uf_union_launch(void* parent, void* seen, const void* src, const void* dst,
                    const void* mask, int n, int capacity, int flat, void* scratch,
                    long long scratch_bytes, void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaGetLastError());
  return union_launch<false>(parent, seen, src, dst, mask, n, capacity, flat, scratch,
                             scratch_bytes, static_cast<cudaStream_t>(stream));
}

// The parity union of the bipartiteness check (replaces the JAX package's
// parity_union_edges, gelly_streaming_tpu/ops/unionfind.py:145-162, and the
// seen update of BipartitenessCheck.update): parent2: int32[2 * capacity],
// updated in place; seen: uint8[capacity] or null, marked in the original
// vertex space; src, dst: int32[n]; mask: uint8[n] or null (masked rows are
// the JAX fold's (0, 0) self-unions, which change nothing); scratch:
// uf_scratch_bytes(2n, 2 * capacity) bytes.  The concatenated [2n] edge
// arrays of the JAX function are never built: each item forms its doubled
// edge from the row it reads.
int uf_parity_union_launch(void* parent2, void* seen, const void* src, const void* dst,
                           const void* mask, int n, int capacity, int flat, void* scratch,
                           long long scratch_bytes, void* stream) {
  if (capacity <= 0) return static_cast<int>(cudaGetLastError());
  return union_launch<true>(parent2, seen, src, dst, mask, n, capacity, flat, scratch,
                            scratch_bytes, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
