// Masked-CSR triangle count of K panes on Hopper (sm_90a) behind a plain C
// interface, loaded with ctypes (gelly_streaming_tpu_torch/ops/_cuda.py,
// ops/csr_triangles.py).
//
// Replaces two XLA programs of the JAX package (gelly_streaming_tpu/library/
// triangles.py): _superpane_count_fn (:229-259), the superbatch plane's
// vmapped count over K panes, and _count_kernel_impl (:322-338), the same
// count for one pane past the dense kernels' vertex bound.  Both build a
// padded neighbor table [n_v, D] of the pane's edges in both directions and
// reduce, for every canonical edge (u, v), an [E, D, D] equality tensor:
// |N(u) & N(v)| summed over the edges is three times the pane's triangle
// count.  That is E * D^2 work and, in XLA or eager PyTorch, E * D^2 bytes
// of intermediates (2^31 bytes a pane at E = 2^17, D = 128; a hub row of
// 2^17 neighbors cannot be counted at all).
//
// Here no [E, D, D] and no [n_v, D] table is formed.  All K panes at once,
// in three C calls around the port's stable radix sort (csrc/
// neighborhoods.cu, nb_sort_launch: 8-bit digits, one-sweep passes with a
// decoupled look-back, masked rows dropped, the pass count planned on the
// device), which ops/csr_triangles.py calls between them:
//   csr_expand_launch writes two directed entries a slot, (row, col) with
//   row = pane * n_v + u and col = v, and the reverse, masked where the slot
//   is not ok or an id lies outside [0, n_v).  Where (row << cb | col), cb
//   the bits of n_v - 1, fits 31 bits, row carries that fused key and one
//   sort orders the entries by (row, col); otherwise the wrapper sorts by
//   col, then stably by row;
//   csr_prefix_mask_launch (the two-sort case) marks the first sort's
//   valid rows, whose count lies on the device, for the second;
//   csr_count_launch: csr_bounds_kernel cuts the sorted entries into rows
//   (first and one past the last position of each (pane, vertex) row: the
//   CSR of the pane's adjacency, each row's columns ascending);
//   csr_intersect_warp_kernel gives each slot to a warp: the lanes take the
//   shorter of the two rows 32 entries at a time and binary-search each in
//   the longer one, counting equal entries (so duplicate edges count as the
//   JAX multiset does), so a hub row costs O(d_small * log d_hub) and not
//   O(d_hub); a slot whose shorter row passes kHeavy entries is appended to
//   a list that csr_intersect_block_kernel works through a block an edge;
//   sums are 64-bit, one atomic add a warp and pane; csr_finish_kernel
//   divides each pane's sum by 3.
// The count is therefore a function of the masked edge multiset alone; on
// deduplicated edges whose rows fit the table's D (every caller's case) it
// equals the JAX functions exactly.  Ids outside [0, n_v) are dropped here
// (the JAX table would clamp them); callers pass compacted ids.
//   Bound on the H100 (bytes): u, v and ok read once (9 B a slot) and K
// int64 counts written.  The design moves more: the entries (9 B each, 2
// a slot) are written, sorted (each sort pass reads and writes 8 B an
// entry) and read back, and the searches reread rows (from L2 at these
// sizes).  A simple kernel that is right comes first: no wgmma, no TMA.
//   Scratch (csr_scratch_bytes, this file's part): two int32 [K n_v] row
// bound tables, K uint64 sums and the heavy-slot list (K E + 1 int32), each
// piece 256-byte aligned; ops/csr_triangles.scratch_bytes adds the entries
// (2 K E int32 rows and cols, 2 K E mask bytes) and the sort's scratch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kHeavy = 1024;  // shorter-row length past which a block takes the slot
constexpr int kWarpBlocks = 132 * 8;
constexpr int kHeavyBlocks = 132 * 2;
constexpr int kValid = 1;  // meta[1]: the sorted entries (nb_sorted_launch's meta)

struct Layout {
  size_t row_start, row_end, acc, heavy, total;
};

Layout layout(int k, int e, int n_v) {
  auto up = [](size_t x) { return (x + 255) & ~static_cast<size_t>(255); };
  const size_t rows = static_cast<size_t>(k) * n_v;
  Layout l;
  l.row_start = 0;
  l.row_end = up(rows * 4);
  l.acc = l.row_end + up(rows * 4);
  l.heavy = l.acc + up(static_cast<size_t>(k) * 8);
  l.total = l.heavy + up((static_cast<size_t>(k) * e + 1) * 4);
  return l;
}

template <typename T>
T* at(void* base, size_t offset) {
  return reinterpret_cast<T*>(static_cast<char*>(base) + offset);
}

__device__ __forceinline__ bool slot_valid(const int* __restrict__ u, const int* __restrict__ v,
                                           const uint8_t* __restrict__ ok, long long i, int n_v) {
  const int a = u[i], b = v[i];
  return ok[i] != 0 && a >= 0 && a < n_v && b >= 0 && b < n_v;
}

// Two entries a slot: rows (pane * n_v + u) << shift | (shift ? v : 0),
// cols v, and the reverse; mask 0 for a slot that is no edge.
__global__ void __launch_bounds__(kThreads)
csr_expand_kernel(const int* __restrict__ u, const int* __restrict__ v, const uint8_t* __restrict__ ok,
                  long long slots, int e, int n_v, int shift, int* __restrict__ rows, int* __restrict__ cols,
                  uint8_t* __restrict__ mask) {
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < slots;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const bool live = slot_valid(u, v, ok, i, n_v);
    const int a = live ? u[i] : 0, b = live ? v[i] : 0;
    const int base = static_cast<int>(i / e) * n_v;
    rows[2 * i] = shift ? ((base + a) << shift) | b : base + a;
    rows[2 * i + 1] = shift ? ((base + b) << shift) | a : base + b;
    cols[2 * i] = b;
    cols[2 * i + 1] = a;
    mask[2 * i] = mask[2 * i + 1] = live;
  }
}

__global__ void __launch_bounds__(kThreads)
csr_prefix_mask_kernel(const int* __restrict__ meta, long long n, uint8_t* __restrict__ mask) {
  const long long valid = meta[kValid];
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads)
    mask[i] = i < valid;
}

// Rows of the sorted entries: row_start / row_end (one past) of each
// (pane, vertex) row that has entries.
__global__ void __launch_bounds__(kThreads)
csr_bounds_kernel(const int* __restrict__ rows, const int* __restrict__ meta, int shift, int* __restrict__ row_start,
                  int* __restrict__ row_end) {
  const int n = meta[kValid];
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n; i += gridDim.x * kThreads) {
    const int row = rows[i] >> shift;
    if (i == 0 || (rows[i - 1] >> shift) != row) row_start[row] = i;
    if (i == n - 1 || (rows[i + 1] >> shift) != row) row_end[row] = i + 1;
  }
}

// Entries of the sorted row cols[lo, hi) equal to x.
__device__ __forceinline__ int count_in(const int* __restrict__ cols, int lo, int hi, int x) {
  int l = lo, h = hi;
  while (l < h) {
    const int m = l + ((h - l) >> 1);
    if (__ldg(cols + m) < x)
      l = m + 1;
    else
      h = m;
  }
  int c = 0;
  while (l < hi && __ldg(cols + l) == x) {
    ++c;
    ++l;
  }
  return c;
}

struct Rows {
  int s, e, ls, le;  // the shorter row [s, e), the longer [ls, le)
};

__device__ __forceinline__ Rows slot_rows(const int* __restrict__ u, const int* __restrict__ v, long long i, int e,
                                          int n_v, const int* __restrict__ row_start, const int* __restrict__ row_end) {
  const long long base = (i / e) * static_cast<long long>(n_v);
  const long long ru = base + u[i], rv = base + v[i];
  const int su = row_start[ru], eu = row_end[ru], sv = row_start[rv], ev = row_end[rv];
  return eu - su <= ev - sv ? Rows{su, eu, sv, ev} : Rows{sv, ev, su, eu};
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(kFull, x, d);
  return x;
}

// A warp a slot, grid-stride; slots whose shorter row passes kHeavy go to
// the heavy list.  A warp's slots ascend, so its pane changes at most K
// times: the lanes' sums are added to acc[pane] when it does.
__global__ void __launch_bounds__(kThreads)
csr_intersect_warp_kernel(const int* __restrict__ u, const int* __restrict__ v, const uint8_t* __restrict__ ok,
                          long long slots, int e, int n_v, const int* __restrict__ row_start,
                          const int* __restrict__ row_end, const int* __restrict__ cols,
                          unsigned long long* __restrict__ acc, int* __restrict__ heavy) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  long long pane = -1;
  unsigned long long sum = 0;
  for (long long i = blockIdx.x * static_cast<long long>(kWarps) + (threadIdx.x >> 5); i < slots; i += warps) {
    const long long p = i / e;
    if (p != pane) {
      const unsigned long long w = warp_sum(sum);
      if (lane == 0 && pane >= 0 && w) atomicAdd(acc + pane, w);
      pane = p;
      sum = 0;
    }
    if (!slot_valid(u, v, ok, i, n_v)) continue;
    const Rows r = slot_rows(u, v, i, e, n_v, row_start, row_end);
    if (r.e - r.s > kHeavy) {
      if (lane == 0) heavy[1 + atomicAdd(heavy, 1)] = static_cast<int>(i);
      continue;
    }
    for (int j = r.s + lane; j < r.e; j += 32) sum += count_in(cols, r.ls, r.le, __ldg(cols + j));
  }
  const unsigned long long w = warp_sum(sum);
  if (lane == 0 && pane >= 0 && w) atomicAdd(acc + pane, w);
}

// The heavy slots, a block a slot.
__global__ void __launch_bounds__(kThreads)
csr_intersect_block_kernel(const int* __restrict__ u, const int* __restrict__ v, int e, int n_v,
                           const int* __restrict__ row_start, const int* __restrict__ row_end,
                           const int* __restrict__ cols, unsigned long long* __restrict__ acc,
                           const int* __restrict__ heavy) {
  const int lane = threadIdx.x & 31;
  const int count = heavy[0];
  for (int h = blockIdx.x; h < count; h += gridDim.x) {
    const long long i = heavy[1 + h];
    const Rows r = slot_rows(u, v, i, e, n_v, row_start, row_end);
    unsigned long long sum = 0;
    for (int j = r.s + threadIdx.x; j < r.e; j += kThreads) sum += count_in(cols, r.ls, r.le, __ldg(cols + j));
    sum = warp_sum(sum);
    if (lane == 0 && sum) atomicAdd(acc + i / e, sum);
  }
}

__global__ void csr_finish_kernel(const unsigned long long* __restrict__ acc, int k, long long* __restrict__ out) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < k) out[p] = static_cast<long long>(acc[p] / 3ull);
}

int grid_for(long long items, int per_block, int cap) {
  const long long g = (items + per_block - 1) / per_block;
  return static_cast<int>(g < 1 ? 1 : (g < cap ? g : cap));
}

bool valid_shape(int k, int e, int n_v) {
  return k > 0 && e > 0 && n_v > 0 && static_cast<long long>(k) * e < (1ll << 30) &&
         static_cast<long long>(k) * n_v < (1ll << 31) - 1;
}

}  // namespace

extern "C" {

// The scratch bytes of csr_count_launch over k panes of e slots with ids
// in [0, n_v).
long long csr_scratch_bytes(int k, int e, int n_v) {
  return valid_shape(k, e, n_v) ? static_cast<long long>(layout(k, e, n_v).total) : 0;
}

// u, v: int32[k, e]; ok: bool[k, e]; shift: 0, or the bits of n_v - 1 to
// fuse the column into the row key.  rows, cols: int32[2 k e]; mask:
// bool[2 k e].
int csr_expand_launch(const void* u, const void* v, const void* ok, int k, int e, int n_v, int shift, void* rows,
                      void* cols, void* mask, void* stream) {
  if (!valid_shape(k, e, n_v) || shift < 0 || shift > 30) return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = static_cast<long long>(k) * e;
  csr_expand_kernel<<<grid_for(slots, kThreads, 132 * 16), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(u), static_cast<const int*>(v), static_cast<const uint8_t*>(ok), slots, e, n_v, shift,
      static_cast<int*>(rows), static_cast<int*>(cols), static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

// mask[i] = i < meta[1] for i < n (meta: nb_sorted_launch's).
int csr_prefix_mask_launch(const void* meta, long long n, void* mask, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  csr_prefix_mask_kernel<<<grid_for(n, kThreads, 132 * 16), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), n, static_cast<uint8_t*>(mask));
  return static_cast<int>(cudaGetLastError());
}

// After the sort: rows, cols hold the meta[1] valid entries ordered by
// (row, col) (rows as csr_expand_launch wrote them, with the same shift).
// out: int64[k], the triangle count of each pane (its masked edges' sum of
// |N(u) & N(v)|, over 3).
int csr_count_launch(const void* u, const void* v, const void* ok, int k, int e, int n_v, int shift,
                     const void* rows, const void* cols, const void* meta, void* out, void* scratch,
                     long long bytes, void* stream) {
  if (!valid_shape(k, e, n_v)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(k, e, n_v);
  if (bytes < static_cast<long long>(l.total)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* up = static_cast<const int*>(u);
  const auto* vp = static_cast<const int*>(v);
  const auto* cp = static_cast<const int*>(cols);
  const auto* mp = static_cast<const int*>(meta);
  int* row_start = at<int>(scratch, l.row_start);
  int* row_end = at<int>(scratch, l.row_end);
  auto* acc = at<unsigned long long>(scratch, l.acc);
  int* heavy = at<int>(scratch, l.heavy);
  const long long slots = static_cast<long long>(k) * e;
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.heavy + 4, s);  // the bound tables, sums and heavy count
  if (err != cudaSuccess) return static_cast<int>(err);
  csr_bounds_kernel<<<grid_for(2 * slots, kThreads, 132 * 16), kThreads, 0, s>>>(static_cast<const int*>(rows), mp,
                                                                                 shift, row_start, row_end);
  csr_intersect_warp_kernel<<<grid_for(slots, kWarps, kWarpBlocks), kThreads, 0, s>>>(
      up, vp, static_cast<const uint8_t*>(ok), slots, e, n_v, row_start, row_end, cp, acc, heavy);
  csr_intersect_block_kernel<<<kHeavyBlocks, kThreads, 0, s>>>(up, vp, e, n_v, row_start, row_end, cp, acc, heavy);
  csr_finish_kernel<<<(k + 127) / 128, 128, 0, s>>>(acc, k, static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
