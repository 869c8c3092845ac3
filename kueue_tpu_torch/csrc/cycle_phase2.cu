// Kernel cycle_phase2: phase 2 of the interactive admission cycle.
//
// Replaces the phase-2 part of solve_cycle_segmented
// (kueue_tpu/ops/assign_kernel.py:475, packed at :631-655): the entry
// order (one global jnp.lexsort over all W heads), segmented_rank
// (:449) and the lax.scan step loop with _avail_along_path (:282) and
// the usage bubble-up (_bubble_usage, :315). It writes the packed
// int64[5, W] outcome: chosen, admitted, borrows, reserved, order.
//
// Grid: one block per root-cohort segment (CSR from the host), plus one
// block for the heads outside every segment (pads). Each block
//   1. puts every head's class (no-fit, borrowing) in shared memory;
//   2. gives each of its heads its global position in the entry order
//      (no-fit last, non-borrowing first, priority desc, timestamp
//      asc, head index asc: the index is jnp.lexsort's stability) by
//      counting the heads that order before it, and writes order[pos];
//   3. ranks its walkable heads (not no-fit, cq_row >= 0) by position;
//      ranks >= n_steps are dropped, as the JAX mode="drop" scatter
//      drops them, and so is a segment >= n_segments;
//   4. warp 0 walks them in rank order, one lane per cell (C <= 32):
//      available() root-down along the path, a warp vote for fits,
//      admit (chosen >= 0 and fits) or reserve (chosen < 0, a
//      preempt-mode candidate and reclaimWithinCohort != Any) with the
//      borrow or nominal cap, then the bubble of each node's
//      over-guaranteed delta up the path. Every lane reads its level
//      before any lane adds (atomicAdd), as the JAX .at[].add does.
// Steps 3 and 4 are cycle_body::rank_members and walk_segment
// (cycle_body.cuh), shared with plan_phase2.cu.
// `usage` is the cycle's usage tree, built by quota_tree from the leaf
// rows; the resident leaf buffer is never written here.
//
// What bounds it: the walk is sequential within a segment (each head
// sees its predecessors' admissions), so the chain of dependent global
// round trips (heads per root x (D+1) levels x 2) and the O(W) position
// count per head bound it, not bytes: the bytes bound (chip_smoke.py
// counts them) is well under a microsecond at the headline.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cycle_body.cuh"

namespace cycle2 {
namespace {

constexpr int kThreads = 128;

struct Args {
  int W, K, C, N, FR, D, n_segments, n_steps, n_seg, max_members;
  const int* cq_row;          // [W]
  const int* cells;           // [W,K,C]
  const long long* qty;       // [W,K,C]
  const long long* priority;  // [W]
  const long long* timestamp; // [W]
  const uint8_t* no_reclaim;  // [W]
  const int* chosen;          // [W]
  const uint8_t* borrows;     // [W,K]
  const int* preempt_k;       // [W]
  const int* seg_id;          // [W]
  const int* seg_offsets;     // [n_seg+1]
  const int* seg_members;
  const long long* nominal;   // [N,FR]
  const long long* borrowing_limit;
  const long long* subtree;
  const long long* guaranteed;
  const int* paths;           // [N,D+1]
  long long* usage;           // [N,FR] the cycle usage tree, updated
  long long* packed;          // [5,W]
};

// (no-fit << 1) | borrowing of the effective candidate
__device__ __forceinline__ uint8_t head_class(const Args& a, int x) {
  const int e = cycle_body::eff_k(a.chosen, a.preempt_k, x);
  if (e < 0) return 2;
  return a.borrows[(size_t)x * a.K + e] ? 1 : 0;
}

__device__ __forceinline__ bool orders_before(const Args& a, const uint8_t* cls, int y,
                                              int x) {
  if (cls[y] != cls[x]) return cls[y] < cls[x];
  const long long py = a.priority[y], px = a.priority[x];
  if (py != px) return py > px;
  const long long ty = a.timestamp[y], tx = a.timestamp[x];
  if (ty != tx) return ty < tx;
  return y < x;
}

__global__ void phase2(Args a) {
  extern __shared__ unsigned char smem[];
  uint8_t* cls = smem;
  int* spos = (int*)(smem + ((a.W + 7) & ~7));
  int* walk = spos + a.max_members;
  __shared__ int n_valid;

  const int b = blockIdx.x;
  const bool seg_block = b < a.n_seg;
  for (int j = threadIdx.x; j < a.W; j += blockDim.x) cls[j] = head_class(a, j);
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();

  const int W = a.W;
  long long* out_chosen = a.packed;
  long long* out_admitted = a.packed + W;
  long long* out_borrows = a.packed + 2 * (size_t)W;
  long long* out_reserved = a.packed + 3 * (size_t)W;
  long long* out_order = a.packed + 4 * (size_t)W;
  const int beg = seg_block ? a.seg_offsets[b] : 0;
  const int m = seg_block ? a.seg_offsets[b + 1] - beg : W;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int x = seg_block ? a.seg_members[beg + i] : i;
    if (!seg_block && a.seg_id[x] >= 0) continue;  // a segment block's
    int pos = 0;
    for (int y = 0; y < W; ++y) pos += orders_before(a, cls, y, x);
    out_order[pos] = x;
    out_chosen[x] = a.chosen[x];
    out_borrows[x] = cls[x] & 1;
    out_admitted[x] = 0;
    out_reserved[x] = 0;
    if (seg_block) spos[i] = (cls[x] & 2) || a.cq_row[x] < 0 ? -1 : pos;
  }
  if (!seg_block || b >= a.n_segments) return;
  __syncthreads();

  cycle_body::rank_members(spos, m, a.seg_members + beg, a.n_steps, walk, &n_valid);
  __syncthreads();
  if (threadIdx.x >= 32) return;

  cycle_body::Phase2View v;
  v.K = a.K; v.C = a.C; v.FR = a.FR; v.D = a.D;
  v.cq_row = a.cq_row; v.cells = a.cells; v.qty = a.qty; v.no_reclaim = a.no_reclaim;
  v.chosen = a.chosen; v.preempt_k = a.preempt_k;
  v.nominal = a.nominal; v.borrowing_limit = a.borrowing_limit;
  v.subtree = a.subtree; v.guaranteed = a.guaranteed; v.paths = a.paths;
  v.usage = a.usage; v.out_admitted = out_admitted; v.out_reserved = out_reserved;
  cycle_body::walk_segment(v, walk, min(n_valid, a.n_steps), threadIdx.x,
                           [cls](int h) { return (cls[h] & 1) != 0; });
}

}  // namespace
}  // namespace cycle2

// ints: W K C N FR D n_segments n_steps n_seg max_members; ptrs: the
// Args pointers in order. Returns cudaGetLastError()
// (cudaErrorInvalidValue on a bad argument list or a shape the kernel
// does not take).
extern "C" int cycle_phase2(const int* ints, int n_ints, void* const* p, int n_ptrs,
                            void* stream) {
  if (n_ints != 10 || n_ptrs != 19) return (int)cudaErrorInvalidValue;
  cycle2::Args a;
  a.W = ints[0]; a.K = ints[1]; a.C = ints[2]; a.N = ints[3]; a.FR = ints[4];
  a.D = ints[5]; a.n_segments = ints[6]; a.n_steps = ints[7]; a.n_seg = ints[8];
  a.max_members = ints[9];
  if (a.C > 32) return (int)cudaErrorInvalidValue;
  int i = 0;
  a.cq_row = (const int*)p[i++];
  a.cells = (const int*)p[i++];
  a.qty = (const long long*)p[i++];
  a.priority = (const long long*)p[i++];
  a.timestamp = (const long long*)p[i++];
  a.no_reclaim = (const uint8_t*)p[i++];
  a.chosen = (const int*)p[i++];
  a.borrows = (const uint8_t*)p[i++];
  a.preempt_k = (const int*)p[i++];
  a.seg_id = (const int*)p[i++];
  a.seg_offsets = (const int*)p[i++];
  a.seg_members = (const int*)p[i++];
  a.nominal = (const long long*)p[i++];
  a.borrowing_limit = (const long long*)p[i++];
  a.subtree = (const long long*)p[i++];
  a.guaranteed = (const long long*)p[i++];
  a.paths = (const int*)p[i++];
  a.usage = (long long*)p[i++];
  a.packed = (long long*)p[i++];
  if (a.W == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)((a.W + 7) & ~7) + 8 * (size_t)a.max_members;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        cycle2::phase2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  cycle2::phase2<<<a.n_seg + 1, cycle2::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
