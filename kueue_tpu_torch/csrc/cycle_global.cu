// Kernel B3', cycle_global: phase 2 of the unsegmented admission cycle.
//
// Replaces the phase-2 part of solve_cycle (kueue_tpu/ops/assign_kernel.py:343,
// the lax.scan at :446): the entry order (one jnp.lexsort over all W heads,
// :369-373) and ONE serial scan over every head in that order, with
// _avail_along_path (:282) and the usage bubble-up (_bubble_usage, :315).
// ShardedSolver (kueue_tpu_torch/parallel/sharded_solver.py) runs it on the
// gathered phase-1 output. It writes the packed int64[5, W] outcome (chosen,
// admitted, borrows, reserved, order) and updates the usage tree in place.
//
// One block:
//   1. copies the [N, FR] usage tree into shared memory (the wrapper refuses
//      a tree that does not fit) and puts every head's class (no-fit,
//      borrowing of its effective candidate) beside it;
//   2. gives each head its position in the entry order by counting the
//      heads that order before it (no-fit last, non-borrowing first,
//      priority desc, timestamp asc, head index asc: the index is
//      jnp.lexsort's stability), writes order[pos], and gives each walkable
//      head (not no-fit, cq_row >= 0) its rank among the walkable ones.
//      No-fit heads and pads sort last and neither admit nor reserve, so the
//      walk is the walkable prefix of the order;
//   3. warp 0 walks them in that order with cycle_body::walk_segment (the
//      step body of cycle_phase2 and plan_phase2): availability along the
//      path, admit or reserve, the bubble of the over-guaranteed delta;
//   4. copies the usage tree back.
//
// What bounds it: the walk is one serial chain over all W heads (each head
// sees every predecessor's admission), (D+1) x 2 dependent shared-memory
// round trips a head, plus the O(W^2) position count; the bytes bound
// (chip_smoke.py counts it from the inputs) is far below either. The
// segmented cycle_phase2 exists because independent root cohorts need not
// wait on each other; this kernel is the global order that ShardedSolver
// keeps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cycle_body.cuh"

namespace global_scan {
namespace {

constexpr int kThreads = 512;

struct Args {
  int W, K, C, N, FR, D;
  const int* cq_row;          // [W]
  const int* cells;           // [W,K,C]
  const long long* qty;       // [W,K,C]
  const long long* priority;  // [W]
  const long long* timestamp; // [W]
  const uint8_t* no_reclaim;  // [W]
  const int* chosen;          // [W]
  const uint8_t* borrows;     // [W,K]
  const int* preempt_k;       // [W]
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

__global__ void __launch_bounds__(kThreads) walk_all(Args a) {
  extern __shared__ long long smem_usage[];
  const size_t nfr = (size_t)a.N * a.FR;
  int* walk = (int*)(smem_usage + nfr);
  uint8_t* cls = (uint8_t*)(walk + a.W);
  __shared__ int n_walk;

  const int W = a.W;
  for (size_t j = threadIdx.x; j < nfr; j += blockDim.x) smem_usage[j] = a.usage[j];
  for (int j = threadIdx.x; j < W; j += blockDim.x) cls[j] = head_class(a, j);
  if (threadIdx.x == 0) n_walk = 0;
  __syncthreads();

  long long* out_chosen = a.packed;
  long long* out_admitted = a.packed + W;
  long long* out_borrows = a.packed + 2 * (size_t)W;
  long long* out_reserved = a.packed + 3 * (size_t)W;
  long long* out_order = a.packed + 4 * (size_t)W;
  for (int x = threadIdx.x; x < W; x += blockDim.x) {
    const bool walkable = cls[x] != 2 && a.cq_row[x] >= 0;
    int pos = 0, rank = 0;
    for (int y = 0; y < W; ++y) {
      const bool before = orders_before(a, cls, y, x);
      pos += before;
      rank += before && cls[y] != 2 && a.cq_row[y] >= 0;
    }
    out_order[pos] = x;
    out_chosen[x] = a.chosen[x];
    out_borrows[x] = cls[x] & 1;
    out_admitted[x] = 0;
    out_reserved[x] = 0;
    if (walkable) {
      walk[rank] = x;
      atomicAdd(&n_walk, 1);
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {
    cycle_body::Phase2View v;
    v.K = a.K; v.C = a.C; v.FR = a.FR; v.D = a.D;
    v.cq_row = a.cq_row; v.cells = a.cells; v.qty = a.qty; v.no_reclaim = a.no_reclaim;
    v.chosen = a.chosen; v.preempt_k = a.preempt_k;
    v.nominal = a.nominal; v.borrowing_limit = a.borrowing_limit;
    v.subtree = a.subtree; v.guaranteed = a.guaranteed; v.paths = a.paths;
    v.usage = smem_usage; v.out_admitted = out_admitted; v.out_reserved = out_reserved;
    cycle_body::walk_segment(v, walk, n_walk, threadIdx.x,
                             [cls](int h) { return (cls[h] & 1) != 0; });
  }
  __syncthreads();
  for (size_t j = threadIdx.x; j < nfr; j += blockDim.x) a.usage[j] = smem_usage[j];
}

}  // namespace
}  // namespace global_scan

// The dynamic shared memory one launch takes: the usage tree, the walk and
// the head classes; and what one block may take on the current device (the
// static n_walk counter takes a few bytes beside the dynamic part).
static long long smem_bytes(int W, int N, int FR) { return 8LL * N * FR + 5LL * W; }

extern "C" long long cycle_global_smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (long long)limit - 64;
}

// ints: W K C N FR D; ptrs: the Args pointers in order. Returns
// cudaGetLastError() (cudaErrorInvalidValue on a bad argument list, C > 32,
// or a usage tree that does not fit in one block's shared memory).
extern "C" int cycle_global(const int* ints, int n_ints, void* const* p, int n_ptrs,
                            void* stream) {
  if (n_ints != 6 || n_ptrs != 16) return (int)cudaErrorInvalidValue;
  global_scan::Args a;
  a.W = ints[0]; a.K = ints[1]; a.C = ints[2]; a.N = ints[3]; a.FR = ints[4];
  a.D = ints[5];
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
  a.nominal = (const long long*)p[i++];
  a.borrowing_limit = (const long long*)p[i++];
  a.subtree = (const long long*)p[i++];
  a.guaranteed = (const long long*)p[i++];
  a.paths = (const int*)p[i++];
  a.usage = (long long*)p[i++];
  a.packed = (long long*)p[i++];
  if (a.W == 0) return (int)cudaGetLastError();
  const long long smem = smem_bytes(a.W, a.N, a.FR);
  if (smem > cycle_global_smem_limit()) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        global_scan::walk_all, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  global_scan::walk_all<<<1, global_scan::kThreads, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
