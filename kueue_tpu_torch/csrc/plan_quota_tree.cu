// Kernel plan_quota_tree: the planner's quota recurrences, one quota
// state per scenario (kernel B14, first of its three launches).
//
// Replaces what kueue_tpu/ops/plan_kernel.py:36 (_solve_scenarios)
// recomputes inside its jax.vmap body for every scenario: subtree_quota
// from that scenario's nominal and lending limits (so a nominal delta
// flows through guaranteed and available), usage_tree from its leaf
// usage, available_all and potential_available_all (the JAX
// phase1_classify and solve_cycle_segmented each rebuild them; XLA
// shares the work). One C entry runs the four recurrences of
// quota_tree.cu (their bodies: quota_tree_body.cuh) in turn on the
// stream, each one launch over a (FR column, scenario) grid: blockIdx.y
// is the scenario, whose [N, FR] tensors start at s*N*FR; parent and
// level_mask are shared.
//
// What bounds it: bytes, ~8 [S, N, FR] int64 tensors read or written
// (at planner-sweep-50k S=129, N=1050, FR=17: ~18 MB each), ~150 MB in
// all, ~45 us at 3.35 TB/s; the strided column walk of the row-major
// layout (each block reads one int64 per 136-byte row) wastes most of
// every sector, which a first version accepts.
//
// The usage tree is written where the caller points `usage` (the
// planner's packed result), and plan_phase2 then updates it in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quota_tree_body.cuh"

namespace plan_qt {
namespace {

constexpr int kThreads = 256;

struct Args {
  int S, N, FR, D;
  const int* parent;              // [N]
  const uint8_t* level_mask;      // [D+1,N]
  const long long* nominal;       // [S,N,FR]
  const long long* lending;       // [S,N,FR]
  const long long* borrowing;     // [S,N,FR]
  const long long* local;         // [S,N,FR] leaf usage
  long long* subtree;             // [S,N,FR] out
  long long* guaranteed;          // [S,N,FR] out
  long long* usage;               // [S,N,FR] out: the usage tree
  long long* avail;               // [S,N,FR] out
  long long* potential;           // [S,N,FR] out
};

__device__ __forceinline__ size_t off(const Args& a) {
  return (size_t)blockIdx.y * a.N * a.FR;
}

__global__ void subtree_pass(Args a) {
  const size_t o = off(a);
  quota_tree_body::bottom_up(0, a.parent, a.level_mask, a.N, a.FR, a.D, a.nominal + o,
                             a.lending + o, a.subtree + o, a.guaranteed + o);
}

__global__ void usage_pass(Args a) {
  const size_t o = off(a);
  quota_tree_body::bottom_up(1, a.parent, a.level_mask, a.N, a.FR, a.D, a.local + o,
                             a.guaranteed + o, a.usage + o, nullptr);
}

__global__ void avail_pass(Args a) {
  const size_t o = off(a);
  quota_tree_body::top_down(0, a.parent, a.level_mask, a.N, a.FR, a.D, a.subtree + o,
                            a.guaranteed + o, a.borrowing + o, a.usage + o, a.avail + o);
}

__global__ void potential_pass(Args a) {
  const size_t o = off(a);
  quota_tree_body::top_down(1, a.parent, a.level_mask, a.N, a.FR, a.D, a.subtree + o,
                            a.guaranteed + o, a.borrowing + o, nullptr, a.potential + o);
}

}  // namespace
}  // namespace plan_qt

// ints: S N FR D; ptrs: the Args pointers in order. Returns the first
// launch error (cudaErrorInvalidValue on a bad argument list or a
// scenario count above the grid's y limit).
extern "C" int plan_quota_tree(const int* ints, int n_ints, void* const* p, int n_ptrs,
                               void* stream) {
  if (n_ints != 4 || n_ptrs != 11) return (int)cudaErrorInvalidValue;
  plan_qt::Args a;
  a.S = ints[0]; a.N = ints[1]; a.FR = ints[2]; a.D = ints[3];
  if (a.S > 65535) return (int)cudaErrorInvalidValue;
  int i = 0;
  a.parent = (const int*)p[i++];
  a.level_mask = (const uint8_t*)p[i++];
  a.nominal = (const long long*)p[i++];
  a.lending = (const long long*)p[i++];
  a.borrowing = (const long long*)p[i++];
  a.local = (const long long*)p[i++];
  a.subtree = (long long*)p[i++];
  a.guaranteed = (long long*)p[i++];
  a.usage = (long long*)p[i++];
  a.avail = (long long*)p[i++];
  a.potential = (long long*)p[i++];
  if (a.S == 0 || a.N == 0) return (int)cudaGetLastError();
  const dim3 grid(quota_tree_body::grid_for(a.FR), a.S);
  cudaStream_t s = (cudaStream_t)stream;
  plan_qt::subtree_pass<<<grid, plan_qt::kThreads, 0, s>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  plan_qt::usage_pass<<<grid, plan_qt::kThreads, 0, s>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  plan_qt::avail_pass<<<grid, plan_qt::kThreads, 0, s>>>(a);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  plan_qt::potential_pass<<<grid, plan_qt::kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
