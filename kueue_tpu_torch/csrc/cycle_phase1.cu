// Kernel cycle_phase1: phase 1 of the interactive admission cycle.
//
// Replaces phase1_classify (kueue_tpu/ops/assign_kernel.py:199) with
// its per-cell tests (cell_masks, :144): for every head and flavor
// candidate, does each requested cell fit the cycle-start available()
// (fits), the potentialAvailable and nominal quota (the preempt-mode
// test), and does it push the ClusterQueue above its subtree quota
// (borrows, only under a cohort)? Then per head the masked
// score-argmax over fitting candidates (chosen) and, for heads with
// none, over preempt-eligible ones (preempt_k).
//
// One warp per head, one lane per candidate k (K <= 32): the body is
// cycle_body::classify_head (cycle_body.cuh), shared with plan_phase1.cu
// (the same body under a scenario axis). The argmax is a warp shuffle
// reduction that keeps the larger score and, on equal scores, the lower
// k — jnp.argmax's first-max rule, under the same int64 sentinel
// -(2^62) for ineligible candidates, so all-zero scores give the first
// fit. Pad rows (cq_row < 0) gather row 0 as the JAX code does, and get
// chosen = -1.
//
// What bounds it: bytes. Each head reads its K*C cells and qty and five
// [N, FR] values per cell (gathers that hit L2 for the headline's 1000
// rows), ~ W*K*C*(4+8+5*8) bytes; latency of the dependent gathers
// dominates at the headline size (W = 1024, K = 8, C = 16).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cycle_body.cuh"

namespace cycle1 {
namespace {

constexpr int kThreads = 128;

using Args = cycle_body::Phase1View;

__global__ void phase1(Args a) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= a.W) return;  // warp-uniform
  cycle_body::classify_head(a, w, threadIdx.x & 31);
}

}  // namespace
}  // namespace cycle1

// ints: W K C N FR; ptrs: the Args pointers in order. Returns
// cudaGetLastError() (cudaErrorInvalidValue on a bad argument list).
extern "C" int cycle_phase1(const int* ints, int n_ints, void* const* p, int n_ptrs,
                            void* stream) {
  if (n_ints != 5 || n_ptrs != 14) return (int)cudaErrorInvalidValue;
  cycle1::Args a;
  a.W = ints[0]; a.K = ints[1]; a.C = ints[2]; a.FR = ints[4];
  if (a.K < 1 || a.K > 32) return (int)cudaErrorInvalidValue;
  int i = 0;
  a.cq_row = (const int*)p[i++];
  a.cells = (const int*)p[i++];
  a.qty = (const long long*)p[i++];
  a.valid = (const uint8_t*)p[i++];
  a.score = (const long long*)p[i++];
  a.avail = (const long long*)p[i++];
  a.potential = (const long long*)p[i++];
  a.subtree = (const long long*)p[i++];
  a.local = (const long long*)p[i++];
  a.nominal = (const long long*)p[i++];
  a.parent = (const int*)p[i++];
  a.chosen = (int*)p[i++];
  a.borrows = (uint8_t*)p[i++];
  a.preempt_k = (int*)p[i++];
  if (a.W > 0) {
    const int per_block = cycle1::kThreads / 32;
    const int blocks = (a.W + per_block - 1) / per_block;
    cycle1::phase1<<<blocks, cycle1::kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
