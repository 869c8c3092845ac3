// Kernel plan_phase1: phase 1 of the admission cycle under the
// planner's scenario axis (kernel B14, second of its three launches).
//
// Replaces the phase1_classify of kueue_tpu/ops/plan_kernel.py:36
// (_solve_scenarios: jax.vmap over S scenarios, each classifying the
// one shared heads batch against its own quota state and scores). The
// body is cycle_phase1's (cycle_body::classify_head): one warp per
// (scenario, head), one lane per candidate k (K <= 32), the masked
// score-argmax with jnp.argmax's first-max rule. blockIdx.y is the
// scenario: its [N, FR] views (avail, potential, subtree, leaf usage,
// nominal) start at s*N*FR, its scores at s*W*K, its outputs chosen
// [S, W], borrows [S, W, K] and preempt_k [S, W] at s*W (s*W*K); the
// heads' cells, qty, valid and cq_row, and parent, are shared.
//
// What bounds it: bytes. Each (scenario, head) reads K*C cell indices
// and quantities (shared, L2-resident across scenarios) and five int64
// quota values per requested cell, and writes K + 8 bytes: at
// planner-sweep-50k (S=129, W=65,536, K=8, C=3) the gathers are the
// traffic; the bound counts each distinct input once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cycle_body.cuh"

namespace plan1 {
namespace {

constexpr int kThreads = 128;

struct Args {
  int S, W, K, C, N, FR;
  cycle_body::Phase1View v;  // scenario 0's pointers
};

__global__ void phase1(Args a) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (w >= a.W) return;  // warp-uniform
  const size_t s = blockIdx.y;
  const size_t q = s * a.N * a.FR, h = s * a.W, hk = h * a.K;
  cycle_body::Phase1View v = a.v;
  v.score += hk;
  v.avail += q;
  v.potential += q;
  v.subtree += q;
  v.local += q;
  v.nominal += q;
  v.chosen += h;
  v.borrows += hk;
  v.preempt_k += h;
  cycle_body::classify_head(v, w, threadIdx.x & 31);
}

}  // namespace
}  // namespace plan1

// ints: S W K C N FR; ptrs: cq_row, cells, qty, valid, score [S,W,K],
// avail, potential, subtree, local, nominal (each [S,N,FR]), parent,
// chosen [S,W], borrows [S,W,K], preempt_k [S,W]. Returns
// cudaGetLastError() (cudaErrorInvalidValue on a bad argument list).
extern "C" int plan_phase1(const int* ints, int n_ints, void* const* p, int n_ptrs,
                           void* stream) {
  if (n_ints != 6 || n_ptrs != 14) return (int)cudaErrorInvalidValue;
  plan1::Args a;
  a.S = ints[0]; a.W = ints[1]; a.K = ints[2]; a.C = ints[3]; a.N = ints[4];
  a.FR = ints[5];
  if (a.K < 1 || a.K > 32 || a.S > 65535) return (int)cudaErrorInvalidValue;
  cycle_body::Phase1View& v = a.v;
  v.W = a.W; v.K = a.K; v.C = a.C; v.FR = a.FR;
  int i = 0;
  v.cq_row = (const int*)p[i++];
  v.cells = (const int*)p[i++];
  v.qty = (const long long*)p[i++];
  v.valid = (const uint8_t*)p[i++];
  v.score = (const long long*)p[i++];
  v.avail = (const long long*)p[i++];
  v.potential = (const long long*)p[i++];
  v.subtree = (const long long*)p[i++];
  v.local = (const long long*)p[i++];
  v.nominal = (const long long*)p[i++];
  v.parent = (const int*)p[i++];
  v.chosen = (int*)p[i++];
  v.borrows = (uint8_t*)p[i++];
  v.preempt_k = (int*)p[i++];
  if (v.score == nullptr) return (int)cudaErrorInvalidValue;
  if (a.W > 0 && a.S > 0) {
    const int per_block = plan1::kThreads / 32;
    const dim3 grid((a.W + per_block - 1) / per_block, a.S);
    plan1::phase1<<<grid, plan1::kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
