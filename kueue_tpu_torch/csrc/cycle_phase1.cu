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
// One warp per head, one lane per candidate k (K <= 32), each lane
// walking its C cells; the argmax is a warp shuffle reduction that keeps
// the larger score and, on equal scores, the lower k — jnp.argmax's
// first-max rule, under the same int64 sentinel -(2^62) for ineligible
// candidates, so all-zero scores give the first fit. Pad rows
// (cq_row < 0) gather row 0 as the JAX code does, and get chosen = -1.
//
// What bounds it: bytes. Each head reads its K*C cells and qty and five
// [N, FR] values per cell (gathers that hit L2 for the headline's 1000
// rows), ~ W*K*C*(4+8+5*8) bytes; latency of the dependent gathers
// dominates at the headline size (W = 1024, K = 8, C = 16).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cycle1 {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNeg = -(1LL << 62);
constexpr int kThreads = 128;

struct Args {
  int W, K, C, N, FR;
  const int* cq_row;          // [W]
  const int* cells;           // [W,K,C]
  const long long* qty;       // [W,K,C]
  const uint8_t* valid;       // [W,K]
  const long long* score;     // [W,K] or null (= zeros)
  const long long* avail;     // [N,FR]
  const long long* potential;
  const long long* subtree;
  const long long* local;
  const long long* nominal;
  const int* parent;          // [N]
  int* chosen;                // [W]
  uint8_t* borrows;           // [W,K]
  int* preempt_k;             // [W]
};

// Index of the first maximum of v over the lanes where `present`.
__device__ __forceinline__ int argmax_first(bool present, long long v, int lane) {
  long long best = present ? v : LLONG_MIN;
  int idx = present ? lane : INT_MAX;
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, idx, off);
    if (ov > best || (ov == best && oi < idx)) {
      best = ov;
      idx = oi;
    }
  }
  return __shfl_sync(kFull, idx, 0);
}

__global__ void phase1(Args a) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= a.W) return;  // warp-uniform
  const int cq_raw = a.cq_row[w];
  const int cq = max(cq_raw, 0);
  const bool present = lane < a.K;
  bool fits = true, pot = true, borrow = false, fit_ok = false, pre_ok = false;
  long long sc = 0;
  if (present) {
    const size_t base = ((size_t)w * a.K + lane) * a.C;
    for (int c = 0; c < a.C; ++c) {
      const int cell = a.cells[base + c];
      const long long q = a.qty[base + c];
      if (cell < 0 || q <= 0) continue;  // zero cells never constrain
      const size_t x = (size_t)cq * a.FR + cell;
      fits = fits && a.avail[x] >= q;
      pot = pot && q <= a.potential[x] && q <= a.nominal[x];
      borrow = borrow || a.local[x] + q > a.subtree[x];
    }
    borrow = borrow && a.parent[cq] >= 0;
    a.borrows[(size_t)w * a.K + lane] = borrow;
    const bool v = a.valid[(size_t)w * a.K + lane];
    sc = a.score ? a.score[(size_t)w * a.K + lane] : 0;
    fit_ok = fits && v;
    pre_ok = pot && v;
  }
  const int k_fit = argmax_first(present, fit_ok ? sc : kNeg, lane);
  const int k_pre = argmax_first(present, pre_ok ? sc : kNeg, lane);
  const bool any_fit = __any_sync(kFull, fit_ok);
  const bool any_pre = __any_sync(kFull, pre_ok);
  if (lane == 0) {
    const bool populated = cq_raw >= 0;
    const int chosen = any_fit && populated ? k_fit : -1;
    a.chosen[w] = chosen;
    a.preempt_k[w] = any_pre && populated && chosen < 0 ? k_pre : -1;
  }
}

}  // namespace
}  // namespace cycle1

// ints: W K C N FR; ptrs: the Args pointers in order. Returns
// cudaGetLastError() (cudaErrorInvalidValue on a bad argument list).
extern "C" int cycle_phase1(const int* ints, int n_ints, void* const* p, int n_ptrs,
                            void* stream) {
  if (n_ints != 5 || n_ptrs != 14) return (int)cudaErrorInvalidValue;
  cycle1::Args a;
  a.W = ints[0]; a.K = ints[1]; a.C = ints[2]; a.N = ints[3]; a.FR = ints[4];
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
