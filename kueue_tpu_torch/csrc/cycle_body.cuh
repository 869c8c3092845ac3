// The per-head body of phase 1 of the admission cycle, shared by
// cycle_phase1.cu (the interactive cycle, one scenario) and
// plan_phase1.cu (the planner's scenario-batched solve, kernel B14), and
// cycle_phase2.cu's ranking of a segment's heads. The body takes base
// pointers: a caller with a scenario axis offsets the per-scenario arrays
// (quota views, scores, phase-1 outputs) by its scenario before the call;
// the heads' cells, quantities, flags and the parents are shared.
//
// Phase 1 replaces phase1_classify (kueue_tpu/ops/assign_kernel.py:199).

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace cycle_body {

constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNeg = -(1LL << 62);

// Index of the first maximum of v over the lanes where `present`: the
// larger score wins and, on equal scores, the lower lane (jnp.argmax's
// first-max rule).
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

// One scenario's phase-1 view: the heads (shared), that scenario's
// [N, FR] quota views and [W, K] scores (null = zeros), and where its
// outputs go.
struct Phase1View {
  int W, K, C, FR;
  const int* cq_row;          // [W]
  const int* cells;           // [W,K,C]
  const long long* qty;       // [W,K,C]
  const uint8_t* valid;       // [W,K]
  const long long* score;     // [W,K] or null
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

// Head w, one warp, one lane per candidate k (K <= 32), each lane
// walking its C cells: fits the cycle-start available(), the
// preempt-mode test (potentialAvailable and nominal), the borrow bit
// (only under a cohort); then the masked score-argmax over fitting
// candidates (chosen) and, for heads with none, over preempt-eligible
// ones (preempt_k). Pad rows (cq_row < 0) gather row 0 as the JAX code
// does, and get chosen = preempt_k = -1. Warp-uniform in w.
__device__ __forceinline__ void classify_head(const Phase1View& a, int w, int lane) {
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

// A segment's walk order: each of its m members with an entry position
// (spos[i] >= 0; -1 = not walked) gets its rank among them, and member
// i lands in walk[rank] when the rank is below n_steps (the JAX
// mode="drop" scatter drops the rest). n_valid (shared, zeroed by the
// caller before a barrier) ends as the count of walked members. The
// caller syncs the block after.
__device__ __forceinline__ void rank_members(const int* spos, int m, const int* members,
                                             int n_steps, int* walk, int* n_valid) {
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int p = spos[i];
    if (p < 0) continue;
    atomicAdd(n_valid, 1);
    int r = 0;
    for (int j = 0; j < m; ++j) {
      const int q = spos[j];
      r += q >= 0 && q < p;
    }
    if (r < n_steps) walk[r] = members[i];
  }
}

}  // namespace cycle_body
