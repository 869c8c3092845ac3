// The preempt drains' candidate pools, shared by drain_preempt_search.cu
// (B10, the classic preempt drain: victim_qty, its eligibility its own
// since it loads a chunk of slots at once) and
// drain_fair_preempt_search.cu (B11, the fair-preempt drain: all three).
//
// Replaces the pool reads of kueue_tpu/ops/drain_kernel.py
// solve_drain_preempt (:1890-1925, the candidate eligibility);
// solve_drain_fair_preempt repeats them (:2480-2540):
//   - victim_qty: a pool slot's usage at one cell, summed from its Cv
//     cells;
//   - owner_borrowing: which segment nodes borrow at cycle start in a
//     cell needing preemption (a warp vote over the head's cells);
//   - pool_eligible: preemption.go:480-524's candidate rule for one
//     slot: it uses a cell needing preemption; a same-CQ slot passes
//     the nomination's priority rule (`elig_same`); an other-CQ slot
//     needs reclaimWithinCohort, its priority rule and its owner
//     borrowing.

#pragma once

#include "drain_common.cuh"

namespace drain {
namespace pool {

constexpr unsigned kFull = 0xffffffffu;

// a victim's usage at one cell
__device__ __forceinline__ long long victim_qty(const Args& a, size_t slot, int cell) {
  long long sum = 0;
  for (int cv = 0; cv < a.Cv; ++cv) {
    const size_t y = slot * a.Cv + cv;
    const int vc = a.p.pcells[y];
    if (vc >= 0 && vc == cell) sum += a.p.pqty[y];
  }
  return sum;
}

// borrow_by_local[m] for the M nodes of segment sq: the node's leaf
// usage exceeds its nominal quota at a head cell needing preemption.
// Lane c holds head cell cc (npre: it needs preemption); all 32 lanes
// call it together.
__device__ __forceinline__ void owner_borrowing(const Args& a, int sq, int c, int cc, bool npre,
                                                uint8_t* borrow_by_local) {
  for (int m = 0; m < a.M; ++m) {
    const size_t x = (size_t)max(a.p.seg_nodes[(size_t)sq * a.M + m], 0) * a.FR + cc;
    const bool b = __any_sync(kFull, npre && a.s.local[x] > a.t.nominal[x]);
    if (c == 0) borrow_by_local[m] = b;
  }
}

// Slot v of segment sq is a candidate of queue q's head (priority
// prio). cells_s/npre_s: the head's PC merged cells (clamped) and
// whether each needs preemption. *same: the slot is the head's own
// ClusterQueue's.
__device__ __forceinline__ bool pool_eligible(const Args& a, int q, int sq, int v, long long prio,
                                              int PC, const int* cells_s, const uint8_t* npre_s,
                                              const uint8_t* borrow_by_local, bool* same) {
  const size_t x = (size_t)sq * a.V + v;
  const bool slot_ok = a.p.sowner[x] >= 0;
  const int ol = a.p.sowner_local[x];
  const bool same_q = slot_ok && ol == a.p.hlocal[q];
  const bool live = a.p.pvalid[x] && !a.p.vevicted[x];
  const bool lower = a.p.sprio[x] < prio;
  bool uses = false;
  for (int i = 0; i < PC; ++i) {
    if (npre_s[i] && victim_qty(a, x, cells_s[i]) > 0) uses = true;
  }
  const bool elig_other = live && !same_q && slot_ok && a.p.reclaim_enabled[q] &&
                          (!a.p.only_lower[q] || lower) && borrow_by_local[max(ol, 0)];
  *same = same_q;
  return uses && (a.p.elig_same[(size_t)q * a.V + v] || elig_other);
}

}  // namespace pool
}  // namespace drain
