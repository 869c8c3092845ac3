// The preempt drains' candidate pools, shared by drain_preempt_search.cu
// and drain_preempt_phase2.cu (B10, the classic preempt drain) and
// drain_fair_preempt_search.cu (B11, the fair-preempt drain).
//
// Replaces the pool reads of kueue_tpu/ops/drain_kernel.py
// solve_drain_preempt (:1890-1925, the candidate eligibility) and the
// eviction moves of its step scan (:2050-2090); solve_drain_fair_preempt
// repeats the reads (:2480-2540):
//   - victim_qty: a pool slot's usage at one cell, summed from its Cv
//     cells;
//   - owner_borrowing: which segment nodes borrow at cycle start in a
//     cell needing preemption (a warp vote over the head's cells);
//   - pool_eligible: preemption.go:480-524's candidate rule for one
//     slot: it uses a cell needing preemption; a same-CQ slot passes
//     the nomination's priority rule (`elig_same`); an other-CQ slot
//     needs reclaimWithinCohort, its priority rule and its owner
//     borrowing;
//   - move_victim: a slot's usage taken off (or put back at) its
//     owner's leaf row, each cell's change bubbled up the owner's path
//     (exact: a bubble of -q undoes a bubble of +q).

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

// add sign x a victim's usage at its owner's leaf row and bubble each
// cell's change up the owner's path (one thread)
__device__ __forceinline__ void move_victim(const Args& a, size_t slot, long long sign) {
  const int owner = max(a.p.sowner[slot], 0);
  const int* path = a.t.paths + (size_t)owner * (a.D + 1);
  for (int cv = 0; cv < a.Cv; ++cv) {
    const int cell = a.p.pcells[slot * a.Cv + cv];
    if (cell < 0) continue;
    long long delta = sign * a.p.pqty[slot * a.Cv + cv];
    a.p.leaf[(size_t)owner * a.FR + cell] += delta;
    for (int d = 0; d <= a.D; ++d) {
      const int node = path[d];
      if (node < 0) continue;
      const size_t x = (size_t)node * a.FR + cell;
      const long long old = a.b.usage[x], g = a.t.guaranteed[x];
      a.b.usage[x] = old + delta;
      delta = max(0LL, old + delta - g) - max(0LL, old - g);
    }
  }
}

}  // namespace pool
}  // namespace drain
