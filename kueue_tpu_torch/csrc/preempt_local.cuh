// The minimalPreemptions search on a local subtree panel, kernel B8's
// (preempt_search.cu, the cycle's batched victim search); its bubble
// also serves the fair-preempt drain's search (fair_local.cuh,
// drain_fair_preempt_search.cu). The preempt drain's search
// (drain_preempt_search.cu, B10a) runs a ladder of its own.
//
// Replaces kueue_tpu/ops/preempt_kernel.py _avail_local (:110),
// _bubble_local (:142) and the remove-until-fit / fill-back scans of
// _solve_one (:166-243), which ops/drain_kernel.py _ladder_search_one
// (:1644) reuses for the drain.
//
// Layout: one warp runs one search, one lane per cell. A panel is
// int64[rows, stride] row-major (stride = the problem's cell count);
// lane c owns column c of every panel, so the bubble of a removal and
// the root-down available() of the fit check touch only the lane's own
// cells, and the cross-cell conditions are warp votes: the fit is an
// AND over the needed cells, the "owner still borrows" test an OR over
// the cells needing preemption. available() is quota_path.cuh's
// recurrence with the panel stride in place of FR. Lanes at or past
// the cell count vote neutral and touch no memory. All 32 lanes of the
// warp must call these functions together.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "quota_path.cuh"

namespace preempt_local {

constexpr unsigned kFull = 0xffffffffu;

// The panels of one search: u and lf (bubbled usage and leaf usage)
// are mutated by the search; the quota panels are read only.
struct Panels {
  long long* u;
  long long* lf;
  const long long* g;    // guaranteed
  const long long* sub;  // subtree quota
  const long long* bl;   // borrowing limit
  const long long* nom;  // nominal
  int stride;            // cells per row
};

// addUsage/removeUsage (resource_node.go:123-144) of a signed delta up a
// local path, for the lane's cell: each node takes the delta, and its
// parent the change of the node's usage above its guaranteed quota.
// A bubble of -q exactly undoes a bubble of +q.
__device__ __forceinline__ void bubble(const int* path, int D, int stride, int c,
                                       long long delta, long long* u, const long long* g) {
  for (int d = 0; d <= D; ++d) {
    const int node = path[d];
    if (node < 0) continue;
    const size_t x = (size_t)node * stride + c;
    const long long old = u[x], gg = g[x];
    u[x] = old + delta;
    delta = max(0LL, old + delta - gg) - max(0LL, old - gg);
  }
}

// The head fits: available() along its path covers every needed cell,
// and without borrowing its leaf stays within nominal.
__device__ __forceinline__ bool fits(const Panels& p, const int* hpath, int hrow, int D, int c,
                                     bool need, long long qty, bool allow_borrow) {
  bool ok = true, nb = true;
  if (need) {
    ok = quota_path::avail_along_path(hpath, D, p.stride, c, p.sub, p.g, p.bl, p.u) >= qty;
    const size_t x = (size_t)hrow * p.stride + c;
    nb = p.lf[x] + qty <= p.nom[x];
  }
  const bool all_ok = __all_sync(kFull, ok);
  const bool all_nb = __all_sync(kFull, nb);
  return all_ok && (allow_borrow || all_nb);
}

// One minimalPreemptions attempt (preemption.go:275-342) over the n
// candidates ``cand`` gives in order. Cand provides, per step j:
// valid(j), row(j) (the owner's local row), same(j) (same
// ClusterQueue), prio(j), qty(j, c) (its usage at the lane's cell) and
// path(row) (a local row's ancestor path). ``in``: the lane holds a
// cell; ``need``/``qty``: the head's request at it; ``npre``: the cell
// needs preemption. removed[0..n) (shared memory) ends as the victim
// flags; returns whether a fitting set was found (removed is
// meaningful only then).
template <class Cand>
__device__ bool ladder(const Cand& cand, int n, bool enabled, bool allow_borrow, bool thr_on,
                       long long thr, const Panels& p, const int* hpath, int hrow, int D, int c,
                       bool in, bool need, long long qty, bool npre, uint8_t* removed) {
  bool done = !enabled;
  bool ab = allow_borrow && enabled;
  int fit_at = -1;
  // remove until the head fits
  for (int j = 0; j < n; ++j) {
    bool act = false;
    if (!done && cand.valid(j)) {
      const int row = cand.row(j);
      const size_t x = (size_t)row * p.stride + c;
      const bool owner_borrows = __any_sync(kFull, in && npre && p.lf[x] > p.nom[x]);
      const bool same = cand.same(j);
      act = same || owner_borrows;
      if (act) {
        // borrowWithinCohort: a candidate at or above the threshold
        // disables borrowing for every later fit check
        if (!same && thr_on && cand.prio(j) >= thr) ab = false;
        if (in) {
          const long long q = cand.qty(j, c);
          bubble(cand.path(row), D, p.stride, c, -q, p.u, p.g);
          p.lf[x] -= q;
        }
        __syncwarp();
        if (fits(p, hpath, hrow, D, c, need, qty, ab)) {
          fit_at = j;
          done = true;
        }
      }
    }
    if (c == 0) removed[j] = act;
  }
  __syncwarp();
  const bool found = done && enabled;
  if (!found) return false;
  // fill back in reverse, skipping the removal that produced the fit
  for (int j = n - 1; j >= 0; --j) {
    if (!removed[j] || j == fit_at) continue;
    const int row = cand.row(j);
    const size_t x = (size_t)row * p.stride + c;
    const long long q = in ? cand.qty(j, c) : 0;
    if (in) {
      bubble(cand.path(row), D, p.stride, c, q, p.u, p.g);
      p.lf[x] += q;
    }
    __syncwarp();
    const bool keep = fits(p, hpath, hrow, D, c, need, qty, ab);
    if (!keep && in) {
      bubble(cand.path(row), D, p.stride, c, -q, p.u, p.g);
      p.lf[x] -= q;
    }
    __syncwarp();
    if (keep && c == 0) removed[j] = 0;
    __syncwarp();
  }
  return true;
}

}  // namespace preempt_local
