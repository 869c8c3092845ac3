// Kernel 5, drain_fair_phase2: one fair-sharing drain cycle's conflict
// resolution, in place of drain_phase2.
//
// Replaces the step scan of kueue_tpu/ops/drain_kernel.py
// solve_drain_fair (:1360-1437) with _fair_chain (:1179) and
// _fair_tournament (:1238). Each of n_steps steps pops one head per
// root cohort:
//   1-2. the remaining heads' DRS chains and the bottom-up tournament
//      (drain_fair_tournament.cuh, shared with the fair-preempt drain);
//   3. the root's winner is checked for fit along its path and admits
//      (or, a blocked preempt-mode head of a reclaimWithinCohort=Never
//      queue, reserves: the borrow cap or the nominal cap by its
//      borrow bit), bubbling each node's over-guaranteed delta up the
//      path, as drain_phase2 does; its admission is added to the leaf
//      usage (reservations die with the cycle).
// Winners are one per root cohort and roots own disjoint tree rows, so
// one block per root segment needs no synchronisation with the others.
//
// What bounds it: latency. Every step's chains read D+1 usage rows of
// FR cells a head (1050 x 17 int64 = 143 kB over the whole tree at the
// headline) and the tournament and the walk are dependent chains of
// global reads. Design: one block of 128 threads per root segment, a
// thread per head for the chains and the tournament, warp 0 for the
// walk, one lane per merged cell. A set `done` flag makes the launch a
// no-op.

#include "drain_fair_tournament.cuh"
#include "quota_path.cuh"

namespace drain {
namespace {

using namespace fair_tournament;

constexpr int kThreads = 128;

__global__ void fair_phase2(Args a) {
  const int s = blockIdx.x;
  if (*a.s.done || s >= a.n_seg) return;
  const int beg = a.seg_offsets[s], m = a.seg_offsets[s + 1] - beg;
  const int* members = a.seg_members + beg;
  uint8_t* flags = a.f.flags;
  __shared__ int n_rem, winner;
  fair_tournament::mark(a, members, m, &n_rem);

  const int D = a.D, FR = a.FR, PC = a.P * a.C;
  for (int step = 0; step < a.n_steps && n_rem > 0; ++step) {
    fair_tournament::pop(a, members, m, &winner);
    const int h = winner;
    if (h < 0) break;  // no winner: every later step is the same
    // 3. the winner's fit, admission or reservation, and the bubble
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int cq = cq_of(a, h);
      const int* path = a.t.paths + (size_t)cq * (D + 1);
      int cell = -1;
      long long qv = 0;
      if (lane < PC) {
        cell = a.b.cells_eff[(size_t)h * PC + lane];
        qv = a.b.qty_eff[(size_t)h * PC + lane];
      }
      const bool cell_valid = cell >= 0 && qv > 0;
      const bool ok = !cell_valid ||
                      quota_path::avail_along_path(path, D, FR, cell, a.t.subtree,
                                                   a.t.guaranteed, a.t.borrowing_limit,
                                                   a.b.usage) >= qv;
      const bool fits = __all_sync(0xffffffffu, ok);
      const bool admit = a.b.is_fit[h] && fits;
      const bool reserve = a.b.is_pre[h] && a.q.no_reclaim[h];
      if (cell_valid && (admit || reserve)) {
        long long delta = qv;
        if (!admit) {
          const size_t lx = (size_t)cq * FR + cell;
          const long long nom = a.t.nominal[lx], bl = a.t.borrowing_limit[lx];
          const long long leaf = a.b.usage[lx];
          const long long borrow_cap = bl < kNoLimit ? min(qv, nom + bl - leaf) : qv;
          const long long nominal_cap = max(0LL, min(qv, nom - leaf));
          delta = a.b.head_borrow[h] ? borrow_cap : nominal_cap;
        }
        for (int d = 0; d <= D; ++d) {
          const int node = path[d];
          if (node < 0) continue;
          const size_t x = (size_t)node * FR + cell;
          const long long old = a.b.usage[x], g = a.t.guaranteed[x];
          a.b.usage[x] = old + delta;
          delta = max(0LL, old + delta - g) - max(0LL, old - g);
        }
        if (admit) a.s.local[(size_t)cq * FR + cell] += qv;
      }
      if (lane == 0) {
        a.b.admitted[h] = admit;
        flags[h] = 0;
        n_rem -= 1;
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_fair_phase2(const int* ints, int n_ints, void* const* ptrs,
                                 int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.n_res < 1 || a.n_res > drain::kMaxR || a.f.chain == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n_seg > 0) {
    drain::fair_phase2<<<a.n_seg, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
