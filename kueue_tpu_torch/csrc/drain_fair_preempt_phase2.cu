// Kernel B11b, drain_fair_preempt_phase2: the fair-preempt drain cycle's
// admissions.
//
// Replaces the step scan of kueue_tpu/ops/drain_kernel.py
// solve_drain_fair_preempt (:2604-2742). Each of n_steps steps pops one
// head per root cohort by the fair-sharing tournament against the live
// usage (drain_fair_tournament.cuh, the pop of the fair drain, B7), and
// gives the popped head its disposition, as the classic preempt drain
// (drain_preempt_phase2.cu) does:
//   - a preempter whose targets overlap an earlier eviction of the cycle
//     is skipped (the overlapping-preemption-targets guard);
//   - the head's fit is checked with EVERY accepted victim of the cycle
//     removed, and its own targets when it preempts: the host's
//     non-incremental fits-after-removals (the fair iterator reads usage
//     with the victims present, so the removals live only inside the fit
//     check, and are put back right after it);
//   - an admitted head or a successful preempter charges its usage
//     (AddUsage runs for both, scheduler.go:211-292); a blocked preempt
//     head of a queue with reclaimWithinCohort != Any reserves (borrow or
//     nominal cap);
//   - a successful preempter's victims join this cycle's evictions,
//     attributed to its queue.
//
// Design: one block of 128 threads per root segment: the threads run
// the chains and the tournament, warp 0 the disposition, one lane per
// merged head cell; lane 0 moves the victims (drain_pool.cuh). Segments
// own disjoint tree rows and pool rows, so blocks need no
// synchronisation. The in-cycle leaf usage lives in `leaf`: each block
// first copies its segment's rows from `local`; `local` itself takes
// only the cycle's admissions and evictions, in drain_preempt_motion.cu.
// The JAX scan rebuilds the usage tree from the leaf rows minus the
// removals for every fit check; here the removals are bubbled up their
// owners' paths and bubbled back, which gives the same tree exactly.
//
// What bounds it: latency: the pops are sequential within a segment,
// each a tournament over the segment's heads and a few dependent global
// round trips (chip_smoke.py counts each launch's bytes from its data).
// A set `done` flag makes the launch a no-op.

#include "drain_fair_tournament.cuh"
#include "drain_pool.cuh"
#include "quota_path.cuh"

namespace drain {
namespace {

constexpr int kThreads = 128;

__global__ void phase2(Args a) {
  const int s = blockIdx.x;
  if (*a.s.done) return;
  const int V = a.V, FR = a.FR, D = a.D, M = a.M;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    a.p.ev_now[(size_t)s * V + v] = 0;
    a.p.ev_by[(size_t)s * V + v] = -1;
  }
  for (int i = threadIdx.x; i < M * FR; i += blockDim.x) {
    const int node = a.p.seg_nodes[(size_t)s * M + i / FR];
    if (node < 0) continue;
    const size_t x = (size_t)node * FR + i % FR;
    a.p.leaf[x] = a.s.local[x];
  }
  if (s >= a.n_seg) return;  // no queue in this segment
  const int beg = a.seg_offsets[s], m = a.seg_offsets[s + 1] - beg;
  const int* members = a.seg_members + beg;
  __shared__ int n_rem, winner;
  fair_tournament::mark(a, members, m, &n_rem);

  const int PC = a.P * a.C;
  const unsigned full = 0xffffffffu;
  const size_t slots = (size_t)s * V;
  for (int step = 0; step < a.n_steps && n_rem > 0; ++step) {
    fair_tournament::pop(a, members, m, &winner);
    const int h = winner;
    if (h < 0) break;  // no winner: every later step is the same
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const int cq = max(a.q.cq_rows[h], 0);
      const int* path = a.t.paths + (size_t)cq * (D + 1);
      const uint8_t* htarg = a.p.targets + (size_t)h * V;
      int cell = -1;
      long long qv = 0;
      if (lane < PC) {
        cell = a.b.cells_eff[(size_t)h * PC + lane];
        qv = a.b.qty_eff[(size_t)h * PC + lane];
      }
      const bool cell_valid = cell >= 0 && qv > 0;
      const bool psuccess = a.p.psuccess[h];
      bool ov = false;
      for (int v = lane; v < V; v += 32) {
        ov = ov || (psuccess && htarg[v] && a.p.ev_now[slots + v]);
      }
      const bool do_pre = a.b.is_pre[h] && psuccess && !__any_sync(full, ov);
      // the fit with every accepted victim removed
      if (lane == 0) {
        for (int v = 0; v < V; ++v) {
          if (a.p.ev_now[slots + v] || (do_pre && htarg[v])) pool::move_victim(a, slots + v, -1);
        }
      }
      __syncwarp();
      const bool ok = !cell_valid ||
                      quota_path::avail_along_path(path, D, FR, cell, a.t.subtree,
                                                   a.t.guaranteed, a.t.borrowing_limit,
                                                   a.b.usage) >= qv;
      const bool fits = __all_sync(full, ok);
      if (lane == 0) {
        for (int v = 0; v < V; ++v) {
          if (a.p.ev_now[slots + v] || (do_pre && htarg[v])) pool::move_victim(a, slots + v, 1);
        }
      }
      __syncwarp();
      const bool admit = a.b.is_fit[h] && fits;
      const bool pre_ok = do_pre && fits;
      const bool reserve = a.b.is_pre[h] && !psuccess && a.q.no_reclaim[h];
      if (cell_valid && (admit || pre_ok || reserve)) {
        const size_t lx = (size_t)cq * FR + cell;
        long long delta = qv;
        if (!(admit || pre_ok)) {
          const long long nom = a.t.nominal[lx], bl = a.t.borrowing_limit[lx];
          const long long leaf = a.p.leaf[lx];
          const long long borrow_cap = bl < kNoLimit ? min(qv, nom + bl - leaf) : qv;
          const long long nominal_cap = max(0LL, min(qv, nom - leaf));
          delta = a.b.head_borrow[h] ? borrow_cap : nominal_cap;
        }
        a.p.leaf[lx] += delta;
        for (int d = 0; d <= D; ++d) {
          const int node = path[d];
          if (node < 0) continue;
          const size_t x = (size_t)node * FR + cell;
          const long long old = a.b.usage[x], g = a.t.guaranteed[x];
          a.b.usage[x] = old + delta;
          delta = max(0LL, old + delta - g) - max(0LL, old - g);
        }
      }
      __syncwarp();
      if (lane == 0) {
        if (pre_ok) {
          for (int v = 0; v < V; ++v) {
            if (!htarg[v]) continue;
            a.p.ev_now[slots + v] = 1;
            a.p.ev_by[slots + v] = max(a.p.ev_by[slots + v], h);
          }
        }
        a.b.admitted[h] = admit;
        a.p.preempt_ok[h] = pre_ok;
        a.f.flags[h] = 0;
        n_rem -= 1;
      }
      __syncwarp();
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_fair_preempt_phase2(const int* ints, int n_ints, void* const* ptrs,
                                         int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.p.leaf == nullptr || a.f.chain == nullptr || a.fp.pq_cu == nullptr ||
      a.n_res < 1 || a.n_res > drain::kMaxR || a.n_seg > a.n_segments) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n_segments > 0) {
    drain::phase2<<<a.n_segments, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
