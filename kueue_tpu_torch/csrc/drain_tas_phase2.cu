// Kernel B13b, drain_tas_phase2: the TAS drain's global step scan.
//
// Replaces phase 2 of kueue_tpu/ops/drain_kernel.py solve_drain_tas
// (:993-1107): the entry-order jnp.lexsort over every queue's head
// (not per root cohort: a shared topology couples ClusterQueues across
// cohorts), then the lax.scan of n_steps steps, then the leaf-usage
// add of the admitted heads.
//
// One block of 1024 threads for the whole cycle:
//   1. every thread ranks some of the nominated heads (Fit or
//      preempt-mode, on a live ClusterQueue) by (borrowing asc,
//      priority desc, timestamp asc, queue index asc) by counting the
//      heads that order before it; ranks >= n_steps are dropped as the
//      JAX scatter drops them;
//   2. each step walks the next head: warp 0, one lane per merged
//      cell, checks available() along the head's path (the quota fit)
//      while the whole block re-validates a TAS head's nominated
//      leaves against the LIVE leaf usage (every leaf with taken > 0
//      must still hold that many pods: the truncating min over the
//      requested resources of (free - usage) / request, unclipped) with
//      a block-wide AND; the head is admitted when it is quota-Fit, its
//      quota fits and its leaves still hold. An admitted TAS head
//      charges request x taken into the leaf usage at once (the whole
//      block), then warp 0 does the admission's or a blocked
//      preempt-mode head's reservation update along the path, exactly
//      as drain_phase2.cu does, adds the admitted quantities to the
//      queue's leaf row and records the head's step in adm_step.
// The TAS leaf usage stays on the card across cycles.
//
// What bounds it: the serial chain of steps (each head sees its
// predecessors' admissions, charges and reservations): up to n_steps
// x (a path walk + a pass over Lf leaves + two block barriers). At
// tas-drain-10k that is ~100 heads x 1024 leaves a cycle, a few MB of
// cached reads, against a bytes bound well under a microsecond. A set
// `done` flag makes the launch a no-op.

#include "drain_common.cuh"
#include "quota_path.cuh"
#include "tas_place.cuh"

namespace drain {
namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ bool orders_before(const Args& a, int x, int y) {
  // (borrow asc, priority desc, timestamp asc, queue index asc)
  const int bx = a.b.head_borrow[x], by = a.b.head_borrow[y];
  if (bx != by) return bx < by;
  const int cx = min(a.s.cursor[x], a.L - 1), cy = min(a.s.cursor[y], a.L - 1);
  const long long px = a.q.priority[(size_t)x * a.L + cx];
  const long long py = a.q.priority[(size_t)y * a.L + cy];
  if (px != py) return px > py;
  const long long tx = a.q.timestamp[(size_t)x * a.L + cx];
  const long long ty = a.q.timestamp[(size_t)y * a.L + cy];
  if (tx != ty) return tx < ty;
  return x < y;
}

__device__ __forceinline__ bool walked(const Args& a, int x) {
  const bool active = a.s.cursor[x] < a.q.qlen[x] && a.s.alive[x];
  return active && a.q.cq_rows[x] >= 0 && (a.b.is_fit[x] || a.b.is_pre[x]);
}

__global__ void tas_phase2(Args a) {
  if (*a.s.done) return;
  __shared__ int n_valid, leaves_ok, quota_fits;
  __shared__ long long req[kMaxTasR];
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();

  for (int x = threadIdx.x; x < a.Q; x += blockDim.x) {
    if (!walked(a, x)) continue;
    atomicAdd(&n_valid, 1);
    int rank = 0;
    for (int y = 0; y < a.Q; ++y) {
      if (y != x && walked(a, y) && orders_before(a, y, x)) ++rank;
    }
    if (rank < a.n_steps) a.b.order[rank] = x;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const bool warp0 = threadIdx.x < 32;
  const int PC = a.P * a.C, FR = a.FR, D = a.D, Lf = a.Lf, Rt = a.Rt;
  const int n_walk = min(n_valid, a.n_steps);
  for (int r = 0; r < n_walk; ++r) {
    const int h = a.b.order[r];
    const int cur = min(a.s.cursor[h], a.L - 1);
    const bool tas_h = a.tas.t_is[h];
    const long long* taken = a.tas.taken0 + (size_t)h * Lf;
    if (threadIdx.x == 0) leaves_ok = 1;
    for (int j = threadIdx.x; j < Rt; j += blockDim.x) {
      req[j] = a.tas.t_req[((size_t)h * a.L + cur) * Rt + j];
    }
    __syncthreads();

    if (tas_h) {
      for (int i = threadIdx.x; i < Lf; i += blockDim.x) {
        const long long tk = taken[i];
        if (tk == 0) continue;
        const long long now = tas_place::leaf_count(req, Rt, [&](int j) {
          const size_t x = (size_t)i * Rt + j;
          return a.tas.topo_free[x] - a.tas.tas_u[x];
        });
        if (now < tk) leaves_ok = 0;
      }
    }
    const int cq = max(a.q.cq_rows[h], 0);
    const int* path = a.t.paths + (size_t)cq * (D + 1);
    int cell = -1;
    long long qv = 0;
    if (warp0) {
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
      if (lane == 0) quota_fits = fits;
    }
    __syncthreads();
    const bool admit = a.b.is_fit[h] && quota_fits && leaves_ok;

    if (admit && tas_h) {
      for (int i = threadIdx.x; i < Lf; i += blockDim.x) {
        const long long tk = taken[i];
        if (tk == 0) continue;
        for (int j = 0; j < Rt; ++j) a.tas.tas_u[(size_t)i * Rt + j] += req[j] * tk;
      }
    }
    if (warp0) {
      const bool cell_valid = cell >= 0 && qv > 0;
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
        if (admit) a.tas.adm_step[(size_t)h * a.L + cur] = r;
      }
    }
    // the step's charges and usage updates before the next step's
    // checks; its flags read before they are reset
    __syncthreads();
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_tas_phase2(const int* ints, int n_ints, void* const* ptrs, int n_ptrs,
                                void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.tas.topo_free == nullptr || a.Rt > drain::kMaxTasR) {
    return (int)cudaErrorInvalidValue;
  }
  drain::tas_phase2<<<1, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
