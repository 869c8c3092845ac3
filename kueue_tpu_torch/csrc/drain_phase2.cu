// Kernel 3, drain_phase2: one drain cycle's conflict resolution.
//
// Replaces the entry-order jnp.lexsort, segmented_rank
// (ops/assign_kernel.py:449) and the lax.scan step loop of
// kueue_tpu/ops/drain_kernel.py _plain_cycle (:486-582), with the
// per-step _avail_along_path (assign_kernel.py:282) and the usage
// bubble-up.
//
// One block per root-cohort segment: roots touch disjoint tree rows,
// so segments need no synchronisation with each other (the JAX scan
// runs them in lockstep, which is the same). Inside a segment:
//   1. every thread ranks some of the segment's nominated heads (Fit
//      or preempt-mode) by (borrowing asc, priority desc, timestamp
//      asc, queue index asc) — the last key is jnp.lexsort's
//      stability — by counting the heads that order before it
//      (segments hold tens of queues); ranks >= n_steps are dropped
//      exactly as the JAX scatter drops them;
//   2. warp 0 walks the ranked heads in order, one lane per merged
//      cell: available() root-down along the head's ancestor path, a
//      warp vote for fits, the admit or reserve decision, then the
//      bubble of each node's over-guaranteed delta up the path.
//      Admitted quantities are added to the queue's leaf row of the
//      leaf usage. The cycle usage tree is mutated in place: it is
//      rebuilt from the leaf rows at the start of every cycle, so
//      reservations die with the cycle.
// Segment membership is static for a drain (CSR built on the host).
//
// What bounds it: the walk is sequential within a segment (each head
// sees its predecessors' admissions), so latency, not bytes (about
// 0.2 MB at the headline's first cycle as chip_smoke.py counts it,
// ~0.07 us at 3.35 TB/s), bounds it: 20 heads x (D+1) dependent global
// round trips per segment. 50 segments run on
// 50 SMs at once. A set `done` flag makes the launch a no-op.

#include "drain_common.cuh"
#include "quota_path.cuh"

namespace drain {
namespace {

constexpr int kThreads = 128;

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

__device__ __forceinline__ bool nominated(const Args& a, int x) {
  return a.b.is_fit[x] || a.b.is_pre[x];
}

__global__ void phase2(Args a) {
  const int s = blockIdx.x;
  if (*a.s.done || s >= a.n_segments) return;
  const int beg = a.seg_offsets[s], end = a.seg_offsets[s + 1];
  const int m = end - beg;
  __shared__ int n_valid;
  if (threadIdx.x == 0) n_valid = 0;
  __syncthreads();

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int x = a.seg_members[beg + i];
    if (!nominated(a, x)) continue;
    atomicAdd(&n_valid, 1);
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      const int y = a.seg_members[beg + j];
      if (y != x && nominated(a, y) && orders_before(a, y, x)) ++rank;
    }
    if (rank < a.n_steps) a.b.order[beg + rank] = x;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  const int PC = a.P * a.C, FR = a.FR, D = a.D;
  const int n_walk = min(n_valid, a.n_steps);
  for (int r = 0; r < n_walk; ++r) {
    const int h = a.b.order[beg + r];
    const int cq = max(a.q.cq_rows[h], 0);
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
    if (lane == 0) a.b.admitted[h] = admit;
    __syncwarp();
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_phase2(const int* ints, int n_ints, void* const* ptrs,
                            int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32) return (int)cudaErrorInvalidValue;
  if (a.n_seg > 0) {
    drain::phase2<<<a.n_seg, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
