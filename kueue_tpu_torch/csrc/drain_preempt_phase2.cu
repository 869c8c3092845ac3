// Kernel B10b, drain_preempt_phase2: the preempt drain cycle's step
// scan.
//
// Replaces the entry-order lexsort, segmented_rank and the lax.scan
// step loop of kueue_tpu/ops/drain_kernel.py solve_drain_preempt
// (:1988-2166). Per root segment, heads in (borrowing asc, priority
// desc, timestamp asc, queue index asc) order, ranks >= n_steps
// dropped; each head:
//   - is skipped as a preempter when one of its targets was already
//     evicted this cycle (the overlapping-preemption-targets guard);
//   - a preempter removes its victims' full usage at their OWNER leaf
//     rows, then re-checks its fit along its path;
//   - a preempter that no longer fits puts the victims back;
//   - an admitted head or a successful preempter charges its usage
//     (AddUsage runs for both, scheduler.go:211-292), a blocked
//     no-reclaim head reserves (borrowing or nominal cap);
//   - a successful preempter's victims join this cycle's evictions,
//     attributed to its queue.
//
// Design: one block per root segment, as drain_phase2.cu: the threads
// rank the segment's heads by counting, then warp 0 walks them, one
// lane per merged head cell. Segments own disjoint tree rows and pool
// rows, so blocks need no synchronisation. The JAX scan rebuilds the
// whole usage tree from the leaf rows after a step that removes or
// puts back victims; here lane 0 bubbles each victim cell's change up
// its owner's path instead. Usage is a function of the leaf rows and a
// bubble keeps it equal to their tree exactly, so the two agree
// (perf/lockstep.py holds the kernel to the plain version, which
// rebuilds as the JAX code does, at every cycle). The in-cycle leaf
// usage lives in `leaf`: each block first copies its segment's rows
// from `local` (rows of no segment never change in the drain); `local`
// itself takes only the cycle's admissions and evictions, in
// drain_preempt_motion.cu.
//
// What bounds it: the walk is sequential within a segment (each head
// sees its predecessors' admissions and evictions): ~5 heads x a few
// dependent global round trips per step on the contended cluster,
// latency, not bytes (chip_smoke.py counts each launch's bytes from
// its data). A set `done` flag makes the launch a no-op.

#include "drain_pool.cuh"
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

using pool::move_victim;

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
  const unsigned full = 0xffffffffu;
  const int PC = a.P * a.C;
  const size_t pool = (size_t)s * V;
  const int n_walk = min(n_valid, a.n_steps);
  for (int r = 0; r < n_walk; ++r) {
    const int h = a.b.order[beg + r];
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

    bool ov = false;
    for (int v = lane; v < V; v += 32) ov = ov || (htarg[v] && a.p.ev_now[pool + v]);
    const bool do_pre = a.p.psuccess[h] && !__any_sync(full, ov);
    if (do_pre && lane == 0) {
      for (int v = 0; v < V; ++v) {
        if (htarg[v]) move_victim(a, pool + v, -1);
      }
    }
    __syncwarp();
    const bool ok = !cell_valid ||
                    quota_path::avail_along_path(path, D, FR, cell, a.t.subtree,
                                                 a.t.guaranteed, a.t.borrowing_limit,
                                                 a.b.usage) >= qv;
    const bool fits = __all_sync(full, ok);
    const bool admit = a.b.is_fit[h] && fits;
    const bool pre_ok = do_pre && fits;
    if (do_pre && !fits && lane == 0) {
      for (int v = 0; v < V; ++v) {
        if (htarg[v]) move_victim(a, pool + v, 1);
      }
    }
    __syncwarp();
    const bool reserve = a.b.is_pre[h] && !a.p.psuccess[h] && a.q.no_reclaim[h];
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
          a.p.ev_now[pool + v] = 1;
          a.p.ev_by[pool + v] = max(a.p.ev_by[pool + v], h);
        }
      }
      a.b.admitted[h] = admit;
      a.p.preempt_ok[h] = pre_ok;
    }
    __syncwarp();
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_preempt_phase2(const int* ints, int n_ints, void* const* ptrs,
                                    int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.p.leaf == nullptr || a.n_seg > a.n_segments) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n_segments > 0) {
    drain::phase2<<<a.n_segments, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
