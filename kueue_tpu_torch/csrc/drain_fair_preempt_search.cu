// Kernel B11a, drain_fair_preempt_search: the fair-preempt drain's victim
// search of one cycle, for every queue head at once.
//
// Replaces the search half of the cycle of kueue_tpu/ops/drain_kernel.py
// solve_drain_fair_preempt (:2471-2602). Per queue whose head is
// preempt-mode and may preempt:
//   - the candidate eligibility over its segment's pool, shared with
//     the classic drain (drain_pool.cuh);
//   - the live usage panel over the segment's active cell universe
//     (`seg_cells`; pad cells and rows zero, borrowing limits NO_LIMIT,
//     so the DRS buckets stay inert), with the head's request bubbled
//     in at its row (preemption.go:394-395: AddUsage before DRS);
//   - the candidates in the queue's order (`perm`), valid where live
//     and eligible, with their usage at the panel cells (`pq_cu`);
//   - the fair victim tournament (fair_local.cuh, the search B9 runs);
//   - the targets scattered back to slot space, and psuccess.
// No search is truncated: untrusted stays 0.
//
// Design: one block of one warp per queue. The segment's panels (usage,
// subtree, guaranteed, borrowing limit: [M, Cu] int64), the head's
// request at the panel cells, the per-node lendable table and the
// tournament's flags live in shared memory; a lane per head cell for the
// eligibility vote, then fair_local.cuh's layout (lanes over panel
// cells and nodes). Queues with no search write their empty result and
// leave.
//
// What bounds it: the tournament's serial chain of dependent picks (up
// to 2V + M + 4, each a DRS pass over the panel), not bytes: a head's
// inputs are a few kB (chip_smoke.py counts each launch's bytes from
// its data). A set `done` flag makes the launch a no-op.

#include "drain_pool.cuh"
#include "fair_local.cuh"

namespace drain {
namespace {

struct OrdCand {
  const Args* a;
  const uint8_t* cflag;  // [V] slot is a live eligible candidate (shared)
  int q, sq;
  __device__ int slot(int j) const { return a->p.perm[(size_t)q * a->V + j]; }
  __device__ bool valid(int j) const { return cflag[slot(j)]; }
  __device__ int row(int j) const {
    return max(a->p.sowner_local[(size_t)sq * a->V + slot(j)], 0);
  }
  __device__ long long qty(int j, int c) const {
    return a->fp.pq_cu[((size_t)sq * a->V + slot(j)) * a->Cu + c];
  }
};

// the panels start after the tournament's scratch, 8-byte aligned
__host__ __device__ inline size_t panels_offset(int M, int Cu, int R, int V) {
  return (fair_local::scratch_bytes(M, Cu, R, V) + 7) & ~(size_t)7;
}

__host__ __device__ inline size_t smem_bytes(int M, int Cu, int R, int V) {
  return panels_offset(M, Cu, R, V) + (3 * (size_t)M * Cu + Cu) * sizeof(long long) +
         (Cu + 32) * sizeof(int) + 2 * (size_t)M + V + 32;
}

__global__ void search(Args a) {
  extern __shared__ long long smem[];
  const int q = blockIdx.x;
  const int lane = threadIdx.x;
  if (*a.s.done) return;
  const int V = a.V, M = a.M, Cu = a.Cu, FR = a.FR, D = a.D, R = a.n_res + 1;
  const int PC = a.P * a.C;
  uint8_t* targets = a.p.targets + (size_t)q * V;
  for (int v = lane; v < V; v += 32) targets[v] = 0;
  if (lane == 0) {
    a.p.psuccess[q] = 0;
    a.p.untrusted[q] = 0;
    a.p.preempt_ok[q] = 0;
  }
  const bool active = a.s.cursor[q] < a.q.qlen[q] && a.s.alive[q];
  if (!(active && a.b.is_pre[q] && (a.p.same_enabled[q] || a.p.reclaim_enabled[q]))) return;

  // shared memory: the tournament's scratch, then the panels, the
  // head's request and buckets at the panel cells, its merged cells,
  // per-node flags and the slots' candidate flags
  fair_local::Scratch sc = fair_local::carve(smem, M, Cu, R, V);
  long long* sub = reinterpret_cast<long long*>(reinterpret_cast<char*>(smem) +
                                                panels_offset(M, Cu, R, V));
  long long* g = sub + (size_t)M * Cu;
  long long* bl = g + (size_t)M * Cu;
  long long* need = bl + (size_t)M * Cu;
  int* res = reinterpret_cast<int*>(need + Cu);
  int* cells_s = res + Cu;                                  // [32]
  uint8_t* anc = reinterpret_cast<uint8_t*>(cells_s + 32);  // [M]
  uint8_t* borrow_by_local = anc + M;                       // [M]
  uint8_t* npre_s = borrow_by_local + M;                    // [32]
  uint8_t* cflag = npre_s + 32;                             // [V]

  const int sq = max(a.q.seg_id[q], 0);
  const int cur = min(a.s.cursor[q], a.L - 1);
  const long long prio = a.q.priority[(size_t)q * a.L + cur];
  const bool in = lane < PC;
  const int cell = in ? a.b.cells_eff[(size_t)q * PC + lane] : -1;
  const bool npre = in && a.p.need_pre[(size_t)q * PC + lane];
  const int cc = max(cell, 0);
  cells_s[lane] = cc;
  npre_s[lane] = npre;
  __syncwarp();

  // candidate eligibility, lanes over the pool's slots
  pool::owner_borrowing(a, sq, lane, cc, npre, borrow_by_local);
  __syncwarp();
  for (int v = lane; v < V; v += 32) {
    bool same;
    cflag[v] = pool::pool_eligible(a, q, sq, v, prio, PC, cells_s, npre_s, borrow_by_local,
                                   &same);
  }

  // the segment's panels over its active cell universe
  const int* seg_cells = a.fp.seg_cells + (size_t)sq * Cu;
  const int* seg_nodes = a.p.seg_nodes + (size_t)sq * M;
  const uint8_t* nvalid = a.fp.node_valid + (size_t)sq * M;
  for (int c = lane; c < Cu; c += 32) {
    const int sc_cell = seg_cells[c];
    long long nq = 0;
    for (int i = 0; sc_cell >= 0 && i < PC; ++i) {
      const int hc = a.b.cells_eff[(size_t)q * PC + i];
      const long long hq = a.b.qty_eff[(size_t)q * PC + i];
      if (hc >= 0 && hq > 0 && hc == sc_cell) nq += hq;
    }
    need[c] = nq;
    res[c] = a.fp.res_of_cell[(size_t)sq * Cu + c];
    for (int m = 0; m < M; ++m) {
      const bool on = sc_cell >= 0 && nvalid[m];
      const size_t x = (size_t)max(seg_nodes[m], 0) * FR + max(sc_cell, 0);
      sub[(size_t)m * Cu + c] = on ? a.t.subtree[x] : 0;
      g[(size_t)m * Cu + c] = on ? a.t.guaranteed[x] : 0;
      bl[(size_t)m * Cu + c] = on ? a.t.borrowing_limit[x] : fair_local::kNoLimit;
    }
  }
  const int hrow = max(a.p.hlocal[q], 0);
  const int* lpaths = a.p.lpaths + (size_t)sq * M * (D + 1);
  const int* hpath = lpaths + (size_t)hrow * (D + 1);
  for (int m = lane; m < M; m += 32) {
    bool is_anc = false;
    for (int d = 1; d <= D; ++d) is_anc = is_anc || hpath[d] == m;
    anc[m] = is_anc;
  }
  __syncwarp();

  fair_local::Tree t;
  t.paths = lpaths;
  t.parent = a.fp.parent_local + (size_t)sq * M;
  t.depth = a.fp.depth_local + (size_t)sq * M;
  t.is_cq = a.fp.is_cq_local + (size_t)sq * M;
  t.valid = nvalid;
  t.anc = anc;
  t.weight = a.fp.weight_local + (size_t)sq * M;
  t.sub = sub;
  t.g = g;
  t.bl = bl;
  t.res = res;
  t.need = need;
  t.S = M;
  t.Cu = Cu;
  t.D = D;
  t.R = R;
  t.hrow = hrow;
  fair_local::lendable(t, sc, lane);
  for (int c = lane; c < Cu; c += 32) {
    const int sc_cell = seg_cells[c];
    for (int m = 0; m < M; ++m) {
      const bool on = sc_cell >= 0 && nvalid[m];
      const size_t x = (size_t)max(seg_nodes[m], 0) * FR + max(sc_cell, 0);
      sc.u[(size_t)m * Cu + c] = on ? a.b.usage[x] : 0;
    }
  }
  __syncwarp();
  // the head's usage is part of the simulated state
  auto head_qty = [&](int c) { return need[c]; };
  fair_local::bubble_row(t, sc.u, hrow, 1, head_qty, lane);

  OrdCand cand{&a, cflag, q, sq};
  const bool fits =
      fair_local::search(t, cand, V, sc, a.strategy1, a.has_second != 0, true, lane);
  if (fits) {
    for (int j = lane; j < V; j += 32) {
      if (sc.removed[j]) targets[cand.slot(j)] = 1;
    }
  }
  if (lane == 0) a.p.psuccess[q] = fits;
}

}  // namespace
}  // namespace drain

extern "C" int drain_fair_preempt_search(const int* ints, int n_ints, void* const* ptrs,
                                         int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  const int R = a.n_res + 1;
  if (a.P * a.C > 32 || a.p.targets == nullptr || a.fp.pq_cu == nullptr || a.M < 1 ||
      a.M > fair_local::kMaxS || a.Cu > fair_local::kMaxCu || R > fair_local::kMaxR) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = drain::smem_bytes(a.M, a.Cu, R, a.V);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        drain::search, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.Q > 0) drain::search<<<a.Q, 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
