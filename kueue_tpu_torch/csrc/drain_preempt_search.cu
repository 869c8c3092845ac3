// Kernel B10a, drain_preempt_search: the preempt drain's victim search
// of one cycle, for every queue head at once.
//
// Replaces the search half of the cycle of kueue_tpu/ops/drain_kernel.py
// solve_drain_preempt (:1866-1987): candidate eligibility over the
// head's segment pool (preemption.go:480-524), the strategy ladder
// (preemption.go:144-191: no other-CQ candidate -> one attempt;
// borrowWithinCohort -> one attempt under the priority threshold
// min(priority, maxPriorityThreshold + 1); else, under nominal, a
// reclaim-without-borrowing attempt then a same-queue attempt), the
// compaction in the queue's candidate order (`perm`) to search_width
// (_compact_candidates, :1620), both minimalPreemptions attempts
// (_ladder_search_one, :1644) and the trust of a truncated search: an
// attempt that overflowed the window and missed is inconclusive, and
// an attempt-1 one taints the head even when attempt 2 succeeds.
//
// Design: one block of one warp per queue, one lane per merged head
// cell (P*C <= 32). The segment's six [M, P*C] panels at the head's
// cells (usage, leaf usage, guaranteed, subtree, borrowing limit,
// nominal) are gathered into shared memory, the lanes then stride over
// the pool's slots for eligibility and over the candidate order for
// the compaction (ballot and popcount keep the order), and each attempt
// is preempt_local.cuh's ladder on the panels, the same code as kernel
// B8. A victim's usage at a lane's cell is summed from its Cv cells on
// the fly. Queues with no search to run write their empty result and
// leave.
//
// What bounds it: the ladders' serial chains of dependent shared-memory
// steps (up to search_width removals and fill-backs per attempt), not
// bytes: a head's inputs are a few kB (chip_smoke.py counts each
// launch's bytes from its data). A set `done` flag makes the launch a
// no-op.

#include "drain_pool.cuh"
#include "preempt_local.cuh"

namespace drain {
namespace {

constexpr unsigned kFull = 0xffffffffu;
using pool::victim_qty;

struct PoolCand {
  const Args* a;
  const int* comp;              // [n] slot ids, compacted
  const uint8_t* same_flags;    // [V] slot is same-CQ (shared)
  int sq, cell;                 // segment, the lane's (clamped) head cell
  __device__ bool valid(int j) const { return comp[j] >= 0; }
  __device__ int row(int j) const {
    return max(a->p.sowner_local[(size_t)sq * a->V + comp[j]], 0);
  }
  __device__ bool same(int j) const { return same_flags[comp[j]]; }
  __device__ long long prio(int j) const { return a->p.sprio[(size_t)sq * a->V + comp[j]]; }
  __device__ long long qty(int j, int) const {
    return victim_qty(*a, (size_t)sq * a->V + comp[j], cell);
  }
  __device__ const int* path(int row) const {
    return a->p.lpaths + ((size_t)sq * a->M + row) * (a->D + 1);
  }
};

__global__ void search(Args a) {
  extern __shared__ long long smem[];
  const int q = blockIdx.x;
  const int c = threadIdx.x;
  if (*a.s.done) return;
  const int V = a.V, W = a.search_width, M = a.M, FR = a.FR, D = a.D;
  const int PC = a.P * a.C;
  uint8_t* targets = a.p.targets + (size_t)q * V;
  for (int v = c; v < V; v += 32) targets[v] = 0;
  if (c == 0) {
    a.p.psuccess[q] = 0;
    a.p.untrusted[q] = 0;
    a.p.preempt_ok[q] = 0;
  }
  const bool active = a.s.cursor[q] < a.q.qlen[q] && a.s.alive[q];
  if (!(active && a.b.is_pre[q] && (a.p.same_enabled[q] || a.p.reclaim_enabled[q]))) return;

  // shared memory: six panels, then slot flags, two compacted lists,
  // removal flags, per-node borrowing flags, the lanes' cells
  const size_t panel = (size_t)M * PC;
  long long* u = smem;
  long long* lf = u + panel;
  long long* g = lf + panel;
  long long* sub = g + panel;
  long long* bl = sub + panel;
  long long* nom = bl + panel;
  int* comp1 = reinterpret_cast<int*>(nom + panel);
  int* comp2 = comp1 + W;
  int* cells_s = comp2 + W;                        // [32]
  uint8_t* flags = reinterpret_cast<uint8_t*>(cells_s + 32);  // [V]
  uint8_t* same = flags + V;                       // [V]
  uint8_t* removed = same + V;                     // [W]
  uint8_t* borrow_by_local = removed + W;          // [M]
  uint8_t* npre_s = borrow_by_local + M;           // [32]

  const int sq = max(a.q.seg_id[q], 0);
  const int cur = min(a.s.cursor[q], a.L - 1);
  const long long prio = a.q.priority[(size_t)q * a.L + cur];
  const bool in = c < PC;
  const int cell = in ? a.b.cells_eff[(size_t)q * PC + c] : -1;
  const long long qty = in ? a.b.qty_eff[(size_t)q * PC + c] : 0;
  const bool need = cell >= 0 && qty > 0;
  const bool npre = in && a.p.need_pre[(size_t)q * PC + c];
  const int cc = max(cell, 0);
  cells_s[c] = cc;
  npre_s[c] = npre;

  auto load_mutable = [&]() {
    if (!in) return;
    for (int m = 0; m < M; ++m) {
      const size_t x = (size_t)max(a.p.seg_nodes[(size_t)sq * M + m], 0) * FR + cc;
      u[m * PC + c] = a.b.usage[x];
      lf[m * PC + c] = a.s.local[x];
    }
  };
  load_mutable();
  if (in) {
    for (int m = 0; m < M; ++m) {
      const size_t x = (size_t)max(a.p.seg_nodes[(size_t)sq * M + m], 0) * FR + cc;
      g[m * PC + c] = a.t.guaranteed[x];
      sub[m * PC + c] = a.t.subtree[x];
      bl[m * PC + c] = a.t.borrowing_limit[x];
      nom[m * PC + c] = a.t.nominal[x];
    }
  }
  __syncwarp();
  // other-CQ candidates: their owner borrows at cycle start in a cell
  // needing preemption
  pool::owner_borrowing(a, sq, c, cc, npre, borrow_by_local);
  const int hl = max(a.p.hlocal[q], 0);
  const bool under_nominal =
      __all_sync(kFull, !npre || lf[hl * PC + c] < nom[hl * PC + c]);
  __syncwarp();

  // candidate eligibility, lanes over the pool's slots
  bool other = false;
  for (int v = c; v < V; v += 32) {
    bool same_q;
    const bool elig =
        pool::pool_eligible(a, q, sq, v, prio, PC, cells_s, npre_s, borrow_by_local, &same_q);
    flags[v] = elig;
    same[v] = same_q;
    other = other || (elig && !same_q);
  }
  const bool other_exists = __any_sync(kFull, other);
  __syncwarp();

  // the strategy ladder
  const long long thr = min(prio, a.p.bwc_thr1[q]);
  const bool bwc = a.p.bwc[q];
  const bool case_b = other_exists && bwc;
  const bool case_c = other_exists && !bwc && under_nominal;
  const bool all_elig = !other_exists || case_c;  // cases a and c
  auto cand1 = [&](int v) {
    if (!flags[v]) return false;
    if (case_b) return same[v] || a.p.sprio[(size_t)sq * V + v] < thr || under_nominal;
    return all_elig || same[v];
  };
  auto cand2 = [&](int v) { return flags[v] && same[v]; };

  // compaction in candidate order
  int n1 = 0, n2 = 0;
  const unsigned below = (1u << c) - 1;
  for (int base = 0; base < V; base += 32) {
    const int j = base + c;
    const int slot = j < V ? a.p.perm[(size_t)q * V + j] : -1;
    const bool c1 = slot >= 0 && cand1(slot);
    const bool c2 = slot >= 0 && cand2(slot);
    const unsigned b1 = __ballot_sync(kFull, c1), b2 = __ballot_sync(kFull, c2);
    const int p1 = n1 + __popc(b1 & below), p2 = n2 + __popc(b2 & below);
    if (c1 && p1 < W) comp1[p1] = slot;
    if (c2 && p2 < W) comp2[p2] = slot;
    n1 += __popc(b1);
    n2 += __popc(b2);
  }
  const bool over1 = n1 > W, over2 = n2 > W;
  n1 = min(n1, W);
  n2 = min(n2, W);
  __syncwarp();

  preempt_local::Panels pan{u, lf, g, sub, bl, nom, PC};
  const int* hpath = a.p.lpaths + ((size_t)sq * M + hl) * (D + 1);
  PoolCand lc1{&a, comp1, same, sq, cc};
  const bool found1 = preempt_local::ladder(lc1, n1, true, !case_c, case_b, thr, pan, hpath,
                                            hl, D, c, in, need, qty, npre, removed);
  bool found2 = false;
  const int* comp = comp1;
  int n = n1;
  if (!found1 && case_c) {
    load_mutable();
    __syncwarp();
    PoolCand lc2{&a, comp2, same, sq, cc};
    found2 = preempt_local::ladder(lc2, n2, true, true, false, thr, pan, hpath, hl, D, c,
                                   in, need, qty, npre, removed);
    comp = comp2;
    n = n2;
  }
  __syncwarp();
  if (found1 || found2) {
    for (int j = c; j < n; j += 32) {
      if (removed[j]) targets[comp[j]] = 1;
    }
  }
  const bool untrusted = (over1 && !found1) || (!found1 && case_c && over2 && !found2);
  if (c == 0) {
    a.p.untrusted[q] = untrusted;
    a.p.psuccess[q] = !untrusted && (found1 || found2);
    if (untrusted) *a.p.ovf = 1;
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_preempt_search(const int* ints, int n_ints, void* const* ptrs,
                                    int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.p.targets == nullptr) return (int)cudaErrorInvalidValue;
  const size_t panel = (size_t)a.M * a.P * a.C;
  const size_t smem = 6 * panel * sizeof(long long) + (2 * (size_t)a.search_width + 32) * sizeof(int) +
                      2 * (size_t)a.V + a.search_width + a.M + 32;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        drain::search, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.Q > 0) drain::search<<<a.Q, 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
