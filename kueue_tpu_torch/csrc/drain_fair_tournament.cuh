// The fair drain's step scan over device memory: the kernel
// drain_fair_phase2.cu (B7) launches for a segment whose heads' and
// nodes' tables do not fit in a block's shared memory (its staged design,
// fair_pop.cuh, takes every other segment). Every value is read from
// device memory at each pop.
//
// Replaces kueue_tpu/ops/drain_kernel.py _fair_chain (:1179) and
// _fair_tournament (:1238):
//   1. each remaining head's DRS chain over its path's D+1 levels
//      (fair_chain): the node's borrowed total per resource from the
//      live usage tree (max(0, usage - subtree) summed per resource),
//      plus the head's cells bubbled up over `guaranteed`; the ratio
//      borrowed * 1000 / lendable per resource, its maximum, then the
//      weight division (truncating, as the JAX sign * (|x| // w)), with
//      DRS_MAX for weight 0 and 0 where the node borrows nothing or is
//      a root;
//   2. the bottom-up tournament, level d = D..1: a head that won its
//      node at depth d proposes to the node's parent with the key (its
//      chain value at that node, -priority when
//      PrioritySortingWithinCohort is on, timestamp, queue index); the
//      lexicographic minimum wins the parent, and nobody does when the
//      smallest DRS there is not below INF = 2^62 (the JAX code keeps a
//      node's old winner, -1, when no proposal's key is below INF).
// One block per root segment, a thread per head for the chains and the
// tournament (each head counts the proposals to its parent that beat
// it, O(m^2) a level for m heads in the segment). Queue flags live in
// the `flags` scratch (bit 0: still to pop; bit 1: won its node so
// far; bit 2: lost at this level), the chains in the `chain` scratch.

#pragma once

#include "drain_common.cuh"
#include "quota_path.cuh"

namespace drain {
namespace fair_tournament {

constexpr long long kInf = 1LL << 62;
constexpr long long kDrsMax = 0x7fffffffffffffffLL;
constexpr uint8_t kRemaining = 1, kSurvives = 2, kLoses = 4;
constexpr int kThreads = 128;

struct Key {
  long long dws, tie, ts;
  int q;
};

__device__ __forceinline__ bool less(const Key& x, const Key& y) {
  if (x.dws != y.dws) return x.dws < y.dws;
  if (x.tie != y.tie) return x.tie < y.tie;
  if (x.ts != y.ts) return x.ts < y.ts;
  return x.q < y.q;
}

__device__ __forceinline__ int cq_of(const Args& a, int x) { return max(a.q.cq_rows[x], 0); }

// the head's key at the node it won at depth d, and that node's parent
__device__ __forceinline__ Key key_at(const Args& a, int x, int hd, int d, int* parent) {
  const int D1 = a.D + 1;
  const int cur = min(a.s.cursor[x], a.L - 1);
  const int* path = a.t.paths + (size_t)cq_of(a, x) * D1;
  *parent = path[hd - d + 1];
  Key k;
  k.dws = a.f.chain[(size_t)x * D1 + (hd - d)];
  k.tie = a.prio_tie ? -a.q.priority[(size_t)x * a.L + cur] : 0;
  k.ts = a.q.timestamp[(size_t)x * a.L + cur];
  k.q = x;
  return k;
}

__device__ void fair_chain(const Args& a, int x) {
  const int D1 = a.D + 1, FR = a.FR, PC = a.P * a.C, R = a.n_res;
  const int* path = a.t.paths + (size_t)cq_of(a, x) * D1;
  int cell[kMaxPC];
  long long delta[kMaxPC];
  for (int c = 0; c < PC; ++c) {
    cell[c] = a.b.cells_eff[(size_t)x * PC + c];
    const long long qv = a.b.qty_eff[(size_t)x * PC + c];
    const bool ok = cell[c] >= 0 && qv > 0;
    delta[c] = ok ? qv : 0;
    if (!ok) cell[c] = -1;
  }
  for (int d = 0; d < D1; ++d) {
    const int node = path[d];
    const bool valid = node >= 0;
    const size_t row = (size_t)max(node, 0) * FR;
    long long borrowed[kMaxR];
    for (int r = 0; r < R; ++r) borrowed[r] = 0;
    for (int fr = 0; fr < FR; ++fr) {
      const long long over = a.b.usage[row + fr] - a.t.subtree[row + fr];
      const int r = a.f.res_of_fr[fr];
      if (over > 0 && r < R) borrowed[r] += over;
    }
    for (int c = 0; c < PC; ++c) {
      if (cell[c] < 0) continue;
      const long long u = a.b.usage[row + cell[c]], sub = a.t.subtree[row + cell[c]];
      const int r = a.f.res_of_fr[cell[c]];
      if (r < R) borrowed[r] += max(0LL, u + delta[c] - sub) - max(0LL, u - sub);
    }
    const long long* lend = a.f.lendable + (size_t)max(node, 0) * R;
    long long drs = -1;
    bool any_borrow = false;
    for (int r = 0; r < R; ++r) {
      const long long ratio =
          (borrowed[r] > 0 && lend[r] > 0) ? borrowed[r] * 1000 / lend[r] : -1;
      drs = r == 0 ? ratio : max(drs, ratio);
      any_borrow = any_borrow || borrowed[r] > 0;
    }
    const bool active = any_borrow && a.t.parent[max(node, 0)] >= 0 && valid;
    const long long w = a.f.weight[max(node, 0)];
    long long dws = 0;
    if (active) dws = w == 0 ? kDrsMax : (drs * 1000) / max(w, 1LL);
    a.f.chain[(size_t)x * D1 + d] = dws;
    if (!valid) continue;
    for (int c = 0; c < PC; ++c) {
      if (cell[c] < 0) continue;
      const long long u = a.b.usage[row + cell[c]], g = a.t.guaranteed[row + cell[c]];
      delta[c] = max(0LL, u + delta[c] - g) - max(0LL, u - g);
    }
  }
}

// Marks the segment's heads that take part in the cycle's tournament
// (active, nominated, with a ClusterQueue) in `flags` and counts them
// into *n_rem (shared; zeroed here). All threads of the block call it.
__device__ void mark(const Args& a, const int* members, int m, int* n_rem) {
  if (threadIdx.x == 0) *n_rem = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int x = members[i];
    const bool active = a.s.cursor[x] < a.q.qlen[x] && a.s.alive[x];
    const bool rem = active && (a.b.is_fit[x] || a.b.is_pre[x]) && a.q.cq_rows[x] >= 0;
    a.f.flags[x] = rem ? kRemaining : 0;
    if (rem) atomicAdd(n_rem, 1);
  }
  __syncthreads();
}

// One pop against the live usage: the remaining heads' chains and the
// tournament. Returns the root's winner, or -1 when nobody wins (then
// every later step is the same). All threads of the block call it;
// *winner is shared.
__device__ int pop(const Args& a, const int* members, int m, int* winner_sh) {
  uint8_t* flags = a.f.flags;
  const int D = a.D;
  int& winner = *winner_sh;
  // 1. the chains of the heads still to pop
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int x = members[i];
    if (!(flags[x] & kRemaining)) continue;
    fair_chain(a, x);
    flags[x] = kRemaining | kSurvives;
  }
  if (threadIdx.x == 0) winner = -1;
  __syncthreads();
  // 2. the tournament, bottom-up
  for (int d = D; d >= 1; --d) {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int x = members[i];
      if ((flags[x] & (kRemaining | kSurvives)) != (kRemaining | kSurvives)) continue;
      const int hd = a.f.depth_of[cq_of(a, x)];
      if (hd < d) continue;
      int px;
      const Key kx = key_at(a, x, hd, d, &px);
      bool lose = kx.dws >= kInf;
      for (int j = 0; j < m && !lose; ++j) {
        const int y = members[j];
        if (y == x || (flags[y] & (kRemaining | kSurvives)) != (kRemaining | kSurvives)) continue;
        const int hy = a.f.depth_of[cq_of(a, y)];
        if (hy < d) continue;
        int py;
        const Key ky = key_at(a, y, hy, d, &py);
        if (py == px && less(ky, kx)) lose = true;
      }
      if (lose) flags[x] |= kLoses;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const int x = members[i];
      if (flags[x] & kLoses) flags[x] = kRemaining;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int x = members[i];
    if (flags[x] == (kRemaining | kSurvives)) winner = x;  // at most one
  }
  __syncthreads();
  return winner;
}

// The step scan: each of n_steps steps pops one head per root cohort and
// gives the winner its fit, admission or reservation and the bubble
// (drain_fair_phase2.cu's, on device memory). One block of kThreads a
// segment.
__global__ void device_phase2(Args a) {
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

}  // namespace fair_tournament
}  // namespace drain
