// The fair-sharing victim tournament on a local subtree panel, shared by
// fair_search.cu (B9, the cycle's batched fair victim search) and
// drain_fair_preempt_search.cu (B11, the fair-preempt drain's search).
//
// Replaces kueue_tpu/ops/fair_preempt_kernel.py _bubble (:131) and
// _solve_one_fair (:151-427): the panel DRS (drs_panel, :198-237), the
// walkability pass and the root-to-leaf walk (tournament, :244-297),
// pop_first, lca_of and almost_lca (:299-316), the probe removal with
// its strategy gates (:343-374), fits_without_head / avail_at_head
// (:160-196) and the fill-back (:404-427).
//
// Layout: one warp runs one search. The mutable usage panel
// (int64[S, Cu], row-major) and the per-node lendable table
// (int64[S, R]) live in shared memory; the quota panels may be global
// or shared. Lanes own cells c = lane, lane + 32 (Cu <= 64) for the
// bubbles and the fit checks, and nodes s = lane, lane + 32 (S <= 64)
// for the DRS pass, the walkability pass and the walk's reductions.
// potentialAvailable, and so lendable, depends on quota alone: it is
// computed once per search. A probe removal is applied in place and
// undone, when the gate rejects it, by bubbling +q (the exact inverse,
// preempt_local.cuh). All 32 lanes of the warp call these functions
// together; every branch that a lane takes on a shared value is taken
// by all.
//
// DRS integers, as the JAX code: borrowed * 1000 / lendable (floor of
// non-negatives; -1 where nothing is borrowed or lendable), its maximum
// over the resource buckets, then drs * 1000 / weight truncated toward
// zero (C++ division), DRS_MAX for weight 0, 0 for a root or a node
// that borrows nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "preempt_local.cuh"
#include "quota_path.cuh"

namespace fair_local {

constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNoLimit = 1LL << 60;
constexpr long long kDrsMax = 0x7fffffffffffffffLL;
constexpr int kMaxS = 64;
constexpr int kMaxCu = 64;
constexpr int kMaxR = kMaxCu + 1;  // a resource a cell, plus the inert bucket
constexpr int kLessThanOrEqualToFinal = 0;

// One search's local subtree (read only).
struct Tree {
  const int* paths;         // [S, D+1] local ancestor paths
  const int* parent;        // [S] local parent (-1 root / pads)
  const int* depth;         // [S] distance from the root
  const uint8_t* is_cq;     // [S]
  const uint8_t* valid;     // [S]
  const uint8_t* anc;       // [S] strict ancestors of the head
  const long long* weight;  // [S]
  const long long* sub;     // [S, Cu] subtree quota
  const long long* g;       // [S, Cu] guaranteed
  const long long* bl;      // [S, Cu] borrowing limit
  const int* res;           // [Cu] resource bucket of each cell
  const long long* need;    // [Cu] the head's request
  int S, Cu, D, R, hrow;
};

// One search's shared-memory state.
struct Scratch {
  long long* u;       // [S, Cu] usage (mutated)
  long long* lend;    // [S, R]
  long long* drs;     // [S]
  uint8_t* has_c;     // [S]
  uint8_t* elig;      // [S]
  uint8_t* ok;        // [S]
  uint8_t* gathered;  // [S]
  uint8_t* pruned2;   // [S]
  uint8_t* removed;   // [V]
  uint8_t* retried;   // [V]
  int* order;         // [V] the candidate removed at each step
};

// Shared-memory bytes of one search's Scratch.
__host__ __device__ inline size_t scratch_bytes(int S, int Cu, int R, int V) {
  return ((size_t)S * Cu + (size_t)S * R + S) * sizeof(long long) + (size_t)V * sizeof(int) +
         5 * (size_t)S + 2 * (size_t)V;
}

__device__ inline Scratch carve(void* base, int S, int Cu, int R, int V) {
  Scratch sc;
  long long* p = reinterpret_cast<long long*>(base);
  sc.u = p;
  sc.lend = sc.u + (size_t)S * Cu;
  sc.drs = sc.lend + (size_t)S * R;
  sc.order = reinterpret_cast<int*>(sc.drs + S);
  uint8_t* b = reinterpret_cast<uint8_t*>(sc.order + V);
  sc.has_c = b;
  sc.elig = b + S;
  sc.ok = b + 2 * S;
  sc.gathered = b + 3 * S;
  sc.pruned2 = b + 4 * S;
  sc.removed = b + 5 * S;
  sc.retried = sc.removed + V;
  return sc;
}

__device__ __forceinline__ const int* path_of(const Tree& t, int row) {
  return t.paths + (size_t)max(row, 0) * (t.D + 1);
}

// addUsage/removeUsage of a signed per-cell quantity up ``row``'s path
// (qty(c) gives the lane's cells).
template <class Qty>
__device__ __forceinline__ void bubble_row(const Tree& t, long long* u, int row, long long sign,
                                           const Qty& qty, int lane) {
  const int* path = path_of(t, row);
  for (int c = lane; c < t.Cu; c += 32) {
    preempt_local::bubble(path, t.D, t.Cu, c, sign * qty(c), u, t.g);
  }
  __syncwarp();
}

// The head fits against ``u``: available() along its path covers its
// request at every needed cell.
__device__ __forceinline__ bool fits_at_head(const Tree& t, const long long* u, int lane) {
  const int* hpath = path_of(t, t.hrow);
  bool ok = true;
  for (int c = lane; c < t.Cu; c += 32) {
    const long long q = t.need[c];
    if (q > 0) {
      ok = ok && quota_path::avail_along_path(hpath, t.D, t.Cu, c, t.sub, t.g, t.bl, u) >= q;
    }
  }
  return __all_sync(kFull, ok);
}

// DominantResourceShare of node s on the panel ``u``.
__device__ long long node_drs(const Tree& t, const long long* u, const long long* lend, int s) {
  if (t.parent[s] < 0) return 0;
  long long b[kMaxR];
  for (int r = 0; r < t.R; ++r) b[r] = 0;
  for (int c = 0; c < t.Cu; ++c) {
    const size_t x = (size_t)s * t.Cu + c;
    const long long over = u[x] - t.sub[x];
    const int r = t.res[c];
    if (over > 0 && r >= 0 && r < t.R) b[r] += over;
  }
  long long drs = -1;
  bool any = false;
  for (int r = 0; r < t.R; ++r) {
    const long long l = lend[(size_t)s * t.R + r];
    const long long ratio = (b[r] > 0 && l > 0) ? b[r] * 1000 / l : -1;
    drs = max(drs, ratio);
    any = any || b[r] > 0;
  }
  if (!any) return 0;
  const long long w = t.weight[s];
  if (w == 0) return kDrsMax;
  return (drs * 1000) / max(w, 1LL);
}

// potentialAvailable top-down, then each node's lendable: its parent's
// potentialAvailable summed per bucket (0 at roots). Uses sc.u as
// scratch for the potentials.
__device__ void lendable(const Tree& t, Scratch& sc, int lane) {
  long long* pot = sc.u;
  for (int c = lane; c < t.Cu; c += 32) {
    for (int s = 0; s < t.S; ++s) pot[(size_t)s * t.Cu + c] = t.sub[(size_t)s * t.Cu + c];
    for (int d = 1; d <= t.D; ++d) {
      for (int s = 0; s < t.S; ++s) {
        if (t.depth[s] != d) continue;
        const size_t x = (size_t)s * t.Cu + c;
        long long v = t.g[x] + pot[(size_t)max(t.parent[s], 0) * t.Cu + c];
        if (t.bl[x] < kNoLimit) v = min(t.sub[x] + t.bl[x], v);
        pot[x] = v;
      }
    }
  }
  __syncwarp();
  for (int s = lane; s < t.S; s += 32) {
    long long* row = sc.lend + (size_t)s * t.R;
    for (int r = 0; r < t.R; ++r) row[r] = 0;
    const int p = t.parent[s];
    if (p < 0) continue;
    for (int c = 0; c < t.Cu; ++c) {
      const int r = t.res[c];
      if (r >= 0 && r < t.R) row[r] += pot[(size_t)p * t.Cu + c];
    }
  }
  __syncwarp();
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The node on ``row``'s path just below ``lca`` (its own row if lca is
// not on the path).
__device__ __forceinline__ int almost_lca(const Tree& t, int row, int lca) {
  const int* path = path_of(t, row);
  int pos = 0;
  for (int d = t.D; d >= 0; --d) {
    if (path[d] == lca) pos = d;
  }
  return max(path[max(pos - 1, 0)], 0);
}

// next_target: the host walk with recomputed pruning (sc.drs must hold
// the panel's DRS). Returns the picked local ClusterQueue row or -1.
template <class Cand>
__device__ int pick_target(const Tree& t, const Cand& cand, int V, Scratch& sc, int phase,
                           int root, int lane) {
  for (int s = lane; s < t.S; s += 32) sc.has_c[s] = 0;
  __syncwarp();
  for (int j = lane; j < V; j += 32) {
    const bool avail = cand.valid(j) && !sc.removed[j] &&
                       (phase == 1 ? !sc.retried[j] : sc.retried[j]);
    if (avail) sc.has_c[cand.row(j)] = 1;
  }
  __syncwarp();
  for (int s = lane; s < t.S; s += 32) {
    const bool e = t.is_cq[s] && t.valid[s] && sc.has_c[s] && !(phase == 2 && sc.pruned2[s]) &&
                   !(sc.drs[s] == 0 && s != t.hrow);
    sc.elig[s] = e;
    sc.ok[s] = e;
  }
  __syncwarp();
  if (t.parent[t.hrow] < 0) return sc.has_c[t.hrow] ? t.hrow : -1;  // rootless head
  // cohort walkability, bottom-up
  for (int d = t.D; d >= 1; --d) {
    for (int s = lane; s < t.S; s += 32) sc.gathered[s] = 0;
    __syncwarp();
    for (int s = lane; s < t.S; s += 32) {
      if (sc.ok[s] && t.depth[s] == d && t.parent[s] >= 0) sc.gathered[t.parent[s]] = 1;
    }
    __syncwarp();
    for (int s = lane; s < t.S; s += 32) {
      const bool walk = (!t.is_cq[s] && (sc.drs[s] != 0 || t.anc[s] || s == root)) || s == root;
      if (sc.gathered[s] && walk) sc.ok[s] = 1;
    }
    __syncwarp();
  }
  // the walk from the root: the highest (drs, row) child, cohorts
  // winning ties against ClusterQueues
  if (!sc.ok[root]) return -1;
  int cur = root;
  for (int step = 0; step <= t.D; ++step) {
    long long bcq = -1, bco = -1;
    for (int s = lane; s < t.S; s += 32) {
      if (!t.valid[s] || t.parent[s] != cur) continue;
      if (sc.elig[s]) bcq = max(bcq, sc.drs[s]);
      if (!t.is_cq[s] && sc.ok[s]) bco = max(bco, sc.drs[s]);
    }
    bcq = warp_max(bcq);
    bco = warp_max(bco);
    long long icq = -1, ico = -1;
    for (int s = lane; s < t.S; s += 32) {
      if (!t.valid[s] || t.parent[s] != cur) continue;
      if (sc.elig[s] && sc.drs[s] == bcq) icq = max(icq, (long long)s);
      if (!t.is_cq[s] && sc.ok[s] && sc.drs[s] == bco) ico = max(ico, (long long)s);
    }
    icq = warp_max(icq);
    ico = warp_max(ico);
    const bool go = ico >= 0 && (icq < 0 || bco >= bcq);
    if (!go) return (int)icq;
    cur = (int)ico;
  }
  return -1;
}

// One fair-sharing victim search (preemption.go:372-463) over the
// candidates ``cand`` gives in order: valid(j), row(j) (the owner's
// local row), qty(j, c). sc.u must hold the usage panel with the
// head's request added at its row. Ends with sc.removed[j] the victim
// flags (meaningful when the search fits) and returns whether it fits.
template <class Cand>
__device__ bool search(const Tree& t, const Cand& cand, int V, Scratch& sc, int strategy1,
                       bool has_second, bool enabled, int lane) {
  for (int j = lane; j < V; j += 32) {
    sc.removed[j] = 0;
    sc.retried[j] = 0;
  }
  for (int s = lane; s < t.S; s += 32) sc.pruned2[s] = 0;
  __syncwarp();
  if (!enabled) return false;
  const int* hpath = path_of(t, t.hrow);
  int root = t.hrow;
  for (int d = 0; d <= t.D; ++d) {
    if (hpath[d] >= 0) root = hpath[d];
  }
  auto head_qty = [&](int c) { return t.need[c]; };
  int phase = 1, n_removed = 0;
  bool fits = false;
  const int max_iters = 2 * V + t.S + 4;
  for (int it = 0; it < max_iters; ++it) {
    for (int s = lane; s < t.S; s += 32) sc.drs[s] = node_drs(t, sc.u, sc.lend, s);
    __syncwarp();
    const int pick = pick_target(t, cand, V, sc, phase, root, lane);
    if (pick < 0) {
      if (phase == 1 && has_second) {
        phase = 2;
        continue;
      }
      break;  // give up
    }
    // pop_first: the picked queue's first available candidate
    int v = V;
    for (int j = lane; j < V; j += 32) {
      const bool avail = cand.valid(j) && !sc.removed[j] &&
                         (phase == 1 ? !sc.retried[j] : sc.retried[j]);
      if (avail && cand.row(j) == pick) v = min(v, j);
    }
    v = warp_min_int(v);
    if (v >= V) continue;  // unreachable: the pick has an available candidate
    const bool own = pick == t.hrow && phase == 1;
    // lca_of: the target's first ancestor that is also a head ancestor
    const int* tpath = path_of(t, pick);
    int lca = tpath[0];
    for (int d = t.D; d >= 0; --d) {
      if (tpath[d] >= 0 && t.anc[tpath[d]]) lca = tpath[d];
    }
    const int tnode = almost_lca(t, pick, lca);
    const long long pre_share = sc.drs[almost_lca(t, t.hrow, lca)];
    const long long tgt_old = sc.drs[tnode];
    // the probe removal, undone below when the gate rejects it
    const int vrow = cand.row(v);
    auto vq = [&](int c) { return cand.qty(v, c); };
    bubble_row(t, sc.u, vrow, -1, vq, lane);
    const long long tgt_new = node_drs(t, sc.u, sc.lend, tnode);
    const bool allowed1 =
        strategy1 == kLessThanOrEqualToFinal ? pre_share <= tgt_new : pre_share < tgt_old;
    const bool allowed2 = pre_share < tgt_old;
    const bool accept = own || (phase == 1 && allowed1) || (phase == 2 && allowed2);
    if (!accept) bubble_row(t, sc.u, vrow, 1, vq, lane);
    if (lane == 0) {
      if (accept) {
        sc.removed[v] = 1;
        sc.order[n_removed] = v;
      } else if (phase == 1) {
        sc.retried[v] = 1;
      }
      // the second strategy drops the picked queue whatever the gate says
      if (phase == 2) sc.pruned2[pick] = 1;
    }
    __syncwarp();
    if (!accept) continue;
    ++n_removed;
    // _fits_for_fair_sharing: evaluated with the head's usage removed
    bubble_row(t, sc.u, t.hrow, -1, head_qty, lane);
    const bool now = fits_at_head(t, sc.u, lane);
    bubble_row(t, sc.u, t.hrow, 1, head_qty, lane);
    if (now) {
      fits = true;
      break;
    }
  }
  if (!fits) return false;
  // fill-back: reverse removal order, skipping the last removal
  bubble_row(t, sc.u, t.hrow, -1, head_qty, lane);
  for (int s = n_removed - 2; s >= 0; --s) {
    const int v = sc.order[s];
    const int vrow = cand.row(v);
    auto vq = [&](int c) { return cand.qty(v, c); };
    bubble_row(t, sc.u, vrow, 1, vq, lane);
    const bool keep = fits_at_head(t, sc.u, lane);
    if (keep) {
      if (lane == 0) sc.removed[v] = 0;
    } else {
      bubble_row(t, sc.u, vrow, -1, vq, lane);
    }
    __syncwarp();
  }
  return true;
}

}  // namespace fair_local
