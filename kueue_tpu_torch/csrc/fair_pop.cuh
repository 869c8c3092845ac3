// The fair-sharing pop of one root segment on rows staged in shared
// memory, shared by drain_fair_phase2.cu (B7, the fair drain) and
// drain_fair_preempt_phase2.cu (B11b, the fair-preempt drain): each pop
// takes one head per root cohort by the admission tournament against the
// live usage.
//
// Replaces kueue_tpu/ops/drain_kernel.py _fair_chain (:1179) and
// _fair_tournament (:1238):
//   - chains: each node keeps its borrowed sum per resource (`bsum`,
//     updated by the caller where a charge changes a row), so a head's
//     DRS chain is its path's node sums plus its own cells bubbled up
//     over `guaranteed`; the ratio borrowed * 1000 / lendable per
//     resource, its maximum, then the weight division (truncating), with
//     DRS_MAX for weight 0 and 0 where the node borrows nothing or is a
//     root. Only heads the caller marks dirty recompute theirs;
//   - the tournament, bottom-up, a warp a parent: every node at depth d
//     with a winner proposes to its parent with the key (its winner's
//     chain value at that node, -priority under
//     PrioritySortingWithinCohort, timestamp, queue index); the smallest
//     key wins, and nobody does where the smallest DRS is not below
//     INF = 2^62 (the JAX code keeps the node's winner, -1).
// The segment's rows are staged [M][FR] (kRows) or stay in device
// memory, addressed through each local node's tree row. All threads of
// the block call chains() and tournament() together.

#pragma once

#include <climits>

#include "drain_common.cuh"

namespace drain {
namespace fair_pop {

constexpr unsigned kFull = 0xffffffffu;
constexpr long long kInf = 1LL << 62;
constexpr long long kDrsMax = 0x7fffffffffffffffLL;
constexpr int kMaxSmem = 232448 - 1024;  // the opt-in limit, less the static part
// head flags
constexpr uint8_t kRem = 1, kFitF = 2, kPre = 4, kPs = 8, kNoRe = 16, kBorrow = 32,
                  kStale = 64;

struct Bump {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) & ~(size_t)15;
    return at;
  }
};

// The segment's rows: staged [M][FR] (kRows) or the device's [N][FR].
template <bool kRows>
struct Rows {
  long long *U, *F, *SUB, *G, *BL, *LEAF;
  const int* node_of;
  int FR;
  __device__ __forceinline__ size_t at(int l, int cell) const {
    return kRows ? (size_t)l * FR + cell : (size_t)node_of[l] * FR + cell;
  }
};

// add delta at column `cell` of local node path[0] and bubble each
// node's over-guaranteed change up the path, on tree T
template <bool kRows>
__device__ __forceinline__ void bubble(const Rows<kRows>& rw, long long* T, const int* path,
                                       int D1, int cell, long long delta) {
  for (int d = 0; d < D1; ++d) {
    const int node = path[d];
    if (node < 0) continue;
    const size_t x = rw.at(node, cell);
    const long long old = T[x], g = rw.G[x];
    T[x] = old + delta;
    delta = max(0LL, old + delta - g) - max(0LL, old - g);
  }
}

// available() at path[0] for one cell over tree T: the root-down
// recurrence of resource_node.go:89-104 (quota_path.cuh on local rows)
template <bool kRows>
__device__ __forceinline__ long long avail(const Rows<kRows>& rw, const long long* T,
                                           const int* path, int D1, int cell) {
  int root_pos = -1;
  for (int d = 0; d < D1; ++d) root_pos += path[d] >= 0;
  long long av = 0;
  for (int d = D1 - 1; d >= 0; --d) {
    const int node = path[d];
    if (node < 0) continue;
    const size_t x = rw.at(node, cell);
    const long long s = rw.SUB[x], g = rw.G[x], bl = rw.BL[x], u = T[x];
    if (d == root_pos) {
      av = s - u;
    } else {
      const long long with_max = (s - g) - max(0LL, u - g) + bl;
      const long long clamped = bl < kNoLimit ? min(with_max, av) : av;
      av = max(0LL, g - u) + clamped;
    }
  }
  return av;
}

struct Key {
  long long dws, tie, ts;
  int q, i;
};

__device__ __forceinline__ bool less(const Key& x, const Key& y) {
  if (x.dws != y.dws) return x.dws < y.dws;
  if (x.tie != y.tie) return x.tie < y.tie;
  if (x.ts != y.ts) return x.ts < y.ts;
  return x.q < y.q;
}

// A segment's pop tables in shared memory: M local nodes (tree order is
// free; `npath` holds each node's local ancestor path), m heads.
struct Pop {
  const long long* weight;  // [M]
  const long long* lend;    // [M,R]
  long long* bsum;          // [M,R] borrowed per resource
  const long long* htie;    // [m]
  const long long* hts;     // [m]
  const long long* hqty;    // [m,PC]
  long long* hchain;        // [m,D1]
  const int* lpar;          // [M] local parent (-1 root)
  const int* depth;         // [M] tree depth
  const int* haspar;        // [M] the node has a tree parent
  const int* npath;         // [M,D1]
  const int* plist;         // parents by depth: plist[poff[d] .. poff[d+1])
  const int* poff;          // [D1+1]
  const int* hq;            // [m] queue index
  const int* hnode;         // [m] the head's ClusterQueue, local
  const int* hd;            // [m] its tree depth
  const int* hcell;         // [m,PC] -1 where the cell is not requested
  const int* hres;          // [m,PC] resource bucket (R where none)
  int* win;                 // [M] the node's winner (a head index) ...
  int* wstep;               // [M] ... where wstep holds this pop's step
  uint8_t* hflag;           // [m]
  int m, M, D1, R, PC;
};

// Head i's DRS chain into hchain[i], on the live usage rw.U; delta/bd:
// PC scratch entries each.
template <bool kRows>
__device__ __forceinline__ void chain(const Pop& p, const Rows<kRows>& rw, int i,
                                      long long* delta, long long* bd) {
  const int D1 = p.D1, PC = p.PC, R = p.R;
  const int* path = p.npath + (size_t)p.hnode[i] * D1;
  const int* cells = p.hcell + (size_t)i * PC;
  const int* rs = p.hres + (size_t)i * PC;
  for (int c = 0; c < PC; ++c) delta[c] = cells[c] >= 0 ? p.hqty[(size_t)i * PC + c] : 0;
  for (int d = 0; d < D1; ++d) {
    const int node = path[d];
    long long dws = 0;
    if (node >= 0) {
      for (int c = 0; c < PC; ++c) {
        const int cell = cells[c];
        if (cell < 0) continue;
        const size_t x = rw.at(node, cell);
        const long long u = rw.U[x], sub = rw.SUB[x], g = rw.G[x], dl = delta[c];
        bd[c] = max(0LL, u + dl - sub) - max(0LL, u - sub);
        delta[c] = max(0LL, u + dl - g) - max(0LL, u - g);
      }
      long long drs = -1;
      bool any = false;
      for (int r = 0; r < R; ++r) {
        long long b = p.bsum[(size_t)node * R + r];
        for (int c = 0; c < PC; ++c) {
          if (cells[c] >= 0 && rs[c] == r) b += bd[c];
        }
        const long long ld = p.lend[(size_t)node * R + r];
        const long long ratio = (b > 0 && ld > 0) ? b * 1000 / ld : -1;
        drs = r == 0 ? ratio : max(drs, ratio);
        any = any || b > 0;
      }
      if (any && p.haspar[node]) {
        const long long wt = p.weight[node];
        dws = wt == 0 ? kDrsMax : (drs * 1000) / max(wt, 1LL);
      }
    }
    p.hchain[(size_t)i * D1 + d] = dws;
  }
}

// Each remaining head proposes itself at its ClusterQueue's node for
// pop `step` (a winner written at an older step reads as none, so win[]
// is never reset). The block's threads call it together before the
// barrier that precedes tournament().
template <int kThreads>
__device__ __forceinline__ void propose(const Pop& p, int step) {
  for (int i = threadIdx.x; i < p.m; i += kThreads) {
    if (p.hflag[i] & kRem) {
      p.win[p.hnode[i]] = i;
      p.wstep[p.hnode[i]] = step;
    }
  }
}

// The tournament of pop `step` over the chains, bottom-up; returns the
// root's winner (a head index, or -1: nobody wins, and every later pop
// is the same).
template <int kThreads>
__device__ __forceinline__ int tournament(const Pop& p, int root, int step) {
  constexpr int kWarps = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D1 = p.D1, M = p.M;
  for (int d = D1 - 1; d >= 1; --d) {
    const int p0 = p.poff[d - 1], np = p.poff[d] - p0;
    if (np == 0) continue;
    for (int jp = warp; jp < np; jp += kWarps) {
      const int par = p.plist[p0 + jp];
      Key best = {LLONG_MAX, LLONG_MAX, LLONG_MAX, INT_MAX, -1};
      for (int l = lane; l < M; l += 32) {
        if (p.wstep[l] != step || p.lpar[l] != par || p.depth[l] != d) continue;
        const int w = p.win[l];
        const Key k = {p.hchain[(size_t)w * D1 + (p.hd[w] - d)], p.htie[w], p.hts[w], p.hq[w], w};
        if (less(k, best)) best = k;
      }
      for (int o = 16; o > 0; o >>= 1) {
        Key y;
        y.dws = __shfl_xor_sync(kFull, best.dws, o);
        y.tie = __shfl_xor_sync(kFull, best.tie, o);
        y.ts = __shfl_xor_sync(kFull, best.ts, o);
        y.q = __shfl_xor_sync(kFull, best.q, o);
        y.i = __shfl_xor_sync(kFull, best.i, o);
        if (less(y, best)) best = y;
      }
      if (lane == 0 && best.i >= 0 && best.dws < kInf) {
        p.win[par] = best.i;
        p.wstep[par] = step;
      }
    }
    __syncthreads();
  }
  return p.wstep[root] == step ? p.win[root] : -1;
}

// Parents by depth (warp 0 of the block): plist[poff[dd] .. poff[dd+1])
// lists the staged nodes at depth dd with a staged child.
__device__ __forceinline__ void parents_by_depth(const int* node_of, const int* haschild,
                                                 const int* depth, int M, int D1, int* plist,
                                                 int* poff) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int dd = 0; dd < D1; ++dd) {
    if (lane == 0) poff[dd] = base;
    for (int l0 = 0; l0 < M; l0 += 32) {
      const int l = l0 + lane;
      const bool is_p = l < M && node_of[l] >= 0 && haschild[l] && depth[l] == dd;
      const unsigned bal = __ballot_sync(kFull, is_p);
      if (is_p) plist[base + __popc(bal & ((1u << lane) - 1))] = l;
      base += __popc(bal);
    }
  }
  if (lane == 0) poff[D1] = base;
}

// Each staged node's borrowed sum per resource over its row.
template <bool kRows, int kThreads>
__device__ __forceinline__ void node_sums(const Rows<kRows>& rw, const int* res, int M, int FR,
                                          int R, long long* bsum) {
  for (int i = threadIdx.x; i < M * R; i += kThreads) {
    const int l = i / R, r = i % R;
    long long b = 0;
    if (rw.node_of[l] >= 0) {
      for (int fr = 0; fr < FR; ++fr) {
        if (res[fr] != r) continue;
        const size_t x = rw.at(l, fr);
        b += max(0LL, rw.U[x] - rw.SUB[x]);
      }
    }
    bsum[i] = b;
  }
}

// The winner's charge of delta at column `cell` (one lane a cell) on
// the live usage, bubbled up `path`, each level's borrowed change into
// bdl[lane * D1 + d] (0 where nothing changed).
template <bool kRows>
__device__ __forceinline__ void charge(const Rows<kRows>& rw, const int* path, int D1, int cell,
                                       long long delta, long long* bdl) {
  long long du = delta;
  for (int d = 0; d < D1; ++d) {
    const int node = path[d];
    if (node < 0) continue;
    const size_t xx = rw.at(node, cell);
    const long long old = rw.U[xx], sub = rw.SUB[xx], g = rw.G[xx];
    rw.U[xx] = old + du;
    bdl[d] = max(0LL, old + du - sub) - max(0LL, old - sub);
    du = max(0LL, old + du - g) - max(0LL, old - g);
  }
}

// The charged nodes' borrowed sums (lanes over the path's levels): the
// winner h's cells' changes from bdl[c * D1 + d].
__device__ __forceinline__ void add_sums(const Pop& p, int h, const int* path,
                                         const long long* bdl) {
  const int lane = threadIdx.x & 31, D1 = p.D1, PC = p.PC, R = p.R;
  for (int d = lane; d < D1; d += 32) {
    const int node = path[d];
    if (node < 0) continue;
    for (int c = 0; c < PC; ++c) {
      const int r = p.hres[(size_t)h * PC + c];
      if (p.hcell[(size_t)h * PC + c] >= 0 && r < R) {
        p.bsum[(size_t)node * R + r] += bdl[(size_t)c * D1 + d];
      }
    }
  }
}

}  // namespace fair_pop
}  // namespace drain
