// The walk of a drain cycle's phase 2 on one warp, shared by
// drain_phase2.cu (a root-cohort segment a block) and drain_tas_phase2.cu
// (the TAS drain's one global scan): the staged step operands of a head
// (Window), the quota rows of the walked heads' paths in shared memory
// (stage_rows), and one head's step (walk_head, walk_head_deep):
// available() root-down along the path, a warp vote for fits, admit or
// reserve with the borrow or nominal cap, the bubble of each node's
// over-guaranteed delta up the path (the JAX _avail_along_path and
// .at[].add, kueue_tpu/ops/assign_kernel.py:282 and
// kueue_tpu/ops/drain_kernel.py _plain_cycle).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "drain_common.cuh"

namespace drain {

constexpr int kLevels = 4;   // path levels the unrolled walk holds in registers
constexpr int kRows = 4;     // row cells a thread stages a round
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNoClamp = 0x7fffffffffffffffLL;  // a level with no borrowing limit

extern __shared__ __align__(16) unsigned char smem[];

__host__ __device__ inline int align8(long long b) { return (int)((b + 7) & ~7LL); }

// Shared bytes the walk of a segment with n_walk walked heads needs to
// keep its rows in shared memory: per path entry (head, level) a node
// id, a slot and the five int64 rows of FR cells. (The wrapper's
// phase2_segment_bytes says the same.)
__host__ __device__ inline long long segment_bytes(int n_walk, int fr, int d) {
  return (long long)n_walk * (d + 1) * (8 + 40LL * fr);
}

// One staging window: per head its PC merged cells and quantities, its
// path's D+1 rows (shared slots or node ids), its path's valid levels,
// its flags (1 Fit, 2 reserve, 4 borrowing, 8 cells repeat) and its
// ClusterQueue row.
struct Window {
  int* cell;
  int* lvl;
  int* nv;
  int* flag;
  int* cq;
  long long* qty;
};

__host__ __device__ inline int window_bytes(int win, int pc, int d) {
  return align8(4LL * win * (pc + d + 4)) + 8 * win * pc;
}

__device__ __forceinline__ Window window(int off, int win, int pc, int d) {
  unsigned char* base = smem + off;
  Window w;
  w.cell = (int*)base;
  w.lvl = w.cell + win * pc;
  w.nv = w.lvl + win * (d + 1);
  w.flag = w.nv + win;
  w.cq = w.flag + win;
  w.qty = (long long*)(base + align8(4LL * win * (pc + d + 4)));
  return w;
}

// Flag 8 on the window's heads whose merged cells repeat a cell, a lane
// a head: a cell on two lanes adds twice at each level (the JAX
// .at[].add), so such a head adds atomically, the others store their
// sums. Cells are told apart modulo 32; a collision only costs the
// atomics.
__device__ __forceinline__ void mark_repeats(const Window& w, int nr, int PC, int lane) {
  for (int r = lane; r < nr; r += 32) {
    unsigned seen = 0;
    int n_cells = 0;
    for (int k = 0; k < PC; ++k) {
      const int cell = w.cell[r * PC + k];
      if (cell >= 0 && w.qty[r * PC + k] > 0) {
        seen |= 1u << (cell & 31);
        ++n_cells;
      }
    }
    if (__popc(seen) < n_cells) w.flag[r] |= 8;
  }
  __syncwarp();
}

// The admit-or-reserve delta of one lane: the quantity when admitted,
// else the reservation's borrow or nominal cap against the leaf's usage
// as this step found it.
__device__ __forceinline__ long long step_delta(bool cv, bool admit, int flag, long long qv,
                                                long long nom, long long bl, long long leaf) {
  if (!cv) return 0;
  const long long cap = (flag & 4) ? (bl < kNoLimit ? min(qv, nom + bl - leaf) : qv)
                                   : max(0LL, min(qv, nom - leaf));
  return admit ? qv : (flag & 2) ? cap : 0;
}

// One head of warp 0's walk over the rows S, G, BL, U, N (shared slots
// or device-memory nodes, as lvl holds), its path NV levels long: its
// rows are read once, every level at once, and its bubble adds from
// those values (every lane reads every level before any lane adds; the
// lanes of a head with distinct cells write distinct cells, so only a
// repeating one waits for the others' reads).
// A further condition of the admission, the lane's part of it voted with
// the quota fit: none in the plain drain (the TAS drain's leaf gate).
struct NoGate {
  __device__ __forceinline__ bool operator()() const { return true; }
};

// Returns the admission; gate() is evaluated after the rows are read.
template <bool kShared, int NV, class Gate = NoGate>
__device__ __forceinline__ bool walk_head(const Window& w, int r, int PC, int D1, int FR,
                                          const long long* S, const long long* G,
                                          const long long* BL, long long* U,
                                          const long long* N, uint8_t* adm, int lane,
                                          Gate gate = Gate()) {
  const int* lvl = w.lvl + r * D1;
  const int flag = w.flag[r];
  int cell = -1;
  long long qv = 0;
  if (lane < PC) {
    cell = w.cell[r * PC + lane];
    qv = w.qty[r * PC + lane];
  }
  const bool cv = cell >= 0 && qv > 0, dup = flag & 8;
  const int cc = cv ? cell : 0;
  size_t x[NV];
  long long s[NV], g[NV], bl[NV], u[NV], over[NV];
#pragma unroll
  for (int d = 0; d < NV; ++d) {
    x[d] = (size_t)lvl[d] * FR + cc;
    s[d] = cv ? S[x[d]] : 0;
    g[d] = cv ? G[x[d]] : 0;
    bl[d] = cv ? BL[x[d]] : 0;
    u[d] = cv ? (kShared ? U[x[d]] : __ldcg(U + x[d])) : 0;
    over[d] = max(0LL, u[d] - g[d]);
  }
  const long long nom = cv ? N[x[0]] : 0;
  long long avail = s[NV - 1] - u[NV - 1];  // the root
#pragma unroll
  for (int d = NV - 2; d >= 0; --d) {
    // storedInParent - usedInParent + borrowingLimit, or no clamp
    const long long cap = bl[d] < kNoLimit ? (s[d] - g[d]) - over[d] + bl[d] : kNoClamp;
    avail = max(0LL, g[d] - u[d]) + min(cap, avail);
  }
  const bool fits = __all_sync(kFull, gate() && (!cv || avail >= qv));
  const bool admit = (flag & 1) && fits;
  long long delta = step_delta(cv, admit, flag, qv, nom, bl[0], u[0]);
  if (dup) __syncwarp();  // every lane has read every level
#pragma unroll
  for (int d = 0; d < NV; ++d) {
    if (cv && delta != 0) {
      if (dup) atomicAdd((unsigned long long*)&U[x[d]], (unsigned long long)delta);
      else U[x[d]] = u[d] + delta;
    }
    delta = max(0LL, u[d] + delta - g[d]) - over[d];
  }
  if (lane == 0) adm[r] = admit;
  __syncwarp();  // the head's adds land before the next head reads
  return admit;
}

// The same step level by level, for paths longer than kLevels.
template <bool kShared, class Gate = NoGate>
__device__ __forceinline__ bool walk_head_deep(const Window& w, int r, int PC, int D1, int FR,
                                               const long long* S, const long long* G,
                                               const long long* BL, long long* U,
                                               const long long* N, uint8_t* adm, int lane,
                                               Gate gate = Gate()) {
  auto load_u = [&](size_t x) { return kShared ? U[x] : __ldcg(U + x); };
  const int* lvl = w.lvl + r * D1;
  const int nv = w.nv[r], flag = w.flag[r];
  int cell = -1;
  long long qv = 0;
  if (lane < PC) {
    cell = w.cell[r * PC + lane];
    qv = w.qty[r * PC + lane];
  }
  const bool cv = cell >= 0 && qv > 0, dup = flag & 8;
  const int cc = cv ? cell : 0;
  long long avail = 0, leaf = 0;
  if (cv) {
    for (int d = nv - 1; d >= 0; --d) {
      const size_t xd = (size_t)lvl[d] * FR + cell;
      const long long sd = S[xd], gd = G[xd], bld = BL[xd];
      const long long ud = load_u(xd);
      if (d == nv - 1) {
        avail = sd - ud;
      } else {
        const long long with_max = (sd - gd) - max(0LL, ud - gd) + bld;
        const long long clamped = bld < kNoLimit ? min(with_max, avail) : avail;
        avail = max(0LL, gd - ud) + clamped;
      }
      leaf = ud;  // ends as the leaf row as this step found it
    }
  }
  const bool fits = __all_sync(kFull, gate() && (!cv || avail >= qv));
  const bool admit = (flag & 1) && fits;
  const size_t x0 = (size_t)lvl[0] * FR + cc;
  long long delta = step_delta(cv, admit, flag, qv, cv ? N[x0] : 0, cv ? BL[x0] : 0, leaf);
  for (int d = 0; d < nv; ++d) {
    const size_t xd = (size_t)lvl[d] * FR + cc;
    long long old = 0, gd = 0;
    if (cv) {
      old = load_u(xd);
      gd = G[xd];
    }
    __syncwarp();
    if (cv && delta != 0) {
      if (dup) atomicAdd((unsigned long long*)&U[xd], (unsigned long long)delta);
      else U[xd] = old + delta;
    }
    __syncwarp();
    delta = max(0LL, old + delta - gd) - max(0LL, old - gd);
  }
  if (lane == 0) adm[r] = admit;
  __syncwarp();  // the head's adds land before the next head reads
  return admit;
}

// The quota rows of the walk (tree pointers in device memory).
struct Rows {
  const long long* subtree;
  const long long* guaranteed;
  const long long* borrowing_limit;
  long long* usage;
  const long long* nominal;
};

// The subtree, guaranteed, borrowing-limit, usage and nominal rows of
// every path entry's node (E entries, ent_node[e] < 0 a pad) into
// S, G, BL, U, N (entry-major, FR cells an entry), kRows cells a thread
// a round, every load of a round issued before its stores; `first()`
// runs once while the first round's loads are in flight (the rows of a
// later entry of a node are loaded too, and never used). Then a node's
// slot: its first path entry, a warp an entry. The block is not
// synchronised at the end.
template <int kThreads, class First>
__device__ __forceinline__ void stage_rows(const Rows& t, const int* ent_node, int* ent_slot,
                                           int E, int FR, long long* S, long long* G,
                                           long long* BL, long long* U, long long* N,
                                           First first) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int base = 0; base < E * FR; base += kRows * kThreads) {
    long long v[kRows][5];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = base + k * kThreads + tid, e = i / FR;
      const bool on = i < E * FR && ent_node[e] >= 0;
      const size_t x = on ? (size_t)ent_node[e] * FR + (i - e * FR) : 0;
      v[k][0] = on ? __ldg(t.subtree + x) : 0;
      v[k][1] = on ? __ldg(t.guaranteed + x) : 0;
      v[k][2] = on ? __ldg(t.borrowing_limit + x) : 0;
      v[k][3] = on ? t.usage[x] : 0;
      v[k][4] = on ? __ldg(t.nominal + x) : 0;
    }
    if (base == 0) first();
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int i = base + k * kThreads + tid;
      if (i >= E * FR) continue;
      S[i] = v[k][0];
      G[i] = v[k][1];
      BL[i] = v[k][2];
      U[i] = v[k][3];
      N[i] = v[k][4];
    }
  }
  for (int e = warp; e < E; e += kThreads / 32) {
    const int node = ent_node[e];
    int slot = node < 0 ? -1 : e;
    if (node >= 0) {
      for (int f0 = 0; f0 < e; f0 += 32) {
        const int f = f0 + lane;
        const unsigned hit = __ballot_sync(kFull, f < e && ent_node[f] == node);
        if (hit) {
          slot = f0 + __ffs(hit) - 1;
          break;
        }
      }
    }
    if (lane == 0) ent_slot[e] = slot;
  }
}

}  // namespace drain
