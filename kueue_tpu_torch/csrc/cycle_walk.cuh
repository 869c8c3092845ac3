// The phase-2 walk of the admission cycle on one warp, shared by
// cycle_phase2.cu (B3: a root-cohort segment a block), cycle_global.cu
// (B3': the unsegmented cycle, a group of whole root subtrees a block)
// and plan_phase2.cu (B14's phase 2: a root segment of one scenario a
// one-warp block):
// each head's position in the global entry order (position), the staged
// step operands of a window of walked heads (Window, stage), and warp 0's
// walk of a window (walk_steps): available() root-down along the path,
// a warp vote for fits, admit or reserve with the borrow or nominal cap,
// the bubble of each node's over-guaranteed delta up the path
// (kueue_tpu/ops/assign_kernel.py _avail_along_path :282, _bubble_usage
// :315). Each function takes the kernel's Args (fields W K C FR D, the
// heads' and the tree's pointers, `packed`, `lay.win`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "quota_path.cuh"

namespace cycle2 {

constexpr int kWin = 32;            // heads a staging window
constexpr int kLevels = 4;          // path levels the unrolled walk holds in registers
constexpr unsigned kFull = 0xffffffffu;

extern __shared__ __align__(16) unsigned char smem[];

__host__ __device__ inline int align8(long long b) { return (int)((b + 7) & ~7LL); }

// One staging window: per head its C cells, quantities and leaf caps,
// its path's D+1 rows (shared slots or node ids), its index, its path's
// valid levels and its flags (1 admit-able, 2 reserve, 4 borrowing).
struct Window {
  int* cell;
  int* lvl;
  int* head;
  int* nv;
  int* flag;
  long long* qty;
  long long* nom;
  long long* bl;
};

__host__ __device__ inline int window_bytes(int win, int C, int D) {
  return align8(4LL * win * (C + D + 4)) + 24 * win * C;
}

// The window at byte offset `off` of the dynamic shared memory.
__device__ __forceinline__ Window window(int off, int win, int C, int D) {
  unsigned char* base = smem + off;
  Window w;
  w.cell = (int*)base;
  w.lvl = w.cell + win * C;
  w.head = w.lvl + win * (D + 1);
  w.nv = w.head + win;
  w.flag = w.nv + win;
  w.qty = (long long*)(base + align8(4LL * win * (C + D + 4)));
  w.nom = w.qty + win * C;
  w.bl = w.nom + win * C;
  return w;
}

// Position of head x in the entry order: the heads that order before it,
// counted by the lanes of one warp and summed.
template <bool kKeys, class A>
__device__ __forceinline__ int position(const A& a, const uint8_t* cls,
                                        const long long* prio, const long long* ts,
                                        int x, int lane) {
  const uint8_t cx = cls[x];
  const long long px = kKeys ? prio[x] : __ldg(a.priority + x);
  const long long tx = kKeys ? ts[x] : __ldg(a.timestamp + x);
  int n = 0;
#pragma unroll 4
  for (int y = lane; y < a.W; y += 32) {
    const uint8_t cy = cls[y];
    const long long py = kKeys ? prio[y] : __ldg(a.priority + y);
    const long long ty = kKeys ? ts[y] : __ldg(a.timestamp + y);
    // branchless: (cls, -priority, timestamp, index) lexicographic
    n += (cy < cx) | ((cy == cx) & ((py > px) | ((py == px) & ((ty < tx) | ((ty == tx) &
                                                                            (y < x))))));
  }
  return __reduce_add_sync(kFull, n);
}

// Stage window `wi` of the walk (heads walk[wi*win ...]) with threads
// t, t + nt, ... of the block, a thread a (head, cell or level) slot so
// that a slot's loads form one chain of three trips. lvl holds
// slot(rank, level, node): the row's shared slot when rows are staged,
// else the path's node id.
template <class A, class Slot>
__device__ __forceinline__ void stage(const A& a, const int* walk, int n_walk, int wi,
                                      int w_off, const uint8_t* cls, Slot slot, int t, int nt,
                                      bool lvl = true) {
  const int C = a.C, D1 = a.D + 1, win = a.lay.win, span = max(C, D1);
  const Window w = window(w_off, win, C, a.D);
  const int r0 = wi * win, nr = min(win, n_walk - r0);
  for (int i = t; i < nr * span; i += nt) {
    const int r = i / span, c = i - r * span;
    const int h = walk[r0 + r];
    const int cq = __ldg(a.cq_row + h);
    const int ch = __ldg(a.chosen + h), pk = __ldg(a.preempt_k + h);
    const int* path = a.paths + (size_t)cq * D1;
    if (c < D1 && lvl) {
      w.lvl[r * D1 + c] = slot(r0 + r, c, __ldg(path + c));
    }
    if (c == 0) {
      int nv = 0;
      for (int d = 0; d < D1; ++d) nv += __ldg(path + d) >= 0;
      w.head[r] = h;
      w.nv[r] = nv;
      w.flag[r] = (ch >= 0 ? 1 : 0) | (ch < 0 && pk >= 0 && __ldg(a.no_reclaim + h) ? 2 : 0) |
                  ((cls[h] & 1) ? 4 : 0);
    }
    if (c < C) {
      const size_t ci = ((size_t)h * a.K + (ch >= 0 ? ch : pk)) * C + c;
      const int cell = __ldg(a.cells + ci);
      const size_t lx = (size_t)cq * a.FR + max(cell, 0);
      w.cell[r * C + c] = cell;
      w.qty[r * C + c] = __ldg(a.qty + ci);
      w.nom[r * C + c] = cell >= 0 ? __ldg(a.nominal + lx) : 0;
      w.bl[r * C + c] = cell >= 0 ? __ldg(a.borrowing_limit + lx) : 0;
    }
  }
}

// Warp 0's walk of one staged window over the rows S, G, BL, U (shared
// slots or device-memory nodes, as lvl holds). With kL > 0 (paths of at
// most kL levels) a head's rows are read once, every level at once, and
// its bubble adds from those values: every lane reads every level
// before any lane adds. kL = 0 reads level by level.
template <bool kShared, int kL, class A>
__device__ __forceinline__ void walk_window(const A& a, int w_off, int nr,
                                            const long long* S, const long long* G,
                                            const long long* BL, long long* U, int lane) {
  const int C = a.C, FR = a.FR, D1 = a.D + 1;
  const Window w = window(w_off, a.lay.win, C, a.D);
  long long* out_admitted = a.packed + a.W;
  long long* out_reserved = a.packed + 3 * (size_t)a.W;
  auto load_u = [&](size_t x) { return kShared ? U[x] : __ldcg(U + x); };
  for (int r = 0; r < nr; ++r) {
    const int* lvl = w.lvl + r * D1;
    const int nv = w.nv[r], flag = w.flag[r];
    int cell = -1;
    long long qv = 0;
    if (lane < C) {
      cell = w.cell[r * C + lane];
      qv = w.qty[r * C + lane];
    }
    const bool cv = cell >= 0 && qv > 0;
    const int cc = cv ? cell : 0;
    // a cell on two lanes adds twice at each level (the JAX .at[].add):
    // then atomics, else each lane stores its own sums. Cells are told
    // apart modulo 32; a collision only costs the atomics.
    const unsigned seen = __reduce_or_sync(kFull, cv ? 1u << (cell & 31) : 0u);
    const bool dup = __popc(seen) < __popc(__ballot_sync(kFull, cv));
    bool ok = true;
    long long leaf = 0;
    long long u[kL > 0 ? kL : 1], g[kL > 0 ? kL : 1];
    size_t x[kL > 0 ? kL : 1];
    if constexpr (kL > 0) {
      long long s[kL], bl[kL];
#pragma unroll
      for (int d = 0; d < kL; ++d) {
        x[d] = (size_t)(d < nv ? lvl[d] : 0) * FR + cc;
        const bool on = cv && d < nv;
        s[d] = on ? S[x[d]] : 0;
        g[d] = on ? G[x[d]] : 0;
        bl[d] = on ? BL[x[d]] : 0;
        u[d] = on ? load_u(x[d]) : 0;
      }
      long long avail = 0;
#pragma unroll
      for (int d = kL - 1; d >= 0; --d) {
        if (d >= nv) continue;
        if (d == nv - 1) {
          avail = s[d] - u[d];
        } else {
          const long long with_max = (s[d] - g[d]) - max(0LL, u[d] - g[d]) + bl[d];
          const long long clamped =
              bl[d] < quota_path::kNoLimit ? min(with_max, avail) : avail;
          avail = max(0LL, g[d] - u[d]) + clamped;
        }
      }
      ok = !cv || avail >= qv;
      leaf = u[0];  // the leaf row as this step found it
    } else if (cv) {
      long long avail = 0;
      for (int d = nv - 1; d >= 0; --d) {
        const size_t xd = (size_t)lvl[d] * FR + cell;
        const long long sd = S[xd], gd = G[xd], bld = BL[xd];
        const long long ud = load_u(xd);
        if (d == nv - 1) {
          avail = sd - ud;
        } else {
          const long long with_max = (sd - gd) - max(0LL, ud - gd) + bld;
          const long long clamped = bld < quota_path::kNoLimit ? min(with_max, avail) : avail;
          avail = max(0LL, gd - ud) + clamped;
        }
        leaf = ud;  // ends as the leaf row as this step found it
      }
      ok = avail >= qv;
    }
    const bool fits = __all_sync(kFull, ok);
    const bool admit = (flag & 1) && fits;
    const bool reserve = flag & 2;
    long long delta = 0;
    if (cv) {
      const long long nom = w.nom[r * C + lane], bl = w.bl[r * C + lane];
      const long long cap = (flag & 4)
          ? (bl < quota_path::kNoLimit ? min(qv, nom + bl - leaf) : qv)
          : max(0LL, min(qv, nom - leaf));
      delta = admit ? qv : reserve ? cap : 0;
    }
    if constexpr (kL > 0) {
      __syncwarp();  // every lane has read every level
#pragma unroll
      for (int d = 0; d < kL; ++d) {
        if (d >= nv) break;
        if (cv && delta != 0) {
          if (dup) atomicAdd((unsigned long long*)&U[x[d]], (unsigned long long)delta);
          else U[x[d]] = u[d] + delta;
        }
        delta = max(0LL, u[d] + delta - g[d]) - max(0LL, u[d] - g[d]);
      }
    } else {
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
    }
    if (lane == 0) {
      out_admitted[w.head[r]] = admit;
      out_reserved[w.head[r]] = reserve;
    }
    __syncwarp();  // the head's adds land before the next head reads
  }
}

template <bool kShared, class A>
__device__ __forceinline__ void walk_steps(const A& a, int w_off, int nr,
                                           const long long* S, const long long* G,
                                           const long long* BL, long long* U, int lane) {
  if (a.D + 1 <= kLevels) walk_window<kShared, kLevels>(a, w_off, nr, S, G, BL, U, lane);
  else walk_window<kShared, 0>(a, w_off, nr, S, G, BL, U, lane);
}

}  // namespace cycle2
