// Kernel 3, drain_phase2: one drain cycle's conflict resolution.
//
// Replaces the entry-order jnp.lexsort, segmented_rank
// (ops/assign_kernel.py:449) and the lax.scan step loop of
// kueue_tpu/ops/drain_kernel.py _plain_cycle (:486-582), with the
// per-step _avail_along_path (assign_kernel.py:282) and the usage
// bubble-up.
//
// Grid: one block of 8 warps per root-cohort segment (CSR from the
// host): roots touch disjoint tree rows, so segments need no
// synchronisation with each other (the JAX scan runs them in lockstep,
// which is the same). Each block
//   1. stages every member's sort key in shared memory, the loads of a
//      round issued together: ranked (nominated, Fit or preempt-mode,
//      and active), borrowing, the priority and timestamp of its entry
//      at min(cursor, L-1), and its ClusterQueue row and ancestor path
//      (the keys stay in device memory when the segment is too wide for
//      them);
//   2. ranks each ranked member by (borrowing asc, priority desc,
//      timestamp asc, queue index asc) — the last key is jnp.lexsort's
//      stability — a warp a member, the lanes counting the members that
//      order before it, branchless, and a warp sum; ranks >= n_steps
//      are dropped exactly as the JAX scatter drops them, and so is a
//      segment >= n_segments;
//   3. puts the walk's quota rows in shared memory: the subtree,
//      guaranteed, borrowing-limit, usage and nominal rows of every
//      node on the walked heads' paths, read in one round while window
//      0 is staged (step 4), then deduplicated in the block (a node's
//      first path entry holds its rows; a warp an entry, a ballot over
//      the earlier ones); a segment whose rows do not fit
//      (segment_bytes below) walks on the device-memory rows instead,
//      chosen here from its size;
//   4. stages each walked head's step operands (its merged cells and
//      quantities, its path's rows, its flags) in windows of up to 32
//      heads: all warps stage the first, then warps 1-7 stage window
//      i+1 while warp 0 walks window i;
//   5. warp 0 walks the heads in rank order (drain_walk.cuh, shared with
//      drain_tas_phase2.cu), one lane per merged cell
//      (P*C <= 32), each head's step unrolled over its own path's
//      levels (up to 4; longer paths level by level): available()
//      root-down along the path, a warp vote for fits, admit (Fit and
//      fits) or reserve (preempt-mode and reclaimWithinCohort != Any)
//      with the borrow or nominal cap, then the bubble of each node's
//      over-guaranteed delta up the path. Every lane reads its level
//      before any lane adds, as the JAX .at[].add does; a head whose
//      cells are distinct stores its sums, one repeating a cell adds
//      atomically. The walk touches shared memory only: the cycle usage
//      tree is mutated in place on the shared rows (it is rebuilt from
//      the leaf rows at the start of every cycle, so reservations die
//      with the cycle), and each head's admission is kept by rank;
//   6. writes back the usage rows, adds the admitted quantities to
//      their queues' leaf rows of the leaf usage (from the windows
//      still staged, else from device memory) and sets `admitted`,
//      every thread at once. `admitted` is written for the walked heads
//      only: the nomination cleared it for every queue.
//
// What bounds it: the walk is sequential within a segment (each head
// sees its predecessors' admissions). Its least time is a chain: two
// dependent shared-memory trips a walked head (read its usage rows,
// add) over the longest segment, ~0.6 us at the headline (20 heads);
// the bytes bound (chip_smoke.py counts it) is well under a
// microsecond. On the card a head's step is a chain of dependent int64
// operations and warp votes of one warp, ~0.5 us a head (PERF.md).
// Steps 1-4 and 6 are a few device-memory round trips a block, all
// warps at once. A set `done` flag makes the launch a no-op.

#include "drain_common.cuh"
#include "drain_walk.cuh"

namespace drain {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWin = 32;     // heads a staging window
constexpr int kStage = 2;    // members a thread stages a round
constexpr int kSmemMax = 232448 - 1024;  // a block's opt-in shared memory (sm_90),
                                          // less room for the static n_valid

// Byte offsets of the dynamic shared memory (multiples of 8), set by
// the host.
struct Layout {
  int kx, kf, kp, kt;  // member keys: queue index, flags, priority, timestamp
  int kc, kpath;       // member's ClusterQueue row, its ancestor path
  int walk;            // int32[max_members]: the walked members by rank
  int adm;             // uint8[max_members]: admitted, by rank
  int stage;           // two staging windows of `win` heads
  int stage_buf;       // bytes of one window
  int rows;            // the segment's rows, `rows_bytes` of them
  int rows_bytes;
  int win;
  int keys;            // 1 when the members' keys are staged
  int total;
};


// A member's sort key: its queue, flags (1 ranked, 2 borrowing), the
// priority and timestamp of its current entry.
struct Key {
  int x, f;
  long long p, t;
};

// Key of member j from device memory: three dependent trips.
__device__ __forceinline__ Key load_key(const Args& a, int beg, int j) {
  Key k;
  k.x = __ldg(a.seg_members + beg + j);
  const int cur = __ldg(a.s.cursor + k.x);
  const bool ranked = (__ldg(a.b.is_fit + k.x) | __ldg(a.b.is_pre + k.x)) &&
                      cur < __ldg(a.q.qlen + k.x) && __ldg(a.s.alive + k.x);
  k.f = (ranked ? 1 : 0) | (__ldg(a.b.head_borrow + k.x) ? 2 : 0);
  const size_t e = (size_t)k.x * a.L + min(cur, a.L - 1);
  k.p = __ldg(a.q.priority + e);
  k.t = __ldg(a.q.timestamp + e);
  return k;
}

template <bool kKeys>
__device__ __forceinline__ Key key_of(const Args& a, const Layout& L, int beg, int j) {
  if constexpr (kKeys) {
    Key k;
    k.x = ((const int*)(smem + L.kx))[j];
    k.f = smem[L.kf + j];
    k.p = ((const long long*)(smem + L.kp))[j];
    k.t = ((const long long*)(smem + L.kt))[j];
    return k;
  } else {
    return load_key(a, beg, j);
  }
}

// Member m's queue, ClusterQueue row and path node at level d: staged
// with the keys, else from device memory.
template <bool kKeys>
struct Members {
  const int* kx;       // shared: queue, ClusterQueue row, path by member
  const int* kc;
  const int* kpath;
  const int* members;  // device memory: the segment's queues
  const int* cq_rows;
  const int* paths;
  int d1;
  __device__ __forceinline__ int queue(int m) const {
    return kKeys ? kx[m] : __ldg(members + m);
  }
  __device__ __forceinline__ int cq(int m) const {
    return kKeys ? kc[m] : max(__ldg(cq_rows + queue(m)), 0);
  }
  __device__ __forceinline__ int path(int m, int d) const {
    return kKeys ? kpath[m * d1 + d] : __ldg(paths + (size_t)cq(m) * d1 + d);
  }
};

// Stage window `wi` of the walk (members walk[wi*win ...]) with threads
// t, t + nt, ... of the block, a thread a (head, cell or level) slot.
// lvl holds shared slots (ent_slot, by path entry) when rows are
// staged, else the paths' node ids.
template <bool kKeys>
__device__ __forceinline__ void stage(const Args& a, const Layout& L, const Members<kKeys>& mb,
                                      const int* walk, int n_walk, int wi, int w_off,
                                      const int* ent_slot, int t, int nt, bool lvl = true) {
  const int PC = a.P * a.C, D1 = a.D + 1, win = L.win, span = max(PC, D1);
  const Window w = window(w_off, win, PC, a.D);
  const int r0 = wi * win, nr = min(win, n_walk - r0);
  for (int i = t; i < nr * span; i += nt) {
    const int r = i / span, c = i - r * span;
    const int m = walk[r0 + r];
    const int h = mb.queue(m);
    if (c < D1 && lvl) {
      w.lvl[r * D1 + c] = ent_slot ? ent_slot[(r0 + r) * D1 + c] : mb.path(m, c);
    }
    if (c == 0) {
      int nv = 0;
      for (int d = 0; d < D1; ++d) nv += mb.path(m, d) >= 0;
      w.nv[r] = nv;
      w.cq[r] = mb.cq(m);
      w.flag[r] = (__ldg(a.b.is_fit + h) ? 1 : 0) |
                  (__ldg(a.b.is_pre + h) && __ldg(a.q.no_reclaim + h) ? 2 : 0) |
                  (__ldg(a.b.head_borrow + h) ? 4 : 0);
    }
    if (c < PC) {
      const size_t ci = (size_t)h * PC + c;
      w.cell[r * PC + c] = __ldg(a.b.cells_eff + ci);
      w.qty[r * PC + c] = __ldg(a.b.qty_eff + ci);
    }
  }
}


// Warp 0's walk of one staged window: each head's step unrolled over its
// own path's levels (up to kLevels), else level by level.
template <bool kShared>
__device__ __forceinline__ void walk_window(const Args& a, const Layout& Lay, int w_off,
                                            int nr, const long long* S, const long long* G,
                                            const long long* BL, long long* U,
                                            const long long* N, uint8_t* adm, int lane) {
  const int PC = a.P * a.C, FR = a.FR, D1 = a.D + 1;
  const Window w = window(w_off, Lay.win, PC, a.D);
  mark_repeats(w, nr, PC, lane);
  static_assert(kLevels == 4, "the switch below unrolls 1-4 levels");
  for (int r = 0; r < nr; ++r) {
    switch (w.nv[r]) {
      case 1: walk_head<kShared, 1>(w, r, PC, D1, FR, S, G, BL, U, N, adm, lane); break;
      case 2: walk_head<kShared, 2>(w, r, PC, D1, FR, S, G, BL, U, N, adm, lane); break;
      case 3: walk_head<kShared, 3>(w, r, PC, D1, FR, S, G, BL, U, N, adm, lane); break;
      case 4: walk_head<kShared, 4>(w, r, PC, D1, FR, S, G, BL, U, N, adm, lane); break;
      default: walk_head_deep<kShared>(w, r, PC, D1, FR, S, G, BL, U, N, adm, lane);
    }
  }
}

// One block a multiprocessor is enough (the grid is a block a segment or
// bin): without the 1, ptxas held the kernel to 64 registers and spilled.
template <bool kKeys>
__global__ void __launch_bounds__(kThreads, 1) phase2(Args a, Layout L) {
  const int s = blockIdx.x;
  if (*a.s.done || s >= a.n_segments) return;
  const int beg = a.seg_offsets[s], m = a.seg_offsets[s + 1] - beg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D1 = a.D + 1;
  int* walk = (int*)(smem + L.walk);
  const Members<kKeys> mb{(const int*)(smem + L.kx), (const int*)(smem + L.kc),
                          (const int*)(smem + L.kpath), a.seg_members + beg, a.q.cq_rows,
                          a.t.paths, D1};
  __shared__ int n_valid;
  if (tid == 0) n_valid = 0;

  if constexpr (kKeys) {
    // a thread's members j = base + i * kThreads + tid, kStage at a
    // time: every load of a trip issued before the next trip's
    int* kx = (int*)(smem + L.kx);
    uint8_t* kf = smem + L.kf;
    long long* kp = (long long*)(smem + L.kp);
    long long* kt = (long long*)(smem + L.kt);
    int* kc = (int*)(smem + L.kc);
    int* kpath = (int*)(smem + L.kpath);
    for (int base = 0; base < m; base += kStage * kThreads) {
      int x[kStage], cur[kStage], f[kStage], cq[kStage];
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int j = base + i * kThreads + tid;
        x[i] = j < m ? __ldg(a.seg_members + beg + j) : 0;
      }
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        cur[i] = __ldg(a.s.cursor + x[i]);
        cq[i] = max(__ldg(a.q.cq_rows + x[i]), 0);
        const bool ranked = (__ldg(a.b.is_fit + x[i]) | __ldg(a.b.is_pre + x[i])) &&
                            cur[i] < __ldg(a.q.qlen + x[i]) && __ldg(a.s.alive + x[i]);
        f[i] = (ranked ? 1 : 0) | (__ldg(a.b.head_borrow + x[i]) ? 2 : 0);
      }
#pragma unroll
      for (int i = 0; i < kStage; ++i) {
        const int j = base + i * kThreads + tid;
        if (j >= m) continue;
        const size_t e = (size_t)x[i] * a.L + min(cur[i], a.L - 1);
        kx[j] = x[i];
        kf[j] = (uint8_t)f[i];
        kc[j] = cq[i];
        kp[j] = __ldg(a.q.priority + e);
        kt[j] = __ldg(a.q.timestamp + e);
        for (int d = 0; d < D1; ++d) {
          kpath[j * D1 + d] = __ldg(a.t.paths + (size_t)cq[i] * D1 + d);
        }
      }
    }
  }
  __syncthreads();

  // rank: a warp a ranked member, its lanes counting its predecessors
  for (int i = warp; i < m; i += kWarps) {
    const Key ki = key_of<kKeys>(a, L, beg, i);
    if (!(ki.f & 1)) continue;
    const int bi = ki.f >> 1;
    int n = 0;
    for (int j = lane; j < m; j += 32) {
      const Key kj = key_of<kKeys>(a, L, beg, j);
      const int bj = kj.f >> 1;
      // branchless: (borrowing, -priority, timestamp, queue index)
      n += (kj.f & 1) &
           ((bj < bi) | ((bj == bi) & ((kj.p > ki.p) |
                                       ((kj.p == ki.p) & ((kj.t < ki.t) |
                                                          ((kj.t == ki.t) & (kj.x < ki.x)))))));
    }
    n = __reduce_add_sync(kFull, n);
    if (lane == 0) {
      atomicAdd(&n_valid, 1);
      if (n < a.n_steps) walk[n] = i;
    }
  }
  __syncthreads();
  const int n_walk = min(n_valid, a.n_steps);
  if (n_walk == 0) return;

  // the walk's rows: in shared memory when the segment's fit
  const int FR = a.FR, E = n_walk * D1;
  const bool shared_rows = segment_bytes(n_walk, FR, a.D) <= L.rows_bytes;
  int* ent_node = (int*)(smem + L.rows);
  int* ent_slot = ent_node + E;
  long long* S = (long long*)(smem + L.rows + align8(8LL * E));
  long long* G = S + (size_t)E * FR;
  long long* BL = G + (size_t)E * FR;
  long long* U = BL + (size_t)E * FR;
  long long* N = U + (size_t)E * FR;
  const int win = L.win, n_win = (n_walk + win - 1) / win;
  const int w0 = L.stage, w1 = L.stage + L.stage_buf;  // the two windows' offsets
  const int* slots = shared_rows ? ent_slot : nullptr;
  if (!shared_rows) {
    stage<kKeys>(a, L, mb, walk, n_walk, 0, w0, nullptr, tid, kThreads, true);
  } else {
    for (int e = tid; e < E; e += kThreads) {
      const int r = e / D1;
      ent_node[e] = mb.path(walk[r], e - r * D1);
    }
    __syncthreads();
    stage_rows<kThreads>(
        Rows{a.t.subtree, a.t.guaranteed, a.t.borrowing_limit, a.b.usage, a.t.nominal},
        ent_node, ent_slot, E, FR, S, G, BL, U, N, [&] {
          stage<kKeys>(a, L, mb, walk, n_walk, 0, w0, nullptr, tid, kThreads, false);
        });
    __syncthreads();
    int* lvl0 = window(w0, win, a.P * a.C, a.D).lvl;
    for (int i = tid; i < min(win, n_walk) * D1; i += kThreads) lvl0[i] = ent_slot[i];
  }
  __syncthreads();
  uint8_t* adm = smem + L.adm;
  for (int wi = 0; wi < n_win; ++wi) {
    const int cur = (wi & 1) ? w1 : w0;
    if (warp == 0) {
      const int nr = min(win, n_walk - wi * win);
      uint8_t* adm_w = adm + wi * win;
      if (shared_rows) walk_window<true>(a, L, cur, nr, S, G, BL, U, N, adm_w, lane);
      else walk_window<false>(a, L, cur, nr, a.t.subtree, a.t.guaranteed,
                              a.t.borrowing_limit, a.b.usage, a.t.nominal, adm_w, lane);
    } else if (wi + 1 < n_win) {
      stage<kKeys>(a, L, mb, walk, n_walk, wi + 1, (wi & 1) ? w0 : w1, slots, tid - 32,
                   kThreads - 32);
    }
    __syncthreads();
  }
  // the walk touched shared memory only: its rows, the admissions'
  // leaf usage and flags go out now, every thread at once
  if (shared_rows) {
    for (int i = tid; i < E * FR; i += kThreads) {
      const int e = i / FR;
      if (ent_slot[e] == e) a.b.usage[(size_t)ent_node[e] * FR + (i - e * FR)] = U[i];
    }
  }
  const int PC = a.P * a.C;
  const int intact = max(0, n_win - 2) * win;  // the last two windows are still staged
  for (int i = tid; i < n_walk * PC; i += kThreads) {
    const int r = i / PC, c = i - r * PC;
    if (!adm[r]) continue;
    int cell, cq;
    long long qv;
    if (r >= intact) {
      const Window w = window(((r / win) & 1) ? w1 : w0, win, PC, a.D);
      const int rr = r % win;
      cell = w.cell[rr * PC + c];
      qv = w.qty[rr * PC + c];
      cq = w.cq[rr];
    } else {
      const size_t ci = (size_t)mb.queue(walk[r]) * PC + c;
      cell = __ldg(a.b.cells_eff + ci);
      qv = __ldg(a.b.qty_eff + ci);
      cq = mb.cq(walk[r]);
    }
    if (cell >= 0 && qv > 0) {
      atomicAdd((unsigned long long*)(a.s.local + (size_t)cq * FR + cell),
                (unsigned long long)qv);
    }
  }
  for (int r = tid; r < n_walk; r += kThreads) a.b.admitted[mb.queue(walk[r])] = adm[r];
}

// The block's shared-memory layout for these shapes; false when even
// one-head windows do not fit.
bool plan_layout(const Args& a, Layout* L) {
  const int M = max(a.max_members, 1), PC = a.P * a.C, D1 = a.D + 1;
  const int base = align8(4LL * M) + align8(M);  // walk, adm
  // kx, kf, kp, kt, kc, kpath
  const int keys = align8(4LL * M) + align8(M) + 16 * M + align8(4LL * M) +
                   align8(4LL * M * D1);
  int win = kWin;
  const bool with_keys = base + keys + 2 * window_bytes(win, PC, a.D) <= kSmemMax;
  if (!with_keys) {
    while (win > 1 && base + 2 * window_bytes(win, PC, a.D) > kSmemMax) win >>= 1;
    if (base + 2 * window_bytes(win, PC, a.D) > kSmemMax) return false;
  }
  int off = 0;
  L->kx = off;
  off += with_keys ? align8(4LL * M) : 0;
  L->kf = off;
  off += with_keys ? align8(M) : 0;
  L->kp = off;
  off += with_keys ? 8 * M : 0;
  L->kt = off;
  off += with_keys ? 8 * M : 0;
  L->kc = off;
  off += with_keys ? align8(4LL * M) : 0;
  L->kpath = off;
  off += with_keys ? align8(4LL * M * D1) : 0;
  L->keys = with_keys;
  L->walk = off;
  off += align8(4LL * M);
  L->adm = off;
  off += align8(M);
  L->win = win;
  L->stage = off;
  L->stage_buf = window_bytes(win, PC, a.D);
  off += 2 * L->stage_buf;
  L->rows = off;
  // a segment walks at most min(its members, n_steps) heads
  const long long need = align8(segment_bytes(min(M, max(a.n_steps, 0)), a.FR, a.D));
  L->rows_bytes = (int)(need < kSmemMax - off ? need : kSmemMax - off);
  L->total = off + L->rows_bytes;
  return true;
}

template <bool kKeys>
int launch(const Args& a, const Layout& L, cudaStream_t stream) {
  static int raised = 48 * 1024;  // the dynamic shared memory allowed so far
  if (L.total > raised) {
    cudaError_t rc = cudaFuncSetAttribute(
        phase2<kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (rc != cudaSuccess) return (int)rc;
    raised = kSmemMax;
  }
  phase2<kKeys><<<a.n_seg, kThreads, L.total, stream>>>(a, L);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace drain

extern "C" int drain_phase2(const int* ints, int n_ints, void* const* ptrs,
                            int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32) return (int)cudaErrorInvalidValue;
  if (a.n_seg <= 0) return (int)cudaGetLastError();
  drain::Layout L;
  if (!drain::plan_layout(a, &L)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return L.keys ? drain::launch<true>(a, L, s) : drain::launch<false>(a, L, s);
}
