// Kernel cycle_phase2: phase 2 of the interactive admission cycle.
//
// Replaces the phase-2 part of solve_cycle_segmented
// (kueue_tpu/ops/assign_kernel.py:475, packed at :631-655): the entry
// order (one global jnp.lexsort over all W heads), segmented_rank
// (:449) and the lax.scan step loop with _avail_along_path (:282) and
// the usage bubble-up (_bubble_usage, :315). It writes the packed
// int64[5, W] outcome: chosen, admitted, borrows, reserved, order.
//
// Grid: one block of 8 warps per root-cohort segment (CSR from the
// host), plus one block for the heads outside every segment (pads).
// Each block
//   1. stages every head's sort key in shared memory with coalesced
//      loads: its class (no-fit, borrowing), priority and timestamp,
//      17 B a head (the priorities and timestamps stay in device memory
//      when W is too wide for them);
//   2. gives each of its heads its global position in the entry order
//      (no-fit last, non-borrowing first, priority desc, timestamp
//      asc, head index asc: the index is jnp.lexsort's stability), a
//      warp a head, the lanes counting the heads that order before it
//      and a warp sum; writes order[pos]. The pad block deals its heads
//      to the warps in turn (pads sit together at the end of W);
//   3. ranks its walkable heads (not no-fit, cq_row >= 0) by position
//      (cycle_body::rank_members); ranks >= n_steps are dropped, as
//      the JAX mode="drop" scatter drops them, and so is a segment
//      >= n_segments;
//   4. puts the walk's quota rows in shared memory: the nodes on the
//      walked heads' paths (a segment is a root cohort, so blocks hold
//      disjoint nodes), deduplicated in the block, with their subtree,
//      guaranteed, borrowing-limit and usage rows; a segment whose rows
//      do not fit (segment_bytes below) walks on the device-memory rows
//      instead, chosen here from its size;
//   5. stages each walked head's step operands (its effective
//      candidate's cells and quantities, the leaf caps, its path's
//      rows, its admit / reserve / borrow flags) in windows of up to 32
//      heads: all warps stage the first, then warps 1-7 stage window
//      i+1 while warp 0 walks window i;
//   6. warp 0 walks in rank order (cycle_walk.cuh, shared with
//      cycle_global.cu), one lane per cell (C <= 32), a
//      head's path rows read at once (up to 4 levels; deeper paths
//      level by level):
//      available() root-down along the path, a warp vote for fits,
//      admit (chosen >= 0 and fits) or reserve (chosen < 0, a
//      preempt-mode candidate and reclaimWithinCohort != Any) with the
//      borrow or nominal cap, then the bubble of each node's
//      over-guaranteed delta up the path. Every lane reads its level
//      before any lane adds, as the JAX .at[].add does; a head whose
//      cells are distinct stores its sums, one repeating a cell adds
//      atomically. With the rows in shared memory the walk touches
//      shared memory only, and the usage rows are written back at the
//      end.
// `usage` is the cycle's usage tree, built by quota_tree from the leaf
// rows; the resident leaf buffer is never written here.
//
// What bounds it: the walk is sequential within a segment (each head
// sees its predecessors' admissions). Its least time is a chain: two
// dependent shared-memory trips a walked head (read its path's rows,
// add) over the longest segment, ~0.6 us at the headline; the bytes
// bound (chip_smoke.py counts it) is well under a microsecond. Steps
// 1-5 are a few device-memory round trips a block, all warps at once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cycle_body.cuh"
#include "cycle_walk.cuh"

namespace cycle2 {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 2;           // heads a thread stages a round
constexpr int kSmemMax = 232448 - 1024;  // a block's opt-in shared memory (sm_90),
                                          // less room for the static n_valid

// Byte offsets of the dynamic shared memory (multiples of 8), set by
// the host.
struct Layout {
  int prio, ts;      // int64[W] each, when the keys are staged
  int stage;         // two staging windows of `win` heads
  int stage_buf;     // bytes of one window
  int spos, walk;    // int32[max_members] each
  int cls;           // uint8[W]
  int rows;          // the segment's rows, `rows_bytes` of them
  int rows_bytes;
  int win;
  int keys;          // 1 when the priorities and timestamps are staged
  int total;
};

struct Args {
  int W, K, C, N, FR, D, n_segments, n_steps, n_seg, max_members;
  const int* cq_row;          // [W]
  const int* cells;           // [W,K,C]
  const long long* qty;       // [W,K,C]
  const long long* priority;  // [W]
  const long long* timestamp; // [W]
  const uint8_t* no_reclaim;  // [W]
  const int* chosen;          // [W]
  const uint8_t* borrows;     // [W,K]
  const int* preempt_k;       // [W]
  const int* seg_id;          // [W]
  const int* seg_offsets;     // [n_seg+1]
  const int* seg_members;
  const long long* nominal;   // [N,FR]
  const long long* borrowing_limit;
  const long long* subtree;
  const long long* guaranteed;
  const int* paths;           // [N,D+1]
  long long* usage;           // [N,FR] the cycle usage tree, updated
  long long* packed;          // [5,W]
  Layout lay;
};

// Shared bytes the walk of a segment with n_walk walked heads needs to
// keep its rows in shared memory: per path entry (head, level) a node
// id, a slot and the four int64 rows of FR cells. (The wrapper's
// segment_bytes says the same.)
__host__ __device__ inline long long segment_bytes(int n_walk, int fr, int d) {
  return (long long)n_walk * (d + 1) * (8 + 32LL * fr);
}

template <bool kKeys>
__global__ void __launch_bounds__(kThreads) phase2(Args a) {
  const Layout& L = a.lay;
  long long* prio = (long long*)(smem + L.prio);
  long long* ts = (long long*)(smem + L.ts);
  int* spos = (int*)(smem + L.spos);
  int* walk = (int*)(smem + L.walk);
  uint8_t* cls = smem + L.cls;
  __shared__ int n_valid;

  const int W = a.W, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x;
  const bool seg_block = b < a.n_seg;
  // a thread's heads j = tid + i * kThreads, kStage at a time: every
  // load of a round issued before the round's dependent borrow bits
  for (int base = 0; base < W; base += kStage * kThreads) {
    int e[kStage];
    long long pr[kStage], tm[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int j = base + i * kThreads + tid;
      e[i] = -1;
      if (j < W) {
        const int ch = __ldg(a.chosen + j), pk = __ldg(a.preempt_k + j);
        e[i] = ch >= 0 ? ch : pk;
        if (kKeys) {
          pr[i] = __ldg(a.priority + j);
          tm[i] = __ldg(a.timestamp + j);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int j = base + i * kThreads + tid;
      if (j >= W) continue;
      // (no-fit << 1) | borrowing of the effective candidate
      cls[j] = e[i] < 0 ? 2 : (__ldg(a.borrows + (size_t)j * a.K + e[i]) ? 1 : 0);
      if (kKeys) {
        prio[j] = pr[i];
        ts[j] = tm[i];
      }
    }
  }
  if (tid == 0) n_valid = 0;
  __syncthreads();

  long long* out_chosen = a.packed;
  long long* out_admitted = a.packed + W;
  long long* out_borrows = a.packed + 2 * (size_t)W;
  long long* out_reserved = a.packed + 3 * (size_t)W;
  long long* out_order = a.packed + 4 * (size_t)W;
  const int beg = seg_block ? a.seg_offsets[b] : 0;
  const int m = seg_block ? a.seg_offsets[b + 1] - beg : 0;
  auto place = [&](int x, int i) {
    const int pos = position<kKeys>(a, cls, prio, ts, x, lane);
    if (lane == 0) {
      out_order[pos] = x;
      out_chosen[x] = a.chosen[x];
      out_borrows[x] = cls[x] & 1;
      out_admitted[x] = 0;
      out_reserved[x] = 0;
      if (i >= 0) spos[i] = (cls[x] & 2) || a.cq_row[x] < 0 ? -1 : pos;
    }
  };
  if (seg_block) {
    for (int i = warp; i < m; i += kWarps) place(a.seg_members[beg + i], i);
  } else {  // the heads of no segment, dealt to the warps in turn
    int seen = 0;
    for (int base = 0; base < W; base += 32) {
      const int y = base + lane;
      unsigned pads = __ballot_sync(kFull, y < W && __ldg(a.seg_id + y) < 0);
      while (pads) {
        const int x = base + __ffs(pads) - 1;
        pads &= pads - 1;
        if (seen++ % kWarps == warp) place(x, -1);
      }
    }
  }
  if (!seg_block || b >= a.n_segments) return;
  __syncthreads();

  cycle_body::rank_members(spos, m, a.seg_members + beg, a.n_steps, walk, &n_valid);
  __syncthreads();
  const int n_walk = min(n_valid, a.n_steps);
  if (n_walk == 0) return;

  // the walk's rows: in shared memory when the segment's fit
  const int FR = a.FR, D1 = a.D + 1, E = n_walk * D1;
  const bool shared_rows = segment_bytes(n_walk, FR, a.D) <= L.rows_bytes;
  int* ent_node = (int*)(smem + L.rows);
  int* ent_slot = ent_node + E;
  long long* S = (long long*)(smem + L.rows + align8(8LL * E));
  long long* G = S + (size_t)E * FR;
  long long* BL = G + (size_t)E * FR;
  long long* U = BL + (size_t)E * FR;
  const int win = L.win, n_win = (n_walk + win - 1) / win;
  const int w0 = L.stage, w1 = L.stage + L.stage_buf;  // the two windows' offsets
  // a path entry's row: its shared slot when the rows are staged, else its node
  auto node_ids = [](int, int, int node) { return node; };
  auto slot_of = [&](int r, int c, int node) {
    return shared_rows ? ent_slot[r * D1 + c] : node;
  };
  // window 0's operands (its path rows once the slots are known) beside
  // the path nodes of every walked head
  stage(a, walk, n_walk, 0, w0, cls, node_ids, tid, kThreads, !shared_rows);
  if (shared_rows) {
    for (int e = tid; e < E; e += kThreads) {
      const int r = e / D1, d = e - r * D1;
      ent_node[e] = __ldg(a.paths + (size_t)__ldg(a.cq_row + walk[r]) * D1 + d);
    }
    __syncthreads();
    // a node's slot: its first path entry (the rows of later entries of
    // the same node are never used)
    for (int e = tid; e < E; e += kThreads) {
      const int node = ent_node[e];
      int slot = node < 0 ? -1 : e;
      for (int f = 0; f < e && node >= 0; ++f) {
        if (ent_node[f] == node) {
          slot = f;
          break;
        }
      }
      ent_slot[e] = slot;
    }
    __syncthreads();
    for (int i = tid; i < E * FR; i += kThreads) {
      const int e = i / FR;
      if (ent_slot[e] != e) continue;
      const size_t x = (size_t)ent_node[e] * FR + (i - e * FR);
      S[i] = __ldg(a.subtree + x);
      G[i] = __ldg(a.guaranteed + x);
      BL[i] = __ldg(a.borrowing_limit + x);
      U[i] = a.usage[x];
    }
    int* lvl0 = window(w0, win, a.C, a.D).lvl;
    for (int i = tid; i < min(win, n_walk) * D1; i += kThreads) lvl0[i] = ent_slot[i];
  }
  __syncthreads();
  for (int wi = 0; wi < n_win; ++wi) {
    const int cur = (wi & 1) ? w1 : w0;
    if (warp == 0) {
      const int nr = min(win, n_walk - wi * win);
      if (shared_rows) walk_steps<true>(a, cur, nr, S, G, BL, U, lane);
      else walk_steps<false>(a, cur, nr, a.subtree, a.guaranteed, a.borrowing_limit, a.usage,
                             lane);
    } else if (wi + 1 < n_win) {
      stage(a, walk, n_walk, wi + 1, (wi & 1) ? w0 : w1, cls, slot_of, tid - 32,
            kThreads - 32);
    }
    __syncthreads();
  }
  if (shared_rows) {
    for (int i = tid; i < E * FR; i += kThreads) {
      const int e = i / FR;
      if (ent_slot[e] == e) a.usage[(size_t)ent_node[e] * FR + (i - e * FR)] = U[i];
    }
  }
}

// The block's shared-memory layout for these shapes; false when even
// one-head windows do not fit.
bool plan_layout(const Args& a, Layout* L) {
  const int base = 2 * align8(4LL * a.max_members) + align8(a.W);
  const int keys = 16 * a.W;
  int win = kWin;
  bool with_keys = base + keys + 2 * window_bytes(win, a.C, a.D) <= kSmemMax;
  if (!with_keys) {
    while (win > 1 && base + 2 * window_bytes(win, a.C, a.D) > kSmemMax) win >>= 1;
    if (base + 2 * window_bytes(win, a.C, a.D) > kSmemMax) return false;
  }
  int off = 0;
  L->prio = off;
  off += with_keys ? 8 * a.W : 0;
  L->ts = off;
  off += with_keys ? 8 * a.W : 0;
  L->win = win;
  L->keys = with_keys;
  L->stage = off;
  L->stage_buf = window_bytes(win, a.C, a.D);
  off += 2 * L->stage_buf;
  L->spos = off;
  off += align8(4LL * a.max_members);
  L->walk = off;
  off += align8(4LL * a.max_members);
  L->cls = off;
  off += align8(a.W);
  L->rows = off;
  // the largest segment walks at most max_members heads
  const long long need = align8(segment_bytes(a.max_members, a.FR, a.D));
  L->rows_bytes = (int)(need < kSmemMax - off ? need : kSmemMax - off);
  L->total = off + L->rows_bytes;
  return true;
}

template <bool kKeys>
int launch(const Args& a, cudaStream_t stream) {
  if (a.lay.total > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        phase2<kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.lay.total);
    if (rc != cudaSuccess) return (int)rc;
  }
  phase2<kKeys><<<a.n_seg + 1, kThreads, a.lay.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cycle2

// ints: W K C N FR D n_segments n_steps n_seg max_members; ptrs: the
// Args pointers in order. Returns cudaGetLastError()
// (cudaErrorInvalidValue on a bad argument list or a shape the kernel
// does not take).
extern "C" int cycle_phase2(const int* ints, int n_ints, void* const* p, int n_ptrs,
                            void* stream) {
  if (n_ints != 10 || n_ptrs != 19) return (int)cudaErrorInvalidValue;
  cycle2::Args a;
  a.W = ints[0]; a.K = ints[1]; a.C = ints[2]; a.N = ints[3]; a.FR = ints[4];
  a.D = ints[5]; a.n_segments = ints[6]; a.n_steps = ints[7]; a.n_seg = ints[8];
  a.max_members = ints[9];
  if (a.C > 32) return (int)cudaErrorInvalidValue;
  int i = 0;
  a.cq_row = (const int*)p[i++];
  a.cells = (const int*)p[i++];
  a.qty = (const long long*)p[i++];
  a.priority = (const long long*)p[i++];
  a.timestamp = (const long long*)p[i++];
  a.no_reclaim = (const uint8_t*)p[i++];
  a.chosen = (const int*)p[i++];
  a.borrows = (const uint8_t*)p[i++];
  a.preempt_k = (const int*)p[i++];
  a.seg_id = (const int*)p[i++];
  a.seg_offsets = (const int*)p[i++];
  a.seg_members = (const int*)p[i++];
  a.nominal = (const long long*)p[i++];
  a.borrowing_limit = (const long long*)p[i++];
  a.subtree = (const long long*)p[i++];
  a.guaranteed = (const long long*)p[i++];
  a.paths = (const int*)p[i++];
  a.usage = (long long*)p[i++];
  a.packed = (long long*)p[i++];
  if (a.W == 0) return (int)cudaGetLastError();
  if (!cycle2::plan_layout(a, &a.lay)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return a.lay.keys ? cycle2::launch<true>(a, s) : cycle2::launch<false>(a, s);
}
