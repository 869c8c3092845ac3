// Kernel B3', cycle_global: phase 2 of the unsegmented admission cycle.
//
// Replaces the phase-2 part of solve_cycle (kueue_tpu/ops/assign_kernel.py:343,
// the lax.scan at :446): the entry order (one jnp.lexsort over all W heads,
// :369-373) and ONE serial scan over every head in that order, with
// _avail_along_path (:282) and the usage bubble-up (_bubble_usage, :315).
// ShardedSolver (kueue_tpu_torch/parallel/sharded_solver.py) runs it on the
// gathered phase-1 output. It writes the packed int64[5, W] outcome (chosen,
// admitted, borrows, reserved, order) and updates the usage tree in place.
//
// A step reads and writes only the rows on its head's ancestor path, so
// heads under different root cohorts never see each other: walking each
// root's heads in the global order gives the scan's outcome. The grid is
// a block per group of whole root subtrees: quota_tree's bins (the forest
// packed breadth first, `Forest` in ops/quota.py), consecutive bins a
// group, so a group's nodes are one run of forest positions. Each block
//   1. stages every head's sort key in shared memory: its class (no-fit,
//      borrowing of its effective candidate), priority and timestamp, 17 B
//      a head (the priorities and timestamps stay in device memory when W
//      is too wide for them);
//   2. takes as its members the heads whose ClusterQueue lies in its
//      group, and the pads (cq_row < 0) of index b modulo the grid;
//      where W is too wide for the classes and member lists in shared
//      memory (beyond ~17,000 heads), they go to a device scratch: the
//      classes written once by a first launch (`classes`), each block's
//      member lists in a region of 3 x its member count claimed from a
//      counter once it has counted them (the regions tile 3 x W ints),
//      its position bits and their prefix in a region of its own; the
//      windows and rows take the shared memory;
//   3. gives each member its global position in the entry order (no-fit
//      last, non-borrowing first, priority desc, timestamp asc, head index
//      asc: the index is jnp.lexsort's stability), a warp a member, the
//      lanes counting the heads that order before it; writes order[pos],
//      chosen, borrows and zeroed admitted and reserved for it. Every slot
//      of the packed rows is written exactly once over the grid;
//   4. ranks its walkable members (not no-fit, cq_row >= 0) by position:
//      a bit a position, a prefix of the words' counts;
//   5. stages the group's subtree, guaranteed, borrowing-limit and usage
//      rows in shared memory by forest position (a group whose rows do not
//      fit walks on the device-memory rows, chosen here from its size);
//   6. walks them as cycle_phase2 does (cycle_walk.cuh): warp 0 walks a
//      staged window while warps 1-15 stage the next; there is no n_steps
//      cap (solve_cycle walks every head);
//   7. writes the group's usage rows back. Groups hold disjoint rows, so
//      blocks need no atomics between them.
//
// What bounds it: the walk is sequential within a root cohort (each head
// sees its predecessors' admissions): two dependent shared-memory trips a
// walked head over the longest root's heads, ~0.6 us at the headline; the
// bytes bound (chip_smoke.py counts it from the inputs) is below it. The
// positions are an O(W) count a head, spread over the grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cycle_walk.cuh"

namespace cycle2 {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 2;  // heads a thread stages a round
constexpr int kSmemMax = 232448 - 1024;  // a block's opt-in shared memory (sm_90),
                                          // less room for the static counters

// Byte offsets of the dynamic shared memory (multiples of 8), planned by
// the wrapper (ops/assign_kernel.global_layout).
struct Layout {
  int prio, ts;      // int64[W] each, when the keys are staged
  int stage;         // two staging windows of `win` heads
  int stage_buf;     // bytes of one window
  int cls;           // uint8[W]
  int mem;           // the member lists: members, positions, walk, position bits
  int rows;          // the group's rows, `rows_bytes` of them
  int rows_bytes;
  int win;
  int keys;          // 1 when the priorities and timestamps are staged, 2 when
                     // the classes and member lists are in the device scratch
  int total;
};

struct Args {
  int W, K, C, N, FR, D, n_bins, bins_stride;
  const int* cq_row;          // [W]
  const int* cells;           // [W,K,C]
  const long long* qty;       // [W,K,C]
  const long long* priority;  // [W]
  const long long* timestamp; // [W]
  const uint8_t* no_reclaim;  // [W]
  const int* chosen;          // [W]
  const uint8_t* borrows;     // [W,K]
  const int* preempt_k;       // [W]
  const long long* nominal;   // [N,FR]
  const long long* borrowing_limit;
  const long long* subtree;
  const long long* guaranteed;
  const int* paths;           // [N,D+1]
  const int* pos_of;          // [N] the node's forest position
  const int* meta;            // [N,4] the position's node at [p*4]
  const int* bins;            // [n_bins, bins_stride]: a bin's level starts, its end last
  long long* usage;           // [N,FR] the cycle usage tree, updated
  long long* packed;          // [5,W]
  int* scratch;               // keys == 2: the counter, the member lists [3W], the
                              // blocks' position bits [grid, 2 ceil(W/32)], the classes
  Layout lay;
};

// The device scratch of the wide layout (keys == 2), in ints.
__host__ __device__ inline size_t scratch_lists(const Args&) { return 1; }
__host__ __device__ inline size_t scratch_bits(const Args& a) { return 1 + 3 * (size_t)a.W; }
__host__ __device__ inline size_t scratch_cls(const Args& a, int grid) {
  return scratch_bits(a) + (size_t)grid * 2 * ((a.W + 31) / 32);
}

// The wide layout's first launch: every head's class, once, and the
// member-list counter zeroed.
__global__ void classes(Args a, int grid) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  uint8_t* cls = (uint8_t*)(a.scratch + scratch_cls(a, grid));
  if (j == 0) a.scratch[0] = 0;
  if (j >= a.W) return;
  const int ch = __ldg(a.chosen + j), pk = __ldg(a.preempt_k + j);
  const int e = ch >= 0 ? ch : pk;
  cls[j] = e < 0 ? 2 : (__ldg(a.borrows + (size_t)j * a.K + e) ? 1 : 0);
}

template <bool kKeys, bool kDev>
__global__ void __launch_bounds__(kThreads) walk_roots(Args a) {
  const Layout& L = a.lay;
  long long* prio = (long long*)(smem + L.prio);
  long long* ts = (long long*)(smem + L.ts);
  const int W = a.W, nw = (W + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x, G = gridDim.x;
  uint8_t* cls = kDev ? (uint8_t*)(a.scratch + scratch_cls(a, G)) : smem + L.cls;
  int* mem = (int*)(smem + L.mem);
  int* members = mem;
  int* spos = members + W;
  int* walk = spos + W;
  unsigned* bits = kDev ? (unsigned*)(a.scratch + scratch_bits(a) + (size_t)b * 2 * nw)
                        : (unsigned*)(walk + W);
  int* pre = (int*)(bits + nw);
  __shared__ int n_mem, n_walk_s, m_base;

  // the group's bins and its run of forest positions
  const int lo = (int)((long long)b * a.n_bins / G);
  const int hi = (int)((long long)(b + 1) * a.n_bins / G);
  const int p_lo = __ldg(a.bins + (size_t)lo * a.bins_stride);
  const int p_hi = __ldg(a.bins + (size_t)(hi - 1) * a.bins_stride + a.bins_stride - 1);

  // a thread's heads j = tid + i * kThreads, kStage at a time: every
  // load of a round issued before the round's dependent borrow bits
  for (int base = 0; base < (kDev ? 0 : W); base += kStage * kThreads) {
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
  for (int i = tid; i < nw; i += kThreads) bits[i] = 0;
  if (tid == 0) n_mem = 0;
  __syncthreads();

  // the members, appended a warp at a time (in the wide layout counted
  // first, then appended to the region claimed for them)
  auto is_member = [&](int x) {
    if (x >= W) return false;
    const int cq = __ldg(a.cq_row + x);
    if (cq < 0) return x % G == b;
    const int p = __ldg(a.pos_of + cq);
    return p >= p_lo && p < p_hi;
  };
  if (kDev) {
    for (int base = 0; base < W; base += kThreads) {
      const unsigned hit = __ballot_sync(kFull, is_member(base + tid));
      if (lane == 0 && hit) atomicAdd(&n_mem, __popc(hit));
    }
    __syncthreads();
    if (tid == 0) {
      m_base = n_mem ? atomicAdd(a.scratch, n_mem) : 0;
      n_mem = 0;
    }
    __syncthreads();
    members = a.scratch + scratch_lists(a) + m_base;
    spos = members + W;
    walk = spos + W;
  }
  for (int base = 0; base < W; base += kThreads) {
    const int x = base + tid;
    const bool mine = is_member(x);
    const unsigned hit = __ballot_sync(kFull, mine);
    int first = 0;
    if (lane == 0 && hit) first = atomicAdd(&n_mem, __popc(hit));
    first = __shfl_sync(kFull, first, 0);
    if (mine) members[first + __popc(hit & ((1u << lane) - 1))] = x;
  }
  __syncthreads();
  const int m = n_mem;
  if (m == 0) return;

  // positions, a warp a member
  long long* out_chosen = a.packed;
  long long* out_admitted = a.packed + W;
  long long* out_borrows = a.packed + 2 * (size_t)W;
  long long* out_reserved = a.packed + 3 * (size_t)W;
  long long* out_order = a.packed + 4 * (size_t)W;
  for (int i = warp; i < m; i += kWarps) {
    const int x = members[i];
    const int pos = position<kKeys>(a, cls, prio, ts, x, lane);
    if (lane == 0) {
      out_order[pos] = x;
      out_chosen[x] = a.chosen[x];
      out_borrows[x] = cls[x] & 1;
      out_admitted[x] = 0;
      out_reserved[x] = 0;
      const bool walkable = !(cls[x] & 2) && a.cq_row[x] >= 0;
      spos[i] = walkable ? pos : -1;
      if (walkable) atomicOr(bits + (pos >> 5), 1u << (pos & 31));
    }
  }
  __syncthreads();

  // ranks: the walkable members' positions below each one
  if (warp == 0) {
    int carry = 0;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int c = w0 + lane < nw ? __popc(bits[w0 + lane]) : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (w0 + lane < nw) pre[w0 + lane] = carry + incl - c;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) n_walk_s = carry;
  }
  __syncthreads();
  for (int i = tid; i < m; i += kThreads) {
    const int p = spos[i];
    if (p < 0) continue;
    walk[pre[p >> 5] + __popc(bits[p >> 5] & ((1u << (p & 31)) - 1))] = members[i];
  }
  __syncthreads();
  const int n_walk = n_walk_s;
  if (n_walk == 0) return;

  // the group's rows, by forest position, when they fit
  const int FR = a.FR, nb = p_hi - p_lo;
  const bool shared_rows = (long long)nb * FR * 32 <= L.rows_bytes;
  long long* S = (long long*)(smem + L.rows);
  long long* Gr = S + (size_t)nb * FR;
  long long* BL = Gr + (size_t)nb * FR;
  long long* U = BL + (size_t)nb * FR;
  const int win = L.win, n_win = (n_walk + win - 1) / win;
  const int w0 = L.stage, w1 = L.stage + L.stage_buf;  // the two windows' offsets
  // a path entry's row: its slot among the group's positions when the
  // rows are staged, else its node
  const int* pos_of = a.pos_of;
  auto slot_of = [=](int, int, int node) {
    return node < 0 || !shared_rows ? node : __ldg(pos_of + node) - p_lo;
  };
  stage(a, walk, n_walk, 0, w0, cls, slot_of, tid, kThreads);
  if (shared_rows) {
    for (int i = tid; i < nb * FR; i += kThreads) {
      const int r = i / FR;
      const size_t x = (size_t)__ldg(a.meta + (size_t)(p_lo + r) * 4) * FR + (i - r * FR);
      S[i] = __ldg(a.subtree + x);
      Gr[i] = __ldg(a.guaranteed + x);
      BL[i] = __ldg(a.borrowing_limit + x);
      U[i] = a.usage[x];
    }
  }
  __syncthreads();
  for (int wi = 0; wi < n_win; ++wi) {
    const int cur = (wi & 1) ? w1 : w0;
    if (warp == 0) {
      const int nr = min(win, n_walk - wi * win);
      if (shared_rows) walk_steps<true>(a, cur, nr, S, Gr, BL, U, lane);
      else walk_steps<false>(a, cur, nr, a.subtree, a.guaranteed, a.borrowing_limit, a.usage,
                             lane);
    } else if (wi + 1 < n_win) {
      stage(a, walk, n_walk, wi + 1, (wi & 1) ? w0 : w1, cls, slot_of, tid - 32,
            kThreads - 32);
    }
    __syncthreads();
  }
  if (shared_rows) {
    for (int i = tid; i < nb * FR; i += kThreads) {
      const int r = i / FR;
      a.usage[(size_t)__ldg(a.meta + (size_t)(p_lo + r) * 4) * FR + (i - r * FR)] = U[i];
    }
  }
}

template <bool kKeys, bool kDev>
int launch(const Args& a, int grid, cudaStream_t stream) {
  if (a.lay.total > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        walk_roots<kKeys, kDev>, cudaFuncAttributeMaxDynamicSharedMemorySize, a.lay.total);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (kDev) classes<<<(a.W + 255) / 256, 256, 0, stream>>>(a, grid);
  walk_roots<kKeys, kDev><<<grid, kThreads, a.lay.total, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace cycle2

// ints: W K C N FR D n_bins bins_stride grid, then the layout (prio ts
// stage stage_buf cls mem rows rows_bytes win keys total); ptrs: the Args
// pointers in order, the scratch last (NULL unless keys == 2: then
// 1 + 3W + grid * 2 * ceil(W/32) + ceil(W/4) ints). Returns
// cudaGetLastError() (cudaErrorInvalidValue on a bad argument list,
// C > 32, a layout beyond a block's shared memory or a missing scratch).
extern "C" int cycle_global(const int* ints, int n_ints, void* const* p, int n_ptrs,
                            void* stream) {
  if (n_ints != 20 || n_ptrs != 20) return (int)cudaErrorInvalidValue;
  cycle2::Args a;
  a.W = ints[0]; a.K = ints[1]; a.C = ints[2]; a.N = ints[3]; a.FR = ints[4];
  a.D = ints[5]; a.n_bins = ints[6]; a.bins_stride = ints[7];
  const int grid = ints[8];
  cycle2::Layout& L = a.lay;
  L.prio = ints[9]; L.ts = ints[10]; L.stage = ints[11]; L.stage_buf = ints[12];
  L.cls = ints[13]; L.mem = ints[14]; L.rows = ints[15]; L.rows_bytes = ints[16];
  L.win = ints[17]; L.keys = ints[18]; L.total = ints[19];
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
  a.nominal = (const long long*)p[i++];
  a.borrowing_limit = (const long long*)p[i++];
  a.subtree = (const long long*)p[i++];
  a.guaranteed = (const long long*)p[i++];
  a.paths = (const int*)p[i++];
  a.pos_of = (const int*)p[i++];
  a.meta = (const int*)p[i++];
  a.bins = (const int*)p[i++];
  a.usage = (long long*)p[i++];
  a.packed = (long long*)p[i++];
  a.scratch = (int*)p[i++];
  if (a.W == 0) return (int)cudaGetLastError();
  if (a.C > 32 || grid < 1 || grid > a.n_bins || L.total > cycle2::kSmemMax || L.win < 1 ||
      L.keys < 0 || L.keys > 2 || (L.keys == 2 && a.scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (L.keys == 2) return cycle2::launch<false, true>(a, grid, s);
  return L.keys ? cycle2::launch<true, false>(a, grid, s)
                : cycle2::launch<false, false>(a, grid, s);
}
