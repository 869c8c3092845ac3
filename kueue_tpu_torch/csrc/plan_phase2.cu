// Kernel plan_phase2: phase 2 of the admission cycle under the
// planner's scenario axis (kernel B14, last of its three launches).
//
// Replaces the solve_cycle_segmented of kueue_tpu/ops/plan_kernel.py:36
// (_solve_scenarios under jax.vmap, packed at :59-76): per scenario the
// entry order (one jnp.lexsort over all W heads: no-fit last,
// non-borrowing first, priority desc, timestamp asc, index asc),
// segmented_rank and the lax.scan step loop against that scenario's
// quota state, priority and phase-1 outcome. It writes the packed
// int64[S, 6, W] per-head rows (chosen, admitted, borrows, reserved,
// order, preempt_k) and updates the usage tree [S, N, FR] in place.
//
// One C entry, two launches on the stream:
//   1. order_pass, one block of 1024 threads per scenario: each head's
//      class (no-fit, borrowing) into the `cls` scratch, then a
//      bottom-up merge sort of the head indices in global scratch,
//      each element placed by a binary search of the partner run
//      (log2 W passes). The keys with the index last are distinct, so
//      the order is jnp.lexsort's exactly. It writes the order row and
//      each head's position (`pos` scratch). The interactive cycle's
//      cycle_phase2 ranks by counting every head that orders before
//      (O(W) a head); at W = 65,536 and 129 scenarios that is ~5.5e11
//      comparisons, where the sort takes ~W (log W)^2 / 2 a scenario.
//   2. walk_pass, one block per (root segment, scenario) plus one per
//      scenario for the heads outside every segment (pads): each head's
//      chosen, borrow bit and preempt_k rows, admitted and reserved
//      zeroed; then a segment's walkable heads ranked by position and
//      walked by warp 0 in that order: cycle_phase2's body
//      (cycle_body::rank_members, walk_segment), with the scenario's
//      [N, FR] views at s*N*FR.
// Shared across scenarios: the heads' cells, qty, timestamp,
// no_reclaim and cq_row, seg_id and the segments' CSR, and the paths.
//
// What bounds it: the walk is sequential within a segment (each head
// sees its predecessors' admissions): ~heads a root x (D+1) levels x 2
// dependent round trips, in 129 x 50 blocks at planner-sweep-50k; the
// sort's binary searches are dependent loads too. Not bytes: the
// packed rows and usage are ~86 MB (~26 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cycle_body.cuh"

namespace plan2 {
namespace {

constexpr int kSortThreads = 1024;
constexpr int kWalkThreads = 128;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may take

struct Args {
  int S, W, K, C, N, FR, D, n_segments, n_steps, n_seg, max_members;
  const int* cq_row;          // [W]
  const int* cells;           // [W,K,C]
  const long long* qty;       // [W,K,C]
  const long long* priority;  // [S,W]
  const long long* timestamp; // [W]
  const uint8_t* no_reclaim;  // [W]
  const int* chosen;          // [S,W]
  const uint8_t* borrows;     // [S,W,K]
  const int* preempt_k;       // [S,W]
  const int* seg_id;          // [W]
  const int* seg_offsets;     // [n_seg+1]
  const int* seg_members;
  const long long* nominal;   // [S,N,FR]
  const long long* borrowing_limit;
  const long long* subtree;
  const long long* guaranteed;
  const int* paths;           // [N,D+1]
  long long* usage;           // [S,N,FR] the usage trees, updated
  long long* per_head;        // [S,6,W]
  uint8_t* cls;               // [S,W] scratch
  int* pos;                   // [S,W] scratch
  int* idx_a;                 // [S,W] scratch
  int* idx_b;                 // [S,W] scratch
};

__global__ void __launch_bounds__(kSortThreads) order_pass(Args a) {
  const int W = a.W;
  const size_t s = blockIdx.x, h = s * W;
  const int* chosen = a.chosen + h;
  const int* preempt_k = a.preempt_k + h;
  const uint8_t* borrows = a.borrows + h * a.K;
  const long long* prio = a.priority + h;
  const long long* ts = a.timestamp;
  uint8_t* cls = a.cls + h;
  int* src = a.idx_a + h;
  int* dst = a.idx_b + h;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    const int e = cycle_body::eff_k(chosen, preempt_k, j);
    cls[j] = e < 0 ? 2 : (borrows[(size_t)j * a.K + e] ? 1 : 0);
    src[j] = j;
  }
  __syncthreads();
  for (int width = 1; width < W; width <<= 1) {
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const int x = src[i];
      const uint8_t cx = cls[x];
      const long long px = prio[x], tx = ts[x];
      const int run = i / width;
      const int p = i - run * width;
      const int pbeg = (run ^ 1) * width;
      // how many of the partner run order before x (a prefix of it)
      int lo = 0, hi = pbeg < W ? min(width, W - pbeg) : 0;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int y = src[pbeg + mid];
        const uint8_t cy = cls[y];
        bool before;
        if (cy != cx) {
          before = cy < cx;
        } else {
          const long long py = prio[y];
          if (py != px) {
            before = py > px;
          } else {
            const long long ty = ts[y];
            before = ty != tx ? ty < tx : y < x;
          }
        }
        if (before) lo = mid + 1; else hi = mid;
      }
      dst[(run & ~1) * width + p + lo] = x;
    }
    __syncthreads();
    int* t = src; src = dst; dst = t;
  }
  long long* out_order = a.per_head + s * 6 * W + 4 * (size_t)W;
  int* pos = a.pos + h;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const int x = src[i];
    out_order[i] = x;
    pos[x] = i;
  }
}

__global__ void walk_pass(Args a) {
  extern __shared__ int smem[];
  int* spos = smem;
  int* walk = smem + a.max_members;
  __shared__ int n_valid;

  const int W = a.W;
  const int b = blockIdx.x;
  const size_t s = blockIdx.y, h = s * W, q = s * a.N * a.FR;
  const bool seg_block = b < a.n_seg;
  const uint8_t* cls = a.cls + h;
  const int* chosen = a.chosen + h;
  const int* preempt_k = a.preempt_k + h;
  const int* pos = a.pos + h;
  long long* ph = a.per_head + s * 6 * W;
  long long* out_chosen = ph;
  long long* out_admitted = ph + W;
  long long* out_borrows = ph + 2 * (size_t)W;
  long long* out_reserved = ph + 3 * (size_t)W;
  long long* out_preempt = ph + 5 * (size_t)W;
  if (threadIdx.x == 0) n_valid = 0;

  const int beg = seg_block ? a.seg_offsets[b] : 0;
  const int m = seg_block ? a.seg_offsets[b + 1] - beg : W;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const int x = seg_block ? a.seg_members[beg + i] : i;
    if (!seg_block && a.seg_id[x] >= 0) continue;  // a segment block's
    const uint8_t c = cls[x];
    out_chosen[x] = chosen[x];
    out_borrows[x] = c & 1;
    out_admitted[x] = 0;
    out_reserved[x] = 0;
    out_preempt[x] = preempt_k[x];
    if (seg_block) spos[i] = (c & 2) || a.cq_row[x] < 0 ? -1 : pos[x];
  }
  if (!seg_block || b >= a.n_segments) return;
  __syncthreads();

  cycle_body::rank_members(spos, m, a.seg_members + beg, a.n_steps, walk, &n_valid);
  __syncthreads();
  if (threadIdx.x >= 32) return;

  cycle_body::Phase2View v;
  v.K = a.K; v.C = a.C; v.FR = a.FR; v.D = a.D;
  v.cq_row = a.cq_row; v.cells = a.cells; v.qty = a.qty; v.no_reclaim = a.no_reclaim;
  v.chosen = chosen; v.preempt_k = preempt_k;
  v.nominal = a.nominal + q; v.borrowing_limit = a.borrowing_limit + q;
  v.subtree = a.subtree + q; v.guaranteed = a.guaranteed + q; v.paths = a.paths;
  v.usage = a.usage + q; v.out_admitted = out_admitted; v.out_reserved = out_reserved;
  cycle_body::walk_segment(v, walk, min(n_valid, a.n_steps), threadIdx.x,
                           [cls](int x) { return (cls[x] & 1) != 0; });
}

}  // namespace
}  // namespace plan2

// ints: S W K C N FR D n_segments n_steps n_seg max_members; ptrs: the
// Args pointers in order. Returns the first launch error
// (cudaErrorInvalidValue on a bad argument list or a shape the kernel
// does not take: C > 32, S > 65535, a segment too large for shared
// memory).
extern "C" int plan_phase2(const int* ints, int n_ints, void* const* p, int n_ptrs,
                           void* stream) {
  if (n_ints != 11 || n_ptrs != 23) return (int)cudaErrorInvalidValue;
  plan2::Args a;
  a.S = ints[0]; a.W = ints[1]; a.K = ints[2]; a.C = ints[3]; a.N = ints[4];
  a.FR = ints[5]; a.D = ints[6]; a.n_segments = ints[7]; a.n_steps = ints[8];
  a.n_seg = ints[9]; a.max_members = ints[10];
  if (a.C > 32 || a.S > 65535) return (int)cudaErrorInvalidValue;
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
  a.per_head = (long long*)p[i++];
  a.cls = (uint8_t*)p[i++];
  a.pos = (int*)p[i++];
  a.idx_a = (int*)p[i++];
  a.idx_b = (int*)p[i++];
  if (a.W == 0 || a.S == 0) return (int)cudaGetLastError();
  const size_t smem = 8 * (size_t)a.max_members;
  if (smem > plan2::kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        plan2::walk_pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  cudaStream_t st = (cudaStream_t)stream;
  plan2::order_pass<<<a.S, plan2::kSortThreads, 0, st>>>(a);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  plan2::walk_pass<<<dim3(a.n_seg + 1, a.S), plan2::kWalkThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
