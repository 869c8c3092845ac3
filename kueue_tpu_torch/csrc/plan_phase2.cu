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
// The timestamps are shared by every scenario, and a quota sweep's
// scenarios share one priority row too: only a priority delta or a
// policy changes it. So the order is (priority desc, timestamp asc,
// index asc) sorted once for each distinct priority row, and each
// scenario's order is that base order stably partitioned by the head's
// class (0 fits without borrowing, 1 borrows, 2 no fit): the class is
// the lexsort's first two keys. One C entry, on the stream:
//   1. classify, a thread a (scenario, head): the class into the `cls`
//      scratch; the packed rows chosen, borrows, preempt_k, and admitted
//      and reserved zeroed; per scenario the counts of classes 0 and 1
//      and whether its priority row differs from scenario 0's.
//   2. sort_tiles and log2(W / tile) merge passes, only for scenario 0
//      and the scenarios whose row differs (the others' blocks return):
//      tiles of up to 2048 heads sorted in shared memory by a bitonic
//      network over staged keys; each merge pass a block an output tile,
//      its two input ranges found by a merge-path search a warp does
//      32 probes at a time, then staged with their keys and merged in
//      shared memory. Keys with the index last are distinct, so the
//      order is the lexsort's exactly.
//   3. partition, a block a scenario: the base order (its own or
//      scenario 0's) read in chunks, each head's class from the staged
//      `cls` row, warp ballots and a block prefix per class: the order
//      row, and each base position's place in it (`pos` scratch, written
//      in base order); a scenario that sorted its row also writes each
//      head's base position.
//   4. walk_lists, a block a (root segment, scenario): the segment's
//      walkable members (not no-fit, a ClusterQueue) marked at their
//      places in a bitmap of the scenario's order, a prefix of the
//      words' counts their ranks, ranks >= n_steps dropped: its walk
//      list, into the sort's free buffer, and its length.
//   5. walk, a warp a (root segment, scenario), many to an SM: the
//      nodes on the walked heads' paths numbered by a bitmap of tree rows
//      and its prefix; their subtree, guaranteed, borrowing-limit and
//      usage rows staged (device rows where they exceed the block's
//      room); then windows of heads staged and walked with cycle_walk.cuh
//      (stage, walk_steps), the walk B3 and B3' share, through a view of
//      the scenario's arrays.
// Where W fits one tile, steps 1-4 are one launch, order_small: a block
// a scenario sorts its own row, classifies, partitions and makes every
// segment's walk list, counting each (segment, class) with warp matches
// over the order (the launches and the cross-block counts cost more than
// 129 small sorts; at planner-sweep-50k the matches, a round a distinct
// key, cost more than the lists' bitmaps).
// Shared across scenarios: the heads' cells, qty, timestamp,
// no_reclaim and cq_row, seg_id and the segments' CSR, and the paths.
//
// What bounds it: the walk is sequential within a (segment, scenario)
// (each head sees its predecessors' admissions): two dependent
// shared-memory trips a walked head over the longest walk; its 129 x 50
// walks at planner-sweep-50k run side by side. The packed rows and the
// usage trees are ~86 MB at planner-sweep-50k (~26 us at 3.35 TB/s).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cycle_body.cuh"
#include "cycle_walk.cuh"

namespace plan2 {
namespace {

using cycle2::smem;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kClassThreads = 256;
constexpr int kTile = 2048;          // heads a sorted tile and a merge block's output
constexpr int kSortThreads = 1024;   // a tile's bitonic network, a pair a thread a stage
constexpr int kMergeThreads = 512;
constexpr int kPartThreads = 1024;
constexpr int kListThreads = 128;
constexpr int kSmemMax = 232448 - 1024;     // a block's opt-in shared memory, less the static part
constexpr int kWalkBudget = 232448 / 14;    // a walk block's room: 14 blocks an SM (its
                                            // rows staged beyond it go to device rows)
constexpr int kMaxClsStaged = 196608;       // heads whose classes a partition block stages
constexpr int kListBlocks = 264;            // blocks of the device-memory walk lists

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
  int* pos;                   // [S,W] scratch: each base position's place in the
                              // scenario's order
  int* idx_a;                 // [S,W] scratch: the sort's two buffers (then the walk lists)
  int* idx_b;
  int* ctl;                   // [S,4] scratch, zeroed: differs, class-0 count, class-1 count
  int* n_walk;                // [S,n_seg] scratch: each walk's heads
  unsigned* list_bits;        // [grid, 2 ceil(W/32)] scratch of the device-memory walk
                              // lists (NULL where their bitmap or positions fit a block)
};

// A walk block's shared memory (byte offsets, multiples of 16), planned
// by the host.
struct WalkLayout {
  int bits, pre, nw;  // uint32[nw] each: the path nodes' bitmap and its prefix
  int nodes, rows;    // int32[cap] slot -> node; int64[4][cap][FR]
  int cap;            // slots the rows have room for (0: device rows)
  int window, win;    // cycle_walk.cuh's window: its offset and heads
  int total;
};

// The scenario's arrays as cycle_walk.cuh reads them.
struct View {
  int W, K, C, FR, D;
  const int* cq_row;
  const int* cells;
  const long long* qty;
  const uint8_t* no_reclaim;
  const int* chosen;
  const int* preempt_k;
  const long long* nominal;
  const long long* borrowing_limit;
  const int* paths;
  long long* packed;
  struct { int win; } lay;
};

__host__ __device__ inline int align16(long long b) { return (int)((b + 15) & ~15LL); }

// ---- 1. classify -------------------------------------------------------

// Head j of scenario s: its class (0 fits without borrowing, 1 borrows,
// 2 no fit) into `cls`, and its packed rows chosen, borrows, preempt_k,
// admitted and reserved (0).
__device__ __forceinline__ int classify_head(const Args& a, size_t s, int j) {
  const int W = a.W;
  const size_t h = s * W;
  const int ch = a.chosen[h + j], pk = a.preempt_k[h + j];
  const int e = ch >= 0 ? ch : pk;
  const bool b = e >= 0 && a.borrows[(h + j) * a.K + e];
  const int c = e < 0 ? 2 : (b ? 1 : 0);
  a.cls[h + j] = (uint8_t)c;
  long long* ph = a.per_head + s * 6 * W;
  ph[j] = ch;
  ph[W + j] = 0;
  ph[2 * (size_t)W + j] = b;
  ph[3 * (size_t)W + j] = 0;
  ph[5 * (size_t)W + j] = pk;
  return c;
}

__global__ void __launch_bounds__(kClassThreads) classify(Args a) {
  const int W = a.W, j = blockIdx.x * kClassThreads + threadIdx.x;
  const size_t s = blockIdx.y, h = s * W;
  int c = 3;
  bool differs = false;
  if (j < W) {
    c = classify_head(a, s, j);
    differs = s > 0 && a.priority[h + j] != a.priority[j];
  }
  const int n0 = __syncthreads_count(c == 0);
  const int n1 = __syncthreads_count(c == 1);
  const int d = __syncthreads_or(differs);
  if (threadIdx.x == 0) {
    int* ctl = a.ctl + s * 4;
    if (d) atomicOr(ctl, 1);
    if (n0) atomicAdd(ctl + 1, n0);
    if (n1) atomicAdd(ctl + 2, n1);
  }
}

// ---- 2. the sort of a priority row ------------------------------------

__device__ __forceinline__ bool sorts(const Args& a, int s) {
  return s == 0 || a.ctl[s * 4] != 0;
}

// x orders before y: priority desc, timestamp asc, index asc; indices
// >= W are pads, after every head
__device__ __forceinline__ bool before(long long px, long long tx, int ix, long long py,
                                       long long ty, int iy, int W) {
  if (ix >= W || iy >= W) return ix < iy;
  return (px > py) | ((px == py) & ((tx < ty) | ((tx == ty) & (ix < iy))));
}

// Heads t0 .. t0 + tile of scenario s's priority row sorted in shared
// memory (kp, kt, ki: priorities, timestamps, indices) by a bitonic
// network, the block's threads a pair each a stage; pads past W last.
__device__ void sort_tile(const Args& a, int s, int t0, int tile, long long* kp, long long* kt,
                          int* ki) {
  const int W = a.W, nt = blockDim.x;
  const long long* prio = a.priority + (size_t)s * W;
  for (int i = threadIdx.x; i < tile; i += nt) {
    const int j = t0 + i;
    ki[i] = j;
    kp[i] = j < W ? prio[j] : 0;
    kt[i] = j < W ? a.timestamp[j] : 0;
  }
  __syncthreads();
  for (int k = 2; k <= tile; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      for (int t = threadIdx.x; t < tile / 2; t += nt) {
        const int i = 2 * jj * (t / jj) + (t % jj), l = i + jj;
        const bool lb = before(kp[l], kt[l], ki[l], kp[i], kt[i], ki[i], W);
        if ((i & k) == 0 ? lb : !lb) {
          const long long p = kp[i], tt = kt[i];
          const int x = ki[i];
          kp[i] = kp[l];
          kt[i] = kt[l];
          ki[i] = ki[l];
          kp[l] = p;
          kt[l] = tt;
          ki[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kSortThreads) sort_tiles(Args a, int* dst, int tile) {
  const int s = blockIdx.y, t0 = blockIdx.x * tile, W = a.W;
  if (!sorts(a, s)) return;
  long long* kp = (long long*)smem;
  long long* kt = kp + tile;
  int* ki = (int*)(kt + tile);
  sort_tile(a, s, t0, tile, kp, kt, ki);
  int* out = dst + (size_t)s * W;
  for (int i = threadIdx.x; i < tile && t0 + i < W; i += blockDim.x) out[t0 + i] = ki[i];
}

// How many of A's heads are among the first `diag` of merge(A, B): a
// warp's search, 32 probes a round (the probes' answers are a prefix).
__device__ int merge_path(const int* A, int na, const int* B, int nb, int diag,
                          const long long* prio, const long long* ts, int W, int lane) {
  int lo = max(0, diag - nb), hi = min(diag, na);
  while (hi > lo) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + lane * step;
    bool pred = false;
    if (p < hi) {
      const int x = A[p], y = B[diag - 1 - p];
      pred = before(prio[x], ts[x], x, prio[y], ts[y], y, W);
    }
    const int c = __popc(__ballot_sync(kFull, pred));
    const int nlo = c > 0 ? lo + (c - 1) * step + 1 : lo;
    hi = min(hi, lo + c * step);
    lo = nlo;
  }
  return lo;
}

__global__ void __launch_bounds__(kMergeThreads) merge(Args a, const int* src, int* dst,
                                                       int width, int tile) {
  const int s = blockIdx.y;
  if (!sorts(a, s)) return;
  __shared__ int cut[2];
  long long* kp = (long long*)smem;
  long long* kt = kp + tile;
  int* ki = (int*)(kt + tile);
  const int W = a.W, t0 = blockIdx.x * tile;
  const long long* prio = a.priority + (size_t)s * W;
  const long long* ts = a.timestamp;
  const int* row = src + (size_t)s * W;
  const int pb = t0 / (2 * width) * (2 * width);  // the pair's first head
  const int a_end = min(pb + width, W), b_end = min(pb + 2 * width, W);
  const int na = a_end - pb, nb = b_end - a_end;
  const int o0 = t0 - pb, o1 = min(o0 + tile, na + nb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int c = merge_path(row + pb, na, row + a_end, nb, warp ? o1 : o0, prio, ts, W, lane);
    if (lane == 0) cut[warp] = c;
  }
  __syncthreads();
  const int a0 = cut[0], a1 = cut[1], b0 = o0 - a0, b1 = o1 - a1;
  const int ma = a1 - a0, mb = b1 - b0;
  for (int i = threadIdx.x; i < ma + mb; i += kMergeThreads) {
    const int x = i < ma ? row[pb + a0 + i] : row[a_end + b0 + i - ma];
    ki[i] = x;
    kp[i] = prio[x];
    kt[i] = ts[x];
  }
  __syncthreads();
  int* out = dst + (size_t)s * W + t0;
  for (int i = threadIdx.x; i < ma + mb; i += kMergeThreads) {
    const long long px = kp[i], tx = kt[i];
    const int x = ki[i];
    // the other part's heads that order before this one
    const bool in_a = i < ma;
    int lo = in_a ? ma : 0, hi = in_a ? ma + mb : ma;
    const int base = lo;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(kp[mid], kt[mid], ki[mid], px, tx, x, W)) lo = mid + 1; else hi = mid;
    }
    out[(in_a ? i : i - ma) + lo - base] = x;
  }
}

// ---- 3. the partition by class, and the walk's ranks ------------------

// The scenario's order row, and the position in it of the head at each
// base position (`pmap`, written in base order): the base order stably
// partitioned by class, in chunks of two heads a thread (a warp's 64 in
// order), warp ballots and a prefix over the warps per class; class 1
// starts at n0, class 2 at n0 + n1.
__device__ void partition_body(const Args& a, const int* base, const uint8_t* cls, long long* out,
                               int* pmap, int n0, int n1) {
  __shared__ int wc[32][3];
  __shared__ int tot[3];
  const int W = a.W, nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5, chunk = 2 * nt;
  const unsigned lt = (1u << lane) - 1;
  int run[3] = {0, n0, n0 + n1};
  for (int c0 = 0; c0 < W; c0 += chunk) {
    const int i = c0 + 64 * warp + lane;
    const int xa = i < W ? base[i] : 0, xb = i + 32 < W ? base[i + 32] : 0;
    const int ca = i < W ? cls[xa] : 3, cb = i + 32 < W ? cls[xb] : 3;
    unsigned ma[3], mb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      ma[k] = __ballot_sync(kFull, ca == k);
      mb[k] = __ballot_sync(kFull, cb == k);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) wc[warp][k] = __popc(ma[k]) + __popc(mb[k]);
    }
    __syncthreads();
    if (warp == 0) {  // an exclusive prefix over the warps, a lane a warp
      for (int k = 0; k < 3; ++k) {
        const int v = lane < nwarps ? wc[lane][k] : 0;
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += y;
        }
        if (lane < nwarps) wc[lane][k] = incl - v;
        if (lane == 31) tot[k] = incl;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int at = run[k] + wc[warp][k];
      if (ca == k) {
        const int p = at + __popc(ma[k] & lt);
        out[p] = xa;
        pmap[i] = p;
      }
      if (cb == k) {
        const int p = at + __popc(ma[k]) + __popc(mb[k] & lt);
        out[p] = xb;
        pmap[i + 32] = p;
      }
      run[k] += tot[k];
    }
    __syncthreads();  // wc and tot are rewritten
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kPartThreads) partition(Args a, const int* sorted, int* bpos) {
  uint8_t* cls_s = smem;
  const int W = a.W, s = blockIdx.x;
  const uint8_t* cls_g = a.cls + (size_t)s * W;
  if (kStaged) {
    for (int j = threadIdx.x; j < W; j += blockDim.x) cls_s[j] = cls_g[j];
    __syncthreads();
  }
  const uint8_t* cls = kStaged ? cls_s : cls_g;
  const bool own = sorts(a, s);
  const int* base = sorted + (size_t)(own ? s : 0) * W;
  partition_body(a, base, cls, a.per_head + (size_t)s * 6 * W + 4 * (size_t)W,
                 a.pos + (size_t)s * W, a.ctl[s * 4 + 1], a.ctl[s * 4 + 2]);
  if (own) {  // each head's base position, once a sorted row
    for (int i = threadIdx.x; i < W; i += blockDim.x) bpos[(size_t)s * W + base[i]] = i;
  }
}

// The walk lists of a scenario whose order is staged (`order`, W heads),
// all its segments at once: each walked head's key (2 x its segment + its
// class, -1 if not walked: `key`), counted over warp slices of the order
// with warp matches, a prefix over the slices, then counted again, each
// head taking its slice's offset plus the heads of its key before it,
// after its segment's heads of class 0 when it borrows; ranks >= n_steps
// dropped. `tab`: [nw warps][2 x n_seg] counts; `tot`: [2 x n_seg].
// Matches cost a round a distinct key, so this serves a W of one tile.
__device__ void small_lists(const Args& a, size_t s, const int* order, const int* key, int* tab,
                            int* tot, int nw, int* lists) {
  const int W = a.W, K2 = 2 * a.n_seg, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < nw * K2; i += blockDim.x) tab[i] = 0;
  __syncthreads();
  const int span = ((W + nw - 1) / nw + 31) / 32 * 32;
  const int lo = warp * span, hi = min(lo + span, W);
  int* row = tab + (size_t)warp * K2;
  for (int pass = 0; pass < 2; ++pass) {
    if (warp < nw) {
      for (int i0 = lo; i0 < hi; i0 += 32) {
        const int i = i0 + lane;
        const int x = i < hi ? order[i] : 0;
        const int k = i < hi ? key[x] : -1;
        const unsigned peers = __match_any_sync(kFull, k);
        if (pass == 1 && k >= 0) {
          const int r = row[k] + __popc(peers & ((1u << lane) - 1)) + ((k & 1) ? tot[k - 1] : 0);
          if (r < a.n_steps) lists[s * W + a.seg_offsets[k >> 1] + r] = x;
        }
        __syncwarp();
        if (k >= 0 && __ffs(peers) - 1 == lane) row[k] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();
    if (pass == 0) {  // each key's count over the slices before, and its total
      for (int k = tid; k < K2; k += blockDim.x) {
        int run = 0;
        for (int w = 0; w < nw; ++w) {
          const int v = tab[(size_t)w * K2 + k];
          tab[(size_t)w * K2 + k] = run;
          run += v;
        }
        tot[k] = run;
      }
      __syncthreads();
      for (int g = tid; g < a.n_seg; g += blockDim.x) {
        a.n_walk[s * a.n_seg + g] = min(tot[2 * g] + tot[2 * g + 1], a.n_steps);
      }
    }
  }
}

// The order of a W that fits one tile, all in one block a scenario: its
// own row sorted (no row shared), its heads classified and counted, the
// partition and the walk lists.
__global__ void __launch_bounds__(kSortThreads) order_small(Args a, int tile, int nw, int* lists) {
  __shared__ int cnt[2];
  const int W = a.W, s = blockIdx.x;
  long long* kp = (long long*)smem;
  long long* kt = kp + tile;
  int* ki = (int*)(kt + tile);
  int* key = ki + tile;
  int* tot = key + W;
  uint8_t* cls = (uint8_t*)(tot + 2 * a.n_seg);
  int* tab = (int*)(smem + align16(20LL * tile + 4LL * W + 8LL * a.n_seg + W));
  if (threadIdx.x < 2) cnt[threadIdx.x] = 0;
  __syncthreads();
  for (int j0 = 0; j0 < W; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const int c = j < W ? classify_head(a, s, j) : 3;
    if (j < W) {
      const int g = a.seg_id[j];
      cls[j] = (uint8_t)c;
      key[j] = c < 2 && g >= 0 && a.cq_row[j] >= 0 ? 2 * g + c : -1;
    }
    const int n0 = __syncthreads_count(c == 0);
    const int n1 = __syncthreads_count(c == 1);
    if (threadIdx.x == 0) {
      cnt[0] += n0;
      cnt[1] += n1;
    }
  }
  sort_tile(a, s, 0, tile, kp, kt, ki);  // its barriers publish cls and cnt
  partition_body(a, ki, cls, a.per_head + (size_t)s * 6 * W + 4 * (size_t)W,
                 a.pos + (size_t)s * W, cnt[0], cnt[1]);
  small_lists(a, s, ki, key, tab, tot, nw, lists);
}

// The walk list of a (root segment, scenario): its walkable members
// (not no-fit, a ClusterQueue), each at its position in the scenario's
// order (pmap at its base position), ranked by a bitmap of those
// positions (`bits`, nw words) and an exclusive prefix of the words'
// counts (`pre`), ranks >= n_steps dropped; the heads into `list`. A
// thread takes kUnroll members a round, their gathers in flight together.
// Returns the walk's length. All the block's threads call it; `wsum`: 33
// ints of shared scratch.
__device__ int build_list(const Args& a, size_t s, int g, const int* bpos, int* list,
                          unsigned* bits, int* pre, int nw, int* wsum) {
  constexpr int kUnroll = 8;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const size_t h = s * a.W;
  const uint8_t* cls = a.cls + h;
  const int* pmap = a.pos + h;
  const int beg = a.seg_offsets[g], m = a.seg_offsets[g + 1] - beg;
  const int* members = a.seg_members + beg;
  for (int w = tid; w < nw; w += nt) bits[w] = 0;
  __syncthreads();
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1) {  // an exclusive prefix of the words' counts, a run a thread
      const int per = (nw + nt - 1) / nt, lo = min(tid * per, nw), hi = min(lo + per, nw);
      int mine = 0;
      for (int w = lo; w < hi; ++w) mine += __popc(bits[w]);
      int incl = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) wsum[warp] = incl;
      __syncthreads();
      if (warp == 0) {
        const int v = lane < nt / 32 ? wsum[lane] : 0;
        int inc2 = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, inc2, o);
          if (lane >= o) inc2 += y;
        }
        wsum[lane] = inc2 - v;
        if (lane == 31) wsum[32] = inc2;  // every walkable member
      }
      __syncthreads();
      int run = wsum[warp] + incl - mine;
      for (int w = lo; w < hi; ++w) {
        pre[w] = run;
        run += __popc(bits[w]);
      }
      __syncthreads();
    }
    for (int i0 = tid; i0 < m; i0 += nt * kUnroll) {
      int x[kUnroll], b[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * nt;
        ok[u] = i < m;
        x[u] = ok[u] ? members[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = cls[x[u]], cq = a.cq_row[x[u]];
        b[u] = bpos[x[u]];
        ok[u] = ok[u] && c < 2 && cq >= 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        const int p = pmap[b[u]];
        if (pass == 0) {
          atomicOr(bits + (p >> 5), 1u << (p & 31));
          continue;
        }
        const int r = pre[p >> 5] + __popc(bits[p >> 5] & ((1u << (p & 31)) - 1));
        if (r < a.n_steps) list[beg + r] = x[u];
      }
    }
    __syncthreads();
  }
  return min(wsum[32], a.n_steps);
}

// The row of base positions a scenario's order partitions: its own where
// it sorted its row (`shared`: scenario 0's otherwise).
__device__ __forceinline__ const int* bpos_row(const Args& a, const int* bpos, size_t s,
                                               bool shared) {
  return bpos + (size_t)(shared && !sorts(a, (int)s) ? 0 : s) * a.W;
}

// How a walk list is made where W is past one tile: its bitmap of
// positions in shared memory; its members' positions there, ranked by
// counting; or, where neither fits (W past ~925,000 heads and a segment
// past ~57,800), its bitmap in device memory (`list_bits`, a region a
// block, each of kListBlocks blocks taking (segment, scenario) pairs in
// turn).
enum ListMode { kBits, kRanks, kDeviceBits };

// Each (root segment, scenario)'s walk list, a block each (kDeviceBits:
// a block a run of pairs), where W is past one tile: the lists into
// `lists` at the segment's CSR offset, their lengths into `n_walk`.
// Where the bitmap of W positions exceeds shared memory (W past ~925,000
// heads), the members' positions are ranked by counting
// (cycle_body::rank_members) where they fit, else the bitmap is built in
// device memory.
__global__ void __launch_bounds__(kListThreads) walk_lists(Args a, const int* bpos, int* lists,
                                                           bool shared, int mode) {
  __shared__ int wsum[33];
  const int nw = (a.W + 31) / 32;
  const bool dev_bits = mode == kDeviceBits;
  const int n_segs = min(a.n_seg, a.n_segments);
  const long long n_pairs = dev_bits ? (long long)n_segs * a.S : 1;
  unsigned* bits = dev_bits ? a.list_bits + (size_t)blockIdx.x * 2 * nw : (unsigned*)smem;
  int* pre = dev_bits ? (int*)(bits + nw) : (int*)(smem + align16(4LL * nw));
  for (long long pair = dev_bits ? blockIdx.x : 0; pair < n_pairs;
       pair += dev_bits ? gridDim.x : 1) {
    const int g = dev_bits ? (int)(pair % n_segs) : (int)blockIdx.x;
    const size_t s = dev_bits ? (size_t)(pair / n_segs) : blockIdx.y;
    const int* brow = bpos_row(a, bpos, s, shared);
    int n;
    if (mode != kRanks) {
      n = build_list(a, s, g, brow, lists + s * a.W, bits, pre, nw, wsum);
    } else {
      int* spos = (int*)smem;
      const size_t h = s * a.W;
      const int beg = a.seg_offsets[g], m = a.seg_offsets[g + 1] - beg;
      const int* members = a.seg_members + beg;
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int x = members[i];
        const bool ok = a.cls[h + x] < 2 && a.cq_row[x] >= 0;
        spos[i] = ok ? a.pos[h + brow[x]] : -1;
      }
      if (threadIdx.x == 0) wsum[0] = 0;
      __syncthreads();
      cycle_body::rank_members(spos, m, members, a.n_steps, lists + h + beg, wsum);
      __syncthreads();
      n = min(wsum[0], a.n_steps);
    }
    if (threadIdx.x == 0) a.n_walk[s * a.n_seg + g] = n;
    __syncthreads();
  }
}

// ---- 4. the walk --------------------------------------------------------

__global__ void __launch_bounds__(32, 1) walk(Args a, WalkLayout L, const int* lists) {
  const int g = blockIdx.x, lane = threadIdx.x;
  const size_t s = blockIdx.y, h = s * a.W, q = s * (size_t)a.N * a.FR;
  const uint8_t* cls = a.cls + h;
  long long* ph = a.per_head + s * 6 * a.W;
  // the walked heads' path nodes: a bit a tree row, a slot its rank
  const int FR = a.FR, D1 = a.D + 1;
  unsigned* bits = (unsigned*)(smem + L.bits);
  int* pre = (int*)(smem + L.pre);
  int* nodes = (int*)(smem + L.nodes);
  const int n_walk = a.n_walk[s * a.n_seg + g];
  if (n_walk == 0) return;
  const int* walk_list = lists + h + a.seg_offsets[g];
  if (L.cap > 0) {
    for (int w = lane; w < L.nw; w += 32) bits[w] = 0;
    __syncwarp();
    for (int r = lane; r < n_walk; r += 32) {
      const int cq = a.cq_row[walk_list[r]];
      for (int d = 0; d < D1; ++d) {
        const int node = a.paths[(size_t)cq * D1 + d];
        if (node >= 0) atomicOr(bits + (node >> 5), 1u << (node & 31));
      }
    }
    __syncwarp();
  }

  View v;
  v.W = a.W; v.K = a.K; v.C = a.C; v.FR = a.FR; v.D = a.D;
  v.cq_row = a.cq_row; v.cells = a.cells; v.qty = a.qty; v.no_reclaim = a.no_reclaim;
  v.chosen = a.chosen + h; v.preempt_k = a.preempt_k + h;
  v.nominal = a.nominal + q; v.borrowing_limit = a.borrowing_limit + q;
  v.paths = a.paths; v.packed = ph; v.lay.win = L.win;

  int n_slots = INT_MAX;
  if (L.cap > 0) {  // the slots: a prefix of the words' counts
    int carry = 0;
    for (int w0 = 0; w0 < L.nw; w0 += 32) {
      const int c = w0 + lane < L.nw ? __popc(bits[w0 + lane]) : 0;
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (w0 + lane < L.nw) pre[w0 + lane] = carry + incl - c;
      carry += __shfl_sync(kFull, incl, 31);
    }
    n_slots = carry;
  }
  const bool shared_rows = n_slots <= L.cap;
  long long* S = (long long*)(smem + L.rows);
  long long* G = S + (size_t)L.cap * FR;
  long long* BL = G + (size_t)L.cap * FR;
  long long* U = BL + (size_t)L.cap * FR;
  auto slot_of = [=](int, int, int node) {
    if (node < 0 || !shared_rows) return node;
    return pre[node >> 5] + __popc(bits[node >> 5] & ((1u << (node & 31)) - 1));
  };
  const long long* sub = a.subtree + q;
  const long long* gua = a.guaranteed + q;
  const long long* bor = a.borrowing_limit + q;
  long long* use = a.usage + q;
  if (shared_rows) {
    __syncwarp();
    for (int w = lane; w < L.nw; w += 32) {
      unsigned word = bits[w];
      int at = pre[w];
      while (word) {
        nodes[at++] = 32 * w + __ffs(word) - 1;
        word &= word - 1;
      }
    }
    __syncwarp();
    for (int i = lane; i < n_slots * FR; i += 32) {
      const size_t x = (size_t)nodes[i / FR] * FR + i % FR;
      S[i] = sub[x];
      G[i] = gua[x];
      BL[i] = bor[x];
      U[i] = use[x];
    }
  }
  __syncwarp();
  const int win = L.win, n_win = (n_walk + win - 1) / win;
  for (int wi = 0; wi < n_win; ++wi) {
    cycle2::stage(v, walk_list, n_walk, wi, L.window, cls, slot_of, lane, 32);
    __syncwarp();
    const int nr = min(win, n_walk - wi * win);
    if (shared_rows) cycle2::walk_steps<true>(v, L.window, nr, S, G, BL, U, lane);
    else cycle2::walk_steps<false>(v, L.window, nr, sub, gua, bor, use, lane);
    __syncwarp();
  }
  if (shared_rows) {
    for (int i = lane; i < n_slots * FR; i += 32) use[(size_t)nodes[i / FR] * FR + i % FR] = U[i];
  }
}

// The walk block's layout: the node tables and rows where they fit in
// its room, then one window.
void plan_walk(const Args& a, WalkLayout* L) {
  const int win = cycle2::kWin;
  const int wbytes = align16(cycle2::window_bytes(win, a.C, a.D));
  const int nw = (a.N + 31) / 32;
  const int tables = 2 * align16(4LL * nw);
  const long long slot_bytes = 32LL * a.FR + 4;
  const long long room = (long long)kWalkBudget - wbytes - tables - 32;
  long long cap = room > 0 ? room / slot_bytes : 0;
  cap = min(cap, (long long)a.N);
  cap = min(cap, (long long)max(a.max_members, 1) * (a.D + 1));
  int off = 0;
  L->nw = nw;
  L->bits = L->pre = L->nodes = L->rows = off;
  L->cap = (int)cap;
  if (cap > 0) {
    L->bits = off;
    off += align16(4LL * nw);
    L->pre = off;
    off += align16(4LL * nw);
    L->nodes = off;
    off += align16(4 * cap);
    L->rows = off;
    off += align16(32 * cap * a.FR);
  }
  L->window = off;
  L->win = win;
  off += wbytes;
  L->total = off;
}

inline cudaStream_t st_of(void* stream) { return (cudaStream_t)stream; }

template <class K>
int opt_in(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace
}  // namespace plan2

// ints: S W K C N FR D n_segments n_steps n_seg max_members; ptrs: the
// Args pointers in order, `list_bits` last (NULL unless W is past one
// tile and neither its bitmap of positions nor its largest segment's
// positions fit a block's shared memory: then min(segments walked x S,
// 264) x 2 ceil(W/32) words). Returns the first launch error
// (cudaErrorInvalidValue on a bad argument list, a shape the kernel
// does not take, C > 32 or S > 65535, or a missing `list_bits`).
extern "C" int plan_phase2(const int* ints, int n_ints, void* const* p, int n_ptrs,
                           void* stream) {
  using namespace plan2;
  if (n_ints != 11 || n_ptrs != 26) return (int)cudaErrorInvalidValue;
  Args a;
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
  a.ctl = (int*)p[i++];
  a.n_walk = (int*)p[i++];
  a.list_bits = (unsigned*)p[i++];
  if (a.W == 0 || a.S == 0) return (int)cudaGetLastError();
  // the sort's tile: a power of two, at most kTile, a pair a thread
  int tile = 1;
  while (tile < a.W && tile < kTile) tile <<= 1;
  const int sort_threads = max(32, tile / 2);
  const int sort_smem = tile * 20;
  // the partition: the classes staged where they fit (in one tile, with
  // the keys); the walk lists: a bitmap of positions and its prefix, in
  // the walk's block where W fits one tile, else in their own blocks
  const bool staged = a.W <= kMaxClsStaged;
  // where W fits one tile, order_small also makes the walk lists, with
  // the counts of as many warps (a power of two) as its room holds
  const long long small_fixed = align16(20LL * tile + 5LL * a.W + 8LL * a.n_seg);
  int nw = sort_threads / 32;
  while (nw > 1 && small_fixed + 8LL * nw * a.n_seg > kSmemMax) nw >>= 1;
  const bool small = a.W <= kTile && small_fixed + 8LL * nw * a.n_seg <= kSmemMax;
  const int part_smem = small ? (int)(small_fixed + 8LL * nw * a.n_seg)
                              : (staged ? align16(a.W) : 0);
  const long long bits_smem = 2LL * align16(4LL * ((a.W + 31) / 32));
  const long long ranks_smem = align16(4LL * max(a.max_members, 1));
  const int mode = bits_smem <= kSmemMax ? kBits : (ranks_smem <= kSmemMax ? kRanks : kDeviceBits);
  const long long list_smem = mode == kBits ? bits_smem : (mode == kRanks ? ranks_smem : 0);
  if (!small && mode == kDeviceBits && a.list_bits == nullptr) return (int)cudaErrorInvalidValue;
  WalkLayout wl;
  plan_walk(a, &wl);
  auto part = staged ? partition<true> : partition<false>;
  int rc = opt_in(walk, wl.total);
  if (rc == 0) rc = opt_in(sort_tiles, sort_smem);
  if (rc == 0) rc = opt_in(merge, sort_smem);
  if (rc == 0) rc = opt_in(part, part_smem);
  if (rc == 0) rc = opt_in(order_small, part_smem);
  if (rc == 0 && !small) rc = opt_in(walk_lists, (int)list_smem);
  if (rc != 0) return rc;
  const cudaStream_t st = st_of(stream);
  const int n_walk_segs = min(a.n_seg, a.n_segments);
  if (small) {  // the walk lists into the sort's buffer, unused here
    order_small<<<a.S, sort_threads, part_smem, st>>>(a, tile, nw, a.idx_a);
    if (n_walk_segs > 0) walk<<<dim3(n_walk_segs, a.S), 32, wl.total, st>>>(a, wl, a.idx_a);
    return (int)cudaGetLastError();
  }
  cudaError_t e = cudaMemsetAsync(a.ctl, 0, sizeof(int) * 4 * (size_t)a.S, st);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (a.W + tile - 1) / tile;
  classify<<<dim3((a.W + kClassThreads - 1) / kClassThreads, a.S), kClassThreads, 0, st>>>(a);
  sort_tiles<<<dim3(tiles, a.S), sort_threads, sort_smem, st>>>(a, a.idx_a, tile);
  int* src = a.idx_a;
  int* dst = a.idx_b;
  for (int width = tile; width < a.W; width <<= 1) {
    merge<<<dim3(tiles, a.S), kMergeThreads, sort_smem, st>>>(a, src, dst, width, tile);
    int* t = src;
    src = dst;
    dst = t;
  }
  // base positions into the sort's other buffer, then the walk lists
  // over the sorted rows
  part<<<a.S, kPartThreads, part_smem, st>>>(a, src, dst);
  if (n_walk_segs > 0) {
    const long long pairs = (long long)n_walk_segs * a.S;
    const dim3 list_grid = mode == kDeviceBits
        ? dim3((unsigned)(pairs < kListBlocks ? pairs : kListBlocks))
        : dim3(n_walk_segs, a.S);
    walk_lists<<<list_grid, kListThreads, (int)list_smem, st>>>(a, dst, src, true, mode);
    walk<<<dim3(n_walk_segs, a.S), 32, wl.total, st>>>(a, wl, src);
  }
  return (int)cudaGetLastError();
}
