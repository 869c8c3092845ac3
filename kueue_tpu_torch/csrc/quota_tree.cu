// Kernel 1, quota_tree: the cohort-forest quota recurrences, any subset
// of them in one launch.
//
// Replaces kueue_tpu/ops/quota.py subtree_quota (:93), usage_tree
// (:110), available_all (:128) and potential_available_all (:157), the
// level-scheduled segment sums the JAX package jits inside solve_drain
// and solve_cycle_segmented. `mask` chooses the recurrences; per column
// they run in this order, each reading the ones before it:
//   1 subtree    subtree = nominal + sum_children (child.subtree -
//                child.guaranteed); guaranteed = max(0, subtree -
//                lending) where a lending limit is set, else 0;
//   2 usage      usage = local + sum_children max(0, child.usage -
//                child.guaranteed);
//   4 available  root: subtree - usage; below: max(0, g - u) plus the
//                parent's, clamped by the borrowing limit through
//                (s - g) - max(0, u - g) + borrowing;
//   8 potential  root: subtree; below: g + the parent's, clamped by
//                subtree + borrowing.
// A recurrence not in `mask` whose result a later one reads takes it
// from its pointer as an input. The drain cycle runs usage | available,
// the interactive cycle all four.
//
// Grid: a block a bin of whole root subtrees (ops/quota.build_forest,
// built once on the host). A bin's nodes are numbered breadth first, so
// each level is a run of positions and each node's children a run of
// the next level. The block
//   1. stages the bin's rows of every matrix the recurrences read into
//      shared memory, a thread a (node, column) pair in row-major
//      order, so a warp reads whole rows: one round trip, every load of
//      it issued together;
//   2. runs the bottom-up recurrences level by level from the deepest,
//      each (node, column) pair gathering its children's rows (no
//      atomics: integer sums are exact in any order), then the
//      top-down ones from the roots, a __syncthreads() between levels;
//   3. writes the outputs back, coalesced as it read them.
// The blocks of a bin split its columns (the recurrences are
// independent per column: blockIdx.y is a run of columns), so that all
// bins' blocks fill the card and the largest bin's rows fit a block's
// shared memory; a bin too large for even one column (a root subtree of
// thousands of nodes) runs the same levels on the device-memory rows,
// chosen here from its size.
//
// What bounds it: at the headline (N = 1050, FR = 17, depth 1) the
// drain's pass moves about 0.86 MB, ~0.26 us at 3.35 TB/s; the launch
// itself (~5 us with no work) and three dependent memory trips a block
// are the rest. All arithmetic is in long long; NO_LIMIT tests are
// `< (1LL << 60)`. A non-null `done` flag set to nonzero makes the
// launch a no-op (the drain's host loop runs a few cycles ahead of its
// termination check).

#include <cuda_runtime.h>
#include <stdint.h>

namespace qt {
namespace {

constexpr long long kNoLimit = 1LL << 60;
constexpr int kThreads = 256;
constexpr int kRows = 2;  // row cells a thread stages a round
constexpr int kSmemMax = 232448 - 1024;  // a block's opt-in shared memory (sm_90)
constexpr int kSMs = 132;                // the card's multiprocessors
enum : int { kSub = 1, kUsage = 2, kAvail = 4, kPot = 8 };

extern __shared__ __align__(16) unsigned char smem[];

struct Args {
  int mask, n, fr, depth, n_bins, max_bin;
  const int4* meta;  // [N] per position: node, parent, children [first, end) (bin-local)
  const int* bins;   // [n_bins, depth + 2] level starts and the bin's end
  const long long* nominal;
  const long long* lending;
  const long long* borrowing;
  const long long* local;
  long long* sub;    // [N, FR] each an input or an output, as mask says
  long long* g;
  long long* usage;
  long long* avail;
  long long* pot;
  const int* done;
  int n_mats;        // [nb, cw] matrices a bin holds in shared memory
  int cw;            // columns a block owns (blockIdx.y: which)
  int smem;          // dynamic shared bytes of a block
};

__device__ __forceinline__ long long guaranteed_of(long long sub, long long lend) {
  return lend < kNoLimit ? max(0LL, sub - lend) : 0LL;
}

// The matrices the recurrences of `mask` keep: S (subtree), G
// (guaranteed; the lending limit until a node's level turns it into
// guaranteed), U (usage), BL (borrowing limit), AV, PT.
__host__ __device__ inline int mats_of(int mask) {
  const bool down = mask & (kAvail | kPot);
  return ((mask & kSub) || down) + 1 + ((mask & (kUsage | kAvail)) != 0) + down +
         ((mask & kAvail) != 0) + ((mask & kPot) != 0);
}

// Columns a block owns (blockIdx.y picks a run of them; the recurrences
// are independent per column): few enough that the blocks of all bins
// fill the card's ~132 multiprocessors, and that the largest bin's rows
// fit a block's shared memory; a bin too large for even one column (a
// root subtree of thousands of nodes) runs on the device rows.
// (ops/quota.column_chunk says the same.)
__host__ __device__ inline int column_chunk(int max_bin, int fr, int n_mats, int n_bins) {
  const int want = (kSMs + n_bins - 1) / (n_bins > 1 ? n_bins : 1);  // blocks a bin
  const int par = (fr + want - 1) / want;
  const long long fit = ((long long)kSmemMax / (max_bin > 1 ? max_bin : 1) - 16) /
                        (8LL * n_mats);
  const long long cw = fit >= 1 && fit < par ? fit : par;
  return cw >= 1 ? (int)cw : 1;
}

struct Views {
  long long *S, *G, *U, *BL, *AV, *PT;
};

// Columns [f0, f0 + W) of one bin of `nb` positions from `lo`; `lvl`
// its level starts. With kShared the rows sit in shared memory at
// position * W, else the device rows at node * FR + f0.
template <bool kShared>
__device__ __forceinline__ void run_bin(const Args& a, int lo, int nb, const int* lvl, int f0,
                                        int W) {
  const int FR = a.fr, tid = threadIdx.x, mask = a.mask;
  int4* sm = reinterpret_cast<int4*>(smem);
  Views v;
  if constexpr (kShared) {
    long long* m = reinterpret_cast<long long*>(smem + 16 * (size_t)nb);
    const size_t rows = (size_t)nb * W;
    const bool down = mask & (kAvail | kPot);
    int k = 0;
    v.S = ((mask & kSub) || down) ? m + rows * k++ : nullptr;
    v.G = m + rows * k++;
    v.U = (mask & (kUsage | kAvail)) ? m + rows * k++ : nullptr;
    v.BL = down ? m + rows * k++ : nullptr;
    v.AV = (mask & kAvail) ? m + rows * k++ : nullptr;
    v.PT = (mask & kPot) ? m + rows * k++ : nullptr;
    for (int i = tid; i < nb; i += kThreads) sm[i] = __ldg(a.meta + lo + i);
    __syncthreads();
    // kRows cells a thread a round, every load of a round issued before
    // its stores
    const long long* s_in = (mask & kSub) ? a.nominal : a.sub;
    const long long* g_in = (mask & kSub) ? a.lending : a.g;
    const long long* u_in = (mask & kUsage) ? a.local : a.usage;
    for (int base = 0; base < nb * W; base += kRows * kThreads) {
      long long val[kRows][4];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = base + k * kThreads + tid;
        const bool on = i < nb * W;
        const int p = on ? i / W : 0;
        const size_t x = on ? (size_t)sm[p].x * FR + f0 + (i - p * W) : 0;
        val[k][0] = on && v.S ? __ldg(s_in + x) : 0;
        val[k][1] = on ? __ldg(g_in + x) : 0;
        val[k][2] = on && v.U ? __ldg(u_in + x) : 0;
        val[k][3] = on && v.BL ? __ldg(a.borrowing + x) : 0;
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = base + k * kThreads + tid;
        if (i >= nb * W) continue;
        if (v.S) v.S[i] = val[k][0];
        v.G[i] = val[k][1];
        if (v.U) v.U[i] = val[k][2];
        if (v.BL) v.BL[i] = val[k][3];
      }
    }
  } else {
    // the outputs are the working rows: seed them from their inputs
    v = Views{a.sub, a.g, a.usage, const_cast<long long*>(a.borrowing), a.avail, a.pot};
    for (int i = tid; i < nb * W; i += kThreads) {
      const int p = i / W;
      const size_t x = (size_t)__ldg(&a.meta[lo + p].x) * FR + f0 + (i - p * W);
      if (mask & kSub) {
        v.S[x] = __ldg(a.nominal + x);
        v.G[x] = __ldg(a.lending + x);
      }
      if (mask & kUsage) v.U[x] = __ldg(a.local + x);
    }
  }
  __syncthreads();

  const int4* gm = a.meta + lo;  // the bin's packing in device memory

  if (mask & (kSub | kUsage)) {
    for (int d = a.depth; d >= 0; --d) {
      const int l0 = lvl[d] - lo, cnt = lvl[d + 1] - lvl[d];
      for (int i = tid; i < cnt * W; i += kThreads) {
        const int q = i / W, f = i - q * W, p = l0 + q;
        const int4 m = kShared ? sm[p] : __ldg(gm + p);
        const size_t x = (kShared ? (size_t)p * W : (size_t)m.x * FR + f0) + f;
        if (mask & kSub) {
          long long s = v.S[x];
          for (int c = m.z; c < m.w; ++c) {
            const size_t y =
                (kShared ? (size_t)c * W : (size_t)__ldg(&gm[c].x) * FR + f0) + f;
            s += v.S[y] - v.G[y];
          }
          v.S[x] = s;
          v.G[x] = guaranteed_of(s, v.G[x]);
        }
        if (mask & kUsage) {
          long long u = v.U[x];
          for (int c = m.z; c < m.w; ++c) {
            const size_t y =
                (kShared ? (size_t)c * W : (size_t)__ldg(&gm[c].x) * FR + f0) + f;
            u += max(0LL, v.U[y] - v.G[y]);
          }
          v.U[x] = u;
        }
      }
      __syncthreads();
    }
  }

  if (mask & (kAvail | kPot)) {
    for (int d = 0; d <= a.depth; ++d) {
      const int l0 = lvl[d] - lo, cnt = lvl[d + 1] - lvl[d];
      for (int i = tid; i < cnt * W; i += kThreads) {
        const int q = i / W, f = i - q * W, p = l0 + q;
        const int4 m = kShared ? sm[p] : __ldg(gm + p);
        const size_t x = (kShared ? (size_t)p * W : (size_t)m.x * FR + f0) + f;
        const long long s = v.S[x], g = v.G[x], bl = v.BL[x];
        const bool has_borrow = bl < kNoLimit;
        if (m.y < 0) {
          if (mask & kAvail) v.AV[x] = s - v.U[x];
          if (mask & kPot) v.PT[x] = s;
        } else {
          const size_t y =
              (kShared ? (size_t)m.y * W : (size_t)__ldg(&gm[m.y].x) * FR + f0) + f;
          if (mask & kAvail) {
            const long long u = v.U[x], pa = v.AV[y];
            const long long with_max = (s - g) - max(0LL, u - g) + bl;
            v.AV[x] = max(0LL, g - u) + (has_borrow ? min(with_max, pa) : pa);
          }
          if (mask & kPot) {
            const long long pv = g + v.PT[y];
            v.PT[x] = has_borrow ? min(s + bl, pv) : pv;
          }
        }
      }
      __syncthreads();
    }
  }

  if constexpr (kShared) {
    for (int i = tid; i < nb * W; i += kThreads) {
      const int p = i / W;
      const size_t x = (size_t)sm[p].x * FR + f0 + (i - p * W);
      if (mask & kSub) {
        a.sub[x] = v.S[i];
        a.g[x] = v.G[i];
      }
      if (mask & kUsage) a.usage[x] = v.U[i];
      if (mask & kAvail) a.avail[x] = v.AV[i];
      if (mask & kPot) a.pot[x] = v.PT[i];
    }
  }
}

// One block a multiprocessor is enough (the grid is a block a segment or
// bin): without the 1, ptxas held the kernel to 64 registers and spilled.
__global__ void __launch_bounds__(kThreads, 1) quota_kernel(Args a) {
  if (a.done != nullptr && *a.done) return;
  const int* lvl = a.bins + (size_t)blockIdx.x * (a.depth + 2);
  const int lo = lvl[0], nb = lvl[a.depth + 1] - lo;
  const int f0 = blockIdx.y * a.cw, W = min(a.cw, a.fr - f0);
  if ((long long)nb * (16 + 8LL * W * a.n_mats) <= a.smem) run_bin<true>(a, lo, nb, lvl, f0, W);
  else run_bin<false>(a, lo, nb, lvl, f0, W);
}

}  // namespace
}  // namespace qt

// ints: mask N FR depth n_bins max_bin; ptrs: meta bins nominal
// lending_limit borrowing_limit local subtree guaranteed usage avail
// potential done (NULL where the recurrences of `mask` neither read nor
// write it; done may be NULL). Returns cudaGetLastError()
// (cudaErrorInvalidValue on a bad argument list or a missing pointer).
extern "C" int quota_tree(const int* ints, int n_ints, void* const* p, int n_ptrs,
                          void* stream) {
  using namespace qt;
  if (n_ints != 6 || n_ptrs != 12) return (int)cudaErrorInvalidValue;
  Args a;
  a.mask = ints[0]; a.n = ints[1]; a.fr = ints[2]; a.depth = ints[3];
  a.n_bins = ints[4]; a.max_bin = ints[5];
  int i = 0;
  a.meta = (const int4*)p[i++];
  a.bins = (const int*)p[i++];
  a.nominal = (const long long*)p[i++];
  a.lending = (const long long*)p[i++];
  a.borrowing = (const long long*)p[i++];
  a.local = (const long long*)p[i++];
  a.sub = (long long*)p[i++];
  a.g = (long long*)p[i++];
  a.usage = (long long*)p[i++];
  a.avail = (long long*)p[i++];
  a.pot = (long long*)p[i++];
  a.done = (const int*)p[i++];
  const int m = a.mask;
  const bool sub = m & kSub, use = m & kUsage, av = m & kAvail, pot = m & kPot;
  const bool ok = m > 0 && m < 16 && a.meta && a.bins && a.g && (!(sub || av || pot) || a.sub) &&
                  (!sub || (a.nominal && a.lending)) && (!use || a.local) &&
                  (!(use || av) || a.usage) && (!(av || pot) || a.borrowing) &&
                  (!av || a.avail) && (!pot || a.pot);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (a.n_bins == 0 || a.fr == 0) return (int)cudaGetLastError();
  a.n_mats = mats_of(m);
  a.cw = column_chunk(a.max_bin, a.fr, a.n_mats, a.n_bins);
  const long long need = (long long)a.max_bin * (16 + 8LL * a.cw * a.n_mats);
  a.smem = (int)(need < kSmemMax ? need : kSmemMax);
  static int raised = 48 * 1024;  // the dynamic shared memory allowed so far
  if (a.smem > raised) {
    cudaError_t rc = cudaFuncSetAttribute(quota_kernel,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          kSmemMax);
    if (rc != cudaSuccess) return (int)rc;
    raised = kSmemMax;
  }
  const dim3 grid(a.n_bins, (a.fr + a.cw - 1) / a.cw);
  quota_kernel<<<grid, kThreads, a.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
