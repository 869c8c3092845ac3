// Kernel 1, quota_tree: the cohort-forest quota recurrences.
//
// Replaces kueue_tpu/ops/quota.py subtree_quota, usage_tree,
// available_all and potential_available_all (the level-scheduled
// segment sums the JAX package jits inside solve_drain). Two entry
// points over one level loop:
//   quota_bottom_up  mode 0: subtree = nominal + sum_children
//                    (child.subtree - child.guaranteed); also writes
//                    guaranteed. mode 1: usage = local + sum_children
//                    max(0, child.usage - child.guaranteed).
//   quota_top_down   mode 0: available (root: subtree - usage; below:
//                    max(0, g - u) + parent's, clamped by the
//                    borrowing limit). mode 1: potentialAvailable.
//
// What bounds it: at the headline shape (N=1050 nodes, FR=17, depth 1)
// a pass moves ~0.5 MB, about 0.15 us at 3.35 TB/s, so the launch
// itself (a few us) bounds it. Design: one block per FR column (a grid
// stride covers FR > grid), threads stride over the nodes, and a
// __syncthreads() separates the levels, so the whole recurrence is one
// launch whatever the depth. Bottom-up sums use 64-bit integer
// atomicAdd, exact in any order (two's complement wraps identically).
// All arithmetic is in long long; NO_LIMIT tests are `< (1LL << 60)`.
// The row-major [N, FR] layout makes a column walk strided; at these
// sizes that costs nothing measurable and keeps the tensors in the
// layout the rest of the drain reads.
//
// A non-null `done` flag set to nonzero makes the launch a no-op (the
// drain's host loop runs a few cycles ahead of its termination check).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kNoLimit = 1LL << 60;

__device__ __forceinline__ long long guaranteed_of(long long sub, long long lend) {
  return lend < kNoLimit ? max(0LL, sub - lend) : 0LL;
}

__global__ void bottom_up(int mode, const int* __restrict__ parent,
                          const uint8_t* __restrict__ level_mask, int n, int fr,
                          int max_depth, const long long* __restrict__ base,
                          const long long* __restrict__ aux, long long* out,
                          long long* out_g, const int* done) {
  if (done != nullptr && *done) return;
  for (int f = blockIdx.x; f < fr; f += gridDim.x) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      out[(size_t)i * fr + f] = base[(size_t)i * fr + f];
    }
    __syncthreads();
    for (int d = max_depth; d >= 1; --d) {
      const uint8_t* m = level_mask + (size_t)d * n;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        int p = parent[i];
        if (!m[i] || p < 0) continue;
        long long v = out[(size_t)i * fr + f];
        long long a = aux[(size_t)i * fr + f];
        long long c = mode == 0 ? v - guaranteed_of(v, a) : max(0LL, v - a);
        atomicAdd(reinterpret_cast<unsigned long long*>(&out[(size_t)p * fr + f]),
                  static_cast<unsigned long long>(c));
      }
      __syncthreads();
    }
    if (mode == 0) {
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        out_g[(size_t)i * fr + f] =
            guaranteed_of(out[(size_t)i * fr + f], aux[(size_t)i * fr + f]);
      }
    }
    __syncthreads();
  }
}

__global__ void top_down(int mode, const int* __restrict__ parent,
                         const uint8_t* __restrict__ level_mask, int n, int fr,
                         int max_depth, const long long* __restrict__ subtree,
                         const long long* __restrict__ guaranteed,
                         const long long* __restrict__ borrowing_limit,
                         const long long* __restrict__ usage, long long* out,
                         const int* done) {
  if (done != nullptr && *done) return;
  for (int f = blockIdx.x; f < fr; f += gridDim.x) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      size_t x = (size_t)i * fr + f;
      out[x] = mode == 0 ? subtree[x] - usage[x] : subtree[x];
    }
    __syncthreads();
    for (int d = 1; d <= max_depth; ++d) {
      const uint8_t* m = level_mask + (size_t)d * n;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (!m[i]) continue;
        int p = max(parent[i], 0);
        size_t x = (size_t)i * fr + f;
        long long pv = out[(size_t)p * fr + f];
        long long s = subtree[x], g = guaranteed[x], bl = borrowing_limit[x];
        bool has_borrow = bl < kNoLimit;
        long long v;
        if (mode == 0) {
          long long u = usage[x];
          long long with_max = (s - g) - max(0LL, u - g) + bl;
          long long clamped = has_borrow ? min(with_max, pv) : pv;
          v = max(0LL, g - u) + clamped;
        } else {
          v = g + pv;
          if (has_borrow) v = min(s + bl, v);
        }
        out[x] = v;
      }
      __syncthreads();
    }
  }
}

int grid_for(int fr) { return fr < 132 ? (fr > 0 ? fr : 1) : 132; }

}  // namespace

extern "C" int quota_bottom_up(int mode, const void* parent, const void* level_mask,
                               int n, int fr, int max_depth, const void* base,
                               const void* aux, void* out, void* out_g,
                               const void* done, void* stream) {
  bottom_up<<<grid_for(fr), 256, 0, (cudaStream_t)stream>>>(
      mode, (const int*)parent, (const uint8_t*)level_mask, n, fr, max_depth,
      (const long long*)base, (const long long*)aux, (long long*)out,
      (long long*)out_g, (const int*)done);
  return (int)cudaGetLastError();
}

extern "C" int quota_top_down(int mode, const void* parent, const void* level_mask,
                              int n, int fr, int max_depth, const void* subtree,
                              const void* guaranteed, const void* borrowing_limit,
                              const void* usage, void* out, const void* done,
                              void* stream) {
  top_down<<<grid_for(fr), 256, 0, (cudaStream_t)stream>>>(
      mode, (const int*)parent, (const uint8_t*)level_mask, n, fr, max_depth,
      (const long long*)subtree, (const long long*)guaranteed,
      (const long long*)borrowing_limit, (const long long*)usage,
      (long long*)out, (const int*)done);
  return (int)cudaGetLastError();
}
