// The cohort-forest quota recurrences of one quota state, shared by
// quota_tree.cu (kernel 1: one state) and plan_quota_tree.cu (kernel
// B14's first launch: one state per scenario, blockIdx.y). Each body is
// run by one block over its FR columns (blockIdx.x, gridDim.x stride)
// on base pointers that the caller has offset to its state; parent and
// level_mask are shared.
//   bottom_up  mode 0: subtree = nominal + sum_children (child.subtree -
//              child.guaranteed); also writes guaranteed. mode 1: usage
//              = local + sum_children max(0, child.usage - child.guaranteed).
//   top_down   mode 0: available (root: subtree - usage; below: max(0,
//              g - u) + parent's, clamped by the borrowing limit).
//              mode 1: potentialAvailable.
// Bottom-up sums use 64-bit integer atomicAdd, exact in any order
// (two's complement wraps identically). All arithmetic is in long long;
// NO_LIMIT tests are `< (1LL << 60)`.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace quota_tree_body {

constexpr long long kNoLimit = 1LL << 60;

__device__ __forceinline__ long long guaranteed_of(long long sub, long long lend) {
  return lend < kNoLimit ? max(0LL, sub - lend) : 0LL;
}

__device__ __forceinline__ void bottom_up(int mode, const int* __restrict__ parent,
                                          const uint8_t* __restrict__ level_mask, int n,
                                          int fr, int max_depth,
                                          const long long* __restrict__ base,
                                          const long long* __restrict__ aux, long long* out,
                                          long long* out_g) {
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

__device__ __forceinline__ void top_down(int mode, const int* __restrict__ parent,
                                         const uint8_t* __restrict__ level_mask, int n,
                                         int fr, int max_depth,
                                         const long long* __restrict__ subtree,
                                         const long long* __restrict__ guaranteed,
                                         const long long* __restrict__ borrowing_limit,
                                         const long long* __restrict__ usage,
                                         long long* out) {
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

// One block per FR column, up to the card's 132 SMs (a grid stride
// covers more columns).
inline int grid_for(int fr) { return fr < 132 ? (fr > 0 ? fr : 1) : 132; }

}  // namespace quota_tree_body
