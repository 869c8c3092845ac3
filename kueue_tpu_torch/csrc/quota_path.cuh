// available() along one ancestor path, shared by drain_phase2.cu and
// cycle_phase2.cu: the root-down recurrence of resource_node.go:89-104
// (the JAX _avail_along_path, kueue_tpu/ops/assign_kernel.py:282) for
// one cell, over the path's nodes only.
//
// path: int32[D+1] = [leaf, parent, ..., root, -1 pads]; the matrices
// are int64[N, FR] row-major. NO_LIMIT borrowing limits are compared
// as `< kNoLimit`, never clamped.

#pragma once

#include <cuda_runtime.h>

namespace quota_path {

constexpr long long kNoLimit = 1LL << 60;

__device__ __forceinline__ long long avail_along_path(
    const int* path, int D, int FR, int cell, const long long* subtree,
    const long long* guaranteed, const long long* borrowing_limit,
    const long long* usage) {
  int n_valid = 0;
  for (int d = 0; d <= D; ++d) n_valid += path[d] >= 0;
  const int root_pos = n_valid - 1;
  long long avail = 0;
  for (int d = D; d >= 0; --d) {
    const int node = path[d];
    if (node < 0) continue;
    const size_t x = (size_t)node * FR + cell;
    const long long s = subtree[x], g = guaranteed[x];
    const long long bl = borrowing_limit[x], u = usage[x];
    if (d == root_pos) {
      avail = s - u;
    } else {
      const long long with_max = (s - g) - max(0LL, u - g) + bl;
      const long long clamped = bl < kNoLimit ? min(with_max, avail) : avail;
      avail = max(0LL, g - u) + clamped;
    }
  }
  return avail;
}

}  // namespace quota_path
