// The CountIn of one TAS leaf (leaf_count), shared by the pod counting
// (tas_leaf_counts.cu), the placement (drain_tas_place.cu) and the
// global scan's re-validation (drain_tas_phase2.cu), with the
// placement's clamps (kueue_tpu/ops/drain_kernel.py
// _tas_fit_and_place, :689-872).

#pragma once

#include <cuda_runtime.h>

namespace tas_place {

constexpr long long kInf = 1LL << 62;
constexpr long long kMaxCount = (1LL << 31) - 1;
constexpr long long kFloor = -(1LL << 40);

// CountIn of one leaf for one pod (Go's truncating division): the
// minimum over the requested resources (req[r] > 0) of
// trunc(rem(r) / req[r]), kMaxCount when none is requested. rem(r) is
// the leaf's remaining capacity of resource r. Not clipped.
template <typename Rem>
__device__ __forceinline__ long long leaf_count(const long long* req, int R, Rem rem) {
  long long c = kMaxCount;
  for (int r = 0; r < R; ++r) {
    if (req[r] <= 0) continue;
    const long long x = rem(r);
    const long long mag = (x < 0 ? -x : x) / req[r];
    c = min(c, x < 0 ? -mag : mag);
  }
  return c;
}

}  // namespace tas_place
