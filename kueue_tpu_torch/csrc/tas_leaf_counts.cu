// Kernel B12, tas_leaf_counts: TAS phase-1 pod counting.
//
// Replaces leaf_counts (kueue_tpu/ops/tas_kernel.py:52, jitted at :93)
// and level_counts (:73, with fill_in_counts at :97) — fillInCounts
// of pkg/cache/tas_flavor_snapshot.go:647-690 as dense tensor ops. Two
// C entry points:
//
//   leaf_counts:  one thread per (request b, leaf l), looping over the
//     R resources: remaining = free - usage (0 under simulate_empty) -
//     assumed; per resource with req > 0 the truncating quotient
//     sign(rem) * (|rem| / max(req, 1)) (C++ `/` on non-negatives), the
//     minimum over those (2^31-1 when no resource is requested), clipped
//     above at 2^31-1 (no floor); 0 where the leaf's taints are not
//     tolerated.
//   level_counts: one thread per (request, leaf) adds its count into the
//     domain total of every level with an int64 atomicAdd (integer sums
//     are exact in any order); out is zeroed by the caller and laid out
//     [B, sum(n_domains)] at the per-level offsets. A segment id outside
//     [0, n_domains[d]) is dropped, as jax.ops.segment_sum drops it.
//
// What bounds it: bytes. leaf_counts reads free, usage and assumed
// (8 B per leaf and resource each) and writes 8 B per (b, leaf); at the
// fleet size (131,072 leaves x 2 resources, B=1) that is ~7.3 MB, ~2 us
// at 3.35 TB/s, against a few integer divides a thread. level_counts
// reads 8 B of count and 4 B of segment id per (b, leaf, level) and its
// atomics land on few addresses at the top levels (contention, not
// bandwidth, is its risk at a wide fleet's block level).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tas_place.cuh"

namespace {

using tas_place::kMaxCount;

__global__ void leaf_counts_kernel(const long long* __restrict__ free_,
                                   const long long* __restrict__ usage,
                                   const long long* __restrict__ req,
                                   const long long* __restrict__ assumed,
                                   const uint8_t* __restrict__ taint_ok,
                                   const uint8_t* __restrict__ sim,
                                   long long* __restrict__ out, int B, int L, int R) {
  const size_t total = (size_t)B * L;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(t / L), l = (int)(t % L);
    const bool empty = sim[b] != 0;
    long long count = tas_place::leaf_count(req + (size_t)b * R, R, [&](int r) {
      const long long rem = free_[(size_t)l * R + r] - assumed[t * R + r];
      return empty ? rem : rem - usage[(size_t)l * R + r];
    });
    if (count > kMaxCount) count = kMaxCount;
    out[t] = taint_ok[t] ? count : 0;
  }
}

__global__ void level_counts_kernel(const long long* __restrict__ counts,
                                    const int* __restrict__ seg_ids,
                                    const int* __restrict__ offsets, long long* out,
                                    int B, int L, int D, int total_domains) {
  const size_t total = (size_t)B * L;
  for (size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (size_t)gridDim.x * blockDim.x) {
    const int b = (int)(t / L), l = (int)(t % L);
    const long long c = counts[t];
    for (int d = 0; d < D; ++d) {
      const int s = seg_ids[(size_t)d * L + l];
      if (s < 0 || s >= offsets[d + 1] - offsets[d]) continue;
      atomicAdd((unsigned long long*)&out[(size_t)b * total_domains + offsets[d] + s],
                (unsigned long long)c);
    }
  }
}

int grid_for(size_t total, int threads) {
  const size_t blocks = (total + threads - 1) / threads;
  return (int)(blocks < 4096 ? (blocks < 1 ? 1 : blocks) : 4096);
}

}  // namespace

extern "C" int leaf_counts(const void* free_, const void* usage, const void* req,
                           const void* assumed, const void* taint_ok, const void* sim,
                           void* out, int B, int L, int R, void* stream) {
  const size_t total = (size_t)B * L;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  leaf_counts_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const long long*)free_, (const long long*)usage, (const long long*)req,
      (const long long*)assumed, (const uint8_t*)taint_ok, (const uint8_t*)sim,
      (long long*)out, B, L, R);
  return (int)cudaGetLastError();
}

extern "C" int level_counts(const void* counts, const void* seg_ids, const void* offsets,
                            void* out, int B, int L, int D, int total_domains,
                            void* stream) {
  const size_t total = (size_t)B * L;
  if (total == 0 || D == 0) return (int)cudaGetLastError();
  const int threads = 256;
  level_counts_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const long long*)counts, (const int*)seg_ids, (const int*)offsets,
      (long long*)out, B, L, D, total_domains);
  return (int)cudaGetLastError();
}
