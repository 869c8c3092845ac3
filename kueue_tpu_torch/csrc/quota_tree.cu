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
// launch whatever the depth. The bodies live in quota_tree_body.cuh,
// shared with plan_quota_tree.cu.
// The row-major [N, FR] layout makes a column walk strided; at these
// sizes that costs nothing measurable and keeps the tensors in the
// layout the rest of the drain reads.
//
// A non-null `done` flag set to nonzero makes the launch a no-op (the
// drain's host loop runs a few cycles ahead of its termination check).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quota_tree_body.cuh"

namespace {

__global__ void bottom_up(int mode, const int* __restrict__ parent,
                          const uint8_t* __restrict__ level_mask, int n, int fr,
                          int max_depth, const long long* __restrict__ base,
                          const long long* __restrict__ aux, long long* out,
                          long long* out_g, const int* done) {
  if (done != nullptr && *done) return;
  quota_tree_body::bottom_up(mode, parent, level_mask, n, fr, max_depth, base, aux, out,
                             out_g);
}

__global__ void top_down(int mode, const int* __restrict__ parent,
                         const uint8_t* __restrict__ level_mask, int n, int fr,
                         int max_depth, const long long* __restrict__ subtree,
                         const long long* __restrict__ guaranteed,
                         const long long* __restrict__ borrowing_limit,
                         const long long* __restrict__ usage, long long* out,
                         const int* done) {
  if (done != nullptr && *done) return;
  quota_tree_body::top_down(mode, parent, level_mask, n, fr, max_depth, subtree,
                            guaranteed, borrowing_limit, usage, out);
}

using quota_tree_body::grid_for;

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
