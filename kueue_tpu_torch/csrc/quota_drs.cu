// Kernel B1', quota_drs: the fair-sharing reductions over the quota tree.
//
// Replaces kueue_tpu/ops/quota.py lendable_per_resource (:175) and
// dominant_resource_share (:196), two entry points under one launch counter:
//   quota_lendable  calculateLendable (fair_sharing.go:90-104): the node's
//                   parent's potentialAvailable summed per resource through
//                   resource_index; roots get 0. int64[N, R].
//   quota_drs       DominantResourceShare (fair_sharing.go:49-86): borrowed
//                   = max(0, wl_req + usage - subtree) summed per resource;
//                   ratio = borrowed*1000 / max(lendable, 1) where borrowed > 0
//                   and lendable > 0, else -1; the max and its first
//                   (lowest-resource) argmax; the share drs*1000 / weight
//                   with C's truncating division (Go's; drs may be -1), and
//                   DRS_MAX for a zero weight while borrowing. A node that
//                   does not borrow or has no parent gets 0 and -1; the
//                   dominant resource is -1 also where drs < 0.
//
// One block: the potentialAvailable recurrence (quota_tree_body::top_down,
// mode 1, the body of kernel 1) over every FR column into the [N, FR]
// scratch, a barrier, then one thread a node for the per-resource sums.
//
// What bounds it: at the headline (N=1050, FR=17, depth 1) it reads and
// writes well under a megabyte, a fraction of a microsecond at 3.35 TB/s,
// so the launch and the level barriers bound it. The per-node sums walk the
// FR cells once for every resource (R x FR work a node): R and FR are a few
// dozen at most in the configurations the repo runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "quota_tree_body.cuh"

namespace drs {
namespace {

constexpr int kThreads = 512;
constexpr long long kDrsMax = 0x7fffffffffffffffLL;

struct Tree {
  int N, FR, R, D;
  const int* parent;              // [N]
  const uint8_t* level_mask;      // [D+1, N]
  const long long* subtree;       // [N,FR]
  const long long* guaranteed;
  const long long* borrowing_limit;
  const int* resource_index;      // [FR]
  long long* pot;                 // [N,FR] scratch: potentialAvailable
};

// potentialAvailable into t.pot; the caller syncs the block after.
__device__ __forceinline__ void potential(const Tree& t) {
  quota_tree_body::top_down(1, t.parent, t.level_mask, t.N, t.FR, t.D, t.subtree,
                            t.guaranteed, t.borrowing_limit, nullptr, t.pot);
}

// Node i's lendable of resource r: its parent's potentialAvailable summed
// over the cells of r; 0 for a root.
__device__ __forceinline__ long long lendable_of(const Tree& t, int i, int r) {
  const int p = t.parent[i];
  if (p < 0) return 0;
  long long s = 0;
  for (int j = 0; j < t.FR; ++j) {
    if (t.resource_index[j] == r) s += t.pot[(size_t)p * t.FR + j];
  }
  return s;
}

__global__ void __launch_bounds__(kThreads) lendable_kernel(Tree t, long long* out) {
  potential(t);
  __syncthreads();
  for (int i = threadIdx.x; i < t.N; i += blockDim.x) {
    for (int r = 0; r < t.R; ++r) out[(size_t)i * t.R + r] = lendable_of(t, i, r);
  }
}

__global__ void __launch_bounds__(kThreads) drs_kernel(Tree t, const long long* usage,
                                                       const long long* wl_req,
                                                       const long long* weight,
                                                       long long* out_drs,
                                                       int* out_dominant) {
  potential(t);
  __syncthreads();
  for (int i = threadIdx.x; i < t.N; i += blockDim.x) {
    long long best = -1;  // every ratio -1: the max is -1 and argmax 0
    int dominant = 0;
    bool borrowing = false;
    for (int r = 0; r < t.R; ++r) {
      long long borrowed = 0;
      for (int j = 0; j < t.FR; ++j) {
        if (t.resource_index[j] != r) continue;
        const size_t x = (size_t)i * t.FR + j;
        borrowed += max(0LL, wl_req[x] + usage[x] - t.subtree[x]);
      }
      borrowing = borrowing || borrowed > 0;
      const long long lend = lendable_of(t, i, r);
      const long long ratio =
          borrowed > 0 && lend > 0 ? borrowed * 1000 / max(lend, 1LL) : -1;
      if (ratio > best) {  // ratio >= -1: the first maximum, as argmax takes it
        best = ratio;
        dominant = r;
      }
    }
    const bool active = borrowing && t.parent[i] >= 0;
    const long long w = weight[i];
    long long share = 0;
    if (active) share = w == 0 ? kDrsMax : best * 1000 / max(w, 1LL);
    out_drs[i] = share;
    out_dominant[i] = active && best >= 0 ? dominant : -1;
  }
}

Tree tree_of(const int* ints, void* const* p) {
  Tree t;
  t.N = ints[0]; t.FR = ints[1]; t.R = ints[2]; t.D = ints[3];
  t.parent = (const int*)p[0];
  t.level_mask = (const uint8_t*)p[1];
  t.subtree = (const long long*)p[2];
  t.guaranteed = (const long long*)p[3];
  t.borrowing_limit = (const long long*)p[4];
  t.resource_index = (const int*)p[5];
  t.pot = (long long*)p[6];
  return t;
}

}  // namespace
}  // namespace drs

// ints: N FR R D; ptrs: parent, level_mask, subtree, guaranteed,
// borrowing_limit, resource_index, pot scratch [N,FR], out int64[N,R].
extern "C" int quota_lendable(const int* ints, int n_ints, void* const* p, int n_ptrs,
                              void* stream) {
  if (n_ints != 4 || n_ptrs != 8) return (int)cudaErrorInvalidValue;
  const drs::Tree t = drs::tree_of(ints, p);
  if (t.N == 0) return (int)cudaGetLastError();
  drs::lendable_kernel<<<1, drs::kThreads, 0, (cudaStream_t)stream>>>(
      t, (long long*)p[7]);
  return (int)cudaGetLastError();
}

// ints: N FR R D; ptrs: parent, level_mask, subtree, guaranteed,
// borrowing_limit, resource_index, pot scratch [N,FR], usage [N,FR],
// wl_req [N,FR], weight_milli [N], out drs int64[N], out dominant int32[N].
extern "C" int quota_drs(const int* ints, int n_ints, void* const* p, int n_ptrs,
                         void* stream) {
  if (n_ints != 4 || n_ptrs != 12) return (int)cudaErrorInvalidValue;
  const drs::Tree t = drs::tree_of(ints, p);
  if (t.N == 0) return (int)cudaGetLastError();
  drs::drs_kernel<<<1, drs::kThreads, 0, (cudaStream_t)stream>>>(
      t, (const long long*)p[7], (const long long*)p[8], (const long long*)p[9],
      (long long*)p[10], (int*)p[11]);
  return (int)cudaGetLastError();
}
