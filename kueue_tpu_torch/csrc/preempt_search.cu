// Kernel B8, preempt_search: every deferred preempt-mode head's victim
// search of one scheduling cycle, in one launch.
//
// Replaces kueue_tpu/ops/preempt_kernel.py solve_preempt (:246), the
// vmap over attempt rows of _solve_one (:166), packed as
// _solve_preempt_packed (:253): int32[W*V] targets, then int32[W]
// fits.
//
// Design: one block of one warp per attempt row, one lane per cell
// (Cu <= 16). The row's mutable usage and leaf panels ([S, Cu] int64)
// are copied to shared memory; the quota panels are read from global
// memory, where the row's own slice stays in L1. The candidate loop
// is serial (each removal changes the next fit check), so the search
// is preempt_local.cuh's ladder: per candidate one bubble up the
// owner's path and one available() down the head's path per lane, and
// two warp votes.
//
// What bounds it: the serial chain of dependent shared-memory steps per
// row (up to V removals and V fill-backs, each ~2 x (D+1) round trips),
// not bytes: a row's inputs are a few kB (chip_smoke.py counts them
// per launch from the rows' own data). Rows run in parallel, 32 lanes
// each, so up to ~1000 rows fill the card's 132 SMs many times over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "preempt_local.cuh"

namespace {

struct Problem {
  const int* paths;             // [W,S,D+1]
  const long long* usage0;      // [W,S,Cu]
  const long long* leaf0;
  const long long* nominal;
  const long long* subtree_q;
  const long long* guaranteed;
  const long long* borrow_lim;
  const int* hrow;              // [W]
  const long long* need_qty;    // [W,Cu]
  const uint8_t* need_pre;      // [W,Cu]
  const uint8_t* allow_borrow;  // [W]
  const uint8_t* has_thr;
  const long long* thr;
  const int* crow;              // [W,V]
  const long long* cqty;        // [W,V,Cu]
  const uint8_t* cvalid;        // [W,V]
  const uint8_t* csame;
  const long long* cprio;
  const uint8_t* row_valid;     // [W]
  int* out;                     // [W*V + W]
};

struct RowCand {
  const Problem* pr;
  int w, S, Cu, V, D1;
  __device__ bool valid(int j) const { return pr->cvalid[(size_t)w * V + j]; }
  __device__ int row(int j) const { return max(pr->crow[(size_t)w * V + j], 0); }
  __device__ bool same(int j) const { return pr->csame[(size_t)w * V + j]; }
  __device__ long long prio(int j) const { return pr->cprio[(size_t)w * V + j]; }
  __device__ long long qty(int j, int c) const {
    return pr->cqty[((size_t)w * V + j) * Cu + c];
  }
  __device__ const int* path(int row) const {
    return pr->paths + ((size_t)w * S + row) * D1;
  }
};

__global__ void search(Problem pr, int W, int S, int Cu, int V, int D) {
  extern __shared__ long long smem[];
  const int w = blockIdx.x;
  const int c = threadIdx.x;
  const int D1 = D + 1;
  const size_t panel = (size_t)S * Cu;
  long long* u = smem;
  long long* lf = smem + panel;
  uint8_t* removed = reinterpret_cast<uint8_t*>(smem + 2 * panel);
  const size_t base = (size_t)w * panel;
  for (size_t i = c; i < panel; i += 32) {
    u[i] = pr.usage0[base + i];
    lf[i] = pr.leaf0[base + i];
  }
  __syncwarp();

  const bool in = c < Cu;
  const long long qty = in ? pr.need_qty[(size_t)w * Cu + c] : 0;
  const bool need = in && qty > 0;
  const bool npre = in && pr.need_pre[(size_t)w * Cu + c];
  const int hrow = max(pr.hrow[w], 0);
  preempt_local::Panels p{u, lf, pr.guaranteed + base, pr.subtree_q + base,
                          pr.borrow_lim + base, pr.nominal + base, Cu};
  RowCand cand{&pr, w, S, Cu, V, D1};
  const bool found = preempt_local::ladder(
      cand, V, pr.row_valid[w], pr.allow_borrow[w], pr.has_thr[w], pr.thr[w], p,
      pr.paths + ((size_t)w * S + hrow) * D1, hrow, D, c, in, need, qty, npre, removed);
  __syncwarp();
  for (int j = c; j < V; j += 32) pr.out[(size_t)w * V + j] = found && removed[j];
  if (c == 0) pr.out[(size_t)W * V + w] = found;
}

}  // namespace

extern "C" int preempt_search(int W, int S, int Cu, int V, int D, const int* paths,
                              const long long* usage0, const long long* leaf0,
                              const long long* nominal, const long long* subtree_q,
                              const long long* guaranteed, const long long* borrow_lim,
                              const int* hrow, const long long* need_qty,
                              const uint8_t* need_pre, const uint8_t* allow_borrow,
                              const uint8_t* has_thr, const long long* thr, const int* crow,
                              const long long* cqty, const uint8_t* cvalid,
                              const uint8_t* csame, const long long* cprio,
                              const uint8_t* row_valid, int* out, void* stream) {
  if (Cu > 32 || V < 0 || W < 0) return (int)cudaErrorInvalidValue;
  Problem pr{paths, usage0, leaf0, nominal, subtree_q, guaranteed, borrow_lim, hrow,
             need_qty, need_pre, allow_borrow, has_thr, thr, crow, cqty, cvalid, csame,
             cprio, row_valid, out};
  const size_t smem = 2 * (size_t)S * Cu * sizeof(long long) + (size_t)V;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        search, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (W > 0) search<<<W, 32, smem, (cudaStream_t)stream>>>(pr, W, S, Cu, V, D);
  return (int)cudaGetLastError();
}
