// Kernel B9, fair_search: every deferred preempt-mode head's fair-sharing
// victim search of one scheduling cycle, in one launch.
//
// Replaces kueue_tpu/ops/fair_preempt_kernel.py solve_fair (:430), the
// vmap over head rows of _solve_one_fair (:151), packed as
// _solve_fair_packed (:442-449): int32[W*V] targets, then int32[W]
// fits.
//
// Design: one block of one warp per head row. The row's usage panel
// ([S, Cu] int64, the head's request already bubbled in by the host)
// is copied to shared memory with the row's lendable table and the
// tournament's flags; the quota panels are read from global memory,
// where the row's own slice stays in L1. The search is
// fair_local.cuh's: per pick one DRS pass over the panel (a lane per
// node), the walkability pass and the walk (warp reductions), then one
// probe bubble and one fit check (a lane per cell).
//
// What bounds it: the serial chain of dependent picks per row (up to
// 2V + S + 4, each a DRS pass and a few shared-memory round trips),
// not bytes: a row's inputs are a few kB (chip_smoke.py counts them
// per launch from the rows' own data). Rows run in parallel, one warp
// each.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fair_local.cuh"

namespace {

struct Problem {
  const int* paths;          // [W,S,D+1]
  const long long* usage0;   // [W,S,Cu]
  const long long* subtree_q;
  const long long* guaranteed;
  const long long* borrow_lim;
  const long long* weight;   // [W,S]
  const int* parent_loc;     // [W,S]
  const int* depth_s;        // [W,S]
  const uint8_t* is_cq;      // [W,S]
  const uint8_t* svalid;     // [W,S]
  const uint8_t* anc_of_head;  // [W,S]
  const int* hrow;           // [W]
  const long long* need_qty; // [W,Cu]
  const int* res_of;         // [W,Cu]
  const int* crow;           // [W,V]
  const long long* cqty;     // [W,V,Cu]
  const uint8_t* cvalid;     // [W,V]
  const uint8_t* row_valid;  // [W]
  int* out;                  // [W*V + W]
};

struct RowCand {
  const Problem* pr;
  int w, V, Cu;
  __device__ bool valid(int j) const { return pr->cvalid[(size_t)w * V + j]; }
  __device__ int row(int j) const { return max(pr->crow[(size_t)w * V + j], 0); }
  __device__ long long qty(int j, int c) const {
    return pr->cqty[((size_t)w * V + j) * Cu + c];
  }
};

__global__ void search(Problem pr, int W, int S, int Cu, int V, int D, int R, int strategy1,
                       int has_second) {
  extern __shared__ long long smem[];
  const int w = blockIdx.x;
  const int lane = threadIdx.x;
  fair_local::Scratch sc = fair_local::carve(smem, S, Cu, R, V);
  const size_t panel = (size_t)S * Cu;
  const size_t rs = (size_t)w * S;
  fair_local::Tree t;
  t.paths = pr.paths + rs * (D + 1);
  t.parent = pr.parent_loc + rs;
  t.depth = pr.depth_s + rs;
  t.is_cq = pr.is_cq + rs;
  t.valid = pr.svalid + rs;
  t.anc = pr.anc_of_head + rs;
  t.weight = pr.weight + rs;
  t.sub = pr.subtree_q + (size_t)w * panel;
  t.g = pr.guaranteed + (size_t)w * panel;
  t.bl = pr.borrow_lim + (size_t)w * panel;
  t.res = pr.res_of + (size_t)w * Cu;
  t.need = pr.need_qty + (size_t)w * Cu;
  t.S = S;
  t.Cu = Cu;
  t.D = D;
  t.R = R;
  t.hrow = max(pr.hrow[w], 0);

  fair_local::lendable(t, sc, lane);
  for (size_t i = lane; i < panel; i += 32) sc.u[i] = pr.usage0[(size_t)w * panel + i];
  __syncwarp();
  RowCand cand{&pr, w, V, Cu};
  const bool fits = fair_local::search(t, cand, V, sc, strategy1, has_second != 0,
                                       pr.row_valid[w] != 0, lane);
  for (int j = lane; j < V; j += 32) pr.out[(size_t)w * V + j] = fits && sc.removed[j];
  if (lane == 0) pr.out[(size_t)W * V + w] = fits;
}

}  // namespace

extern "C" int fair_search(int W, int S, int Cu, int V, int D, int R, int strategy1,
                           int has_second, const int* paths, const long long* usage0,
                           const long long* subtree_q, const long long* guaranteed,
                           const long long* borrow_lim, const long long* weight,
                           const int* parent_loc, const int* depth_s, const uint8_t* is_cq,
                           const uint8_t* svalid, const uint8_t* anc_of_head, const int* hrow,
                           const long long* need_qty, const int* res_of, const int* crow,
                           const long long* cqty, const uint8_t* cvalid,
                           const uint8_t* row_valid, int* out, void* stream) {
  if (S < 1 || S > fair_local::kMaxS || Cu > fair_local::kMaxCu || R < 1 ||
      R > fair_local::kMaxR || V < 0 || W < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Problem pr{paths, usage0, subtree_q, guaranteed, borrow_lim, weight, parent_loc, depth_s,
             is_cq, svalid, anc_of_head, hrow, need_qty, res_of, crow, cqty, cvalid,
             row_valid, out};
  const size_t smem = fair_local::scratch_bytes(S, Cu, R, V);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        search, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (W > 0) {
    search<<<W, 32, smem, (cudaStream_t)stream>>>(pr, W, S, Cu, V, D, R, strategy1,
                                                  has_second);
  }
  return (int)cudaGetLastError();
}
