// Kernel B15, global_rescore: the federation's global rescore.
//
// Replaces kueue_tpu/ops/global_kernel.py _solve_rescore (:115, jitted as
// solve_rescore at :156, host wrapper rescore_pairs at :159). For every
// (pending workload r, worker column j) pair of the [W, C] inputs:
//   tta_c = clip(clip(tta, 0, CAP) + (degraded[j] ? penalty : 0), 0, CAP)
//   s     = clip(score, -2^20, 2^20-1) + 2^20
//   key   = tta_c<<33 | (2^21-1-s)<<12 | ((j - rotation[r]) floor-mod C)
//   key   = valid ? key : INVALID (2^63-1)
// then per row the first least key (jnp.argmin's column), best = -1 where
// that key is INVALID, and against the current column (clipped into
// [0, C) for the reads, compared unclipped):
//   movable   = current >= 0 && valid[current] && best exists
//   gain      = movable ? tta_c[current] - tta_c[best] : 0
//   rebalance = movable && best != current && gain > hysteresis
// The four results go to one packed int64 [4, W] buffer (best, best_key,
// gain, rebalance as 0/1) that the wrapper fetches in one copy.
//
// Design: a row of threads per workload (a warp where C <= 1024, a block
// of kRowThreads otherwise). Each thread packs the keys of the columns
// lane, lane + width, ... (neighbouring threads on neighbouring columns, so
// the row's tta/score/valid loads coalesce) and keeps its least (key,
// column); a warp-shuffle min, then a shared-memory min across the block's
// warps for the wide case, finishes the row. The (key, column)
// lexicographic min is jnp.argmin's first-occurrence rule. All arithmetic
// is int64; the penalty add wraps as the reference's int64 add does.
//
// What bounds it: bytes. Every pair reads 17 bytes (tta, score, valid), a
// row 8 more and writes 32; there is no reuse to exploit. At W=65,536 x
// C=64 that is ~73 MB, ~22 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace rescore {
namespace {

constexpr long long kTtaCap = (1LL << 30) - 1;
constexpr long long kScoreHalf = 1LL << 20;
constexpr long long kScoreMask = (1LL << 21) - 1;
constexpr int kIdxBits = 12;
constexpr int kTtaShift = 33;
constexpr long long kInvalid = 0x7fffffffffffffffLL;
constexpr int kBlock = 256;       // threads a block
constexpr int kRowThreads = 256;  // a row's threads in the wide case (C > 1024)

struct In {
  int W, C;
  const long long* tta;      // [W, C]
  const long long* score;    // [W, C]
  const uint8_t* valid;      // [W, C]
  const int* current;        // [W]
  const int* rotation;       // [W]
  const uint8_t* degraded;   // [C]
  long long hysteresis, penalty;
  long long* out;            // [4, W]
};

__device__ __forceinline__ long long clip(long long v, long long lo, long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ long long tta_of(const In& in, size_t at, int j) {
  long long t = clip(in.tta[at], 0, kTtaCap);
  if (in.degraded[j])
    t = (long long)((unsigned long long)t + (unsigned long long)in.penalty);
  return clip(t, 0, kTtaCap);
}

// (key, column) lexicographic order: the least key, the first column.
__device__ __forceinline__ void take_min(long long& k, int& c, long long k2, int c2) {
  if (k2 < k || (k2 == k && c2 < c)) {
    k = k2;
    c = c2;
  }
}

__device__ __forceinline__ void warp_min(long long& k, int& c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long k2 = __shfl_down_sync(0xffffffffu, k, off);
    const int c2 = __shfl_down_sync(0xffffffffu, c, off);
    take_min(k, c, k2, c2);
  }
}

__global__ void __launch_bounds__(kBlock) rescore_rows(In in, int row_threads) {
  __shared__ long long s_key[kBlock / 32];
  __shared__ int s_col[kBlock / 32];
  const int rows_per_block = kBlock / row_threads;
  const int r = blockIdx.x * rows_per_block + threadIdx.x / row_threads;
  const int lane = threadIdx.x % row_threads;
  const int C = in.C;
  long long best_key = kInvalid;
  int best_col = 0x7fffffff;
  if (r < in.W) {
    const long long rot = (long long)in.rotation[r];
    const size_t row = (size_t)r * C;
    for (int j = lane; j < C; j += row_threads) {
      if (!in.valid[row + j]) {
        take_min(best_key, best_col, kInvalid, j);
        continue;
      }
      const long long t = tta_of(in, row + j, j);
      const long long s = clip(in.score[row + j], -kScoreHalf, kScoreHalf - 1) + kScoreHalf;
      long long idx = ((long long)j - rot) % C;
      if (idx < 0) idx += C;
      const long long key = (t << kTtaShift) | ((kScoreMask - s) << kIdxBits) | idx;
      take_min(best_key, best_col, key, j);
    }
  }
  // every warp of the block reaches the shuffles (rows past W carry the
  // neutral element), so the full mask is right
  warp_min(best_key, best_col);
  if (row_threads > 32) {
    const int warp = threadIdx.x / 32;
    if ((threadIdx.x & 31) == 0) {
      s_key[warp] = best_key;
      s_col[warp] = best_col;
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      const int n_warps = row_threads / 32;
      best_key = threadIdx.x < n_warps ? s_key[threadIdx.x] : kInvalid;
      best_col = threadIdx.x < n_warps ? s_col[threadIdx.x] : 0x7fffffff;
      warp_min(best_key, best_col);
    }
  }
  if (lane != 0 || r >= in.W) return;
  const size_t row = (size_t)r * C;
  const bool has_best = best_key < kInvalid;
  const int best = has_best ? best_col : -1;
  const int cur = in.current[r];
  const int cur_col = cur < 0 ? 0 : (cur > C - 1 ? C - 1 : cur);
  const bool cur_valid = cur >= 0 && in.valid[row + cur_col];
  const int bcol = best < 0 ? 0 : best;
  const bool movable = cur_valid && has_best;
  const long long gain = movable ? tta_of(in, row + cur_col, cur_col) - tta_of(in, row + bcol, bcol)
                                 : 0;
  const bool rebalance = movable && best != cur && gain > in.hysteresis;
  const int W = in.W;
  in.out[r] = best;
  in.out[(size_t)W + r] = best_key;
  in.out[2 * (size_t)W + r] = gain;
  in.out[3 * (size_t)W + r] = rebalance ? 1 : 0;
}

}  // namespace
}  // namespace rescore

extern "C" int global_rescore(const void* tta, const void* score, const void* valid,
                              const void* current, const void* rotation, const void* degraded,
                              long long hysteresis, long long penalty, void* out, int W, int C,
                              void* stream) {
  if (W <= 0 || C <= 0) return (int)cudaGetLastError();
  rescore::In in{W, C, (const long long*)tta, (const long long*)score,
                 (const uint8_t*)valid, (const int*)current, (const int*)rotation,
                 (const uint8_t*)degraded, hysteresis, penalty, (long long*)out};
  const int row_threads = C > 1024 ? rescore::kRowThreads : 32;
  const int rows_per_block = rescore::kBlock / row_threads;
  const int blocks = (W + rows_per_block - 1) / rows_per_block;
  rescore::rescore_rows<<<blocks, rescore::kBlock, 0, (cudaStream_t)stream>>>(in, row_threads);
  return (int)cudaGetLastError();
}
