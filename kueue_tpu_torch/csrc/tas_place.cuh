// Helpers of the TAS kernels. The CountIn of one leaf (leaf_count),
// shared by the pod counting (tas_leaf_counts.cu), the placement
// (drain_tas_place.cu) and the global scan's re-validation
// (drain_tas_phase2.cu); and the block-wide helpers of the placement:
// the reductions, the exclusive scan, the bitonic sort and the greedy
// split of kueue_tpu/ops/drain_kernel.py _tas_fit_and_place
// (:689-872). Every block-wide helper is called by all threads of the
// block and ends with the block synchronised.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tas_place {

constexpr long long kInf = 1LL << 62;
constexpr long long kMaxCount = (1LL << 31) - 1;
constexpr long long kFloor = -(1LL << 40);
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

struct Reduce {
  long long v[kWarps];
};

// min (op 0), sum (op 1) of one value a thread over the block; every
// thread gets the result.
template <int Op>
__device__ long long block_reduce(long long x, Reduce* sh) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long y = __shfl_down_sync(0xffffffffu, x, o);
    x = Op == 0 ? min(x, y) : x + y;
  }
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // sh may still be read by the previous call
  if (lane == 0) sh->v[w] = x;
  __syncthreads();
  long long r = sh->v[0];
  for (int i = 1; i < kWarps; ++i) r = Op == 0 ? min(r, sh->v[i]) : r + sh->v[i];
  return r;
}

// In-place exclusive prefix sum of a[0, n) (shared memory): each
// thread sums a contiguous chunk, the chunk totals are scanned, then
// each chunk is rewritten.
__device__ void exclusive_scan(long long* a, int n, Reduce* sh, long long* totals) {
  const int t = threadIdx.x;
  const int chunk = (n + kThreads - 1) / kThreads;
  const int beg = min(n, t * chunk), end = min(n, beg + chunk);
  long long s = 0;
  for (int i = beg; i < end; ++i) s += a[i];
  totals[t] = s;
  __syncthreads();
  if (t == 0) {
    long long acc = 0;
    for (int i = 0; i < kThreads; ++i) {
      const long long v = totals[i];
      totals[i] = acc;
      acc += v;
    }
  }
  __syncthreads();
  long long acc = totals[t];
  for (int i = beg; i < end; ++i) {
    const long long v = a[i];
    a[i] = acc;
    acc += v;
  }
  __syncthreads();
}

// (key desc, index asc) — jnp.lexsort((arange, -key))
__device__ __forceinline__ bool before(long long ka, int ia, long long kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

// Bitonic sort of p2 (a power of two) (key, index) pairs into the
// `before` order.
__device__ void bitonic_sort(long long* key, int* idx, int p2) {
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2; i += kThreads) {
        const int x = i ^ j;
        if (x > i) {
          const bool up = (i & k) == 0;
          const bool swap = up ? before(key[x], idx[x], key[i], idx[i])
                               : before(key[i], idx[i], key[x], idx[x]);
          if (swap) {
            const long long tk = key[i];
            key[i] = key[x];
            key[x] = tk;
            const int ti = idx[i];
            idx[i] = idx[x];
            idx[x] = ti;
          }
        }
      }
      __syncthreads();
    }
  }
}

struct Scratch {
  long long* key;     // [p2] sorted states
  int* idx;           // [p2] their domain index
  long long* prefix;  // [p2]
  long long* totals;  // [kThreads]
  Reduce* red;
};

// The greedy split (drain_kernel.py:806-838): the masked states
// (`ok[j]`, else -1) in (state desc, index asc) order take `cnt` pods
// greedily, the covering position jumping to the BestFit domain; the
// prefix runs on states clamped to [0, cnt] in int64 (the reference's
// clamp, its int32 width dropped). Nothing covered makes position 0
// take the whole remainder, as the reference's argmax does. Writes
// out[j] for j < nd (0 where !ok[j]).
__device__ void split(const long long* s, const uint8_t* ok, long long cnt, int nd, int p2,
                      long long* out, const Scratch& w) {
  for (int p = threadIdx.x; p < p2; p += kThreads) {
    w.key[p] = p < nd ? (ok[p] ? s[p] : -1) : LLONG_MIN;
    w.idx[p] = p;
  }
  __syncthreads();
  bitonic_sort(w.key, w.idx, p2);
  for (int p = threadIdx.x; p < p2; p += kThreads) {
    const long long v = p < nd ? w.key[p] : 0;
    w.prefix[p] = min(max(v, 0LL), cnt);
  }
  __syncthreads();
  exclusive_scan(w.prefix, p2, w.red, w.totals);
  // k: the first covered position (0 when none)
  long long first = nd;
  for (int p = threadIdx.x; p < nd; p += kThreads) {
    const long long rem = cnt - w.prefix[p];
    if (rem > 0 && w.key[p] >= rem) first = min(first, (long long)p);
  }
  first = block_reduce<0>(first, w.red);
  const int k = first < nd ? (int)first : 0;
  const long long rem_k = max(cnt - w.prefix[k], 0LL);
  // the BestFit jump: the smallest state >= rem_k at or after k
  long long mval = kInf;
  for (int p = threadIdx.x; p < nd; p += kThreads) {
    const long long v = w.key[p];
    if (p >= k && v >= rem_k && rem_k > 0) mval = min(mval, v);
  }
  mval = block_reduce<0>(mval, w.red);
  long long jfirst = nd;
  for (int p = threadIdx.x; p < nd; p += kThreads) {
    const long long v = w.key[p];
    if (p >= k && v >= rem_k && rem_k > 0 && v == mval) jfirst = min(jfirst, (long long)p);
  }
  jfirst = block_reduce<0>(jfirst, w.red);
  const int jstar = jfirst < nd ? (int)jfirst : 0;
  for (int p = threadIdx.x; p < nd; p += kThreads) {
    long long take = p < k ? max(w.key[p], 0LL) : 0;
    if (p == jstar) take = rem_k;
    const int j = w.idx[p];
    out[j] = ok[j] ? take : 0;
  }
  __syncthreads();
}

}  // namespace tas_place
