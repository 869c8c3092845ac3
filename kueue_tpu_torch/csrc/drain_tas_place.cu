// Kernel B13a, drain_tas_place: the TAS drain's nomination placement.
//
// Replaces the vmapped _tas_fit_and_place of solve_drain_tas
// (kueue_tpu/ops/drain_kernel.py:689-872, called at :975-981) and the
// parks after it (:982-991). Every TAS head (a queue of TAS workloads
// with entries left) is placed against the CYCLE-START TAS leaf usage
// with the reference's phase-2 greedy, BestFit profile, in all three
// modes:
//   - counts per leaf of the head's flavor (others 0): the truncating
//     min over requested resources of (free - usage) / request,
//     clipped at 2^31-1 and floored at -(2^40);
//   - per level the domain totals (segment sums, -1 past the level's
//     domains), the BestFit pick (the smallest total >= count, first
//     index among equals, 0 when none), any fit, and the positive
//     total;
//   - fits / multi-domain / fit level by mode (Required: one domain at
//     the level; Preferred: the deepest single fit between the
//     flavor's top and the level, else the multi-domain take at the
//     top; Unconstrained: one leaf-level domain, else the take there);
//   - the allocation seeded at the fit level (the pick capped at count,
//     or the greedy split), then split down level by level among the
//     children of the domains picked above (tas_place.cuh).
// It writes tas_nom_ok[q] and the pods taken per leaf taken0[q, :]
// (zeros for queues whose head is not a TAS head: no decision reads
// them), then parks a quota-Fit TAS head whose placement failed and
// any head with a topology request on a non-TAS flavor (t_bad):
// is_fit, is_pre and pend, which phase 2 and the motion read.
//
// One block of 256 threads per queue. Shared memory (dynamic): the
// leaf counts, one level's totals, the allocation rows of the level
// above and of this level, the sort's keys, indices and prefix (the
// next power of two of ND), and the split's mask: 90 KB at the
// lowering's cap of ND = Lf = 2048, 45 KB at tas-drain-10k's 1024.
//
// What bounds it: the serial depth of each block, not bytes. A head
// reads its flavor's leaves (Lf x Rt x 16 B: 32 KB at tas-drain-10k),
// the segment ids and parent map, and writes its taken row (8 KB);
// its time is the per-level passes and, for each split, a bitonic sort
// of ND keys (55 synchronised stages at ND = 1024). Heads run in
// parallel, one block each. A set `done` flag makes the launch a no-op.

#include "drain_common.cuh"
#include "tas_place.cuh"

namespace drain {
namespace {

using tas_place::kThreads;

struct Smem {
  long long* counts;  // [Lf]
  long long* row;     // [ND] one level's totals
  long long* prev;    // [ND] allocation at the level above
  long long* cur;     // [ND]
  uint8_t* ok;        // [ND]
  tas_place::Scratch w;
};

__device__ int p2_of(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// one level's domain totals into sm.row: the leaf counts summed per
// domain, -1 past the level's domains
__device__ void level_totals(const Args& a, int d, const Smem& sm) {
  const int nd_d = a.tas.n_domains[d];
  for (int j = threadIdx.x; j < a.ND; j += kThreads) sm.row[j] = j < nd_d ? 0 : -1;
  __syncthreads();
  for (int i = threadIdx.x; i < a.Lf; i += kThreads) {
    const int s = a.tas.seg_ids[(size_t)d * a.Lf + i];
    if (s >= 0 && s < nd_d) {
      atomicAdd((unsigned long long*)&sm.row[s], (unsigned long long)sm.counts[i]);
    }
  }
  __syncthreads();
}

__global__ void place(Args a) {
  if (*a.s.done) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q = blockIdx.x;
  const int ND = a.ND, Lf = a.Lf, Rt = a.Rt, Dt = a.Dt;
  const int p2 = p2_of(ND);
  Smem sm;
  {
    long long* base = (long long*)smem_raw;
    sm.counts = base;
    sm.row = sm.counts + Lf;
    sm.prev = sm.row + ND;
    sm.cur = sm.prev + ND;
    sm.w.key = sm.cur + ND;
    sm.w.prefix = sm.w.key + p2;
    sm.w.totals = sm.w.prefix + p2;
    sm.w.red = (tas_place::Reduce*)(sm.w.totals + kThreads);
    sm.w.idx = (int*)(sm.w.red + 1);
    sm.ok = (uint8_t*)(sm.w.idx + p2);
  }
  __shared__ long long req[kMaxTasR];
  __shared__ long long total_l[kMaxTasDepth];
  __shared__ int ok_l[kMaxTasDepth], idx_l[kMaxTasDepth];

  const int cur = min(a.s.cursor[q], a.L - 1);
  const bool active = a.s.cursor[q] < a.q.qlen[q] && a.s.alive[q];
  const bool tas_head = a.tas.t_is[q] && active;
  long long* taken = a.tas.taken0 + (size_t)q * Lf;
  bool fits = false;

  if (tas_head) {
    const size_t e = (size_t)q * a.L + cur;
    const long long cnt = a.tas.t_count[e];
    const int level = a.tas.t_level[e], mode = a.tas.t_mode[e];
    const int top = a.tas.t_top[q], flavor = a.tas.t_flavor[q];
    for (int r = threadIdx.x; r < Rt; r += kThreads) req[r] = a.tas.t_req[e * Rt + r];
    __syncthreads();
    for (int i = threadIdx.x; i < Lf; i += kThreads) {
      long long c = 0;
      if (a.tas.leaf_flavor[i] == flavor) {
        c = tas_place::leaf_count(req, Rt, [&](int r) {
          const size_t x = (size_t)i * Rt + r;
          return a.tas.topo_free[x] - a.tas.tas_u[x];
        });
        c = max(min(c, tas_place::kMaxCount), tas_place::kFloor);
      }
      sm.counts[i] = c;
    }
    __syncthreads();

    // per level: the BestFit pick, any fit, the positive total
    for (int d = 0; d < Dt; ++d) {
      level_totals(a, d, sm);
      const int nd_d = a.tas.n_domains[d];
      long long mval = tas_place::kInf, pos = 0;
      for (int j = threadIdx.x; j < nd_d; j += kThreads) {
        const long long s = sm.row[j];
        if (s >= cnt) mval = min(mval, s);
        pos += max(s, 0LL);
      }
      mval = tas_place::block_reduce<0>(mval, sm.w.red);
      pos = tas_place::block_reduce<1>(pos, sm.w.red);
      long long first = ND;
      for (int j = threadIdx.x; j < nd_d; j += kThreads) {
        const long long s = sm.row[j];
        if (s >= cnt && s == mval) first = min(first, (long long)j);
      }
      first = tas_place::block_reduce<0>(first, sm.w.red);
      if (threadIdx.x == 0) {
        ok_l[d] = first < ND;
        idx_l[d] = first < ND ? (int)first : 0;
        total_l[d] = pos;
      }
    }
    __syncthreads();

    const int lc = min(max(level, 0), Dt - 1), tc = min(max(top, 0), Dt - 1);
    int pref_level = -1;
    for (int d = 0; d < Dt; ++d) {
      if (ok_l[d] && d <= level && d >= top) pref_level = d;
    }
    const bool pref_found = pref_level >= 0;
    bool multi = false;
    int fit_level = level;
    if (mode == 1) {
      fits = pref_found || total_l[tc] >= cnt;
      multi = !pref_found;
      fit_level = pref_found ? pref_level : top;
    } else if (mode == 2) {
      fits = ok_l[lc] || total_l[lc] >= cnt;
      multi = !ok_l[lc];
    } else {
      fits = ok_l[lc];
    }

    if (fits) {
      // seed at the fit level, then split down among the children of
      // the domains picked at the level above
      for (int d = 0; d < Dt; ++d) {
        if (d < fit_level) continue;
        level_totals(a, d, sm);
        const int nd_d = a.tas.n_domains[d];
        if (d == fit_level && !multi) {
          for (int j = threadIdx.x; j < ND; j += kThreads) {
            sm.cur[j] = j == idx_l[d] ? cnt : 0;
          }
        } else {
          for (int j = threadIdx.x; j < ND; j += kThreads) {
            bool ok = j < nd_d;
            if (d > fit_level) {
              const int pm = max(a.tas.parent_map[(size_t)d * ND + j], 0);
              ok = ok && sm.prev[pm] > 0;
            }
            sm.ok[j] = ok;
          }
          __syncthreads();
          tas_place::split(sm.row, sm.ok, cnt, ND, p2, sm.cur, sm.w);
        }
        __syncthreads();
        long long* t = sm.prev;
        sm.prev = sm.cur;
        sm.cur = t;
      }
      // sm.prev holds the leaf level's allocation (zeros when the fit
      // level lies below the forest)
      const bool placed = fit_level < Dt;
      for (int i = threadIdx.x; i < Lf; i += kThreads) {
        const int s = a.tas.seg_ids[(size_t)(Dt - 1) * Lf + i];
        taken[i] = placed ? sm.prev[s] : 0;
      }
    }
  }
  if (!fits) {
    for (int i = threadIdx.x; i < Lf; i += kThreads) taken[i] = 0;
  }
  if (threadIdx.x == 0) {
    const bool bad = a.tas.t_bad[(size_t)q * a.L + cur] && active;
    const bool parked = (tas_head && a.b.is_fit[q] && !fits) || bad;
    a.tas.tas_nom_ok[q] = fits;
    a.b.is_fit[q] = a.b.is_fit[q] && !parked;
    a.b.is_pre[q] = a.b.is_pre[q] && !bad;
    a.b.pend[q] = a.b.pend[q] && !parked;
  }
}

size_t smem_bytes(const Args& a) {
  int p2 = 1;
  while (p2 < a.ND) p2 <<= 1;
  return sizeof(long long) * ((size_t)a.Lf + 3 * (size_t)a.ND + 2 * (size_t)p2 + kThreads) +
         sizeof(tas_place::Reduce) + sizeof(int) * (size_t)p2 + (size_t)a.ND;
}

}  // namespace
}  // namespace drain

extern "C" int drain_tas_place(const int* ints, int n_ints, void* const* ptrs, int n_ptrs,
                               void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.tas.topo_free == nullptr || a.Dt < 1 || a.Dt > drain::kMaxTasDepth ||
      a.Rt > drain::kMaxTasR || a.ND > drain::kMaxTasND || a.Lf < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.Q == 0) return (int)cudaGetLastError();
  const size_t smem = drain::smem_bytes(a);
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        drain::place, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  drain::place<<<a.Q, drain::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
