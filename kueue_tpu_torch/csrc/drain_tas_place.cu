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
//     children of the domains picked above.
// It writes tas_nom_ok[q] and the pods taken per leaf taken0[q, :]
// (zeros for queues whose head is not a TAS head: no decision reads
// them), then parks a quota-Fit TAS head whose placement failed and
// any head with a topology request on a non-TAS flavor (t_bad):
// is_fit, is_pre and pend, which phase 2 and the motion read.
//
// Design: one block of kThreads threads a queue, everything of a head
// in shared memory (256 threads: 512 measured 4% faster at
// tas-drain-10k's 100 queues, 1024 slower with a spill; at 256 two blocks
// share an SM where the queues outnumber the SMs).
//   - Totals: the host orders the leaves once so that every level's
//     domains are runs (ops/drain_kernel.tas_leaf_groups, built with the
//     merged forest); the block counts the leaves in that order and
//     prefix-sums them with warp shuffles, so a domain's total at any
//     level is P[end] - P[beg]: no atomics, and the split reuses them.
//   - The fit pass reduces (smallest fitting total, first index,
//     positive sum) in one pass a level, only at the levels the mode
//     reads, with one barrier for all of them.
//   - The split never sorts. The greedy covers `count` within its first
//     `count` positions (each taken domain adds at least one pod), so it
//     extracts the entries in (total desc, index asc) order one argmax
//     at a time until the covering one, then takes the BestFit jump as
//     an argmin over the rest: the full sort's answer, its fallback
//     included (position 0 of the full order, a masked entry when the
//     best `ok` total is below -1, or -1 with a larger index than the
//     smallest masked one). The entries are the children of the domains
//     picked above, gathered from the host's parent grouping, or every
//     domain of the fit level; one warp selects with shuffles up to 32
//     entries, else the block, a few entries a thread in registers.
//
// What bounds it: the serial depth of each block, not bytes. A head
// reads its flavor's leaves (Lf x Rt x 16 B: 32 KB at tas-drain-10k) and
// the domain runs of the levels it reads, and writes its taken row
// (8 KB); its time is the counting pass, one barrier for the fit
// levels and a few block reductions a split (one a pod taken, at most).
// Heads run in parallel, one block each. A set `done` flag makes the
// launch a no-op.

#include <climits>

#include "drain_common.cuh"
#include "tas_place.cuh"

namespace drain {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = kMaxTasND / kThreads;  // split entries a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = INT_MAX;

// Passed by value and never indexed at run time, so it stays in
// registers: the two pick lists are chosen by a select.
struct Smem {
  long long* P;      // [Lf+1] prefix of the counts in leaf order
  long long* alloc;  // [ND] dense allocation (the leaf level's; scratch)
  long long* v0;     // [ND] a level's picked domains: their pods,
  long long* v1;     //      in two lists (the level above, this level)
  int* j0;           // [ND] and their ids
  int* j1;
  int* ent;          // [ND] a split's entries (domain ids)
  __device__ __forceinline__ long long* pick_v(int x) const { return x ? v1 : v0; }
  __device__ __forceinline__ int* pick_j(int x) const { return x ? j1 : j0; }
};

struct Shared {  // the block's scalars and reduction slots
  long long req[kMaxTasR];
  long long fit_k[kMaxTasDepth][kWarps], fit_p[kMaxTasDepth][kWarps];
  int fit_i[kMaxTasDepth][kWarps];
  long long tot_l[kMaxTasDepth];
  int ok_l[kMaxTasDepth], idx_l[kMaxTasDepth];
  long long red_k[2][kWarps];
  int red_i[2][kWarps];
  long long scan[kWarps];
  long long first_k;  // a split's best entry
  int first_i, found, n_pick[2], n_ent, masked_min;
};

// (key desc, index asc): the order of jnp.lexsort((arange, -key))
__device__ __forceinline__ bool before(long long ka, int ia, long long kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ bool smaller(long long ka, int ia, long long kb, int ib) {
  return ka < kb || (ka == kb && ia < ib);
}

template <bool kMax>
__device__ __forceinline__ void warp_arg(long long& k, int& i) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long k2 = __shfl_xor_sync(kFull, k, o);
    const int i2 = __shfl_xor_sync(kFull, i, o);
    if (kMax ? before(k2, i2, k, i) : smaller(k2, i2, k, i)) {
      k = k2;
      i = i2;
    }
  }
}

__device__ __forceinline__ long long warp_sum(long long x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// argmax (kMax) or argmin over the block; every thread gets it. Calls
// alternate between two slot sets (`parity`), so one barrier a call.
template <bool kMax>
__device__ __forceinline__ void block_arg(long long& k, int& i, Shared& sh, int parity) {
  warp_arg<kMax>(k, i);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh.red_k[parity][w] = k;
    sh.red_i[parity][w] = i;
  }
  __syncthreads();
  k = sh.red_k[parity][0];
  i = sh.red_i[parity][0];
  for (int x = 1; x < kWarps; ++x) {
    const long long k2 = sh.red_k[parity][x];
    const int i2 = sh.red_i[parity][x];
    if (kMax ? before(k2, i2, k, i) : smaller(k2, i2, k, i)) {
      k = k2;
      i = i2;
    }
  }
}

// A split's entries held by one thread: kN (key, domain) pairs and the
// extracted ones.
template <int kN>
struct Items {
  long long key[kN];
  int j[kN];
  unsigned ext;
};

template <int kN>
__device__ __forceinline__ void local_max(const Items<kN>& it, long long& k, int& i) {
  k = LLONG_MIN;
  i = kNone;
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    if (!((it.ext >> u) & 1) && before(it.key[u], it.j[u], k, i)) {
      k = it.key[u];
      i = it.j[u];
    }
  }
}

// The greedy split's selection over the entries of `it` (the block's,
// kBlock, or warp 0's): extracts the entries in (total desc, index asc)
// order into pick (j, v) until one covers what is left of `cnt`, then
// appends the BestFit jump. sh.found says whether one covered (else the
// caller decides position 0 from sh.first_*); sh.n_pick[nx] the picks.
// Every thread of the scope calls it; the block's results are in `sh`
// after its last barrier, warp 0's after the caller's.
template <bool kBlock, int kN>
__device__ __forceinline__ void select(Items<kN>& it, long long cnt, int* pick_j,
                                       long long* pick_v, int nx, Shared& sh) {
  const bool lead = threadIdx.x == 0;
  long long acc = 0, rem_k = 0;
  int n_ext = 0, calls = 0;
  bool found = false;
  for (int iter = 0;; ++iter) {
    long long k;
    int i;
    local_max(it, k, i);
    if (kBlock) {
      block_arg<true>(k, i, sh, calls++ & 1);
    } else {
      warp_arg<true>(k, i);
    }
    if (i == kNone) break;  // no entry left
    if (iter == 0 && lead) {
      sh.first_k = k;
      sh.first_i = i;
    }
    const long long rem = cnt - acc;
    if (rem > 0 && k >= rem) {
      found = true;
      rem_k = rem;
      break;
    }
    if (rem <= 0 || k < 1) break;  // no later position can cover
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      if (it.j[u] == i) it.ext |= 1u << u;
    }
    if (lead) {
      pick_j[n_ext] = i;
      pick_v[n_ext] = k;  // k >= 1: max(k, 0)
    }
    acc += min(k, cnt);
    ++n_ext;
  }
  if (found) {
    // the BestFit jump: the smallest total >= rem_k after the extracted
    long long k = LLONG_MAX;
    int i = kNone;
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      if (!((it.ext >> u) & 1) && it.key[u] >= rem_k && smaller(it.key[u], it.j[u], k, i)) {
        k = it.key[u];
        i = it.j[u];
      }
    }
    if (kBlock) {
      block_arg<false>(k, i, sh, calls++ & 1);
    } else {
      warp_arg<false>(k, i);
    }
    if (lead) {
      pick_j[n_ext] = i;
      pick_v[n_ext] = rem_k;
    }
    ++n_ext;
  }
  if (lead) {
    sh.found = found;
    sh.n_pick[nx] = found ? n_ext : 0;
  }
}

// A domain's total at level d: the prefix difference over its run.
__device__ __forceinline__ long long total(const Args& a, Smem sm, int d, int j) {
  const size_t x = (size_t)d * a.ND + j;
  return sm.P[__ldg(a.tas.dom_end + x)] - sm.P[__ldg(a.tas.dom_beg + x)];
}

// One level's split into pick[nx]: the entries are every domain of the
// level (`all`) or sh.n_ent ids in sm.ent (the children of the domains
// picked at the level above, pick[nx ^ 1]). All threads call it.
__device__ __forceinline__ void split(const Args& a, Smem sm, Shared& sh, int d, bool all,
                                      long long cnt, int nx) {
  const int nd_d = a.tas.n_domains[d];
  if (threadIdx.x == 0) sh.first_i = kNone;
  __syncthreads();  // and gather_children's entries
  const int n = all ? nd_d : sh.n_ent;
  if (n <= 32) {
    if (threadIdx.x < 32) {
      Items<1> it;
      it.ext = 0;
      it.j[0] = kNone;
      it.key[0] = LLONG_MIN;
      if ((int)threadIdx.x < n) {
        it.j[0] = all ? (int)threadIdx.x : sm.ent[threadIdx.x];
        it.key[0] = total(a, sm, d, it.j[0]);
      }
      select<false>(it, cnt, sm.pick_j(nx), sm.pick_v(nx), nx, sh);
    }
  } else {
    Items<kItems> it;
    it.ext = 0;
#pragma unroll
    for (int u = 0; u < kItems; ++u) {
      const int e = threadIdx.x + u * kThreads;
      it.j[u] = kNone;
      it.key[u] = LLONG_MIN;
      if (e < n) {
        it.j[u] = all ? e : sm.ent[e];
        it.key[u] = total(a, sm, d, it.j[u]);
      }
    }
    select<true>(it, cnt, sm.pick_j(nx), sm.pick_v(nx), nx, sh);
  }
  __syncthreads();
  if (sh.found) return;
  // nothing covered: position 0 of the full order takes max(cnt, 0). It
  // is a masked entry (key -1, nothing written) when some entry is
  // masked and the best ok key is below -1, or -1 at a larger index.
  const bool masked = n < nd_d;
  bool first_wins = sh.first_i != kNone && cnt > 0;
  if (first_wins && masked && sh.first_k <= -1) {
    if (sh.first_k < -1) {
      first_wins = false;
    } else {
      // the smallest masked index: a domain whose parent took nothing
      const int* pj = sm.pick_j(nx ^ 1);
      const long long* pv = sm.pick_v(nx ^ 1);
      for (int j = threadIdx.x; j < a.ND; j += kThreads) sm.alloc[j] = 0;
      if (threadIdx.x == 0) sh.masked_min = kNone;
      __syncthreads();
      for (int e = threadIdx.x; e < sh.n_pick[nx ^ 1]; e += kThreads) sm.alloc[pj[e]] = pv[e];
      __syncthreads();
      int mn = kNone;
      for (int j = threadIdx.x; j < nd_d; j += kThreads) {
        const int pm = max(a.tas.parent_map[(size_t)d * a.ND + j], 0);
        if (sm.alloc[pm] <= 0) mn = min(mn, j);
      }
      for (int o = 16; o > 0; o >>= 1) mn = min(mn, __shfl_xor_sync(kFull, mn, o));
      if ((threadIdx.x & 31) == 0) atomicMin(&sh.masked_min, mn);
      __syncthreads();
      first_wins = sh.first_i < sh.masked_min;
    }
  }
  if (threadIdx.x == 0) {
    sh.n_pick[nx] = first_wins ? 1 : 0;
    sm.pick_j(nx)[0] = sh.first_i;
    sm.pick_v(nx)[0] = cnt;
  }
  __syncthreads();
}

// The children (at level d) of the domains picked at the level above
// with pods > 0, into sm.ent / sh.n_ent (warp 0; the caller syncs).
__device__ __forceinline__ void gather_children(const Args& a, Smem sm, Shared& sh, int d,
                                                int px) {
  const int lane = threadIdx.x;
  const int n_prev = sh.n_pick[px];
  const int* off = a.tas.child_off + (size_t)d * (a.ND + 1);
  const int* list = a.tas.child_list + (size_t)d * a.ND;
  int base = 0;
  for (int c0 = 0; c0 < n_prev; c0 += 32) {
    const int e = c0 + lane;
    int lo = 0, hi = 0;
    if (e < n_prev && sm.pick_v(px)[e] > 0) {
      const int p = sm.pick_j(px)[e];
      lo = __ldg(off + p);
      hi = __ldg(off + p + 1);
    }
    const int c = hi - lo;
    int incl = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int at = base + incl - c;
    for (int x = 0; x < c; ++x) sm.ent[at + x] = __ldg(list + lo + x);
    base += __shfl_sync(kFull, incl, 31);
  }
  if (lane == 0) sh.n_ent = base;
}

__global__ void __launch_bounds__(kThreads, 1) place(Args a) {
  if (*a.s.done) return;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Shared sh;
  const int q = blockIdx.x;
  const int ND = a.ND, Lf = a.Lf, Rt = a.Rt, Dt = a.Dt;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  Smem sm;
  {
    long long* base = (long long*)smem_raw;
    sm.P = base;
    sm.alloc = sm.P + Lf + 1;
    sm.v0 = sm.alloc + ND;
    sm.v1 = sm.v0 + ND;
    sm.j0 = (int*)(sm.v1 + ND);
    sm.j1 = sm.j0 + ND;
    sm.ent = sm.j1 + ND;
  }

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
    for (int r = tid; r < Rt; r += kThreads) sh.req[r] = a.tas.t_req[e * Rt + r];
    __syncthreads();
    // 1. the counts in leaf order, then their prefix (a thread a run)
#pragma unroll 4
    for (int p = tid; p < Lf; p += kThreads) {
      const int i = __ldg(a.tas.leaf_order + p);
      long long c = 0;
      if (__ldg(a.tas.leaf_flavor + i) == flavor) {
        c = tas_place::leaf_count(sh.req, Rt, [&](int r) {
          const size_t x = (size_t)i * Rt + r;
          return __ldg(a.tas.topo_free + x) - a.tas.tas_u[x];
        });
        c = max(min(c, tas_place::kMaxCount), tas_place::kFloor);
      }
      sm.P[p + 1] = c;
    }
    __syncthreads();
    {
      const int chunk = (Lf + kThreads - 1) / kThreads;
      const int pb = min(Lf, tid * chunk), pe = min(Lf, pb + chunk);
      long long run = 0;
      for (int p = pb; p < pe; ++p) run += sm.P[p + 1];
      long long incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      if (lane == 31) sh.scan[w] = incl;
      __syncthreads();
      long long acc = incl - run;
      for (int x = 0; x < w; ++x) acc += sh.scan[x];
      for (int p = pb; p < pe; ++p) {
        acc += sm.P[p + 1];
        sm.P[p + 1] = acc;
      }
      if (tid == 0) sm.P[0] = 0;
    }
    __syncthreads();

    // 2. the levels the mode reads: the BestFit pick, any fit, the
    // positive total, in one pass a level and one barrier for all
    const int lc = min(max(level, 0), Dt - 1), tc = min(max(top, 0), Dt - 1);
    for (int d = 0; d < Dt; ++d) {
      const bool need = mode == 1 ? ((d >= top && d <= level) || d == tc) : d == lc;
      if (!need) continue;
      const int nd_d = a.tas.n_domains[d];
      long long bk = LLONG_MAX, pos = 0;
      int bi = kNone;
#pragma unroll 4
      for (int j = tid; j < nd_d; j += kThreads) {
        const long long s = total(a, sm, d, j);
        if (s >= cnt && s < bk) {  // j rises: the first index among equals
          bk = s;
          bi = j;
        }
        pos += max(s, 0LL);
      }
      warp_arg<false>(bk, bi);
      pos = warp_sum(pos);
      if (lane == 0) {
        sh.fit_k[d][w] = bk;
        sh.fit_i[d][w] = bi;
        sh.fit_p[d][w] = pos;
      }
    }
    __syncthreads();
    if (tid < Dt) {
      const int d = tid;
      long long bk = LLONG_MAX, pos = 0;
      int bi = kNone;
      const bool need = mode == 1 ? ((d >= top && d <= level) || d == tc) : d == lc;
      if (need) {
        for (int x = 0; x < kWarps; ++x) {
          if (smaller(sh.fit_k[d][x], sh.fit_i[d][x], bk, bi)) {
            bk = sh.fit_k[d][x];
            bi = sh.fit_i[d][x];
          }
          pos += sh.fit_p[d][x];
        }
      }
      sh.ok_l[d] = bi != kNone;
      sh.idx_l[d] = bi != kNone ? bi : 0;
      sh.tot_l[d] = pos;
    }
    __syncthreads();

    int pref_level = -1;
    for (int d = 0; d < Dt; ++d) {
      if (sh.ok_l[d] && d <= level && d >= top) pref_level = d;
    }
    const bool pref_found = pref_level >= 0;
    bool multi = false;
    int fit_level = level;
    if (mode == 1) {
      fits = pref_found || sh.tot_l[tc] >= cnt;
      multi = !pref_found;
      fit_level = pref_found ? pref_level : top;
    } else if (mode == 2) {
      fits = sh.ok_l[lc] || sh.tot_l[lc] >= cnt;
      multi = !sh.ok_l[lc];
    } else {
      fits = sh.ok_l[lc];
    }

    if (fits) {
      // 3. seed at the fit level, then split down among the children of
      // the domains picked at the level above
      int nx = 0;
      if (tid == 0) sh.n_pick[1] = 0;
      for (int d = max(fit_level, 0); d < Dt; ++d) {
        if (d == fit_level && !multi) {
          if (tid == 0) {
            sm.pick_j(nx)[0] = sh.idx_l[d];
            sm.pick_v(nx)[0] = cnt;
            sh.n_pick[nx] = 1;
          }
          __syncthreads();
        } else {
          const bool all = d == fit_level;
          if (!all && tid < 32) gather_children(a, sm, sh, d, nx ^ 1);
          split(a, sm, sh, d, all, cnt, nx);
        }
        nx ^= 1;
      }
      // pick[nx ^ 1] holds the leaf level's allocation (nothing when the
      // fit level lies below the forest)
      const int px = nx ^ 1;
      const int n_last = fit_level < Dt ? sh.n_pick[px] : 0;
      for (int j = tid; j < ND; j += kThreads) sm.alloc[j] = 0;
      __syncthreads();
      for (int x = tid; x < n_last; x += kThreads) sm.alloc[sm.pick_j(px)[x]] = sm.pick_v(px)[x];
      __syncthreads();
      const int* seg_last = a.tas.seg_ids + (size_t)(Dt - 1) * Lf;
      for (int i = tid; i < Lf; i += kThreads) taken[i] = sm.alloc[__ldg(seg_last + i)];
    }
  }
  if (!fits) {
    for (int i = tid; i < Lf; i += kThreads) taken[i] = 0;
  }
  if (tid == 0) {
    const bool bad = a.tas.t_bad[(size_t)q * a.L + cur] && active;
    const bool parked = (tas_head && a.b.is_fit[q] && !fits) || bad;
    a.tas.tas_nom_ok[q] = fits;
    a.b.is_fit[q] = a.b.is_fit[q] && !parked;
    a.b.is_pre[q] = a.b.is_pre[q] && !bad;
    a.b.pend[q] = a.b.pend[q] && !parked;
  }
}

size_t smem_bytes(const Args& a) {
  return sizeof(long long) * ((size_t)a.Lf + 1 + 3 * (size_t)a.ND) +
         sizeof(int) * 3 * (size_t)a.ND;
}

}  // namespace
}  // namespace drain

extern "C" int drain_tas_place(const int* ints, int n_ints, void* const* ptrs, int n_ptrs,
                               void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.tas.topo_free == nullptr || a.tas.leaf_order == nullptr || a.Dt < 1 ||
      a.Dt > drain::kMaxTasDepth || a.Rt > drain::kMaxTasR || a.ND > drain::kMaxTasND ||
      a.Lf < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.Q == 0) return (int)cudaGetLastError();
  const size_t smem = drain::smem_bytes(a);
  if (smem + sizeof(drain::Shared) > 48 * 1024) {  // the static part counts too
    cudaError_t rc = cudaFuncSetAttribute(
        drain::place, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  drain::place<<<a.Q, drain::kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
