// Kernel B13b, drain_tas_phase2: the TAS drain's global step scan.
//
// Replaces phase 2 of kueue_tpu/ops/drain_kernel.py solve_drain_tas
// (:993-1107): the entry-order jnp.lexsort over every queue's head
// (not per root cohort: a shared topology couples ClusterQueues across
// cohorts), then the lax.scan of n_steps steps, then the leaf-usage
// add of the admitted heads.
//
// One block of 16 warps for the whole cycle:
//   1. stages every queue's sort key in shared memory (ranked: Fit or
//      preempt-mode, active, on a ClusterQueue; borrowing; the priority
//      and timestamp of its entry at min(cursor, L-1); its ClusterQueue
//      row and ancestor path; the keys stay in device memory when Q is
//      too wide for them), and the live leaf headroom topo_free - tas_u
//      of every leaf (in device memory when Lf x Rt is too wide);
//   2. ranks each ranked queue by (borrowing asc, priority desc,
//      timestamp asc, queue index asc), a warp a queue, the lanes
//      counting its predecessors, branchless; ranks >= n_steps are
//      dropped as the JAX scatter drops them;
//   3. puts the quota rows of the walked heads' paths in shared memory,
//      deduplicated (drain_walk.cuh's stage_rows; device rows when they
//      do not fit);
//   4. warps 1-15 stage each walked head, in rank order, into a ring of
//      slots: its merged cells and quantities, its path's rows, its
//      flags, its per-pod request, and its nominated leaves compacted
//      from the taken0 row into entries of a headroom cell (a leaf and a
//      resource) and the charge taken x request there (a ballot and a
//      prefix count a 32-leaf chunk; a head with more entries than a
//      slot holds keeps reading its taken0 row). A slot is published
//      with a tag; a producer reuses it once warp 0 has walked its head;
//   5. warp 0 walks the heads in rank order with no block barrier, each
//      step on shared memory: drain_walk.cuh's quota step (admit when
//      quota-Fit, the quota fits and the leaves hold; else the
//      preempt-mode reservation with its caps; the usage bubble), the
//      leaf gate voted with its quota fit (every nominated leaf must
//      still hold its pods against the live headroom:
//      trunc((free - usage) / request) >= taken for each requested
//      resource, tested as (free - usage) >= taken x request, an
//      overflowing product failing the head, which is the same, a
//      lane an entry), then the admitted head's charge into the headroom
//      of its entries;
//   6. writes back the usage rows and tas_u, adds the admitted
//      quantities to their queues' leaf rows, sets `admitted` and
//      records each admission's step in adm_step.
// The TAS leaf usage stays on the card across cycles.
//
// What bounds it: the serial chain of steps (each head sees its
// predecessors' admissions, charges and reservations); a shared
// topology couples every head, so the chain is every walked head:
// (a gate, the path walk, a charge) a head, ~80 heads a cycle at
// tas-drain-10k. The bytes bound (the taken rows, ~650 KB a launch
// there) is a fraction of a microsecond. Staging overlaps the walk. A
// set `done` flag makes the launch a no-op.

#include "drain_common.cuh"
#include "drain_walk.cuh"

namespace drain {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 32;    // heads the ring of staged operands holds
constexpr int kEntryCap = 128;  // (headroom cell, charge) entries a slot holds
constexpr int kUnroll = 8;    // taken-row chunks a lane loads at once
constexpr int kSmemMax = 232448 - 1024;  // a block's opt-in shared memory (sm_90),
                                          // less room for the static scalars

// Byte offsets of the dynamic shared memory (multiples of 8), set by
// the host; -1 for a part that is not staged.
struct Layout {
  int kf, kp, kt, kc, kpath;  // queue keys: flags, priority, timestamp, ClusterQueue row, path
  int walk;                   // int32[Q]: the walked queues by rank
  int adm;                    // uint8[Q]: admitted, by rank
  int ring;                   // the drain window of `slots` heads
  int tring;                  // the ring's TAS part
  int room;                   // int64[Lf, Rt]: the live leaf headroom
  int rows, rows_bytes;       // the walk's rows
  int slots, cap;
  int keys;                   // 1 when the queue keys are staged
  int total;
};

// The TAS part of a slot: its publication tag (rank + 1), queue, entry
// count (-1: more than `cap`, read the taken0 row), whether a requested
// charge overflowed (the head's leaves cannot hold), per-pod request and
// entries: the headroom cell leaf x Rt + resource (~cell for a resource
// that is not requested: charged, never gated) and its charge.
struct TasRing {
  int* tag;
  int* head;
  int* ne;
  int* fail;
  long long* req;   // [slots, Rt]
  int* ex;          // [slots, cap]
  long long* ec;    // [slots, cap]
};

// A slot's tag: published by its producer with a release store after
// its writes, read by warp 0 with acquire loads until it names the head.
__device__ __forceinline__ void publish(int* tag, int v) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(tag);
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(at), "r"(v) : "memory");
}

__device__ __forceinline__ void await(const int* tag, int v) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(tag);
  int got;
  do {
    asm volatile("ld.acquire.cta.shared.b32 %0, [%1];" : "=r"(got) : "r"(at) : "memory");
  } while (got != v);
}

__host__ __device__ inline int tas_ring_bytes(int slots, int rt, int cap) {
  return 16 * slots + 8 * slots * rt + align8(4LL * slots * cap) + 8 * slots * cap;
}

__device__ __forceinline__ TasRing tas_ring(int off, int slots, int rt, int cap) {
  unsigned char* base = smem + off;
  TasRing t;
  t.tag = (int*)base;
  t.head = t.tag + slots;
  t.ne = t.head + slots;
  t.fail = t.ne + slots;
  t.req = (long long*)(base + 16 * slots);
  t.ex = (int*)(t.req + (size_t)slots * rt);
  t.ec = (long long*)((unsigned char*)t.ex + align8(4LL * slots * cap));
  return t;
}

// Queue x's cursor entry, ranked flag (1) and borrow bit (2), priority,
// timestamp, ClusterQueue row and path node at level d: staged, else
// from device memory.
template <bool kKeys>
struct Keys {
  static __device__ __forceinline__ int cur(const Args& a, int x) {
    return min(__ldg(a.s.cursor + x), a.L - 1);
  }
  static __device__ __forceinline__ int flags(const Args& a, const Layout& L, int x) {
    if (kKeys) return smem[L.kf + x];
    const int c = __ldg(a.s.cursor + x);
    const bool ranked = (__ldg(a.b.is_fit + x) | __ldg(a.b.is_pre + x)) &&
                        c < __ldg(a.q.qlen + x) && __ldg(a.s.alive + x) &&
                        __ldg(a.q.cq_rows + x) >= 0;
    return (ranked ? 1 : 0) | (__ldg(a.b.head_borrow + x) ? 2 : 0);
  }
  static __device__ __forceinline__ long long prio(const Args& a, const Layout& L, int x) {
    return kKeys ? ((const long long*)(smem + L.kp))[x]
                 : __ldg(a.q.priority + (size_t)x * a.L + cur(a, x));
  }
  static __device__ __forceinline__ long long ts(const Args& a, const Layout& L, int x) {
    return kKeys ? ((const long long*)(smem + L.kt))[x]
                 : __ldg(a.q.timestamp + (size_t)x * a.L + cur(a, x));
  }
  static __device__ __forceinline__ int cq(const Args& a, const Layout& L, int x) {
    return kKeys ? ((const int*)(smem + L.kc))[x] : max(__ldg(a.q.cq_rows + x), 0);
  }
  static __device__ __forceinline__ int path(const Args& a, const Layout& L, int x, int d) {
    return kKeys ? ((const int*)(smem + L.kpath))[x * (a.D + 1) + d]
                 : __ldg(a.t.paths + (size_t)cq(a, L, x) * (a.D + 1) + d);
  }
};

// The live headroom of headroom cell x (leaf x Rt + resource): H in
// shared memory (kRoom), else topo_free - tas_u in device memory.
template <bool kRoom>
__device__ __forceinline__ long long headroom(const Args& a, const long long* H, size_t x) {
  if constexpr (kRoom) return H[x];
  else return __ldg(a.tas.topo_free + x) - __ldcg(a.tas.tas_u + x);
}

// Charge chg into headroom cell x.
template <bool kRoom>
__device__ __forceinline__ void charge(const Args& a, long long* H, size_t x, long long chg) {
  if constexpr (kRoom) H[x] -= chg;
  else a.tas.tas_u[x] += chg;
}

// Whether a leaf still holds tk pods of the per-pod request rq: for
// every requested resource headroom >= tk x rq, the product taken as
// too large when it overflows. That is tas_place::leaf_count(rq, Rt,
// headroom) >= tk: for rq > 0 and tk > 0, trunc(headroom / rq) >= tk
// exactly when headroom >= tk x rq.
template <bool kRoom>
__device__ __forceinline__ bool leaf_holds(const Args& a, const long long* H,
                                           const long long* rq, int leaf, long long tk) {
  bool ok = true;
  for (int j = 0; j < a.Rt; ++j) {
    const long long q = rq[j];
    if (q <= 0) continue;
    const long long lo = tk * q;
    const bool over = __mul64hi(tk, q) != 0 || lo < 0;
    ok &= !over && headroom<kRoom>(a, H, (size_t)leaf * a.Rt + j) >= lo;
  }
  return ok;
}

// Stage walked head r into slot s of the ring, one warp.
template <bool kKeys>
__device__ __forceinline__ void stage_head(const Args& a, const Layout& L, const int* walk,
                                           const int* ent_slot, int r, int s, int lane) {
  using K = Keys<kKeys>;
  const int PC = a.P * a.C, D1 = a.D + 1, Rt = a.Rt, Lf = a.Lf;
  const Window w = window(L.ring, L.slots, PC, a.D);
  const TasRing t = tas_ring(L.tring, L.slots, Rt, L.cap);
  const int h = walk[r];
  const int cur = K::cur(a, h);
  int nv = 0;
  for (int d0 = 0; d0 < D1; d0 += 32) {
    const int d = d0 + lane;
    const int node = d < D1 ? K::path(a, L, h, d) : -1;
    if (d < D1) w.lvl[s * D1 + d] = ent_slot ? ent_slot[r * D1 + d] : node;
    nv += __popc(__ballot_sync(kFull, node >= 0));
  }
  int cell = -1;
  long long qv = 0;
  if (lane < PC) {
    const size_t ci = (size_t)h * PC + lane;
    cell = __ldg(a.b.cells_eff + ci);
    qv = __ldg(a.b.qty_eff + ci);
    w.cell[s * PC + lane] = cell;
    w.qty[s * PC + lane] = qv;
  }
  // a cell on two lanes adds twice at each level (the JAX .at[].add):
  // such a head adds atomically. Cells are told apart modulo 32; a
  // collision only costs the atomics.
  const bool cv = cell >= 0 && qv > 0;
  const unsigned seen = __reduce_or_sync(kFull, cv ? 1u << (cell & 31) : 0u);
  const bool dup = __popc(seen) < __popc(__ballot_sync(kFull, cv));
  const bool tas_h = __ldg(a.tas.t_is + h);
  const long long* rq = a.tas.t_req + ((size_t)h * a.L + cur) * Rt;
  if (lane < Rt) t.req[s * Rt + lane] = __ldg(rq + lane);
  // a nominated leaf's entries: one a resource of nonzero request
  int m = 0;
  for (int j = 0; j < Rt; ++j) m += __ldg(rq + j) != 0;
  int n = 0;
  bool over = false;
  if (tas_h) {
    const long long* row = a.tas.taken0 + (size_t)h * Lf;
    for (int base = 0; base < Lf; base += 32 * kUnroll) {
      long long v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * 32 + lane;
        v[u] = i < Lf ? __ldg(row + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned hit = __ballot_sync(kFull, v[u] != 0);
        int e = (n + __popc(hit & ((1u << lane) - 1))) * m;
        if (v[u] != 0) {
          const size_t leaf = base + u * 32 + lane;
          for (int j = 0; j < Rt; ++j) {
            const long long q = __ldg(rq + j);
            if (q == 0) continue;
            over |= q > 0 && (__mul64hi(v[u], q) != 0 || v[u] * q < 0);
            if (e < L.cap) {
              const int x = (int)(leaf * Rt + j);
              t.ex[s * L.cap + e] = q > 0 ? x : ~x;
              t.ec[s * L.cap + e] = v[u] * q;
            }
            ++e;
          }
        }
        n += __popc(hit);
      }
    }
  }
  over = __any_sync(kFull, over);
  if (lane == 0) {
    w.nv[s] = nv;
    w.cq[s] = K::cq(a, L, h);
    w.flag[s] = (__ldg(a.b.is_fit + h) ? 1 : 0) |
                (__ldg(a.b.is_pre + h) && __ldg(a.q.no_reclaim + h) ? 2 : 0) |
                (__ldg(a.b.head_borrow + h) ? 4 : 0) | (dup ? 8 : 0);
    t.head[s] = h;
    t.ne[s] = n * m <= L.cap ? n * m : -1;
    t.fail[s] = over;
  }
  __syncwarp();
  if (lane == 0) publish(t.tag + s, r + 1);
}

// Warp 0's walk of the ranked heads, each taken from the ring once its
// slot is published: on the quota rows in shared memory (kShared) or in
// device memory, on the live headroom H [Lf, Rt] in shared memory
// (kRoom) or on topo_free - tas_u in device memory, charging tas_u.
template <bool kShared, bool kRoom>
__device__ __forceinline__ void walk(const Args& a, const Layout& L, int n_walk,
                                     const long long* S, const long long* G,
                                     const long long* BL, long long* U, const long long* N,
                                     long long* H, uint8_t* adm, volatile int* walked,
                                     int lane) {
  const int PC = a.P * a.C, D1 = a.D + 1, FR = a.FR, Rt = a.Rt, Lf = a.Lf;
  const Window w = window(L.ring, L.slots, PC, a.D);
  const TasRing t = tas_ring(L.tring, L.slots, Rt, L.cap);
  for (int r = 0; r < n_walk; ++r) {
    const int s = r % L.slots;
    await(t.tag + s, r + 1);
    const int ne = t.ne[s];
    const bool fail = t.fail[s];
    const long long* rq = t.req + s * Rt;
    const int* ex = t.ex + s * L.cap;
    const long long* ec = t.ec + (size_t)s * L.cap;
    const long long* taken = a.tas.taken0 + (size_t)t.head[s] * Lf;
    // the leaf gate, the lane's entries (or leaves of the taken0 row)
    auto gate = [&]() {
      bool ok = !fail;
      if (ne >= 0) {
        for (int k = lane; k < ne; k += 32) {
          const int x = ex[k];
          ok &= x < 0 || headroom<kRoom>(a, H, (size_t)x) >= ec[k];
        }
      } else {
        for (int i = lane; i < Lf; i += 32) {
          const long long tk = __ldg(taken + i);
          if (tk != 0) ok &= leaf_holds<kRoom>(a, H, rq, i, tk);
        }
      }
      return ok;
    };
    uint8_t* adm_r = adm + (r - s);  // walk_head writes adm_r[s] = adm[r]
    bool admit;
    switch (w.nv[s]) {
      case 1: admit = walk_head<kShared, 1>(w, s, PC, D1, FR, S, G, BL, U, N, adm_r, lane, gate);
              break;
      case 2: admit = walk_head<kShared, 2>(w, s, PC, D1, FR, S, G, BL, U, N, adm_r, lane, gate);
              break;
      case 3: admit = walk_head<kShared, 3>(w, s, PC, D1, FR, S, G, BL, U, N, adm_r, lane, gate);
              break;
      case 4: admit = walk_head<kShared, 4>(w, s, PC, D1, FR, S, G, BL, U, N, adm_r, lane, gate);
              break;
      default: admit = walk_head_deep<kShared>(w, s, PC, D1, FR, S, G, BL, U, N, adm_r, lane,
                                               gate);
    }
    if (admit && ne > 0) {  // the admitted head's charge, an entry a lane
      for (int k = lane; k < ne; k += 32) {
        const int x = ex[k];
        charge<kRoom>(a, H, (size_t)(x < 0 ? ~x : x), ec[k]);
      }
    } else if (admit && ne < 0) {
      for (int i = lane; i < Lf; i += 32) {
        const long long tk = __ldg(taken + i);
        if (tk == 0) continue;
        for (int j = 0; j < Rt; ++j) charge<kRoom>(a, H, (size_t)i * Rt + j, rq[j] * tk);
      }
    }
    __syncwarp();  // the charges land before the next gate; the slot is read
    if (lane == 0) *walked = r + 1;
  }
}

// One block a multiprocessor: without the 1, ptxas may hold the kernel
// to fewer registers and spill.
template <bool kKeys>
__global__ void __launch_bounds__(kThreads, 1) tas_phase2(Args a, Layout L) {
  if (*a.s.done) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int Q = a.Q, D1 = a.D + 1, FR = a.FR;
  using K = Keys<kKeys>;
  int* walk_of = (int*)(smem + L.walk);
  uint8_t* adm = smem + L.adm;
  long long* H = L.room >= 0 ? (long long*)(smem + L.room) : nullptr;
  __shared__ int n_valid;
  __shared__ int walked;
  if (tid == 0) {
    n_valid = 0;
    walked = 0;
  }
  const TasRing tr = tas_ring(L.tring, L.slots, a.Rt, L.cap);
  for (int s = tid; s < L.slots; s += kThreads) tr.tag[s] = 0;
  if (H) {
    for (int i = tid; i < a.Lf * a.Rt; i += kThreads) {
      H[i] = __ldg(a.tas.topo_free + i) - a.tas.tas_u[i];
    }
  }
  if constexpr (kKeys) {
    uint8_t* kf = smem + L.kf;
    long long* kp = (long long*)(smem + L.kp);
    long long* kt = (long long*)(smem + L.kt);
    int* kc = (int*)(smem + L.kc);
    int* kpath = (int*)(smem + L.kpath);
    for (int x = tid; x < Q; x += kThreads) {
      const int c = __ldg(a.s.cursor + x);
      const int row = __ldg(a.q.cq_rows + x);
      const bool ranked = (__ldg(a.b.is_fit + x) | __ldg(a.b.is_pre + x)) &&
                          c < __ldg(a.q.qlen + x) && __ldg(a.s.alive + x) && row >= 0;
      const size_t e = (size_t)x * a.L + min(c, a.L - 1);
      const int cq = max(row, 0);
      kf[x] = (uint8_t)((ranked ? 1 : 0) | (__ldg(a.b.head_borrow + x) ? 2 : 0));
      kp[x] = __ldg(a.q.priority + e);
      kt[x] = __ldg(a.q.timestamp + e);
      kc[x] = cq;
      for (int d = 0; d < D1; ++d) kpath[x * D1 + d] = __ldg(a.t.paths + (size_t)cq * D1 + d);
    }
  }
  __syncthreads();

  // rank: a warp a ranked queue, its lanes counting its predecessors
  for (int i = warp; i < Q; i += kWarps) {
    const int fi = K::flags(a, L, i);
    if (!(fi & 1)) continue;
    const int bi = fi >> 1;
    const long long pi = K::prio(a, L, i), ti = K::ts(a, L, i);
    int n = 0;
    for (int j = lane; j < Q; j += 32) {
      const int fj = K::flags(a, L, j), bj = fj >> 1;
      const long long pj = K::prio(a, L, j), tj = K::ts(a, L, j);
      // branchless: (borrowing, -priority, timestamp, queue index)
      const bool first = (tj < ti) | ((tj == ti) & (j < i));
      n += (fj & 1) & ((bj < bi) | ((bj == bi) & ((pj > pi) | ((pj == pi) & first))));
    }
    n = __reduce_add_sync(kFull, n);
    if (lane == 0) {
      atomicAdd(&n_valid, 1);
      if (n < a.n_steps) walk_of[n] = i;
    }
  }
  __syncthreads();
  const int n_walk = min(n_valid, a.n_steps);
  if (n_walk == 0) return;

  // the walk's rows: in shared memory when they fit
  const int E = n_walk * D1;
  const bool shared_rows = segment_bytes(n_walk, FR, a.D) <= L.rows_bytes;
  int* ent_node = (int*)(smem + L.rows);
  int* ent_slot = ent_node + E;
  long long* S = (long long*)(smem + L.rows + align8(8LL * E));
  long long* G = S + (size_t)E * FR;
  long long* BL = G + (size_t)E * FR;
  long long* U = BL + (size_t)E * FR;
  long long* N = U + (size_t)E * FR;
  if (shared_rows) {
    for (int e = tid; e < E; e += kThreads) {
      const int r = e / D1;
      ent_node[e] = K::path(a, L, walk_of[r], e - r * D1);
    }
    __syncthreads();
    stage_rows<kThreads>(
        Rows{a.t.subtree, a.t.guaranteed, a.t.borrowing_limit, a.b.usage, a.t.nominal},
        ent_node, ent_slot, E, FR, S, G, BL, U, N, [] {});
    __syncthreads();
  }

  // warp 0 walks while warps 1-15 stage the heads into the ring
  if (warp == 0) {
    const long long *dS = a.t.subtree, *dG = a.t.guaranteed, *dBL = a.t.borrowing_limit;
    if (shared_rows && H) walk<true, true>(a, L, n_walk, S, G, BL, U, N, H, adm, &walked, lane);
    else if (shared_rows) walk<true, false>(a, L, n_walk, S, G, BL, U, N, H, adm, &walked, lane);
    else if (H) walk<false, true>(a, L, n_walk, dS, dG, dBL, a.b.usage, a.t.nominal, H, adm,
                                  &walked, lane);
    else walk<false, false>(a, L, n_walk, dS, dG, dBL, a.b.usage, a.t.nominal, H, adm, &walked,
                            lane);
  } else {
    for (int r = warp - 1; r < n_walk; r += kWarps - 1) {
      if (r >= L.slots) {
        while (((volatile int*)&walked)[0] < r - L.slots + 1) __nanosleep(128);
      }
      stage_head<kKeys>(a, L, walk_of, shared_rows ? ent_slot : nullptr, r, r % L.slots, lane);
    }
  }
  __syncthreads();

  // the walk touched shared memory only: its rows, the headroom, the
  // admissions' leaf usage, flags and steps go out now
  if (shared_rows) {
    for (int i = tid; i < E * FR; i += kThreads) {
      const int e = i / FR;
      if (ent_slot[e] == e) a.b.usage[(size_t)ent_node[e] * FR + (i - e * FR)] = U[i];
    }
  }
  if (H) {
    for (int i = tid; i < a.Lf * a.Rt; i += kThreads) {
      a.tas.tas_u[i] = __ldg(a.tas.topo_free + i) - H[i];
    }
  }
  const int PC = a.P * a.C;
  for (int i = tid; i < n_walk * PC; i += kThreads) {
    const int r = i / PC, c = i - r * PC;
    if (!adm[r]) continue;
    const int h = walk_of[r];
    const int cell = __ldg(a.b.cells_eff + (size_t)h * PC + c);
    const long long qv = __ldg(a.b.qty_eff + (size_t)h * PC + c);
    if (cell >= 0 && qv > 0) {
      atomicAdd((unsigned long long*)(a.s.local + (size_t)K::cq(a, L, h) * FR + cell),
                (unsigned long long)qv);
    }
  }
  for (int r = tid; r < n_walk; r += kThreads) {
    const int h = walk_of[r];
    a.b.admitted[h] = adm[r];
    if (adm[r]) a.tas.adm_step[(size_t)h * a.L + K::cur(a, h)] = r;
  }
}

// The block's shared-memory layout for these shapes; false when even a
// one-slot ring does not fit.
bool plan_layout(const Args& a, Layout* L) {
  const int Q = max(a.Q, 1), PC = a.P * a.C, D1 = a.D + 1, Rt = a.Rt;
  const int base = align8(4LL * Q) + align8(Q);  // walk, adm
  int slots = min(kSlots, max(1, min(Q, a.n_steps)));
  int cap = min(a.Lf * Rt, kEntryCap);
  auto ring = [&] { return window_bytes(slots, PC, a.D) + tas_ring_bytes(slots, Rt, cap); };
  while (base + ring() > kSmemMax && (slots > 1 || cap > 0)) {
    if (cap > 8) cap >>= 1;
    else if (slots > 1) slots >>= 1;
    else cap = 0;
  }
  if (base + ring() > kSmemMax) return false;
  const int keys = align8(Q) + 16 * Q + align8(4LL * Q) + align8(4LL * Q * D1);
  const int room = 8 * a.Lf * Rt;
  int off = 0;
  L->keys = base + ring() + keys <= kSmemMax;
  L->kf = off;
  off += L->keys ? align8(Q) : 0;
  L->kp = off;
  off += L->keys ? 8 * Q : 0;
  L->kt = off;
  off += L->keys ? 8 * Q : 0;
  L->kc = off;
  off += L->keys ? align8(4LL * Q) : 0;
  L->kpath = off;
  off += L->keys ? align8(4LL * Q * D1) : 0;
  L->walk = off;
  off += align8(4LL * Q);
  L->adm = off;
  off += align8(Q);
  L->slots = slots;
  L->cap = cap;
  L->ring = off;
  off += window_bytes(slots, PC, a.D);
  L->tring = off;
  off += tas_ring_bytes(slots, Rt, cap);
  L->room = off + room <= kSmemMax ? off : -1;
  off += L->room >= 0 ? room : 0;
  L->rows = off;
  // the scan walks at most min(Q, n_steps) heads
  const long long need = align8(segment_bytes(min(Q, max(a.n_steps, 0)), a.FR, a.D));
  L->rows_bytes = (int)(need < kSmemMax - off ? need : kSmemMax - off);
  L->total = off + L->rows_bytes;
  return true;
}

template <bool kKeys>
int launch(const Args& a, const Layout& L, cudaStream_t stream) {
  static int raised = 48 * 1024;  // the dynamic shared memory allowed so far
  if (L.total > raised) {
    cudaError_t rc = cudaFuncSetAttribute(
        tas_phase2<kKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (rc != cudaSuccess) return (int)rc;
    raised = kSmemMax;
  }
  tas_phase2<kKeys><<<1, kThreads, L.total, stream>>>(a, L);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace drain

extern "C" int drain_tas_phase2(const int* ints, int n_ints, void* const* ptrs, int n_ptrs,
                                void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.tas.topo_free == nullptr || a.Rt > drain::kMaxTasR) {
    return (int)cudaErrorInvalidValue;
  }
  drain::Layout L;
  if (!drain::plan_layout(a, &L)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return L.keys ? drain::launch<true>(a, L, s) : drain::launch<false>(a, L, s);
}
