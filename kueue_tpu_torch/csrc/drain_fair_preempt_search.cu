// Kernel B11a, drain_fair_preempt_search: the fair-preempt drain's victim
// search of one cycle, for every queue head at once.
//
// Replaces the search half of the cycle of kueue_tpu/ops/drain_kernel.py
// solve_drain_fair_preempt (:2471-2602) with the fair victim tournament
// of kueue_tpu/ops/fair_preempt_kernel.py _solve_one_fair (:151-427).
// Per queue whose head is preempt-mode and may preempt:
//   - the candidate eligibility over its segment's pool, shared with
//     the classic drain (drain_pool.cuh);
//   - the live usage panel over the segment's active cell universe
//     (`seg_cells`; pad cells and rows zero, borrowing limits NO_LIMIT,
//     so the DRS buckets stay inert), with the head's request bubbled
//     in at its row (preemption.go:394-395: AddUsage before DRS);
//   - the candidates in the queue's order (`perm`), valid where live
//     and eligible, with their usage at the panel cells (`pq_cu`);
//   - the tournament (preemption.go:372-463): pick a target queue by
//     the host walk with recomputed pruning (cohorts walkable where they
//     borrow, hold the head or are the root; the highest DRS child, ties
//     to the higher row, cohorts winning ties against ClusterQueues),
//     pop its first available candidate, probe its removal against the
//     strategy's gate (LessThanOrEqualToFinalShare or
//     LessThanInitialShare on the shares below the lowest common
//     ancestor), keep or undo it, and stop when the head fits with its
//     own usage removed; the second strategy retries the first one's
//     rejects and drops each picked queue (`pruned2`);
//   - the fill-back in reverse removal order, skipping the last;
//   - the targets scattered back to slot space, and psuccess.
// No search is truncated: untrusted stays 0.
//
// Design: one block a queue, 256 threads where the panels are wide (M x
// Cu >= 1024: staging is most of such a search), else 128 (both measured
// at the caps and at fair-preempt-1k). The block stages the search once,
// in few dependent phases of device reads: the head's cells, each node's
// tables and owner-borrowing flag (a thread a node), the queue's order;
// then the candidate flags (a thread a slot) and the segment's quota
// panels (subtree, guaranteed, borrowing limit: [M, Cu] int64, rows of an
// odd stride so a column read across rows spreads over the banks, one
// device trip a cell); potentialAvailable level by level for each node's
// lendable table; the valid candidates compacted in perm order with their
// nonzero panel cells (at most Cv a candidate; device reads of `pq_cu`
// where they do not fit); the usage panel with the head's request bubbled
// in; each node's borrowed sums per resource (a thread a node and bucket)
// and DRS (eight lanes a node). Then one warp runs the tournament on that
// state, with no block barrier:
//   - each row keeps a cursor to its first available candidate per
//     phase, and the rows that have one are a 64-bit node mask (M <= 64)
//     kept in registers with the second strategy's dropped rows, so the
//     pick's availability test and pop_first are register and cursor
//     reads, not scans of the pool;
//   - eligibility and walkability are node masks, a level two ballots;
//     each lane ranks its cohorts' children at once (the highest DRS,
//     ties to the higher row, cohorts winning ties), so the walk is a
//     shuffle a level;
//   - a probe bubbles the candidate's few cells up its row's path (a lane
//     a cell) and adds each level's change of borrowed usage to the path
//     nodes' sums; the target's DRS is computed only where
//     LessThanOrEqualToFinalShare reads it, the path's only when the
//     removal is kept; an undo bubbles back and takes the sums back;
//   - the fit test bubbles the head's request out into scratch and reads
//     available() from there: the usage and the DRS do not see it.
//
// What bounds it: the tournament's serial chain of dependent picks (up
// to 2V + M + 4; each a few warp reductions, a bubble of D + 1 levels and
// a fit test), not bytes: a head's inputs are a few kB (chip_smoke.py
// counts each launch's bytes from its data, kernel_ab its chain). A set
// `done` flag makes the launch a no-op.

#include "drain_pool.cuh"
#include "preempt_local.cuh"

namespace drain {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr long long kDrsMax = 0x7fffffffffffffffLL;
constexpr int kMaxM = 64;
constexpr int kMaxCu = 64;
constexpr int kMaxR = kMaxCu + 1;  // a resource a cell, plus the inert bucket
constexpr int kLessThanOrEqualToFinal = 0;
constexpr int kMaxSmem = 232448 - 1024;  // the opt-in limit, less the static part
// candidate state
constexpr uint8_t kRemoved = 1, kRetried = 2;

struct Bump {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) & ~(size_t)15;
    return at;
  }
};

// The panels' row stride: odd, so a column read across rows spreads
// over the banks.
__host__ __device__ inline int stride_of(int Cu) { return Cu | 1; }

// Byte offsets of the block's shared memory; `kq`: the candidates'
// nonzero panel cells are staged (KC = Cv a candidate).
struct Layout {
  size_t u, sub, g, bl, lend, bsum, drs, need, weight, db, child, dmask;
  size_t kqty, kj, order, pm, lpath, parent, depth, sn, res, scl, c1, c2, cells;
  size_t kcell, kcnt, krow, kst, cflag, npre, bbl, isq, valid, anc;
  size_t total;
};

__host__ __device__ inline Layout plan(const Args& a, bool kq) {
  const size_t M = a.M, Cu = a.Cu, R = a.n_res + 1, V = a.V, D1 = a.D + 1;
  const size_t KC = a.Cv > 0 ? a.Cv : 1, PS = stride_of(a.Cu);
  Layout L = {};
  Bump b;
  L.u = b.take(8 * M * PS);
  L.sub = b.take(8 * M * PS);
  L.g = b.take(8 * M * PS);
  L.bl = b.take(8 * M * PS);
  L.lend = b.take(8 * M * R);
  L.bsum = b.take(8 * M * R);
  L.drs = b.take(8 * M);
  L.need = b.take(8 * Cu);
  L.weight = b.take(8 * M);
  L.db = b.take(8 * Cu * D1);
  L.child = b.take(8 * M);
  L.dmask = b.take(8 * D1);
  if (kq) L.kqty = b.take(8 * V * KC);
  L.kj = b.take(4 * V);
  L.order = b.take(4 * V);
  L.pm = b.take(4 * V);
  L.lpath = b.take(4 * M * D1);
  L.parent = b.take(4 * M);
  L.depth = b.take(4 * M);
  L.sn = b.take(4 * M);
  L.res = b.take(4 * Cu);
  L.scl = b.take(4 * Cu);
  L.c1 = b.take(4 * M);
  L.c2 = b.take(4 * M);
  L.cells = b.take(4 * 32);
  if (kq) L.kcell = b.take(V * KC);
  L.kcnt = b.take(V);
  L.krow = b.take(V);
  L.kst = b.take(V);
  L.cflag = b.take(V);
  L.npre = b.take(32);
  L.bbl = b.take(M);
  L.isq = b.take(M);
  L.valid = b.take(M);
  L.anc = b.take(M);
  L.total = b.off;
  return L;
}

struct Sh {
  unsigned long long cq, vmask, anc;  // node masks: ClusterQueues, valid, head ancestors
  int nv, wide, root;
};

// 64-bit node mask of a per-node predicate (lane holds nodes lane and
// lane + 32)
__device__ __forceinline__ unsigned long long mask64(bool p0, bool p1) {
  return (unsigned long long)__ballot_sync(kFull, p0) |
         ((unsigned long long)__ballot_sync(kFull, p1) << 32);
}

// A node's DRS (fair_sharing.go's DominantResourceShare with the JAX
// integer semantics) from its buckets' largest ratio and any-borrowed
// flag, each lane of an eight-lane group holding its buckets' (r = lane
// % 8, mod 8): the group's reduction, then the weight; every lane of
// the group returns the value.
__device__ __forceinline__ long long group_drs(long long drs, bool any, bool has_parent,
                                               long long w) {
  for (int o = 4; o > 0; o >>= 1) {
    drs = max(drs, __shfl_xor_sync(kFull, drs, o));
    any = __shfl_xor_sync(kFull, (int)any, o) || any;
  }
  if (!has_parent || !any) return 0;
  if (w == 0) return kDrsMax;
  return (drs * 1000) / max(w, 1LL);
}

__device__ __forceinline__ long long ratio(long long b, long long l) {
  return (b > 0 && l > 0) ? b * 1000 / l : -1LL;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1) search(Args a, int kq) {
  if (*a.s.done) return;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Sh sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;
  const int V = a.V, M = a.M, Cu = a.Cu, FR = a.FR, D = a.D, D1 = a.D + 1, R = a.n_res + 1;
  const int PC = a.P * a.C, KC = a.Cv > 0 ? a.Cv : 1, PS = stride_of(Cu);
  const int q = blockIdx.x;
  uint8_t* targets = a.p.targets + (size_t)q * V;
  for (int v = tid; v < V; v += kThreads) targets[v] = 0;
  if (tid == 0) {
    a.p.psuccess[q] = 0;
    a.p.untrusted[q] = 0;
    a.p.preempt_ok[q] = 0;
  }
  const bool active = a.s.cursor[q] < a.q.qlen[q] && a.s.alive[q];
  if (!(active && a.b.is_pre[q] && (a.p.same_enabled[q] || a.p.reclaim_enabled[q]))) return;

  const Layout L = plan(a, kq);
  long long* u = (long long*)(smem + L.u);
  long long* sub = (long long*)(smem + L.sub);
  long long* g = (long long*)(smem + L.g);
  long long* bl = (long long*)(smem + L.bl);
  long long* lend = (long long*)(smem + L.lend);
  long long* bsum = (long long*)(smem + L.bsum);
  long long* drs = (long long*)(smem + L.drs);
  long long* need = (long long*)(smem + L.need);
  long long* weight = (long long*)(smem + L.weight);
  long long* db = (long long*)(smem + L.db);
  unsigned long long* child = (unsigned long long*)(smem + L.child);
  unsigned long long* dmask = (unsigned long long*)(smem + L.dmask);
  long long* kqty = (long long*)(smem + L.kqty);
  int* kj = (int*)(smem + L.kj);
  int* order = (int*)(smem + L.order);
  int* pm = (int*)(smem + L.pm);
  int* lpath = (int*)(smem + L.lpath);
  int* parent = (int*)(smem + L.parent);
  int* depth = (int*)(smem + L.depth);
  int* sn = (int*)(smem + L.sn);
  int* res = (int*)(smem + L.res);
  int* scl = (int*)(smem + L.scl);
  int* c1 = (int*)(smem + L.c1);
  int* c2 = (int*)(smem + L.c2);
  int* cells_s = (int*)(smem + L.cells);
  uint8_t* kcell = smem + L.kcell;
  uint8_t* kcnt = smem + L.kcnt;
  uint8_t* krow = smem + L.krow;
  uint8_t* kst = smem + L.kst;
  uint8_t* cflag = smem + L.cflag;
  uint8_t* npre_s = smem + L.npre;
  uint8_t* bbl = smem + L.bbl;
  uint8_t* isq = smem + L.isq;
  uint8_t* valid = smem + L.valid;
  uint8_t* anc = smem + L.anc;

  const int sq = max(a.q.seg_id[q], 0);
  const int cur = min(a.s.cursor[q], a.L - 1);
  const long long prio = a.q.priority[(size_t)q * a.L + cur];
  const int hrow = max(a.p.hlocal[q], 0);
  const size_t sM = (size_t)sq * M;
  const int* lpaths = a.p.lpaths + sM * D1;
  const int* hpath_g = lpaths + (size_t)hrow * D1;

  // ---- staging A: the head's cells; each node's tables and its
  // owner-borrowing flag (drain_pool.cuh's owner_borrowing, a thread a
  // node); the panel cells, the head's request there; the queue's order ----
  if (warp == 0) {
    const bool in = lane < PC;
    const int cell = in ? a.b.cells_eff[(size_t)q * PC + lane] : -1;
    cells_s[lane] = max(cell, 0);
    npre_s[lane] = in && a.p.need_pre[(size_t)q * PC + lane];
  }
  for (int m = tid; m < M; m += kThreads) {
    const int node = a.p.seg_nodes[sM + m];
    sn[m] = node;
    parent[m] = a.fp.parent_local[sM + m];
    depth[m] = a.fp.depth_local[sM + m];
    isq[m] = a.fp.is_cq_local[sM + m];
    valid[m] = a.fp.node_valid[sM + m];
    weight[m] = a.fp.weight_local[sM + m];
    c1[m] = V;
    c2[m] = V;
    bool is_anc = false;
    for (int d = 1; d <= D; ++d) is_anc = is_anc || hpath_g[d] == m;
    anc[m] = is_anc;
    for (int d = 0; d < D1; ++d) lpath[m * D1 + d] = lpaths[(size_t)m * D1 + d];
    bool b = false;
    for (int i = 0; i < PC; ++i) {
      const size_t x = (size_t)max(node, 0) * FR + max(a.b.cells_eff[(size_t)q * PC + i], 0);
      b = b || (a.p.need_pre[(size_t)q * PC + i] && a.s.local[x] > a.t.nominal[x]);
    }
    bbl[m] = b;
  }
  for (int c = tid; c < Cu; c += kThreads) {
    const int sc_cell = a.fp.seg_cells[(size_t)sq * Cu + c];
    scl[c] = sc_cell;
    long long nq = 0;
    for (int i = 0; sc_cell >= 0 && i < PC; ++i) {
      const int hc = a.b.cells_eff[(size_t)q * PC + i];
      const long long hq = a.b.qty_eff[(size_t)q * PC + i];
      if (hc >= 0 && hq > 0 && hc == sc_cell) nq += hq;
    }
    need[c] = nq;
    res[c] = a.fp.res_of_cell[(size_t)sq * Cu + c];
  }
  for (int j = tid; j < V; j += kThreads) pm[j] = a.p.perm[(size_t)q * V + j];
  if (tid == 0) {
    sh.nv = 0;
    sh.wide = 0;
    int root = hrow;
    for (int d = 0; d <= D; ++d) {
      if (hpath_g[d] >= 0) root = hpath_g[d];
    }
    sh.root = root;
  }
  __syncthreads();

  // ---- staging B: the candidate flags (a thread a slot), the quota
  // panels (one device trip a cell; potentialAvailable starts at the
  // subtree quota), the node masks ----
  for (int v = tid; v < V; v += kThreads) {
    bool same;
    cflag[v] = pool::pool_eligible(a, q, sq, v, prio, PC, cells_s, npre_s, bbl, &same);
  }
#pragma unroll 4
  for (int i = tid; i < M * Cu; i += kThreads) {
    const int m = i / Cu, c = i % Cu, y = m * PS + c;
    const bool on = scl[c] >= 0 && valid[m];
    const size_t x = (size_t)max(sn[m], 0) * FR + max(scl[c], 0);
    const long long st = on ? a.t.subtree[x] : 0;
    sub[y] = st;
    u[y] = st;
    g[y] = on ? a.t.guaranteed[x] : 0;
    bl[y] = on ? a.t.borrowing_limit[x] : kNoLimit;
  }
  if (warp == 0) {
    const int s0 = lane, s1 = lane + 32;
    const bool in0 = s0 < M, in1 = s1 < M;
    const unsigned long long cq = mask64(in0 && isq[s0], in1 && isq[s1]);
    const unsigned long long vm = mask64(in0 && valid[s0], in1 && valid[s1]);
    const unsigned long long am = mask64(in0 && anc[s0], in1 && anc[s1]);
    for (int d = 0; d < D1; ++d) {
      const unsigned long long dm = mask64(in0 && depth[s0] == d, in1 && depth[s1] == d);
      if (lane == 0) dmask[d] = dm;
    }
    if (lane == 0) {
      sh.cq = cq;
      sh.vmask = vm;
      sh.anc = am;
    }
  }
  for (int s = tid; s < M; s += kThreads) {
    unsigned long long cm = 0;
    for (int t = 0; t < M; ++t) cm |= (unsigned long long)(parent[t] == s) << t;
    child[s] = cm;
  }
  __syncthreads();
  // potentialAvailable top-down (a thread a cell of each node at depth d)
  for (int d = 1; d <= D; ++d) {
    for (int i = tid; i < M * Cu; i += kThreads) {
      const int s = i / Cu, c = i % Cu, y = s * PS + c;
      if (depth[s] != d) continue;
      long long v = g[y] + u[max(parent[s], 0) * PS + c];
      if (bl[y] < kNoLimit) v = min(sub[y] + bl[y], v);
      u[y] = v;
    }
    __syncthreads();
  }
  // ---- staging C: each node's lendable, its parent's potentials summed
  // per bucket; the valid candidates compacted in perm order (warp 0) ----
  for (int i = tid; i < M * R; i += kThreads) {
    const int s = i / R, r = i % R;
    const int p = parent[s];
    long long l = 0;
    for (int c = 0; p >= 0 && c < Cu; ++c) {
      if (res[c] == r) l += u[p * PS + c];
    }
    lend[i] = l;
  }
  if (warp == 0) {
    int base = 0;
    for (int j0 = 0; j0 < V; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < V && cflag[pm[j]];
      const unsigned bal = __ballot_sync(kFull, ok);
      if (ok) kj[base + __popc(bal & ((1u << lane) - 1))] = j;
      base += __popc(bal);
    }
    if (lane == 0) sh.nv = base;
  }
  __syncthreads();
  const int nv = sh.nv;
  // ---- staging D: the usage panel; each candidate's row and nonzero
  // cells (a warp a candidate, a lane a cell) ----
#pragma unroll 4
  for (int i = tid; i < M * Cu; i += kThreads) {
    const int m = i / Cu, c = i % Cu;
    const bool on = scl[c] >= 0 && valid[m];
    u[m * PS + c] = on ? a.b.usage[(size_t)max(sn[m], 0) * FR + max(scl[c], 0)] : 0;
  }
  for (int k = warp; k < nv; k += kWarps) {
    const size_t sv = (size_t)sq * V + pm[kj[k]];
    if (lane == 0) {
      krow[k] = (uint8_t)max(a.p.sowner_local[sv], 0);
      kst[k] = 0;
    }
    int n = 0;
    for (int c0 = 0; c0 < Cu; c0 += 32) {
      const int c = c0 + lane;
      const long long v = c < Cu ? a.fp.pq_cu[sv * Cu + c] : 0;
      const unsigned bal = __ballot_sync(kFull, v != 0);
      const int at = n + __popc(bal & ((1u << lane) - 1));
      if (kq && v != 0 && at < KC) {
        kcell[(size_t)k * KC + at] = (uint8_t)c;
        kqty[(size_t)k * KC + at] = v;
      }
      n += __popc(bal);
    }
    if (lane == 0) {
      kcnt[k] = (uint8_t)min(n, 255);
      if (n > KC) sh.wide = 1;
    }
  }
  __syncthreads();
  // ---- staging E: the head's request bubbled in (warp 0, a lane a
  // cell); each row's first candidate ----
  const int* hpath = lpath + (size_t)hrow * D1;
  if (warp == 0) {
    for (int c = lane; c < Cu; c += 32) preempt_local::bubble(hpath, D, PS, c, need[c], u, g);
  }
  for (int k = tid; k < nv; k += kThreads) atomicMin(&c1[krow[k]], k);
  __syncthreads();
  // ---- staging F: each node's borrowed sums per bucket (a thread a
  // node and bucket), then its DRS (eight lanes a node) ----
  for (int i = tid; i < M * R; i += kThreads) {
    const int s = i / R, r = i % R;
    long long bs = 0;
#pragma unroll 8
    for (int c = 0; c < Cu; ++c) {
      const long long over = max(0LL, u[s * PS + c] - sub[s * PS + c]);
      bs += res[c] == r ? over : 0;
    }
    bsum[i] = bs;
  }
  __syncthreads();
  for (int s0 = warp * 4; s0 < M; s0 += 4 * kWarps) {
    const int s = min(s0 + (lane >> 3), M - 1);
    long long dv = -1;
    bool any = false;
    for (int r = lane & 7; r < R; r += 8) {
      const long long bs = bsum[(size_t)s * R + r];
      dv = max(dv, ratio(bs, lend[(size_t)s * R + r]));
      any = any || bs > 0;
    }
    const long long v = group_drs(dv, any, parent[s] >= 0, weight[s]);
    if ((lane & 7) == 0 && s0 + (lane >> 3) < M) drs[s] = v;
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- the tournament: one warp, no block barrier ----
  const bool wide = !kq || sh.wide;
  const int root = sh.root;
  const unsigned long long cqm = sh.cq, vmask = sh.vmask, ancm = sh.anc;
  const unsigned long long rootbit = 1ull << root, hbit = 1ull << hrow;
  const int s0 = lane, s1 = lane + 32;
  const bool in0 = s0 < M, in1 = s1 < M;
  const unsigned long long c0m = in0 ? child[s0] & vmask : 0, c1m = in1 ? child[s1] & vmask : 0;
  const bool co0 = in0 && !isq[s0], co1 = in1 && !isq[s1];
  const bool rootless = parent[hrow] < 0;
  // the rows with an available candidate in each phase (c1, c2 < V), and
  // the second strategy's dropped rows
  unsigned long long has1 = mask64(in0 && c1[s0] < V, in1 && c1[s1] < V), has2 = 0, pruned = 0;
  // candidate k's e-th nonzero panel cell and its usage there
  auto n_cells = [&](int k) { return wide ? Cu : (int)kcnt[k]; };
  auto cell_of = [&](int k, int e) { return wide ? e : (int)kcell[(size_t)k * KC + e]; };
  auto qty_of = [&](int k, int e) {
    return wide ? a.fp.pq_cu[((size_t)sq * V + pm[kj[k]]) * Cu + e] : kqty[(size_t)k * KC + e];
  };
  // sign x candidate k's usage bubbled up `path` (a lane a cell); with
  // `sums` (+1 a removal's probe, -1 its undo), the change of borrowed
  // usage at each level goes into db (a probe) and into the path nodes'
  // sums (a lane a node)
  auto move = [&](int k, const int* path, long long sign, int sums) {
    const int n = n_cells(k);
    for (int e = lane; e < n; e += 32) {
      const int c = cell_of(k, e);
      long long delta = sign * qty_of(k, e);
      for (int d = 0; d < D1; ++d) {
        const int node = path[d];
        long long dbv = 0;
        if (node >= 0) {
          const int x = node * PS + c;
          const long long old = u[x], nw = old + delta, gg = g[x], ss = sub[x];
          u[x] = nw;
          dbv = max(0LL, nw - ss) - max(0LL, old - ss);
          delta = max(0LL, nw - gg) - max(0LL, old - gg);
        }
        if (sums > 0) db[(size_t)e * D1 + d] = dbv;
      }
    }
    __syncwarp();
    if (sums == 0) return;
    for (int d = lane; d < D1; d += 32) {
      const int node = path[d];
      if (node < 0) continue;
      for (int e = 0; e < n; ++e) {
        const int r = res[cell_of(k, e)];
        if (r >= 0 && r < R) bsum[(size_t)node * R + r] += sums * db[(size_t)e * D1 + d];
      }
    }
    __syncwarp();
  };
  // the DRS of node s from its sums, the whole warp (a lane a bucket)
  auto node_drs = [&](int s) {
    long long dv = -1;
    bool any = false;
    for (int r = lane; r < R; r += 32) {
      const long long bs = bsum[(size_t)s * R + r];
      dv = max(dv, ratio(bs, lend[(size_t)s * R + r]));
      any = any || bs > 0;
    }
    for (int o = 16; o > 0; o >>= 1) {
      dv = max(dv, __shfl_xor_sync(kFull, dv, o));
      any = __shfl_xor_sync(kFull, (int)any, o) || any;
    }
    if (parent[s] < 0 || !any) return 0LL;
    if (weight[s] == 0) return kDrsMax;
    return (dv * 1000) / max(weight[s], 1LL);
  };
  // the path nodes' DRS from their sums (eight lanes a node)
  auto path_drs = [&](const int* path) {
    for (int d0 = 0; d0 < D1; d0 += 4) {
      const int d = min(d0 + (lane >> 3), D1 - 1);
      const int node = path[d];
      const int s = max(node, 0);
      long long dv = -1;
      bool any = false;
      for (int r = lane & 7; r < R; r += 8) {
        const long long bs = bsum[(size_t)s * R + r];
        dv = max(dv, ratio(bs, lend[(size_t)s * R + r]));
        any = any || bs > 0;
      }
      const long long v = group_drs(dv, any, parent[s] >= 0, weight[s]);
      if ((lane & 7) == 0 && d0 + (lane >> 3) < D1 && node >= 0) drs[s] = v;
    }
    __syncwarp();
  };
  // the head's request out of (sign -1) the usage, for the fill-back
  auto move_head = [&](long long sign) {
    for (int c = lane; c < Cu; c += 32) {
      if (need[c] != 0) preempt_local::bubble(hpath, D, PS, c, sign * need[c], u, g);
    }
    __syncwarp();
  };
  // the head fits: available() along its path covers its request at
  // every needed cell
  auto fits = [&]() {
    bool ok = true;
    for (int c = lane; c < Cu; c += 32) {
      const long long nq = need[c];
      if (nq > 0) ok = ok && quota_path::avail_along_path(hpath, D, PS, c, sub, g, bl, u) >= nq;
    }
    return (bool)__all_sync(kFull, ok);
  };
  // _fits_for_fair_sharing: the same with the head's request removed,
  // the removal bubbled into db (its levels' usage) and not into u
  auto fits_without_head = [&]() {
    bool ok = true;
    int root_pos = -1;
    for (int d = 0; d < D1; ++d) root_pos += hpath[d] >= 0;
    for (int c = lane; c < Cu; c += 32) {
      const long long nq = need[c];
      if (nq <= 0) continue;
      long long* ut = db + (size_t)c * D1;
      long long delta = -nq;
      for (int d = 0; d < D1; ++d) {
        const int node = hpath[d];
        if (node < 0) continue;
        const int x = node * PS + c;
        const long long old = u[x], nw = old + delta, gg = g[x];
        ut[d] = nw;
        delta = max(0LL, nw - gg) - max(0LL, old - gg);
      }
      long long av = 0;
      for (int d = D; d >= 0; --d) {
        const int node = hpath[d];
        if (node < 0) continue;
        const int x = node * PS + c;
        const long long st = sub[x], gg = g[x], bb = bl[x], uu = ut[d];
        if (d == root_pos) {
          av = st - uu;
        } else {
          const long long with_max = (st - gg) - max(0LL, uu - gg) + bb;
          const long long clamped = bb < kNoLimit ? min(with_max, av) : av;
          av = max(0LL, gg - uu) + clamped;
        }
      }
      ok = ok && av >= nq;
    }
    return (bool)__all_sync(kFull, ok);
  };
  // the first candidate of row s after k (phase 1: any; phase 2: retried
  // and not removed), or V
  auto next_of = [&](int s, int k, int phase) {
    for (int k0 = k + 1; k0 < nv; k0 += 32) {
      const int kk = k0 + lane;
      const bool hit = kk < nv && krow[kk] == s &&
                       (phase == 1 || (kst[kk] & (kRemoved | kRetried)) == kRetried);
      const unsigned bal = __ballot_sync(kFull, hit);
      if (bal) return k0 + __ffs(bal) - 1;
    }
    return V;
  };
  // almost_lca: the node on `path` just below lca (path[0] if lca is not on it)
  auto almost_lca = [&](const int* path, int lca) {
    const bool at = lane < D1 && path[min(lane, D1 - 1)] == lca;
    const unsigned bal = __ballot_sync(kFull, at);
    const int pos = bal ? __ffs(bal) - 1 : 0;
    return max(path[max(pos - 1, 0)], 0);
  };

  const int max_iters = 2 * V + M + 4;
  int phase = 1, n_removed = 0;
  bool fit_found = false;
  for (int it = 0; it < max_iters; ++it) {
    // next_target: eligibility, walkability and the walk on node masks
    const long long d0 = in0 ? drs[s0] : 0, d1 = in1 ? drs[s1] : 0;
    const unsigned long long zero = mask64(in0 && d0 == 0, in1 && d1 == 0);
    const unsigned long long has = phase == 1 ? has1 : has2;
    const unsigned long long elig =
        cqm & vmask & has & ~(phase == 2 ? pruned : 0ull) & ~(zero & ~hbit);
    int pick = -1;
    if (rootless) {
      pick = (has >> hrow) & 1 ? hrow : -1;  // its own queue
    } else {
      const unsigned long long walkable = ((~zero | ancm) & ~cqm) | rootbit;
      unsigned long long ok = elig;
      for (int d = D; d >= 1; --d) {
        const unsigned long long contrib = ok & dmask[d];
        ok |= mask64((c0m & contrib) != 0, (c1m & contrib) != 0) & walkable;
      }
      if (ok & rootbit) {
        // each lane's cohorts: the highest (DRS, row) eligible
        // ClusterQueue child and walkable cohort child (the scan from -1,
        // as the JAX code's max), and whether the walk goes on
        const unsigned long long okco = ok & ~cqm;
        auto best = [&](unsigned long long kids) {
          long long bq = -1, bo = -1;
          int iq = -1, io = -1;
          while (kids) {
            const int c = __ffsll((long long)kids) - 1;
            kids &= kids - 1;
            const long long dc = drs[c];
            if ((elig >> c) & 1) {
              if (dc > bq) {
                bq = dc;
                iq = c;
              } else if (dc == bq) {
                iq = c;
              }
            }
            if ((okco >> c) & 1) {
              if (dc > bo) {
                bo = dc;
                io = c;
              } else if (dc == bo) {
                io = c;
              }
            }
          }
          const bool go = io >= 0 && (iq < 0 || bo >= bq);
          return go ? 0x100 | io : iq + 1;
        };
        const int p0 = co0 ? best(c0m) : 0, p1 = co1 ? best(c1m) : 0;
        int at = root;
        for (int step = 0; step <= D; ++step) {
          const int v = __shfl_sync(kFull, at < 32 ? p0 : p1, at & 31);
          if (!(v & 0x100)) {
            pick = v - 1;
            break;
          }
          at = v & 0xff;
        }
      }
    }
    if (pick < 0) {
      if (phase == 1 && a.has_second) {
        phase = 2;
        continue;
      }
      break;  // give up
    }
    // pop_first: the picked queue's cursor
    const int k = phase == 1 ? c1[pick] : c2[pick];
    if (k >= V) continue;  // unreachable: the pick has an available candidate
    const bool own = pick == hrow && phase == 1;
    // lca_of: the target's first ancestor that is also a head ancestor
    const int* tpath = lpath + (size_t)pick * D1;
    const int tn = lane < D1 ? tpath[min(lane, D1 - 1)] : -1;
    const unsigned in_anc = __ballot_sync(kFull, tn >= 0 && ((ancm >> tn) & 1));
    const int lca = in_anc ? tpath[__ffs(in_anc) - 1] : tpath[0];
    const int tnode = almost_lca(tpath, lca);
    const long long pre_share = drs[almost_lca(hpath, lca)];
    const long long tgt_old = drs[tnode];
    // the probe removal, undone below when the gate rejects it; the
    // target's DRS after it only where the gate reads it
    move(k, tpath, -1, 1);
    const bool final_gate = phase == 1 && !own && a.strategy1 == kLessThanOrEqualToFinal;
    const long long tgt_new = final_gate ? node_drs(tnode) : 0;
    const bool allowed1 = final_gate ? pre_share <= tgt_new : pre_share < tgt_old;
    const bool allowed2 = pre_share < tgt_old;
    const bool accept = own || (phase == 1 && allowed1) || (phase == 2 && allowed2);
    if (accept) {
      path_drs(tpath);
    } else {
      move(k, tpath, 1, -1);
    }
    // the candidate's state, the cursors, the rows' masks
    const unsigned long long pbit = 1ull << pick;
    if (lane == 0) {
      if (accept) {
        kst[k] |= kRemoved;
        order[n_removed] = k;
      } else if (phase == 1) {
        kst[k] |= kRetried;
        if (!(has2 & pbit)) c2[pick] = k;  // the row's first retried one
      }
    }
    if (phase == 1 && !accept) has2 |= pbit;
    // the second strategy drops the picked queue whatever the gate says
    if (phase == 2) pruned |= pbit;
    __syncwarp();
    if (phase == 1 || accept) {
      const int nx = next_of(pick, k, phase);
      if (lane == 0) (phase == 1 ? c1 : c2)[pick] = nx;
      if (nx >= V) {
        if (phase == 1) {
          has1 &= ~pbit;
        } else {
          has2 &= ~pbit;
        }
      }
      __syncwarp();
    }
    if (!accept) continue;
    ++n_removed;
    if (fits_without_head()) {
      fit_found = true;
      break;
    }
  }
  if (!fit_found) return;
  // fill-back: reverse removal order, skipping the last removal
  move_head(-1);
  for (int s = n_removed - 2; s >= 0; --s) {
    const int k = order[s];
    const int* vpath = lpath + (size_t)krow[k] * D1;
    move(k, vpath, 1, 0);
    if (fits()) {
      if (lane == 0) kst[k] &= ~kRemoved;
    } else {
      move(k, vpath, -1, 0);
    }
    __syncwarp();
  }
  for (int k = lane; k < nv; k += 32) {
    if (kst[k] & kRemoved) targets[pm[kj[k]]] = 1;
  }
  if (lane == 0) a.p.psuccess[q] = 1;
}

}  // namespace
}  // namespace drain

extern "C" int drain_fair_preempt_search(const int* ints, int n_ints, void* const* ptrs,
                                         int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  const int R = a.n_res + 1;
  if (a.P * a.C > 32 || a.p.targets == nullptr || a.fp.pq_cu == nullptr || a.M < 1 ||
      a.M > drain::kMaxM || a.Cu > drain::kMaxCu || R > drain::kMaxR || a.D + 1 > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int lim = drain::kMaxSmem;
  if (drain::plan(a, false).total > (size_t)lim) return (int)cudaErrorInvalidValue;
  const int kq = drain::plan(a, true).total <= (size_t)lim;
  const size_t smem = drain::plan(a, kq).total;
  // 256 threads where the panels are wide (their staging is most of a
  // search), else 128: both measured at the caps and at fair-preempt-1k
  const bool wide = a.M * a.Cu >= 1024;
  auto kern = wide ? drain::search<256> : drain::search<128>;
  const int threads = wide ? 256 : 128;
  if (smem + sizeof(drain::Sh) > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.Q > 0) kern<<<a.Q, threads, smem, (cudaStream_t)stream>>>(a, kq);
  return (int)cudaGetLastError();
}
