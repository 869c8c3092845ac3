// Kernel B11b, drain_fair_preempt_phase2: the fair-preempt drain cycle's
// admissions.
//
// Replaces the step scan of kueue_tpu/ops/drain_kernel.py
// solve_drain_fair_preempt (:2604-2742), with its DRS chains
// (_fair_chain, :1179) and tournament (_fair_tournament, :1238). Each of
// n_steps steps pops one head per root cohort by the fair-sharing
// tournament against the live usage and gives the popped head its
// disposition, as the classic preempt drain (drain_preempt_phase2.cu)
// does:
//   - a preempter whose targets overlap an earlier eviction of the cycle
//     is skipped (the overlapping-preemption-targets guard);
//   - the head's fit is checked with EVERY accepted victim of the cycle
//     removed, and its own targets when it preempts: the host's
//     non-incremental fits-after-removals (the fair iterator reads usage
//     with the victims present, so the removals live only inside the fit
//     check);
//   - an admitted head or a successful preempter charges its usage
//     (AddUsage runs for both, scheduler.go:211-292); a blocked preempt
//     head of a queue with reclaimWithinCohort != Any reserves (borrow or
//     nominal cap);
//   - a successful preempter's victims join this cycle's evictions,
//     attributed to its queue.
//
// Design: one block a root segment (256 threads where the segments fit
// in one wave of a block an SM, else 128, two an SM: both measured at
// the caps and at fair-preempt-1k); segments own disjoint tree rows and
// pool rows, so blocks need no synchronisation.
// At launch the block stages its segment in shared memory: the M nodes'
// usage, subtree, guaranteed, borrowing-limit and leaf rows (device
// memory when they do not fit: a template, chosen by the entry from M
// and FR), each node's lendable, weight, local path and parent, each
// head's keys, path, cells and quantities, the pool's slots and the
// preempters' targets as bits (where they fit): the small tables a warp
// each, so their dependent loads overlap, then the rows and the bits by
// the whole block, then each node's borrowed sums. Then a pop:
//   - chains: each node keeps its borrowed sum per resource (updated
//     where a charge changes a row), so a head's DRS chain is its path's
//     node sums plus its own cells bubbled up; only heads whose path
//     shares a non-root node with the last charge recompute theirs (the
//     root's share is 0);
//   - the tournament runs a warp a parent, the min of (dws, -priority,
//     timestamp, queue) over its proposing children; no one wins where
//     the smallest dws is >= 2^62;
//   - the fit runs on a second usage tree, the segment's usage with the
//     cycle's committed evictions removed, kept by bubbling each
//     victim's cells once when its preempter commits and every charge;
//     the popped head's own targets are bubbled out of its cells'
//     columns and back around its check. Bubbling int64 deltas with the
//     guaranteed max formula gives the tree a rebuild from the leaf rows
//     would, so this is the JAX rebuild exactly.
// Results (usage, leaf rows) are written back after the pops.
//
// What bounds it: latency: the pops are sequential within a segment,
// each a few block barriers, a warp reduction a parent a level and the
// winner's bubbles along its path (chip_smoke.py counts each launch's
// bytes from its data, kernel_ab its chain). A set `done` flag makes the
// launch a no-op.

#include "fair_pop.cuh"

namespace drain {
namespace {

using namespace fair_pop;

// Byte offsets of the block's shared memory. `rows`: the segment's six
// row arrays (and res_of_fr) are staged; `pool`: the pool's slots;
// `tb`: each head's targets as bits. The fixed part always is.
struct Layout {
  size_t node_of, lpar, depth, haspar, haschild, npath, plist, poff, win, wstep;
  size_t weight, lend, bsum;
  size_t hq, hnode, hd, hcell, hres, hflag, htie, hts, hqty, hchain, hdelta, hbd, hmask;
  size_t bdl, ev, tbits, tl;
  size_t rows[6], res;
  size_t pcells, powner, pqty;
  size_t htb;
  size_t total;
};

__host__ __device__ inline Layout plan(const Args& a, bool rows, bool pool, bool tb) {
  const size_t M = a.M, m = a.max_members > 0 ? a.max_members : 1, D1 = a.D + 1;
  const size_t R = a.n_res, PC = (size_t)a.P * a.C, V = a.V, VW = (V + 31) / 32;
  const size_t FR = a.FR, Cv = a.Cv;
  Layout L = {};
  Bump b;
  L.weight = b.take(8 * M);
  L.lend = b.take(8 * M * R);
  L.bsum = b.take(8 * M * R);
  L.htie = b.take(8 * m);
  L.hts = b.take(8 * m);
  L.hqty = b.take(8 * m * PC);
  L.hchain = b.take(8 * m * D1);
  L.hdelta = b.take(8 * m * PC);
  L.hbd = b.take(8 * m * PC);
  L.hmask = b.take(8 * m);
  L.bdl = b.take(8 * PC * D1);
  L.node_of = b.take(4 * M);
  L.lpar = b.take(4 * M);
  L.depth = b.take(4 * M);
  L.haspar = b.take(4 * M);
  L.haschild = b.take(4 * M);
  L.npath = b.take(4 * M * D1);
  L.plist = b.take(4 * M);
  L.poff = b.take(4 * (D1 + 1));
  L.win = b.take(4 * M);
  L.wstep = b.take(4 * M);
  L.hq = b.take(4 * m);
  L.hnode = b.take(4 * m);
  L.hd = b.take(4 * m);
  L.hcell = b.take(4 * m * PC);
  L.hres = b.take(4 * m * PC);
  L.hflag = b.take(m);
  L.ev = b.take(4 * VW);
  L.tbits = b.take(4 * VW);
  L.tl = b.take(4 * V);
  if (rows) {
    for (int k = 0; k < 6; ++k) L.rows[k] = b.take(8 * M * FR);
    L.res = b.take(4 * FR);
  }
  if (pool) {
    L.pqty = b.take(8 * V * Cv);
    L.pcells = b.take(4 * V * Cv);
    L.powner = b.take(4 * V);
  }
  if (tb) L.htb = b.take(4 * m * VW);
  L.total = b.off;
  return L;
}

struct Flags {
  int pool, tb;
};

// The segment's pool slots: staged (`powner`: the local owner, -1 for a
// pad) or the device's.
struct Pool {
  const int* pcells;       // [V,Cv]
  const long long* pqty;   // [V,Cv]
  const int* powner;       // [V] staged, or null
  const int* sowner;       // [V] the device's
  const int* sowner_local;
  int Cv;
  __device__ __forceinline__ int owner(int v) const {
    return powner ? powner[v] : (sowner[v] >= 0 ? sowner_local[v] : -1);
  }
};

// sign x the winner's targets' usage at column `cell`, bubbled up each
// owner's path on the fit tree (one lane a column)
template <bool kRows>
__device__ __forceinline__ void move_targets(const Rows<kRows>& rw, const Pool& pool,
                                             const int* tl, int n_t, const int* npath, int D1,
                                             int cell, long long sign) {
  for (int t = 0; t < n_t; ++t) {
    const int v = tl[t];
    const int ol = pool.owner(v);
    if (ol < 0) continue;
    long long rq = 0;
    for (int cv = 0; cv < pool.Cv; ++cv) {
      if (pool.pcells[(size_t)v * pool.Cv + cv] == cell) rq += pool.pqty[(size_t)v * pool.Cv + cv];
    }
    if (rq != 0) bubble(rw, rw.F, npath + (size_t)ol * D1, D1, cell, sign * rq);
  }
}

struct Sh {
  unsigned long long touched;  // non-root nodes the last pop charged
  int n_rem, winner, root;
};

template <bool kRows, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) phase2(Args a, Flags fl) {
  constexpr int kWarps = kThreads / 32;
  if (*a.s.done) return;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Sh sh;
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = a.V, FR = a.FR, M = a.M, D1 = a.D + 1, R = a.n_res, Cv = a.Cv;
  const int PC = a.P * a.C, VW = (V + 31) / 32;
  const size_t sv = (size_t)s * V;
  for (int v = tid; v < V; v += kThreads) {
    a.p.ev_now[sv + v] = 0;
    a.p.ev_by[sv + v] = -1;
  }
  if (!kRows || s >= a.n_seg) {
    for (int i = tid; i < M * FR; i += kThreads) {
      const int node = a.p.seg_nodes[(size_t)s * M + i / FR];
      if (node < 0) continue;
      const size_t x = (size_t)node * FR + i % FR;
      a.p.leaf[x] = a.s.local[x];
    }
  }
  if (s >= a.n_seg) return;  // no queue in this segment
  const int beg = a.seg_offsets[s], m = a.seg_offsets[s + 1] - beg;
  const int* members = a.seg_members + beg;

  const Layout L = plan(a, kRows, fl.pool, fl.tb);
  long long* weight = (long long*)(smem + L.weight);
  long long* lend = (long long*)(smem + L.lend);
  long long* bsum = (long long*)(smem + L.bsum);
  long long* htie = (long long*)(smem + L.htie);
  long long* hts = (long long*)(smem + L.hts);
  long long* hqty = (long long*)(smem + L.hqty);
  long long* hchain = (long long*)(smem + L.hchain);
  long long* hdelta = (long long*)(smem + L.hdelta);
  long long* hbd = (long long*)(smem + L.hbd);
  unsigned long long* hmask = (unsigned long long*)(smem + L.hmask);
  long long* bdl = (long long*)(smem + L.bdl);
  int* node_of = (int*)(smem + L.node_of);
  int* lpar = (int*)(smem + L.lpar);
  int* depth = (int*)(smem + L.depth);
  int* haspar = (int*)(smem + L.haspar);
  int* haschild = (int*)(smem + L.haschild);
  int* npath = (int*)(smem + L.npath);
  int* plist = (int*)(smem + L.plist);
  int* poff = (int*)(smem + L.poff);
  int* win = (int*)(smem + L.win);
  int* wstep = (int*)(smem + L.wstep);
  int* hq = (int*)(smem + L.hq);
  int* hnode = (int*)(smem + L.hnode);
  int* hd = (int*)(smem + L.hd);
  int* hcell = (int*)(smem + L.hcell);
  int* hres = (int*)(smem + L.hres);
  uint8_t* hflag = smem + L.hflag;
  unsigned* ev = (unsigned*)(smem + L.ev);
  unsigned* tbits = (unsigned*)(smem + L.tbits);
  int* tl = (int*)(smem + L.tl);
  unsigned* htb = (unsigned*)(smem + L.htb);

  Rows<kRows> rw;
  rw.node_of = node_of;
  rw.FR = FR;
  const int* res;
  if (kRows) {
    rw.U = (long long*)(smem + L.rows[0]);
    rw.F = (long long*)(smem + L.rows[1]);
    rw.SUB = (long long*)(smem + L.rows[2]);
    rw.G = (long long*)(smem + L.rows[3]);
    rw.BL = (long long*)(smem + L.rows[4]);
    rw.LEAF = (long long*)(smem + L.rows[5]);
    res = (const int*)(smem + L.res);
  } else {
    rw.U = a.b.usage;
    rw.F = a.fit_usage;
    rw.SUB = const_cast<long long*>(a.t.subtree);
    rw.G = const_cast<long long*>(a.t.guaranteed);
    rw.BL = const_cast<long long*>(a.t.borrowing_limit);
    rw.LEAF = a.p.leaf;
    res = a.f.res_of_fr;
  }
  const size_t svc = sv * Cv;
  Pool pool;
  pool.pcells = fl.pool ? (const int*)(smem + L.pcells) : a.p.pcells + svc;
  pool.pqty = fl.pool ? (const long long*)(smem + L.pqty) : a.p.pqty + svc;
  pool.powner = fl.pool ? (const int*)(smem + L.powner) : nullptr;
  pool.sowner = a.p.sowner + sv;
  pool.sowner_local = a.p.sowner_local + sv;
  pool.Cv = Cv;
  const int* lp_seg = a.p.lpaths + (size_t)s * M * D1;

  // ---- staging: A, the tables, a warp each (their loads overlap) ----
  if (warp == 0) {
    for (int l = lane; l < M; l += 32) {
      const int node = a.p.seg_nodes[(size_t)s * M + l];
      const int nn = max(node, 0);
      node_of[l] = node;
      lpar[l] = node >= 0 && D1 > 1 ? lp_seg[(size_t)l * D1 + 1] : -1;
      depth[l] = node >= 0 ? a.f.depth_of[nn] : -1;
      haspar[l] = node >= 0 && a.t.parent[nn] >= 0;
      haschild[l] = 0;
      weight[l] = a.f.weight[nn];
      wstep[l] = -1;
      for (int d = 0; d < D1; ++d) npath[l * D1 + d] = lp_seg[(size_t)l * D1 + d];
      for (int r = 0; r < R; ++r) lend[l * R + r] = a.f.lendable[(size_t)nn * R + r];
    }
  } else if (warp == 1) {
    for (int i = lane; i < m; i += 32) {
      const int x = members[i];
      const int cur = min(a.s.cursor[x], a.L - 1);
      const bool active = a.s.cursor[x] < a.q.qlen[x] && a.s.alive[x];
      const bool fit = a.b.is_fit[x], pre = a.b.is_pre[x];
      const bool rem = active && (fit || pre) && a.q.cq_rows[x] >= 0;
      hq[i] = x;
      hnode[i] = a.p.hlocal[x];
      hd[i] = a.f.depth_of[max(a.q.cq_rows[x], 0)];
      htie[i] = a.prio_tie ? -a.q.priority[(size_t)x * a.L + cur] : 0;
      hts[i] = a.q.timestamp[(size_t)x * a.L + cur];
      hflag[i] = (rem ? kRem | kStale : 0) | (fit ? kFitF : 0) | (pre ? kPre : 0) |
                 (a.p.psuccess[x] ? kPs : 0) | (a.q.no_reclaim[x] ? kNoRe : 0) |
                 (a.b.head_borrow[x] ? kBorrow : 0);
    }
  } else if (warp == 2) {
#pragma unroll 4
    for (int i = lane; i < m * PC; i += 32) {
      const int x = members[i / PC];
      const int cell = a.b.cells_eff[(size_t)x * PC + i % PC];
      const long long qv = a.b.qty_eff[(size_t)x * PC + i % PC];
      const bool ok = cell >= 0 && qv > 0;
      hcell[i] = ok ? cell : -1;
      hqty[i] = qv;
      hres[i] = ok ? a.f.res_of_fr[cell] : R;
    }
    if (kRows) {
      int* res_s = (int*)(smem + L.res);
      for (int fr = lane; fr < FR; fr += 32) res_s[fr] = a.f.res_of_fr[fr];
    }
  } else if (warp == 3) {
    for (int w = lane; w < VW; w += 32) ev[w] = 0;
    if (fl.pool) {
      int* pc_s = (int*)(smem + L.pcells);
      long long* pq_s = (long long*)(smem + L.pqty);
      int* po_s = (int*)(smem + L.powner);
#pragma unroll 4
      for (int i = lane; i < V * Cv; i += 32) {
        pc_s[i] = a.p.pcells[svc + i];
        pq_s[i] = a.p.pqty[svc + i];
      }
      for (int v = lane; v < V; v += 32) {
        po_s[v] = a.p.sowner[sv + v] >= 0 ? a.p.sowner_local[sv + v] : -1;
      }
    }
  }
  __syncthreads();
  // B, the block: the rows, and the preempters' targets as bits (a
  // thread a head's 32 slots, read four at a time where V allows)
  if (kRows) {
#pragma unroll 4
    for (int i = tid; i < M * FR; i += kThreads) {
      const int node = node_of[i / FR];
      long long u = 0, sub = 0, g = 0, bl = 0, lf = 0;
      if (node >= 0) {
        const size_t x = (size_t)node * FR + i % FR;
        u = a.b.usage[x];
        sub = a.t.subtree[x];
        g = a.t.guaranteed[x];
        bl = a.t.borrowing_limit[x];
        lf = a.s.local[x];
      }
      rw.U[i] = u;
      rw.F[i] = u;
      rw.SUB[i] = sub;
      rw.G[i] = g;
      rw.BL[i] = bl;
      rw.LEAF[i] = lf;
    }
  } else {
    for (int i = tid; i < M * FR; i += kThreads) {
      const int node = node_of[i / FR];
      if (node < 0) continue;
      const size_t x = (size_t)node * FR + i % FR;
      rw.F[x] = a.b.usage[x];
    }
  }
  if (fl.tb) {
    const bool by4 = (V & 3) == 0;
    for (int i = tid; i < m * VW; i += kThreads) {
      const int hi = i / VW, w = i % VW;
      unsigned word = 0;
      if ((hflag[hi] & (kRem | kPs | kPre)) == (kRem | kPs | kPre)) {
        const uint8_t* row = a.p.targets + (size_t)hq[hi] * V + 32 * w;
        if (by4) {
          const unsigned* r4 = (const unsigned*)row;
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            if (32 * w + 4 * k >= V) break;
            const unsigned b = r4[k];  // four bool bytes
            word |= ((b & 1) | ((b >> 7) & 2) | ((b >> 14) & 4) | ((b >> 21) & 8)) << (4 * k);
          }
        } else {
          for (int k = 0; k < 32 && 32 * w + k < V; ++k) word |= (row[k] ? 1u : 0u) << k;
        }
      }
      htb[i] = word;
    }
  }
  for (int l = tid; l < M; l += kThreads) {
    if (node_of[l] >= 0 && lpar[l] >= 0) haschild[lpar[l]] = 1;
    if (node_of[l] >= 0 && lpar[l] < 0) sh.root = l;
  }
  __syncthreads();
  // C: node sums, parents, masks
  node_sums<kRows, kThreads>(rw, res, M, FR, R, bsum);
  for (int i = tid; i < m; i += kThreads) {
    const int* path = npath + (size_t)hnode[i] * D1;
    unsigned long long mask = 0;
    for (int d = 0; d < D1; ++d) {
      if (path[d] >= 0 && path[d] != sh.root) mask |= 1ull << path[d];
    }
    hmask[i] = mask;
  }
  if (warp == 0) {
    parents_by_depth(node_of, haschild, depth, M, D1, plist, poff);
    int n = 0;
    for (int i = lane; i < m; i += 32) n += hflag[i] & kRem;
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if (lane == 0) {
      sh.n_rem = n;
      sh.touched = 0;
    }
  }
  __syncthreads();

  // ---- the pops ----
  Pop P;
  P.weight = weight;
  P.lend = lend;
  P.bsum = bsum;
  P.htie = htie;
  P.hts = hts;
  P.hqty = hqty;
  P.hchain = hchain;
  P.lpar = lpar;
  P.depth = depth;
  P.haspar = haspar;
  P.npath = npath;
  P.plist = plist;
  P.poff = poff;
  P.hq = hq;
  P.hnode = hnode;
  P.hd = hd;
  P.hcell = hcell;
  P.hres = hres;
  P.win = win;
  P.wstep = wstep;
  P.hflag = hflag;
  P.m = m;
  P.M = M;
  P.D1 = D1;
  P.R = R;
  P.PC = PC;
  for (int step = 0; step < a.n_steps && sh.n_rem > 0; ++step) {
    // 1. the chains of the heads whose path the last charge touched
    const unsigned long long touched = sh.touched;
    for (int i = tid; i < m; i += kThreads) {
      const uint8_t f = hflag[i];
      if (!(f & kRem) || (!(f & kStale) && !(hmask[i] & touched))) continue;
      hflag[i] = f & ~kStale;
      chain(P, rw, i, hdelta + (size_t)i * PC, hbd + (size_t)i * PC);
    }
    propose<kThreads>(P, step);
    __syncthreads();
    // 2. the tournament, bottom-up: every node at depth d with a winner
    // proposes to its parent; a warp a parent takes the smallest key
    if (tid == 0) sh.touched = 0;  // every thread has read it
    const int h = tournament<kThreads>(P, sh.root, step);
    if (h < 0) break;  // no winner: every later step is the same
    const uint8_t f = hflag[h];
    const int x = hq[h];
    const bool ps = f & kPs, is_pre = f & kPre, is_fit = f & kFitF;
    // 3. the winner's targets and the overlap guard
    bool ov = false;
    if (ps) {
      if (fl.tb) {
        for (int w = tid; w < VW; w += kThreads) tbits[w] = htb[(size_t)h * VW + w];
      } else {
        for (int w = warp; w < VW; w += kWarps) {
          const int v = 32 * w + lane;
          const bool t = v < V && a.p.targets[(size_t)x * V + v];
          const unsigned word = __ballot_sync(kFull, t);
          if (lane == 0) tbits[w] = word;
        }
      }
      __syncthreads();
      for (int w = tid; w < VW; w += kThreads) ov = ov || (tbits[w] & ev[w]) != 0;
    }
    ov = __syncthreads_or(ov);
    const bool do_pre = is_pre && ps && !ov;
    if (warp == 0) {
      // the target slots, compacted
      int n_t = 0;
      if (do_pre) {
        for (int w0 = 0; w0 < VW; w0 += 32) {
          const int w = w0 + lane;
          unsigned word = w < VW ? tbits[w] : 0;
          const int c = __popc(word);
          int incl = c;
          for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(kFull, incl, o);
            if (lane >= o) incl += y;
          }
          int at = n_t + incl - c;
          while (word) {
            tl[at++] = 32 * w + __ffs(word) - 1;
            word &= word - 1;
          }
          n_t += __shfl_sync(kFull, incl, 31);
        }
        __syncwarp();
      }
      // 4. the fit with the cycle's evictions and the own targets removed
      const int* path = npath + (size_t)hnode[h] * D1;
      int cell = -1;
      long long qv = 0;
      if (lane < PC) {
        cell = hcell[(size_t)h * PC + lane];
        qv = hqty[(size_t)h * PC + lane];
      }
      const bool valid = cell >= 0;
      const bool own = do_pre && valid;
      if (own) move_targets(rw, pool, tl, n_t, npath, D1, cell, -1);
      const bool ok = !valid || avail(rw, rw.F, path, D1, cell) >= qv;
      if (own) move_targets(rw, pool, tl, n_t, npath, D1, cell, 1);
      const bool fits = __all_sync(kFull, ok);
      // 5. the charge: admitted heads, successful preempters, reserves
      const bool admit = is_fit && fits;
      const bool pre_ok = do_pre && fits;
      const bool reserve = is_pre && !ps && (f & kNoRe);
      const bool charge = valid && (admit || pre_ok || reserve);
      if (lane < PC) {
        for (int d = 0; d < D1; ++d) bdl[(size_t)lane * D1 + d] = 0;
      }
      if (charge) {
        const int cq_l = hnode[h];
        const size_t lx = rw.at(cq_l, cell);
        long long delta = qv;
        if (!(admit || pre_ok)) {
          const long long nom = a.t.nominal[(size_t)node_of[cq_l] * FR + cell];
          const long long bl = rw.BL[lx], leaf = rw.LEAF[lx];
          const long long borrow_cap = bl < kNoLimit ? min(qv, nom + bl - leaf) : qv;
          const long long nominal_cap = max(0LL, min(qv, nom - leaf));
          delta = (f & kBorrow) ? borrow_cap : nominal_cap;
        }
        rw.LEAF[lx] += delta;
        fair_pop::charge(rw, path, D1, cell, delta, bdl + (size_t)lane * D1);
        bubble(rw, rw.F, path, D1, cell, delta);
      }
      const bool any_charge = __any_sync(kFull, charge);
      __syncwarp();
      if (any_charge) add_sums(P, h, path, bdl);
      // 6. a successful preempter's victims join the cycle's evictions:
      // out of the fit tree once, a lane a column
      if (pre_ok) {
        for (int w = lane; w < VW; w += 32) ev[w] |= tbits[w];
        for (int t = lane; t < n_t; t += 32) {
          a.p.ev_now[sv + tl[t]] = 1;
          a.p.ev_by[sv + tl[t]] = x;
        }
        for (int t = 0; t < n_t; ++t) {
          const int v = tl[t];
          const int ol = pool.owner(v);
          if (ol < 0) continue;
          for (int cv = 0; cv < Cv; ++cv) {
            const int vc = pool.pcells[(size_t)v * Cv + cv];
            if (vc < 0 || (vc & 31) != lane) continue;
            bubble(rw, rw.F, npath + (size_t)ol * D1, D1, vc, -pool.pqty[(size_t)v * Cv + cv]);
          }
        }
      }
      if (lane == 0) {
        a.b.admitted[x] = admit;
        a.p.preempt_ok[x] = pre_ok;
        hflag[h] = f & ~kRem;
        sh.n_rem -= 1;
        if (any_charge) sh.touched = hmask[h];
      }
    }
    __syncthreads();
  }

  // ---- write back ----
  if (kRows) {
    for (int i = tid; i < M * FR; i += kThreads) {
      const int node = node_of[i / FR];
      if (node < 0) continue;
      const size_t x = (size_t)node * FR + i % FR;
      a.b.usage[x] = rw.U[i];
      a.p.leaf[x] = rw.LEAF[i];
    }
  }
  for (int i = tid; i < m; i += kThreads) a.f.flags[hq[i]] = hflag[i] & kRem;
}

}  // namespace
}  // namespace drain

extern "C" int drain_fair_preempt_phase2(const int* ints, int n_ints, void* const* ptrs,
                                         int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.p.leaf == nullptr || a.f.chain == nullptr || a.fp.pq_cu == nullptr ||
      a.n_res < 1 || a.n_res > drain::kMaxR || a.n_seg > a.n_segments || a.M > 64 ||
      a.max_members > a.M) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n_segments == 0) return (int)cudaGetLastError();
  using drain::plan;
  const int lim = drain::kMaxSmem;
  if (plan(a, false, false, false).total > (size_t)lim) return (int)cudaErrorInvalidValue;
  const bool rows = plan(a, true, false, false).total <= (size_t)lim;
  if (!rows && a.fit_usage == nullptr) return (int)cudaErrorInvalidValue;
  drain::Flags fl;
  fl.pool = plan(a, rows, true, false).total <= (size_t)lim;
  fl.tb = plan(a, rows, fl.pool, true).total <= (size_t)lim;
  const size_t smem = plan(a, rows, fl.pool, fl.tb).total;
  // a block an SM (189 registers a thread at 256) when the segments fit
  // in one wave of them, else two an SM at 128
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const bool wide = a.n_segments <= sms;
  auto kern = rows ? (wide ? drain::phase2<true, 256> : drain::phase2<true, 128>)
                   : (wide ? drain::phase2<false, 256> : drain::phase2<false, 128>);
  if (smem + sizeof(drain::Sh) > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kern<<<a.n_segments, wide ? 256 : 128, smem, (cudaStream_t)stream>>>(a, fl);
  return (int)cudaGetLastError();
}
