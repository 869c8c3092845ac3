// Kernel 5 (B7), drain_fair_phase2: one fair-sharing drain cycle's
// conflict resolution, in place of drain_phase2.
//
// Replaces the step scan of kueue_tpu/ops/drain_kernel.py
// solve_drain_fair (:1360-1437) with _fair_chain (:1179) and
// _fair_tournament (:1238). Each of n_steps steps pops one head per
// root cohort:
//   1-2. the remaining heads' DRS chains and the bottom-up tournament
//      (fair_pop.cuh, shared with the fair-preempt drain's step scan);
//   3. the root's winner is checked for fit along its path and admits
//      (or, a blocked preempt-mode head of a reclaimWithinCohort=Never
//      queue, reserves: the borrow cap or the nominal cap by its
//      borrow bit), bubbling each node's over-guaranteed delta up the
//      path, as drain_phase2 does; its admission is added to the leaf
//      usage (reservations die with the cycle).
// Winners are one per root cohort and roots own disjoint tree rows, so
// one block per root segment needs no synchronisation with the others.
//
// Design: one block a root segment (256 threads where the segments fit
// in one wave of a block an SM, else 128). At launch the block stages
// the segment in shared memory: the remaining heads' keys, cells and
// quantities (a warp's table each, so their loads overlap), the nodes on
// their paths numbered locally (a hash of tree rows in shared memory,
// then a ballot compaction), each node's lendable, weight, parent and
// local path, and its usage, subtree, guaranteed and borrowing-limit
// rows (device memory when they do not fit: a template, chosen by the
// entry), then each node's borrowed sums. A pop then recomputes only the
// chains of heads whose path holds a non-root node the last charge
// touched (the root's share is 0), ranks a warp a parent a level, and
// gives the winner its fit and charge on one warp, a lane a cell,
// updating the charged nodes' sums. The usage rows are written back
// after the pops.
//
// What bounds it: latency: the pops are sequential within a segment,
// each a few block barriers, a warp reduction a parent a level and the
// winner's bubble along its path (chip_smoke.py counts each launch's
// bytes from its data, kernel_ab its chain). A set `done` flag makes the
// launch a no-op. A drain whose largest segment's heads and nodes do not
// fit in a block's shared memory (some 900 heads at the headline's 3
// cells a head) runs the step scan over device memory instead
// (drain_fair_tournament.cuh).

#include "drain_fair_tournament.cuh"
#include "fair_pop.cuh"

namespace drain {
namespace {

using namespace fair_pop;

// Byte offsets of the block's shared memory for the largest segment's m
// heads and at most min(m(D+1), N) nodes on their paths; `rows`: the
// segment's four row arrays (and res_of_fr) are staged.
struct Layout {
  size_t node_of, lpar, depth, haspar, haschild, npath, plist, poff, win, wstep, weight, lend,
      bsum;
  size_t hkey, hown, hlid;
  size_t hq, hnode, hd, hcq, hpath, hcell, hres, hflag, htie, hts, hqty, hnom, hchain;
  size_t delta, bd, bdl, tn;
  size_t rows[4], res;
  size_t nodes, hsize, total;
};

__host__ __device__ inline Layout plan(const Args& a, int threads, bool rows) {
  const size_t m = a.max_members > 0 ? a.max_members : 1, D1 = a.D + 1;
  const size_t R = a.n_res, PC = (size_t)a.P * a.C, FR = a.FR;
  const size_t N = a.N > 0 ? a.N : 1, M = m * D1 < N ? m * D1 : N;
  size_t H = 32;
  while (H < 2 * M) H *= 2;
  Layout L = {};
  Bump b;
  L.nodes = M;
  L.hsize = H;
  L.weight = b.take(8 * M);
  L.lend = b.take(8 * M * R);
  L.bsum = b.take(8 * M * R);
  L.htie = b.take(8 * m);
  L.hts = b.take(8 * m);
  L.hqty = b.take(8 * m * PC);
  L.hnom = b.take(8 * m * PC);
  L.hchain = b.take(8 * m * D1);
  L.delta = b.take(8 * threads * PC);
  L.bd = b.take(8 * threads * PC);
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
  L.tn = b.take(4 * D1);
  L.hkey = b.take(4 * H);
  L.hown = b.take(4 * H);
  L.hlid = b.take(4 * H);
  L.hq = b.take(4 * m);
  L.hnode = b.take(4 * m);
  L.hd = b.take(4 * m);
  L.hcq = b.take(4 * m);
  L.hpath = b.take(4 * m * D1);
  L.hcell = b.take(4 * m * PC);
  L.hres = b.take(4 * m * PC);
  L.hflag = b.take(m);
  if (rows) {
    for (int k = 0; k < 4; ++k) L.rows[k] = b.take(8 * M * FR);
    L.res = b.take(4 * FR);
  }
  L.total = b.off;
  return L;
}

struct Sh {
  int n_rem, n_nodes, root;
};

__device__ __forceinline__ unsigned slot_of(int node, unsigned H) {
  return ((unsigned)node * 2654435761u) & (H - 1);
}

// the hash slot of tree row `node` (present)
__device__ __forceinline__ unsigned find(const int* hkey, int node, unsigned H) {
  unsigned s = slot_of(node, H);
  while (hkey[s] != node) s = (s + 1) & (H - 1);
  return s;
}

template <bool kRows, int kThreads>
__global__ void __launch_bounds__(kThreads, 1) fair_phase2(Args a) {
  if (*a.s.done) return;
  const int s = blockIdx.x;
  if (s >= a.n_seg) return;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Sh sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int FR = a.FR, D1 = a.D + 1, R = a.n_res, PC = a.P * a.C;
  const int beg = a.seg_offsets[s], m = a.seg_offsets[s + 1] - beg;
  const int* members = a.seg_members + beg;

  const Layout L = plan(a, kThreads, kRows);
  const unsigned H = (unsigned)L.hsize;
  long long* weight = (long long*)(smem + L.weight);
  long long* lend = (long long*)(smem + L.lend);
  long long* bsum = (long long*)(smem + L.bsum);
  long long* htie = (long long*)(smem + L.htie);
  long long* hts = (long long*)(smem + L.hts);
  long long* hqty = (long long*)(smem + L.hqty);
  long long* hnom = (long long*)(smem + L.hnom);
  long long* hchain = (long long*)(smem + L.hchain);
  long long* delta_s = (long long*)(smem + L.delta);
  long long* bd_s = (long long*)(smem + L.bd);
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
  int* tn = (int*)(smem + L.tn);
  int* hkey = (int*)(smem + L.hkey);
  int* hown = (int*)(smem + L.hown);
  int* hlid = (int*)(smem + L.hlid);
  int* hq = (int*)(smem + L.hq);
  int* hnode = (int*)(smem + L.hnode);
  int* hd = (int*)(smem + L.hd);
  int* hcq = (int*)(smem + L.hcq);
  int* hpath = (int*)(smem + L.hpath);
  int* hcell = (int*)(smem + L.hcell);
  int* hres = (int*)(smem + L.hres);
  uint8_t* hflag = smem + L.hflag;

  Rows<kRows> rw;
  rw.node_of = node_of;
  rw.FR = FR;
  const int* res;
  if (kRows) {
    rw.U = (long long*)(smem + L.rows[0]);
    rw.SUB = (long long*)(smem + L.rows[1]);
    rw.G = (long long*)(smem + L.rows[2]);
    rw.BL = (long long*)(smem + L.rows[3]);
    res = (const int*)(smem + L.res);
  } else {
    rw.U = a.b.usage;
    rw.SUB = const_cast<long long*>(a.t.subtree);
    rw.G = const_cast<long long*>(a.t.guaranteed);
    rw.BL = const_cast<long long*>(a.t.borrowing_limit);
    res = a.f.res_of_fr;
  }
  rw.F = rw.U;
  rw.LEAF = nullptr;

  // ---- staging: A, the heads' tables and paths, a warp each (their
  // loads overlap) ----
  for (unsigned h = tid; h < H; h += kThreads) hkey[h] = -1;
  for (int l = tid; l < (int)L.nodes; l += kThreads) {
    haschild[l] = 0;
    wstep[l] = -1;
  }
  if (warp == 0) {
    for (int i = lane; i < m; i += 32) {
      const int x = members[i];
      const int cur = min(a.s.cursor[x], a.L - 1);
      const bool active = a.s.cursor[x] < a.q.qlen[x] && a.s.alive[x];
      const bool fit = a.b.is_fit[x], pre = a.b.is_pre[x];
      const int cq = a.q.cq_rows[x];
      const bool rem = active && (fit || pre) && cq >= 0;
      hq[i] = x;
      hcq[i] = rem ? cq : -1;
      hd[i] = a.f.depth_of[max(cq, 0)];
      htie[i] = a.prio_tie ? -a.q.priority[(size_t)x * a.L + cur] : 0;
      hts[i] = a.q.timestamp[(size_t)x * a.L + cur];
      hflag[i] = (rem ? kRem | kStale : 0) | (fit ? kFitF : 0) | (pre ? kPre : 0) |
                 (a.q.no_reclaim[x] ? kNoRe : 0) | (a.b.head_borrow[x] ? kBorrow : 0);
      for (int d = 0; d < D1; ++d) hpath[i * D1 + d] = rem ? a.t.paths[(size_t)cq * D1 + d] : -1;
    }
  } else if (warp == 1) {
#pragma unroll 4
    for (int i = lane; i < m * PC; i += 32) {
      const int x = members[i / PC];
      const int cell = a.b.cells_eff[(size_t)x * PC + i % PC];
      const long long qv = a.b.qty_eff[(size_t)x * PC + i % PC];
      const bool ok = cell >= 0 && qv > 0;
      hcell[i] = ok ? cell : -1;
      hqty[i] = qv;
      hres[i] = ok ? a.f.res_of_fr[cell] : R;
      // the leaf's nominal quota there, for a reservation's caps
      hnom[i] = ok ? a.t.nominal[(size_t)max(a.q.cq_rows[x], 0) * FR + cell] : 0;
    }
    if (kRows) {
      int* res_s = (int*)(smem + L.res);
      for (int fr = lane; fr < FR; fr += 32) res_s[fr] = a.f.res_of_fr[fr];
    }
  }
  __syncthreads();
  // B: the remaining heads' path nodes into the hash, each slot owned by
  // the position that inserted it
  for (int i = tid; i < m * D1; i += kThreads) {
    const int node = hpath[i];
    if (node < 0) continue;
    unsigned sl = slot_of(node, H);
    while (true) {
      const int prev = atomicCAS(&hkey[sl], -1, node);
      if (prev == -1) {
        hown[sl] = i;
        break;
      }
      if (prev == node) break;
      sl = (sl + 1) & (H - 1);
    }
  }
  __syncthreads();
  // local ids in slot order (warp 0)
  if (warp == 0) {
    int base = 0;
    for (unsigned h0 = 0; h0 < H; h0 += 32) {
      const unsigned h = h0 + lane;
      const bool used = hkey[h] >= 0;
      const unsigned bal = __ballot_sync(kFull, used);
      if (used) {
        const int l = base + __popc(bal & ((1u << lane) - 1));
        hlid[h] = l;
        node_of[l] = hkey[h];
      }
      base += __popc(bal);
    }
    if (lane == 0) sh.n_nodes = base;
  }
  __syncthreads();
  const int M = sh.n_nodes;
  // C: each node's tables and local path (from the position that
  // inserted it), its parent's child flag, the root; each head's node;
  // the rows (the block)
  for (int l = tid; l < M; l += kThreads) {
    const int node = node_of[l];
    const int pos = hown[find(hkey, node, H)];
    const int* path = hpath + (pos / D1) * D1;
    const int d0 = pos % D1;
    for (int k = 0; k < D1; ++k) {
      const int g = d0 + k < D1 ? path[d0 + k] : -1;
      npath[l * D1 + k] = g >= 0 ? hlid[find(hkey, g, H)] : -1;
    }
    const int lp = D1 > 1 ? npath[l * D1 + 1] : -1;
    lpar[l] = lp;
    if (lp >= 0) haschild[lp] = 1;
    else sh.root = l;
    depth[l] = a.f.depth_of[node];
    haspar[l] = a.t.parent[node] >= 0;
    weight[l] = a.f.weight[node];
    for (int r = 0; r < R; ++r) lend[l * R + r] = a.f.lendable[(size_t)node * R + r];
  }
  for (int i = tid; i < m; i += kThreads) {
    hnode[i] = hcq[i] >= 0 ? hlid[find(hkey, hcq[i], H)] : -1;
  }
  if (kRows) {
#pragma unroll 4
    for (int i = tid; i < M * FR; i += kThreads) {
      const size_t x = (size_t)node_of[i / FR] * FR + i % FR;
      rw.U[i] = a.b.usage[x];
      rw.SUB[i] = a.t.subtree[x];
      rw.G[i] = a.t.guaranteed[x];
      rw.BL[i] = a.t.borrowing_limit[x];
    }
  }
  __syncthreads();
  // D: node sums, parents by depth, the count of heads to pop
  node_sums<kRows, kThreads>(rw, res, M, FR, R, bsum);
  if (warp == 0) {
    parents_by_depth(node_of, haschild, depth, M, D1, plist, poff);
    int n = 0;
    for (int i = lane; i < m; i += 32) n += hflag[i] & kRem;
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kFull, n, o);
    if (lane == 0) sh.n_rem = n;
    for (int d = lane; d < D1; d += 32) tn[d] = -1;
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
    // 1. the chains of the heads whose path holds a node the last
    // charge touched: node t of depth dt is on head i's path iff the
    // path's entry at depth dt is t
    for (int i = tid; i < m; i += kThreads) {
      const uint8_t f = hflag[i];
      if (!(f & kRem)) continue;
      bool dirty = f & kStale;
      const int* path = npath + (size_t)hnode[i] * D1;
      for (int k = 0; k < D1 && !dirty; ++k) {
        const int t = tn[k];
        const int at = t >= 0 ? hd[i] - depth[t] : -1;
        dirty = at >= 0 && at < D1 && path[at] == t;
      }
      if (!dirty) continue;
      hflag[i] = f & ~kStale;
      chain(P, rw, i, delta_s + (size_t)tid * PC, bd_s + (size_t)tid * PC);
    }
    propose<kThreads>(P, step);
    __syncthreads();
    // 2. the tournament, bottom-up: a warp a parent
    const int h = tournament<kThreads>(P, sh.root, step);
    if (h < 0) break;  // no winner: every later step is the same
    // 3. the winner's fit, admission or reservation, and the charge
    if (warp == 0) {
      const uint8_t f = hflag[h];
      const int x = hq[h], cq_l = hnode[h];
      const int* path = npath + (size_t)cq_l * D1;
      int cell = -1;
      long long qv = 0;
      if (lane < PC) {
        cell = hcell[(size_t)h * PC + lane];
        qv = hqty[(size_t)h * PC + lane];
      }
      const bool valid = cell >= 0;
      const bool ok = !valid || avail(rw, rw.U, path, D1, cell) >= qv;
      const bool fits = __all_sync(kFull, ok);
      const bool admit = (f & kFitF) && fits;
      const bool reserve = (f & kPre) && (f & kNoRe);
      const bool charged = valid && (admit || reserve);
      if (lane < PC) {
        for (int d = 0; d < D1; ++d) bdl[(size_t)lane * D1 + d] = 0;
      }
      if (charged) {
        const size_t lx = rw.at(cq_l, cell);
        const size_t gx = (size_t)node_of[cq_l] * FR + cell;
        long long delta = qv;
        if (!admit) {
          const long long nom = hnom[(size_t)h * PC + lane], bl = rw.BL[lx], leaf = rw.U[lx];
          const long long borrow_cap = bl < kNoLimit ? min(qv, nom + bl - leaf) : qv;
          const long long nominal_cap = max(0LL, min(qv, nom - leaf));
          delta = (f & kBorrow) ? borrow_cap : nominal_cap;
        }
        fair_pop::charge(rw, path, D1, cell, delta, bdl + (size_t)lane * D1);
        // the leaf usage, read by no pop of this launch: a reduction the
        // warp does not wait for
        if (admit) atomicAdd((unsigned long long*)&a.s.local[gx], (unsigned long long)qv);
      }
      const bool any_charge = __any_sync(kFull, charged);
      __syncwarp();
      if (any_charge) add_sums(P, h, path, bdl);
      for (int d = lane; d < D1; d += 32) {
        const int t = path[d];
        tn[d] = any_charge && t >= 0 && t != sh.root ? t : -1;
      }
      if (lane == 0) {
        a.b.admitted[x] = admit;
        hflag[h] = f & ~kRem;
        sh.n_rem -= 1;
      }
    }
    __syncthreads();
  }

  // ---- write back ----
  if (kRows) {
    for (int i = tid; i < M * FR; i += kThreads) {
      a.b.usage[(size_t)node_of[i / FR] * FR + i % FR] = rw.U[i];
    }
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_fair_phase2(const int* ints, int n_ints, void* const* ptrs,
                                 int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.n_res < 1 || a.n_res > drain::kMaxR) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n_seg == 0) return (int)cudaGetLastError();
  const int lim = drain::fair_pop::kMaxSmem;
  // a block an SM when the segments fit in one wave of them, else two
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int threads = a.n_seg <= sms ? 256 : 128;
  if (drain::plan(a, threads, false).total > (size_t)lim) {
    if (a.f.chain == nullptr || a.f.flags == nullptr) return (int)cudaErrorInvalidValue;
    drain::fair_tournament::device_phase2<<<a.n_seg, drain::fair_tournament::kThreads, 0,
                                             (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
  }
  const bool rows = drain::plan(a, threads, true).total <= (size_t)lim;
  const size_t smem = drain::plan(a, threads, rows).total;
  auto kern = rows ? (threads == 256 ? drain::fair_phase2<true, 256> : drain::fair_phase2<true, 128>)
                   : (threads == 256 ? drain::fair_phase2<false, 256>
                                     : drain::fair_phase2<false, 128>);
  if (smem + sizeof(drain::Sh) > 48 * 1024) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kern<<<a.n_seg, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
