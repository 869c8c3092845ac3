// Kernel B10b, drain_preempt_phase2: the preempt drain cycle's step
// scan.
//
// Replaces the entry-order lexsort, segmented_rank and the lax.scan
// step loop of kueue_tpu/ops/drain_kernel.py solve_drain_preempt
// (:1988-2166). Per root segment, heads in (borrowing asc, priority
// desc, timestamp asc, queue index asc) order, ranks >= n_steps
// dropped; each head:
//   - is skipped as a preempter when one of its targets was already
//     evicted this cycle (the overlapping-preemption-targets guard);
//   - a preempter removes its victims' full usage at their OWNER leaf
//     rows, then re-checks its fit along its path;
//   - a preempter that no longer fits puts the victims back;
//   - an admitted head or a successful preempter charges its usage
//     (AddUsage runs for both, scheduler.go:211-292), a blocked
//     no-reclaim head reserves (borrowing or nominal cap);
//   - a successful preempter's victims join this cycle's evictions,
//     attributed to its queue.
//
// Design: one block of 128 threads a root segment; segments own
// disjoint tree rows and pool rows, so blocks need no synchronisation.
//   1. Staging, once: each member's keys (borrow bit, priority and
//      timestamp at min(cursor, L-1)), flags, local ClusterQueue, cells
//      and quantities; the M nodes' usage, leaf, guaranteed, subtree,
//      borrowing-limit and nominal rows over FR; the pool's slot owners
//      (as local nodes), cells and quantities; each preempter's targets
//      as V bits. The small tables a warp each (their loads overlap),
//      the rows and the bits by the block. Tables past the block's room
//      stay in device memory: the rows through a template, the others
//      through flags, chosen by the entry from the shapes. A segment
//      with no queue only resets its eviction record and copies its
//      leaf rows.
//   2. Ranking from the staged keys, a thread a member, branchless.
//   3. The walk, on warp 0 with no block barrier. A head's targets are
//      its V-bit mask; the cycle's evictions a mask, so the overlap
//      guard is one AND a word. The removal runs across the lanes, a
//      lane a target slot, each victim cell added into its owner's leaf
//      row and bubbled up the owner's path with atomic adds: each level
//      passes on the change its own add made to the guaranteed max,
//      computed from the value the add found, so concurrent bubbles on
//      one column telescope to the sequential ones' and the tree equals
//      a rebuild from the leaf rows, as the JAX scan's is. A preempter
//      that no longer fits gets its saved rows back (device rows: a
//      second bubble with the opposite sign, exact by the same
//      argument). The evictions are OR-ed into the mask.
//   4. Write-back: usage and leaf rows, ev_now; admitted, preempt_ok
//      and ev_by are written as the walk decides them.
// `local` itself takes only the cycle's admissions and evictions, in
// drain_preempt_motion.cu (perf/lockstep.py holds the kernel to the
// plain version, which rebuilds as the JAX code does, at every cycle).
//
// What bounds it: the walk is sequential within a segment (each head
// sees its predecessors' admissions and evictions): ~5-10 heads a step
// on the contended cluster, a few dependent shared-memory trips each;
// the bytes bound (chip_smoke.py counts each launch's from its data) is
// well below. A set `done` flag makes the launch a no-op.

#include "drain_common.cuh"

namespace drain {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr int kSmemLimit = 232448 - 1024;  // the opt-in limit, less the static part
// member flags
constexpr uint8_t kNom = 1, kFitF = 2, kPreF = 4, kPs = 8, kNoRe = 16, kBor = 32;

struct Bump {
  size_t off = 0;
  __host__ __device__ size_t take(size_t bytes) {
    const size_t at = off;
    off += (bytes + 15) & ~(size_t)15;
    return at;
  }
};

// What is staged beyond the fixed part: the members' tables (`heads`:
// keys, flags, nodes and the walk list; `cells`: their cells and
// quantities; `tb`: their targets as bits) and the pool's slots.
struct Flags {
  int heads, cells, tb, pool;
};

// Byte offsets of the dynamic shared memory.
struct Layout {
  size_t ev, cur, node_of, npath;
  size_t hp, ht, hq, hnode, walk, hflag, hqty, hcell, tbits;
  size_t rows[8];  // usage, leaf, guaranteed, subtree, borrowing limit, nominal, two saves
  size_t pqty, pcells, powner;
  size_t total;
};

__host__ __device__ inline Layout plan(const Args& a, bool rows, Flags f) {
  const size_t M = a.M, m = a.max_members > 0 ? a.max_members : 1, D1 = a.D + 1;
  const size_t PC = (size_t)a.P * a.C, V = a.V, VW = (V + 31) / 32, FR = a.FR, Cv = a.Cv;
  Layout L = {};
  Bump b;
  L.ev = b.take(4 * VW);
  L.cur = b.take(4 * VW);
  L.node_of = b.take(4 * M);
  L.npath = b.take(4 * M * D1);
  if (f.heads) {
    L.hp = b.take(8 * m);
    L.ht = b.take(8 * m);
    L.hq = b.take(4 * m);
    L.hnode = b.take(4 * m);
    L.walk = b.take(4 * m);
    L.hflag = b.take(m);
  }
  if (f.cells) {
    L.hqty = b.take(8 * m * PC);
    L.hcell = b.take(4 * m * PC);
  }
  if (f.tb) L.tbits = b.take(4 * m * VW);
  if (rows) {
    for (int k = 0; k < 8; ++k) L.rows[k] = b.take(8 * M * FR);
  }
  if (f.pool) {
    L.pqty = b.take(8 * V * Cv);
    L.pcells = b.take(4 * V * Cv);
    L.powner = b.take(4 * V);
  }
  L.total = b.off;
  return L;
}

// The segment's rows: staged [M][FR] (kRows) or the device's [N][FR],
// addressed through each local node's tree row.
template <bool kRows>
struct Rows {
  long long *U, *LEAF, *UB, *LB;
  const long long *G, *SUB, *BL, *NOM;
  const int* node_of;
  int FR;
  __device__ __forceinline__ size_t at(int l, int cell) const {
    return kRows ? (size_t)l * FR + cell : (size_t)node_of[l] * FR + cell;
  }
  // a row the walk changes: device rows read from L2, past the L1
  __device__ __forceinline__ long long get(const long long* p, size_t x) const {
    return kRows ? p[x] : __ldcg(p + x);
  }
};

// add delta at column `cell` of local node path[0] and up the path
// (atomically: each level passes on the change of the guaranteed max
// its own add made, from the value the add found)
template <bool kRows>
__device__ __forceinline__ void bubble(const Rows<kRows>& rw, const int* path, int D1, int cell,
                                       long long delta) {
  for (int d = 0; d < D1 && delta != 0; ++d) {
    const int node = path[d];
    if (node < 0) break;
    const size_t x = rw.at(node, cell);
    const long long old =
        (long long)atomicAdd((unsigned long long*)&rw.U[x], (unsigned long long)delta);
    const long long g = rw.G[x];
    delta = max(0LL, old + delta - g) - max(0LL, old - g);
  }
}

// available() at path[0] for one cell: the root-down recurrence of
// resource_node.go:89-104 (quota_path.cuh on local rows)
template <bool kRows>
__device__ __forceinline__ long long avail(const Rows<kRows>& rw, const int* path, int D1,
                                           int cell) {
  int root_pos = -1;
  for (int d = 0; d < D1; ++d) root_pos += path[d] >= 0;
  long long av = 0;
  for (int d = root_pos; d >= 0; --d) {
    const size_t x = rw.at(path[d], cell);
    const long long s = rw.SUB[x], g = rw.G[x], bl = rw.BL[x], u = rw.get(rw.U, x);
    if (d == root_pos) {
      av = s - u;
    } else {
      const long long with_max = (s - g) - max(0LL, u - g) + bl;
      const long long clamped = bl < kNoLimit ? min(with_max, av) : av;
      av = max(0LL, g - u) + clamped;
    }
  }
  return av;
}

// The segment's pool slots: staged (`powner`: the local owner, -1 for a
// pad) or the device's.
struct Pool {
  const int* pcells;      // [V,Cv]
  const long long* pqty;  // [V,Cv]
  const int* powner;      // [V] staged, or null
  const int* sowner;      // [V] the device's
  const int* sowner_local;
  int Cv;
  __device__ __forceinline__ int owner(int v) const {
    return powner ? powner[v] : (sowner[v] >= 0 ? sowner_local[v] : -1);
  }
};

// sign x the usage of the target slots whose bits `cur` holds, at their
// owners' leaf rows and up their paths: a lane a slot, its cells in turn
template <bool kRows>
__device__ __forceinline__ void move_targets(const Rows<kRows>& rw, const Pool& pool,
                                             const unsigned* cur, int V, const int* npath,
                                             int D1, long long sign, int lane) {
  for (int v0 = 0; v0 < V; v0 += 32) {
    const int v = v0 + lane;
    if (v >= V || !((cur[v0 >> 5] >> lane) & 1u)) continue;
    const int ol = pool.owner(v);
    if (ol < 0) continue;
    for (int cv = 0; cv < pool.Cv; ++cv) {
      const int cell = pool.pcells[(size_t)v * pool.Cv + cv];
      if (cell < 0) continue;
      const long long q = sign * pool.pqty[(size_t)v * pool.Cv + cv];
      atomicAdd((unsigned long long*)&rw.LEAF[rw.at(ol, cell)], (unsigned long long)q);
      bubble(rw, npath + (size_t)ol * D1, D1, cell, q);
    }
  }
}

__device__ __forceinline__ bool orders_before(bool bj, long long pj, long long tj, int qj,
                                              bool bi, long long pi, long long ti, int qi) {
  // (borrow asc, priority desc, timestamp asc, queue index asc)
  return (bj < bi) | ((bj == bi) & ((pj > pi) | ((pj == pi) & ((tj < ti) | ((tj == ti) &
                                                                          (qj < qi))))));
}

template <bool kRows>
__global__ void __launch_bounds__(kThreads, 1) phase2(Args a, Flags fl) {
  if (*a.s.done) return;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_valid;
  const int s = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int V = a.V, VW = (V + 31) / 32, FR = a.FR, M = a.M, D1 = a.D + 1, Cv = a.Cv;
  const int PC = a.P * a.C;
  const size_t sv = (size_t)s * V;
  for (int v = tid; v < V; v += kThreads) a.p.ev_by[sv + v] = -1;
  if (s >= a.n_seg) {  // no queue in this segment
    for (int v = tid; v < V; v += kThreads) a.p.ev_now[sv + v] = 0;
    for (int i = tid; i < M * FR; i += kThreads) {
      const int node = a.p.seg_nodes[(size_t)s * M + i / FR];
      if (node < 0) continue;
      const size_t x = (size_t)node * FR + i % FR;
      a.p.leaf[x] = a.s.local[x];
    }
    return;
  }
  const int beg = a.seg_offsets[s], m = a.seg_offsets[s + 1] - beg;
  const int* members = a.seg_members + beg;

  const Layout L = plan(a, kRows, fl);
  unsigned* ev = (unsigned*)(smem + L.ev);
  unsigned* cur_s = (unsigned*)(smem + L.cur);
  int* node_of = (int*)(smem + L.node_of);
  int* npath = (int*)(smem + L.npath);
  long long* hp = (long long*)(smem + L.hp);
  long long* ht = (long long*)(smem + L.ht);
  int* hq = (int*)(smem + L.hq);
  int* hnode = (int*)(smem + L.hnode);
  // rank -> member index: staged, or the segment's rows of the order buffer
  int* walk = fl.heads ? (int*)(smem + L.walk) : a.b.order + beg;
  uint8_t* hflag = smem + L.hflag;
  long long* hqty = (long long*)(smem + L.hqty);
  int* hcell = (int*)(smem + L.hcell);
  unsigned* tbits = (unsigned*)(smem + L.tbits);

  Rows<kRows> rw;
  rw.node_of = node_of;
  rw.FR = FR;
  if (kRows) {
    rw.U = (long long*)(smem + L.rows[0]);
    rw.LEAF = (long long*)(smem + L.rows[1]);
    rw.G = (const long long*)(smem + L.rows[2]);
    rw.SUB = (const long long*)(smem + L.rows[3]);
    rw.BL = (const long long*)(smem + L.rows[4]);
    rw.NOM = (const long long*)(smem + L.rows[5]);
    rw.UB = (long long*)(smem + L.rows[6]);
    rw.LB = (long long*)(smem + L.rows[7]);
  } else {
    rw.U = a.b.usage;
    rw.LEAF = a.p.leaf;
    rw.G = a.t.guaranteed;
    rw.SUB = a.t.subtree;
    rw.BL = a.t.borrowing_limit;
    rw.NOM = a.t.nominal;
    rw.UB = rw.LB = nullptr;
  }
  const size_t svc = sv * Cv;
  Pool pool;
  pool.pcells = fl.pool ? (const int*)(smem + L.pcells) : a.p.pcells + svc;
  pool.pqty = fl.pool ? (const long long*)(smem + L.pqty) : a.p.pqty + svc;
  pool.powner = fl.pool ? (const int*)(smem + L.powner) : nullptr;
  pool.sowner = a.p.sowner + sv;
  pool.sowner_local = a.p.sowner_local + sv;
  pool.Cv = Cv;

  // ---- 1. staging: A, the tables, a warp each ----
  if (warp == 0) {
    const int* lp = a.p.lpaths + (size_t)s * M * D1;
    for (int l = lane; l < M; l += 32) node_of[l] = a.p.seg_nodes[(size_t)s * M + l];
    for (int i = lane; i < M * D1; i += 32) npath[i] = lp[i];
    for (int w = lane; w < VW; w += 32) ev[w] = 0;
  } else if (warp == 1) {
    if (fl.heads) {
      for (int i = lane; i < m; i += 32) {
        const int x = members[i];
        const int c = min(a.s.cursor[x], a.L - 1);
        const bool fit = a.b.is_fit[x], pre = a.b.is_pre[x];
        hq[i] = x;
        hnode[i] = a.p.hlocal[x];
        hp[i] = a.q.priority[(size_t)x * a.L + c];
        ht[i] = a.q.timestamp[(size_t)x * a.L + c];
        hflag[i] = (fit || pre ? kNom : 0) | (fit ? kFitF : 0) | (pre ? kPreF : 0) |
                   (a.p.psuccess[x] ? kPs : 0) | (a.q.no_reclaim[x] ? kNoRe : 0) |
                   (a.b.head_borrow[x] ? kBor : 0);
      }
    }
  } else if (warp == 2) {
    if (fl.cells) {
#pragma unroll 4
      for (int i = lane; i < m * PC; i += 32) {
        const int x = members[i / PC];
        hcell[i] = a.b.cells_eff[(size_t)x * PC + i % PC];
        hqty[i] = a.b.qty_eff[(size_t)x * PC + i % PC];
      }
    }
  } else if (warp == 3) {
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
  if (tid == 0) n_valid = 0;
  __syncthreads();
  // B, the block: the rows (device rows: the leaf rows copied), the
  // preempters' targets as bits (a thread a head's 32 slots, read four
  // at a time where V allows)
  if (kRows) {
    long long* U = rw.U;
    long long* LEAF = rw.LEAF;
    long long* G = (long long*)(smem + L.rows[2]);
    long long* SUB = (long long*)(smem + L.rows[3]);
    long long* BL = (long long*)(smem + L.rows[4]);
    long long* NOM = (long long*)(smem + L.rows[5]);
#pragma unroll 2
    for (int i = tid; i < M * FR; i += kThreads) {
      const int node = node_of[i / FR];
      long long u = 0, lf = 0, g = 0, sub = 0, bl = 0, nom = 0;
      if (node >= 0) {
        const size_t x = (size_t)node * FR + i % FR;
        u = a.b.usage[x];
        lf = a.s.local[x];
        g = a.t.guaranteed[x];
        sub = a.t.subtree[x];
        bl = a.t.borrowing_limit[x];
        nom = a.t.nominal[x];
      }
      U[i] = u;
      LEAF[i] = lf;
      G[i] = g;
      SUB[i] = sub;
      BL[i] = bl;
      NOM[i] = nom;
    }
  } else {
    for (int i = tid; i < M * FR; i += kThreads) {
      const int node = node_of[i / FR];
      if (node < 0) continue;
      const size_t x = (size_t)node * FR + i % FR;
      a.p.leaf[x] = a.s.local[x];
    }
  }
  if (fl.tb) {
    const bool by4 = (V & 3) == 0;
    for (int i = tid; i < m * VW; i += kThreads) {
      const int hi = i / VW, w = i % VW;
      unsigned word = 0;
      if ((hflag[hi] & (kNom | kPs)) == (kNom | kPs)) {
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
      tbits[i] = word;
    }
  }

  // ---- 2. ranking ----
  int n_mine = 0;
  if (fl.heads) {
    for (int i = tid; i < m; i += kThreads) {
      const uint8_t fi = hflag[i];
      if (!(fi & kNom)) continue;
      ++n_mine;
      const bool bi = fi & kBor;
      const long long pi = hp[i], ti = ht[i];
      const int qi = hq[i];
      int rank = 0;
      for (int j = 0; j < m; ++j) {
        const uint8_t fj = hflag[j];
        rank += (fj & kNom) && orders_before(fj & kBor, hp[j], ht[j], hq[j], bi, pi, ti, qi);
      }
      if (rank < a.n_steps) walk[rank] = i;
    }
  } else {  // the keys from device memory
    for (int i = tid; i < m; i += kThreads) {
      const int x = members[i];
      if (!(a.b.is_fit[x] || a.b.is_pre[x])) continue;
      ++n_mine;
      const int cx = min(a.s.cursor[x], a.L - 1);
      const bool bi = a.b.head_borrow[x];
      const long long pi = a.q.priority[(size_t)x * a.L + cx];
      const long long ti = a.q.timestamp[(size_t)x * a.L + cx];
      int rank = 0;
      for (int j = 0; j < m; ++j) {
        const int y = members[j];
        if (!(a.b.is_fit[y] || a.b.is_pre[y])) continue;
        const int cy = min(a.s.cursor[y], a.L - 1);
        rank += orders_before(a.b.head_borrow[y], a.q.priority[(size_t)y * a.L + cy],
                              a.q.timestamp[(size_t)y * a.L + cy], y, bi, pi, ti, x);
      }
      if (rank < a.n_steps) walk[rank] = i;
    }
  }
  if (n_mine) atomicAdd(&n_valid, n_mine);
  __syncthreads();

  // ---- 3. the walk, on warp 0 ----
  if (warp == 0) {
    const int n_walk = min(n_valid, a.n_steps);
    const size_t MF = (size_t)M * FR;
    for (int r = 0; r < n_walk; ++r) {
      const int i = walk[r];
      int x, node;
      uint8_t f;
      if (fl.heads) {
        x = hq[i];
        node = hnode[i];
        f = hflag[i];
      } else {
        x = members[i];
        node = a.p.hlocal[x];
        f = kNom | (a.b.is_fit[x] ? kFitF : 0) | (a.b.is_pre[x] ? kPreF : 0) |
            (a.p.psuccess[x] ? kPs : 0) | (a.q.no_reclaim[x] ? kNoRe : 0) |
            (a.b.head_borrow[x] ? kBor : 0);
      }
      const int* path = npath + (size_t)node * D1;
      int cell = -1;
      long long qv = 0;
      if (lane < PC) {
        if (fl.cells) {
          cell = hcell[(size_t)i * PC + lane];
          qv = hqty[(size_t)i * PC + lane];
        } else {
          cell = a.b.cells_eff[(size_t)x * PC + lane];
          qv = a.b.qty_eff[(size_t)x * PC + lane];
        }
      }
      const bool cell_valid = cell >= 0 && qv > 0;
      // the targets' bits and the overlap guard
      const bool ps = f & kPs;
      const unsigned* cur = fl.tb ? tbits + (size_t)i * VW : cur_s;
      bool ov = false;
      if (ps) {
        if (!fl.tb) {
          for (int w = 0; w < VW; ++w) {
            const int v = 32 * w + lane;
            const unsigned word = __ballot_sync(kFull, v < V && a.p.targets[(size_t)x * V + v]);
            if (lane == 0) cur_s[w] = word;
          }
          __syncwarp();
        }
        for (int w = lane; w < VW; w += 32) ov = ov || (cur[w] & ev[w]) != 0;
      }
      const bool do_pre = ps && !__any_sync(kFull, ov);
      if (do_pre) {
        if (kRows) {
          for (size_t j = lane; j < MF; j += 32) {
            rw.UB[j] = rw.U[j];
            rw.LB[j] = rw.LEAF[j];
          }
          __syncwarp();
        }
        move_targets(rw, pool, cur, V, npath, D1, -1, lane);
        __syncwarp();
      }
      const bool ok = !cell_valid || avail(rw, path, D1, cell) >= qv;
      const bool fits = __all_sync(kFull, ok);
      const bool admit = (f & kFitF) && fits;
      const bool pre_ok = do_pre && fits;
      if (do_pre && !fits) {  // the victims back
        if (kRows) {
          for (size_t j = lane; j < MF; j += 32) {
            rw.U[j] = rw.UB[j];
            rw.LEAF[j] = rw.LB[j];
          }
        } else {
          move_targets(rw, pool, cur, V, npath, D1, 1, lane);
        }
        __syncwarp();
      }
      const bool reserve = (f & kPreF) && !ps && (f & kNoRe);
      const bool charge = cell_valid && (admit || pre_ok || reserve);
      long long delta = qv;
      size_t lx = 0;
      if (charge) {
        lx = rw.at(node, cell);
        if (!(admit || pre_ok)) {
          const long long nom = rw.NOM[lx], bl = rw.BL[lx], leaf = rw.get(rw.LEAF, lx);
          const long long borrow_cap = bl < kNoLimit ? min(qv, nom + bl - leaf) : qv;
          const long long nominal_cap = max(0LL, min(qv, nom - leaf));
          delta = (f & kBor) ? borrow_cap : nominal_cap;
        }
      }
      __syncwarp();  // every lane has read its leaf row before any adds
      if (charge) {
        atomicAdd((unsigned long long*)&rw.LEAF[lx], (unsigned long long)delta);
        bubble(rw, path, D1, cell, delta);
      }
      if (pre_ok) {
        for (int v = lane; v < V; v += 32) {
          if ((cur[v >> 5] >> (v & 31)) & 1u) a.p.ev_by[sv + v] = x;
        }
        for (int w = lane; w < VW; w += 32) ev[w] |= cur[w];
      }
      if (lane == 0) {
        a.b.admitted[x] = admit;
        a.p.preempt_ok[x] = pre_ok;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- 4. write back ----
  for (int v = tid; v < V; v += kThreads) a.p.ev_now[sv + v] = (ev[v >> 5] >> (v & 31)) & 1u;
  if (kRows) {
    for (int i = tid; i < M * FR; i += kThreads) {
      const int node = node_of[i / FR];
      if (node < 0) continue;
      const size_t x = (size_t)node * FR + i % FR;
      a.b.usage[x] = rw.U[i];
      a.p.leaf[x] = rw.LEAF[i];
    }
  }
}

template <bool kRows>
int launch(const Args& a, Flags fl, size_t smem, cudaStream_t stream) {
  if (smem + sizeof(int) > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        phase2<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  phase2<kRows><<<a.n_segments, kThreads, smem, stream>>>(a, fl);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace drain

extern "C" int drain_preempt_phase2(const int* ints, int n_ints, void* const* ptrs,
                                    int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.p.leaf == nullptr || a.n_seg > a.n_segments) {
    return (int)cudaErrorInvalidValue;
  }
  if (a.n_segments == 0) return (int)cudaGetLastError();
  using drain::plan;
  const size_t lim = drain::kSmemLimit;
  drain::Flags fl = {0, 0, 0, 0};
  if (plan(a, false, fl).total > lim) return (int)cudaErrorInvalidValue;
  fl.heads = plan(a, false, {1, 0, 0, 0}).total <= lim;
  const bool rows = plan(a, true, fl).total <= lim;
  drain::Flags t = fl;
  t.pool = 1;
  if (plan(a, rows, t).total <= lim) fl = t;
  if (fl.heads) {
    t = fl;
    t.cells = 1;
    if (plan(a, rows, t).total <= lim) fl = t;
    t = fl;
    t.tb = 1;
    if (plan(a, rows, t).total <= lim) fl = t;
  }
  const size_t smem = plan(a, rows, fl).total;
  const cudaStream_t st = (cudaStream_t)stream;
  return rows ? drain::launch<true>(a, fl, smem, st) : drain::launch<false>(a, fl, smem, st);
}
