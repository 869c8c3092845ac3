// Kernel B10a, drain_preempt_search: the preempt drain's victim search
// of one cycle, for every queue head at once.
//
// Replaces the search half of the cycle of kueue_tpu/ops/drain_kernel.py
// solve_drain_preempt (:1866-1987): candidate eligibility over the
// head's segment pool (preemption.go:480-524), the strategy ladder
// (preemption.go:144-191: no other-CQ candidate -> one attempt;
// borrowWithinCohort -> one attempt under the priority threshold
// min(priority, maxPriorityThreshold + 1); else, under nominal, a
// reclaim-without-borrowing attempt then a same-queue attempt), the
// compaction in the queue's candidate order (`perm`) to search_width
// (_compact_candidates, :1620), both minimalPreemptions attempts
// (_ladder_search_one, :1644) and the trust of a truncated search: an
// attempt that overflowed the window and missed is inconclusive, and
// an attempt-1 one taints the head even when attempt 2 succeeds.
//
// Design: one block of one warp per queue, one lane per merged head
// cell (P*C <= 32). Every read the ladder's steps make is staged in
// shared memory before the first step, each staging pass with its loads
// spread over the lanes so that they are in flight together:
//   - the segment's six [M, P*C] panels at the head's cells (usage, leaf
//     usage, guaranteed, subtree, borrowing limit, nominal), a lane an
//     (node, cell) entry, and the segment's local paths;
//   - which segment nodes borrow in a cell needing preemption (the
//     owner rule of an other-CQ candidate), a lane a node over the
//     staged leaf-usage and nominal panels;
//   - eligibility, a lane four pool slots at a time, every field of the
//     four loaded at once (at Cv = 4 a slot's cells in one 16-byte load
//     and its quantities in two), matched against the head's cells that
//     need preemption (a warp loop over their ballot), and whether its
//     priority is below the borrowWithinCohort threshold; the compaction
//     in candidate order (ballot and popcount keep the order) from those
//     flags and the order's entries, also read four at a time;
//   - each compacted candidate's owner row, priority, same-queue flag,
//     usage at each of the head's cells and its path's first four panel
//     offsets, a lane a candidate, both lists in one pass where a second
//     attempt may run; the two mutable panels are kept as loaded, so a
//     second attempt starts from them without a trip to device memory.
// Each attempt is then the minimalPreemptions ladder (`ladder`, B10a's
// own; B8 keeps preempt_local.cuh's): the first four levels of the
// head's path, their offsets and read-only quota rows (subtree,
// guaranteed, borrowing limit, nominal), sit in registers, deeper
// levels are read from the staged panels and paths, and the next
// candidate's fields are read while a step runs, so a step's chain is
// one read of its owner row and path rows (the owner vote, the bubble's
// old values), the writes, one read of the head's usage rows, and one
// vote for the fit. Where the staged candidates do not fit a block's
// shared memory (search_width 512 at P*C 32), the same ladder reads
// them from the pool in device memory.
// Queues with no search to run write their empty result and leave. One
// warp a block: the blocks are small (a few kB of shared memory at the
// contended drain), so 32 of them an SM fit, and a queue that leaves at
// once frees its slot for the next.
//
// What bounds it: the ladders' serial chains of dependent shared-memory
// steps (up to search_width removals and fill-backs per attempt) and the
// few dependent trips to device memory before them, not bytes: a head's
// inputs are a few kB (chip_smoke.py counts each launch's bytes from its
// data; perf/kernel_ab.py the chain). A set `done` flag makes the launch
// a no-op.

#include "drain_pool.cuh"
#include "quota_path.cuh"

namespace drain {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemMax = 232448;  // a block's opt-in shared memory (no static part)
constexpr int kL = 4;             // path levels the ladder holds in registers
constexpr int kChunk = 4;         // pool slots a lane loads at once (128 a warp)
constexpr int kCvChunk = 4;       // their cells held in registers (Cv <= 4)
using pool::victim_qty;

// The panels of one search, int64[M, stride] at the head's cells: u and
// lf (bubbled usage and leaf usage) are mutated by the search, the
// quota panels read only.
struct Panels {
  long long* u;
  long long* lf;
  const long long* g;    // guaranteed
  const long long* sub;  // subtree quota
  const long long* bl;   // borrowing limit
  const long long* nom;  // nominal
  int stride;            // cells per row (P*C)
};

// Byte offsets of the dynamic shared memory, planned by plan_layout.
struct Layout {
  int u, lf, g, sub, bl, nom;  // int64[M, PC] panels
  int u0, lf0;                 // int64[M, PC] the mutable two as loaded (staged)
  int stq;                     // int64[2W, PC] staged candidates' usage at the head cells
                               // (the first list's, then the second's)
  int sprio;                   // int64[2W]
  int comp1, comp2;            // int32[W]
  int srow;                    // int32[2W]
  int cpx;                     // int32[2W, kL] staged candidates' first kL path offsets
  int spath;                   // int32[M, D+1] the segment's local paths
  int cells;                   // int32[32]
  int flags, same, low;        // uint8[V]
  int removed;                 // uint8[W]
  int ssame;                   // uint8[2W]
  int borrow;                  // uint8[M]
  int npre;                    // uint8[32]
  int total;
};

__host__ __device__ inline int align8(long long b) { return (int)((b + 7) & ~7LL); }

// The layout of a search block; `staged`: room for the staged
// candidates.
inline Layout plan_layout(const Args& a, bool staged) {
  const int PC = a.P * a.C, M = a.M, W = a.search_width, D1 = a.D + 1;
  Layout L;
  int at = 0;
  auto take = [&](int bytes) {
    const int off = at;
    at += align8(bytes);
    return off;
  };
  const int panel = 8 * M * PC;
  L.u = take(panel);
  L.lf = take(panel);
  L.g = take(panel);
  L.sub = take(panel);
  L.bl = take(panel);
  L.nom = take(panel);
  L.u0 = take(staged ? panel : 0);
  L.lf0 = take(staged ? panel : 0);
  L.stq = take(staged ? 16 * W * PC : 0);
  L.sprio = take(staged ? 16 * W : 0);
  L.comp1 = take(4 * W);
  L.comp2 = take(4 * W);
  L.srow = take(staged ? 8 * W : 0);
  L.cpx = take(staged ? 8 * W * kL : 0);
  L.spath = take(4 * M * D1);
  L.cells = take(4 * 32);
  L.flags = take(a.V);
  L.same = take(a.V);
  L.low = take(a.V);
  L.removed = take(W);
  L.ssame = take(staged ? 2 * W : 0);
  L.borrow = take(M);
  L.npre = take(32);
  L.total = at;
  return L;
}

// A pool slot's first kCvChunk cells and quantities (-1 and 0 past Cv
// or where `on` is false): a 16-byte and two 16-byte loads where Cv = 4.
__device__ __forceinline__ void slot_cells(const Args& a, size_t x, bool on, int* vc,
                                           long long* vq) {
  if (on && a.Cv == kCvChunk) {
    const int4 c4 = *reinterpret_cast<const int4*>(a.p.pcells + x * kCvChunk);
    const longlong2 q01 = *reinterpret_cast<const longlong2*>(a.p.pqty + x * kCvChunk);
    const longlong2 q23 = *reinterpret_cast<const longlong2*>(a.p.pqty + x * kCvChunk + 2);
    vc[0] = c4.x; vc[1] = c4.y; vc[2] = c4.z; vc[3] = c4.w;
    vq[0] = q01.x; vq[1] = q01.y; vq[2] = q23.x; vq[3] = q23.y;
    return;
  }
#pragma unroll
  for (int cv = 0; cv < kCvChunk; ++cv) {
    vc[cv] = on && cv < a.Cv ? a.p.pcells[x * a.Cv + cv] : -1;
    vq[cv] = on && cv < a.Cv ? a.p.pqty[x * a.Cv + cv] : 0;
  }
}

// A lane's kChunk pool slots (v = base + 32 k + lane), every field the
// eligibility reads loaded at once, the cells in registers where
// Cv <= kCvChunk.
struct SlotChunk {
  int owner[kChunk], ol[kChunk];
  bool live[kChunk], esame[kChunk];
  long long sp[kChunk];
  int vc[kChunk][kCvChunk];
  long long vq[kChunk][kCvChunk];
  __device__ __forceinline__ void load(const Args& a, int q, int sq, int base, int lane) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int v = base + 32 * k + lane;
      const bool in = v < a.V;
      const size_t x = (size_t)sq * a.V + (in ? v : 0);
      owner[k] = in ? a.p.sowner[x] : -1;
      ol[k] = in ? a.p.sowner_local[x] : -1;
      const uint8_t valid = in ? a.p.pvalid[x] : 0, evicted = in ? a.p.vevicted[x] : 1;
      live[k] = valid && !evicted;
      sp[k] = in ? a.p.sprio[x] : 0;
      esame[k] = in ? a.p.elig_same[(size_t)q * a.V + v] : 0;
      slot_cells(a, x, in && a.Cv <= kCvChunk, vc[k], vq[k]);
    }
  }
  // slot k's usage at one cell (victim_qty's sum; from device memory
  // where Cv > kCvChunk)
  __device__ __forceinline__ long long at(const Args& a, int sq, int v, int k, int cell) const {
    if (a.Cv > kCvChunk) return v < a.V ? victim_qty(a, (size_t)sq * a.V + v, cell) : 0;
    long long sum = 0;
#pragma unroll
    for (int cv = 0; cv < kCvChunk; ++cv) {
      sum += (vc[k][cv] >= 0 && vc[k][cv] == cell) ? vq[k][cv] : 0;
    }
    return sum;
  }
};

// The ladder's candidates, j < n of one compacted list: its owner's
// local row, same-queue flag, priority, usage at the lane's cell and the
// panel offsets (node * PC, -1 past the root) of its path's first kL
// levels (`path`: its owner's row of the local paths), staged in shared
// memory...
struct StagedCand {
  const int* srow;
  const uint8_t* ssame;
  const long long* sprio;
  const long long* stq;  // [n, PC]
  const int* cpx;        // [n, kL]
  int PC;
  __device__ int row(int j) const { return srow[j]; }
  __device__ bool same(int j) const { return ssame[j]; }
  __device__ long long prio(int j) const { return sprio[j]; }
  __device__ long long qty(int j, int c) const { return stq[j * PC + c]; }
  __device__ int x(int j, int d, const int*) const { return cpx[j * kL + d]; }
};

// ... or read from the pool in device memory (past the room)
struct PoolCand {
  const Args* a;
  const int* comp;            // [n] slot ids, compacted
  const uint8_t* same_flags;  // [V] slot is same-CQ (shared)
  int sq, cell;               // segment, the lane's (clamped) head cell
  __device__ size_t slot(int j) const { return (size_t)sq * a->V + comp[j]; }
  __device__ int row(int j) const { return max(a->p.sowner_local[slot(j)], 0); }
  __device__ bool same(int j) const { return same_flags[comp[j]]; }
  __device__ long long prio(int j) const { return a->p.sprio[slot(j)]; }
  __device__ long long qty(int j, int) const { return victim_qty(*a, slot(j), cell); }
  __device__ int x(int, int d, const int* path) const {
    const int node = d <= a->D ? path[d] : -1;
    return node >= 0 ? node * a->P * a->C : -1;
  }
};

// One level of available() (quota_path::avail_along_path), from the
// root down: `up` is the parent's availability.
__device__ __forceinline__ long long avail_level(bool root, long long sub, long long g,
                                                 long long bl, long long u, long long up) {
  if (root) return sub - u;
  const long long with_max = (sub - g) - max(0LL, u - g) + bl;
  const long long clamped = bl < quota_path::kNoLimit ? min(with_max, up) : up;
  return max(0LL, g - u) + clamped;
}

// One minimalPreemptions attempt (preemption.go:275-342,
// kueue_tpu/ops/drain_kernel.py _ladder_search_one) over the n
// candidates of `s`, a lane a head cell (c; `in`: the lane holds one,
// `need`/`qty`: the head's request there, `npre`: it needs preemption).
// The head's path is spath's row hrow; its first kL levels' offsets and
// read-only quota rows sit in registers, deeper levels are read from the
// panels. Each bubble's first kL levels are read before any is written
// (a path's nodes are distinct), and the fit's two votes are one
// (allow_borrow is the warp's). removed[0..n) (shared memory) ends as
// the victim flags; returns whether a fitting set was found (removed is
// meaningful only then). All 32 lanes call it together.
template <class Cand>
__device__ __forceinline__ bool ladder(const Cand& s, int n, bool allow_borrow, bool thr_on,
                                       long long thr, const Panels& p, const int* spath,
                                       int hrow, int D, int c, bool in, bool need,
                                       long long qty, bool npre, uint8_t* removed) {
  const int PC = p.stride, D1 = D + 1;
  const int* hpath = spath + hrow * D1;
  int hn = 0, hx[kL];
  long long hs[kL], hg[kL], hb[kL];
#pragma unroll
  for (int d = 0; d < kL; ++d) {
    const int node = d < D1 ? hpath[d] : -1;
    hn += node >= 0;
    hx[d] = node >= 0 && need ? node * PC + c : -1;
    hs[d] = hx[d] >= 0 ? p.sub[hx[d]] : 0;
    hg[d] = hx[d] >= 0 ? p.g[hx[d]] : 0;
    hb[d] = hx[d] >= 0 ? p.bl[hx[d]] : 0;
  }
  for (int d = kL; d < D1; ++d) hn += hpath[d] >= 0;
  const int root = hn - 1;
  const int hxl = hrow * PC + c;
  const long long hnom = need ? p.nom[hxl] : 0;
  auto fits = [&](bool ab) {
    bool ok = true;
    if (need) {
      long long uu[kL];
#pragma unroll
      for (int d = 0; d < kL; ++d) uu[d] = hx[d] >= 0 ? p.u[hx[d]] : 0;
      const long long lfh = p.lf[hxl];
      long long avail = 0;
      for (int d = D; d >= kL; --d) {  // the levels past the registers'
        const int node = hpath[d];
        if (node < 0) continue;
        const int x = node * PC + c;
        avail = avail_level(d == root, p.sub[x], p.g[x], p.bl[x], p.u[x], avail);
      }
#pragma unroll
      for (int d = kL - 1; d >= 0; --d) {
        if (hx[d] >= 0) avail = avail_level(d == root, hs[d], hg[d], hb[d], uu[d], avail);
      }
      ok = avail >= qty && (ab || lfh + qty <= hnom);
    }
    return __all_sync(kFull, ok);
  };
  // a candidate's fields and its path (the next one's read while a step
  // runs): the first kL levels' panel offsets, node * PC, -1 past the
  // root
  struct Fetched {
    int row;
    bool same;
    long long prio, q;
    const int* path;
    int x[kL];
  };
  auto fetch = [&](int j) {
    Fetched f;
    f.row = s.row(j);
    f.same = s.same(j);
    f.prio = s.prio(j);
    f.q = in ? s.qty(j, c) : 0;
    f.path = spath + f.row * D1;
#pragma unroll
    for (int d = 0; d < kL; ++d) f.x[d] = s.x(j, d, f.path);
    return f;
  };
  // addUsage/removeUsage (resource_node.go:123-144) of delta up the
  // candidate's path for the lane's cell: each node takes the delta, its
  // parent the change of the node's usage above its guaranteed quota;
  // the first kL levels from their values read before (read_path)
  auto bubble = [&](const Fetched& f, const long long* uu, const long long* gg,
                    long long delta) {
#pragma unroll
    for (int d = 0; d < kL; ++d) {
      if (f.x[d] < 0) continue;
      p.u[f.x[d] + c] = uu[d] + delta;
      delta = max(0LL, uu[d] + delta - gg[d]) - max(0LL, uu[d] - gg[d]);
    }
    for (int d = kL; d < D1; ++d) {
      const int node = f.path[d];
      if (node < 0) continue;
      const int x = node * PC + c;
      const long long old = p.u[x], gx = p.g[x];
      p.u[x] = old + delta;
      delta = max(0LL, old + delta - gx) - max(0LL, old - gx);
    }
  };
  auto read_path = [&](const Fetched& f, long long* uu, long long* gg) {
#pragma unroll
    for (int d = 0; d < kL; ++d) {
      const bool on = in && f.x[d] >= 0;
      uu[d] = on ? p.u[f.x[d] + c] : 0;
      gg[d] = on ? p.g[f.x[d] + c] : 0;
    }
  };
  bool done = false, ab = allow_borrow;
  int fit_at = -1, j = 0;
  // remove until the head fits
  Fetched cur;
  if (n > 0) cur = fetch(0);
  for (; j < n && !done; ++j) {
    Fetched nxt;
    if (j + 1 < n) nxt = fetch(j + 1);
    const int x = cur.row * PC + c;
    long long uu[kL], gg[kL];
    read_path(cur, uu, gg);
    const long long lfx = in ? p.lf[x] : 0;
    const bool owner_borrows = __any_sync(kFull, in && npre && lfx > p.nom[x]);
    const bool act = cur.same || owner_borrows;
    if (act) {
      // borrowWithinCohort: a candidate at or above the threshold
      // disables borrowing for every later fit check
      if (!cur.same && thr_on && cur.prio >= thr) ab = false;
      if (in) {
        bubble(cur, uu, gg, -cur.q);
        p.lf[x] = lfx - cur.q;
      }
      __syncwarp();
      if (fits(ab)) {
        fit_at = j;
        done = true;
      }
    }
    if (c == 0) removed[j] = act;
    cur = nxt;
  }
  for (int k = j + c; k < n; k += 32) removed[k] = 0;  // not visited after the fit
  __syncwarp();
  if (!done) return false;
  // fill back in reverse, skipping the removal that produced the fit
  for (int k = fit_at - 1; k >= 0; --k) {
    if (!removed[k]) continue;
    const Fetched f = fetch(k);
    const int x = f.row * PC + c;
    long long uu[kL], gg[kL];
    if (in) {
      read_path(f, uu, gg);
      bubble(f, uu, gg, f.q);
      p.lf[x] += f.q;
    }
    __syncwarp();
    const bool keep = fits(ab);
    if (!keep && in) {
      read_path(f, uu, gg);
      bubble(f, uu, gg, -f.q);
      p.lf[x] -= f.q;
    }
    __syncwarp();
    if (keep && c == 0) removed[k] = 0;
    __syncwarp();
  }
  return true;
}

template <bool kStaged>
__global__ void __launch_bounds__(32) search(Args a, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int q = blockIdx.x;
  const int c = threadIdx.x;
  const int V = a.V, W = a.search_width, M = a.M, FR = a.FR, D = a.D;
  const int PC = a.P * a.C;
  const bool in = c < PC;
  if (*a.s.done) return;
  // every scalar of the head at once: none depends on another
  const int cursor = a.s.cursor[q], qlen = a.q.qlen[q];
  const bool alive = a.s.alive[q], is_pre = a.b.is_pre[q];
  const bool same_on = a.p.same_enabled[q], reclaim_on = a.p.reclaim_enabled[q];
  const bool only_lower = a.p.only_lower[q], bwc = a.p.bwc[q];
  const long long thr1 = a.p.bwc_thr1[q];
  const int seg = a.q.seg_id[q], hlocal = a.p.hlocal[q];
  const int cell = in ? a.b.cells_eff[(size_t)q * PC + c] : -1;
  const long long qty = in ? a.b.qty_eff[(size_t)q * PC + c] : 0;
  const bool npre = in && a.p.need_pre[(size_t)q * PC + c];
  uint8_t* targets = a.p.targets + (size_t)q * V;
  for (int v = c; v < V; v += 32) targets[v] = 0;
  if (c == 0) {
    a.p.psuccess[q] = 0;
    a.p.untrusted[q] = 0;
    a.p.preempt_ok[q] = 0;
  }
  const bool active = cursor < qlen && alive;
  if (!(active && is_pre && (same_on || reclaim_on))) return;

  long long* u = (long long*)(smem + L.u);
  long long* lf = (long long*)(smem + L.lf);
  long long* g = (long long*)(smem + L.g);
  long long* sub = (long long*)(smem + L.sub);
  long long* bl = (long long*)(smem + L.bl);
  long long* nom = (long long*)(smem + L.nom);
  int* comp1 = (int*)(smem + L.comp1);
  int* comp2 = (int*)(smem + L.comp2);
  int* cells_s = (int*)(smem + L.cells);
  uint8_t* flags = smem + L.flags;
  uint8_t* same = smem + L.same;
  uint8_t* low = smem + L.low;
  uint8_t* removed = smem + L.removed;
  uint8_t* borrow_by_local = smem + L.borrow;
  uint8_t* npre_s = smem + L.npre;

  const int sq = max(seg, 0);
  // issued before the panels: the priority, the first 128 slots' fields
  // and the candidate order's first 128 entries
  const long long prio = a.q.priority[(size_t)q * a.L + min(cursor, a.L - 1)];
  const int* perm = a.p.perm + (size_t)q * V;
  SlotChunk ch;
  ch.load(a, q, sq, 0, c);
  int order[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) order[k] = 32 * k + c < V ? perm[32 * k + c] : -1;
  const bool need = cell >= 0 && qty > 0;
  const int cc = max(cell, 0);
  cells_s[c] = cc;
  npre_s[c] = npre;
  __syncwarp();

  // the panels, a lane an (node, cell) entry; the mutable two again for
  // a second attempt
  const int* nodes = a.p.seg_nodes + (size_t)sq * M;
  long long* u0 = (long long*)(smem + L.u0);
  long long* lf0 = (long long*)(smem + L.lf0);
  auto load_mutable = [&]() {
    for (int e = c; e < M * PC; e += 32) {
      if (kStaged) {  // the copies kept in shared memory
        u[e] = u0[e];
        lf[e] = lf0[e];
        continue;
      }
      const int m = e / PC;
      const size_t x = (size_t)max(nodes[m], 0) * FR + cells_s[e - m * PC];
      u[e] = a.b.usage[x];
      lf[e] = a.s.local[x];
    }
  };
  for (int e = c; e < M * PC; e += 32) {
    const int m = e / PC;
    const size_t x = (size_t)max(nodes[m], 0) * FR + cells_s[e - m * PC];
    u[e] = a.b.usage[x];
    lf[e] = a.s.local[x];
    if (kStaged) {
      u0[e] = u[e];
      lf0[e] = lf[e];
    }
    g[e] = a.t.guaranteed[x];
    sub[e] = a.t.subtree[x];
    bl[e] = a.t.borrowing_limit[x];
    nom[e] = a.t.nominal[x];
  }
  const int D1 = D + 1;
  const int* lpaths = a.p.lpaths + (size_t)sq * M * D1;
  int* spath = (int*)(smem + L.spath);
  for (int e = c; e < M * D1; e += 32) spath[e] = lpaths[e];
  __syncwarp();
  // other-CQ candidates: their owner borrows at cycle start in a cell
  // needing preemption, a lane a node over the staged panels
  for (int m = c; m < M; m += 32) {
    bool b = false;
    for (int i = 0; i < PC; ++i) b |= npre_s[i] && lf[m * PC + i] > nom[m * PC + i];
    borrow_by_local[m] = b;
  }
  const int hl = max(hlocal, 0);
  const bool under_nominal =
      __all_sync(kFull, !npre || lf[hl * PC + c] < nom[hl * PC + c]);
  __syncwarp();

  // candidate eligibility, lanes over the pool's slots, a chunk of 128
  // at a time (pool::pool_eligible on the chunk's registers)
  const long long thr = min(prio, thr1);
  bool other = false;
  // the head's cells needing preemption, a bit each (the loop over them
  // is the warp's, so a lane's cell comes by shuffle)
  const unsigned npre_mask = __ballot_sync(kFull, npre);
  for (int base = 0; base < V; base += 32 * kChunk) {
    if (base) ch.load(a, q, sq, base, c);
    bool uses[kChunk] = {};
    for (unsigned m = npre_mask; m; m &= m - 1) {
      const int ci = __shfl_sync(kFull, cc, __ffs(m) - 1);
#pragma unroll
      for (int k = 0; k < kChunk; ++k) uses[k] |= ch.at(a, sq, base + 32 * k + c, k, ci) > 0;
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int v = base + 32 * k + c;
      if (v >= V) continue;
      const bool slot_ok = ch.owner[k] >= 0;
      const bool same_q = slot_ok && ch.ol[k] == hlocal;
      const bool elig_other = ch.live[k] && !same_q && slot_ok && reclaim_on &&
                              (!only_lower || ch.sp[k] < prio) &&
                              borrow_by_local[max(ch.ol[k], 0)];
      const bool elig = uses[k] && (ch.esame[k] || elig_other);
      flags[v] = elig;
      same[v] = same_q;
      low[v] = ch.sp[k] < thr;
      other = other || (elig && !same_q);
    }
  }
  const bool other_exists = __any_sync(kFull, other);
  __syncwarp();

  // the strategy ladder
  const bool case_b = other_exists && bwc;
  const bool case_c = other_exists && !bwc && under_nominal;
  const bool all_elig = !other_exists || case_c;  // cases a and c
  auto cand1 = [&](int v) {
    if (!flags[v]) return false;
    if (case_b) return same[v] || low[v] || under_nominal;
    return all_elig || same[v];
  };
  auto cand2 = [&](int v) { return flags[v] && same[v]; };

  // compaction in candidate order, the order's entries a chunk at a time
  int n1 = 0, n2 = 0;
  const unsigned below = (1u << c) - 1;
  for (int base = 0; base < V; base += 32 * kChunk) {
    if (base) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int j = base + 32 * k + c;
        order[k] = j < V ? perm[j] : -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (base + 32 * k >= V) break;
      const int slot = order[k];
      const bool c1 = slot >= 0 && cand1(slot);
      const bool c2 = slot >= 0 && cand2(slot);
      const unsigned b1 = __ballot_sync(kFull, c1), b2 = __ballot_sync(kFull, c2);
      const int p1 = n1 + __popc(b1 & below), p2 = n2 + __popc(b2 & below);
      if (c1 && p1 < W) comp1[p1] = slot;
      if (c2 && p2 < W) comp2[p2] = slot;
      n1 += __popc(b1);
      n2 += __popc(b2);
    }
  }
  const bool over1 = n1 > W, over2 = n2 > W;
  n1 = min(n1, W);
  n2 = min(n2, W);
  __syncwarp();

  Panels pan{u, lf, g, sub, bl, nom, PC};
  // stage a compacted list's candidates, a lane a candidate
  long long* stq = (long long*)(smem + L.stq);
  long long* sprio_s = (long long*)(smem + L.sprio);
  int* srow = (int*)(smem + L.srow);
  int* cpx = (int*)(smem + L.cpx);
  uint8_t* ssame = smem + L.ssame;
  // both lists at once where the second attempt may run (case c): the
  // second's entries from W on
  auto stage = [&]() {
    const int n_all = n1 + (case_c ? n2 : 0);
    for (int t = c; t < n_all; t += 32) {
      const int slot = t < n1 ? comp1[t] : comp2[t - n1];
      const int j = t < n1 ? t : W + t - n1;
      const size_t x = (size_t)sq * V + slot;
      const int row = max(a.p.sowner_local[x], 0);
      srow[j] = row;
      sprio_s[j] = a.p.sprio[x];
      ssame[j] = same[slot];
      if (a.Cv <= kCvChunk) {
        int vc[kCvChunk];
        long long vq[kCvChunk];
        slot_cells(a, x, true, vc, vq);
        for (int i = 0; i < PC; ++i) {
          long long sum = 0;
#pragma unroll
          for (int cv = 0; cv < kCvChunk; ++cv) {
            sum += (vc[cv] >= 0 && vc[cv] == cells_s[i]) ? vq[cv] : 0;
          }
          stq[j * PC + i] = sum;
        }
      } else {
        for (int i = 0; i < PC; ++i) stq[j * PC + i] = victim_qty(a, x, cells_s[i]);
      }
#pragma unroll
      for (int d = 0; d < kL; ++d) {
        const int node = d < D1 ? spath[row * D1 + d] : -1;
        cpx[j * kL + d] = node >= 0 ? node * PC : -1;
      }
    }
    __syncwarp();
  };
  if (kStaged) stage();
  auto attempt = [&](const int* comp, int n, bool allow_borrow, bool thr_on) {
    if constexpr (kStaged) {
      const int o = comp == comp1 ? 0 : W;  // the list's staged entries
      const StagedCand sc{srow + o, ssame + o, sprio_s + o, stq + (size_t)o * PC,
                          cpx + o * kL, PC};
      return ladder(sc, n, allow_borrow, thr_on, thr, pan, spath, hl, D, c, in, need, qty, npre,
                    removed);
    } else {
      const PoolCand pc{&a, comp, same, sq, cc};
      return ladder(pc, n, allow_borrow, thr_on, thr, pan, spath, hl, D, c, in, need, qty, npre,
                    removed);
    }
  };
  // attempt 1, then (case c, attempt 1 missed) the same-queue attempt on
  // fresh panels: one call site of the ladder
  bool found1 = false, found2 = false;
  const int* comp = comp1;
  int n = n1;
  for (int att = 0; att < 2; ++att) {
    if (att == 1) {
      if (found1 || !case_c) break;
      load_mutable();
      __syncwarp();
      comp = comp2;
      n = n2;
    }
    const bool found = attempt(comp, n, att == 1 || !case_c, att == 0 && case_b);
    (att == 0 ? found1 : found2) = found;
  }
  __syncwarp();
  if (found1 || found2) {
    for (int j = c; j < n; j += 32) {
      if (removed[j]) targets[comp[j]] = 1;
    }
  }
  const bool untrusted = (over1 && !found1) || (!found1 && case_c && over2 && !found2);
  if (c == 0) {
    a.p.untrusted[q] = untrusted;
    a.p.psuccess[q] = !untrusted && (found1 || found2);
    if (untrusted) *a.p.ovf = 1;
  }
}

template <bool kStaged>
int launch(const Args& a, const Layout& L, cudaStream_t stream) {
  if (L.total > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        search<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.Q > 0) search<kStaged><<<a.Q, 32, L.total, stream>>>(a, L);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace drain

extern "C" int drain_preempt_search(const int* ints, int n_ints, void* const* ptrs,
                                    int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.P * a.C > 32 || a.p.targets == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const drain::Layout staged = drain::plan_layout(a, true);
  if (staged.total <= drain::kSmemMax) {
    return drain::launch<true>(a, staged, st);
  }
  const drain::Layout pool = drain::plan_layout(a, false);
  if (pool.total > drain::kSmemMax) return (int)cudaErrorInvalidValue;
  return drain::launch<false>(a, pool, st);
}
