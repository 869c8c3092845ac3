// Shared argument layout of the drain kernels (drain_nominate.cu,
// drain_phase2.cu, drain_queue_motion.cu, megaloop_boundary.cu,
// drain_fair_phase2.cu, drain_preempt_search.cu,
// drain_preempt_phase2.cu, drain_preempt_motion.cu,
// drain_fair_preempt_search.cu, drain_fair_preempt_phase2.cu,
// drain_tas_place.cu, drain_tas_phase2.cu).
//
// Each C entry point takes the same two arrays, built once per drain
// by kueue_tpu_torch/ops/drain_kernel.py (DrainContext.kernel_args):
//   ints: Q L P K C G N FR D n_segments n_steps n_seg max_cycles
//         chunk_cycles max_rounds n_res prio_tie V Cv M search_width
//         Cu strategy1 has_second Lf Rt Dt ND max_members
//   ptrs: 17 DrainQueues fields, 7 tree tensors, 12 DrainState
//         fields, 12 CycleBuffers fields, seg_offsets, seg_members,
//         8 megaloop round-log fields, 6 fair-drain fields, 33
//         preempt-drain fields, 8 fair-preempt-drain fields, 22
//         TAS-drain fields, the fair-preempt drain's fit scratch
// in the order of the structs below, and returns cudaGetLastError()
// (cudaErrorInvalidValue when the array lengths do not match).
// max_rounds is 0 outside the megaloop, whose round-log pointers are
// then NULL; the fair pointers are NULL outside the fair drain, the
// preempt pointers (and V Cv M search_width) outside the preempt
// drains, the fair-preempt pointers (and Cu strategy1 has_second)
// outside the fair-preempt drain, the TAS pointers (and Lf Rt Dt ND)
// outside the TAS drain. Booleans are torch.bool tensors: one byte, 0 or 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace drain {

constexpr long long kNoLimit = 1LL << 60;
constexpr int kMaxK = 16;
constexpr int kMaxC = 8;
constexpr int kMaxG = 8;
constexpr int kMaxP = 4;
constexpr int kMaxPC = kMaxP * kMaxC;  // merged cells: one warp lane each
constexpr int kMaxR = 16;  // resources of the fair drain's DRS
constexpr int kMaxTasND = 2048;   // TAS drain: domains a level
constexpr int kMaxTasDepth = 16;  // TAS drain: levels of the merged forest
constexpr int kMaxTasR = 16;      // TAS drain: topology resources

struct Queues {
  const int* cq_rows;
  const int* seg_id;
  const int* qlen;
  const int* cells;          // [Q,L,P,K,C]
  const long long* qty;      // [Q,L,P,K,C]
  const uint8_t* valid;      // [Q,L,P,K]
  const int* gidx;           // [Q,L,P,K,G]
  const uint8_t* glast;      // [Q,L,P,K,G]
  const int8_t* cgrp;        // [Q,L,P,K,C]
  const int* n_podsets;      // [Q,L]
  const uint8_t* ffb;
  const uint8_t* ffp;
  const int* retry_cap;
  const long long* priority;   // [Q,L]
  const long long* timestamp;  // [Q,L]
  const uint8_t* no_reclaim;
  const long long* score;    // [Q,L,P,K] or null (= zeros)
};

struct Tree {
  const int* parent;                // [N]
  const long long* nominal;         // [N,FR]
  const long long* borrowing_limit;
  const long long* subtree;
  const long long* guaranteed;
  const long long* potential;
  const int* paths;                 // [N,D+1]
};

struct State {
  long long* local;  // [N,FR]
  int* cursor;       // [Q]
  int* g_start;      // [Q,P,G]
  int* retries;      // [Q]
  uint8_t* stuck;    // [Q]
  int* no_prog;      // [1]
  int* adm_k;        // [Q,L,P]
  int* adm_cycle;    // [Q,L]
  int* cycle;        // [1] (megaloop: cycles within the round)
  int* done;         // [1]
  uint8_t* alive;    // [Q] queues still in the drain
  int* cap;          // [Q] retry budget in force
};

struct Rounds {          // the megaloop's round log
  const int* cap_suffix; // [Q,L]
  int* adm_round;        // [Q,L]
  int* round_idx;        // [1]
  int* total;            // [1] cycles over all rounds
  int* r_cursor;         // [R,Q]
  uint8_t* r_stuck;      // [R,Q]
  int* r_cycles;         // [R]
  long long* r_usage;    // [R,N,FR]
};

struct Fair {                 // the fair drain's inputs and scratch
  const int* depth_of;        // [N]
  const long long* weight;    // [N]
  const long long* lendable;  // [N,n_res]
  const int* res_of_fr;       // [FR]
  long long* chain;           // [Q,D+1] scratch
  uint8_t* flags;             // [Q] scratch
};

struct Preempt {                 // the preempt drain (n_segments pools)
  // SegVictims
  const long long* sprio;        // [S,V]
  const long long* sts;          // [S,V]
  const int* sowner;             // [S,V] owner tree row (-1 pad)
  const int* sowner_local;       // [S,V]
  const int* seg_nodes;          // [S,M]
  const int* lpaths;             // [S,M,D+1]
  const int* hlocal;             // [Q]
  const int* perm;               // [Q,V]
  const int* entry_slot;         // [Q,L]
  const uint8_t* same_enabled;   // [Q]
  const uint8_t* same_prio_ok;
  const uint8_t* reclaim_enabled;
  const uint8_t* only_lower;
  const uint8_t* bwc;
  const long long* bwc_thr1;     // [Q]
  // PreemptState
  int* status;                   // [Q,L]
  int* pcells;                   // [S,V,Cv]
  long long* pqty;               // [S,V,Cv]
  uint8_t* pvalid;               // [S,V]
  uint8_t* vevicted;             // [S,V]
  int* evict_cycle;              // [S,V]
  int* evict_by;                 // [S,V]
  uint8_t* ovf;                  // [1]
  // PreemptBuffers
  uint8_t* need_pre;             // [Q,P*C]
  uint8_t* elig_same;            // [Q,V]
  uint8_t* veto;                 // [Q,FR]
  uint8_t* targets;              // [Q,V]
  uint8_t* psuccess;             // [Q]
  uint8_t* untrusted;            // [Q]
  uint8_t* preempt_ok;           // [Q]
  long long* leaf;               // [N,FR]
  uint8_t* ev_now;               // [S,V]
  int* ev_by;                    // [S,V]
};

struct FairPreempt {             // the fair-preempt drain's panels
  const int* seg_cells;          // [S,Cu] global cell ids (-1 pads)
  const int* parent_local;       // [S,M]
  const int* depth_local;        // [S,M]
  const uint8_t* is_cq_local;    // [S,M]
  const uint8_t* node_valid;     // [S,M]
  const long long* weight_local; // [S,M]
  const int* res_of_cell;        // [S,Cu]
  long long* pq_cu;              // [S,V,Cu] state: pool usage at panel cells
};

struct Tas {                     // the TAS drain (merged domain forest)
  const long long* topo_free;    // [Lf,Rt]
  const int* seg_ids;            // [Dt,Lf] leaf -> domain at each level
  const int* n_domains;          // [Dt]
  const uint8_t* t_is;           // [Q]
  const long long* t_req;        // [Q,L,Rt] per-pod requests (pods 1)
  const int* t_count;            // [Q,L]
  const int* t_level;            // [Q,L]
  const int* t_mode;             // [Q,L] 0 Required 1 Preferred 2 Unconstrained
  const int* t_top;              // [Q]
  const int* t_flavor;           // [Q]
  const int* leaf_flavor;        // [Lf]
  const int* parent_map;         // [Dt,ND]
  const uint8_t* t_bad;          // [Q,L]
  long long* tas_u;              // [Lf,Rt] state: live TAS leaf usage
  int* adm_step;                 // [Q,L] state
  uint8_t* tas_nom_ok;           // [Q] buffers
  long long* taken0;             // [Q,Lf] buffers
  // the leaves grouped by domain (ops/drain_kernel.tas_leaf_groups): one
  // leaf order in which every level's domains are runs, each domain's
  // run, and each level's domains grouped by their parent
  const int* leaf_order;         // [Lf]
  const int* dom_beg;            // [Dt,ND] first position of the run
  const int* dom_end;            // [Dt,ND] one past its last
  const int* child_off;          // [Dt,ND+1] children of parent p at level d:
  const int* child_list;         // [Dt,ND]   child_list[d][child_off[d][p] ..)
};

struct Buffers {
  long long* usage;   // [N,FR]
  long long* avail;   // [N,FR]
  uint8_t* is_fit;    // [Q]
  uint8_t* is_pre;
  uint8_t* pend;
  uint8_t* head_borrow;
  int* rep_k;         // [Q,P]
  int* walk_next;     // [Q,P,G]
  int* cells_eff;     // [Q,P*C]
  long long* qty_eff; // [Q,P*C]
  uint8_t* admitted;  // [Q]
  int* order;         // [Q]
};

struct Args {
  int Q, L, P, K, C, G, N, FR, D;
  int n_segments, n_steps, n_seg, max_cycles;
  int chunk_cycles, max_rounds, n_res, prio_tie;
  int V, Cv, M, search_width;
  int Cu, strategy1, has_second;
  int Lf, Rt, Dt, ND;
  int max_members;  // queues of the largest segment
  Queues q;
  Tree t;
  State s;
  Buffers b;
  const int* seg_offsets;  // [n_seg+1]
  const int* seg_members;
  Rounds r;
  Fair f;
  Preempt p;
  FairPreempt fp;
  Tas tas;
  long long* fit_usage;    // [N,FR] the fair-preempt phase 2's fit tree
                           // when its rows stay in device memory
};

constexpr int kNumInts = 29;
constexpr int kNumPtrs = 17 + 7 + 12 + 12 + 2 + 8 + 6 + 33 + 8 + 22 + 1;

// Fills `a` from the two arrays; false when their lengths do not match.
inline bool unpack(const int* ints, int n_ints, void* const* p, int n_ptrs, Args* a) {
  if (n_ints != kNumInts || n_ptrs != kNumPtrs) return false;
  a->Q = ints[0]; a->L = ints[1]; a->P = ints[2]; a->K = ints[3]; a->C = ints[4];
  a->G = ints[5]; a->N = ints[6]; a->FR = ints[7]; a->D = ints[8];
  a->n_segments = ints[9]; a->n_steps = ints[10]; a->n_seg = ints[11];
  a->max_cycles = ints[12];
  a->chunk_cycles = ints[13]; a->max_rounds = ints[14];
  a->n_res = ints[15]; a->prio_tie = ints[16];
  a->V = ints[17]; a->Cv = ints[18]; a->M = ints[19]; a->search_width = ints[20];
  a->Cu = ints[21]; a->strategy1 = ints[22]; a->has_second = ints[23];
  a->Lf = ints[24]; a->Rt = ints[25]; a->Dt = ints[26]; a->ND = ints[27];
  a->max_members = ints[28];
  int i = 0;
  a->q.cq_rows = (const int*)p[i++];
  a->q.seg_id = (const int*)p[i++];
  a->q.qlen = (const int*)p[i++];
  a->q.cells = (const int*)p[i++];
  a->q.qty = (const long long*)p[i++];
  a->q.valid = (const uint8_t*)p[i++];
  a->q.gidx = (const int*)p[i++];
  a->q.glast = (const uint8_t*)p[i++];
  a->q.cgrp = (const int8_t*)p[i++];
  a->q.n_podsets = (const int*)p[i++];
  a->q.ffb = (const uint8_t*)p[i++];
  a->q.ffp = (const uint8_t*)p[i++];
  a->q.retry_cap = (const int*)p[i++];
  a->q.priority = (const long long*)p[i++];
  a->q.timestamp = (const long long*)p[i++];
  a->q.no_reclaim = (const uint8_t*)p[i++];
  a->q.score = (const long long*)p[i++];
  a->t.parent = (const int*)p[i++];
  a->t.nominal = (const long long*)p[i++];
  a->t.borrowing_limit = (const long long*)p[i++];
  a->t.subtree = (const long long*)p[i++];
  a->t.guaranteed = (const long long*)p[i++];
  a->t.potential = (const long long*)p[i++];
  a->t.paths = (const int*)p[i++];
  a->s.local = (long long*)p[i++];
  a->s.cursor = (int*)p[i++];
  a->s.g_start = (int*)p[i++];
  a->s.retries = (int*)p[i++];
  a->s.stuck = (uint8_t*)p[i++];
  a->s.no_prog = (int*)p[i++];
  a->s.adm_k = (int*)p[i++];
  a->s.adm_cycle = (int*)p[i++];
  a->s.cycle = (int*)p[i++];
  a->s.done = (int*)p[i++];
  a->s.alive = (uint8_t*)p[i++];
  a->s.cap = (int*)p[i++];
  a->b.usage = (long long*)p[i++];
  a->b.avail = (long long*)p[i++];
  a->b.is_fit = (uint8_t*)p[i++];
  a->b.is_pre = (uint8_t*)p[i++];
  a->b.pend = (uint8_t*)p[i++];
  a->b.head_borrow = (uint8_t*)p[i++];
  a->b.rep_k = (int*)p[i++];
  a->b.walk_next = (int*)p[i++];
  a->b.cells_eff = (int*)p[i++];
  a->b.qty_eff = (long long*)p[i++];
  a->b.admitted = (uint8_t*)p[i++];
  a->b.order = (int*)p[i++];
  a->seg_offsets = (const int*)p[i++];
  a->seg_members = (const int*)p[i++];
  a->r.cap_suffix = (const int*)p[i++];
  a->r.adm_round = (int*)p[i++];
  a->r.round_idx = (int*)p[i++];
  a->r.total = (int*)p[i++];
  a->r.r_cursor = (int*)p[i++];
  a->r.r_stuck = (uint8_t*)p[i++];
  a->r.r_cycles = (int*)p[i++];
  a->r.r_usage = (long long*)p[i++];
  a->f.depth_of = (const int*)p[i++];
  a->f.weight = (const long long*)p[i++];
  a->f.lendable = (const long long*)p[i++];
  a->f.res_of_fr = (const int*)p[i++];
  a->f.chain = (long long*)p[i++];
  a->f.flags = (uint8_t*)p[i++];
  a->p.sprio = (const long long*)p[i++];
  a->p.sts = (const long long*)p[i++];
  a->p.sowner = (const int*)p[i++];
  a->p.sowner_local = (const int*)p[i++];
  a->p.seg_nodes = (const int*)p[i++];
  a->p.lpaths = (const int*)p[i++];
  a->p.hlocal = (const int*)p[i++];
  a->p.perm = (const int*)p[i++];
  a->p.entry_slot = (const int*)p[i++];
  a->p.same_enabled = (const uint8_t*)p[i++];
  a->p.same_prio_ok = (const uint8_t*)p[i++];
  a->p.reclaim_enabled = (const uint8_t*)p[i++];
  a->p.only_lower = (const uint8_t*)p[i++];
  a->p.bwc = (const uint8_t*)p[i++];
  a->p.bwc_thr1 = (const long long*)p[i++];
  a->p.status = (int*)p[i++];
  a->p.pcells = (int*)p[i++];
  a->p.pqty = (long long*)p[i++];
  a->p.pvalid = (uint8_t*)p[i++];
  a->p.vevicted = (uint8_t*)p[i++];
  a->p.evict_cycle = (int*)p[i++];
  a->p.evict_by = (int*)p[i++];
  a->p.ovf = (uint8_t*)p[i++];
  a->p.need_pre = (uint8_t*)p[i++];
  a->p.elig_same = (uint8_t*)p[i++];
  a->p.veto = (uint8_t*)p[i++];
  a->p.targets = (uint8_t*)p[i++];
  a->p.psuccess = (uint8_t*)p[i++];
  a->p.untrusted = (uint8_t*)p[i++];
  a->p.preempt_ok = (uint8_t*)p[i++];
  a->p.leaf = (long long*)p[i++];
  a->p.ev_now = (uint8_t*)p[i++];
  a->p.ev_by = (int*)p[i++];
  a->fp.seg_cells = (const int*)p[i++];
  a->fp.parent_local = (const int*)p[i++];
  a->fp.depth_local = (const int*)p[i++];
  a->fp.is_cq_local = (const uint8_t*)p[i++];
  a->fp.node_valid = (const uint8_t*)p[i++];
  a->fp.weight_local = (const long long*)p[i++];
  a->fp.res_of_cell = (const int*)p[i++];
  a->fp.pq_cu = (long long*)p[i++];
  a->tas.topo_free = (const long long*)p[i++];
  a->tas.seg_ids = (const int*)p[i++];
  a->tas.n_domains = (const int*)p[i++];
  a->tas.t_is = (const uint8_t*)p[i++];
  a->tas.t_req = (const long long*)p[i++];
  a->tas.t_count = (const int*)p[i++];
  a->tas.t_level = (const int*)p[i++];
  a->tas.t_mode = (const int*)p[i++];
  a->tas.t_top = (const int*)p[i++];
  a->tas.t_flavor = (const int*)p[i++];
  a->tas.leaf_flavor = (const int*)p[i++];
  a->tas.parent_map = (const int*)p[i++];
  a->tas.t_bad = (const uint8_t*)p[i++];
  a->tas.tas_u = (long long*)p[i++];
  a->tas.adm_step = (int*)p[i++];
  a->tas.tas_nom_ok = (uint8_t*)p[i++];
  a->tas.taken0 = (long long*)p[i++];
  a->tas.leaf_order = (const int*)p[i++];
  a->tas.dom_beg = (const int*)p[i++];
  a->tas.dom_end = (const int*)p[i++];
  a->tas.child_off = (const int*)p[i++];
  a->tas.child_list = (const int*)p[i++];
  a->fit_usage = (long long*)p[i++];
  return true;
}

}  // namespace drain
