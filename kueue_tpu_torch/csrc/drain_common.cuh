// Shared argument layout of the drain kernels (drain_nominate.cu,
// drain_phase2.cu, drain_queue_motion.cu).
//
// Each C entry point takes the same two arrays, built once per drain
// by kueue_tpu_torch/ops/drain_kernel.py (DrainContext.kernel_args):
//   ints: Q L P K C G N FR D n_segments n_steps n_seg max_cycles
//   ptrs: 17 DrainQueues fields, 7 tree tensors, 10 DrainState
//         fields, 12 CycleBuffers fields, seg_offsets, seg_members
// in the order of the structs below, and returns cudaGetLastError()
// (cudaErrorInvalidValue when the array lengths do not match).
// Booleans are torch.bool tensors: one byte, 0 or 1.

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
  int* cycle;        // [1]
  int* done;         // [1]
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
  Queues q;
  Tree t;
  State s;
  Buffers b;
  const int* seg_offsets;  // [n_seg+1]
  const int* seg_members;
};

constexpr int kNumInts = 13;
constexpr int kNumPtrs = 17 + 7 + 10 + 12 + 2;

// Fills `a` from the two arrays; false when their lengths do not match.
inline bool unpack(const int* ints, int n_ints, void* const* p, int n_ptrs, Args* a) {
  if (n_ints != kNumInts || n_ptrs != kNumPtrs) return false;
  a->Q = ints[0]; a->L = ints[1]; a->P = ints[2]; a->K = ints[3]; a->C = ints[4];
  a->G = ints[5]; a->N = ints[6]; a->FR = ints[7]; a->D = ints[8];
  a->n_segments = ints[9]; a->n_steps = ints[10]; a->n_seg = ints[11];
  a->max_cycles = ints[12];
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
  return true;
}

}  // namespace drain
