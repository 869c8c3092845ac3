// Kernel 2, drain_nominate: one drain cycle's nomination of every
// queue head.
//
// Replaces kueue_tpu/ops/drain_kernel.py _nominate_multi (:230) with
// its cell_masks (ops/assign_kernel.py:144) and _group_walk (:140).
// For each queue's head entry, podsets are walked in order: podset p
// classifies every (candidate, cell) against the cycle-start
// availability with quantities inflated by the cells chosen by
// podsets < p, then runs each resource group's flavor walk (stop rule
// by flavorFungibility, best-mode fallback, masked score argmax with
// ties to the earliest flavor, sentinels inf = 2^30 and neg = -2^62 as
// the JAX code types them), and the resume cursor per group. With
// P > 1 duplicate cells of the representative choices are merged onto
// their first occurrence.
//
// What bounds it: at the headline shape (Q=1000 heads, K=8, C=3, G=2,
// P=1) it must move about 1.2 MB at the first cycle (the live heads'
// entries, per-head state and the distinct quota cells they gather, as
// chip_smoke.py counts it), ~0.36 us at 3.35 TB/s. It is bound by
// launch latency and by the serial per-head walk. Design: one thread per
// queue head; the per-candidate masks are bit sets over the cells
// (C <= 8) in registers, the group walk is a few K x G loops, so no
// shared memory and no synchronisation. Uncoalesced gathers are
// acceptable at this size. It also clears the cycle's `admitted`
// flags for drain_phase2. A set `done` flag makes the launch a no-op.
// A queue the megaloop retired (`alive` 0) nominates nothing.

#include "drain_common.cuh"

namespace drain {
namespace {

constexpr int kInf = 1 << 30;
constexpr long long kNeg = -(1LL << 62);

__global__ void nominate(Args a) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (*a.s.done || q >= a.Q) return;
  const int P = a.P, K = a.K, C = a.C, G = a.G, FR = a.FR, PC = a.P * a.C;
  a.b.admitted[q] = 0;
  const bool active = a.s.cursor[q] < a.q.qlen[q] && a.s.alive[q];
  if (!active) {
    a.b.is_fit[q] = 0;
    a.b.is_pre[q] = 0;
    a.b.pend[q] = 0;
    a.b.head_borrow[q] = 0;
    for (int p = 0; p < P; ++p) {
      a.b.rep_k[q * P + p] = -1;
      for (int g = 0; g < G; ++g) a.b.walk_next[(q * P + p) * G + g] = 0;
    }
    for (int i = 0; i < PC; ++i) {
      a.b.cells_eff[q * PC + i] = -1;
      a.b.qty_eff[q * PC + i] = 0;
    }
    return;
  }
  const int cur = min(a.s.cursor[q], a.L - 1);
  const int cq = max(a.q.cq_rows[q], 0);
  const bool has_cohort = a.t.parent[cq] >= 0;
  const int npod = a.q.n_podsets[q * a.L + cur];
  const bool ffb = a.q.ffb[q], ffp = a.q.ffp[q];

  // assignment_usage of earlier podsets as (cell, qty) pairs
  int acc_cell[kMaxPC];
  long long acc_qty[kMaxPC];
  int nacc = 0;
  int mcells[kMaxPC];
  long long mqty[kMaxPC];

  bool processed = true, head_borrow = false, pending = false;
  int head_mode = 3;

  for (int p = 0; p < P; ++p) {
    const bool real = p < npod;
    const size_t e = ((size_t)q * a.L + cur) * P + p;  // entry podset
    const int* cells_p = a.q.cells + e * K * C;
    const long long* qty_p = a.q.qty + e * K * C;
    const int8_t* cg_p = a.q.cgrp + e * K * C;
    const int* gid_p = a.q.gidx + e * K * G;
    const uint8_t* gl_p = a.q.glast + e * K * G;
    const uint8_t* valid_p = a.q.valid + e * K;
    const long long* sc_p = a.q.score ? a.q.score + e * K : nullptr;
    const int* gs = a.s.g_start + ((size_t)q * P + p) * G;

    // per-cell masks (bit c of each word), and the walk's valid set
    uint32_t fitm[kMaxK], potm[kMaxK], recm[kMaxK], borm[kMaxK];
    bool vk[kMaxK];
    for (int k = 0; k < K; ++k) {
      uint32_t fm = 0, pm = 0, rm = 0, bm = 0;
      for (int c = 0; c < C; ++c) {
        const int cell = cells_p[k * C + c];
        const long long qv = qty_p[k * C + c];
        long long infl = qv;
        if (p > 0 && cell >= 0 && qv > 0) {
          for (int j = 0; j < nacc; ++j)
            if (acc_cell[j] == cell) infl += acc_qty[j];
        }
        const uint32_t bit = 1u << c;
        if (!(cell >= 0 && infl > 0)) {  // pad / zero cells are permissive
          fm |= bit; pm |= bit; rm |= bit;
          continue;
        }
        const size_t x = (size_t)cq * FR + cell;
        const long long nom = a.t.nominal[x], loc = a.s.local[x];
        if (a.b.avail[x] >= infl) fm |= bit;
        if (infl <= a.t.potential[x] && infl <= nom) pm |= bit;
        if (loc + infl <= nom) rm |= bit;
        if (loc + infl > a.t.subtree[x] && has_cohort) bm |= bit;
      }
      fitm[k] = fm; potm[k] = pm; recm[k] = rm; borm[k] = bm;
      bool km = true;
      for (int g = 0; g < G; ++g) km = km && gid_p[k * G + g] >= gs[g];
      vk[k] = valid_p[k] && real && km;
    }

    // per-group walks
    int choice[kMaxG], nstart[kMaxG];
    int walk_mode = 3;
    bool pend_p = false;
    for (int g = 0; g < G; ++g) {
      int gm[kMaxK];
      bool stop[kMaxK];
      long long stop_best = kNeg;
      int best_mode = -1;
      for (int k = 0; k < K; ++k) {
        int mode = 3;
        bool gb = false;
        for (int c = 0; c < C; ++c) {
          if (cg_p[k * C + c] != g) continue;
          const uint32_t bit = 1u << c;
          const int cm = (fitm[k] & bit) ? 3
                         : ((potm[k] & bit) && (recm[k] & bit)) ? 2
                         : (potm[k] & bit) ? 1 : 0;
          mode = min(mode, cm);
          gb = gb || (borm[k] & bit);
        }
        const bool borrow_ok = !gb || ffb;
        gm[k] = mode;
        stop[k] = vk[k] && ((mode == 3 && borrow_ok) ||
                            ((mode == 1 || mode == 2) && ffp && borrow_ok));
        const long long sc = sc_p ? sc_p[k] : 0;
        if (stop[k]) stop_best = max(stop_best, sc);
        if (vk[k]) best_mode = max(best_mode, mode);
      }
      int stop_idx = kInf;
      long long bm_best = kNeg;
      for (int k = 0; k < K; ++k) {
        const long long sc = sc_p ? sc_p[k] : 0;
        if (stop[k] && sc == stop_best) stop_idx = min(stop_idx, gid_p[k * G + g]);
        if (vk[k] && gm[k] == best_mode) bm_best = max(bm_best, sc);
      }
      int best_idx = kInf;
      for (int k = 0; k < K; ++k) {
        const long long sc = sc_p ? sc_p[k] : 0;
        if (vk[k] && gm[k] == best_mode && sc == bm_best)
          best_idx = min(best_idx, gid_p[k * G + g]);
      }
      const bool stopped = stop_idx < kInf;
      const int ch = stopped ? stop_idx : best_idx;
      int ch_mode = -1;
      bool is_last = false;
      for (int k = 0; k < K; ++k) {
        if (vk[k] && gid_p[k * G + g] == ch) {
          ch_mode = max(ch_mode, gm[k]);
          is_last = is_last || gl_p[k * G + g];
        }
      }
      const bool have = ch < kInf && ch_mode >= 1;
      walk_mode = min(walk_mode, have ? ch_mode : 0);
      const int tried = (stopped && !is_last) ? ch : -1;
      pend_p = pend_p || tried >= 0;
      nstart[g] = tried + 1;
      choice[g] = ch;
    }
    int k_rep = -1;
    for (int k = 0; k < K && k_rep < 0; ++k) {
      if (!vk[k]) continue;
      bool all = true;
      for (int g = 0; g < G; ++g) all = all && gid_p[k * G + g] == choice[g];
      if (all) k_rep = k;
    }
    const int chosen = (walk_mode == 3 && k_rep >= 0) ? k_rep : -1;
    const int pre = ((walk_mode == 1 || walk_mode == 2) && k_rep >= 0) ? k_rep : -1;

    // the podset's representative choice
    const bool live = real && processed;
    const int mode_p = live ? (chosen >= 0 ? 3 : (pre >= 0 ? 1 : 0)) : 3;
    const int rep = chosen >= 0 ? chosen : pre;
    const bool use = live && rep >= 0;
    const int rs = max(rep, 0);
    bool borrow_rep = false;
    for (int c = 0; c < C; ++c) {
      const int cr = cells_p[rs * C + c];
      const int cell = (use && cr >= 0) ? cr : -1;
      const long long qv = cell >= 0 ? qty_p[rs * C + c] : 0;
      mcells[p * C + c] = cell;
      mqty[p * C + c] = qv;
      if (p < P - 1 && cell >= 0) {
        acc_cell[nacc] = cell;
        acc_qty[nacc] = qv;
        ++nacc;
      }
      if ((borm[rs] & (1u << c)) && cell >= 0) borrow_rep = true;
    }
    head_borrow = head_borrow || (borrow_rep && use);
    pending = pending || (pend_p && live);
    head_mode = min(head_mode, mode_p);
    processed = processed && mode_p >= 1;
    a.b.rep_k[q * P + p] = use ? rep : -1;
    for (int g = 0; g < G; ++g) a.b.walk_next[(q * P + p) * G + g] = live ? nstart[g] : 0;
  }

  // merge duplicate cells onto their first occurrence (P > 1 only: a
  // single candidate's cells are distinct by construction)
  for (int i = 0; i < PC; ++i) {
    int cell = mcells[i];
    long long qv = mqty[i];
    if (P > 1 && cell >= 0) {
      bool first = true;
      long long sum = 0;
      for (int j = 0; j < PC; ++j) {
        if (mcells[j] != cell) continue;
        sum += mqty[j];
        if (j < i) first = false;
      }
      cell = first ? cell : -1;
      qv = first ? sum : 0;
    }
    a.b.cells_eff[q * PC + i] = cell;
    a.b.qty_eff[q * PC + i] = qv;
  }
  const bool is_pre = head_mode == 1 || head_mode == 2;
  a.b.is_fit[q] = head_mode == 3;
  a.b.is_pre[q] = is_pre;
  a.b.pend[q] = pending && is_pre;
  a.b.head_borrow[q] = head_borrow;
}

}  // namespace
}  // namespace drain

extern "C" int drain_nominate(const int* ints, int n_ints, void* const* ptrs,
                              int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (a.Q + threads - 1) / threads;
  if (blocks > 0) {
    drain::nominate<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
