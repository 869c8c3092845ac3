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
// their first occurrence. It also clears the cycle's `admitted` flags
// for drain_phase2. A set `done` flag makes the launch a no-op. A
// queue the megaloop retired (`alive` 0) nominates nothing.
//
// In the preempt drains (their pointers set) it also carries the
// reclaim oracle of kueue_tpu/ops/drain_kernel.py:255-300 and
// ops/assign_kernel.py:186-187: the head's eligible same-CQ victims
// over its segment's live pool (preemption.go:480-524's priority rule,
// kept for drain_preempt_search) and the cells they use (its row of
// `veto`); a vetoed cell cannot be upgraded to RECLAIM, and
// canPreemptWhileBorrowing (`pwb`) lets the preempt mode cover requests
// above nominal. It also writes the merged cells needing preemption
// (`need_pre`).
//
// What bounds it: at the headline shape (Q=1000 heads, K=8, C=3, G=2,
// P=1) it must move about 1.2 MB at the first cycle (the live heads'
// entries, per-head state and the distinct quota cells they gather, as
// chip_smoke.py counts it), ~0.36 us at 3.35 TB/s: launch latency and
// the chain of dependent loads a head (cursor -> entry -> cells ->
// quota cells) bound it. Design: one warp per queue head, 4 heads a
// block.
//   - Lanes go over the entry podset's (candidate, cell) pairs, K*C of
//     them (24 at the headline), folded onto the lanes up to 4 deep
//     (K*C <= 128); every gather of a fold is issued at once.
//   - The per-candidate fit / preempt / reclaim / borrow masks are
//     warp votes (__ballot_sync) over the pairs; lane k then reads
//     candidate k's C bits out of the votes.
//   - Each group walk is warp reductions over the candidate lanes:
//     the stop rule, the best mode, the score argmax with ties to the
//     earliest flavor index (64-bit max as two 32-bit redux.sync), the
//     choice's mode and last flag, the resume cursor.
//   - The merged cells live one a lane (P*C <= 32): the inflation by
//     earlier podsets and the merge of duplicates are shuffles.
//   - The reclaim oracle's victim loop is split across the lanes; the
//     veto row is complete (__syncwarp) before a lane reads it.
// No per-thread array is indexed at run time: the fold and group loops
// are unrolled over their caps.

#include "drain_common.cuh"

namespace drain {
namespace {

constexpr int kInf = 1 << 30;
constexpr long long kNeg = -(1LL << 62);
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;                            // queue heads a block
constexpr int kMaxFold = (kMaxK * kMaxC + 31) / 32;  // pairs a lane

// Largest int64 over the warp: the high words' max, then the low words'
// max among the lanes holding it.
__device__ __forceinline__ long long warp_max64(long long v) {
  const int hi = (int)(v >> 32);
  const int mh = __reduce_max_sync(kFull, hi);
  const unsigned lo = __reduce_max_sync(kFull, hi == mh ? (unsigned)v : 0u);
  return (long long)(((unsigned long long)(unsigned)mh << 32) | lo);
}

// The C bits of the votes starting at pair s (s + C <= 128): pairs
// 0-63 in lo, 64-127 in hi.
__device__ __forceinline__ uint32_t bits_at(unsigned long long lo, unsigned long long hi,
                                            int s, int C) {
  unsigned long long v;
  if (s >= 64) v = hi >> (s - 64);
  else v = s ? (lo >> s) | (hi << (64 - s)) : lo;
  return (uint32_t)v & ((1u << C) - 1u);
}

struct Votes {
  unsigned long long lo, hi;
};

template <class Pred>
__device__ __forceinline__ Votes vote(int nfold, Pred pred) {
  uint32_t w[kMaxFold];
#pragma unroll
  for (int t = 0; t < kMaxFold; ++t) w[t] = t < nfold ? __ballot_sync(kFull, pred(t)) : 0u;
  return {w[0] | ((unsigned long long)w[1] << 32), w[2] | ((unsigned long long)w[3] << 32)};
}

__global__ void __launch_bounds__(kWarps * 32) nominate(Args a) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (*a.s.done || q >= a.Q) return;  // warp-uniform
  const int P = a.P, K = a.K, C = a.C, G = a.G, FR = a.FR, PC = a.P * a.C;
  const int cursor = __ldg(a.s.cursor + q);
  const bool active = cursor < __ldg(a.q.qlen + q) && __ldg(a.s.alive + q);
  uint8_t* veto = a.p.veto ? a.p.veto + (size_t)q * FR : nullptr;
  const int cur = min(cursor, a.L - 1);
  if (lane == 0) a.b.admitted[q] = 0;
  if (veto) {
    for (int f = lane; f < FR; f += 32) veto[f] = 0;
    if (lane < PC) a.p.need_pre[(size_t)q * PC + lane] = 0;
    __syncwarp();
    const int sq = max(a.q.seg_id[q], 0);
    const long long prio = a.q.priority[(size_t)q * a.L + cur];
    const long long ts = a.q.timestamp[(size_t)q * a.L + cur];
    const bool same_on = active && a.p.same_enabled[q];
    for (int v = lane; v < a.V; v += 32) {
      const size_t x = (size_t)sq * a.V + v;
      bool eligible = false;
      if (same_on) {
        const long long sp = a.p.sprio[x];
        eligible = a.p.pvalid[x] && !a.p.vevicted[x] && a.p.sowner[x] >= 0 &&
                   a.p.sowner_local[x] == a.p.hlocal[q] &&
                   (sp < prio || (a.p.same_prio_ok[q] && sp == prio && ts < a.p.sts[x]));
      }
      a.p.elig_same[(size_t)q * a.V + v] = eligible;
      if (!eligible) continue;
      for (int cv = 0; cv < a.Cv; ++cv) {
        const int cell = a.p.pcells[x * a.Cv + cv];
        if (cell >= 0) veto[cell] = 1;
      }
    }
    __syncwarp();  // the veto row is whole before any lane reads it
  }
  if (!active) {
    if (lane == 0) {
      a.b.is_fit[q] = 0;
      a.b.is_pre[q] = 0;
      a.b.pend[q] = 0;
      a.b.head_borrow[q] = 0;
    }
    if (lane < P) a.b.rep_k[q * P + lane] = -1;
    for (int i = lane; i < P * G; i += 32) a.b.walk_next[q * P * G + i] = 0;
    if (lane < PC) {
      a.b.cells_eff[q * PC + lane] = -1;
      a.b.qty_eff[q * PC + lane] = 0;
    }
    return;
  }
  const int cq = max(__ldg(a.q.cq_rows + q), 0);
  const bool has_cohort = __ldg(a.t.parent + cq) >= 0;
  const int npod = __ldg(a.q.n_podsets + q * a.L + cur);
  const bool ffb = __ldg(a.q.ffb + q), ffp = __ldg(a.q.ffp + q);
  // canPreemptWhileBorrowing: borrowWithinCohort, and in the
  // fair-preempt drain also reclaimWithinCohort
  // (kueue_tpu/ops/drain_kernel.py:2426)
  const bool pwb = a.p.bwc && (a.p.bwc[q] || (a.fp.pq_cu && a.p.reclaim_enabled[q]));
  const int KC = K * C, nfold = (KC + 31) >> 5;
  const size_t row = (size_t)cq * FR;

  // merged slot `lane` (P*C <= 32): the podsets' representative cells
  int mcell = -1;
  long long mqty = 0;
  bool mneed = false;
  bool processed = true, head_borrow = false, pending = false;
  int head_mode = 3;

  for (int p = 0; p < P; ++p) {
    // a podset past the entry's count, or after one with no choice, is
    // inert: no choice, cursor 0, mode FIT
    if (!(p < npod && processed)) {
      if (lane == 0) a.b.rep_k[q * P + p] = -1;
      if (lane < G) a.b.walk_next[(q * P + p) * G + lane] = 0;
      continue;
    }
    const size_t e = ((size_t)q * a.L + cur) * P + p;  // entry podset
    const int* cells_p = a.q.cells + e * KC;
    const long long* qty_p = a.q.qty + e * KC;
    const int8_t* cg_p = a.q.cgrp + e * KC;
    const int* gs = a.s.g_start + ((size_t)q * P + p) * G;

    // lane k: candidate k's walk inputs
    const bool cand = lane < K;
    int gid[kMaxG];
    uint32_t glast = 0;
    bool vk = cand && __ldg(a.q.valid + e * K + lane);
    const long long sc = cand && a.q.score ? __ldg(a.q.score + e * K + lane) : 0;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      gid[g] = 0;
      if (g < G && cand) {
        gid[g] = __ldg(a.q.gidx + (e * K + lane) * G + g);
        glast |= (uint32_t)__ldg(a.q.glast + (e * K + lane) * G + g) << g;
        vk = vk && gid[g] >= __ldg(gs + g);
      }
    }

    // lanes over (candidate, cell) pairs j = 32 t + lane
    int cell[kMaxFold];
    long long qv[kMaxFold], infl[kMaxFold];
    int cg[kMaxFold];
#pragma unroll
    for (int t = 0; t < kMaxFold; ++t) {
      const int j = 32 * t + lane;
      const bool in = t < nfold && j < KC;
      cell[t] = in ? __ldg(cells_p + j) : -1;
      qv[t] = in ? __ldg(qty_p + j) : 0;
      cg[t] = in ? __ldg(cg_p + j) : -1;
      infl[t] = qv[t];
    }
    // assignment_usage of earlier podsets: their merged cells, a lane each
    for (int i = 0; i < p * C; ++i) {
      const int mc = __shfl_sync(kFull, mcell, i);
      const long long mq = __shfl_sync(kFull, mqty, i);
#pragma unroll
      for (int t = 0; t < kMaxFold; ++t)
        if (cell[t] >= 0 && qv[t] > 0 && mc == cell[t]) infl[t] += mq;
    }
    bool fit[kMaxFold], pot[kMaxFold], rec[kMaxFold], bor[kMaxFold];
#pragma unroll
    for (int t = 0; t < kMaxFold; ++t) {
      const bool vetoed = veto && cell[t] >= 0 && veto[cell[t]];
      if (!(cell[t] >= 0 && infl[t] > 0)) {  // pad / zero cells are permissive
        fit[t] = pot[t] = true;
        rec[t] = !vetoed;
        bor[t] = false;
        continue;
      }
      const size_t x = row + cell[t];
      const long long nom = __ldg(a.t.nominal + x), loc = __ldg(a.s.local + x);
      fit[t] = __ldg(a.b.avail + x) >= infl[t];
      pot[t] = infl[t] <= __ldg(a.t.potential + x) && (infl[t] <= nom || pwb);
      rec[t] = loc + infl[t] <= nom && !vetoed;
      bor[t] = loc + infl[t] > __ldg(a.t.subtree + x) && has_cohort;
    }
    const Votes vf = vote(nfold, [&](int t) { return fit[t]; });
    const Votes vp = vote(nfold, [&](int t) { return pot[t]; });
    const Votes vr = vote(nfold, [&](int t) { return rec[t]; });
    const Votes vb = vote(nfold, [&](int t) { return bor[t]; });
    const int s = cand ? lane * C : 0;
    const uint32_t fm = bits_at(vf.lo, vf.hi, s, C), pm = bits_at(vp.lo, vp.hi, s, C);
    const uint32_t rm = bits_at(vr.lo, vr.hi, s, C), bm = bits_at(vb.lo, vb.hi, s, C);

    // per-group walks, warp reductions over the candidate lanes
    int walk_mode = 3;
    bool pend_p = false, all_match = true;
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const Votes vg = vote(nfold, [&](int t) { return cg[t] == g; });
      const uint32_t in_g = cand ? bits_at(vg.lo, vg.hi, s, C) : 0u;
      const uint32_t nf = in_g & ~fm;  // the group's cells that do not fit
      const int mode = (nf & ~pm) ? 0 : (nf & ~rm) ? 1 : nf ? 2 : 3;
      const bool borrow_ok = !(in_g & bm) || ffb;
      const bool stop = vk && ((mode == 3 && borrow_ok) ||
                               ((mode == 1 || mode == 2) && ffp && borrow_ok));
      const long long stop_best = warp_max64(stop ? sc : kNeg);
      const int best_mode = __reduce_max_sync(kFull, vk ? mode : -1);
      const int stop_idx = __reduce_min_sync(kFull, stop && sc == stop_best ? gid[g] : kInf);
      const bool at_best = vk && mode == best_mode;
      const long long bm_best = warp_max64(at_best ? sc : kNeg);
      const int best_idx = __reduce_min_sync(kFull, at_best && sc == bm_best ? gid[g] : kInf);
      const bool stopped = stop_idx < kInf;
      const int ch = stopped ? stop_idx : best_idx;
      const bool at = vk && gid[g] == ch;
      const int ch_mode = __reduce_max_sync(kFull, at ? mode : -1);
      const bool is_last = __any_sync(kFull, at && ((glast >> g) & 1u));
      const bool have = ch < kInf && ch_mode >= 1;
      walk_mode = min(walk_mode, have ? ch_mode : 0);
      const int tried = (stopped && !is_last) ? ch : -1;
      pend_p = pend_p || tried >= 0;
      all_match = all_match && gid[g] == ch;
      if (lane == 0) a.b.walk_next[(q * P + p) * G + g] = tried + 1;
    }
    const unsigned reps = __ballot_sync(kFull, vk && all_match);
    const int k_rep = reps ? __ffs(reps) - 1 : -1;
    const int chosen = (walk_mode == 3 && k_rep >= 0) ? k_rep : -1;
    const int pre = ((walk_mode == 1 || walk_mode == 2) && k_rep >= 0) ? k_rep : -1;

    // the podset's representative choice into merged slots p*C..p*C+C-1
    const int mode_p = chosen >= 0 ? 3 : (pre >= 0 ? 1 : 0);
    const int rep = chosen >= 0 ? chosen : pre;
    const bool use = rep >= 0;
    const int rs = max(rep, 0);
    const int c = lane - p * C;
    const bool mine = c >= 0 && c < C;
    const int j = rs * C + (mine ? c : 0);
    int cr = -1;
    long long qr = 0;
#pragma unroll
    for (int t = 0; t < kMaxFold; ++t) {
      if (t >= nfold) break;
      const int ct = __shfl_sync(kFull, cell[t], j & 31);
      const long long qt = __shfl_sync(kFull, qv[t], j & 31);
      if ((j >> 5) == t) {
        cr = ct;
        qr = qt;
      }
    }
    const uint32_t f_rep = bits_at(vf.lo, vf.hi, rs * C, C);
    const uint32_t b_rep = bits_at(vb.lo, vb.hi, rs * C, C);
    const int mc = (use && cr >= 0) ? cr : -1;
    if (mine) {
      mcell = mc;
      mqty = mc >= 0 ? qr : 0;
      // the choice's cells that did not fit: its frs_need_preemption
      mneed = mc >= 0 && mqty > 0 && !((f_rep >> c) & 1u);
    }
    const bool borrow_rep = __any_sync(kFull, mine && mc >= 0 && ((b_rep >> c) & 1u));
    head_borrow = head_borrow || (borrow_rep && use);
    pending = pending || pend_p;
    head_mode = min(head_mode, mode_p);
    processed = mode_p >= 1;
    if (lane == 0) a.b.rep_k[q * P + p] = use ? rep : -1;
  }

  // merge duplicate cells onto their first occurrence (P > 1 only: a
  // single candidate's cells are distinct by construction)
  int cell_out = mcell;
  long long qty_out = mqty;
  bool need_out = mneed;
  if (P > 1) {
    bool first = true;
    long long sum = 0;
    for (int i = 0; i < PC; ++i) {
      const int mc = __shfl_sync(kFull, mcell, i);
      const long long mq = __shfl_sync(kFull, mqty, i);
      const bool mn = __shfl_sync(kFull, (int)mneed, i) != 0;
      if (mcell < 0 || mc != mcell) continue;
      sum += mq;
      need_out = need_out || mn;
      if (i < lane) first = false;
    }
    if (mcell >= 0) {
      cell_out = first ? mcell : -1;
      qty_out = first ? sum : 0;
      need_out = need_out && first;
    }
  }
  if (lane < PC) {
    a.b.cells_eff[q * PC + lane] = cell_out;
    a.b.qty_eff[q * PC + lane] = qty_out;
    if (veto) a.p.need_pre[(size_t)q * PC + lane] = need_out;
  }
  if (lane == 0) {
    const bool is_pre = head_mode == 1 || head_mode == 2;
    a.b.is_fit[q] = head_mode == 3;
    a.b.is_pre[q] = is_pre;
    a.b.pend[q] = pending && is_pre;
    a.b.head_borrow[q] = head_borrow;
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_nominate(const int* ints, int n_ints, void* const* ptrs,
                              int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  const int blocks = (a.Q + drain::kWarps - 1) / drain::kWarps;
  if (blocks > 0) {
    drain::nominate<<<blocks, drain::kWarps * 32, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
