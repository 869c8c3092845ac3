// Kernel B10c, drain_preempt_motion: the preempt drain cycle's end.
//
// Replaces the cycle end and queue motion of kueue_tpu/ops/drain_kernel.py
// solve_drain_preempt (:2168-2271) and its while_loop condition
// (:2278-2287):
//   - leaf usage: admitted heads charge their cells; every victim
//     evicted this cycle releases its full usage at its owner row; the
//     eviction is recorded (cycle, evicting queue);
//   - an admitted entry fills its part-B pool slot with its cells, a
//     live reclaim candidate from the next cycle on; in the fair-preempt
//     drain (its `pq_cu` pointer set, NULL in the classic drain) also
//     the slot's row of the fair panels, its usage at the segment's
//     panel cells (solve_drain_fair_preempt, :2744-2770);
//   - queue motion: admitted heads leave (status 2); NoFit heads and
//     searches that found no victims park (1) unless a flavor walk
//     left a pending cursor; heads skipped after a successful search
//     (the fits re-check or the overlap guard) and successful
//     preempters stay pending; an untrusted (truncated, missed) search
//     freezes its queue as stuck; the PendingFlavors retry budget and
//     the stagnation guard (no head advanced and nothing evicted for
//     2 x max(retry_cap) cycles) as in the plain drain;
//   - an eviction in a root cohort reactivates that cohort's parked
//     entries; each queue's next head is its first pending entry;
//   - the cycle counter advances and `done` is set once no unstuck
//     queue has a pending entry or max_cycles is reached.
//
// Design: the whole card, one launch. A block of 8 warps takes a run of
// the S x V pool slots (a thread a slot: the eviction record and the
// owner's release, 64-bit atomicAdd, since victims of one owner and
// admitted heads may share a row) and 8 queues, a warp a queue: its
// scalars loaded once by every lane, its cells a lane each (the charge,
// the slot fill, the fair panel's sums by shuffles), its segment's
// eviction bytes read a word a lane and voted (`released`), its L
// statuses a lane each, all L of them updated, and its next head the
// first set bit of a ballot.
// The whole-drain reductions (anything evicted or advanced, the largest
// retry cap, a live queue) go through a last-arriving-block ticket in a
// small scratch (`motion_scratch`, reset by that block for the next
// launch): every block folds its partials in with atomics, fences, and
// takes a ticket; the last one computes no_prog and the stagnation test,
// freezes the queues that were active and did not advance (flagged in
// the scratch by their warps) only when the drain is stagnant, which is
// rare, and writes the cycle, no_prog and done. A cooperative launch's
// grid barrier would do the same with every block resident at once and
// a second wait for all of them; the ticket lets every block but the
// last leave as soon as it is done. What bounds it: launch latency and a
// few dependent trips to device memory a block (chip_smoke.py counts the
// bytes of each launch). A set `done` flag makes the launch a no-op.

#include <limits.h>

#include "drain_common.cuh"

namespace drain {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// motion_scratch: the ticket, anything evicted or advanced, the largest
// retry cap, a live queue; then a byte a queue: active and not advanced
enum { kTicket, kAnyProg, kMaxCap, kAnyLive, kCand };

__device__ __forceinline__ void add_to(long long* x, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(x), static_cast<unsigned long long>(v));
}

// Whether any slot of the segment's pool row was evicted this cycle: a
// word (or a byte, for rows not a multiple of 4) a lane, voted.
__device__ __forceinline__ bool segment_released(const uint8_t* ev, int V, int lane) {
  bool any = false;
  if ((V & 3) == 0) {
    const unsigned* w = reinterpret_cast<const unsigned*>(ev);
    for (int i = lane; i < (V >> 2); i += 32) any |= w[i] != 0u;
  } else {
    for (int v = lane; v < V; v += 32) any |= ev[v] != 0;
  }
  return __any_sync(kFull, any);
}

__global__ void __launch_bounds__(kThreads, 1) motion(Args a) {
  if (*a.s.done) return;
  __shared__ int any_prog, max_cap, any_live, last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    any_prog = 0;
    max_cap = INT_MIN;
    any_live = 0;
  }
  __syncthreads();
  const int cycle = *a.s.cycle;
  const int V = a.V, Cv = a.Cv, FR = a.FR, L = a.L, P = a.P, G = a.G;
  const int PC = a.P * a.C;
  int* scratch = a.motion_scratch;
  uint8_t* cand = reinterpret_cast<uint8_t*>(scratch + kCand);

  // this cycle's evictions: the block's run of slots
  const long long slots = (long long)a.n_segments * V;
  const long long x_lo = slots * blockIdx.x / gridDim.x;
  const long long x_hi = slots * (blockIdx.x + 1) / gridDim.x;
  bool evicted = false;
  for (long long x = x_lo + tid; x < x_hi; x += kThreads) {
    if (!a.p.ev_now[x]) continue;
    evicted = true;
    a.p.vevicted[x] = 1;
    a.p.evict_cycle[x] = cycle;
    a.p.evict_by[x] = a.p.ev_by[x];
    const int owner = max(a.p.sowner[x], 0);
    for (int cv = 0; cv < Cv; ++cv) {
      const int cell = a.p.pcells[x * Cv + cv];
      if (cell >= 0) add_to(&a.s.local[(size_t)owner * FR + cell], -a.p.pqty[x * Cv + cv]);
    }
  }
  if (evicted) any_prog = 1;

  // a warp a queue: admission, pool fill, status and the motion
  const int q = blockIdx.x * kWarps + warp;
  if (q < a.Q) {
    const int cur_raw = a.s.cursor[q];
    const bool active = cur_raw < a.q.qlen[q] && a.s.alive[q];
    const int cur = min(cur_raw, L - 1);
    const bool is_fit = a.b.is_fit[q], pend = a.b.pend[q];
    const bool admitted = a.b.admitted[q], preempt_ok = a.p.preempt_ok[q];
    const bool psuccess = a.p.psuccess[q], untrusted = a.p.untrusted[q];
    const bool stuck0 = a.s.stuck[q];
    const int retries = a.s.retries[q], cap = a.s.cap[q];
    const int cq = max(a.q.cq_rows[q], 0), seg = a.q.seg_id[q];
    const int slot = a.p.entry_slot[(size_t)q * L + cur];
    int cell = -1;
    long long qv = 0;
    if (lane < PC) {
      cell = a.b.cells_eff[(size_t)q * PC + lane];
      qv = a.b.qty_eff[(size_t)q * PC + lane];
    }
    if (admitted && cell >= 0 && qv > 0) add_to(&a.s.local[(size_t)cq * FR + cell], qv);
    if (admitted && active && slot >= 0) {
      const size_t x = (size_t)max(seg, 0) * V + slot;
      for (int cv = lane; cv < Cv; cv += 32) {
        // lane cv holds head cell cv (PC <= 32 <= cv past the first round)
        a.p.pcells[x * Cv + cv] = cv < PC ? cell : -1;
        a.p.pqty[x * Cv + cv] = cv < PC ? qv : 0;
      }
      if (lane == 0) a.p.pvalid[x] = 1;
      if (a.fp.pq_cu) {
        // the fair panels' view of the slot: the head's request at its
        // segment's panel cells, a panel cell a lane
        const int* seg_cells = a.fp.seg_cells + (size_t)max(seg, 0) * a.Cu;
        for (int c0 = 0; c0 < a.Cu; c0 += 32) {
          const int c = c0 + lane;
          const int sc = c < a.Cu ? seg_cells[c] : -1;
          long long sum = 0;
          for (int i = 0; i < PC; ++i) {
            const int ci = __shfl_sync(kFull, cell, i);
            const long long qi = __shfl_sync(kFull, qv, i);
            if (sc >= 0 && ci >= 0 && qi > 0 && ci == sc) sum += qi;
          }
          if (c < a.Cu) a.fp.pq_cu[x * a.Cu + c] = sum;
        }
      }
    }
    const bool pre_skipped = psuccess && !preempt_ok;
    const bool undecided = active && !is_fit && !preempt_ok && !pre_skipped;
    bool stuck = stuck0 || untrusted || (undecided && pend && retries >= cap);
    const bool retrying = undecided && pend && !stuck;
    const int status_new = admitted ? 2 : ((undecided && !pend) ? 1 : 0);
    const bool advanced = active && status_new != 0;
    stuck = stuck && !advanced;
    if (lane == 0) {
      a.s.retries[q] = (advanced || !active) ? 0 : (retrying ? retries + 1 : retries);
      a.s.stuck[q] = stuck;
      cand[q] = active && !advanced;  // frozen if the drain is stagnant
      if (admitted && active) a.s.adm_cycle[(size_t)q * L + cur] = cycle;
      if (advanced) any_prog = 1;
      atomicMax(&max_cap, cap);
    }
    if (admitted && active) {
      for (int p = lane; p < P; p += 32) {
        a.s.adm_k[((size_t)q * L + cur) * P + p] = a.b.rep_k[q * P + p];
      }
    }
    const bool lost = active && is_fit && !admitted;
    const bool reset = admitted || (active && !is_fit && !retrying) || preempt_ok;
    if (reset || lost || retrying) {
      for (int i = lane; i < P * G; i += 32) {
        const size_t x = (size_t)q * P * G + i;
        a.s.g_start[x] = reset ? 0 : a.b.walk_next[x];
      }
    }
    // reactivation and the next head: a status a lane, every run of 32
    // updated (the head's new status and the released parked entries
    // may lie past the first pending one)
    const bool released = seg >= 0 && segment_released(a.p.ev_now + (size_t)seg * V, V, lane);
    int* status = a.p.status + (size_t)q * L;
    int next = L;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int l = l0 + lane;
      int st = -1;
      if (l < L) {
        const int was = status[l];
        st = (active && l == cur) ? status_new : was;
        if (released && st == 1) st = 0;
        if (st != was) status[l] = st;
      }
      const unsigned pending = __ballot_sync(kFull, st == 0);
      if (pending && next == L) next = l0 + __ffs(pending) - 1;
    }
    if (lane == 0) {
      a.s.cursor[q] = next;
      if (next < a.q.qlen[q] && !stuck) any_live = 1;
    }
  }

  // the whole drain's reductions: the last block to arrive finishes them
  __syncthreads();
  if (tid == 0) {
    if (any_prog) atomicOr(scratch + kAnyProg, 1);
    atomicMax(scratch + kMaxCap, max_cap);
    if (any_live) atomicOr(scratch + kAnyLive, 1);
    __threadfence();
    last = atomicAdd(scratch + kTicket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const volatile int* vs = scratch;
  const int no_prog = vs[kAnyProg] ? 0 : *a.s.no_prog + 1;
  const int cap_max = vs[kMaxCap];
  const bool stagnant = no_prog >= 2 * cap_max;
  bool live = vs[kAnyLive];
  if (stagnant) {
    // the stagnation freeze: every queue active this cycle that did not
    // advance is stuck, and a live queue is one still unstuck
    __syncthreads();
    if (tid == 0) any_live = 0;
    __syncthreads();
    for (int i = tid; i < a.Q; i += kThreads) {
      bool st = __ldcg(a.s.stuck + i);
      if (__ldcg(cand + i)) {
        st = true;
        a.s.stuck[i] = 1;
      }
      if (__ldcg(a.s.cursor + i) < a.q.qlen[i] && !st) any_live = 1;
    }
    __syncthreads();
    live = any_live;
  }
  if (tid == 0) {
    *a.s.no_prog = no_prog;
    *a.s.cycle = cycle + 1;
    if (!(live && cycle + 1 < a.max_cycles)) *a.s.done = 1;
    scratch[kAnyProg] = 0;
    scratch[kMaxCap] = INT_MIN;
    scratch[kAnyLive] = 0;
    scratch[kTicket] = 0;
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_preempt_motion(const int* ints, int n_ints, void* const* ptrs,
                                    int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.p.status == nullptr || a.motion_scratch == nullptr || a.Cv < a.P * a.C ||
      a.P * a.C > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid = max(1, (a.Q + drain::kWarps - 1) / drain::kWarps);
  drain::motion<<<grid, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
