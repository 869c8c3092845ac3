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
// Design: one block of 1024 threads striding over the pool slots, then
// twice over the queues, split by __syncthreads() so the stagnation
// test sees this cycle's progress; leaf usage with 64-bit atomicAdd
// (victims of one owner and admitted heads may share a row); the
// reductions in shared memory. What bounds it: launch latency and the
// passes over Q queues and S x V slots (chip_smoke.py counts the bytes
// of each launch). A set `done` flag makes the launch a no-op.

#include "drain_common.cuh"

namespace drain {
namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ void add_to(long long* x, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(x), static_cast<unsigned long long>(v));
}

__global__ void motion(Args a) {
  if (*a.s.done) return;
  __shared__ int any_prog, max_cap, any_live;
  if (threadIdx.x == 0) {
    any_prog = 0;
    max_cap = -2147483647 - 1;
    any_live = 0;
  }
  __syncthreads();
  const int cycle = *a.s.cycle;
  const int V = a.V, Cv = a.Cv, FR = a.FR, L = a.L, P = a.P, G = a.G;
  const int PC = a.P * a.C;
  const size_t slots = (size_t)a.n_segments * V;

  // this cycle's evictions
  for (size_t x = threadIdx.x; x < slots; x += blockDim.x) {
    if (!a.p.ev_now[x]) continue;
    any_prog = 1;
    a.p.vevicted[x] = 1;
    a.p.evict_cycle[x] = cycle;
    a.p.evict_by[x] = a.p.ev_by[x];
    const int owner = max(a.p.sowner[x], 0);
    for (int cv = 0; cv < Cv; ++cv) {
      const int cell = a.p.pcells[x * Cv + cv];
      if (cell >= 0) add_to(&a.s.local[(size_t)owner * FR + cell], -a.p.pqty[x * Cv + cv]);
    }
  }
  __syncthreads();

  // admissions, pool fill, status and the per-queue motion
  for (int q = threadIdx.x; q < a.Q; q += blockDim.x) {
    const bool active = a.s.cursor[q] < a.q.qlen[q] && a.s.alive[q];
    const int cur = min(a.s.cursor[q], L - 1);
    const bool is_fit = a.b.is_fit[q], pend = a.b.pend[q];
    const bool admitted = a.b.admitted[q], preempt_ok = a.p.preempt_ok[q];
    const int cq = max(a.q.cq_rows[q], 0);
    if (admitted) {
      for (int i = 0; i < PC; ++i) {
        const int cell = a.b.cells_eff[(size_t)q * PC + i];
        const long long qv = a.b.qty_eff[(size_t)q * PC + i];
        if (cell >= 0 && qv > 0) add_to(&a.s.local[(size_t)cq * FR + cell], qv);
      }
    }
    const int slot = a.p.entry_slot[(size_t)q * L + cur];
    if (admitted && active && slot >= 0) {
      const size_t x = (size_t)max(a.q.seg_id[q], 0) * V + slot;
      for (int cv = 0; cv < Cv; ++cv) {
        a.p.pcells[x * Cv + cv] = cv < PC ? a.b.cells_eff[(size_t)q * PC + cv] : -1;
        a.p.pqty[x * Cv + cv] = cv < PC ? a.b.qty_eff[(size_t)q * PC + cv] : 0;
      }
      a.p.pvalid[x] = 1;
      if (a.fp.pq_cu) {
        // the fair panels' view of the slot: the head's request at its
        // segment's panel cells
        const int* seg_cells = a.fp.seg_cells + (size_t)max(a.q.seg_id[q], 0) * a.Cu;
        for (int c = 0; c < a.Cu; ++c) {
          long long sum = 0;
          for (int i = 0; seg_cells[c] >= 0 && i < PC; ++i) {
            const int cell = a.b.cells_eff[(size_t)q * PC + i];
            const long long qv = a.b.qty_eff[(size_t)q * PC + i];
            if (cell >= 0 && qv > 0 && cell == seg_cells[c]) sum += qv;
          }
          a.fp.pq_cu[x * a.Cu + c] = sum;
        }
      }
    }
    const bool pre_skipped = a.p.psuccess[q] && !preempt_ok;
    const bool undecided = active && !is_fit && !preempt_ok && !pre_skipped;
    const int retries = a.s.retries[q];
    bool stuck = a.s.stuck[q] || a.p.untrusted[q] || (undecided && pend && retries >= a.s.cap[q]);
    const bool retrying = undecided && pend && !stuck;
    const int status = admitted ? 2 : ((undecided && !pend) ? 1 : 0);
    const bool advanced = active && status != 0;
    stuck = stuck && !advanced;
    a.s.retries[q] = (advanced || !active) ? 0 : (retrying ? retries + 1 : retries);
    a.s.stuck[q] = stuck;
    if (advanced) any_prog = 1;
    atomicMax(&max_cap, a.s.cap[q]);
    if (admitted && active) {
      for (int p = 0; p < P; ++p) {
        a.s.adm_k[((size_t)q * L + cur) * P + p] = a.b.rep_k[q * P + p];
      }
      a.s.adm_cycle[(size_t)q * L + cur] = cycle;
    }
    if (active) a.p.status[(size_t)q * L + cur] = status;
    const bool lost = active && is_fit && !admitted;
    const bool reset = admitted || (active && !is_fit && !retrying) || preempt_ok;
    for (int i = 0; i < P * G; ++i) {
      const size_t x = (size_t)q * P * G + i;
      a.s.g_start[x] = reset ? 0 : ((lost || retrying) ? a.b.walk_next[x] : a.s.g_start[x]);
    }
  }
  __syncthreads();
  const int no_prog = any_prog ? 0 : *a.s.no_prog + 1;
  const bool stagnant = no_prog >= 2 * max_cap;

  // the stagnation freeze, reactivation and the next heads
  for (int q = threadIdx.x; q < a.Q; q += blockDim.x) {
    const bool active = a.s.cursor[q] < a.q.qlen[q] && a.s.alive[q];
    const bool preempt_ok = a.p.preempt_ok[q];
    const bool undecided = active && !a.b.is_fit[q] && !preempt_ok &&
                           !(a.p.psuccess[q] && !preempt_ok);
    const bool advanced = active && (a.b.admitted[q] || (undecided && !a.b.pend[q]));
    bool stuck = a.s.stuck[q] || (stagnant && active && !advanced);
    a.s.stuck[q] = stuck;
    int* status = a.p.status + (size_t)q * L;
    if (a.q.seg_id[q] >= 0) {
      const uint8_t* ev = a.p.ev_now + (size_t)a.q.seg_id[q] * V;
      bool released = false;
      for (int v = 0; v < V && !released; ++v) released = ev[v];
      if (released) {
        for (int l = 0; l < L; ++l) {
          if (status[l] == 1) status[l] = 0;
        }
      }
    }
    int next = L;
    for (int l = 0; l < L; ++l) {
      if (status[l] == 0) {
        next = l;
        break;
      }
    }
    a.s.cursor[q] = next;
    if (next < a.q.qlen[q] && !stuck) any_live = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    *a.s.no_prog = no_prog;
    *a.s.cycle = cycle + 1;
    if (!(any_live && cycle + 1 < a.max_cycles)) *a.s.done = 1;
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_preempt_motion(const int* ints, int n_ints, void* const* ptrs,
                                    int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.p.status == nullptr || a.Cv < a.P * a.C) return (int)cudaErrorInvalidValue;
  drain::motion<<<1, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
