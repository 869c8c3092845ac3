// Kernel 4, drain_queue_motion: end-of-cycle queue motion and the
// loop condition.
//
// Replaces kueue_tpu/ops/drain_kernel.py _cursor_queue_motion (:396)
// and the while_loop condition of solve_drain (:618-620). Admitted
// heads leave and record (candidate, cycle); non-Fit heads park unless
// a podset walk stored a pending flavor cursor; conflict losers and
// PendingFlavors retries resume from their stored per-group cursors;
// a queue retrying past its joint-cursor budget freezes as stuck, and
// with no queue advancing for 2 x max(retry_cap) cycles every
// non-advancing active queue freezes. Then the device cycle counter
// advances, and `done` is set once no unstuck queue has entries left
// or max_cycles is reached. Every drain launch returns at once while
// `done` is set, so the host may enqueue cycles ahead of its check and
// the cycle count stays exact. In the megaloop (max_rounds > 0) the
// cycle counter counts cycles within the round and megaloop_boundary,
// launched next, owns `done`; a queue it retired (`alive` 0) is
// inactive, and the retry budget is its `cap` buffer, not the plan's
// retry_cap (the two are equal in the plain and fair drains).
//
// What bounds it: global reductions over the queues (any advance, the
// max retry budget, any live queue) in a ~65 KB pass: launch latency.
// Design: one block of 1024 threads striding over Q, two phases split
// by __syncthreads() so the stagnation test sees this cycle's
// `any advance`; reductions in shared memory.

#include "drain_common.cuh"

namespace drain {
namespace {

constexpr int kThreads = 1024;

__global__ void motion(Args a) {
  if (*a.s.done) return;
  __shared__ int any_advance, max_cap, any_live;
  if (threadIdx.x == 0) {
    any_advance = 0;
    max_cap = -2147483647 - 1;
    any_live = 0;
  }
  __syncthreads();
  const int cycle = *a.s.cycle;

  // phase A: stuck / retries, and the reductions
  for (int q = threadIdx.x; q < a.Q; q += blockDim.x) {
    const bool active = a.s.cursor[q] < a.q.qlen[q] && a.s.alive[q];
    const bool is_fit = a.b.is_fit[q], pend = a.b.pend[q];
    const bool admitted = a.b.admitted[q];
    const int retries = a.s.retries[q];
    bool stuck = a.s.stuck[q] || (active && !is_fit && pend && retries >= a.s.cap[q]);
    const bool advance = active && (admitted || (!is_fit && !pend));
    stuck = stuck && !advance;
    const bool retrying = active && !is_fit && pend && !stuck;
    a.s.retries[q] = (advance || !active) ? 0 : (retrying ? retries + 1 : retries);
    a.s.stuck[q] = stuck;
    if (advance) any_advance = 1;
    atomicMax(&max_cap, a.s.cap[q]);
  }
  __syncthreads();
  const int no_prog = any_advance ? 0 : *a.s.no_prog + 1;
  const bool stagnant = no_prog >= 2 * max_cap;

  // phase B: the stagnation freeze, admissions, cursors
  const int P = a.P, G = a.G;
  for (int q = threadIdx.x; q < a.Q; q += blockDim.x) {
    const int cursor = a.s.cursor[q];
    const bool active = cursor < a.q.qlen[q] && a.s.alive[q];
    const bool is_fit = a.b.is_fit[q], pend = a.b.pend[q];
    const bool admitted = a.b.admitted[q];
    const bool advance = active && (admitted || (!is_fit && !pend));
    bool stuck = a.s.stuck[q];
    const bool retrying = active && !is_fit && pend && !stuck;
    stuck = stuck || (stagnant && active && !advance);
    a.s.stuck[q] = stuck;
    const int cur = min(cursor, a.L - 1);
    if (admitted && active) {
      for (int p = 0; p < P; ++p) {
        a.s.adm_k[((size_t)q * a.L + cur) * P + p] = a.b.rep_k[q * P + p];
      }
      a.s.adm_cycle[(size_t)q * a.L + cur] = cycle;
    }
    const bool lost = active && is_fit && !admitted;
    for (int i = 0; i < P * G; ++i) {
      const size_t x = (size_t)q * P * G + i;
      a.s.g_start[x] = advance ? 0 : ((lost || retrying) ? a.b.walk_next[x] : a.s.g_start[x]);
    }
    const int next = cursor + (advance ? 1 : 0);
    a.s.cursor[q] = next;
    if (next < a.q.qlen[q] && !stuck) any_live = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    *a.s.no_prog = no_prog;
    *a.s.cycle = cycle + 1;
    if (a.max_rounds == 0 && !(any_live && cycle + 1 < a.max_cycles)) *a.s.done = 1;
  }
}

}  // namespace
}  // namespace drain

extern "C" int drain_queue_motion(const int* ints, int n_ints, void* const* ptrs,
                                  int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  drain::motion<<<1, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
