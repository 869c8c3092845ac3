// Kernel 6, megaloop_boundary: the megaloop's round bookkeeping,
// launched after drain_queue_motion in every megaloop cycle.
//
// Replaces the loop body of kueue_tpu/ops/megaloop_kernel.py
// solve_drain_megaloop after its _plain_cycle (:128-173) and the
// while_loop condition (:169-173). In order:
//   1. stamp the round index on the admission this cycle made (the
//      JAX code stamps every entry with adm_k >= 0 and adm_round < 0;
//      only the entry just behind each queue's cursor can be one, so
//      that is the entry read);
//   2. count the cycle;
//   3. close the round when it quiesced (no alive queue with entries
//      left is unstuck) or ran chunk_cycles cycles (the state's cycle
//      counter counts the round's cycles): snapshot the cursors, the
//      stuck-or-retired queues, the round's cycles and the leaf usage
//      (N x FR int64) at index min(round, max_rounds - 1); retire the
//      stuck queues from `alive`; zero the per-group cursors, retries,
//      the stagnation counter and the stuck flags; gather the next
//      round's retry budget from cap_suffix at each cursor (0 for
//      retired and drained queues); advance the round and zero the
//      round's cycle counter;
//   4. the loop condition into `done`: some alive queue has entries
//      and is not stuck, and rounds remain.
// A set `done` makes the launch a no-op, as for the other drain
// kernels, so the host can enqueue every cycle of the megaloop's bound
// with no read.
//
// What bounds it: at a boundary it copies the leaf usage (N x FR int64,
// 143 kB at the headline) into the log; between boundaries it reads a
// few bytes a queue. Both are far below what launch latency costs, and
// two reductions over the queues need one block. Design: one block of
// 1024 threads striding over Q (phase A: stamps and the quiescence
// test; phase B: the boundary's per-queue writes and the loop
// condition), the usage copy strided over all threads.

#include "drain_common.cuh"

namespace drain {
namespace {

constexpr int kThreads = 1024;

__global__ void boundary(Args a) {
  if (*a.s.done) return;
  __shared__ int any_unstuck, any_more, close_round, ri;
  if (threadIdx.x == 0) {
    any_unstuck = 0;
    any_more = 0;
  }
  __syncthreads();
  const int round_idx = *a.r.round_idx;

  // phase A: the round stamp of this cycle's admissions, quiescence
  for (int q = threadIdx.x; q < a.Q; q += blockDim.x) {
    const int cursor = a.s.cursor[q];
    if (cursor > 0) {
      const size_t e = (size_t)q * a.L + min(cursor - 1, a.L - 1);
      if (a.s.adm_k[e * a.P] >= 0 && a.r.adm_round[e] < 0) a.r.adm_round[e] = round_idx;
    }
    if (cursor < a.q.qlen[q] && a.s.alive[q] && !a.s.stuck[q]) any_unstuck = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    *a.r.total += 1;
    close_round = !any_unstuck || *a.s.cycle >= a.chunk_cycles;
    ri = min(round_idx, a.max_rounds - 1);
  }
  __syncthreads();

  // phase B: the boundary's writes and the loop condition
  const bool closing = close_round;
  if (closing) {
    const size_t nfr = (size_t)a.N * a.FR;
    long long* snap = a.r.r_usage + (size_t)ri * nfr;
    for (size_t i = threadIdx.x; i < nfr; i += blockDim.x) snap[i] = a.s.local[i];
  }
  const int PG = a.P * a.G;
  for (int q = threadIdx.x; q < a.Q; q += blockDim.x) {
    const int cursor = a.s.cursor[q];
    bool stuck = a.s.stuck[q];
    bool alive = a.s.alive[q];
    if (closing) {
      const size_t x = (size_t)ri * a.Q + q;
      a.r.r_cursor[x] = cursor;
      a.r.r_stuck[x] = stuck || !alive;
      alive = alive && !stuck;
      stuck = false;
      a.s.alive[q] = alive;
      a.s.stuck[q] = 0;
      a.s.retries[q] = 0;
      for (int i = 0; i < PG; ++i) a.s.g_start[(size_t)q * PG + i] = 0;
      const bool remaining = cursor < a.q.qlen[q] && alive;
      a.s.cap[q] = remaining ? a.r.cap_suffix[(size_t)q * a.L + min(cursor, a.L - 1)] : 0;
    }
    if (cursor < a.q.qlen[q] && !stuck && alive) any_more = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int next_round = round_idx;
    if (closing) {
      a.r.r_cycles[ri] = *a.s.cycle;
      *a.s.no_prog = 0;
      *a.s.cycle = 0;
      next_round = round_idx + 1;
      *a.r.round_idx = next_round;
    }
    if (!(any_more && next_round < a.max_rounds)) *a.s.done = 1;
  }
}

}  // namespace
}  // namespace drain

extern "C" int megaloop_boundary(const int* ints, int n_ints, void* const* ptrs,
                                 int n_ptrs, void* stream) {
  drain::Args a;
  if (!drain::unpack(ints, n_ints, ptrs, n_ptrs, &a)) return (int)cudaErrorInvalidValue;
  if (a.max_rounds <= 0 || a.r.adm_round == nullptr) return (int)cudaErrorInvalidValue;
  drain::boundary<<<1, drain::kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
