#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``kueue_tpu_torch``) on one card.

Run from the repository root: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc``; without them, or without the package beside
it, it exits non-zero and prints no result. It drives these paths: the
plain bulk drain (phases 2-3), the K-round megaloop (phase 4), the
fair-sharing drain (phase 5), the interactive admission cycle (phase
6), the cycle with the batched victim search (phase 7), the drain with
classic preemption (phase 8), the fair cycle with the batched fair
victim search (phase 9), the drain with fair-sharing preemption
(phase 10), Topology-Aware Scheduling: the snapshot's pod counting
and the TAS drain (phase 11), the what-if planner's scenario-batched
solve with the admission policies (phase 12), and the mesh harness:
the unsegmented cycle through ShardedSolver, the fair-sharing DRS
reductions and every drain's mesh= path on a one-card mesh (phase 13),
and the runtime and the federation: ClusterRuntime's serial, pipelined
and megaloop drain loops at bench.py's 50k x 1000-CQ stages and the
MultiKueue federation's global rescore (kernel B15) through
GlobalScheduler at bench.py's 50-worker stage (phase 14).

1. Prints the card's name and power limit, builds the 25 kernels from
   ``kueue_tpu_torch/csrc`` with nvcc (sm_90a, in parallel) and prints
   the build seconds and each kernel's registers, stack frame and
   spills, and the card's shared-memory load latency (a one-thread
   pointer chase): the serial kernels' chain bound (cycle_phase2,
   cycle_global, drain_tas_phase2, plan_phase2) is two such trips a
   walked head of the launch's longest segment (root cohort; the TAS
   drain's one global scan), drain_fair_phase2's 2(D+1) a pop of its
   longest segment (a chain's levels, then the charge up the path).
2. Holds each kernel to its plain PyTorch version on the card, bit-exact
   (int64, tolerance 0), in lockstep at EVERY cycle of two drains: the
   real 50k x 1k headline plan, and a small seeded case with three
   podsets, nonzero candidate scores, a depth-3 cohort forest,
   borrowing and lending limits and PendingFlavors queues that freeze
   as stuck (all 1168 cycles: every admission is decided by cycle 5,
   and its queues freeze at cycles 59, 86, 198 and 1168). The plain
   steps of the headline lockstep are timed. Each cycle's differences
   are taken on the card in stream order and read once a cycle.
   Then the headline drain runs once more on the kernels alone with
   every launch timed on the device (a spin kernel holds the stream
   while the host enqueues the events and the launch), and each
   cycle's bytes bound is counted from that cycle's data.
3. Drives the plain drain through its entry point: headline cluster
   (seed 0) -> Cache -> take_snapshot -> run_drain(device="cuda"), with
   the launch counters reset just before; asserts 74 cycles, 15178
   admitted, 34822 parked, 0 fallback, not truncated, the decision
   digest the JAX package gives, and that every kernel launched. Prints
   the drain's wall time (median of 3 after a warm run), and the
   device time of the same drain's launches replayed as one CUDA graph.
4. The megaloop chain at the headline (perf/megaloop.py: 8 rounds of 8
   cycles a launch, relaunched over the last round's undecided backlog
   until a log is not truncated):
   a. lockstep: every launch of its five per-cycle launches (quota_tree
      once, drain_nominate, drain_phase2, drain_queue_motion,
      megaloop_boundary) held to its plain version at every cycle of
      both launches of the chain, and of mixed_spec(7) at 56 cycles a
      round, where a round boundary retires stuck queues;
   b. the main path: the chained launch_drain_megaloop(device="cuda"),
      counters reset before; asserts MEGALOOP_EXPECT, the lockstep's
      rounds, and every kernel launched; prints each launch's rounds,
      host syncs and wall split into plan, enqueue and fetch;
   c. each round equal to the serial chain of launch_drain(max_cycles=8)
      on cuda (outcome signature, undecided, final usage), with that
      chain's wall beside the megaloop's;
   d. every launch of the chain timed alone on the device, with its
      bytes bound from its own cycle's data.
5. The fair-sharing drain at the headline: lockstep of its launches
   (drain_fair_phase2 in place of drain_phase2) at every cycle of the
   headline and of the depth-3 weighted perf.cases.fair_spec;
   run_drain(fair_sharing=True, device="cuda") gives FAIR_EXPECT with
   every kernel launched; its wall and solve time; every launch timed
   alone with its bytes bound.
6. The interactive cycle (``Scheduler.schedule``) over the headline
   cluster with the whole 50k backlog queued (1000 heads a cycle): the
   16 cycles of CYCLE_EXPECT, then on to cycle 30 (steady state: from
   cycle 24 on each cycle changes at most N/4 usage rows, so the
   resident buffer takes row deltas through scatter_rows):
   a. lockstep: every launch of the cycle's kernels (quota_tree once
      for its four recurrences, cycle_phase1, cycle_phase2, scatter_rows) held to its plain
      version at every one of the 30 headline cycles and of a small
      seeded cluster run to quiescence (perf.cases.cycle_spec:
      depth-3 cohorts, limits, reservations, host victim search),
      whose decisions must equal the same run on the CPU;
   b. the main path: the port's Scheduler on cuda under the strict
      guard (GuardConfig(mode="device", divergence_check_every=1): no
      failover, every cycle re-solved on the host mirror), launch
      counters reset before and read after each of the two runs;
      asserts the JAX package's CYCLE_EXPECT over the first 16 cycles,
      all 40 equal to the lockstep run, the small run equal to its
      lockstep run, every dispatch via the device, 0 failures,
      0 divergences, and every kernel launched by each run;
   c. timing: every cycle-kernel launch timed alone on the device with
      its bytes bound from its own inputs (quota_tree and the two
      phases over the first 16 cycles, scatter_rows over the steady
      ones, index_copy_ on each scatter's inputs beside it), and the
      16 cycles' wall per cycle split into snapshot, lowering,
      dispatch (solve and the one fetch), the rest of nomination and
      the host apply.
7. The interactive cycle with classic preemption over bench.py's
   contended cluster (perf/contended.py: 1000 ClusterQueues in 100
   cohorts, 6000 admitted victims, 5000 queued, ~500 heads a cycle,
   each cycle's victims evicted before the next):
   a. lockstep: every launch of the cycle's kernels and of kernel B8
      (preempt_search, the batched victim search) held to its plain
      version on the same inputs, over 12 cycles;
   b. the main path: Scheduler(use_solver=True,
      use_preempt_solver=True, device="cuda"), counters reset before;
      asserts CONTENDED_CYCLE_EXPECT, the lockstep's records, every
      preempting head searched on the card, every kernel launched;
   c. one cycle with the default use_preempt_solver=None: its first
      probe batches ("device"), with the same decisions;
   d. every B8 launch timed alone with its bytes bound from its own
      problem; the cycles' wall split (snapshot, nomination, the
      batched search within it, the host apply).
8. The drain with classic preemption over the same cluster
   (run_drain_preempt at bench.py's search_width=64):
   a. lockstep: every launch of the preempt cycle (quota_tree once,
      drain_nominate with the reclaim oracle, drain_preempt_search,
      drain_preempt_phase2, drain_preempt_motion) held to its plain
      version at every cycle of both tiers a fresh PanelTuner solves
      (16, which overflows, and 64), and of the depth-3 multi-podset
      perf.cases.preempt_spec(6);
   b. the main path: run_drain_preempt(device="cuda") with a fresh
      tuner, counters reset before; asserts CONTENDED_EXPECT, the panel
      schedule CONTENDED_PANELS and every kernel launched; a forced
      (8, 64) schedule gives the same decisions; the small case on the
      card equals the CPU;
   c. the entry point's wall (median of 3), its host lowering and
      upload, and the solve of each tier (inputs on the card, one
      fetch);
   d. every launch of both tiers timed alone, bytes bound from each
      cycle's own data.
9. The fair cycle over fair-preempt-1k (perf/fairpreempt.py: bench.py's
   fair-preempt cluster at 1000 ClusterQueues in cohorts of 6, 1500
   borrowing victims, 4000 queued, each cycle's victims evicted before
   the next):
   a. lockstep: every launch of the cycle's kernels and of kernel B9
      (fair_search, the batched fair victim tournament) held to its
      plain version on the same inputs, over the first 8 cycles;
   b. the main path: Scheduler(fair_sharing=True, use_solver=True,
      use_preempt_solver=True, device="cuda"), counters reset before;
      asserts FAIR_PREEMPT_CYCLE_EXPECT, the lockstep's records, every
      preempting head searched on the card, the path's kernels launched;
   c. on to quiescence (bench.py's loop), every B9 launch timed alone
      with its bytes bound: the admitted and evicted sets equal the
      fair-preempt drain's;
   d. B9 on bench.py's fair stage (FAIR_SEARCH_EXPECT) and at the
      lowering's caps (S=64 nodes, Cu=32 cells), bit-exact and timed;
   e. the two-tier B9 schedule against one full-width launch on the
      quiescence run's batches and on bench.py's fair batch: host wall
      and device time of each, the same decisions.
10. The drain with fair-sharing preemption:
   a. lockstep: every launch of its cycle (quota_tree once,
      drain_nominate with the reclaim oracle, drain_fair_preempt_search,
      drain_fair_preempt_phase2, drain_preempt_motion with the fair-panel
      fill) held to its plain version at every cycle of fair-preempt-1k,
      of the depth-3 weighted perf.cases.fair_preempt_spec(1) and of the
      drain at the panel caps (perf/fairpreempt.build_fair_wide: M=64
      nodes, depth 3, Cu=64 cells over two resources);
   b. the main path: run_drain_fair_preempt(device="cuda"), counters
      reset before; asserts FAIR_PREEMPT_EXPECT and every kernel
      launched; bench.py's 60-CQ stage gives FAIR_PREEMPT_SMALL_EXPECT;
      the small case on the card equals the CPU; the drain at the panel
      caps gives FAIR_WIDE_EXPECT with every kernel launched (counters
      reset before it too);
   c. the entry point's wall (median of 3), its host lowering and
      upload, and the solve (inputs on the card, one fetch);
   d. every launch timed alone, bytes bound from each cycle's data, at
      fair-preempt-1k (the kernels' line) and at the panel caps (each
      kernel's ``at_panel_caps``).
11. Topology-Aware Scheduling (perf/tas.py):
   a. kernel B12 (tas_leaf_counts: leaf_counts, level_counts) held to
      its plain versions on tas-placement-1k (bench.py's tas stage
      topology, 1024 hosts) with a batch of 16 of tas-drain-10k's
      per-pod requests (assumed usage, a simulate_empty row, a
      taint-masked leaf set), and on tas-fleet-131k (131,072 hosts)
      with such a batch of 3 and with the main path's own input (the
      arguments find_topology_assignments hands leaf_counts, B=1);
      the 1k batch and the fleet's main-path input each timed alone,
      index_add_ beside level_counts;
   b. find_topology_assignments at tas-fleet-131k with the default
      threshold, counters reset before: B12 launched, the assignment
      equal to the same call on a device="cpu" snapshot; the host numpy
      CountIn and B12's (upload, launch, fetch) per podset at both
      sizes;
   c. lockstep: every launch of the TAS cycle (quota_tree once,
      drain_nominate, drain_tas_place, drain_tas_phase2,
      drain_queue_motion) held to its plain version at every cycle of
      tas-drain-10k (bench.py's tas_drain stage, seed 6) and of the
      two-flavor perf.cases.tas_spec(0);
   d. the main path: run_drain_tas(device="cuda") and
      run_drain_for_scope("tas"), counters reset before each: asserts
      TAS_DRAIN_EXPECT (with its in-line replay of the placements) and
      every kernel launched; the small case on the card equals the CPU;
   e. the entry point's wall (median of 3), its host lowering and
      upload, the solve, and every launch timed alone with its bytes
      bound from each cycle's data.
12. The planner and the admission policies (perf/planner.py):
   a. lockstep: the three B14 launches (plan_quota_tree, plan_phase1,
      plan_phase2) held to their plain versions on seeded random
      batches (S = 1, 5, 17), on the small depth-3 case with one
      scenario of every delta kind (priority and policy included; its
      report on cuda equal to the CPU's), and inside ``Planner.plan``
      at planner-stage-500 and planner-sweep-50k (the plain steps
      timed);
   b. the main path: ``Planner.plan(device="cuda")`` at
      planner-sweep-50k and planner-stage-500, counters reset before
      each: asserts PLANNER_SWEEP_EXPECT and PLANNER_STAGE_EXPECT and
      one B14 call (each of its three kernels launched once, nothing
      else); planner-stage-500 with verify_host=True;
   c. policy-48x64: ``run_drain`` under first-fit and under Gavel on
      cuda and the Gavel plan with its forecast give POLICY_EXPECT
      (every drain kernel launched); the two drains' walls; four
      cycles of a Gavel Scheduler on cuda (every cycle launch held to
      its plain version) equal to the same cycles on the CPU, score
      breakdowns included;
   d. times at both planner cells: the plan's wall (median of 3) and
      its spans (snapshot and lowering, stacking, the device solve with
      its upload and fetch, decode, ranking), the solve with its inputs
      on the card, every B14 launch alone with its bytes bound, and
      bench.py's sequential shape (one cycle solve a scenario on the
      card: all 128 scenarios at planner-stage-500, 8 at the sweep).
13. The mesh harness (kueue_tpu_torch/parallel, perf/mesh.py) on
   ``make_mesh(1, device="cuda")``:
   a. the headline Scheduler's 30 cycles with its dispatch on the mesh
      (``dispatch_lowered(mesh=)``, counters reset before: CYCLE_EXPECT
      over the first 16, all 30 equal to phase 6's), each cycle's
      segmented solve (B3) recorded; the main path of kernel B3'
      (cycle_global): ``ShardedSolver(mesh)`` on every recorded cycle,
      counters reset before, its packed rows and usage tree bit-exact
      to B3's on the same heads at every cycle (B3 is held to its plain
      version at these cycles in phase 6) and to ``solve_cycle_plain``
      on the card at cycles 1, 16 and 30 (the plain step loop takes
      seconds a cycle); B3' held to its plain version on seeded
      ``cycle_batch`` problems (reservations, preempt-mode heads,
      depth 3, a 3000-ClusterQueue tree beyond one block's shared
      memory) and ``entry(device="cuda")``'s;
   b. kernel B1' (quota_drs: lendable_per_resource and
      dominant_resource_share) on fair-preempt-1k's snapshot and the
      headline's after its 30 cycles, with a zero and a seeded nonzero
      request and weights with zeros: counters reset before, bit-exact
      to its plain versions, the DRS of every ClusterQueue equal to
      ``dominant_resource_share_np``;
   c. every drain with ``mesh=``, counters reset before each:
      run_drain plain and fair (HEADLINE_EXPECT, FAIR_EXPECT), the
      megaloop chain (MEGALOOP_EXPECT), run_drain_preempt
      (CONTENDED_EXPECT, the narrow-panel canary run on the card and
      certifying), run_drain_fair_preempt (FAIR_PREEMPT_EXPECT),
      run_drain_tas (TAS_DRAIN_EXPECT) and batched_fair_get_targets
      (FAIR_SEARCH_EXPECT, one full-width launch); prints the mesh's
      shape, bucket_stats, placement seconds and the canary's verdicts;
   d. every B3' launch timed alone with its bytes bound from its own
      cycle's data and B3's time on the same heads beside it, the plain
      step loop's time on the card, B1''s launches timed alone, the
      ShardedSolver wall a cycle (median of 30: phase 1, B3', the
      fetch) and each mesh drain's wall (one run) beside the wall of
      the same drain without the mesh from its earlier phase.
14. The runtime and the federation:
   a. B15 (global_rescore) held bit-exact to rescore_plain on the card
      and to the numpy mirror global_np.rescore_np at the CPU tests'
      cases (seeds 0-7 x 12 fleets, degraded masks, wide rotations,
      current columns past C, the key's corner, ties, the hysteresis
      boundary) and at rescore-65k-64 (W=65,536 x C=64) and
      rescore-1k-4096 (W=1024 x C=4096); each launch there timed alone,
      with the plain version's ms and the bytes bound;
   b. perf/multikueue.run_federation_scale(n_workers=50) with every
      runtime on the card and every B15 launch held to rescore_plain,
      counters reset before: FED_SCALE_EXPECT (200/200 admitted, 5
      passes, 5 rescore passes, 24 rebalances, 224 acked retractions,
      1200 s virtual), the applied rebalances' digest
      FED_REBALANCE_DIGEST (from the JAX package on the CPU), every
      rescore with pending rows on path "device", and global_rescore
      launched 3 times (at 108, 45 and 10 pending rows); the federation
      launches are then timed alone on their own inputs (the kernels
      line's B15 numbers);
   c. perf/runtime at bench.py's pipeline stage (seed
      default_rng(13), chunk 16, divergence sampling off): serial then
      pipelined bulk_drain on the card, both RUNTIME_DRAIN_EXPECT,
      rounds >= 2 and prefetches >= 1, no guard failure, the drain
      kernels launched; and at the megaloop stage (default_rng(17),
      chunk 4): serial, pipelined and drain_megaloop="16", all
      RUNTIME_MEGALOOP_EXPECT, megaloop_boundary launched; prints each
      mode's wall, its dispatches and the Pipeline/MegaloopStats; then
      a pipelined and a K=4 megaloop drain of a 32-CQ cut on the card
      with every committed round replayed on the numpy mirror (a
      differing round raises KernelError), none differing;
   d. no fallback on the card (perf/trap.py, each in a process of its
      own over sources with one kernel patched to trap): a trapping B15
      raises KernelError out of GlobalScheduler.rescore with no host
      rescore, and a trapping drain_nominate raises KernelError out of
      a pipelined bulk_drain round's device_join with no failover.
15. Prints the 25 kernels' JSON line, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

No phase is caught and passed over: any failure exits non-zero.
"""

from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from dataclasses import fields

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock, per timed launch
SMALL_SEED = 7  # mixed_spec seed whose drain freezes PendingFlavors queues
SMALL_CYCLES_END = 1168  # its drain's length: its fourth queue freezes at the last cycle
FAIR_SEED = 4  # fair_spec seed: depth 3, weights 0-2000, 133 cycles
SMALL_CYCLE_SEED = 0  # cycle_spec seed: reservations, preemption, scatters
SMALL_CYCLES = 24  # its preempting heads re-nominate until then (no evictions)
STEADY_CYCLES = 30  # the headline run goes on to here: from cycle 24 on, each
# cycle changes at most N/4 usage rows, so the resident buffer takes row deltas
SMALL_FAIR_PREEMPT_SEED = 1  # fair_preempt_spec seed: depth 3, weights 0-2000
SMALL_FAIR_PREEMPT_CYCLES = 32  # its decisions end by cycle 13; stalled heads then spin
TAS_LOCKSTEP_CYCLES = 160  # tas-drain-10k is held in lockstep over its first 160 of
# 490 cycles (its main-path run goes all 490 against TAS_DRAIN_EXPECT)
SMALL_PREEMPT_SEED = 6  # preempt_spec seed: depth 3, three podsets, 65 cycles,
# within-CQ preemption and cross-CQ reclamation, a stuck queue
TRIPS_PER_HEAD = 2  # a walked head's dependent shared-memory trips: read its rows, add
SMEM = {"ns": float("nan")}  # the card's shared-memory load latency (phase 1)

SOURCES = {
    "quota_tree": "kueue_tpu_torch/csrc/quota_tree.cu",
    "drain_nominate": "kueue_tpu_torch/csrc/drain_nominate.cu",
    "drain_phase2": "kueue_tpu_torch/csrc/drain_phase2.cu",
    "drain_queue_motion": "kueue_tpu_torch/csrc/drain_queue_motion.cu",
    "cycle_phase1": "kueue_tpu_torch/csrc/cycle_phase1.cu",
    "cycle_phase2": "kueue_tpu_torch/csrc/cycle_phase2.cu",
    "scatter_rows": "kueue_tpu_torch/csrc/scatter_rows.cu",
    "megaloop_boundary": "kueue_tpu_torch/csrc/megaloop_boundary.cu",
    "drain_fair_phase2": "kueue_tpu_torch/csrc/drain_fair_phase2.cu",
    "preempt_search": "kueue_tpu_torch/csrc/preempt_search.cu",
    "drain_preempt_search": "kueue_tpu_torch/csrc/drain_preempt_search.cu",
    "drain_preempt_phase2": "kueue_tpu_torch/csrc/drain_preempt_phase2.cu",
    "drain_preempt_motion": "kueue_tpu_torch/csrc/drain_preempt_motion.cu",
    "fair_search": "kueue_tpu_torch/csrc/fair_search.cu",
    "drain_fair_preempt_search": "kueue_tpu_torch/csrc/drain_fair_preempt_search.cu",
    "drain_fair_preempt_phase2": "kueue_tpu_torch/csrc/drain_fair_preempt_phase2.cu",
    "tas_leaf_counts": "kueue_tpu_torch/csrc/tas_leaf_counts.cu",
    "drain_tas_place": "kueue_tpu_torch/csrc/drain_tas_place.cu",
    "drain_tas_phase2": "kueue_tpu_torch/csrc/drain_tas_phase2.cu",
    "plan_quota_tree": "kueue_tpu_torch/csrc/plan_quota_tree.cu",
    "plan_phase1": "kueue_tpu_torch/csrc/plan_phase1.cu",
    "plan_phase2": "kueue_tpu_torch/csrc/plan_phase2.cu",
    "cycle_global": "kueue_tpu_torch/csrc/cycle_global.cu",
    "quota_drs": "kueue_tpu_torch/csrc/quota_drs.cu",
    "global_rescore": "kueue_tpu_torch/csrc/global_rescore.cu",
}
REPLACES = {
    "quota_tree": "kueue_tpu/ops/quota.py:93",
    "drain_nominate": "kueue_tpu/ops/drain_kernel.py:230",
    "drain_phase2": "kueue_tpu/ops/drain_kernel.py:451",
    "drain_queue_motion": "kueue_tpu/ops/drain_kernel.py:396",
    "cycle_phase1": "kueue_tpu/ops/assign_kernel.py:199",
    "cycle_phase2": "kueue_tpu/ops/assign_kernel.py:475",
    "scatter_rows": "kueue_tpu/core/solver.py:504",
    "megaloop_boundary": "kueue_tpu/ops/megaloop_kernel.py:82",
    "drain_fair_phase2": "kueue_tpu/ops/drain_kernel.py:1297",
    "preempt_search": "kueue_tpu/ops/preempt_kernel.py:246",
    "drain_preempt_search": "kueue_tpu/ops/drain_kernel.py:1644",
    "drain_preempt_phase2": "kueue_tpu/ops/drain_kernel.py:1745",
    "drain_preempt_motion": "kueue_tpu/ops/drain_kernel.py:1745",
    "fair_search": "kueue_tpu/ops/fair_preempt_kernel.py:430",
    "drain_fair_preempt_search": "kueue_tpu/ops/drain_kernel.py:2359",
    "drain_fair_preempt_phase2": "kueue_tpu/ops/drain_kernel.py:2359",
    "tas_leaf_counts": "kueue_tpu/ops/tas_kernel.py:52",
    "drain_tas_place": "kueue_tpu/ops/drain_kernel.py:689",
    "drain_tas_phase2": "kueue_tpu/ops/drain_kernel.py:894",
    "plan_quota_tree": "kueue_tpu/ops/plan_kernel.py:36",
    "plan_phase1": "kueue_tpu/ops/plan_kernel.py:36",
    "plan_phase2": "kueue_tpu/ops/plan_kernel.py:36",
    "cycle_global": "kueue_tpu/ops/assign_kernel.py:343",
    "quota_drs": "kueue_tpu/ops/quota.py:175",
    "global_rescore": "kueue_tpu/ops/global_kernel.py:115",
}


T0 = time.perf_counter()


def stamp() -> str:
    """Seconds since the script started, for the phase lines."""
    return f"[{time.perf_counter() - T0:.0f} s]"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# ---- timing and bounds -------------------------------------------------


class BoundData:
    """Host copies of a drain's fixed inputs, for the bytes bounds."""

    def __init__(self, ctx):
        qs = ctx.queues
        self.q, self.l, self.p, self.k, self.c = qs.cells.shape
        self.g = qs.gidx.shape[-1]
        self.n, self.fr = ctx.tree.nominal.shape
        self.d1 = ctx.tree.max_depth + 1
        self.s = ctx.segments.count
        self.cells = qs.cells.cpu().numpy()
        self.qlen = qs.qlen.cpu().numpy()
        self.rows = qs.cq_rows.cpu().numpy()
        self.no_reclaim = qs.no_reclaim.cpu().numpy()
        self.paths = ctx.paths.cpu().numpy()
        self.seg_id = qs.seg_id.cpu().numpy()
        self.forest = forest_bytes(ctx.tree)


def forest_bytes(tree) -> int:
    """Bytes of quota_tree's packing of the forest a launch reads: a
    position's node, parent and children (16 B), and each bin's level
    starts."""
    from kueue_tpu_torch.ops.quota import tree_forest

    f = tree_forest(tree)
    return 16 * tree.n_nodes + 4 * f.bins.numel()


def chain_heads(walked: np.ndarray, seg: np.ndarray, n_steps: int) -> int:
    """Walked heads of the longest segment (at most n_steps): the serial
    kernels' chain, each head TRIPS_PER_HEAD dependent shared-memory
    trips after its predecessor's."""
    if not walked.any():
        return 0
    return int(min(np.bincount(seg[walked]).max(), n_steps))


def _distinct(rows: np.ndarray, cells: np.ndarray, fr: int) -> int:
    """Number of distinct (row, cell) pairs, cells < 0 ignored."""
    keep = cells >= 0
    return int(np.unique(rows[keep].astype(np.int64) * fr + cells[keep]).size)


def cycle_bytes(bd: BoundData, cursor: np.ndarray, buf, alive=None) -> dict:
    """Bytes each kernel must move in one cycle (each input read once,
    each output written once), counted from the cycle's own data:
    ``cursor`` (and the megaloop's ``alive``) at the cycle's start and
    the buffers after it, which say who was nominated and admitted.
    quota_tree is its one launch of usage and availability."""
    q, l, p, k, c, g, fr, d1 = bd.q, bd.l, bd.p, bd.k, bd.c, bd.g, bd.fr, bd.d1
    mat = bd.n * fr * 8
    # local, guaranteed, subtree, borrowing_limit in, usage and avail
    # out, and the forest's packing
    quota = [6 * mat + bd.forest]

    active = cursor < bd.qlen
    if alive is not None:
        active &= alive
    n_act = int(active.sum())
    cur = np.minimum(cursor, l - 1)
    head_cells = bd.cells[np.arange(q), cur]  # [Q,P,K,C]
    act = np.nonzero(active)[0]
    entry = p * k * c * (4 + 8 + 1) + p * k * (1 + 8) + p * k * g * (4 + 1)
    per_head_io = 4 * 5 + 2 + 4 * p * g  # queue scalars, flags, cursors
    outs = 5 + 4 * p + 4 * p * g + 12 * p * c
    # avail, nominal, local, potential, subtree of each distinct
    # (cq row, cell) pair the heads' candidates gather from
    pairs = _distinct(
        np.repeat(bd.rows[act], p * k * c), head_cells[act].reshape(-1), fr
    )
    nominate = n_act * (entry + per_head_io) + q * (8 + outs) + pairs * 5 * 8

    is_fit = buf.is_fit.cpu().numpy()
    is_pre = buf.is_pre.cpu().numpy()
    nominated = is_fit | is_pre
    admitted = buf.admitted.cpu().numpy()
    ce = buf.cells_eff.cpu().numpy()
    qe = buf.qty_eff.cpu().numpy()
    ce = np.where(qe > 0, ce, -1)  # cells the walk touches
    nom = np.nonzero(nominated)[0]
    # subtree, guaranteed, borrowing_limit, usage read and usage written
    # once for each distinct (node, cell) pair on a nominated head's path
    path_nodes = bd.paths[bd.rows[nom]]  # [H, D+1]
    pc = ce.shape[1]
    node_rows = np.repeat(path_nodes, pc, axis=1)  # [H, (D+1)*PC]
    node_cells = np.tile(ce[nom], (1, d1))
    node_cells = np.where(node_rows >= 0, node_cells, -1)
    path_pairs = _distinct(node_rows.reshape(-1), node_cells.reshape(-1), fr)
    adm = np.nonzero(admitted)[0]
    adm_pairs = _distinct(np.repeat(bd.rows[adm], pc), ce[adm].reshape(-1), fr)
    reserve = np.nonzero(is_pre & bd.no_reclaim & ~admitted)[0]
    res_pairs = _distinct(np.repeat(bd.rows[reserve], pc), ce[reserve].reshape(-1), fr)
    # per nominated head: borrow, fit, pre, no_reclaim flags, cursor,
    # cq row, priority, timestamp, merged cells and quantities, path row
    per_head = 4 + 4 + 4 + 8 + 8 + 12 * pc + 4 * d1
    phase2 = (
        len(nom) * per_head
        + path_pairs * 5 * 8
        + adm_pairs * 2 * 8  # local read and written
        + res_pairs * 8  # nominal
        + q * (2 + 4 + 1)  # fit/pre flags while ranking, members, admitted out
        + 4 * (bd.s + 1)
    )
    motion = q * (8 + 4 + 3 + 8 + 4 + 2 + 8 * p * g + 4 * p * g) + len(adm) * (
        4 * p + 4 * p + 4
    )
    return {
        "quota_tree": quota,
        "drain_nominate": [nominate],
        "drain_phase2": [phase2],
        "drain_queue_motion": [motion],
    }


def timed_drain(ctx, local, queues):
    """The drain once more on the kernels alone, every launch timed on
    the device through ``TimedLaunches``, for all the cycles that do
    work, with each cycle's bytes (``cycle_bytes``). Returns (cycles,
    the timer)."""
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf.lockstep import STEPS

    bd = BoundData(ctx)
    state = dk.DrainState.initial(local, queues, ctx.max_cycles)
    buf = dk.CycleBuffers.empty(local, queues)
    timer = TimedLaunches()
    cycles = 0
    while not state.done.item():
        cursor = state.cursor.cpu().numpy()
        for name, kern, _ in STEPS:
            timer(name, lambda: kern(ctx, state, buf), None)
        timer.add_bytes(cycle_bytes(bd, cursor, buf))
        timer.add_chain("drain_phase2", drain_chain(bd, buf, ctx.n_steps))
        cycles += 1
    return cycles, timer


def drain_graph_ms(ctx, local, queues, n_cycles, reps=3):
    """Device time of the whole drain with no host in it: ``n_cycles``
    cycles (as many as the main path enqueues; those past the end are
    no-ops) captured in one CUDA graph and replayed from the initial
    state between two events. Returns (median ms, admitted, cycles)."""
    import torch

    from kueue_tpu_torch.ops import drain_kernel as dk

    state0 = dk.DrainState.initial(local, queues, ctx.max_cycles)
    state = state0.clone()
    buf = dk.CycleBuffers.empty(local, queues)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n_cycles):
            dk.drain_cycle(ctx, state, buf)
    times = []
    for _ in range(reps):
        for f in fields(state):
            getattr(state, f.name).copy_(getattr(state0, f.name))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    admitted = int((state.adm_cycle >= 0).sum())
    return float(np.median(times)), admitted, int(state.cycle.item())


# ---- the interactive cycle ------------------------------------------------


def strict_guard(check_every: int = 1):
    """GuardConfig(mode="device", divergence_check_every=1): no
    failover, every device solve re-solved on the host mirror; with a
    log of the path each solve took. The timing runs pass 0 (no
    mirror)."""
    from kueue_tpu_torch.core.guard import GuardConfig, SolverGuard
    from kueue_tpu_torch.utils.clock import FakeClock

    guard = SolverGuard(
        clock=FakeClock(0.0),
        config=GuardConfig(mode="device", divergence_check_every=check_every),
    )
    guard.vias = []
    solve = guard.solve

    def logged(snapshot, lowered, dispatch):
        out = solve(snapshot, lowered, dispatch)
        guard.vias.append(out.via)
        return out

    guard.solve = logged
    return guard


def check_strict(guard, label: str) -> None:
    """Every dispatch went via the device, was checked against the
    host mirror, and nothing failed, diverged or was contained."""
    n = len(guard.vias)
    if n == 0 or guard.vias != ["device"] * n:
        fail(f"{label}: dispatch paths {guard.vias}")
    if guard.divergence_checks != n:
        fail(f"{label}: {guard.divergence_checks} divergence checks for {n} solves")
    bad = (guard.failovers, guard.breaker.consecutive_failures, guard.divergences,
           guard.contained_cycles)
    if any(bad):
        fail(f"{label}: failovers, breaker failures, divergences, contained cycles = {bad}")


def cycle_launch_bytes(tree, heads, paths, seg_id, phase1, packed) -> dict:
    """Bytes each launch of one cycle solve must move (each input read
    once, each output written once), from that cycle's own data; the
    gathers count distinct (row, cell) pairs."""
    n, fr = tree.nominal.shape
    d1 = paths.shape[1]
    mat = n * fr * 8
    # quota_all: nominal, lending, borrowing_limit, local in; subtree,
    # guaranteed, usage, avail, potential out; the forest's packing
    quota = [9 * mat + forest_bytes(tree)]

    cq = heads.cq_row.cpu().numpy()
    cells = heads.cells.cpu().numpy()
    qty = heads.qty.cpu().numpy()
    valid = heads.valid.cpu().numpy()
    w, k, c = cells.shape
    live = cq >= 0  # pad rows carry no work beyond their cq_row and outputs
    n_live = int(live.sum())
    cand = valid & live[:, None]  # [W, K] the candidates a head has
    need = (cells >= 0) & (qty > 0) & cand[:, :, None]
    rows = np.broadcast_to(np.maximum(cq, 0)[:, None, None], cells.shape)
    pairs = _distinct(rows[need], cells[need], fr)
    # in: every row's cq_row; a live row's K valid flags; a candidate's
    # score and C cell indices, and the quantity of each real cell
    # (cells >= 0); avail, potential, subtree, local and nominal of each
    # distinct (row, cell) pair needed, a live row's parent; out:
    # chosen, borrows, preempt_k of every row
    phase1_b = (4 * w + k * n_live + int(cand.sum()) * (8 + 4 * c)
                + 8 * int((cells[cand] >= 0).sum()) + pairs * 5 * 8
                + 4 * len(np.unique(cq[live])) + w * (4 + k + 4))

    chosen, _, preempt_k = (t.cpu().numpy() for t in phase1)
    p = packed.cpu().numpy()
    eff = np.where(chosen >= 0, chosen, preempt_k)
    walked = np.nonzero(live & (eff >= 0))[0]
    ce_all = cells[walked, eff[walked]]
    qe = qty[walked, eff[walked]]
    ce = np.where(qe > 0, ce_all, -1)
    path_rows = paths.cpu().numpy()[cq[walked]]  # [H, D+1]
    node_rows = np.repeat(path_rows, c, axis=1)
    node_cells = np.where(node_rows >= 0, np.tile(ce, (1, d1)), -1)
    path_pairs = _distinct(node_rows.reshape(-1), node_cells.reshape(-1), fr)
    moved = (p[1, walked] > 0) | (p[3, walked] > 0)
    mrows = np.repeat(path_rows[moved], c, axis=1)
    mcells = np.where(mrows >= 0, np.tile(ce[moved], (1, d1)), -1)
    written = _distinct(mrows.reshape(-1), mcells.reshape(-1), fr)
    leaf = _distinct(np.repeat(cq[walked], c), ce.reshape(-1), fr)
    seg = np.asarray(seg_id)
    n_seg = int(seg.max()) + 1 if (seg >= 0).any() else 0
    # per live head: cq_row, priority, timestamp, chosen, preempt_k,
    # seg_id, the effective candidate's borrow bit, no_reclaim (a pad
    # row: its cq_row); the CSR; per walked head its C cell indices, the
    # quantity of each real cell and its path; subtree, guaranteed,
    # borrowing_limit, usage per path pair, nominal per leaf pair, usage
    # written per moved pair; the packed [5, W] out
    phase2_b = (34 * n_live + 4 * (w - n_live) + 4 * (n_seg + 1)
                + 4 * int((seg >= 0).sum()) + len(walked) * (4 * c + 4 * d1)
                + 8 * int((ce_all >= 0).sum()) + path_pairs * 32 + leaf * 8
                + written * 8 + 40 * w)
    return {"quota_tree": quota, "cycle_phase1": [phase1_b], "cycle_phase2": [phase2_b]}


def cycle_chain(heads, seg_id, phase1, n_segments: int, n_steps: int) -> int:
    """A cycle's chain: the walked heads (a ClusterQueue, an effective
    candidate) of its longest root segment below n_segments, at most
    n_steps (cycle_phase2's); cycle_global drops neither segments nor
    steps, and its chain is the longest root's walked heads."""
    cq = heads.cq_row.cpu().numpy()
    chosen, _, preempt_k = (t.cpu().numpy() for t in phase1)
    walked = (cq >= 0) & ((chosen >= 0) | (preempt_k >= 0))
    seg = np.asarray(seg_id)
    return chain_heads(walked & (seg >= 0) & (seg < n_segments), seg, n_steps)


def sharded_cycle_bytes(tree, heads, paths, phase1, packed) -> int:
    """Bytes B3' (``cycle_global``) must move on one cycle's data, each
    input read once and each output written once: per live head its
    cq_row, priority, timestamp, no_reclaim, chosen, preempt_k and the
    effective candidate's borrow bit (a pad row: cq_row, chosen and
    preempt_k); per walked head its C cell indices, the quantity of
    each real cell and its ancestor path; subtree, guaranteed,
    borrowing_limit and usage of each distinct (path node, cell) pair,
    nominal of each leaf pair, the usage written at each pair a moved
    head touches, and the packed [5, W] rows."""
    _, fr = tree.nominal.shape
    d1 = paths.shape[1]
    cq = heads.cq_row.cpu().numpy()
    cells = heads.cells.cpu().numpy()
    qty = heads.qty.cpu().numpy()
    w, _, c = cells.shape
    live = cq >= 0
    n_live = int(live.sum())
    chosen, _, preempt_k = (t.cpu().numpy() for t in phase1)
    p = packed.cpu().numpy()
    eff = np.where(chosen >= 0, chosen, preempt_k)
    walked = np.nonzero(live & (eff >= 0))[0]
    ce_all = cells[walked, eff[walked]]
    qe = qty[walked, eff[walked]]
    ce = np.where(qe > 0, ce_all, -1)
    path_rows = paths.cpu().numpy()[cq[walked]]
    node_rows = np.repeat(path_rows, c, axis=1)
    node_cells = np.where(node_rows >= 0, np.tile(ce, (1, d1)), -1)
    path_pairs = _distinct(node_rows.reshape(-1), node_cells.reshape(-1), fr)
    moved = (p[1, walked] > 0) | (p[3, walked] > 0)
    mrows = np.repeat(path_rows[moved], c, axis=1)
    mcells = np.where(mrows >= 0, np.tile(ce[moved], (1, d1)), -1)
    written = _distinct(mrows.reshape(-1), mcells.reshape(-1), fr)
    leaf = _distinct(np.repeat(cq[walked], c), ce.reshape(-1), fr)
    return (30 * n_live + 12 * (w - n_live) + len(walked) * (4 * c + 4 * d1)
            + 8 * int((ce_all >= 0).sum()) + path_pairs * 32 + leaf * 8 + written * 8
            + 40 * w)


def drs_bytes(n: int, fr: int, d: int, n_res: int, drs: bool) -> int:
    """Bytes B1' must move: parent, level_mask, subtree, guaranteed,
    borrowing_limit and resource_index in; lendable [N, R] out, or with
    ``drs`` the usage and wl_req [N, FR] and weights in and the share
    and dominant resource out."""
    base = 4 * n + (d + 1) * n + 24 * n * fr + 4 * fr
    if drs:
        return base + 16 * n * fr + 8 * n + 12 * n
    return base + 8 * n * n_res


class TimedLaunches:
    """Times each kernel launch alone on the device (also the check of
    perf.lockstep's interface): before the launch a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues the
    start event, the launch and the end event, so the events bracket
    the launch's device time and no host time. A launch whose start
    event had already run when the host finished enqueuing counts as
    uncovered, and the spin doubles (up to 16 times its start). Keeps
    the device and host ms per kernel, each launch's bytes, the last
    phase-1 outputs (for phase 2's bytes) and every scatter's inputs
    (for the library yardstick)."""

    def __init__(self):
        self.dev_ms, self.host_ms, self.nbytes, self.chain = {}, {}, {}, {}
        self.spin, self.uncovered = SPIN_CYCLES, 0
        self.phase1 = None
        self.scatter_args = []

    def __call__(self, name, kern, plain):
        import torch

        torch.cuda._sleep(self.spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        out = kern()
        host = time.perf_counter() - t0
        end.record()
        if start.query():
            self.uncovered += 1
            self.spin = min(2 * self.spin, 16 * SPIN_CYCLES)
        end.synchronize()
        self.dev_ms.setdefault(name, []).append(start.elapsed_time(end))
        self.host_ms.setdefault(name, []).append(host * 1e3)
        if name == "cycle_phase1":
            self.phase1 = out
        return out

    def add_bytes(self, per_kernel: dict) -> None:
        for name, b in per_kernel.items():
            self.nbytes.setdefault(name, []).extend(b)

    def add_chain(self, name: str, heads: int) -> None:
        self.chain.setdefault(name, []).append(heads)


@contextlib.contextmanager
def timed_cycle_kernels(timer: TimedLaunches):
    """The cycle dispatch and the resident scatter, launch by launch
    through ``timer``, with each launch's bytes."""
    from kueue_tpu_torch.core import solver
    from kueue_tpu_torch.perf import lockstep

    saved = (solver.solve_cycle_segmented_packed, solver.scatter_rows)

    def solve(tree, local, heads, paths, seg_id, n_segments, n_steps):
        packed = lockstep.cycle_solve(
            tree, local, heads, paths, seg_id, n_segments, n_steps, timer
        )
        timer.add_bytes(cycle_launch_bytes(tree, heads, paths, seg_id, timer.phase1, packed))
        timer.add_chain("cycle_phase2", cycle_chain(heads, seg_id, timer.phase1, n_segments,
                                                    n_steps))
        return packed

    def scatter(usage, idx, rows):
        timer.scatter_args.append((usage.clone(), idx, rows))
        lockstep.scatter_step(usage, idx, rows, timer)
        # the delta's distinct rows: an index and a row read, a row
        # written (the padding repeats the first row and adds nothing)
        uniq = int(idx.unique().numel())
        timer.add_bytes({"scatter_rows": [4 * uniq + 16 * uniq * rows.shape[1]]})

    solver.solve_cycle_segmented_packed, solver.scatter_rows = solve, scatter
    try:
        yield
    finally:
        solver.solve_cycle_segmented_packed, solver.scatter_rows = saved


def timing_of(timer: TimedLaunches, name: str, plain_ms: dict) -> dict:
    """One kernel's numbers for the result lines: means over the timed
    launches, the bound from their bytes."""
    nbytes = float(np.mean(timer.nbytes[name]))
    out = {
        "ms": float(np.mean(timer.dev_ms[name])),
        "device_ms_total": float(np.sum(timer.dev_ms[name])),
        "host_ms": float(np.mean(timer.host_ms[name])),
        "plain_ms": float(np.mean(plain_ms[name])),
        "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "timed": len(timer.dev_ms[name]),
    }
    if name in timer.chain:
        heads = float(np.mean(timer.chain[name]))
        out["chain_heads"] = heads
        out["chain_bound_ms"] = heads * TRIPS_PER_HEAD * SMEM["ns"] * 1e-6
    return out


def index_copy_ms(scatters) -> float:
    """ms per call of ``index_copy_``, the one PyTorch call computing
    scatter_rows' function, on each scatter's inputs, every call timed
    alone as the kernels are (the yardstick only), after one warm call."""
    timer = TimedLaunches()
    usage, idx, rows = scatters[0]
    usage.index_copy_(0, idx.long(), rows)
    for usage, idx, rows in scatters:
        idx64 = idx.long()
        timer("index_copy_", lambda: usage.index_copy_(0, idx64, rows), None)
    return float(np.mean(timer.dev_ms["index_copy_"]))


@contextlib.contextmanager
def timed_cycle_phases(spans: dict):
    """Host wall of the cycle's lowering and dispatch (solve and the
    one fetch, which synchronises), per call."""
    from kueue_tpu_torch.core import solver

    saved = (solver.lower_heads, solver.dispatch_lowered)

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spans.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return call

    solver.lower_heads = timed("lowering", saved[0])
    solver.dispatch_lowered = timed("dispatch", saved[1])
    try:
        yield
    finally:
        solver.lower_heads, solver.dispatch_lowered = saved


def cycle_path(device) -> dict:
    """Phase 4 on ``device`` ("cuda"; the CPU only to rehearse the
    harness): returns what the result lines need."""
    import torch

    from kueue_tpu_torch.core.snapshot import take_snapshot as snap_of
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.perf import cases, cycle
    from kueue_tpu_torch.perf.lockstep import (
        CYCLE_KERNELS,
        Lockstep,
        cycle_kernels_through,
    )

    steady = STEADY_CYCLES - cycle.CYCLES

    def headline_run(sched, ccache, label, before=None, after=None):
        """The headline's CYCLE_EXPECT cycles, checked, then its steady
        cycles; ``before``/``after`` wrap each part (context factories)."""
        with (before or contextlib.nullcontext)():
            records = cycle.run_cycles(sched)
        csum = cycle.cycle_summary(records, ccache, snap_of)
        if csum != cycle.CYCLE_EXPECT:
            fail(f"{label}: {csum} != expected {cycle.CYCLE_EXPECT}")
        with (after or contextlib.nullcontext)():
            records += cycle.run_cycles(sched, steady)
        return records, csum

    # 4a. the cycle's kernels in lockstep at the headline (its first
    # cycles' plain ms apart from the steady cycles') and on the small
    # cluster (to quiescence)
    cerrs, cplain, stplain = {}, {}, {}
    t0 = time.perf_counter()
    sched, ccache = cycle.build_headline_scheduler(device=device, guard=strict_guard())
    check = Lockstep(cerrs, label="cycle headline", plain_ms=cplain)
    stcheck = Lockstep(cerrs, label="cycle headline, steady", plain_ms=stplain)
    lock_records, csum = headline_run(
        sched, ccache, "cycle lockstep at the headline",
        lambda: cycle_kernels_through(check), lambda: cycle_kernels_through(stcheck),
    )
    if check.failures or stcheck.failures:
        fail(f"cycle lockstep at the headline: {check.failures + stcheck.failures}")
    check_strict(sched.guard, "cycle lockstep at the headline")
    if stcheck.launches.get("scatter_rows", 0) <= 0:
        fail("the headline's steady cycles made no row scatter")
    print(f"{stamp()} cycle lockstep headline: {len(lock_records)} cycles, launches "
          f"checked {json.dumps(check.launches)} in the first {cycle.CYCLES}, "
          f"{json.dumps(stcheck.launches)} in the steady ones, every one bit-exact "
          f"({time.perf_counter() - t0:.1f} s); admitted {csum['admitted']} then "
          f"{[len(r['admitted']) for r in lock_records[cycle.CYCLES:]]}")

    spec = cases.cycle_spec(SMALL_CYCLE_SEED)
    ssched, smgr, _ = cases.build_scheduler(spec, device=device, guard=strict_guard())
    scheck = Lockstep(cerrs, label="cycle small")
    with cycle_kernels_through(scheck):
        srecords = cycle.run_until_quiet(ssched, smgr, SMALL_CYCLES)
    cpu_sched, cpu_mgr, _ = cases.build_scheduler(spec, device="cpu")
    if scheck.failures or srecords != cycle.run_until_quiet(cpu_sched, cpu_mgr, SMALL_CYCLES):
        fail(f"cycle lockstep on the small cluster: {scheck.failures or 'decisions differ from the CPU'}")
    check_strict(ssched.guard, "cycle lockstep on the small cluster")
    if set(scheck.launches) != set(CYCLE_KERNELS):
        fail(f"the small cycle run checked only {sorted(scheck.launches)}")
    print(f"{stamp()} cycle lockstep small cluster (cycle_spec({SMALL_CYCLE_SEED}), depth "
          f"{ssched._resident_state._tree.max_depth}): {len(srecords)} cycles, launches "
          f"checked {json.dumps(scheck.launches)}, bit-exact, equal to the CPU run")

    # 4b. the main path: the port's Scheduler on cuda, strict guard
    _build.reset_launches()
    sched, ccache = cycle.build_headline_scheduler(device=device, guard=strict_guard())
    records, csum = headline_run(sched, ccache, "headline cycles")
    cycle_launches = _build.launch_counts()
    if records != lock_records:
        fail("the headline cycles on cuda differ from their lockstep run")
    check_strict(sched.guard, "headline cycles")
    rs = sched._resident_state
    print(f"{stamp()} Scheduler on cuda, headline: {json.dumps(csum)}; "
          f"{len(records)} cycles in all, equal to the lockstep run; resolutions "
          f"{[r['resolution'] for r in records]}; every dispatch via the device and "
          f"checked on the host mirror ({sched.guard.divergence_checks}), 0 failures, "
          f"0 divergences; resident uploads {rs.full_uploads}, delta cycles "
          f"{rs.delta_cycles}, rows {rs.delta_rows}; launches {json.dumps(cycle_launches)}")
    _build.reset_launches()
    ssched, smgr, _ = cases.build_scheduler(spec, device=device, guard=strict_guard())
    srecords2 = cycle.run_until_quiet(ssched, smgr, SMALL_CYCLES)
    small_launches = _build.launch_counts()
    if srecords2 != srecords:
        fail("the small cycle run on cuda differs from its lockstep run")
    check_strict(ssched.guard, "small cycles")
    print(f"{stamp()} Scheduler on cuda, small cluster: {len(srecords2)} cycles equal to the CPU "
          f"run; launches {json.dumps(small_launches)}")
    for name in CYCLE_KERNELS:
        if cycle_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the headline cycles")
        if small_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the small cluster's cycles")

    # 4c. timing: every launch alone on the device (quota_tree and the
    # two phases over the first cycles, the scatter over the steady
    # ones), then the walls
    timer, stimer = TimedLaunches(), TimedLaunches()
    sched, ccache = cycle.build_headline_scheduler(device=device, guard=strict_guard(0))
    timed_records, _ = headline_run(
        sched, ccache, "the timed headline cycles",
        lambda: timed_cycle_kernels(timer), lambda: timed_cycle_kernels(stimer),
    )
    if timed_records != lock_records:
        fail("the timed headline cycles changed their decisions")
    library = {"scatter_rows": index_copy_ms(stimer.scatter_args)}
    ctiming = {name: timing_of(timer, name, cplain)
               for name in ("quota_tree", "cycle_phase1", "cycle_phase2")}
    ctiming["scatter_rows"] = timing_of(stimer, "scatter_rows", stplain)
    steady_timing = {name: timing_of(stimer, name, stplain)
                     for name in ("quota_tree", "cycle_phase1", "cycle_phase2")}
    print(f"{stamp()} timed cycle launches: first {cycle.CYCLES} cycles "
          f"{json.dumps({k: len(v) for k, v in timer.dev_ms.items()})}, steady "
          f"{json.dumps({k: len(v) for k, v in stimer.dev_ms.items()})}, "
          f"{timer.uncovered + stimer.uncovered} uncovered; scatter rows "
          f"{[int(a[1].unique().numel()) for a in stimer.scatter_args]}")

    sched, ccache = cycle.build_headline_scheduler(device=device, guard=strict_guard(0))
    spans, totals = {}, []
    with timed_cycle_phases(spans):
        recs = []
        for _ in range(cycle.CYCLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs.append(cycle.cycle_record(sched.schedule()))
            totals.append(time.perf_counter() - t0)
    if cycle.cycle_summary(recs, ccache, snap_of) != cycle.CYCLE_EXPECT:
        fail("the timed headline cycles changed their decisions")
    traces = list(sched.last_traces)
    parts = {
        "total": totals,
        "snapshot": [t.spans["snapshot"] for t in traces],
        "lowering": spans["lowering"],
        "dispatch": spans["dispatch"],
        "nominate_rest": [t.spans["nominate"] - lo - di for t, lo, di in
                          zip(traces, spans["lowering"], spans["dispatch"])],
        "host_apply": [t.spans["admit"] for t in traces],
    }
    cycle_ms = {k: 1e3 * float(np.mean(v)) for k, v in parts.items()}
    cycle_max_ms = 1e3 * float(np.max(totals))
    solve_dev = sum(ctiming[n]["ms"] * m for n, m in
                    (("quota_tree", 1), ("cycle_phase1", 1), ("cycle_phase2", 1)))
    print(f"{stamp()} headline cycle wall, mean of {cycle.CYCLES} cycles (max {cycle_max_ms:.1f} ms): "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in cycle_ms.items())
          + f"; the solve's three launches, each timed alone, {solve_dev:.3f} ms a cycle")
    depth = sched._resident_state._tree.max_depth
    cshapes = {
        "quota_tree": f"headline cycles 1-{cycle.CYCLES}, 1 a cycle (4 recurrences), "
                      f"D={depth}",
        "cycle_phase1": f"headline cycles 1-{cycle.CYCLES}, W=1024 K=8 C=16",
        "cycle_phase2": f"headline cycles 1-{cycle.CYCLES}, W=1024 K=8 C=16 D={depth}",
        "scatter_rows": f"headline cycles {cycle.CYCLES + 1}-{STEADY_CYCLES}, row deltas",
    }
    for name, t in ctiming.items():
        print(f"kernel {name} [{cshapes[name]}]: mean over {t['timed']} launches: "
              f"{t['ms'] * 1e3:.2f} us/launch on the device ({t['device_ms_total']:.3f} ms "
              f"in all), {t['host_ms'] * 1e3:.2f} us/call to enqueue, plain "
              f"{t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us "
              f"({t['bytes']:.0f} B); launches headline {cycle_launches[name]} small "
              f"{small_launches[name]}; max_abs_err {cerrs[name]}"
              + (f"; index_copy_ {library[name] * 1e3:.2f} us/call" if name in library else ""))
    for name, t in steady_timing.items():
        print(f"kernel {name} [headline cycles {cycle.CYCLES + 1}-{STEADY_CYCLES}]: "
              f"{t['ms'] * 1e3:.2f} us/launch over {t['timed']}, plain "
              f"{t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us")

    return {
        "errs": cerrs, "timing": ctiming, "library": library,
        "launches": {"cycle_headline": cycle_launches, "cycle_small": small_launches},
        "cycle_ms": cycle_ms, "cycle_max_ms": cycle_max_ms, "solve_dev": solve_dev,
        "records": lock_records,
    }


# ---- the megaloop and the fair drain --------------------------------------


def boundary_bytes(bd: BoundData, cursor, closing: bool, alive_after, n_stamped: int) -> int:
    """Bytes megaloop_boundary must move in one cycle: per queue its
    cursor, length, alive, stuck and admitted flags; a 4-byte round
    stamp per admission of the cycle; at a boundary the leaf usage read
    and its snapshot written, per queue the snapshot's cursor and stuck
    flag, the new alive, stuck, retries, per-group cursors and budget
    written, and the budget read for each remaining queue; the
    scalars."""
    q, pg = bd.q, bd.p * bd.g
    b = q * 11 + 4 * n_stamped + 24
    if closing:
        remaining = (cursor < bd.qlen) & alive_after
        b += 2 * bd.n * bd.fr * 8 + q * (4 + 1 + 1 + 1 + 4 + 4 * pg + 4)
        b += 4 * int(remaining.sum())
    return b


def drain_chain(bd: BoundData, buf, n_steps: int, segmented: bool = True) -> int:
    """A drain phase 2's chain on one cycle: the nominated heads of its
    longest segment (at most n_steps), or all of them for a global scan."""
    nominated = (buf.is_fit | buf.is_pre).cpu().numpy()
    if not segmented:
        return int(nominated.sum())
    seg = bd.seg_id
    return chain_heads(nominated & (seg >= 0), seg, n_steps)


def fair_bytes(bd: BoundData, cursor, alive, buf, n_res: int) -> int:
    """Bytes drain_fair_phase2 must move in one cycle (each input read
    once, each output written once): per participating head its used
    cells and their quantities (an unused slot costs nothing), cursor, priority, timestamp, ClusterQueue row and
    flags; per distinct node on their paths its usage and subtree rows
    (the borrowed sums), lendable, weight, parent and depth; guaranteed
    and borrowing_limit per distinct (node, cell) pair on the paths;
    nominal per reserving head's leaf pair; usage written per moved
    pair; local read and written per admitted leaf pair; the cell-to-
    resource map, the segments and the admitted flags."""
    fr, d1 = bd.fr, bd.d1
    active = (cursor < bd.qlen) & alive
    is_fit = buf.is_fit.cpu().numpy()
    is_pre = buf.is_pre.cpu().numpy()
    admitted = buf.admitted.cpu().numpy()
    part = np.nonzero(active & (is_fit | is_pre) & (bd.rows >= 0))[0]
    ce = buf.cells_eff.cpu().numpy()
    qe = buf.qty_eff.cpu().numpy()
    ce = np.where(qe > 0, ce, -1)
    pc = ce.shape[1]
    path_nodes = bd.paths[bd.rows[part]]  # [H, D+1]
    nodes = np.unique(path_nodes[path_nodes >= 0])
    node_rows = np.repeat(path_nodes, pc, axis=1)
    node_cells = np.where(node_rows >= 0, np.tile(ce[part], (1, d1)), -1)
    pairs = _distinct(node_rows.reshape(-1), node_cells.reshape(-1), fr)
    adm = np.nonzero(admitted)[0]
    adm_pairs = _distinct(np.repeat(bd.rows[adm], pc), ce[adm].reshape(-1), fr)
    reserve = np.nonzero(is_pre & bd.no_reclaim & active)[0]
    res_pairs = _distinct(np.repeat(bd.rows[reserve], pc), ce[reserve].reshape(-1), fr)
    moved = np.nonzero(admitted | (is_pre & bd.no_reclaim & active))[0]
    mrows = np.repeat(bd.paths[bd.rows[moved]], pc, axis=1)
    mcells = np.where(mrows >= 0, np.tile(ce[moved], (1, d1)), -1)
    moved_pairs = _distinct(mrows.reshape(-1), mcells.reshape(-1), fr)
    per_head = 4 + 8 + 8 + 4 + 4 * d1 + 4 + 5
    per_node = 2 * fr * 8 + 8 * n_res + 8 + 4 + 4
    return (len(part) * per_head + 12 * int((ce[part] >= 0).sum()) + len(nodes) * per_node + pairs * 16 + res_pairs * 8
            + moved_pairs * 8 + adm_pairs * 16 + 4 * fr + 4 * (bd.s + 1) + 4 * bd.q
            + bd.q)


def megaloop_inputs(snap, pending, flavors, dev):
    """One chain launch's plan and device inputs, as
    launch_drain_megaloop builds them."""
    from kueue_tpu_torch._torch import to_device
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.perf import headline

    plan = pd.plan_drain(snap, pending, flavors, max_cells=headline.HEADLINE_MAX_CELLS)
    tree, paths, local, queues = pd._drain_device_inputs(snap, plan, dev)
    cap = to_device(pd._cap_suffix_of(plan), dev, np.int32)
    return dict(snap=snap, pending=list(pending), plan=plan, tree=tree, paths=paths,
                local=local, queues=queues, cap=cap)


def megaloop_log(inp, state):
    """The host-decoded log a megaloop state holds."""
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.ops.megaloop_kernel import pack_megaloop, result_of
    from kueue_tpu_torch.perf import megaloop

    return pd.MegaloopLaunch(
        plan=inp["plan"], queues_np=inp["plan"].queues_np,
        flat_dev=pack_megaloop(result_of(state)),
        usage_shape=tuple(inp["snap"].local_usage.shape),
        start_usage=np.asarray(inp["snap"].local_usage), pending=inp["pending"],
        chunk_cycles=megaloop.CHUNK_CYCLES, max_rounds=megaloop.MAX_ROUNDS,
    ).fetch()


def round_view(out):
    from kueue_tpu_torch.core.pipeline import outcome_signature

    sig = outcome_signature(out)
    sig["undecided"] = sorted((wl.key, cq) for wl, cq in out.undecided)
    sig["final_usage"] = np.asarray(out.final_usage).tolist()
    return sig


def megaloop_path(dev, cache, pending) -> dict:
    """Phase 4: the megaloop chain at the headline (module docstring)."""
    import torch

    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.pipeline import speculative_snapshot
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.ops import megaloop_kernel as ml
    from kueue_tpu_torch.perf import cases, headline, megaloop
    from kueue_tpu_torch.perf.lockstep import MEGALOOP_STEPS, lockstep_megaloop

    ch, mr = megaloop.CHUNK_CYCLES, megaloop.MAX_ROUNDS
    errs, plain = {}, {}

    # 4a. lockstep over the chain's launches, and the small case
    t0 = time.perf_counter()
    inputs, lock_logs = [], []
    s, p = take_snapshot(cache), pending
    while True:
        inp = megaloop_inputs(s, p, cache.flavors, dev)
        _, state, cyc = lockstep_megaloop(
            inp["tree"], inp["local"], inp["queues"], inp["paths"], inp["cap"],
            inp["plan"].n_segments, inp["plan"].n_steps, ch, mr, errs,
            label=f"megaloop launch {len(inputs) + 1}", plain_ms=plain,
        )
        log = megaloop_log(inp, state)
        inputs.append(inp)
        lock_logs.append(log)
        if not log.truncated:
            break
        if len(inputs) >= megaloop.MAX_LAUNCHES:
            fail("the lockstep megaloop chain did not end")
        last = log.rounds[-1]
        s, p = speculative_snapshot(s, last.final_usage), last.undecided
    lsum = megaloop.chain_summary(lock_logs)
    if lsum != megaloop.MEGALOOP_EXPECT:
        fail(f"megaloop lockstep chain {lsum} != expected {megaloop.MEGALOOP_EXPECT}")
    print(f"{stamp()} megaloop lockstep headline (chunk_cycles={ch}, max_rounds={mr}): "
          f"{len(lock_logs)} launches, rounds {lsum['rounds_per_launch']}, "
          f"{lsum['cycles']} cycles, every launch of {sorted(errs)} bit-exact to its plain "
          f"version ({time.perf_counter() - t0:.1f} s)")

    spec = cases.mixed_spec(SMALL_SEED)
    s_cache, s_pending = cases.build_cache(spec)
    sinp = megaloop_inputs(take_snapshot(s_cache), s_pending, s_cache.flavors, dev)
    sp = sinp["plan"]
    # at 56 cycles a round its PendingFlavors queues freeze in the second
    # round, and that round's boundary retires them
    _, s_state, s_cyc = lockstep_megaloop(
        sinp["tree"], sinp["local"], sinp["queues"], sinp["paths"], sinp["cap"],
        sp.n_segments, sp.n_steps, 56, 6, errs, label="megaloop small",
    )
    retired = int((~s_state.alive).sum())
    if retired == 0:
        fail("the small megaloop retired no stuck queue")
    print(f"{stamp()} megaloop lockstep small case (mixed_spec({SMALL_SEED}), 56 x 6): "
          f"{s_cyc} cycles, {int(s_state.round_idx.item())} rounds, {retired} queues "
          f"retired at a boundary, bit-exact")

    # 4b. the main path: the chained launch_drain_megaloop on cuda
    plan_s = []
    real_plan = pd.plan_drain

    def timed_plan(*a, **k):
        t = time.perf_counter()
        out = real_plan(*a, **k)
        plan_s.append(time.perf_counter() - t)
        return out

    _build.reset_launches()
    logs, walls = [], []
    pd.plan_drain = timed_plan
    try:
        s, p = take_snapshot(cache), pending
        while True:
            torch.cuda.synchronize()
            reads = dk.DONE_READS
            t0 = time.perf_counter()
            launch = pd.launch_drain_megaloop(
                s, p, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS,
                chunk_cycles=ch, max_rounds=mr, device="cuda",
            )
            t1 = time.perf_counter()
            syncs = dk.DONE_READS - reads + 1  # the done-flag reads and the fetch
            torch.cuda.synchronize()  # the fetch's wait for the card, timed apart
            tw = time.perf_counter()
            log = launch.fetch()
            t2 = time.perf_counter()
            logs.append(log)
            walls.append({"plan_ms": plan_s[-1] * 1e3,
                          "enqueue_ms": (t1 - t0 - plan_s[-1]) * 1e3,
                          "fetch_ms": (t2 - t1) * 1e3, "fetch_wait_ms": (tw - t1) * 1e3,
                          "fetch_copy_decode_ms": (t2 - tw) * 1e3, "host_syncs": syncs,
                          "rounds": log.n_rounds, "cycles": log.cycles})
            if not log.truncated or len(logs) >= megaloop.MAX_LAUNCHES:
                break
            last = log.rounds[-1]
            s, p = speculative_snapshot(s, last.final_usage), last.undecided
    finally:
        pd.plan_drain = real_plan
    launches = _build.launch_counts()
    summary = megaloop.chain_summary(logs)
    print(f"{stamp()} launch_drain_megaloop chain on cuda: {json.dumps(summary)}; "
          f"launches {json.dumps(launches)}")
    if summary != megaloop.MEGALOOP_EXPECT:
        fail(f"megaloop chain {summary} != expected {megaloop.MEGALOOP_EXPECT}")
    if [[round_view(r) for r in g.rounds] for g in logs] != [
            [round_view(r) for r in g.rounds] for g in lock_logs]:
        fail("the megaloop chain on cuda differs from its lockstep run")
    for name in _build.MEGALOOP_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the megaloop chain")
    for i, w in enumerate(walls):
        print(f"  launch {i + 1}: {w['rounds']} rounds, {w['cycles']} cycles, host syncs "
              f"{w['host_syncs']}; wall {w['plan_ms'] + w['enqueue_ms'] + w['fetch_ms']:.1f} ms"
              f" = plan {w['plan_ms']:.1f} + enqueue {w['enqueue_ms']:.1f} + fetch "
              f"{w['fetch_ms']:.1f} ms (the card's remaining work {w['fetch_wait_ms']:.1f}, "
              f"the copy and the host decode of the rounds "
              f"{w['fetch_copy_decode_ms']:.1f})")

    # 4c. each round equals the serial launch_drain chain on cuda
    rounds = [r for g in logs for r in g.rounds]
    t0 = time.perf_counter()
    serial = megaloop.serial_chain(
        pd.launch_drain, speculative_snapshot, take_snapshot(cache), pending,
        cache.flavors, len(rounds), device="cuda",
    )
    serial_ms = (time.perf_counter() - t0) * 1e3
    if [round_view(r) for r in serial] != [round_view(r) for r in rounds]:
        fail("the megaloop rounds differ from the serial launch_drain chain")
    print(f"{stamp()} serial chain: {len(serial)} launch_drain(max_cycles={ch}) launches on "
          f"cuda equal the megaloop's {len(rounds)} rounds (signature, undecided, final "
          f"usage); its wall {serial_ms:.1f} ms beside the megaloop chain's "
          f"{sum(w['plan_ms'] + w['enqueue_ms'] + w['fetch_ms'] for w in walls):.1f} ms")

    # 4d. every launch of the chain timed alone on the device
    timer = TimedLaunches()
    for inp in inputs:
        plan = inp["plan"]
        ctx = dk.DrainContext.build(
            inp["tree"], inp["queues"], inp["paths"], plan.n_segments, plan.n_steps,
            ch * mr, chunk_cycles=ch, max_rounds=mr,
        )
        bd = BoundData(ctx)
        state = ml.MegaloopState.initial_rounds(inp["local"], inp["queues"], inp["cap"], mr)
        buf = dk.CycleBuffers.empty(inp["local"], inp["queues"])
        while not state.done.item():
            cursor = state.cursor.cpu().numpy()
            alive = state.alive.cpu().numpy()
            rnd = int(state.round_idx.item())
            for name, kern, _ in MEGALOOP_STEPS:
                timer(name, lambda: kern(ctx, state, buf), None)
            per = cycle_bytes(bd, cursor, buf, alive)
            after = state.cursor.cpu().numpy()
            per["megaloop_boundary"] = [boundary_bytes(
                bd, after, int(state.round_idx.item()) != rnd,
                state.alive.cpu().numpy(), int(buf.admitted.sum()))]
            timer.add_bytes(per)
            timer.add_chain("drain_phase2", drain_chain(bd, buf, plan.n_steps))
    timing = {name: timing_of(timer, name, plain) for name in _build.MEGALOOP_KERNELS}
    print(f"{stamp()} timed megaloop chain: "
          f"{json.dumps({k: len(v) for k, v in timer.dev_ms.items()})} launches each timed "
          f"alone, {timer.uncovered} uncovered")
    return {"errs": errs, "timing": timing, "launches": launches, "walls": walls,
            "serial_ms": serial_ms, "summary": summary}


def fair_inputs_of(cache, pending, dev, max_cells):
    """The fair drain's plan (preempt-capable queues routed out) and its
    device inputs, as run_drain(fair_sharing=True) builds them."""
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot

    snap = take_snapshot(cache)
    plan = pd.plan_drain(snap, pending, cache.flavors, max_cells=max_cells)
    pd._route_preempt_capable(snap, plan)
    tree, paths, local, queues = pd._drain_device_inputs(snap, plan, dev)
    return plan, tree, paths, local, queues, pd.fair_inputs(snap, tree.max_depth, dev)


def fair_path(dev, cache, pending) -> dict:
    """Phase 5: the fair-sharing drain at the headline (module docstring)."""
    import torch

    from kueue_tpu_torch.core.drain import run_drain
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import cases, headline
    from kueue_tpu_torch.perf.lockstep import FAIR_STEPS, lockstep

    mc = headline.HEADLINE_MAX_CELLS
    errs, plain = {}, {}

    # 5a. lockstep at the headline and on the depth-3 weighted case
    t0 = time.perf_counter()
    plan, tree, paths, local, queues, fair = fair_inputs_of(cache, pending, dev, mc)
    _, _, cyc = lockstep(tree, local, queues, paths, plan.n_segments, plan.n_steps,
                         plan.max_cycles, errs, label="fair headline", plain_ms=plain,
                         fair=fair)
    if cyc != headline.FAIR_EXPECT["cycles"]:
        fail(f"fair lockstep headline ran {cyc} cycles")
    print(f"{stamp()} fair lockstep headline: {cyc} cycles, every launch of {sorted(errs)} "
          f"bit-exact ({time.perf_counter() - t0:.1f} s)")
    f_cache, f_pending = cases.build_cache(cases.fair_spec(FAIR_SEED))
    fp, ft, fpa, fl, fq, ff = fair_inputs_of(f_cache, f_pending, dev, 4)
    _, _, fcyc = lockstep(ft, fl, fq, fpa, fp.n_segments, fp.n_steps, fp.max_cycles, errs,
                          label="fair small", fair=ff)
    print(f"{stamp()} fair lockstep small case (fair_spec({FAIR_SEED}), D={ft.max_depth}, "
          f"{int((fq.qlen > 0).sum())} queues in the tournament): {fcyc} cycles, bit-exact")

    # 5b. the main path
    _build.reset_launches()
    out = run_drain(take_snapshot(cache), pending, cache.flavors, max_cells=mc,
                    fair_sharing=True, device="cuda")
    launches = _build.launch_counts()
    summary = headline.outcome_summary(out)
    print(f"{stamp()} run_drain(fair_sharing=True) on cuda: {json.dumps(summary)}; "
          f"launches {json.dumps(launches)}")
    if summary != headline.FAIR_EXPECT:
        fail(f"fair drain {summary} != expected {headline.FAIR_EXPECT}")
    for name in _build.FAIR_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the fair drain")
    walls, solves = [], []
    for _ in range(3):
        snap = take_snapshot(cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_drain(snap, pending, cache.flavors, max_cells=mc, fair_sharing=True, device="cuda")
        walls.append(time.perf_counter() - t0)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dk._solve_drain_packed(
            tree, local, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles,
            seg_id=plan.queues_np["seg_id"], fair=fair,
        ).cpu()
        solves.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls)) * 1e3
    solve_ms = float(np.median(solves)) * 1e3
    print(f"{stamp()} fair drain wall (run_drain, lowering included, median of 3): "
          f"{wall_ms:.1f} ms = {wall_ms / cyc:.3f} ms/cycle; solve (inputs on the card, "
          f"{cyc} cycles, one fetch) {solve_ms:.2f} ms = {solve_ms / cyc:.4f} ms/cycle")

    # 5c. every launch timed alone on the device
    ctx = dk.DrainContext.build(tree, queues, paths, plan.n_segments, plan.n_steps,
                                plan.max_cycles, fair=fair)
    bd = BoundData(ctx)
    state = dk.DrainState.initial(local, queues, plan.max_cycles)
    buf = dk.CycleBuffers.empty(local, queues)
    timer = TimedLaunches()
    while not state.done.item():
        cursor = state.cursor.cpu().numpy()
        alive = state.alive.cpu().numpy()
        for name, kern, _ in FAIR_STEPS:
            timer(name, lambda: kern(ctx, state, buf), None)
        per = cycle_bytes(bd, cursor, buf)
        del per["drain_phase2"]
        per["drain_fair_phase2"] = [fair_bytes(bd, cursor, alive, buf, fair.n_res)]
        timer.add_bytes(per)
        timer.add_chain("drain_fair_phase2", drain_chain(bd, buf, plan.n_steps) * bd.d1)
    timing = {name: timing_of(timer, name, plain) for name in _build.FAIR_KERNELS}
    print(f"{stamp()} timed fair drain: "
          f"{json.dumps({k: len(v) for k, v in timer.dev_ms.items()})} launches each timed "
          f"alone, {timer.uncovered} uncovered")
    return {"errs": errs, "timing": timing, "launches": launches, "wall_ms": wall_ms,
            "solve_ms": solve_ms, "cycles": cyc}


# ---- classic preemption: the contended cycle and the contended drain -----


def b8_bytes(p) -> int:
    """Bytes one preempt_search launch must move, from its problem's own
    data (padding rows, cells and candidates excluded): per attempt row
    its real local rows' paths and six [rows, cells] panels, the head's
    row, request and flags, each real candidate's row, flags, priority
    and usage at the real cells; out, a target flag per real candidate
    and the row's fit."""
    paths = p.paths.cpu().numpy()
    cells = (p.need_qty > 0).sum(dim=1).cpu().numpy()
    cands = p.cvalid.sum(dim=1).cpu().numpy()
    rows = (paths[:, :, 0] >= 0).sum(axis=1)
    d1 = paths.shape[2]
    live = p.row_valid.cpu().numpy()
    b = (rows * d1 * 4 + 6 * rows * cells * 8 + 4 + cells * 9 + 11
         + cands * (14 + cells * 8) + cands * 4 + 4)
    return int(b[live].sum())


@contextlib.contextmanager
def timed_preempt_search(timer, spans):
    """kernel B8, each launch through ``timer`` with its bytes, and the
    host wall of each cycle's batched search (lowering, launch, fetch,
    decode) in ``spans['victim_search']``."""
    from kueue_tpu_torch.core import preempt_batch
    from kueue_tpu_torch.ops import preempt_kernel as pk

    saved, saved_bgt = pk.solve_preempt_packed, preempt_batch.batched_get_targets

    def search(p, depth, n_cand):
        out = timer("preempt_search", lambda: saved(p, depth, n_cand), None)
        timer.add_bytes({"preempt_search": [b8_bytes(p)]})
        return out

    def bgt(*a, **k):
        t0 = time.perf_counter()
        out = saved_bgt(*a, **k)
        spans.setdefault("victim_search", []).append(time.perf_counter() - t0)
        return out

    pk.solve_preempt_packed, preempt_batch.batched_get_targets = search, bgt
    try:
        yield
    finally:
        pk.solve_preempt_packed, preempt_batch.batched_get_targets = saved, saved_bgt


def contended_cycle_path(dev) -> dict:
    """Phase 7: the interactive cycle with classic preemption over the
    contended cluster (module docstring)."""
    import torch

    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.perf import contended
    from kueue_tpu_torch.perf.lockstep import (
        PREEMPT_CYCLE_KERNELS,
        Lockstep,
        cycle_kernels_through,
        preempt_search_through,
    )

    def fresh(**kw):
        env = contended.build_contended(np.random.default_rng(contended.SEED))
        return contended.build_scheduler(env, device=dev, **kw), env

    # 7a. every launch of the cycle's kernels and of B8 in lockstep
    errs, plain = {}, {}
    t0 = time.perf_counter()
    check = Lockstep(errs, label="contended cycles", plain_ms=plain)
    sched, env = fresh(use_preempt_solver=True)
    with cycle_kernels_through(check), preempt_search_through(check):
        lock_records = contended.run_cycles(sched, env)
    if check.failures:
        fail(f"contended cycle lockstep: {check.failures}")
    if set(check.launches) != set(PREEMPT_CYCLE_KERNELS):
        fail(f"the contended cycles checked only {sorted(check.launches)}")
    print(f"{stamp()} contended cycle lockstep: {len(lock_records)} cycles, launches checked "
          f"{json.dumps(check.launches)}, every one bit-exact "
          f"({time.perf_counter() - t0:.1f} s)")

    # 7b. the main path: the Scheduler on cuda, batched victim search
    _build.reset_launches()
    sched, env = fresh(use_preempt_solver=True)
    records = contended.run_cycles(sched, env)
    launches = _build.launch_counts()
    summary = contended.cycle_summary(records)
    print(f"{stamp()} contended Scheduler on cuda (use_preempt_solver=True): "
          f"{json.dumps(summary)}; launches {json.dumps(launches)}")
    if summary != contended.CONTENDED_CYCLE_EXPECT:
        fail(f"contended cycles {summary} != expected {contended.CONTENDED_CYCLE_EXPECT}")
    if records != lock_records:
        fail("the contended cycles on cuda differ from their lockstep run")
    if any(r["victim_search"] != ["device"] for r in records if r["preempting"]):
        fail("a preempting head of the contended cycles was not searched on the card")
    for name in PREEMPT_CYCLE_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the contended cycles")

    # 7c. the default gate: its first probe batches
    sched, env = fresh()
    first = contended.run_cycles(sched, env, 1)
    if first[0]["victim_search"] != ["device"] or first[0]["admitted"] != records[0]["admitted"]:
        fail(f"use_preempt_solver=None: the first cycle searched {first[0]['victim_search']}")
    print(f"{stamp()} use_preempt_solver=None: the first cycle's {len(first[0]['preempting'])} "
          f"preempting heads searched on the card, decisions equal")

    # 7d. timing: every B8 launch alone; the cycle's wall split
    timer, spans = TimedLaunches(), {}
    sched, env = fresh(use_preempt_solver=True)
    totals = []
    with timed_preempt_search(timer, spans):
        timed = []
        for _ in range(contended.CYCLE_CYCLES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            timed += contended.run_cycles(sched, env, 1)
            totals.append(time.perf_counter() - t0)
    if contended.cycle_summary(timed) != contended.CONTENDED_CYCLE_EXPECT:
        fail("the timed contended cycles changed their decisions")
    traces = list(sched.last_traces)
    cyc_ms = {
        "total": 1e3 * float(np.mean(totals)),
        "snapshot": 1e3 * float(np.mean([t.spans["snapshot"] for t in traces])),
        "nominate": 1e3 * float(np.mean([t.spans["nominate"] for t in traces])),
        "victim_search": 1e3 * float(np.mean(spans["victim_search"])),
        "admit": 1e3 * float(np.mean([t.spans["admit"] for t in traces])),
    }
    timing = {"preempt_search": timing_of(timer, "preempt_search", plain)}
    t = timing["preempt_search"]
    print(f"{stamp()} contended cycle wall, mean of {contended.CYCLE_CYCLES} cycles: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in cyc_ms.items())
          + f" (victim_search: lowering, B8 and decoding; within nominate)")
    print(f"kernel preempt_search [contended cycles, {t['timed']} launches]: "
          f"{t['ms'] * 1e3:.2f} us/launch on "
          f"the device, {t['host_ms'] * 1e3:.2f} us/call to enqueue, plain "
          f"{t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us ({t['bytes']:.0f} B); "
          f"main-path launches {launches['preempt_search']}, max_abs_err {errs['preempt_search']}")
    return {"errs": errs, "timing": timing, "launches": launches, "cycle_ms": cyc_ms,
            "summary": summary}


def preempt_cycle_bytes(ctx, state_before, buf, state_after) -> dict:
    """Bytes each launch of one preempt drain cycle must move (each
    input read once, each output written once), from the cycle's own
    data: ``state_before`` (host copies of the cursor, the pool and the
    cycle start's flags) and the buffers and state after the cycle. Pads
    (slots without an owner, -1 cells, nodes beyond a segment) cost
    nothing; reads shared by the heads of one segment count once."""
    vic = ctx.preempt.victims
    qs = ctx.queues
    q, l, p, k, c = qs.cells.shape
    g = qs.gidx.shape[-1]
    n, fr = ctx.tree.nominal.shape
    d1 = ctx.tree.max_depth + 1
    pc = p * c
    owner = vic.sowner.cpu().numpy()
    seg_nodes = vic.seg_nodes.cpu().numpy()
    seg_id = qs.seg_id.cpu().numpy()
    sq = np.maximum(seg_id, 0)
    v_real = (owner >= 0).sum(axis=1)  # [S]
    m_real = (seg_nodes >= 0).sum(axis=1)
    pcells = state_before["pcells"]
    cells_real = (pcells >= 0).sum(axis=2)  # [S,V]
    cursor, qlen = state_before["cursor"], qs.qlen.cpu().numpy()
    active = cursor < qlen
    is_fit = buf.is_fit.cpu().numpy()
    is_pre = buf.is_pre.cpu().numpy()
    ce = buf.cells_eff.cpu().numpy()
    qe = buf.qty_eff.cpu().numpy()
    ce = np.where(qe > 0, ce, -1)
    head_cells = (ce >= 0).sum(axis=1)
    rows = qs.cq_rows.cpu().numpy()
    paths = ctx.paths.cpu().numpy()
    elig = buf.elig_same.cpu().numpy()
    psuccess = buf.psuccess.cpu().numpy()
    preempt_ok = buf.preempt_ok.cpu().numpy()
    admitted = buf.admitted.cpu().numpy()
    targets = buf.targets.cpu().numpy()
    ev_now = buf.ev_now.cpu().numpy()
    mat = n * fr * 8
    quota = [6 * mat + forest_bytes(ctx.tree)]

    # nomination: the plain drain's walk (each head's entry, the quota
    # cells it gathers), plus the oracle over the segment's live pool
    act = np.nonzero(active)[0]
    entry = p * k * c * 13 + p * k * 9 + p * k * g * 5
    head_cells_all = qs.cells.cpu().numpy()[np.arange(q), np.minimum(cursor, l - 1)]
    pairs = _distinct(np.repeat(rows[act], p * k * c), head_cells_all[act].reshape(-1), fr)
    oracle = sum(int(v_real[sq[i]]) * 26 + int(cells_real[sq[i]][elig[i]].sum()) * 4 + 7
                 for i in act)
    nominate = (len(act) * (entry + 24 + 4 * p * g) + q * (8 + 5 + 8 * p + 4 * p * g + 13 * pc)
                + pairs * 5 * 8 + oracle + q * fr + int(v_real[sq].sum()))

    # the search: every queue's flags and targets row; per searching
    # queue its head cells, priority and config; per segment with a
    # searching head its panels at the distinct head cells, its pool
    # and its local paths; per searching queue its eligibility and order
    enabled = np.nonzero(active & is_pre)[0]
    search = q * (12 + 3) + int(v_real[sq].sum())
    segs = {}
    for i in enabled:
        segs.setdefault(int(sq[i]), set()).update(int(x) for x in ce[i] if x >= 0)
        search += head_cells[i] * 13 + 30 + int(v_real[sq[i]]) * 5
    for s_, cells_s in segs.items():
        search += int(m_real[s_]) * (len(cells_s) * 6 * 8 + 4 + d1 * 4)
        search += int(v_real[s_]) * 18 + int(cells_real[s_].sum()) * 12

    # phase 2: the segments' leaf rows copied, the eviction record
    # reset; ranking flags; per walked head its row, cells, path,
    # targets and flags; path pairs read (and written where usage
    # moved); the preempters' victims removed at their owners
    phase2 = int(m_real.sum()) * fr * 16 + int(v_real.sum()) * 5 + q * 7
    walked = np.nonzero(is_fit | is_pre)[0]
    pcn = ce.shape[1]
    phase2 += sum(16 + 4 + head_cells[i] * 12 + d1 * 4 + int(v_real[sq[i]]) + 7 for i in walked)
    node_rows = np.repeat(paths[rows[walked]], pcn, axis=1)
    node_cells = np.where(node_rows >= 0, np.tile(ce[walked], (1, d1)), -1)
    phase2 += _distinct(node_rows.reshape(-1), node_cells.reshape(-1), fr) * 40
    vr, vc = [], []
    for i in np.nonzero(preempt_ok)[0]:
        for v in np.nonzero(targets[i])[0]:
            for cell in pcells[sq[i], v]:
                if cell >= 0:
                    o = owner[sq[i], v]
                    phase2 += 12 + 16
                    vr.append(paths[o])
                    vc.append(np.where(paths[o] >= 0, cell, -1))
    if vr:
        phase2 += _distinct(np.concatenate(vr), np.concatenate(vc), fr) * 24

    # motion: per queue its flags, budgets, cursors, status row and
    # per-group cursors; the cycle's evictions (record, owner usage);
    # admissions (stamps, leaf usage, part-B slot fill)
    qlen_sum = int(np.minimum(qlen, l).sum())
    motion = q * (42 + 12 * p * g) + qlen_sum * 4 + int(v_real.sum())
    for s_, v in zip(*np.nonzero(ev_now)):
        motion += 17 + int(cells_real[s_, v]) * 28
    for i in np.nonzero(admitted)[0]:
        motion += 8 * p + 8 + head_cells[i] * 28 + pcells.shape[2] * 12 + 1
    return {
        "quota_tree": quota, "drain_nominate": [nominate],
        "drain_preempt_search": [search], "drain_preempt_phase2": [phase2],
        "drain_preempt_motion": [motion],
    }


def contended_drain_path(dev) -> dict:
    """Phase 8: the drain with classic preemption over the contended
    cluster, and a small depth-3 multi-podset case (module
    docstring)."""
    import torch

    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import cases, contended
    from kueue_tpu_torch.perf.lockstep import PREEMPT_KERNELS, PREEMPT_STEPS, lockstep_preempt

    env = contended.build_contended(np.random.default_rng(contended.SEED))
    width = contended.SEARCH_WIDTH
    schedule = contended.CONTENDED_PANELS["widths"]

    def inputs():
        return pd.preempt_drain_inputs(take_snapshot(env.cache), env.pending,
                                       env.cache.flavors, dev, timestamp_fn=env.ts_fn)

    # 8a. lockstep at every cycle of each tier the main path solves
    errs, plain = {}, {}
    plan, low, tree, paths, local, queues, victims = inputs()
    t0 = time.perf_counter()
    tiers = {}
    for w in schedule:
        _, state, cyc = lockstep_preempt(
            tree, local, queues, victims, paths, plan.n_segments, plan.n_steps,
            plan.max_cycles, w, errs, label=f"contended drain, width {w}", plain_ms=plain,
        )
        tiers[w] = (cyc, bool(state.ovf.item()))
    if tiers[width] != (contended.CONTENDED_EXPECT["cycles"], False) or not tiers[schedule[0]][1]:
        fail(f"contended drain lockstep tiers {tiers}")
    print(f"{stamp()} contended drain lockstep: tiers {json.dumps(tiers)} (cycles, overflowed); "
          f"every launch of {sorted(errs)} bit-exact ({time.perf_counter() - t0:.1f} s)")
    spec = cases.preempt_spec(SMALL_PREEMPT_SEED)
    s_cache, s_pending = cases.build_cache(spec)
    sp, _, st, spa, sl, sq_, sv = pd.preempt_drain_inputs(
        take_snapshot(s_cache), s_pending, s_cache.flavors, dev)
    _, s_state, s_cyc = lockstep_preempt(st, sl, sq_, sv, spa, sp.n_segments, sp.n_steps,
                                         sp.max_cycles, 32, errs, label="preempt small")
    shape = tuple(sp.queues_np["cells"].shape)
    if shape[2] < 2 or st.max_depth != 3 or not bool(s_state.vevicted.any()):
        fail(f"the small preempt case lost its coverage: cells {shape}, D={st.max_depth}")
    print(f"{stamp()} preempt lockstep small case (preempt_spec({SMALL_PREEMPT_SEED})): cells "
          f"{shape} D={st.max_depth}, {s_cyc} cycles, {int(s_state.vevicted.sum())} evictions, "
          f"bit-exact")

    # 8b. the main path: run_drain_preempt on cuda, a fresh tuner
    tuner = pd.PanelTuner()
    _build.reset_launches()
    out = pd.run_drain_preempt(take_snapshot(env.cache), env.pending, env.cache.flavors,
                               timestamp_fn=env.ts_fn, search_width=width, panel_tuner=tuner,
                               device=dev)
    launches = _build.launch_counts()
    summary = contended.drain_summary(out)
    panels = {"widths": list(schedule), "escalations": tuner.escalations,
              "next_narrow": tuner._narrow[width]}
    print(f"{stamp()} run_drain_preempt on cuda: {json.dumps(summary)}; panels "
          f"{json.dumps(panels)}; launches {json.dumps(launches)}")
    if summary != contended.CONTENDED_EXPECT:
        fail(f"contended drain {summary} != expected {contended.CONTENDED_EXPECT}")
    if panels != contended.CONTENDED_PANELS:
        fail(f"contended panel schedule {panels} != {contended.CONTENDED_PANELS}")
    for name in PREEMPT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the contended drain")
    tier_flags, solve_tier = [], dk._solve_drain_preempt_packed

    def spy(*a, **k):
        flat = solve_tier(*a, **k)
        tier_flags.append((k["search_width"], int(flat[-2])))
        return flat

    dk._solve_drain_preempt_packed = spy
    try:
        forced = pd.run_drain_preempt(take_snapshot(env.cache), env.pending,
                                      env.cache.flavors, timestamp_fn=env.ts_fn,
                                      search_width=width, panel_widths=(8, width), device=dev)
    finally:
        dk._solve_drain_preempt_packed = solve_tier
    if tier_flags != [(8, 1), (width, 0)]:
        fail(f"the forced (8, {width}) schedule's tiers (width, overflowed): {tier_flags}")
    if contended.drain_summary(forced) != contended.CONTENDED_EXPECT:
        fail("the forced (8, 64) panel schedule changed the decisions")
    small = [pd.run_drain_preempt(take_snapshot(s_cache), s_pending, s_cache.flavors,
                                  search_width=32, device=d) for d in (dev, "cpu")]
    if [round_view_preempt(o) for o in small[:1]] != [round_view_preempt(o) for o in small[1:]]:
        fail("the small preempt case on cuda differs from the CPU")
    print(f"{stamp()} forced panels (8, {width}): tiers {tier_flags} (width, overflowed), "
          f"the same decisions; the small case on "
          f"cuda equals the CPU ({len(small[0].admitted)} admitted, {len(small[0].preempted)} "
          f"evicted)")

    # 8c. walls: the entry point, its host lowering, the solve per tier
    walls, plans = [], []
    for _ in range(3):
        snap = take_snapshot(env.cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd.run_drain_preempt(snap, env.pending, env.cache.flavors, timestamp_fn=env.ts_fn,
                             search_width=width, panel_tuner=pd.PanelTuner(), device=dev)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        inputs()
        torch.cuda.synchronize()
        plans.append(time.perf_counter() - t0)
    solves = {}
    for w in schedule:
        ts_ = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dk._solve_drain_preempt_packed(
                tree, local, queues, victims, paths, plan.n_segments, plan.n_steps,
                plan.max_cycles, w, seg_id=plan.queues_np["seg_id"]).cpu()
            ts_.append(time.perf_counter() - t0)
        solves[w] = 1e3 * float(np.median(ts_))
    cyc = summary["cycles"]
    wall_ms, plan_ms = 1e3 * float(np.median(walls)), 1e3 * float(np.median(plans))
    print(f"{stamp()} contended drain wall (run_drain_preempt, fresh tuner: tiers "
          f"{list(schedule)}, median of 3): {wall_ms:.1f} ms = {wall_ms / cyc:.3f} ms/cycle "
          f"over {cyc} cycles; host lowering and upload {plan_ms:.1f} ms; solve per tier (inputs "
          f"on the card, one fetch) " + ", ".join(f"{w}: {v:.2f} ms" for w, v in solves.items()))

    # 8d. every launch of both tiers timed alone, bytes from each cycle
    ctx_all = {}
    timer = TimedLaunches()
    for w in schedule:
        ctx = dk.DrainContext.build(
            tree, queues, paths, plan.n_segments, plan.n_steps, plan.max_cycles,
            preempt=dk.PreemptInputs(victims=victims, search_width=w))
        ctx_all[w] = ctx
        state = dk.PreemptState.initial_preempt(local, queues, plan.max_cycles, victims)
        buf = dk.PreemptBuffers.empty_preempt(local, queues, victims)
        while not state.done.item():
            before = {"cursor": state.cursor.cpu().numpy(), "pcells": state.pcells.cpu().numpy()}
            for name, kern, _ in PREEMPT_STEPS:
                timer(name, lambda: kern(ctx, state, buf), None)
            timer.add_bytes(preempt_cycle_bytes(ctx, before, buf, state))
    timing = {name: timing_of(timer, name, plain) for name in PREEMPT_KERNELS}
    print(f"{stamp()} timed contended drain (tiers {list(schedule)}): "
          f"{json.dumps({k: len(v) for k, v in timer.dev_ms.items()})} launches each timed "
          f"alone, {timer.uncovered} uncovered")
    for name, t in timing.items():
        print(f"kernel {name} [contended drain]: mean over {t['timed']} launches: "
              f"{t['ms'] * 1e3:.2f} us/launch on the device ({t['device_ms_total']:.3f} ms in "
              f"all), {t['host_ms'] * 1e3:.2f} us/call to enqueue, plain {t['plain_ms']:.3f} "
              f"ms/call, bound {t['bound_ms'] * 1e3:.4f} us ({t['bytes']:.0f} B); main-path "
              f"launches {launches[name]}, max_abs_err {errs[name]}")
    return {"errs": errs, "timing": timing, "launches": launches, "wall_ms": wall_ms,
            "plan_ms": plan_ms, "solve_ms": solves, "cycles": cyc, "panels": panels,
            "env": env}


# ---- fair-sharing preemption: the fair cycle and the fair-preempt drain ----


def b9_bytes(p, n_cand: int, n_res: int) -> int:
    """Bytes one fair_search launch must move, from its problem's own
    data (padding rows, cells and candidates excluded): per head row its
    real local rows' paths, node tables (weight, parent, depth, flags)
    and four [rows, cells] panels (usage, subtree, guaranteed, borrowing
    limit), the head's row, request and buckets, each real candidate's
    row, flag and usage at the real cells; out, a target flag per real
    candidate and the row's fit."""
    paths = p.paths.cpu().numpy()
    cells = (p.res_of < n_res - 1).sum(dim=1).cpu().numpy()  # the rest are the inert pads
    cands = p.cvalid[:, :n_cand].sum(dim=1).cpu().numpy()
    rows = (paths[:, :, 0] >= 0).sum(axis=1)
    d1 = paths.shape[2]
    live = p.row_valid.cpu().numpy()
    b = (rows * d1 * 4 + rows * 19 + 4 * rows * cells * 8 + 4 + cells * 12 + 1
         + cands * (5 + cells * 8) + cands * 4 + 4)
    return int(b[live].sum())


@contextlib.contextmanager
def timed_fair_search(timer, spans):
    """kernel B9, each launch through ``timer`` with its bytes, and the
    host wall of each cycle's batched fair search (lowering, launches,
    fetch, decode) in ``spans['victim_search']``."""
    from kueue_tpu_torch.core import preempt_batch
    from kueue_tpu_torch.ops import fair_preempt_kernel as fpk

    saved, saved_bgt = fpk.solve_fair_packed, preempt_batch.batched_fair_get_targets

    def search(p, depth, n_cand, n_local, n_res, strategy1, has_second):
        out = timer("fair_search",
                    lambda: saved(p, depth, n_cand, n_local, n_res, strategy1, has_second), None)
        timer.add_bytes({"fair_search": [b9_bytes(p, n_cand, n_res)]})
        return out

    def bgt(*a, **k):
        t0 = time.perf_counter()
        out = saved_bgt(*a, **k)
        spans.setdefault("victim_search", []).append(time.perf_counter() - t0)
        return out

    fpk.solve_fair_packed, preempt_batch.batched_fair_get_targets = search, bgt
    try:
        yield
    finally:
        fpk.solve_fair_packed, preempt_batch.batched_fair_get_targets = saved, saved_bgt


def b9_batch(build, seed, dev, timer, plain):
    """B9 on one batched search lowered from ``build`` (perf/fairpreempt):
    every panel tier held to plain solve_fair, then timed alone. Returns
    (max_abs_err, launches, the lowered (arrays, meta), the batch's
    summary on cuda)."""
    import torch

    from kueue_tpu_torch.core import preempt_batch as pb
    from kueue_tpu_torch.interop import fair_problem
    from kueue_tpu_torch.ops import fair_preempt_kernel as fpk
    from kueue_tpu_torch.perf import fairpreempt as fp

    snap, items, pre = build(np.random.default_rng(seed))
    arrays, meta = pb.lower_fair_preemption(snap, items, pre)
    err = n = 0
    for _, v_dim, padded in pb.fair_tiers(arrays, meta):
        p = fair_problem(padded, dev)
        kw = dict(depth=meta["depth"], n_cand=v_dim, n_local=meta["s"], n_res=meta["r"],
                  strategy1=meta["strategy1"], has_second=meta["has_second"])
        got = fpk.solve_fair_packed(p, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = fpk._pack(fpk.solve_fair(p, **kw))
        torch.cuda.synchronize()
        plain.setdefault("fair_search", []).append((time.perf_counter() - t0) * 1e3)
        err = max(err, int((got.long() - want.long()).abs().max()))
        timer("fair_search", lambda: fpk.solve_fair_packed(p, **kw), None)
        timer.add_bytes({"fair_search": [b9_bytes(p, v_dim, meta["r"])]})
        n += 1
    res = pb.batched_fair_get_targets(snap, items, pre, device=dev)
    return err, n, (arrays, meta), fp.search_summary(items, res, meta)


def b9_tier_schedules(batches, dev, reps: int = 3) -> dict:
    """batched_fair_get_targets' two-tier B9 schedule (a narrow and, when
    a pool overflows it, a full-width launch, each with its own upload
    and fetch) against one full-width launch, on the same lowered
    batches ``[(arrays, meta)]``: the host wall of each schedule (tier
    split, upload, launch, fetch) and the device time of its launches,
    the median of ``reps`` runs a batch, summed over the batches. Fails
    unless both give every head the same targets and fit."""
    import torch

    from kueue_tpu_torch.core import preempt_batch as pb
    from kueue_tpu_torch.core.solver import _bucket
    from kueue_tpu_torch.interop import fair_problem
    from kueue_tpu_torch.ops import fair_preempt_kernel as fpk

    def one_tier(arrays, meta):
        w = arrays["row_valid"].shape[0]
        return [(list(range(w)), meta["v"], pb._pad_rows(arrays, _bucket(w, minimum=8)))]

    def run(arrays, meta, split):
        t0 = time.perf_counter()
        decided, events = {}, []
        for rows, v_dim, padded in split(arrays, meta):
            w_pad = padded["row_valid"].shape[0]
            p = fair_problem(padded, dev)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fpk.solve_fair_packed(p, meta["depth"], v_dim, meta["s"], meta["r"],
                                        meta["strategy1"], meta["has_second"])
            end.record()
            flat = out.cpu().numpy()
            events.append((start, end))
            tmask = flat[: w_pad * v_dim].reshape(w_pad, v_dim)
            for out_i, a_i in enumerate(rows):
                n_c = len(meta["rows"][a_i]["cands"])
                decided[a_i] = (tuple(tmask[out_i, :n_c]), bool(flat[w_pad * v_dim + out_i]))
        wall = time.perf_counter() - t0
        return decided, 1e3 * wall, sum(s_.elapsed_time(e_) for s_, e_ in events), len(events)

    totals = {"two_tier": [0.0, 0.0, 0], "one_tier": [0.0, 0.0, 0]}
    for arrays, meta in batches:
        for label, split in (("two_tier", pb.fair_tiers), ("one_tier", one_tier)):
            runs = [run(arrays, meta, split) for _ in range(reps)]
            if label == "two_tier":
                want = runs[0][0]
            elif runs[0][0] != want:
                fail("one full-width B9 launch decided differently from the two tiers")
            totals[label][0] += float(np.median([r[1] for r in runs]))
            totals[label][1] += float(np.median([r[2] for r in runs]))
            totals[label][2] += runs[0][3]
    return {k: {"wall_ms": v[0], "device_ms": v[1], "launches": v[2]} for k, v in totals.items()}


def fair_cycle_path(dev) -> dict:
    """Phase 9: the fair cycle over fair-preempt-1k (module docstring)."""
    import torch

    from kueue_tpu_torch.core import preempt_batch as pb
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.perf import contended, fairpreempt as fp
    from kueue_tpu_torch.perf.lockstep import (
        Lockstep,
        cycle_kernels_through,
        fair_search_through,
    )

    path_kernels = ("quota_tree", "cycle_phase1", "cycle_phase2", "fair_search")

    def fresh():
        env = fp.build_fair_preempt(fp.N_CQ)
        sched = fp.build_scheduler(env, use_solver=True, use_preempt_solver=True, device=dev)
        return sched, env

    # 9a. every launch of the cycle's kernels and of B9 in lockstep
    errs, plain = {}, {}
    t0 = time.perf_counter()
    check = Lockstep(errs, label="fair cycles", plain_ms=plain)
    sched, env = fresh()
    with cycle_kernels_through(check), fair_search_through(check):
        lock_records = contended.run_cycles(sched, env, fp.CYCLE_CYCLES)
    if check.failures:
        fail(f"fair cycle lockstep: {check.failures}")
    if not set(path_kernels) <= set(check.launches):
        fail(f"the fair cycles checked only {sorted(check.launches)}")
    print(f"{stamp()} fair cycle lockstep: {len(lock_records)} cycles, launches checked "
          f"{json.dumps(check.launches)}, every one bit-exact "
          f"({time.perf_counter() - t0:.1f} s)")

    # 9b. the main path: the fair Scheduler on cuda, batched fair search
    _build.reset_launches()
    sched, env = fresh()
    walls = []
    records = []
    for _ in range(fp.CYCLE_CYCLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        records += contended.run_cycles(sched, env, 1)
        walls.append(time.perf_counter() - t0)
    launches = _build.launch_counts()
    traces = list(sched.last_traces)[-fp.CYCLE_CYCLES:]
    summary = contended.cycle_summary(records)
    print(f"{stamp()} fair Scheduler on cuda (fair_sharing, use_preempt_solver=True): "
          f"{json.dumps(summary)}; launches {json.dumps(launches)}")
    if summary != fp.FAIR_PREEMPT_CYCLE_EXPECT:
        fail(f"fair cycles {summary} != expected {fp.FAIR_PREEMPT_CYCLE_EXPECT}")
    if records != lock_records:
        fail("the fair cycles on cuda differ from their lockstep run")
    if any(r["victim_search"] != ["device"] for r in records if r["preempting"]):
        fail("a preempting head of the fair cycles was not searched on the card")
    for name in path_kernels:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the fair cycles")
    cyc_ms = {
        "total": 1e3 * float(np.mean(walls)),
        "snapshot": 1e3 * float(np.mean([t.spans["snapshot"] for t in traces])),
        "nominate": 1e3 * float(np.mean([t.spans["nominate"] for t in traces])),
        "admit": 1e3 * float(np.mean([t.spans["admit"] for t in traces])),
    }

    # 9c. on to quiescence, every B9 launch timed alone: the admitted and
    # evicted sets equal the fair-preempt drain's
    timer, spans = TimedLaunches(), {}
    admitted = {a[0] for r in records for a in r["admitted"]}
    evicted = {t[0] for r in records for p_ in r["preempting"] for t in p_[2]}
    batches, real_lower = [], pb.lower_fair_preemption

    def capture(*a, **k):
        out = real_lower(*a, **k)
        if out[0] is not None:
            batches.append(out)
        return out

    pb.lower_fair_preemption = capture
    t0 = time.perf_counter()
    try:
        with timed_fair_search(timer, spans):
            more_adm, more_ev, calls = fp.run_to_quiescence(sched, env)
    finally:
        pb.lower_fair_preemption = real_lower
    admitted |= more_adm
    evicted |= more_ev
    quiesce_s = time.perf_counter() - t0
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot

    denv = fp.build_fair_preempt(fp.N_CQ)
    out = pd.run_drain_fair_preempt(take_snapshot(denv.cache), denv.pending, denv.cache.flavors,
                                    timestamp_fn=denv.ts_fn, device=dev)
    if (admitted, evicted) != fp.drain_sets(out):
        fail("the fair cycles run to quiescence differ from the fair-preempt drain's sets")
    print(f"{stamp()} fair cycles to quiescence: {fp.CYCLE_CYCLES + calls} schedule() calls, "
          f"{len(admitted)} admitted, {len(evicted)} evicted, equal to the drain's sets "
          f"({quiesce_s:.1f} s for the last {calls})")

    # 9d. the direct B9 batch at bench.py's fair shape, and at the caps
    berr, bn, bbatch, bsum = b9_batch(fp.build_fair_search, fp.SEARCH_SEED, dev, timer, plain)
    if bsum != fp.FAIR_SEARCH_EXPECT or berr:
        fail(f"the fair search batch on cuda {bsum} (err {berr}) != {fp.FAIR_SEARCH_EXPECT}")
    cerr, cn, (_, cmeta), csum = b9_batch(fp.build_fair_cap, 0, dev, timer, plain)
    if (cmeta["s"], cmeta["cu"]) != (64, 32) or cerr or not csum["with_victims"]:
        fail(f"the cap-shape fair search: S={cmeta['s']} Cu={cmeta['cu']} err {cerr}")
    errs["fair_search"] = max(errs.get("fair_search", 0), berr, cerr)
    print(f"{stamp()} B9 batches on cuda: bench.py's fair stage {json.dumps(bsum)} "
          f"(FAIR_SEARCH_EXPECT); caps S={cmeta['s']} Cu={cmeta['cu']} V={cmeta['v']} "
          f"R={cmeta['r']}: {csum['with_victims']} of {csum['heads']} heads find victims; "
          f"both bit-exact")

    # 9e. timing: B9's launches alone (the quiescence run's, then the two
    # batches'), the fair cycle's wall split
    main_n = len(timer.dev_ms["fair_search"]) - bn - cn
    t_main = {k: v[:main_n] for k, v in timer.dev_ms.items()}
    timing = {"fair_search": timing_of(timer, "fair_search", plain)}
    main_ms = float(np.mean(t_main["fair_search"]))
    main_bytes = float(np.mean(timer.nbytes["fair_search"][:main_n]))
    timing["fair_search"].update(ms=main_ms, bytes=main_bytes,
                                 bound_ms=main_bytes / HBM_BYTES_PER_S * 1e3, timed=main_n)
    bench_ms = timer.dev_ms["fair_search"][main_n:main_n + bn]
    cap_ms = timer.dev_ms["fair_search"][main_n + bn:]
    t = timing["fair_search"]
    print(f"{stamp()} fair cycle wall, mean of {fp.CYCLE_CYCLES} cycles: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in cyc_ms.items())
          + f"; victim_search {1e3 * float(np.mean(spans['victim_search'])):.2f} ms/cycle "
          f"over the quiescence run (lowering, B9 and decoding; within nominate)")
    print(f"kernel fair_search [fair cycles to quiescence, {t['timed']} launches]: "
          f"{t['ms'] * 1e3:.2f} us/launch on the device, plain {t['plain_ms']:.3f} ms/call, "
          f"bound {t['bound_ms'] * 1e3:.4f} us ({t['bytes']:.0f} B); bench.py's fair batch "
          f"{float(np.mean(bench_ms)) * 1e3:.2f} us, caps {float(np.mean(cap_ms)) * 1e3:.2f} us; "
          f"main-path launches {launches['fair_search']}, max_abs_err {errs['fair_search']}")
    tiers = {"fair-preempt-1k": b9_tier_schedules(batches, dev),
             "bench_fair": b9_tier_schedules([bbatch], dev)}
    for label, t in tiers.items():
        print(f"{stamp()} B9 schedules [{label}, {len(batches) if label != 'bench_fair' else 1} "
              f"batches, median of 3 each, summed]: two tiers "
              f"{t['two_tier']['launches']} launches, {t['two_tier']['wall_ms']:.3f} ms host "
              f"wall (split, upload, launch, fetch), {t['two_tier']['device_ms']:.3f} ms on the "
              f"device; one full-width tier {t['one_tier']['launches']} launches, "
              f"{t['one_tier']['wall_ms']:.3f} ms wall, {t['one_tier']['device_ms']:.3f} ms on "
              f"the device; same decisions")
    return {"errs": errs, "timing": timing, "launches": launches, "cycle_ms": cyc_ms,
            "tiers": tiers,
            "summary": summary, "quiescence_calls": fp.CYCLE_CYCLES + calls,
            "bench_batch_us": 1e3 * float(np.mean(bench_ms)),
            "cap_batch_us": 1e3 * float(np.mean(cap_ms))}


def fair_preempt_cycle_bytes(ctx, state_before, buf, state_after) -> dict:
    """Bytes each launch of one fair-preempt drain cycle must move, from
    the cycle's own data, as ``preempt_cycle_bytes`` counts them: the
    usage tree, nomination and motion as there (the motion plus each
    filled slot's fair-panel row); the search per searching queue over
    its segment's panels at the active cell universe; phase 2 over its
    participants' paths and the victims it moves. Pads cost nothing;
    reads shared by the heads of one segment count once."""
    base = preempt_cycle_bytes(ctx, state_before, buf, state_after)
    vic, pan = ctx.preempt.victims, ctx.fair_preempt.panels
    qs = ctx.queues
    q, l, p, k, c = qs.cells.shape
    n, fr = ctx.tree.nominal.shape
    d1 = ctx.tree.max_depth + 1
    n_res = ctx.fair.n_res
    owner = vic.sowner.cpu().numpy()
    seg_nodes = vic.seg_nodes.cpu().numpy()
    sq = np.maximum(qs.seg_id.cpu().numpy(), 0)
    v_real = (owner >= 0).sum(axis=1)
    m_real = (seg_nodes >= 0).sum(axis=1)
    cu_real = (pan.seg_cells.cpu().numpy() >= 0).sum(axis=1)
    pcells = state_before["pcells"]
    cells_real = (pcells >= 0).sum(axis=2)
    cursor, qlen = state_before["cursor"], qs.qlen.cpu().numpy()
    active = cursor < qlen
    is_fit = buf.is_fit.cpu().numpy()
    is_pre = buf.is_pre.cpu().numpy()
    ce = buf.cells_eff.cpu().numpy()
    qe = buf.qty_eff.cpu().numpy()
    ce = np.where(qe > 0, ce, -1)
    head_cells = (ce >= 0).sum(axis=1)
    rows = qs.cq_rows.cpu().numpy()
    paths = ctx.paths.cpu().numpy()
    psuccess = buf.psuccess.cpu().numpy()
    targets = buf.targets.cpu().numpy()
    ev_now = buf.ev_now.cpu().numpy()
    admitted = buf.admitted.cpu().numpy()

    # the search: every queue's flags and targets row; per searching
    # queue its head cells, priority, config, eligibility and order; per
    # segment with a searching head its four panels over the universe,
    # its node tables and paths, its pool and the pool's panel rows
    enabled = np.nonzero(active & is_pre)[0]
    search = q * (12 + 3) + int(v_real[sq].sum())
    segs = set()
    for i in enabled:
        segs.add(int(sq[i]))
        search += head_cells[i] * 13 + 30 + int(v_real[sq[i]]) * 9
    for s_ in segs:
        m, cu = int(m_real[s_]), int(cu_real[s_])
        search += m * (cu * 4 * 8 + 18 + d1 * 4) + cu * 8
        search += int(v_real[s_]) * (18 + cu * 8) + int(cells_real[s_].sum()) * 12

    # phase 2: the segments' leaf rows copied, the eviction record
    # reset; per participant its keys, cells, path and targets; per
    # distinct node on a participant's path its FR usage and subtree
    # (the chains), guaranteed, limits, lendable and tree fields; the
    # victims moved for the fit checks; the decisions written
    part = np.nonzero(active & (is_fit | is_pre) & (rows >= 0))[0]
    phase2 = int(m_real.sum()) * fr * 16 + int(v_real.sum()) * 5
    phase2 += sum(40 + head_cells[i] * 12 + d1 * 4 + int(psuccess[i]) * int(v_real[sq[i]])
                  for i in part)
    nodes = np.unique(paths[rows[part]][paths[rows[part]] >= 0]) if len(part) else []
    phase2 += len(nodes) * (fr * 36 + n_res * 8 + 16)
    moved = {(int(s_), int(v)) for s_, v in zip(*np.nonzero(ev_now))}
    moved |= {(int(sq[i]), int(v)) for i in part if psuccess[i]
              for v in np.nonzero(targets[i])[0]}
    phase2 += sum(4 + int(cells_real[s_, v]) * 12 for s_, v in moved)
    phase2 += len(part) * 2 + int(ev_now.sum()) * 5

    motion = base["drain_preempt_motion"][0]
    for i in np.nonzero(admitted)[0]:
        motion += int(cu_real[sq[i]]) * 12
    return {
        "quota_tree": base["quota_tree"], "drain_nominate": base["drain_nominate"],
        "drain_fair_preempt_search": [search], "drain_fair_preempt_phase2": [phase2],
        "drain_preempt_motion": [motion],
    }


def fair_preempt_drain_path(dev) -> dict:
    """Phase 10: the fair-preempt drain over fair-preempt-1k, bench.py's
    60-CQ stage and a small depth-3 case (module docstring)."""
    import torch

    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.perf import cases, fairpreempt as fp
    from kueue_tpu_torch.perf.lockstep import (
        FAIR_PREEMPT_KERNELS,
        FAIR_PREEMPT_STEPS,
        lockstep_fair_preempt,
    )

    env = fp.build_fair_preempt(fp.N_CQ)

    def inputs(e=env, **kw):
        return pd.fair_preempt_drain_inputs(take_snapshot(e.cache), e.pending, e.cache.flavors,
                                            dev, timestamp_fn=e.ts_fn, **kw)

    def drain_args(inp):
        plan, _, tree, paths, local, queues, victims, panels, fair = inp
        return (tree, local, queues, victims, panels, paths, fair, plan.n_segments,
                plan.n_steps, plan.max_cycles, 0, True)

    # 10a. lockstep at every cycle of fair-preempt-1k and of the small case
    errs, plain = {}, {}
    inp = inputs()
    t0 = time.perf_counter()
    _, state, cyc = lockstep_fair_preempt(*drain_args(inp), errs, label="fair-preempt-1k",
                                          plain_ms=plain)
    if cyc != fp.FAIR_PREEMPT_EXPECT["cycles"]:
        fail(f"fair-preempt-1k lockstep ran {cyc} cycles")
    print(f"{stamp()} fair-preempt drain lockstep: {cyc} cycles, "
          f"{int(state.vevicted.sum())} evictions; every launch of {sorted(errs)} bit-exact "
          f"({time.perf_counter() - t0:.1f} s)")
    spec = cases.fair_preempt_spec(SMALL_FAIR_PREEMPT_SEED)
    s_cache, s_pending = cases.build_cache(spec)
    s_inp = pd.fair_preempt_drain_inputs(take_snapshot(s_cache), s_pending, s_cache.flavors, dev,
                                         max_cycles=SMALL_FAIR_PREEMPT_CYCLES)
    _, s_state, s_cyc = lockstep_fair_preempt(*drain_args(s_inp), errs, label="fair-preempt small")
    shape = tuple(s_inp[0].queues_np["cells"].shape)
    if s_inp[2].max_depth != 3 or not bool(s_state.vevicted.any()):
        fail(f"the small fair-preempt case lost its coverage: cells {shape}")
    print(f"{stamp()} fair-preempt lockstep small case (fair_preempt_spec("
          f"{SMALL_FAIR_PREEMPT_SEED}), {SMALL_FAIR_PREEMPT_CYCLES} cycles): cells {shape} "
          f"D={s_inp[2].max_depth} M={s_inp[6].seg_nodes.shape[1]} "
          f"Cu={s_inp[7].seg_cells.shape[1]}, {int(s_state.vevicted.sum())} evictions, bit-exact")
    wenv = fp.build_fair_wide(np.random.default_rng(fp.WIDE_SEED))
    w_inp = inputs(wenv)
    w_plain = {}
    t0 = time.perf_counter()
    _, w_state, w_cyc = lockstep_fair_preempt(*drain_args(w_inp), errs, label="fair-preempt wide",
                                              plain_ms=w_plain)
    w_shape = (f"Q={w_inp[0].queues_np['cells'].shape[0]} D={w_inp[2].max_depth} "
               f"M={w_inp[6].seg_nodes.shape[1]} Cu={w_inp[7].seg_cells.shape[1]} "
               f"V={w_inp[6].sowner.shape[1]} R={w_inp[8].n_res}")
    if w_cyc != fp.FAIR_WIDE_EXPECT["cycles"]:
        fail(f"the wide fair-preempt lockstep ran {w_cyc} cycles")
    print(f"{stamp()} fair-preempt lockstep at the panel caps (build_fair_wide, {w_shape}): "
          f"{w_cyc} cycles, {int(w_state.vevicted.sum())} evictions, bit-exact "
          f"({time.perf_counter() - t0:.1f} s)")

    # 10b. the main path: run_drain_fair_preempt on cuda
    _build.reset_launches()
    out = pd.run_drain_fair_preempt(take_snapshot(env.cache), env.pending, env.cache.flavors,
                                    timestamp_fn=env.ts_fn, device=dev)
    launches = _build.launch_counts()
    summary = fp.drain_summary(out)
    print(f"{stamp()} run_drain_fair_preempt on cuda: {json.dumps(summary)}; "
          f"launches {json.dumps(launches)}")
    if summary != fp.FAIR_PREEMPT_EXPECT:
        fail(f"fair-preempt drain {summary} != expected {fp.FAIR_PREEMPT_EXPECT}")
    for name in FAIR_PREEMPT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the fair-preempt drain")
    senv = fp.build_fair_preempt(fp.SMALL_N_CQ)
    small = pd.run_drain_fair_preempt(take_snapshot(senv.cache), senv.pending,
                                      senv.cache.flavors, timestamp_fn=senv.ts_fn, device=dev)
    if fp.drain_summary(small) != fp.FAIR_PREEMPT_SMALL_EXPECT:
        fail(f"bench.py's 60-CQ stage on cuda {fp.drain_summary(small)}")
    spec_runs = [pd.run_drain_fair_preempt(take_snapshot(s_cache), s_pending, s_cache.flavors,
                                           max_cycles=SMALL_FAIR_PREEMPT_CYCLES, device=d)
                 for d in (dev, "cpu")]
    if round_view_preempt(spec_runs[0]) != round_view_preempt(spec_runs[1]):
        fail("the small fair-preempt case on cuda differs from the CPU")
    print(f"{stamp()} bench.py's 60-CQ stage on cuda gives FAIR_PREEMPT_SMALL_EXPECT; the "
          f"small case on cuda equals the CPU ({len(spec_runs[0].admitted)} admitted, "
          f"{len(spec_runs[0].preempted)} evicted)")
    _build.reset_launches()
    wide = pd.run_drain_fair_preempt(take_snapshot(wenv.cache), wenv.pending, wenv.cache.flavors,
                                     timestamp_fn=wenv.ts_fn, device=dev)
    w_launches = _build.launch_counts()
    w_summary = fp.drain_summary(wide)
    print(f"{stamp()} run_drain_fair_preempt on cuda at the panel caps: {json.dumps(w_summary)}; "
          f"launches {json.dumps(w_launches)}")
    if w_summary != fp.FAIR_WIDE_EXPECT:
        fail(f"the wide fair-preempt drain {w_summary} != expected {fp.FAIR_WIDE_EXPECT}")
    for name in FAIR_PREEMPT_KERNELS:
        if w_launches[name] <= 0:
            fail(f"kernel {name} was not launched by the wide fair-preempt drain")

    # 10c. walls: the entry point, its host lowering, the solve
    walls, plans, solves = [], [], []
    for _ in range(3):
        snap = take_snapshot(env.cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd.run_drain_fair_preempt(snap, env.pending, env.cache.flavors, timestamp_fn=env.ts_fn,
                                  device=dev)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        inputs()
        torch.cuda.synchronize()
        plans.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dk._solve_drain_fair_preempt_packed(*drain_args(inp),
                                            seg_id=inp[0].queues_np["seg_id"]).cpu()
        solves.append(time.perf_counter() - t0)
    cyc = summary["cycles"]
    wall_ms, plan_ms = 1e3 * float(np.median(walls)), 1e3 * float(np.median(plans))
    solve_ms = 1e3 * float(np.median(solves))
    print(f"{stamp()} fair-preempt drain wall (run_drain_fair_preempt, median of 3): "
          f"{wall_ms:.1f} ms = {wall_ms / cyc:.3f} ms/cycle over {cyc} cycles; host lowering "
          f"and upload {plan_ms:.1f} ms; solve (inputs on the card, one fetch) {solve_ms:.2f} ms")

    # 10d. every launch timed alone, bytes from each cycle: fair-preempt-1k
    # (the kernels' line) and the drain at the panel caps
    def timed(inp, plain_ms, label, main_launches):
        plan, _, tree, paths, local, queues, victims, panels, fair = inp
        ctx = dk.fair_preempt_context(tree, queues, victims, panels, paths, fair,
                                      plan.n_segments, plan.n_steps, plan.max_cycles, 0, True)
        state = dk.FairPreemptState.initial_fair(local, queues, plan.max_cycles, victims, panels)
        buf = dk.PreemptBuffers.empty_preempt(local, queues, victims)
        timer = TimedLaunches()
        while not state.done.item():
            before = {"cursor": state.cursor.cpu().numpy(), "pcells": state.pcells.cpu().numpy()}
            for name, kern, _ in FAIR_PREEMPT_STEPS:
                timer(name, lambda: kern(ctx, state, buf), None)
            timer.add_bytes(fair_preempt_cycle_bytes(ctx, before, buf, state))
        timing = {name: timing_of(timer, name, plain_ms) for name in FAIR_PREEMPT_KERNELS}
        print(f"{stamp()} timed fair-preempt drain [{label}]: "
              f"{json.dumps({k: len(v) for k, v in timer.dev_ms.items()})} launches each timed "
              f"alone, {timer.uncovered} uncovered")
        for name, t in timing.items():
            print(f"kernel {name} [fair-preempt drain, {label}]: mean over {t['timed']} "
                  f"launches: {t['ms'] * 1e3:.2f} us/launch on the device "
                  f"({t['device_ms_total']:.3f} ms in all), {t['host_ms'] * 1e3:.2f} us/call to "
                  f"enqueue, plain {t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us "
                  f"({t['bytes']:.0f} B); main-path launches {main_launches[name]}, "
                  f"max_abs_err {errs[name]}")
        return timing

    timing = timed(inp, plain, "fair-preempt-1k", launches)
    w_timing = timed(w_inp, w_plain, f"panel caps, {w_shape}", w_launches)
    return {"errs": errs, "timing": timing, "launches": launches, "wall_ms": wall_ms,
            "plan_ms": plan_ms, "solve_ms": solve_ms, "cycles": cyc,
            "wide_timing": w_timing, "wide_launches": w_launches, "wide_shape": w_shape,
            "env": env}


def round_view_preempt(out):
    return (sorted((wl.name, repr(sorted(f.items())), c) for wl, _, f, c in out.admitted),
            sorted(wl.name for wl, _ in out.parked), sorted(wl.name for wl, _ in out.fallback),
            sorted((e.victim.name, e.cycle, e.by_cq, e.reason) for e in out.evictions),
            out.cycles, out.truncated)


# ---- Topology-Aware Scheduling: TAS pod counting and the TAS drain --------


def b12_batch(snap, dev, rng, b: int):
    """A B12 batch on ``snap``'s leaves (both packages' semantics): ``b``
    per-pod requests drawn from tas-drain-10k's (1-2 cpu, one pod), each
    row's assumed usage nonzero on a few leaves, one simulate_empty row
    and one row with a taint-masked leaf set."""
    from kueue_tpu_torch._torch import to_device

    snap.freeze()
    n_l, n_r = len(snap._leaf_order), len(snap._resources)
    r_cpu, r_pods = snap._resources.index("cpu"), snap._resources.index("pods")
    req = np.zeros((b, n_r), dtype=np.int64)
    req[:, r_cpu] = rng.integers(1, 3, b) * 1000
    req[:, r_pods] = 1
    assumed = np.zeros((b, n_l, n_r), dtype=np.int64)
    for i in range(b):
        leaves = rng.integers(0, n_l, 8)
        assumed[i, leaves, r_cpu] = rng.integers(1, 9, 8) * 1000
        assumed[i, leaves, r_pods] = rng.integers(1, 9, 8)
    taint_ok = np.ones((b, n_l), dtype=bool)
    taint_ok[min(1, b - 1), rng.integers(0, n_l, max(1, n_l // 16))] = False
    sim = np.zeros(b, dtype=bool)
    sim[-1] = True
    return [to_device(a, dev, t) for a, t in ((req, np.int64), (assumed, np.int64),
                                              (taint_ok, np.bool_), (sim, np.bool_))]


def b12_bytes(topo, req, sim, levels: bool) -> int:
    """Bytes B12 must move on this batch: leaf_counts reads req, the
    taint and simulate_empty flags, free (read once) of each resource
    some row requests, usage (read once) of each resource some row
    without simulate_empty requests, each row's assumed usage of the
    resources it requests, and writes the counts; level_counts reads
    the counts and the segment ids and writes every level's totals."""
    n_l, n_r = topo.free.shape
    b = req.shape[0]
    if levels:
        return b * n_l * 8 + len(topo.n_domains) * n_l * 4 + b * sum(topo.n_domains) * 8
    asked = req.cpu().numpy() > 0
    sim = sim.cpu().numpy()
    free_cols = int(asked.any(axis=0).sum())
    usage_cols = int(asked[~sim].any(axis=0).sum())
    return ((free_cols + usage_cols) * n_l * 8 + int(asked.sum()) * n_l * 8
            + b * n_r * 8 + b * n_l + b + b * n_l * 8)


def index_add_ms(topo, counts) -> float:
    """ms of ``index_add_``, the one PyTorch call computing level_counts'
    function (the yardstick only): one call a level after a warm one,
    each timed alone as the kernels are, summed over the levels."""
    import torch

    timer = TimedLaunches()
    for d, nd in enumerate(topo.n_domains):
        seg = topo.seg_ids[d].long()
        dst = torch.zeros((counts.shape[0], nd), dtype=counts.dtype, device=counts.device)
        dst.index_add_(1, seg, counts)
        timer(f"index_add_{d}", lambda: dst.index_add_(1, seg, counts), None)
    return float(sum(v[0] for v in timer.dev_ms.values()))


def tas_cycle_bytes(bd: BoundData, ctx, cursor, buf, tas_before, tas_after) -> dict:
    """Bytes each TAS cycle kernel must move, from the cycle's own data
    (``cycle_bytes`` for quota_tree, drain_nominate and the motion; the
    placement and the global scan counted here)."""
    base = cycle_bytes(bd, cursor, buf)
    tas = ctx.tas
    th = tas.heads
    lf, rt = tas.topo_free.shape
    d_t = len(tas.n_domains)
    nd = th.parent_map.shape[1]
    active = cursor < bd.qlen
    t_is = th.t_is.cpu().numpy()
    heads = active & t_is
    n_heads = int(heads.sum())
    q = bd.q
    # placement: the forest (free and usage of the leaves read once, the
    # segment ids, the parent map, the leaf flavors), each head's entry
    # (request, count, level, mode, top, flavor); every queue's cursor,
    # length, TAS and t_bad flags and the three flags it rewrites, and
    # its taken row and placement flag written
    place = (2 * lf * rt * 8 + d_t * lf * 4 + d_t * nd * 4 + lf * 4 + d_t * 4
             + n_heads * (rt * 8 + 4 * 5)
             + q * (4 + 4 + 1 + 1 + 3 + 3) + q * (lf * 8 + 1))
    # the global scan: the quota walk as phase 2 counts it; for each
    # walked TAS head its taken row and request, the leaves' free
    # capacity and usage read once; the leaf usage written where an
    # admitted head charged it; adm_step of the admitted
    nominated = (buf.is_fit | buf.is_pre).cpu().numpy() & active
    walked_tas = np.nonzero(nominated & t_is)[0]
    admitted = buf.admitted.cpu().numpy()
    changed = int((tas_after != tas_before).any(axis=1).sum())
    scan = (base["drain_phase2"][0] + len(walked_tas) * (lf * 8 + rt * 8)
            + 2 * lf * rt * 8 + changed * rt * 8 + int(admitted.sum()) * 4)
    return {
        "quota_tree": base["quota_tree"],
        "drain_nominate": base["drain_nominate"],
        "drain_tas_place": [place],
        "drain_tas_phase2": [scan],
        "drain_queue_motion": base["drain_queue_motion"],
    }


def tas_path(dev) -> dict:
    """Phase 11: TAS pod counting (B12) at tas-placement-1k and
    tas-fleet-131k, and the TAS drain (B13) at tas-drain-10k and the
    small two-flavor case (module docstring)."""
    import torch

    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import drain_kernel as dk
    from kueue_tpu_torch.ops import tas_kernel as tk
    from kueue_tpu_torch.perf import cases, tas as pt
    from kueue_tpu_torch.perf.lockstep import (
        TAS_DRAIN_KERNELS,
        TAS_STEPS,
        Lockstep,
        leaf_counts_step,
        lockstep_tas,
    )
    from kueue_tpu_torch.tas.snapshot import TASFlavorSnapshot

    errs = {}
    rng = np.random.default_rng(pt.TAS_DRAIN_SEED)

    # 11a. B12 lockstep: tas-placement-1k with a batch of 16 of
    # tas-drain-10k's per-pod requests; tas-fleet-131k with such a batch
    # of 3 (a plain row, a taint-masked one, a simulate_empty one) and
    # with the main path's own input, recorded from a warm call of
    # find_topology_assignments (11b's counted run comes after). The
    # 1k batch and the fleet's main-path input are then timed alone,
    # each entry five times, its plain version three times.
    t0 = time.perf_counter()
    flavors = {label: pt.build_placement(shape) for label, shape in
               (("tas-placement-1k", pt.PLACEMENT_SHAPE), ("tas-fleet-131k", pt.FLEET_SHAPE))}
    print(f"{stamp()} TAS placement flavors built ({time.perf_counter() - t0:.1f} s)")
    fc, req = flavors["tas-fleet-131k"]
    recorded, launch = [], tk.leaf_counts

    def record(topo, *batch):
        recorded.append((topo, [x.clone() for x in batch]))
        return launch(topo, *batch)

    tk.leaf_counts = record
    try:
        fc.snapshot(dev).find_topology_assignments([req])
    finally:
        tk.leaf_counts = launch
    if len(recorded) != 1:
        fail(f"find_topology_assignments at tas-fleet-131k called leaf_counts "
             f"{len(recorded)} times, not once")
    cases_b12 = []
    for label, b in (("tas-placement-1k", 16), ("tas-fleet-131k", 3)):
        fcl, _ = flavors[label]
        topo = tk.topology_from_snapshot(fcl.snapshot(dev), dev)
        cases_b12.append((label, topo, b12_batch(fcl.snapshot(dev), dev, rng, b),
                          label == "tas-placement-1k"))
    cases_b12.append(("tas-fleet-131k", *recorded[0], True))
    b12 = {}
    for label, topo, batch, timed_here in cases_b12:
        counts, _ = leaf_counts_step(topo, *batch, Lockstep(errs, f"B12 {label}"))
        shape = (f"L={topo.free.shape[0]} R={topo.free.shape[1]} B={batch[0].shape[0]} "
                 f"n_domains={topo.n_domains}")
        if not timed_here:
            print(f"{stamp()} B12 lockstep at {label} ({shape}, a plain, a taint-masked and a "
                  f"simulate_empty row): leaf_counts and level_counts bit-exact")
            continue
        entries = {
            "leaf_counts": (lambda: tk.leaf_counts(topo, *batch),
                            lambda: tk.leaf_counts_plain(topo, *batch),
                            b12_bytes(topo, batch[0], batch[3], False)),
            "level_counts": (lambda: tk.level_counts(topo, counts),
                             lambda: tk.level_counts_plain(topo, counts),
                             b12_bytes(topo, batch[0], batch[3], True)),
        }
        timer, plain_b12 = TimedLaunches(), {}
        for name, (kern, plain_fn, nbytes) in entries.items():
            for _ in range(5):
                timer(name, kern, None)
                timer.add_bytes({name: [nbytes]})
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                plain_fn()
                torch.cuda.synchronize()
                plain_b12.setdefault(name, []).append((time.perf_counter() - t1) * 1e3)
        b12[label] = {name: timing_of(timer, name, plain_b12) for name in entries}
        b12[label]["level_counts"]["library_ms"] = index_add_ms(topo, counts)
        if label == "tas-fleet-131k":
            shape += ", the main path's input"
        b12[label]["shape"] = shape
        print(f"{stamp()} B12 lockstep at {label} ({shape}): leaf_counts and "
              f"level_counts bit-exact")

    # 11b. B12 through its entry point at the fleet, default threshold
    if len(fc.nodes) < TASFlavorSnapshot.DEVICE_LEAF_THRESHOLD:
        fail("tas-fleet-131k lies below the device threshold")
    cpu_out = fc.snapshot("cpu").find_topology_assignments([req])
    _build.reset_launches()
    dev_out = fc.snapshot(dev).find_topology_assignments([req])
    fleet_launches = _build.launch_counts()
    for name in _build.TAS_KERNELS:
        if fleet_launches[name] <= 0:
            fail(f"find_topology_assignments at tas-fleet-131k did not launch {name}")

    def placed(out):
        ta = out.assignments["main"]
        return out.failure_reason, (sorted((d.values, d.count) for d in ta.domains)
                                    if ta is not None else None)

    if placed(dev_out) != placed(cpu_out) or dev_out.failure_reason:
        fail(f"tas-fleet-131k on the card differs from the CPU: {dev_out.failure_reason!r}")
    print(f"{stamp()} find_topology_assignments at tas-fleet-131k on cuda: "
          f"{len(dev_out.assignments['main'].domains)} domains, equal to the CPU; "
          f"B12 launches {fleet_launches['tas_leaf_counts']}")
    crossover = {}
    saved = TASFlavorSnapshot.DEVICE_LEAF_THRESHOLD
    try:
        for label in ("tas-placement-1k", "tas-fleet-131k"):
            fcl, reql = flavors[label]
            row = {}
            for path, threshold in (("host_numpy", 1 << 62), ("b12", 1)):
                TASFlavorSnapshot.DEVICE_LEAF_THRESHOLD = threshold
                snap = fcl.snapshot(dev)
                snap.podset_fit_counts(reql, {})  # warm: freeze, the device view
                ts = []
                for _ in range(5):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    snap.podset_fit_counts(reql, {})
                    ts.append((time.perf_counter() - t1) * 1e3)
                row[path] = float(np.median(ts))
            crossover[label] = row
            print(f"{stamp()} CountIn at {label}: host numpy {row['host_numpy']:.3f} ms, "
                  f"B12 (upload, launch, fetch) {row['b12']:.3f} ms a podset")
    finally:
        TASFlavorSnapshot.DEVICE_LEAF_THRESHOLD = saved

    # 11c. B13 lockstep: tas-drain-10k and the small two-flavor case
    env = pt.build_tas_drain(np.random.default_rng(pt.TAS_DRAIN_SEED))
    small = pt.build_tas_env(cases.tas_spec(0))

    def inputs(e):
        return pd.tas_drain_inputs(take_snapshot(e.cache), e.pending, e.cache.flavors, e.tas,
                                   dev, timestamp_fn=e.ts_fn)

    inp = inputs(env)
    plain = {}
    t0 = time.perf_counter()
    _, state, cyc = lockstep_tas(*inp.solve_args(), errs, label="tas-drain-10k",
                                 plain_ms=plain, stop_after=TAS_LOCKSTEP_CYCLES)
    if cyc != TAS_LOCKSTEP_CYCLES:
        fail(f"tas-drain-10k lockstep ran {cyc} cycles")
    shape = (f"Q={inp.plan.queues_np['cells'].shape[0]} L={inp.plan.queues_np['cells'].shape[1]}"
             f" Lf={inp.topo.free.shape[0]} Rt={inp.topo.free.shape[1]} "
             f"n_domains={inp.n_domains} n_steps={inp.n_steps}")
    print(f"{stamp()} TAS drain lockstep at tas-drain-10k ({shape}): the first {cyc} of "
          f"{pt.TAS_DRAIN_EXPECT['cycles']} cycles, {int((state.adm_cycle >= 0).sum())} admitted "
          f"by then; every launch of "
          f"{sorted(TAS_DRAIN_KERNELS)} bit-exact ({time.perf_counter() - t0:.1f} s)")
    s_inp = inputs(small)
    _, s_state, s_cyc = lockstep_tas(*s_inp.solve_args(), errs, label="tas small")
    if len(s_inp.live_flavors) != 2 or not bool(s_inp.theads_np["t_bad"].any()):
        fail("the small TAS case lost its coverage (two flavors, a t_bad park)")
    print(f"{stamp()} TAS drain lockstep small case (tas_spec(0), flavors "
          f"{s_inp.live_flavors}, n_domains={s_inp.n_domains}): {s_cyc} cycles, bit-exact")

    # 11d. the main path: run_drain_tas and run_drain_for_scope on cuda
    _build.reset_launches()
    out = pd.run_drain_tas(take_snapshot(env.cache), env.pending, env.cache.flavors, env.tas,
                           timestamp_fn=env.ts_fn, device=dev)
    launches = _build.launch_counts()
    summary = pt.drain_summary(out)
    print(f"{stamp()} run_drain_tas on cuda: {json.dumps(summary)}; launches "
          f"{json.dumps(launches)}")
    if summary != pt.TAS_DRAIN_EXPECT:
        fail(f"TAS drain {summary} != expected {pt.TAS_DRAIN_EXPECT}")
    if any(a is None for a in out.assignments):
        fail("an admitted TAS workload has no topology assignment")
    for name in TAS_DRAIN_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the TAS drain")
    snap = take_snapshot(env.cache)
    kind, pending2 = pd.classify_drain_scope(snap, env.pending, set(env.tas.flavors), False)
    _build.reset_launches()
    routed = pd.run_drain_for_scope(kind, snap, pending2, env.cache.flavors, env.tas,
                                    timestamp_fn=env.ts_fn, device=dev)
    if kind != "tas" or pt.drain_summary(routed) != summary:
        fail(f"run_drain_for_scope({kind!r}) gave {pt.drain_summary(routed)}")
    if any(_build.launch_counts()[name] <= 0 for name in TAS_DRAIN_KERNELS):
        fail("run_drain_for_scope('tas') did not launch every TAS drain kernel")
    small_runs = [pd.run_drain_tas(take_snapshot(small.cache), small.pending,
                                   small.cache.flavors, small.tas, timestamp_fn=small.ts_fn,
                                   device=d) for d in (dev, "cpu")]
    if pt.drain_summary(small_runs[0]) != pt.drain_summary(small_runs[1]):
        fail("the small TAS case on cuda differs from the CPU")
    print(f"{stamp()} run_drain_for_scope('tas') on cuda equals run_drain_tas; the small case "
          f"on cuda equals the CPU ({pt.drain_summary(small_runs[0])})")

    # 11e. walls: the entry point (median of 3 after the warm runs above),
    # its host lowering and upload, the solve (inputs on the card, one fetch)
    walls, plans, solves = [], [], []
    for _ in range(3):
        snap = take_snapshot(env.cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd.run_drain_tas(snap, env.pending, env.cache.flavors, env.tas, timestamp_fn=env.ts_fn,
                         device=dev)
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        inputs(env)
        torch.cuda.synchronize()
        plans.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        dk._solve_drain_tas_packed(*inp.solve_args(),
                                   seg_id=inp.plan.queues_np["seg_id"]).cpu()
        solves.append(time.perf_counter() - t0)
    wall_ms, plan_ms = 1e3 * float(np.median(walls)), 1e3 * float(np.median(plans))
    solve_ms = 1e3 * float(np.median(solves))
    print(f"{stamp()} TAS drain wall (run_drain_tas, median of 3): {wall_ms:.1f} ms = "
          f"{wall_ms / cyc:.3f} ms/cycle over {cyc} cycles; host lowering and upload "
          f"{plan_ms:.1f} ms; solve (inputs on the card, one fetch) {solve_ms:.2f} ms")

    # every launch of the drain timed alone, bytes from each cycle's data
    ctx = dk.tas_context(inp.tree, inp.queues, inp.paths, inp.topo.free, inp.topo.seg_ids,
                         inp.theads, inp.n_domains, inp.n_steps, inp.plan.max_cycles)
    st = dk.TASState.initial_tas(inp.local, inp.queues, inp.plan.max_cycles, inp.topo.tas_usage)
    buf = dk.TASBuffers.empty_tas(inp.local, inp.queues, inp.topo.free.shape[0])
    bd = BoundData(ctx)
    timer = TimedLaunches()
    while not st.done.item():
        cursor = st.cursor.cpu().numpy()
        tas_before = st.tas_u.cpu().numpy()
        for name, kern, _ in TAS_STEPS:
            timer(name, lambda: kern(ctx, st, buf), None)
        timer.add_bytes(tas_cycle_bytes(bd, ctx, cursor, buf, tas_before, st.tas_u.cpu().numpy()))
        timer.add_chain("drain_tas_phase2", drain_chain(bd, buf, 0, segmented=False))
    timing = {name: timing_of(timer, name, plain) for name in TAS_DRAIN_KERNELS}
    kernel_ms = sum(t["device_ms_total"] for t in timing.values())
    print(f"{stamp()} timed TAS drain: {json.dumps({k: len(v) for k, v in timer.dev_ms.items()})}"
          f" launches each timed alone, {timer.uncovered} uncovered; the kernels "
          f"{kernel_ms:.3f} ms = {100 * kernel_ms / wall_ms:.2f}% of the wall")
    for name, t in timing.items():
        print(f"kernel {name} [TAS drain, tas-drain-10k]: mean over {t['timed']} launches: "
              f"{t['ms'] * 1e3:.2f} us/launch on the device ({t['device_ms_total']:.3f} ms in "
              f"all), {t['host_ms'] * 1e3:.2f} us/call to enqueue, plain {t['plain_ms']:.3f} "
              f"ms/call, bound {t['bound_ms'] * 1e3:.4f} us ({t['bytes']:.0f} B); main-path "
              f"launches {launches[name]}, max_abs_err {errs[name]}")
    for label, row in b12.items():
        for name in ("leaf_counts", "level_counts"):
            t = row[name]
            lib = t.get("library_ms")
            print(f"kernel tas_leaf_counts.{name} [{label}, {row['shape']}]: mean over "
                  f"{t['timed']} launches: {t['ms'] * 1e3:.2f} us/launch on the device, plain "
                  f"{t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us "
                  f"({t['bytes']:.0f} B)"
                  + (f", index_add_ {lib * 1e3:.2f} us (every level)" if lib is not None else ""))
    return {"errs": errs, "timing": timing, "launches": launches, "wall_ms": wall_ms,
            "plan_ms": plan_ms, "solve_ms": solve_ms, "cycles": cyc, "kernel_ms": kernel_ms,
            "b12": b12, "fleet_launches": fleet_launches,
            "crossover": crossover, "env": env}


# ---- the planner and the admission policies (phase 12) --------------------


def plan_launch_bytes(inp, phase1, per_head) -> dict:
    """Bytes each B14 launch must move (each input read once, each
    output written once), from the solve's own data; the heads' arrays
    are shared by every scenario and count once, the quota state and
    the outputs once a scenario; the gathers count distinct (row, cell)
    pairs."""
    s, n, fr = inp["nominal_s"].shape
    d1 = inp["paths"].shape[1]
    links = 4 * n + d1 * n
    # in: nominal, lending, borrowing, leaf usage; out: subtree,
    # guaranteed, usage tree, available, potential, every scenario
    quota = 9 * s * n * fr * 8 + links

    heads = inp["heads"]
    cq = heads.cq_row.cpu().numpy()
    cells = heads.cells.cpu().numpy()
    qty = heads.qty.cpu().numpy()
    valid = heads.valid.cpu().numpy()
    w, k, c = cells.shape
    live = cq >= 0
    n_live = int(live.sum())
    cand = valid & live[:, None]
    need = (cells >= 0) & (qty > 0) & cand[:, :, None]
    rows = np.broadcast_to(np.maximum(cq, 0)[:, None, None], cells.shape)
    pairs = _distinct(rows[need], cells[need], fr)
    # in, shared: every row's cq_row, a live row's K valid flags, a
    # candidate's C cell indices and each real cell's quantity, a live
    # row's parent; a scenario's: a candidate's score, avail, potential,
    # subtree, local and nominal of each distinct pair needed; out: a
    # scenario's chosen, borrows, preempt_k of every row
    phase1_b = (4 * w + k * n_live + int(cand.sum()) * 4 * c
                + 8 * int((cells[cand] >= 0).sum()) + 4 * len(np.unique(cq[live]))
                + s * (8 * int(cand.sum()) + pairs * 5 * 8 + w * (4 + k + 4)))

    chosen, _, preempt_k = (t.cpu().numpy() for t in phase1)
    ph = per_head.cpu().numpy() if hasattr(per_head, "cpu") else per_head
    paths = inp["paths"].cpu().numpy()
    seg = np.asarray(inp["seg_id"])
    n_seg = int(seg.max()) + 1 if (seg >= 0).any() else 0
    # in, shared: a live head's cq_row, timestamp, seg_id and no_reclaim
    # (a pad row's cq_row and seg_id), the CSR; per walked (head,
    # candidate) its C cell indices and real quantities, a walked
    # head's path; a scenario's: a live head's priority, chosen,
    # preempt_k and borrow bit, subtree, guaranteed, borrowing_limit and
    # usage of each path pair, nominal of each leaf pair, usage written
    # per moved pair; out: the packed [6, W] rows of every scenario
    phase2_b = 17 * n_live + 8 * (w - n_live) + 4 * (n_seg + 1) + 4 * int((seg >= 0).sum())
    walked_pairs, walked_heads = set(), set()
    for si in range(s):
        eff = np.where(chosen[si] >= 0, chosen[si], preempt_k[si])
        walked = np.nonzero(live & (eff >= 0))[0]
        walked_pairs.update(zip(walked.tolist(), eff[walked].tolist()))
        walked_heads.update(walked.tolist())
        ce_all = cells[walked, eff[walked]]
        ce = np.where(qty[walked, eff[walked]] > 0, ce_all, -1)
        path_rows = paths[cq[walked]]
        node_rows = np.repeat(path_rows, c, axis=1)
        node_cells = np.where(node_rows >= 0, np.tile(ce, (1, d1)), -1)
        moved = (ph[si, 1, walked] > 0) | (ph[si, 3, walked] > 0)
        mrows = np.repeat(path_rows[moved], c, axis=1)
        mcells = np.where(mrows >= 0, np.tile(ce[moved], (1, d1)), -1)
        phase2_b += (17 * n_live + 32 * _distinct(node_rows.reshape(-1),
                                                    node_cells.reshape(-1), fr)
                     + 8 * _distinct(np.repeat(cq[walked], c), ce.reshape(-1), fr)
                     + 8 * _distinct(mrows.reshape(-1), mcells.reshape(-1), fr))
    wp = np.array(sorted(walked_pairs), dtype=np.int64).reshape(-1, 2)
    real = int((qty[wp[:, 0], wp[:, 1]] > 0).sum()) if len(wp) else 0
    phase2_b += len(wp) * 4 * c + 8 * real + len(walked_heads) * 4 * d1 + 48 * s * w
    return {"plan_quota_tree": [quota], "plan_phase1": [phase1_b], "plan_phase2": [phase2_b]}


class PlanCapture:
    """The B14 inputs of the Planner's last device solve (stacked,
    uploaded as ``interop.plan_inputs`` makes them), recorded by
    wrapping ``Planner._device_raws``."""

    def __init__(self):
        self.inputs, self.steps = None, None

    @contextlib.contextmanager
    def __call__(self, dev):
        from kueue_tpu_torch.interop import plan_inputs
        from kueue_tpu_torch.planner import engine

        saved = engine.Planner._device_raws

        def grab(planner, enc, stacks, batch_np, paths_np, seg_id, n_segments, n_steps, w):
            names = ("nominal_s", "lending_s", "borrowing_s", "usage_s", "priority_s",
                     "score_s")
            arrays = dict(zip(names, stacks), parent=enc.parent, level_mask=enc.level_mask,
                          heads=batch_np, paths=paths_np, seg_id=seg_id)
            self.inputs = plan_inputs(arrays, dev)
            self.steps = dict(n_segments=n_segments, n_steps=n_steps)
            return saved(planner, enc, stacks, batch_np, paths_np, seg_id, n_segments,
                         n_steps, w)

        engine.Planner._device_raws = grab
        try:
            yield self
        finally:
            engine.Planner._device_raws = saved


@contextlib.contextmanager
def timed_plan_spans(spans: dict):
    """Host wall of each part of ``Planner.plan``, per call: the
    snapshot, encode, backlog, lowering and packing; stacking the
    scenarios; the device solve (upload, three launches, the one fetch,
    the views); the decode; the ranking."""
    from kueue_tpu_torch.planner import engine

    P = engine.Planner
    mod_saved = {n: getattr(engine, n) for n in ("take_snapshot", "encode_snapshot",
                                                  "lower_heads", "pack_heads")}
    cls_saved = {n: getattr(P, n) for n in ("backlog", "_stack", "_device_raws", "_decode",
                                             "_rank")}
    span_of = {"take_snapshot": "snapshot_lowering", "encode_snapshot": "snapshot_lowering",
               "lower_heads": "snapshot_lowering", "pack_heads": "snapshot_lowering",
               "backlog": "snapshot_lowering", "_stack": "stacking",
               "_device_raws": "solve_fetch", "_decode": "decode", "_rank": "ranking"}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            key = span_of[name]
            spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    for n, fn in mod_saved.items():
        setattr(engine, n, timed(n, fn))
    for n, fn in cls_saved.items():
        setattr(P, n, timed(n, fn))
    try:
        yield
    finally:
        for n, fn in mod_saved.items():
            setattr(engine, n, fn)
        for n, fn in cls_saved.items():
            setattr(P, n, fn)


def _strip_report(report) -> dict:
    d = report.to_dict()
    for k in ("durationMs", "sweepMs", "scenariosPerSecond"):
        d.pop(k)
    return d


def sequential_ms(inp, steps, n: int) -> float:
    """bench.py's ``sequential_ms``: the first ``n`` scenarios as one
    call each of the cycle solver (``solve_cycle_segmented_packed``:
    quota_tree x4, cycle_phase1, cycle_phase2) on the card, inputs on
    the card, each result fetched; ms a scenario after one warm call."""
    import torch

    from kueue_tpu_torch.ops import assign_kernel as ak
    from kueue_tpu_torch.ops.quota import QuotaTree

    def one(si):
        tree = QuotaTree(inp["parent"], inp["level_mask"], inp["nominal_s"][si],
                         inp["lending_s"][si], inp["borrowing_s"][si])
        heads = inp["heads"]._replace(priority=inp["priority_s"][si],
                                      score=inp["score_s"][si])
        return ak.solve_cycle_segmented_packed(tree, inp["usage_s"][si], heads, inp["paths"],
                                               inp["seg_id"], **steps).cpu()

    one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for si in range(n):
        one(si)
    return (time.perf_counter() - t0) * 1e3 / n


def planner_path(dev) -> dict:
    """Phase 12a, b and d: kernel B14 in lockstep and through
    ``Planner.plan`` at planner-sweep-50k and planner-stage-500, and the
    planner's times."""
    import torch

    from kueue_tpu_torch import interop
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import plan_kernel as plk
    from kueue_tpu_torch.perf import cases
    from kueue_tpu_torch.perf import planner as pp
    from kueue_tpu_torch.perf.lockstep import (
        PLAN_KERNELS,
        Lockstep,
        plan_kernels_through,
        plan_solve,
    )

    errs, plain = {}, {}

    # 12a. lockstep: seeded random batches (S = 1, 5, 17), the small
    # case with every delta kind (also equal to its plan on the CPU),
    # planner-stage-500 and planner-sweep-50k (the plain steps timed)
    for seed, s in ((0, 1), (1, 5), (2, 17)):
        b = cases.plan_batch(seed, s, w=64, k=8, c=16)
        plan_solve(**interop.plan_inputs(b, dev), n_segments=b["n_segments"],
                   n_steps=b["n_steps"], check=Lockstep(errs, label=f"plan_batch {seed}"))
    reps = []
    for d in (dev, "cpu"):
        planner, scens, _, _ = pp.every_kind_case(device=d)
        with plan_kernels_through(Lockstep(errs, label="every delta kind")):
            reps.append(planner.plan(scenarios=scens, include_reasons="all",
                                     verify_host=True))
    if _strip_report(reps[0]) != _strip_report(reps[1]):
        fail("the every-kind planner case on cuda differs from the CPU")
    kinds = {o.name for o in reps[0].scenarios}
    if (not any(o.reserved for o in reps[0].scenarios)
            or not any(o.preemption_candidates for o in reps[0].scenarios)):
        fail("the every-kind planner case lost its coverage (reservations, preempt-mode heads)")
    print(f"{stamp()} B14 lockstep: plan_batch S=1,5,17 and the every-kind case "
          f"({reps[0].heads} heads, {len(kinds)} scenarios: {sorted(kinds)}) bit-exact; "
          f"its report on cuda equals the CPU's")

    stage = pp.build_stage(device=dev)
    sweep = pp.build_sweep(np.random.default_rng(pp.SWEEP_SEED), device=dev)
    cells = {}
    for label, (planner, scens, cache, _), expect in (
            ("planner-stage-500", stage, pp.PLANNER_STAGE_EXPECT),
            ("planner-sweep-50k", sweep, pp.PLANNER_SWEEP_EXPECT)):
        keys = [wl.key for wl, _ in planner.backlog(take_snapshot(cache), "backlog")]
        t0 = time.perf_counter()
        cap = PlanCapture()
        with plan_kernels_through(Lockstep(errs, label=label, plain_ms=plain.setdefault(
                label, {}))), cap(dev):
            rep = planner.plan(scenarios=scens, heads_mode="backlog", include_reasons="none")
        if pp.plan_summary(rep, keys) != expect:
            fail(f"{label} lockstep plan gave {pp.plan_summary(rep, keys)}")
        s_, n_, fr_ = cap.inputs["nominal_s"].shape
        w_, k_, c_ = cap.inputs["heads"].cells.shape
        cells[label] = dict(planner=planner, scens=scens, keys=keys, cap=cap,
                            shape=(f"S={s_} W={w_} K={k_} C={c_} N={n_} FR={fr_} "
                                   f"D={cap.inputs['paths'].shape[1] - 1} "
                                   f"n_segments={cap.steps['n_segments']} "
                                   f"n_steps={cap.steps['n_steps']}"))
        print(f"{stamp()} B14 lockstep at {label} ({cells[label]['shape']}): every launch "
              f"bit-exact ({time.perf_counter() - t0:.1f} s)")

    # 12b. the main path: Planner.plan on cuda, counters reset before
    launches = {}
    for label in ("planner-sweep-50k", "planner-stage-500"):
        c = cells[label]
        _build.reset_launches()
        rep = c["planner"].plan(scenarios=c["scens"], heads_mode="backlog",
                                include_reasons="none")
        launches[label] = _build.launch_counts()
        summary = pp.plan_summary(rep, c["keys"])
        print(f"{stamp()} Planner.plan at {label} on cuda: {json.dumps(summary)}; launches "
              f"{json.dumps({n: launches[label][n] for n in PLAN_KERNELS})}")
        expect = (pp.PLANNER_SWEEP_EXPECT if label == "planner-sweep-50k"
                  else pp.PLANNER_STAGE_EXPECT)
        if summary != expect:
            fail(f"{label} plan {summary} != expected {expect}")
        if rep.backend != "device" or any(launches[label][n] != 1 for n in PLAN_KERNELS):
            fail(f"{label} was not one B14 call (three launches) on the card")
        if sum(launches[label].values()) != len(PLAN_KERNELS):
            fail(f"{label} launched other kernels: {launches[label]}")
    c = cells["planner-stage-500"]
    rep = c["planner"].plan(scenarios=c["scens"], include_reasons="none", verify_host=True)
    print(f"{stamp()} planner-stage-500 with verify_host=True: the numpy mirror equals the "
          f"card in all {len(rep.scenarios)} scenarios")

    # 12d. times: the plan's wall and spans (median of 3, warm), the
    # solve with its inputs on the card, every launch alone, the
    # sequential shape
    out = {"errs": errs, "launches": launches, "cells": {}}
    for label, c in cells.items():
        walls, span_runs = [], []
        for _ in range(3):
            spans = {}
            torch.cuda.synchronize()
            with timed_plan_spans(spans):
                t0 = time.perf_counter()
                rep = c["planner"].plan(scenarios=c["scens"], heads_mode="backlog",
                                        include_reasons="none")
                walls.append(time.perf_counter() - t0)
            span_runs.append(spans)
        inp, steps = c["cap"].inputs, c["cap"].steps
        solves = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plk.solve_scenarios_packed(**inp, **steps).cpu()
            solves.append(time.perf_counter() - t0)
        timer = TimedLaunches()
        captured = {}

        def check(name, kern, plain_fn, _timer=timer):
            o = _timer(name, kern, None)
            captured[name] = o
            return o

        s_, n_, fr_ = inp["nominal_s"].shape
        for _ in range(3):
            buf = plan_solve(**inp, **steps, check=check)
        # the same inputs every time: the bytes once
        ph, _ = plk.unpack(buf, s_, inp["heads"].cq_row.shape[0], n_, fr_)
        chosen, _, pk = (t.cpu().numpy() for t in captured["plan_phase1"])
        seg = np.asarray(inp["seg_id"])
        live = (inp["heads"].cq_row.cpu().numpy() >= 0) & (seg >= 0) & (
            seg < steps["n_segments"])
        p_chain = max(chain_heads(live & ((chosen[si] >= 0) | (pk[si] >= 0)), seg,
                                  steps["n_steps"]) for si in range(s_))
        for _ in range(3):
            timer.add_bytes(plan_launch_bytes(inp, captured["plan_phase1"], ph))
            timer.add_chain("plan_phase2", p_chain)
        timing = {n: timing_of(timer, n, plain[label]) for n in PLAN_KERNELS}
        n_seq = s_ - 1 if label == "planner-stage-500" else 8
        seq = sequential_ms(inp, steps, n_seq)
        wall = 1e3 * float(np.median(walls))
        med = {k: 1e3 * float(np.median([r.get(k, 0.0) for r in span_runs]))
               for k in ("snapshot_lowering", "stacking", "solve_fetch", "decode", "ranking")}
        solve_ms = 1e3 * float(np.median(solves))
        out["cells"][label] = {"wall_ms": wall, "spans_ms": med, "solve_ms": solve_ms,
                               "timing": timing, "sequential_ms_per_scenario": seq,
                               "batched_ms_per_scenario": solve_ms / s_,
                               "shape": c["shape"], "sweep_ms": 1e3 * rep.sweep_s}
        print(f"{stamp()} Planner.plan at {label} (median of 3): {wall:.1f} ms; spans "
              + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
              + f" ms; the solve with its inputs on the card (three launches, one fetch) "
              f"{solve_ms:.2f} ms = {solve_ms / s_:.4f} ms a scenario; the sequential shape "
              f"(one cycle solve a scenario, {n_seq} scenarios) {seq:.3f} ms a scenario")
        for name, t in timing.items():
            print(f"kernel {name} [{label}, {c['shape']}]: mean over {t['timed']} launches: "
                  f"{t['ms'] * 1e3:.2f} us/launch on the device, {t['host_ms'] * 1e3:.2f} "
                  f"us/call to enqueue, plain {t['plain_ms']:.3f} ms/call, bound "
                  f"{t['bound_ms'] * 1e3:.4f} us ({t['bytes']:.0f} B); main-path launches "
                  f"{launches[label][name]}, max_abs_err {errs[name]}")
    return out


def policy_path(dev) -> dict:
    """Phase 12c: policy-48x64's first-fit and Gavel drains on cuda,
    the Gavel what-if with its forecast, and a Gavel Scheduler's cycles
    on the card against the CPU."""
    import torch

    from kueue_tpu_torch.core.drain import run_drain
    from kueue_tpu_torch.core.scheduler import Scheduler
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.perf import planner as pp
    from kueue_tpu_torch.perf.lockstep import DRAIN_KERNELS, Lockstep, cycle_kernels_through
    from kueue_tpu_torch.policy import resolve_policy

    env = pp.build_policy(np.random.default_rng(pp.POLICY_SEED))
    gavel = resolve_policy("gavel")
    got, walls, launches = {}, {}, {}
    for key, pol in (("first_fit", None), ("gavel", gavel)):
        _build.reset_launches()
        out = run_drain(take_snapshot(env.cache), env.pending, env.cache.flavors,
                        timestamp_fn=env.ts_fn, policy=pol, device=dev)
        launches[key] = _build.launch_counts()
        got[key] = pp.drain_summary(out)
        if any(launches[key][n] <= 0 for n in DRAIN_KERNELS):
            fail(f"the {key} drain at policy-48x64 did not launch every drain kernel")
    for key, pol in (("first_fit", None), ("gavel", gavel), ("first_fit", None),
                     ("gavel", gavel), ("first_fit", None), ("gavel", gavel)):
        snap = take_snapshot(env.cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_drain(snap, env.pending, env.cache.flavors, timestamp_fn=env.ts_fn, policy=pol,
                  device=dev)
        walls.setdefault(key, []).append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    report = pp.policy_plan(env, device=dev)
    forecast_s = time.perf_counter() - t0
    got.update(pp.forecast_gain(report))
    print(f"{stamp()} policy-48x64 on cuda: {json.dumps(got)}; the Gavel plan with its "
          f"forecast {forecast_s:.1f} s")
    if got != pp.POLICY_EXPECT:
        fail(f"policy-48x64 {got} != expected {pp.POLICY_EXPECT}")
    wall = {k: 1e3 * float(np.median(v)) for k, v in walls.items()}
    print(f"{stamp()} policy-48x64 drain walls (run_drain, median of 3): first-fit "
          f"{wall['first_fit']:.1f} ms, Gavel {wall['gavel']:.1f} ms")

    traces, errs = [], {}
    for d in (dev, "cpu"):
        cenv = pp.build_policy(np.random.default_rng(pp.POLICY_SEED))
        sched = Scheduler(queues=cenv.mgr, cache=cenv.cache, clock=cenv.clock, use_solver=True,
                          solver_threshold=1, device=d, policy=gavel)
        trace = []
        with cycle_kernels_through(Lockstep(errs, label="Gavel cycle")):
            for _ in range(4):
                r = sched.schedule()
                trace.append((sorted((e.workload.name, repr(sorted(
                    e.workload.admission.pod_set_assignments[0].flavors.items())))
                    for e in r.admitted), dict(sched._cycle_scores)))
        traces.append(trace)
    if traces[0] != traces[1] or not traces[0][0][0]:
        fail("the Gavel Scheduler's cycles on cuda differ from the CPU")
    print(f"{stamp()} Scheduler(policy=gavel) at policy-48x64: 4 cycles on cuda equal the CPU "
          f"(admitted {[len(t[0]) for t in traces[0]]}, score breakdowns included), every "
          f"cycle launch bit-exact")
    return {"errs": errs, "launches": launches, "walls": wall, "forecast_s": forecast_s,
            "summary": got}


# ---- the mesh harness, the unsegmented cycle (B3') and the DRS (B1') ----


def drs_path(dev, snaps, errs, timer, plain_ms) -> dict:
    """13b: kernel B1' on each snapshot of ``snaps`` (label -> snapshot):
    the main path's launches (lendable, then the DRS with a zero and a
    seeded nonzero request, under the snapshot's weights and under
    weights with zeros), each held to its plain version and the DRS of
    every ClusterQueue to the snapshot's own numpy DRS; every launch
    timed alone. Returns the main path's launch counts."""
    import torch

    from kueue_tpu_torch import interop
    from kueue_tpu_torch.core.solver import tree_arrays
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import quota as q

    cases_ = []
    for i, (label, snap) in enumerate(snaps.items()):
        tree, _, _ = tree_arrays(snap, dev)
        local = tree.nominal.new_tensor(snap.local_usage)
        n, fr = tree.nominal.shape
        rng = np.random.default_rng(80 + i)
        w0 = np.asarray(snap.weight_milli, dtype=np.int64)
        wz = w0.copy()
        wz[rng.random(n) < 0.1] = 0
        req = (rng.integers(0, 4000, (n, fr)) * (rng.random((n, fr)) < 0.2)).astype(np.int64)
        x = interop.drs_inputs(dict(resource_index=snap.resource_index, weight_milli=w0,
                                    wl_req=req), dev)
        variants = [(torch.zeros_like(x["wl_req"]), x["weight_milli"]),
                    (x["wl_req"], x["weight_milli"]),
                    (x["wl_req"], torch.tensor(wz, device=dev))]
        cases_.append((label, snap, tree, local, x["resource_index"],
                       len(snap.resource_names), variants))

    # the main path: the counters from 0, every entry on the card
    _build.reset_launches()
    outs = []
    for label, snap, tree, local, ri, n_res, variants in cases_:
        sub, g = q.subtree_quota(tree)
        usage = q.usage_tree(tree, g, local)
        lend = q.lendable_per_resource(tree, sub, g, ri, n_res)
        drs = [q.dominant_resource_share(tree, sub, g, usage, req, w, ri, n_res)
               for req, w in variants]
        outs.append((sub, g, usage, lend, drs))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if launches["quota_drs"] != sum(1 + len(c[6]) for c in cases_):
        fail(f"B1' launched {launches['quota_drs']} times on its main path")

    report = {}
    for (label, snap, tree, local, ri, n_res, variants), (sub, g, usage, lend, drs) in zip(
            cases_, outs):
        err = 0
        t0 = time.perf_counter()
        lp = q.lendable_per_resource_plain(tree, sub, g, ri, n_res)
        torch.cuda.synchronize()
        plain_ms.setdefault("quota_drs", []).append((time.perf_counter() - t0) * 1e3)
        err = max(err, int((lp - lend).abs().max().item()))
        for (req, w), (d, dom) in zip(variants, drs):
            t0 = time.perf_counter()
            pd_, pdom = q.dominant_resource_share_plain(tree, sub, g, usage, req, w, ri, n_res)
            torch.cuda.synchronize()
            plain_ms["quota_drs"].append((time.perf_counter() - t0) * 1e3)
            err = max(err, int((pd_ - d).abs().max().item()),
                      int((pdom - dom).abs().max().item()))
        errs["quota_drs"] = max(errs.get("quota_drs", 0), err)
        if err:
            fail(f"B1' on {label} differs from its plain version by {err}")
        n_cq = snap.flat.n_cq
        host = np.asarray(snap.all_node_drs())[:n_cq]
        card = drs[0][0].cpu().numpy()[:n_cq]
        if not np.array_equal(host, card):
            fail(f"B1' on {label}: the DRS of {int((host != card).sum())} ClusterQueues "
                 f"differ from dominant_resource_share_np")
        n, fr = tree.nominal.shape
        d = tree.max_depth
        for _ in range(3):
            timer("quota_drs", lambda: q.lendable_per_resource(tree, sub, g, ri, n_res), None)
            timer.add_bytes({"quota_drs": [drs_bytes(n, fr, d, n_res, False)]})
            for req, w in variants:
                timer("quota_drs", lambda: q.dominant_resource_share(
                    tree, sub, g, usage, req, w, ri, n_res), None)
                timer.add_bytes({"quota_drs": [drs_bytes(n, fr, d, n_res, True)]})
        borrowing = [int((dd[1] >= 0).sum().item()) for dd in drs]
        report[label] = {"shape": f"N={n} FR={fr} R={n_res} D={d}",
                         "borrowing_nodes": borrowing,
                         "cq_drs_max": int(card.max()) if card.size else 0}
        print(f"{stamp()} B1' at {label} (N={n} FR={fr} R={n_res} D={d}): lendable and "
              f"3 DRS variants bit-exact to their plain versions; nodes with a dominant "
              f"resource {borrowing}; the DRS of all {n_cq} ClusterQueues equal "
              f"dominant_resource_share_np")
    return {"launches": launches, "report": report}


def mesh_path(dev, cache, pending, walls) -> dict:
    """Phase 13: ShardedSolver with B3' at the headline cycles, B1', and
    every drain's mesh= path on a one-card mesh (module docstring).
    ``walls`` are the earlier phases' unsharded walls (ms), printed
    beside the mesh's."""
    import torch

    from kueue_tpu_torch import entry, interop
    from kueue_tpu_torch.core import drain as pd
    from kueue_tpu_torch.core import preempt_batch as pb
    from kueue_tpu_torch.core.pipeline import speculative_snapshot
    from kueue_tpu_torch.core.snapshot import take_snapshot
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import assign_kernel as ak
    from kueue_tpu_torch.ops import quota as q
    from kueue_tpu_torch.parallel import ShardedSolver, harness, make_mesh
    from kueue_tpu_torch.perf import cases, contended, cycle, headline, megaloop
    from kueue_tpu_torch.perf import fairpreempt as fp
    from kueue_tpu_torch.perf import mesh as pm
    from kueue_tpu_torch.perf import tas as pt

    errs, plain_ms = {}, {}
    mesh = make_mesh(1, device=dev)
    if harness.mesh_shape_str(mesh) != "wl=1" or mesh.distinct_devices()[0].type != dev.type:
        fail(f"make_mesh(1, device={dev}) gave {mesh}")
    harness.reset_stats()
    by_path = {}

    # 13c (the cycle): the headline cycles with the dispatch on the mesh,
    # each segmented solve (B3) recorded
    store = []
    sched, ccache = cycle.build_headline_scheduler(device=dev, guard=strict_guard())
    _build.reset_launches()
    with pm.dispatch_through_mesh(mesh), pm.record_cycle_solves(store):
        records = cycle.run_cycles(sched)
        csum = cycle.cycle_summary(records, ccache, take_snapshot)
        records += cycle.run_cycles(sched, STEADY_CYCLES - cycle.CYCLES)
    by_path["mesh_cycle_dispatch"] = _build.launch_counts()
    check_strict(sched.guard, "the headline cycles on the mesh")
    if csum != cycle.CYCLE_EXPECT:
        fail(f"dispatch_lowered(mesh=) headline cycles {csum} != {cycle.CYCLE_EXPECT}")
    if records != walls["cycle_records"]:
        fail("the headline cycles on the mesh differ from the cycles without it")
    if len(store) != STEADY_CYCLES:
        fail(f"{len(store)} segmented solves recorded over {STEADY_CYCLES} cycles")
    for name in ("quota_tree", "cycle_phase1", "cycle_phase2"):
        if by_path["mesh_cycle_dispatch"][name] <= 0:
            fail(f"kernel {name} was not launched by the cycles on the mesh")
    print(f"{stamp()} Scheduler with dispatch_lowered(mesh=wl=1) on cuda: {json.dumps(csum)}; "
          f"{len(records)} cycles equal to the cycles without the mesh; launches "
          f"{json.dumps(by_path['mesh_cycle_dispatch'])}")

    # 13a. the main path of B3': ShardedSolver on each recorded cycle
    solver = ShardedSolver(mesh)
    _build.reset_launches()
    results, solve_ms = [], []
    for s in store:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = solver(s.tree, s.local, s.heads, s.paths)
        fetched = (torch.stack([r.chosen.long(), r.admitted.long(), r.borrows.long(),
                                r.reserved.long(), r.order.long()]).cpu(), r.usage.cpu())
        solve_ms.append((time.perf_counter() - t0) * 1e3)
        results.append(fetched)
    by_path["sharded_cycle"] = _build.launch_counts()
    for name in _build.SHARDED_CYCLE_KERNELS:
        if by_path["sharded_cycle"][name] <= 0:
            fail(f"kernel {name} was not launched by ShardedSolver")
    # ... held to B3 (the segmented solve on the same heads) at every
    # cycle, and to solve_cycle_plain on the card at the first, a middle
    # and the last cycle
    t0 = time.perf_counter()
    err = 0
    plain_at = {0, len(store) // 2, len(store) - 1}
    for i, (s, (rows, usage)) in enumerate(zip(store, results)):
        if not (torch.equal(rows, s.packed.cpu()) and torch.equal(usage, s.usage.cpu())):
            fail(f"B3' at headline cycle {i + 1} differs from B3 on the same heads")
        if i not in plain_at:
            continue
        p = ak.solve_cycle_plain(s.tree, s.local, s.heads, s.paths)
        prow = torch.stack([p.chosen.long(), p.admitted.long(), p.borrows.long(),
                            p.reserved.long(), p.order.long()]).cpu()
        err = max(err, int((prow - rows).abs().max().item()),
                  int((p.usage.cpu() - usage).abs().max().item()))
    errs["cycle_global"] = err
    if err:
        fail(f"B3' differs from solve_cycle_plain by {err}")
    n_walk = [int((s.packed[0] >= 0).sum().item()) for s in store]
    print(f"{stamp()} ShardedSolver(make_mesh(1, 'cuda')) at the {len(store)} headline cycles "
          f"(W={store[0].heads.cq_row.shape[0]}, N={store[0].tree.n_nodes}, "
          f"FR={store[0].tree.nominal.shape[1]}): packed rows and usage tree bit-exact to B3's on "
          f"the same heads, and to solve_cycle_plain on the card at cycles "
          f"{sorted(i + 1 for i in plain_at)} "
          f"({time.perf_counter() - t0:.1f} s); launches "
          f"{json.dumps({k: v for k, v in by_path['sharded_cycle'].items() if v})}")

    # ... on seeded small batches (reservations, preempt-mode heads,
    # depth 3, pads, scores) and entry(device="cuda")'s problem, each
    # launch held to its plain version on the card
    check_errs = {}
    from kueue_tpu_torch.perf.lockstep import Lockstep

    check = Lockstep(check_errs, label="B3' small batches")
    for seed in range(13):
        # seed 12: 3000 ClusterQueues x FR 12, beyond one block's shared memory
        kw = ({} if seed < 8 else {"w": 200, "n_cq": 60, "fr": 12} if seed < 12
              else {"w": 8, "n_cq": 3000, "fr": 12})
        b = cases.cycle_batch(seed, **kw)
        tree, heads = interop.quota_tree(b, dev), interop.heads_batch(b, dev)
        local, paths = torch.tensor(b["local_usage"], device=dev), torch.tensor(b["paths"], device=dev)
        sub, g = q.subtree_quota(tree)
        usage = q.usage_tree(tree, g, local)
        ph = ak.phase1_classify(tree, sub, g, local, heads)
        u2 = usage.clone()
        check("cycle_global",
              lambda: (ak.cycle_global(tree, sub, g, usage, paths, heads, *ph), usage),
              lambda: (ak.cycle_global_plain(tree, sub, g, u2, paths, heads, *ph), u2))
        ref = ak.solve_cycle_segmented(tree, local, heads, paths, b["seg_id"],
                                       max(b["n_segments"], 1), max(b["n_steps"], 1))
        got = ak.solve_cycle(tree, local, heads, paths)
        for f in ("chosen", "admitted", "borrows", "reserved", "order", "usage"):
            if not torch.equal(getattr(got, f), getattr(ref, f)):
                fail(f"B3' on cycle_batch({seed}) differs from B3 in {f}")
    fn, eargs = entry.entry(device=dev)
    got, ref = fn(*eargs), ak.solve_cycle_plain(*eargs)
    for f in ("chosen", "admitted", "borrows", "reserved", "order", "usage"):
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            fail(f"entry(device='cuda'): solve_cycle differs from its plain version in {f}")
    errs["cycle_global"] = max(errs["cycle_global"], check_errs.get("cycle_global", 0))
    if check.failures:
        fail(f"B3' small batches: {check.failures}")
    print(f"{stamp()} B3' on cycle_batch seeds 0-12 (depth 3, reservations, pads, scores; "
          f"W up to 200; a 3000-ClusterQueue tree): bit-exact to its plain version and to "
          f"B3; entry(device='cuda') ({int(got.admitted.sum())} of {got.admitted.shape[0]} "
          f"admitted) equal to solve_cycle_plain")

    # 13d. B3' timed alone at every headline cycle, B3 beside it on the
    # same heads; the plain step loop on the card at the first cycle
    timer = TimedLaunches()
    for i, s in enumerate(store):
        sub, g = q.subtree_quota(s.tree)
        usage0 = q.usage_tree(s.tree, g, s.local)
        avail = q.available_all(s.tree, sub, g, usage0)
        pot = q.potential_available_all(s.tree, sub, g)
        ph = ak.phase1_classify(s.tree, sub, g, s.local, s.heads, avail, pot)
        u1, u2 = usage0.clone(), usage0.clone()
        packed = timer("cycle_global", lambda: ak.cycle_global(
            s.tree, sub, g, u1, s.paths, s.heads, *ph), None)
        seg_t, segments = ak._as_seg_id(s.seg_id, dev)
        timer("cycle_phase2", lambda: ak.cycle_phase2(
            s.tree, sub, g, u2, s.paths, s.heads, seg_t, segments, s.n_segments, s.n_steps,
            *ph), None)
        timer.add_bytes({
            "cycle_global": [sharded_cycle_bytes(s.tree, s.heads, s.paths, ph, packed)],
            "cycle_phase2": cycle_launch_bytes(s.tree, s.heads, s.paths, s.seg_id, ph,
                                               packed)["cycle_phase2"],
        })
        w = len(s.seg_id)
        timer.add_chain("cycle_global", cycle_chain(s.heads, s.seg_id, ph, w, w))
        timer.add_chain("cycle_phase2", cycle_chain(s.heads, s.seg_id, ph, s.n_segments,
                                                    s.n_steps))
        if i in (0, len(store) - 1):
            u3 = usage0.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pp = ak.cycle_global_plain(s.tree, sub, g, u3, s.paths, s.heads, *ph)
            torch.cuda.synchronize()
            plain_ms.setdefault("cycle_global", []).append((time.perf_counter() - t0) * 1e3)
            if not (torch.equal(pp, packed) and torch.equal(u3, u1)):
                fail(f"B3' at headline cycle {i + 1} differs from cycle_global_plain on the card")
    gtiming = timing_of(timer, "cycle_global", plain_ms)
    b3 = timing_of(timer, "cycle_phase2", {"cycle_phase2": [float("nan")]})
    print(f"{stamp()} B3' timed alone at the {len(store)} headline cycles: "
          f"{gtiming['ms'] * 1e3:.2f} us/launch on the device (B3 on the same heads "
          f"{b3['ms'] * 1e3:.2f} us), plain step loop on the card {gtiming['plain_ms']:.1f} ms; "
          f"bound {gtiming['bound_ms'] * 1e3:.4f} us ({gtiming['bytes']:.0f} B); heads with a "
          f"fitting candidate a cycle {min(n_walk)}-{max(n_walk)}; ShardedSolver wall a cycle (phase 1, B3', fetch; "
          f"median of {len(solve_ms)}) {float(np.median(solve_ms)):.3f} ms; "
          f"{timer.uncovered} uncovered")

    # 13b. B1' on fair-preempt-1k and the headline (after its cycles)
    drs_timer = TimedLaunches()
    drs = drs_path(dev, {"fair-preempt-1k": take_snapshot(walls["fair_preempt_env"].cache),
                         "headline after 30 cycles": take_snapshot(ccache)},
                   errs, drs_timer, plain_ms)
    by_path["drs"] = drs["launches"]
    dtiming = timing_of(drs_timer, "quota_drs", plain_ms)
    print(f"{stamp()} B1' timed alone: {dtiming['ms'] * 1e3:.2f} us/launch over "
          f"{dtiming['timed']} launches (lendable and DRS), plain {dtiming['plain_ms']:.3f} "
          f"ms/call, bound {dtiming['bound_ms'] * 1e3:.4f} us ({dtiming['bytes']:.0f} B); "
          f"{drs_timer.uncovered} uncovered")

    # 13c. every drain's mesh= path on the one-card mesh, counters reset
    # before it, its constant asserted, its wall (one run) beside the
    # unsharded wall of its earlier phase
    mc = headline.HEADLINE_MAX_CELLS
    cenv, fenv, tenv = walls["contended_env"], walls["fair_preempt_env"], walls["tas_env"]

    def chain(snap):
        return megaloop.run_chain(pd.launch_drain_megaloop, speculative_snapshot,
                                  snap, pending, cache.flavors, mesh=mesh)

    # label -> (the snapshot to drain, taken outside the timed region as
    # the earlier phases take it; the drain; its summary; its constant;
    # its kernels; the unsharded wall)
    drains = {
        "mesh_drain": (lambda: take_snapshot(cache),
                       lambda s: pd.run_drain(s, pending, cache.flavors, max_cells=mc,
                                              mesh=mesh),
                       headline.outcome_summary, headline.HEADLINE_EXPECT,
                       _build.DRAIN_KERNELS, walls["drain"]),
        "mesh_fair": (lambda: take_snapshot(cache),
                      lambda s: pd.run_drain(s, pending, cache.flavors, max_cells=mc,
                                             fair_sharing=True, mesh=mesh),
                      headline.outcome_summary, headline.FAIR_EXPECT, _build.FAIR_KERNELS,
                      walls["fair"]),
        "mesh_megaloop": (lambda: take_snapshot(cache), chain, megaloop.chain_summary,
                          megaloop.MEGALOOP_EXPECT, _build.MEGALOOP_KERNELS,
                          walls["megaloop"]),
        "mesh_preempt": (lambda: take_snapshot(cenv.cache), lambda s: pd.run_drain_preempt(
            s, cenv.pending, cenv.cache.flavors, timestamp_fn=cenv.ts_fn,
            search_width=contended.SEARCH_WIDTH, panel_tuner=pd.PanelTuner(), mesh=mesh),
            contended.drain_summary, contended.CONTENDED_EXPECT, _build.PREEMPT_KERNELS,
            walls["contended"]),
        "mesh_fair_preempt": (lambda: take_snapshot(fenv.cache), lambda s: pd.run_drain_fair_preempt(
            s, fenv.pending, fenv.cache.flavors, timestamp_fn=fenv.ts_fn, mesh=mesh),
            fp.drain_summary, fp.FAIR_PREEMPT_EXPECT, _build.FAIR_PREEMPT_KERNELS,
            walls["fair_preempt"]),
        "mesh_tas": (lambda: take_snapshot(tenv.cache), lambda s: pd.run_drain_tas(
            s, tenv.pending, tenv.cache.flavors, tenv.tas, timestamp_fn=tenv.ts_fn, mesh=mesh),
            pt.drain_summary, pt.TAS_DRAIN_EXPECT, _build.TAS_DRAIN_KERNELS, walls["tas"]),
    }
    mesh_walls = {}
    for label, (snap_of, run, summarize, expect, kernels, plain_wall) in drains.items():
        snap = snap_of()
        _build.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(snap)
        wall = time.perf_counter() - t0
        by_path[label] = _build.launch_counts()
        summary = summarize(out)
        if summary != expect:
            fail(f"{label}: {summary} != expected {expect}")
        for name in kernels:
            if by_path[label][name] <= 0:
                fail(f"kernel {name} was not launched by {label}")
        mesh_walls[label] = {"mesh_ms": wall * 1e3, "unsharded_ms": plain_wall}
        extra = ""
        if label == "mesh_preempt":
            extra = (f"; panel schedule {json.dumps(harness.last_panel_schedule())}, canary "
                     f"verdicts {json.dumps({str(k[1]): v for k, v in harness.probe_verdicts().items()})}")
        print(f"{stamp()} {label} on make_mesh(1, 'cuda'): {json.dumps(summary)}; wall "
              f"(one run) {mesh_walls[label]['mesh_ms']:.1f} ms beside {plain_wall:.1f} ms "
              f"without the mesh{extra}")
    verdicts = harness.probe_verdicts()
    if not verdicts or not all(verdicts.values()):
        fail(f"the narrow-panel canary did not certify the card's mesh: {verdicts}")
    if not all(k[0] == harness.mesh_fingerprint(mesh) for k in verdicts):
        fail(f"the canary ran off the card: {list(verdicts)}")

    # batched_fair_get_targets(mesh=) at bench.py's fair stage
    snap, items, pre = fp.build_fair_search(np.random.default_rng(fp.SEARCH_SEED))
    arrays, meta = pb.lower_fair_preemption(snap, items, pre)
    _build.reset_launches()
    res = pb.batched_fair_get_targets(snap, items, pre, mesh=mesh)
    by_path["mesh_fair_search"] = _build.launch_counts()
    ssum = fp.search_summary(items, res, meta)
    ref = pb.batched_fair_get_targets(snap, items, pre, device=dev)
    if ssum != fp.FAIR_SEARCH_EXPECT or [sorted((t.workload.workload.name, t.reason) for t in r)
                                         for r in res] != [
            sorted((t.workload.workload.name, t.reason) for t in r) for r in ref]:
        fail(f"batched_fair_get_targets(mesh=) {ssum} != {fp.FAIR_SEARCH_EXPECT}")
    if by_path["mesh_fair_search"]["fair_search"] != 1:
        fail("the fair search under the mesh is not one full-width launch")
    print(f"{stamp()} batched_fair_get_targets(mesh=wl=1): FAIR_SEARCH_EXPECT, the victims "
          f"of the search without the mesh, one full-width B9 launch")
    print(f"{stamp()} mesh {harness.mesh_shape_str(mesh)}: bucket_stats "
          f"{json.dumps(harness.bucket_stats())}; placement {harness.place_seconds():.3f} s "
          f"in all; the canary ran {len(verdicts)} time(s)")
    return {"errs": errs, "timing": {"cycle_global": gtiming, "quota_drs": dtiming},
            "b3_same_heads": b3, "launches": by_path, "walls": mesh_walls,
            "sharded_solve_ms": float(np.median(solve_ms)), "drs": drs["report"],
            "buckets": harness.bucket_stats(), "place_s": harness.place_seconds()}


# ---- main ---------------------------------------------------------------


# ---- the runtime and the federation (phase 14) -----------------------------


B15_CELLS = {"rescore-65k-64": (65_536, 64, 915), "rescore-1k-4096": (1024, 4096, 916)}


def b15_bytes(w: int, c: int) -> int:
    """Bytes B15 must move: tta, score and valid per pair, current and
    rotation per row, degraded per column in; best (int32), best_key,
    gain (int64) and rebalance (bool) per row out."""
    return w * c * 17 + w * 8 + c + w * 21


def b15_case_inputs() -> list:
    """The CPU tests' B15 cases (tests/test_torch_global_kernel.py), as
    rescore_pairs keyword arguments."""
    from kueue_tpu_torch.ops.global_kernel import TTA_CAP_MS
    from kueue_tpu_torch.perf.cases import rescore_fleet

    out = []
    for seed in range(8):
        rng = np.random.default_rng(seed)
        out += [rescore_fleet(rng) for _ in range(12)]
    for seed in range(4):
        rng = np.random.default_rng(100 + seed)
        for _ in range(10):
            c = int(rng.integers(2, 9))
            out.append(rescore_fleet(rng, w=int(rng.integers(1, 12)), c=c,
                                     n_degraded=int(rng.integers(0, c + 1))))
    for seed in range(4):
        rng = np.random.default_rng(200 + seed)
        out += [rescore_fleet(rng, wide_rotation=True, current_past=True,
                              n_degraded=1 if i % 2 else None) for i in range(10)]
    corner = dict(tta_ms=np.full((2, 4096), TTA_CAP_MS, np.int64),
                  score=np.full((2, 4096), -(2**21), np.int64),
                  valid=np.zeros((2, 4096), bool), current=np.array([0, 4095], np.int32),
                  rotation=np.zeros(2, np.int32), hysteresis_ms=0)
    corner["valid"][1, 4095] = True
    ties = dict(tta_ms=np.array([[100, 100, 50], [100, 100, 100], [100, 100, 100]], np.int64),
                score=np.array([[5, 9, 0], [5, 9, 0], [0, 0, 0]], np.int64),
                valid=np.ones((3, 3), bool), current=np.zeros(3, np.int32),
                rotation=np.array([0, 0, 2], np.int32), hysteresis_ms=0)
    hyst = dict(tta_ms=np.array([[100_000, 0]], np.int64), score=np.zeros((1, 2), np.int64),
                valid=np.ones((1, 2), bool), current=np.array([0], np.int32),
                rotation=np.array([0], np.int32))
    out += [corner, ties, {**hyst, "hysteresis_ms": 100_000}, {**hyst, "hysteresis_ms": 99_999}]
    return out


@contextlib.contextmanager
def b15_lockstep(errs: dict, plain_ms: list, seen: list):
    """Every B15 launch on the card (``rescore_packed``, which
    ``rescore_pairs`` calls) held bit-exact to ``rescore_plain`` on the
    same inputs; the plain version's ms and each launch's inputs are
    kept. The compare calls launch nothing."""
    import torch

    from kueue_tpu_torch.ops import global_kernel as gk

    real = gk.rescore_packed

    def checked(*args):
        out = real(*args)
        if args[0].is_cuda:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = gk.rescore_plain(*args)
            torch.cuda.synchronize()
            plain_ms.append((time.perf_counter() - t0) * 1e3)
            if not torch.equal(out, plain):
                bad = int((out != plain).sum().item())
                errs["global_rescore"] = max(errs.get("global_rescore", 0), bad)
                fail(f"B15 at W={out.shape[1]} C={args[0].shape[1]}: {bad} packed "
                     "values differ from rescore_plain")
            seen.append(args)
        return out

    gk.rescore_packed = checked
    try:
        yield
    finally:
        gk.rescore_packed = real


def b15_time(timer, args, reps: int) -> None:
    """``reps`` launches of B15 on ``args``, each timed alone."""
    from kueue_tpu_torch.ops import global_kernel as gk

    w, c = args[0].shape
    for _ in range(reps):
        timer("global_rescore", lambda: gk.rescore_packed(*args), None)
        timer.add_bytes({"global_rescore": [b15_bytes(w, c)]})


def b15_plain_ms(args, reps: int = 3) -> float:
    import torch

    from kueue_tpu_torch.ops import global_kernel as gk

    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gk.rescore_plain(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.mean(ms))


def federation_path(dev) -> dict:
    """14a and 14b: B15 in lockstep at the test cases and the two wide
    cells, timed there; the federation at bench.py's 50-worker stage on
    the card, its B15 launches counted, held and then timed."""
    import torch

    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.ops import global_kernel as gk
    from kueue_tpu_torch.ops import global_np as gnp
    from kueue_tpu_torch.perf import multikueue as pmk
    from kueue_tpu_torch.perf.cases import rescore_fleet

    errs = {"global_rescore": 0}
    plain_ms, seen = [], []
    # a. the test cases through the entry point, each equal to the mirror
    cases_ = b15_case_inputs()
    with b15_lockstep(errs, plain_ms, seen):
        for i, a in enumerate(cases_):
            got = gk.rescore_pairs(**a, device=dev)
            ref = gnp.rescore_np(**a)
            for f in ("best", "best_key", "gain_ms", "rebalance"):
                if not np.array_equal(getattr(got, f), getattr(ref, f)):
                    fail(f"B15 case {i}: {f} differs from global_np.rescore_np")
    n_case_launches = len(seen)
    print(f"{stamp()} B15 at the CPU tests' {len(cases_)} cases: {n_case_launches} launches "
          f"bit-exact to rescore_plain, every result equal to global_np.rescore_np")

    cells = {}
    for label, (w, c, seed) in B15_CELLS.items():
        a = rescore_fleet(np.random.default_rng(seed), w=w, c=c, invalid=0.25, n_degraded=4)
        seen.clear()
        with b15_lockstep(errs, plain_ms, seen):
            got = gk.rescore_pairs(**a, device=dev)
        ref = gnp.rescore_np(**a)
        for f in ("best", "best_key", "gain_ms", "rebalance"):
            if not np.array_equal(getattr(got, f), getattr(ref, f)):
                fail(f"B15 at {label}: {f} differs from global_np.rescore_np")
        args = gk.rescore_inputs(a["tta_ms"], a["score"], a["valid"], a["current"],
                                 a["rotation"], a["degraded"], dev) + (
            a["hysteresis_ms"], a["degraded_penalty_ms"])
        timer = TimedLaunches()
        b15_time(timer, args, 20)
        t = timing_of(timer, "global_rescore", {"global_rescore": [b15_plain_ms(args)]})
        t["shape"] = f"W={w} C={c}"
        t["rebalance_rows"] = int(got.rebalance.sum())
        t["uncovered"] = timer.uncovered
        cells[label] = t
        print(f"{stamp()} B15 at {label} (W={w} C={c}, 25% invalid, 4 degraded): "
              f"bit-exact; {t['ms'] * 1e3:.2f} us/launch on the device (mean of "
              f"{t['timed']}), plain {t['plain_ms']:.3f} ms, bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bytes']:.0f} B) = {100 * t['bound_ms'] / t['ms']:.1f}% of the bound")

    # b. the federation at bench.py's stage, every runtime on the card
    reports, fed_args = [], []
    with b15_lockstep(errs, plain_ms, fed_args):
        _build.reset_launches()
        t0 = time.perf_counter()
        res = pmk.run_federation_scale(n_workers=50, device=dev,
                                       on_scheduler=pmk.record_rescores(reports))
        torch.cuda.synchronize()
        fed_wall = time.perf_counter() - t0
        launches = _build.launch_counts()
    summary = pmk.fed_scale_summary(res)
    digest = pmk.rebalance_digest(reports)
    with_rows = [r for r in reports if r["pending"]]
    print(f"{stamp()} federation-50 on cuda: {json.dumps(summary)}; rescore passes with rows "
          f"at {[r['pending'] for r in with_rows]}, paths {[r['path'] for r in reports]}; "
          f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
    if summary != pmk.FED_SCALE_EXPECT:
        fail(f"federation-50 {summary} != FED_SCALE_EXPECT {pmk.FED_SCALE_EXPECT}")
    if digest != pmk.FED_REBALANCE_DIGEST:
        fail(f"federation-50 rebalance digest {digest} != {pmk.FED_REBALANCE_DIGEST}")
    if tuple(r["pending"] for r in with_rows) != pmk.FED_RESCORE_PENDING:
        fail(f"federation-50 rescored {[r['pending'] for r in with_rows]} pending rows")
    if any(r["path"] != "device" for r in with_rows):
        fail("a federation rescore with pending rows did not take the device path")
    if launches["global_rescore"] != len(pmk.FED_RESCORE_PENDING):
        fail(f"B15 launched {launches['global_rescore']} times on the federation path")
    timer = TimedLaunches()
    fed_plain = []
    for args in fed_args:
        b15_time(timer, args, 10)
        fed_plain.append(b15_plain_ms(args))
    timing = timing_of(timer, "global_rescore", {"global_rescore": fed_plain})
    print(f"{stamp()} federation-50 wall {fed_wall * 1e3:.1f} ms (virtual "
          f"{res.virtual_s} s, {res.passes} passes); fan-out pass {res.fanout_pass_ms:.1f} ms; "
          f"a rescore pass: aggregate {res.aggregate_ms_per_cycle:.3f} ms, rescore "
          f"{res.rescore_ms_per_cycle:.3f} ms (mean of {res.rescore_passes}); B15 on the "
          f"federation's own {len(fed_args)} inputs (W x C = "
          f"{[tuple(a[0].shape) for a in fed_args]}): {timing['ms'] * 1e3:.2f} us/launch, "
          f"plain {timing['plain_ms']:.3f} ms, bound {timing['bound_ms'] * 1e3:.4f} us")
    return {
        "errs": errs, "launches": launches, "timing": timing, "cells": cells,
        "case_launches": n_case_launches,
        "fed": {"wall_ms": fed_wall * 1e3, "summary": summary, "digest": digest,
                "fanout_pass_ms": res.fanout_pass_ms,
                "aggregate_ms_per_pass": res.aggregate_ms_per_cycle,
                "rescore_ms_per_pass": res.rescore_ms_per_cycle,
                "rescore_pending": [r["pending"] for r in with_rows]},
    }


def _drain_spans(rt) -> dict:
    """The drain traces' span seconds summed by name, in ms."""
    out = {}
    for t in rt.scheduler.last_traces:
        if t.resolution != "drain":
            continue
        for k, v in t.spans.items():
            out[k] = out.get(k, 0.0) + v * 1e3
    return {k: round(v, 3) for k, v in out.items()}


def runtime_stage(dev, label: str, seed: int, chunk: int, modes, expect: dict) -> dict:
    """One bench.py drain-loop stage on the card: each mode built from
    the same seed, its kernels' counters reset before its one
    ``bulk_drain`` and read after; every mode must give ``expect``."""
    from kueue_tpu_torch.ops import _build
    from kueue_tpu_torch.perf import runtime as prt

    out = {}
    for mode, mega in modes:
        t0 = time.perf_counter()
        rt = prt.build_drain_loop_rt(mode, seed, chunk=chunk, megaloop=mega, device=dev)
        build_s = time.perf_counter() - t0
        _build.reset_launches()
        wall = prt.drain_once(rt)
        launches = _build.launch_counts()
        summary = prt.admitted_summary(rt)
        health = rt.guard.health()
        name = f"{mode}" + (f"+megaloop{mega}" if mega != "off" else "")
        p, m = rt.pipeline.to_dict(), rt.megaloop.to_dict()
        dispatches = m["launches"] if mega != "off" else p["rounds"]
        print(f"{stamp()} {label} {name}: {json.dumps(summary)}; wall {wall * 1e3:.1f} ms "
              f"(build {build_s:.1f} s), {dispatches} dispatches; pipeline {json.dumps(p)}; "
              f"megaloop {json.dumps(m)}; drain spans (ms) {json.dumps(_drain_spans(rt))}; "
              f"launches {json.dumps({k: v for k, v in launches.items() if v})}")
        if summary != expect:
            fail(f"{label} {name}: {summary} != {expect}")
        if health["failovers"] or health["breaker"] != "closed" or health["deadlineBreaches"]:
            fail(f"{label} {name}: the guard failed over or breached: {health}")
        kernels = ("quota_tree", "drain_nominate", "drain_phase2", "drain_queue_motion")
        if mega != "off":
            kernels += ("megaloop_boundary",)
        for k in kernels:
            if launches[k] <= 0:
                fail(f"{label} {name}: kernel {k} was not launched")
        if mode == "on" and mega == "off" and (p["rounds"] < 2 or p["prefetches"] < 1):
            fail(f"{label} pipelined: {p['rounds']} rounds, {p['prefetches']} prefetches")
        if mega != "off" and m["launches"] < 1:
            fail(f"{label} {name}: no fused launch")
        out[name] = {"wall_ms": wall * 1e3, "build_s": build_s, "dispatches": dispatches,
                     "pipeline": p, "megaloop": m, "spans_ms": _drain_spans(rt),
                     "launches": launches}
        del rt
    return out


def runtime_path(dev) -> dict:
    """14c: the runtime's drain loops at bench.py's pipeline and
    megaloop stages."""
    from kueue_tpu_torch.perf import runtime as prt

    pipe = runtime_stage(dev, "runtime-drain-50k", prt.stage_seed(13), prt.PIPELINE_CHUNK,
                         (("serial", "off"), ("on", "off")), prt.RUNTIME_DRAIN_EXPECT)
    mega = runtime_stage(dev, "runtime-megaloop-50k", prt.stage_seed(17), prt.MEGALOOP_CHUNK,
                         (("serial", "off"), ("on", "off"), ("on", prt.MEGALOOP_K)),
                         prt.RUNTIME_MEGALOOP_EXPECT)
    s, m = mega["serial"], mega[f"on+megaloop{prt.MEGALOOP_K}"]
    if m["megaloop"]["rounds"] != s["pipeline"]["rounds"]:
        fail(f"megaloop committed {m['megaloop']['rounds']} rounds, serial ran "
             f"{s['pipeline']['rounds']}")
    # the sampled divergence check on the card (off in the stages, as
    # bench.py sets it): every committed round of a pipelined and a
    # fused drain replayed on the numpy mirror, which would raise
    checks = {}
    for label, mega_k in (("pipelined", "off"), ("megaloop", "4")):
        rt = prt.build_drain_loop_rt("on", 5, chunk=4, megaloop=mega_k, device=dev, n_cq=32,
                                     wl_per_cq=14, n_flavors=2, n_cohort=4)
        rt.guard.config.divergence_check_every = 1
        rt.run_until_idle()
        health = rt.guard.health()
        if not health["divergenceChecks"] or health["divergences"] or health["failovers"]:
            fail(f"sampled divergence {label}: {health}")
        checks[label] = health["divergenceChecks"]
    print(f"{stamp()} sampled divergence on the card (32 CQs x 14 workloads, chunk 4): "
          f"{json.dumps(checks)} rounds replayed on the numpy mirror, none differs")
    return {"runtime-drain-50k": pipe, "runtime-megaloop-50k": mega}


def trap_path() -> dict:
    """14d: a trapping B15 and a trapping drain kernel, each in a
    process of its own, must raise KernelError out of their loops."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from kueue_tpu_torch.perf import trap

    runs = (("global_rescore", trap.RESCORE_RUN), ("drain_nominate", trap.DRAIN_RUN))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(len(runs)) as pool:
        # the two processes run side by side, each on the card
        futures = {kernel: pool.submit(trap.run_trapped, kernel, script, Path(tmp) / kernel)
                   for kernel, script in runs}
        results = {kernel: f.result() for kernel, f in futures.items()}
    wall = time.perf_counter() - t0
    for kernel, run in results.items():
        if run.returncode != 0 or not run.stdout.startswith("KernelError True"):
            fail(f"a trapping {kernel} was not raised out of its loop: "
                 f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
        print(f"{stamp()} a trapping {kernel} raised out of its loop "
              f"({run.stdout.strip()[:160]})")
    print(f"{stamp()} the two trapped runs side by side: {wall:.1f} s")
    return {"wall_s": wall}


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: the port runs on the card")
    try:
        from kueue_tpu_torch.core.drain import plan_drain, run_drain
        from kueue_tpu_torch.interop import drain_queues
        from kueue_tpu_torch.core.snapshot import take_snapshot
        from kueue_tpu_torch.core.solver import tree_arrays
        from kueue_tpu_torch.ops import _build
        from kueue_tpu_torch.ops.drain_kernel import _solve_drain_packed
        from kueue_tpu_torch.perf.kernel_ab import smem_latency_ns
        from kueue_tpu_torch.perf import cases, headline
        from kueue_tpu_torch.perf.lockstep import DRAIN_KERNELS, lockstep
    except ImportError as exc:
        fail(f"kueue_tpu_torch is not importable here ({exc}); run from the repo root")

    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    # 1. build
    build_s = _build.build_all()
    print(f"build: {len(_build.KERNELS)} kernels in {build_s:.2f} s")
    for name in _build.KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    SMEM["ns"] = smem_latency_ns(dev, _build.BUILD_DIR)
    print(f"shared-memory load latency {SMEM['ns']:.3f} ns (one thread chasing pointers): "
          f"the serial kernels' chain bound is {TRIPS_PER_HEAD} such trips a walked head of "
          f"the longest segment")

    errs = {name: 0 for name in _build.KERNELS}

    # 2a. lockstep on the headline plan
    t0 = time.perf_counter()
    rng = np.random.default_rng(headline.HEADLINE_SEED)
    cache = headline.build_cluster(rng)
    pending = headline.build_backlog(rng)
    print(f"headline cluster + backlog: {len(pending)} workloads "
          f"({time.perf_counter() - t0:.1f} s)")
    snap = take_snapshot(cache)
    plan = plan_drain(snap, pending, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS)
    tree, paths, _ = tree_arrays(snap, dev)
    local = tree.nominal.new_tensor(snap.local_usage)
    queues = drain_queues(plan.queues_np, dev)
    print(f"headline plan: cells {tuple(plan.queues_np['cells'].shape)} "
          f"G={plan.queues_np['gidx'].shape[-1]} N={tree.n_nodes} "
          f"FR={tree.nominal.shape[1]} D={tree.max_depth} "
          f"n_segments={plan.n_segments} n_steps={plan.n_steps} "
          f"max_cycles={plan.max_cycles}")
    t0 = time.perf_counter()
    plain_ms = {}
    ctx0, _, cyc = lockstep(
        tree, local, queues, paths, plan.n_segments, plan.n_steps,
        plan.max_cycles, errs, label="headline", plain_ms=plain_ms,
    )
    print(f"{stamp()} lockstep headline: {cyc} cycles, every kernel bit-exact to its "
          f"plain version ({time.perf_counter() - t0:.1f} s)")
    if cyc != headline.HEADLINE_EXPECT["cycles"]:
        fail(f"lockstep headline ran {cyc} cycles")

    # 2b. lockstep on the small seeded case, with nonzero scores
    spec = cases.mixed_spec(SMALL_SEED)
    s_cache, s_pending = cases.build_cache(spec)
    s_snap = take_snapshot(s_cache)
    s_plan = plan_drain(s_snap, s_pending, s_cache.flavors)
    srng = np.random.default_rng(SMALL_SEED)
    s_plan.queues_np["score"] = srng.integers(-2, 3, size=s_plan.queues_np["score"].shape)
    s_tree, s_paths, _ = tree_arrays(s_snap, dev)
    s_local = s_tree.nominal.new_tensor(s_snap.local_usage)
    s_queues = drain_queues(s_plan.queues_np, dev)
    _, s_state, s_cyc = lockstep(
        s_tree, s_local, s_queues, s_paths, s_plan.n_segments,
        s_plan.n_steps, s_plan.max_cycles, errs, label="small",
    )
    n_stuck = int(s_state.stuck.sum())
    shape = tuple(s_plan.queues_np["cells"].shape)
    print(f"{stamp()} lockstep small case: cells {shape} D={s_tree.max_depth} "
          f"{s_cyc} cycles, {n_stuck} stuck queues, bit-exact")
    if shape[2] != 3 or s_tree.max_depth != 3 or n_stuck != 4 or s_cyc != SMALL_CYCLES_END:
        fail("the small case lost its coverage (P=3, depth 3, four stuck queues, "
             f"{SMALL_CYCLES_END} cycles)")

    # 2c. every launch of the headline drain timed on the device
    t_cyc, dtimer = timed_drain(ctx0, local, queues)
    if t_cyc != headline.HEADLINE_EXPECT["cycles"]:
        fail(f"timed headline drain ran {t_cyc} cycles")
    timing = {name: timing_of(dtimer, name, plain_ms) for name in DRAIN_KERNELS}
    kernel_ms = sum(t["device_ms_total"] for t in timing.values())
    print(f"{stamp()} timed headline drain: {t_cyc} cycles, "
          f"{sum(len(v) for v in dtimer.dev_ms.values())} launches each timed alone "
          f"on the device, {dtimer.uncovered} uncovered")

    # 3. the slice through its entry point
    _build.reset_launches()
    outcome = run_drain(
        take_snapshot(cache), pending, cache.flavors,
        max_cells=headline.HEADLINE_MAX_CELLS, device="cuda",
    )
    launches = _build.launch_counts()
    summary = headline.outcome_summary(outcome)
    print(f"{stamp()} run_drain on cuda: {json.dumps(summary)}; launches {json.dumps(launches)}")
    if summary != headline.HEADLINE_EXPECT:
        fail(f"headline drain {summary} != expected {headline.HEADLINE_EXPECT}")
    for name in DRAIN_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the main path")
    graph_ms, g_adm, g_cyc = drain_graph_ms(
        ctx0, local, queues, launches["drain_nominate"]
    )
    if (g_cyc, g_adm) != (summary["cycles"], summary["admitted"]):
        fail(f"the drain replayed as one graph gave {g_cyc} cycles, {g_adm} admitted")
    q, l, p, k, c = plan.queues_np["cells"].shape
    g = plan.queues_np["gidx"].shape[-1]
    n, fr = tree.nominal.shape
    shapes = {
        "quota_tree": f"N={n} FR={fr} D={tree.max_depth}",
        "drain_nominate": f"Q={q} L={l} P={p} K={k} C={c} G={g}",
        "drain_phase2": f"Q={q} segments={ctx0.segments.count} "
                        f"n_steps={plan.n_steps} P*C={p * c} D={tree.max_depth}",
        "drain_queue_motion": f"Q={q} L={l} P={p} G={g}",
    }
    for name in DRAIN_KERNELS:
        t = timing[name]
        print(f"kernel {name} [{shapes[name]}]: mean over the drain's {t['timed']} "
              f"launches with work: {t['ms'] * 1e3:.2f} us/launch on the device "
              f"({t['device_ms_total']:.3f} ms in all), {t['host_ms'] * 1e3:.2f} us/call "
              f"to enqueue on the host, plain {t['plain_ms']:.3f} ms/call, bound "
              f"{t['bound_ms'] * 1e3:.4f} us ({t['bytes']:.0f} B); main-path launches "
              f"{launches[name]}, max_abs_err {errs[name]}")

    walls = []
    for _ in range(3):
        s = take_snapshot(cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_drain(s, pending, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS,
                  device="cuda")
        walls.append(time.perf_counter() - t0)
    plans = []
    for _ in range(3):
        s = take_snapshot(cache)
        t0 = time.perf_counter()
        plan_drain(s, pending, cache.flavors, max_cells=headline.HEADLINE_MAX_CELLS)
        plans.append(time.perf_counter() - t0)
    solves = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat = _solve_drain_packed(tree, local, queues, paths, plan.n_segments,
                                   plan.n_steps, plan.max_cycles)
        flat.cpu()
        solves.append(time.perf_counter() - t0)
    wall_ms = float(np.median(walls)) * 1e3
    plan_ms = float(np.median(plans)) * 1e3
    solve_ms = float(np.median(solves)) * 1e3
    cycles = summary["cycles"]
    print(f"{stamp()} headline drain wall (run_drain, lowering included, median of 3): "
          f"{wall_ms:.1f} ms = {wall_ms / cycles:.3f} ms/cycle; of which "
          f"plan_drain (host lowering) {plan_ms:.1f} ms; solve (inputs on the "
          f"card, {cycles} cycles, one fetch) {solve_ms:.2f} ms = "
          f"{solve_ms / cycles:.4f} ms/cycle; the kernels' device time over "
          f"the {cycles} cycles (each launch timed alone) {kernel_ms:.3f} ms "
          f"= {100 * kernel_ms / wall_ms:.2f}% of the wall; "
          f"the drain's {launches['drain_nominate']} cycles of launches as one CUDA "
          f"graph, no host: {graph_ms:.3f} ms = {100 * graph_ms / solve_ms:.1f}% "
          f"of the solve")

    # 4. the megaloop chain; 5. the fair drain
    drain_launches = launches
    mega = megaloop_path(dev, cache, pending)
    fairr = fair_path(dev, cache, pending)
    for label, res in (("megaloop", mega), ("fair", fairr)):
        for name, t in res["timing"].items():
            print(f"kernel {name} [{label}]: mean over {t['timed']} launches with work: "
                  f"{t['ms'] * 1e3:.2f} us/launch on the device ({t['device_ms_total']:.3f} ms "
                  f"in all), {t['host_ms'] * 1e3:.2f} us/call to enqueue, plain "
                  f"{t['plain_ms']:.3f} ms/call, bound {t['bound_ms'] * 1e3:.4f} us "
                  f"({t['bytes']:.0f} B); main-path launches {res['launches'][name]}, "
                  f"max_abs_err {res['errs'][name]}")

    # 6. the interactive cycle
    cyc = cycle_path(dev)
    cerrs, ctiming, library = cyc["errs"], cyc["timing"], cyc["library"]
    cycle_launches = cyc["launches"]["cycle_headline"]
    small_launches = cyc["launches"]["cycle_small"]

    # 7. the contended cycle; 8. the contended drain
    pcyc = contended_cycle_path(dev)
    pdrain = contended_drain_path(dev)

    # 9. the fair cycle; 10. the fair-preempt drain
    fcyc = fair_cycle_path(dev)
    fdrain = fair_preempt_drain_path(dev)

    # 11. TAS pod counting and the TAS drain
    tasr = tas_path(dev)

    # 12. the planner (kernel B14) and the admission policies
    plan = planner_path(dev)
    pol = policy_path(dev)

    # 13. the mesh harness: ShardedSolver with B3', B1', every mesh= path
    walls = {
        "cycle_records": cyc["records"], "contended_env": pdrain["env"],
        "fair_preempt_env": fdrain["env"], "tas_env": tasr["env"], "drain": wall_ms,
        "fair": fairr["wall_ms"],
        "megaloop": sum(w["plan_ms"] + w["enqueue_ms"] + w["fetch_ms"] for w in mega["walls"]),
        "contended": pdrain["wall_ms"], "fair_preempt": fdrain["wall_ms"],
        "tas": tasr["wall_ms"],
    }
    meshr = mesh_path(dev, cache, pending, walls)

    # 14. the runtime's drain loops and the federation (kernel B15), after
    # dropping the earlier phases' clusters and freezing what stays, so
    # the garbage collector does not rescan them in phase 14's host loops
    for res in (pdrain, fdrain, tasr):
        res.pop("env", None)
    cyc.pop("records", None)
    del cache, pending, walls, snap, s_snap, s_plan, s_cache, s_pending, outcome
    gc.collect()
    gc.freeze()
    fedr = federation_path(dev)
    rtr = runtime_path(dev)
    trapr = trap_path()

    # 15. result lines
    by_path = {
        "drain": drain_launches, "megaloop": mega["launches"], "fair": fairr["launches"],
        "cycle_headline": cycle_launches, "cycle_small": small_launches,
        "contended_cycle": pcyc["launches"], "contended_drain": pdrain["launches"],
        "fair_cycle": fcyc["launches"], "fair_preempt_drain": fdrain["launches"],
        "fair_preempt_wide": fdrain["wide_launches"],
        "tas_drain": tasr["launches"], "tas_fleet": tasr["fleet_launches"],
        "planner_sweep": plan["launches"]["planner-sweep-50k"],
        "planner_stage": plan["launches"]["planner-stage-500"],
        "policy_first_fit": pol["launches"]["first_fit"],
        "policy_gavel": pol["launches"]["gavel"],
        **meshr["launches"],
        "federation": fedr["launches"],
        **{f"{stage}/{mode}": r["launches"] for stage, modes in rtr.items()
           for mode, r in modes.items()},
    }
    kernels = []
    for name in _build.KERNELS:
        if name in DRAIN_KERNELS:
            t, lib = timing[name], None
        elif name == "megaloop_boundary":
            t, lib = mega["timing"][name], None
        elif name == "drain_fair_phase2":
            t, lib = fairr["timing"][name], None
        elif name == "preempt_search":
            t, lib = pcyc["timing"][name], None
        elif name.startswith("drain_preempt_"):
            t, lib = pdrain["timing"][name], None
        elif name == "fair_search":
            t, lib = fcyc["timing"][name], None
        elif name.startswith("drain_fair_preempt_"):
            t, lib = fdrain["timing"][name], None
        elif name.startswith("drain_tas_"):
            t, lib = tasr["timing"][name], None
        elif name == "tas_leaf_counts":
            # the main path's entry: leaf_counts at tas-fleet-131k
            t, lib = tasr["b12"]["tas-fleet-131k"]["leaf_counts"], None
        elif name.startswith("plan_"):
            # the planner's full-width path: planner-sweep-50k
            t, lib = plan["cells"]["planner-sweep-50k"]["timing"][name], None
        elif name in ("cycle_global", "quota_drs"):
            t, lib = meshr["timing"][name], None
        elif name == "global_rescore":
            # the main path's entry: the federation's own B15 inputs
            t, lib = fedr["timing"], None
        else:
            t, lib = ctiming[name], library.get(name)
        entry = {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {k: c[name] for k, c in by_path.items()},
            "max_abs_err": max(r.get(name, 0) for r in (errs, cerrs, mega["errs"], fairr["errs"],
                                                         pcyc["errs"], pdrain["errs"],
                                                         fcyc["errs"], fdrain["errs"],
                                                         tasr["errs"], plan["errs"],
                                                         pol["errs"], meshr["errs"],
                                                         fedr["errs"])),
            "ms": t["ms"],
            "device_ms_total": t["device_ms_total"],
            "host_ms": t["host_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": lib,
        }
        for label, res in (("megaloop", mega), ("fair", fairr), ("contended_drain", pdrain),
                           ("fair_preempt_drain", fdrain), ("tas_drain", tasr)):
            if name in res["timing"] and (name in DRAIN_KERNELS
                                          or name == "drain_preempt_motion" and res is fdrain):
                entry.setdefault("ms_by_path", {})[label] = res["timing"][name]["ms"]
        if name in fdrain["wide_timing"]:
            w = fdrain["wide_timing"][name]
            entry["at_panel_caps"] = {"shape": fdrain["wide_shape"], "ms": w["ms"],
                                      "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
                                      "launches": fdrain["wide_launches"][name]}
        if name == "tas_leaf_counts":
            entry["entry_points"] = {
                label: {
                    entry_name: {k: row[entry_name][k] for k in (
                        "ms", "plain_ms", "bound_ms", "bytes", "library_ms") if k in
                        row[entry_name]}
                    for entry_name in ("leaf_counts", "level_counts")
                } | {"shape": row["shape"]}
                for label, row in tasr["b12"].items()
            }
            entry["countin_ms"] = tasr["crossover"]
        if name.startswith("plan_"):
            st = plan["cells"]["planner-stage-500"]["timing"][name]
            entry["at_planner_stage"] = {k: st[k] for k in ("ms", "plain_ms", "bound_ms")}
        if name == "global_rescore":
            entry["at_cells"] = {label: {k: c[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                                           "bytes", "timed")}
                                 for label, c in fedr["cells"].items()}
            entry["case_launches"] = fedr["case_launches"]
        if name == "cycle_global":
            b3 = meshr["b3_same_heads"]
            entry["b3_same_heads"] = {k: b3[k] for k in ("ms", "bound_ms", "bytes")}
        if "chain_bound_ms" in t:
            entry["chain_bound_ms"] = t["chain_bound_ms"]
            entry["chain_heads"] = t["chain_heads"]
        kernels.append(entry)
    print("chain bounds (us a launch; walked heads of the longest segment x "
          f"{TRIPS_PER_HEAD} x {SMEM['ns']:.3f} ns): " + json.dumps(
              {e["name"]: [round(e["chain_bound_ms"] * 1e3, 4), e["chain_heads"]]
               for e in kernels if "chain_bound_ms" in e}))
    if len(kernels) != 25:
        fail(f"{len(kernels)} kernels in the result line")
    print(json.dumps({"kernels": kernels, "smem_latency_ns": SMEM["ns"],
                      "wall_ms": wall_ms, "plan_ms": plan_ms,
                      "solve_ms": solve_ms, "kernels_device_ms": kernel_ms,
                      "drain_graph_ms": graph_ms, "cycles": cycles,
                      "megaloop_walls": mega["walls"], "megaloop_serial_ms": mega["serial_ms"],
                      "fair_wall_ms": fairr["wall_ms"], "fair_solve_ms": fairr["solve_ms"],
                      "fair_cycles": fairr["cycles"],
                      "cycle_ms": cyc["cycle_ms"], "cycle_max_ms": cyc["cycle_max_ms"],
                      "cycle_solve_device_ms": cyc["solve_dev"],
                      "contended_cycle_ms": pcyc["cycle_ms"],
                      "contended_drain_wall_ms": pdrain["wall_ms"],
                      "contended_drain_plan_ms": pdrain["plan_ms"],
                      "contended_drain_solve_ms": pdrain["solve_ms"],
                      "contended_drain_cycles": pdrain["cycles"],
                      "contended_panels": pdrain["panels"],
                      "fair_cycle_ms": fcyc["cycle_ms"],
                      "fair_quiescence_calls": fcyc["quiescence_calls"],
                      "fair_search_bench_us": fcyc["bench_batch_us"],
                      "fair_search_cap_us": fcyc["cap_batch_us"],
                      "fair_search_tiers": fcyc["tiers"],
                      "fair_preempt_drain_wall_ms": fdrain["wall_ms"],
                      "fair_preempt_drain_plan_ms": fdrain["plan_ms"],
                      "fair_preempt_drain_solve_ms": fdrain["solve_ms"],
                      "fair_preempt_drain_cycles": fdrain["cycles"],
                      "tas_drain_wall_ms": tasr["wall_ms"],
                      "tas_drain_plan_ms": tasr["plan_ms"],
                      "tas_drain_solve_ms": tasr["solve_ms"],
                      "tas_drain_kernels_ms": tasr["kernel_ms"],
                      "tas_drain_cycles": tasr["cycles"],
                      "planner": {label: {k: v for k, v in c.items() if k != "timing"}
                                  for label, c in plan["cells"].items()},
                      "policy_drain_walls_ms": pol["walls"],
                      "policy_forecast_s": pol["forecast_s"],
                      "mesh": {"walls_ms": meshr["walls"],
                               "sharded_solve_ms": meshr["sharded_solve_ms"],
                               "drs": meshr["drs"], "buckets": meshr["buckets"],
                               "place_s": meshr["place_s"]},
                      "federation": fedr["fed"],
                      "runtime": {stage: {mode: {k: v for k, v in r.items() if k != "launches"}
                                          for mode, r in modes.items()}
                                  for stage, modes in rtr.items()},
                      "trap_s": trapr}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
