"""Fair-sharing admission ordering — lazy tournament iterator.

Equivalent of ``pkg/scheduler/fair_sharing_iterator.go:33-120``: when
fair sharing is enabled the scheduler does not sort entries once — it
pops them one at a time, and every pop re-evaluates DominantResourceShare
against the *current* snapshot (which earlier admissions in the same
cycle have already mutated via ``add_usage``). Each pop runs a
tournament over the picked entry's cohort tree:

- every remaining head in the tree simulates its own admission
  (usage addition), and its DRS — and the DRS of every ancestor cohort
  with that usage included — is recorded per (parent-cohort, workload),
- the tournament recursively nominates one winner per cohort node:
  children (CQs and sub-cohorts) are compared at their parent by the
  DRS value recorded for that parent level, with ties broken by
  priority (behind the PrioritySortingWithinCohort gate) then FIFO
  timestamp,
- the root's winner is yielded and removed; the next pop recomputes.

Like the reference's computeDRS, the per-head simulation only evaluates
the head's root-to-leaf path: the base usage tree is built once per pop
and the head's usage is bubbled up its path incrementally (O(depth x FR)
per head, not O(N x FR)); lendable capacity (potentialAvailable) depends
only on quota, so it is computed once per iterator.

Entries whose ClusterQueue has no cohort are yielded directly (no
tournament). Order across distinct cohort trees is unspecified in the
reference (Go map iteration); here it is deterministic: lowest original
entry index first.

Port of kueue_tpu/core/fair_sharing_iterator.py (host only: the
interactive cycle's admission order), imports rewritten.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Iterator, List, Tuple

import numpy as np

from kueue_tpu_torch.core.snapshot import Snapshot
from kueue_tpu_torch.ops.quota import DRS_MAX


def path_drs(
    snapshot: Snapshot,
    usage0: np.ndarray,
    pot: np.ndarray,
    row: int,
    vec: np.ndarray,
) -> List[Tuple[int, int]]:
    """DRS of ``row`` and each ancestor with ``vec`` added at ``row``,
    as [(node_row, dws)] leaf-to-root. Semantically identical to adding
    vec to local_usage and reading dominant_resource_share_np at the
    path rows (held to both in tests/test_torch_fair_sharing_iterator.py),
    but restricted to the path."""
    parent = snapshot.flat.parent
    resource_index = snapshot.resource_index
    n_res = len(snapshot.resource_names)
    out: List[Tuple[int, int]] = []
    node = row
    # bubble the addition up the path exactly like usage_tree_np: the
    # contribution to the parent is the over-guaranteed delta
    delta = vec
    while node >= 0:
        old = usage0[node]
        new = old + delta
        p = int(parent[node])
        borrowed_fr = np.maximum(0, new - snapshot.subtree[node])
        if p >= 0:
            borrowed = np.zeros(n_res, dtype=np.int64)
            np.add.at(borrowed, resource_index, borrowed_fr)
            lendable = np.zeros(n_res, dtype=np.int64)
            np.add.at(lendable, resource_index, pot[p])
            ratio = np.where(
                (borrowed > 0) & (lendable > 0),
                borrowed * 1000 // np.maximum(lendable, 1),
                -1,
            )
            if bool((borrowed > 0).any()):
                weight = int(snapshot.weight_milli[node])
                if weight == 0:
                    dws = DRS_MAX
                else:
                    num = int(ratio.max()) * 1000
                    dws = int(np.sign(num) * (abs(num) // max(weight, 1)))
            else:
                dws = 0
        else:
            dws = 0
        out.append((node, dws))
        if p >= 0:
            g = snapshot.guaranteed[node]
            delta = np.maximum(0, new - g) - np.maximum(0, old - g)
        node = p
    return out


def fair_sharing_iter(
    entries: List, snapshot: Snapshot, tie_key: Callable
) -> Iterator:
    """Yield entries in fair-sharing tournament order, re-evaluating DRS
    between pops. ``tie_key(e)`` must return the non-DRS comparison key
    (priority/FIFO), already accounting for feature gates."""
    # heads keyed by CQ row; deque guards against (unexpected) multiple
    # entries per CQ — the reference's map would silently overwrite.
    by_row: Dict[int, deque] = {}
    order_idx: Dict[int, int] = {}
    pending: List = []
    for i, e in enumerate(entries):
        order_idx[id(e)] = i
        if e.cq_name in snapshot.cq_models:
            by_row.setdefault(snapshot.row(e.cq_name), deque()).append(e)
        else:
            pending.append(e)  # unknown CQ: no tournament to run

    for e in pending:
        yield e

    parent = snapshot.flat.parent
    # tree topology and per-entry keys are fixed for the iterator's
    # lifetime — compute once, not per pop
    from kueue_tpu_torch.ops.assign_kernel import build_roots
    from kueue_tpu_torch.ops.quota_np import potential_available_all_np

    roots = build_roots(parent)
    n_cq = snapshot.flat.n_cq
    children: Dict[int, Tuple[List[int], List[int]]] = {}
    for i, p in enumerate(parent):
        p = int(p)
        if p >= 0:
            slot = children.setdefault(p, ([], []))
            slot[0 if i < n_cq else 1].append(i)
    pot = potential_available_all_np(
        parent, snapshot.flat.level_masks(), snapshot.subtree,
        snapshot.guaranteed, snapshot.borrowing_limit,
    )
    usage_cache: Dict[int, np.ndarray] = {}
    tie_cache: Dict[int, tuple] = {}

    def entry_usage(e) -> np.ndarray:
        vec = usage_cache.get(id(e))
        if vec is None:
            if e.assignment is not None:
                vec = snapshot.vector_of(e.assignment.usage)
            else:
                vec = np.zeros(len(snapshot.fr_list), dtype=np.int64)
            usage_cache[id(e)] = vec
        return vec

    def entry_tie(e) -> tuple:
        t = tie_cache.get(id(e))
        if t is None:
            t = tie_cache[id(e)] = tuple(tie_key(e))
        return t

    def compute_drs(root: int) -> Dict[Tuple[int, int], int]:
        """fair_sharing_iterator.go computeDRS: for every remaining head
        under ``root``, simulate its admission and record, at each
        ancestor cohort level, the DRS of the child node on the path
        (with the workload's usage included)."""
        drs: Dict[Tuple[int, int], int] = {}
        usage0 = snapshot.usage()  # shared base tree for this pop
        for row, dq in by_row.items():
            if not dq or roots[row] != root:
                continue
            e = dq[0]
            chain = path_drs(snapshot, usage0, pot, row, entry_usage(e))
            # value recorded at an ancestor = DRS of the child on the
            # path (the node one step below it)
            for (node, dws), (anc, _) in zip(chain, chain[1:]):
                drs[(anc, id(e))] = dws
        return drs

    def tournament(row: int, drs: Dict[Tuple[int, int], int]):
        """runTournament: one winner per cohort node, compared at this
        node by its recorded DRS, then tie_key, then original index."""
        cq_rows, cohort_rows = children.get(row, ([], []))
        candidates = []
        for cr in cohort_rows:
            w = tournament(cr, drs)
            if w is not None:
                candidates.append(w)
        for qr in cq_rows:
            dq = by_row.get(qr)
            if dq:
                candidates.append(dq[0])
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda e: (
                drs.get((row, id(e)), 0),
                entry_tie(e),
                order_idx[id(e)],
            ),
        )

    while by_row:
        # deterministic getCq: lowest original index among remaining heads
        first = min(
            (dq[0] for dq in by_row.values() if dq),
            key=lambda e: order_idx[id(e)],
        )
        row = snapshot.row(first.cq_name)
        if parent[row] < 0:
            winner = first
        else:
            winner = tournament(int(roots[row]), compute_drs(int(roots[row])))
            if winner is None:  # unreachable: first is in the tree
                winner = first
        wrow = snapshot.row(winner.cq_name)
        by_row[wrow].popleft()
        if not by_row[wrow]:
            del by_row[wrow]
        yield winner
