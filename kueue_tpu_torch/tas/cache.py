"""TASCache / TASFlavorCache — node & usage tracking per TAS flavor.

Reference: pkg/cache/tas_cache.go:64, tas_flavor.go. Nodes are ingested
(scraped in the reference by pkg/controller/tas/resource_flavor.go) and
filtered by the flavor's nodeLabels/taints; admitted TAS workloads'
topology assignments charge usage against leaf domains; ``snapshot()``
produces the immutable per-cycle TASFlavorSnapshot (whose fleet-size
leaf counts run on ``device``: the card unless the caller names the
CPU).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kueue_tpu_torch.models import ResourceFlavor, Workload
from kueue_tpu_torch.models.topology import Topology
from kueue_tpu_torch.tas.snapshot import TASFlavorSnapshot, domain_id


@dataclass
class Node:
    """The slice of corev1.Node that TAS consumes."""

    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    allocatable: Dict[str, int] = field(default_factory=dict)
    taints: Tuple = ()
    ready: bool = True
    # usage by pods not managed via TAS (static pods, daemonsets...)
    non_tas_usage: Dict[str, int] = field(default_factory=dict)


class TASFlavorCache:
    """Per-flavor node set + admitted TAS usage (tas_flavor.go)."""

    def __init__(self, flavor: ResourceFlavor, topology: Topology):
        self.flavor = flavor
        self.topology = topology
        self.level_keys: Tuple[str, ...] = topology.level_keys()
        self.nodes: Dict[str, Node] = {}
        # leaf domain id -> accumulated usage / pod count
        self._usage: Dict[str, Dict[str, int]] = {}
        self._usage_counts: Dict[str, int] = {}

    def node_matches(self, node: Node) -> bool:
        """Flavor nodeLabels must be a subset of the node's labels."""
        return all(node.labels.get(k) == v for k, v in self.flavor.node_labels.items())

    def add_or_update_node(self, node: Node) -> None:
        if self.node_matches(node):
            self.nodes[node.name] = node
        else:
            self.nodes.pop(node.name, None)

    def delete_node(self, name: str) -> None:
        self.nodes.pop(name, None)

    # ---- usage lifecycle (cache.AddOrUpdateWorkload TAS side) ----
    def charge_entries(self, wl: Workload) -> List[Tuple[str, Dict[str, int], int]]:
        """(domain id, usage delta, pod count) entries this workload's
        admission charges against this flavor's domains."""
        out: List[Tuple[str, Dict[str, int], int]] = []
        if wl.admission is None:
            return out
        podsets = {ps.name: ps for ps in wl.pod_sets}
        for psa in wl.admission.pod_set_assignments:
            ta = psa.topology_assignment
            if ta is None:
                continue
            if self.flavor.name not in set(psa.flavors.values()):
                continue
            ps = podsets.get(psa.name)
            if ps is None:
                continue
            for dom in ta.domains:
                out.append(
                    (
                        domain_id(dom.values),
                        {r: v * dom.count for r, v in ps.requests.items()},
                        dom.count,
                    )
                )
        return out

    def apply_entries(
        self, entries: List[Tuple[str, Dict[str, int], int]], sign: int
    ) -> None:
        for did, usage, count in entries:
            acc = self._usage.setdefault(did, {})
            for r, v in usage.items():
                acc[r] = acc.get(r, 0) + sign * v
            self._usage_counts[did] = self._usage_counts.get(did, 0) + sign * count

    def add_usage(self, wl: Workload) -> None:
        self.apply_entries(self.charge_entries(wl), +1)

    def remove_usage(self, wl: Workload) -> None:
        self.apply_entries(self.charge_entries(wl), -1)

    # ---- snapshot (tas_flavor.go snapshot build) ----
    def snapshot(self, device=None) -> TASFlavorSnapshot:
        snap = TASFlavorSnapshot(
            topology_name=self.topology.name,
            level_keys=self.level_keys,
            tolerations=tuple(self.flavor.tolerations),
            device=device,
        )
        for node in self.nodes.values():
            if not node.ready:
                continue
            did = snap.add_node(node.labels, node.allocatable, node.taints)
            if node.non_tas_usage:
                snap.add_non_tas_usage(did, node.non_tas_usage)
        for did, usage in self._usage.items():
            snap.add_tas_usage(did, usage, 0)
            # pod counts are carried inside usage via PODS accumulation
        for did, count in self._usage_counts.items():
            if count:
                snap.add_tas_usage(did, {}, count)
        snap.freeze()
        return snap


class TASCache:
    """All TAS flavors (pkg/cache/tas_cache.go:64)."""

    def __init__(self):
        self.flavors: Dict[str, TASFlavorCache] = {}
        self.topologies: Dict[str, Topology] = {}
        self._nodes: Dict[str, Node] = {}
        # Charge ledger: wl key -> {flavor: entries charged}. Release
        # reads the ledger, not the passed workload object, so a stale
        # caller copy (different admission/topology than what was
        # charged) can't leave residual or negative domain usage; also
        # makes add/remove idempotent under event replays.
        self._charged: Dict[str, Dict[str, list]] = {}
        # Every TAS-intent flavor ever seen, so a Topology arriving late
        # rebinds flavors added before it.
        self._flavor_objs: Dict[str, ResourceFlavor] = {}
        # Bumped on any mutation; consumers cache snapshots per generation.
        self.generation = 0

    @property
    def node_inventory(self) -> Dict[str, Node]:
        """The ingested node set (the control plane's wire surface and
        checkpoint read this — keep it public)."""
        return self._nodes

    def add_or_update_topology(self, topo: Topology) -> None:
        self.topologies[topo.name] = topo
        self.generation += 1
        # (re)bind any flavor referencing this topology — including ones
        # added before the topology existed
        for flavor in list(self._flavor_objs.values()):
            if flavor.topology_name == topo.name:
                self.add_or_update_flavor(flavor)

    def delete_topology(self, name: str) -> None:
        self.topologies.pop(name, None)
        self.generation += 1

    def add_or_update_flavor(self, flavor: ResourceFlavor) -> Optional[str]:
        """Track a TAS flavor; returns an error string when the
        referenced Topology is missing (CQ goes inactive with that
        reason in the reference)."""
        self.generation += 1
        if flavor.topology_name is None:
            self.flavors.pop(flavor.name, None)
            self._flavor_objs.pop(flavor.name, None)
            return None
        self._flavor_objs[flavor.name] = flavor
        topo = self.topologies.get(flavor.topology_name)
        if topo is None:
            self.flavors.pop(flavor.name, None)
            return f"topology {flavor.topology_name} not found"
        old = self.flavors.get(flavor.name)
        fc = TASFlavorCache(flavor, topo)
        if old is not None:
            fc._usage = old._usage
            fc._usage_counts = old._usage_counts
        self.flavors[flavor.name] = fc
        for node in self._nodes.values():
            fc.add_or_update_node(node)
        return None

    def delete_flavor(self, name: str) -> None:
        self.flavors.pop(name, None)
        self._flavor_objs.pop(name, None)
        self.generation += 1

    def add_or_update_node(self, node: Node) -> None:
        self._nodes[node.name] = node
        for fc in self.flavors.values():
            fc.add_or_update_node(node)
        self.generation += 1

    def delete_node(self, name: str) -> None:
        self._nodes.pop(name, None)
        for fc in self.flavors.values():
            fc.delete_node(name)
        self.generation += 1

    def add_usage(self, wl: Workload) -> None:
        if wl.key in self._charged:
            return
        ledger: Dict[str, list] = {}
        for name, fc in self.flavors.items():
            entries = fc.charge_entries(wl)
            if entries:
                fc.apply_entries(entries, +1)
                ledger[name] = entries
        self._charged[wl.key] = ledger
        # non-TAS workloads (empty ledger) change no domain state; don't
        # invalidate consumers' per-generation snapshot caches for them
        if ledger:
            self.generation += 1

    def remove_usage(self, wl: Workload) -> None:
        ledger = self._charged.pop(wl.key, None)
        if not ledger:
            return
        for name, entries in ledger.items():
            fc = self.flavors.get(name)
            if fc is not None:
                fc.apply_entries(entries, -1)
        self.generation += 1

    def snapshots(self, device=None) -> Dict[str, TASFlavorSnapshot]:
        return {name: fc.snapshot(device) for name, fc in self.flavors.items()}
