"""Topology — ordered node-label levels for Topology-Aware Scheduling.

Mirrors apis/kueue/v1alpha1/topology_types.go:82-110: an ordered list of
node label keys from widest to narrowest domain (e.g. block -> rack ->
hostname). On TPU the levels map onto mesh axes (superpod -> pod ->
chip).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class TopologyLevel:
    node_label: str


@dataclass
class Topology:
    name: str
    levels: Tuple[TopologyLevel, ...]

    def __post_init__(self):
        if not self.name:
            raise ValueError("Topology.name is required")
        if not self.levels:
            raise ValueError("Topology requires at least one level")
        keys = [lv.node_label for lv in self.levels]
        if len(set(keys)) != len(keys):
            raise ValueError("Topology levels must be unique")

    def level_keys(self) -> Tuple[str, ...]:
        return tuple(lv.node_label for lv in self.levels)
