"""LocalQueue — namespaced tenant queue pointing at one ClusterQueue.

Mirrors apis/kueue/v1beta1/localqueue_types.go:26-44. The clusterQueue
reference is immutable (enforced by the store, models are values).
"""

from __future__ import annotations

from dataclasses import dataclass

from kueue_tpu_torch.models.constants import StopPolicy


@dataclass
class LocalQueue:
    namespace: str
    name: str
    cluster_queue: str
    stop_policy: StopPolicy = StopPolicy.NONE

    def __post_init__(self):
        if not (self.namespace and self.name and self.cluster_queue):
            raise ValueError("LocalQueue requires namespace, name and clusterQueue")

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"
