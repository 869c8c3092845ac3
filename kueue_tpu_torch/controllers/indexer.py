"""General field-index layer (pkg/controller/core/indexer/indexer.go).

The reference registers field indexes on the informer cache so list
calls can select by a computed key instead of scanning every object
(workload -> queue name, workload -> admitted ClusterQueue, workload ->
admission-check name, job -> owner UID; indexer.go:30-143, consumed by
e.g. pkg/queue/manager.go:175,271). This is the same idea decoupled
from any client: a registry of named extractor functions over one
object kind, maintaining value -> key posting sets incrementally on
every store mutation, O(1) add/delete per indexed value.

Extractors return a list of values (multi-value indexes such as
admission-check names are first-class, matching the reference's
client.MatchingFields over repeated keys).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Set


class FieldIndexer:
    def __init__(self) -> None:
        # field -> extractor(obj) -> [values]
        self._extractors: Dict[str, Callable[[object], List[str]]] = {}
        # field -> value -> {keys}
        self._postings: Dict[str, Dict[str, Set[str]]] = {}
        # key -> field -> [values]  (for incremental removal on update)
        self._by_key: Dict[str, Dict[str, List[str]]] = {}

    def register(self, field: str, extract: Callable[[object], List[str]]) -> None:
        """Register a named index. Must happen before objects are added
        (the reference requires indexes registered at manager setup,
        indexer.go:125-143); registering late raises to surface the
        ordering bug instead of serving a partial index."""
        if field in self._extractors:
            raise ValueError(f"index {field!r} already registered")
        if self._by_key:
            raise RuntimeError(
                f"index {field!r} registered after objects were added"
            )
        self._extractors[field] = extract
        self._postings[field] = {}

    # ---- store mutations ----
    def update(self, key: str, obj: object) -> None:
        self.delete(key)
        fields: Dict[str, List[str]] = {}
        for field, extract in self._extractors.items():
            values = [v for v in extract(obj) if v]
            if not values:
                continue
            fields[field] = values
            posting = self._postings[field]
            for v in values:
                posting.setdefault(v, set()).add(key)
        self._by_key[key] = fields

    def delete(self, key: str) -> None:
        fields = self._by_key.pop(key, None)
        if not fields:
            return
        for field, values in fields.items():
            posting = self._postings[field]
            for v in values:
                keys = posting.get(v)
                if keys is not None:
                    keys.discard(key)
                    if not keys:
                        del posting[v]

    # ---- queries ----
    def lookup(self, field: str, value: str) -> List[str]:
        """Keys whose extracted values contain ``value`` (sorted for
        deterministic iteration, the way reference list calls come back
        name-ordered from the cache)."""
        if field not in self._extractors:
            raise KeyError(f"unknown index {field!r}")
        return sorted(self._postings[field].get(value, ()))

    def values(self, field: str) -> List[str]:
        if field not in self._extractors:
            raise KeyError(f"unknown index {field!r}")
        return sorted(self._postings[field])

    def __len__(self) -> int:
        return len(self._by_key)


# Index names mirroring pkg/controller/core/indexer/indexer.go:23-28.
WORKLOAD_QUEUE_KEY = "spec.queueName"
WORKLOAD_CLUSTER_QUEUE_KEY = "status.admission.clusterQueue"
WORKLOAD_ADMISSION_CHECK_KEY = "status.admissionChecks"


def _wl_queue(wl) -> List[str]:
    return [f"{wl.namespace}/{wl.queue_name}"] if wl.queue_name else []


def _wl_cluster_queue(wl) -> List[str]:
    adm = getattr(wl, "admission", None)
    return [adm.cluster_queue] if adm is not None else []


def _wl_admission_checks(wl) -> List[str]:
    return sorted(getattr(wl, "admission_check_states", {}) or {})


def workload_indexer() -> FieldIndexer:
    """The standard workload index set (indexer.go SetupIndexes)."""
    ix = FieldIndexer()
    ix.register(WORKLOAD_QUEUE_KEY, _wl_queue)
    ix.register(WORKLOAD_CLUSTER_QUEUE_KEY, _wl_cluster_queue)
    ix.register(WORKLOAD_ADMISSION_CHECK_KEY, _wl_admission_checks)
    return ix
