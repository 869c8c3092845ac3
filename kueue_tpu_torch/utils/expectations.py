"""UID-set expectations store — create/observe synchronization barrier.

Reference: pkg/util/expectations/store.go:30. A controller that issues
writes (e.g. the topology ungater removing pod scheduling gates)
records the UIDs it acted on; the event handler marks them observed as
the informer echoes the updates back. Until every expected UID is
observed, reconciles for that key bail out — preventing double-acting
on stale cache state.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Set


class ExpectationsStore:
    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Lock()
        self._store: Dict[str, Set[str]] = {}

    def expect_uids(self, key: str, uids: Iterable[str]) -> None:
        with self._lock:
            self._store.setdefault(key, set()).update(uids)

    def observed_uid(self, key: str, uid: str) -> None:
        with self._lock:
            stored = self._store.get(key)
            if stored is None:
                return
            stored.discard(uid)
            if not stored:
                del self._store[key]

    def satisfied(self, key: str) -> bool:
        with self._lock:
            return key not in self._store

    def forget(self, key: str) -> None:
        with self._lock:
            self._store.pop(key, None)
