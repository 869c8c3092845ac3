"""Workload heap of the pending queues (port of
kueue_tpu/utils/native_heap.py).

The reference prefers a C++ heap from ``native/`` and falls back to its
pure-Python twin, which orders identically: (priority desc, timestamp
asc, FIFO), ranks frozen at push. The port binds no native library yet,
so ``make_workload_heap`` always returns the Python heap; its pop order
equals the reference's on the same pushes.
"""

from __future__ import annotations

from typing import Callable, Dict


class PyWorkloadHeap:
    """Pure-Python twin of NativeWorkloadHeap with IDENTICAL semantics:
    ranks are frozen at push time (an entry reorders only when
    re-pushed — priority-class changes requeue workloads, exactly like
    the reference reacting to priority-class events) and updates take a
    fresh FIFO sequence number."""

    def __init__(
        self,
        key_fn: Callable[[object], str],
        priority_fn: Callable[[object], int],
        timestamp_fn: Callable[[object], float],
    ):
        import heapq

        self._heapq = heapq
        self._key_fn = key_fn
        self._priority_fn = priority_fn
        self._timestamp_fn = timestamp_fn
        self._heap: list = []  # (-prio, ts_ns, seq, key)
        self._live: Dict[str, tuple] = {}  # key -> current rank tuple
        self._values: Dict[str, object] = {}
        self._seq = 0

    def _rank(self, item) -> tuple:
        return (
            -int(self._priority_fn(item)),
            int(self._timestamp_fn(item) * 1e9),
        )

    def __len__(self) -> int:
        return len(self._live)

    def __contains__(self, key: str) -> bool:
        return key in self._live

    def keys(self):
        return list(self._live)

    def items(self):
        return [self._values[k] for k in self._live]

    def _push_entry(self, key: str, rank: tuple, item) -> None:
        entry = (rank[0], rank[1], self._seq, key)
        self._seq += 1
        self._live[key] = entry
        self._values[key] = item
        self._heapq.heappush(self._heap, entry)

    def push_if_not_present(self, item) -> bool:
        key = self._key_fn(item)
        if key in self._live:
            return False
        self._push_entry(key, self._rank(item), item)
        return True

    def push_or_update(self, item) -> None:
        key = self._key_fn(item)
        self._live.pop(key, None)  # lazy-delete the old entry
        self._push_entry(key, self._rank(item), item)

    def delete(self, key: str) -> bool:
        if key not in self._live:
            return False
        del self._live[key]
        del self._values[key]
        return True

    def get_by_key(self, key: str):
        return self._values.get(key) if key in self._live else None

    def _drop_dead(self) -> None:
        while self._heap and self._live.get(self._heap[0][3]) != self._heap[0]:
            self._heapq.heappop(self._heap)

    def peek(self):
        self._drop_dead()
        return self._values.get(self._heap[0][3]) if self._heap else None

    def pop(self):
        self._drop_dead()
        if not self._heap:
            return None
        entry = self._heapq.heappop(self._heap)
        key = entry[3]
        del self._live[key]
        return self._values.pop(key)


def make_workload_heap(
    key_fn: Callable[[object], str],
    priority_fn: Callable[[object], int],
    timestamp_fn: Callable[[object], float],
):
    """The pending-queue heap: (priority desc, timestamp asc, FIFO),
    ranks frozen at push."""
    return PyWorkloadHeap(key_fn, priority_fn, timestamp_fn)
