"""Generic keyed heap with in-place update and delete.

Behavioral equivalent of the reference's ``pkg/util/heap/heap.go``:
a binary heap addressable by string key supporting PushIfNotPresent,
PushOrUpdate, Delete, GetByKey, Peek and Pop. Uses lazy deletion plus an
entry-version guard so updates are O(log n) amortized without the
sift-by-index bookkeeping the Go code does.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, Generic, List, Optional, Tuple, TypeVar

T = TypeVar("T")


class Heap(Generic[T]):
    """Keyed min-heap ordered by a user-provided ``less`` comparison.

    ``key_fn`` extracts the identity key; ``less`` returns True when its
    first argument should pop before the second. Internally items are
    wrapped with a monotonic sequence number so comparisons never reach
    the payload (mirrors heap.go's interface-based lessFunc contract).
    """

    def __init__(self, key_fn: Callable[[T], str], less: Callable[[T, T], bool]):
        self._key_fn = key_fn
        self._less = less
        self._items: Dict[str, "_Entry[T]"] = {}
        self._heap: List["_Entry[T]"] = []
        self._seq = itertools.count()
        self._dead = 0

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def keys(self):
        return self._items.keys()

    def items(self):
        return [e.value for e in self._items.values()]

    def push_if_not_present(self, item: T) -> bool:
        key = self._key_fn(item)
        if key in self._items:
            return False
        self._push(key, item)
        return True

    def push_or_update(self, item: T) -> None:
        key = self._key_fn(item)
        if key in self._items:
            self._kill(self._items[key])
        self._push(key, item)

    def delete(self, key: str) -> bool:
        entry = self._items.pop(key, None)
        if entry is None:
            return False
        self._kill(entry)
        return True

    def get_by_key(self, key: str) -> Optional[T]:
        entry = self._items.get(key)
        return entry.value if entry else None

    def peek(self) -> Optional[T]:
        self._drop_dead()
        return self._heap[0].value if self._heap else None

    def pop(self) -> Optional[T]:
        self._drop_dead()
        if not self._heap:
            return None
        entry = heapq.heappop(self._heap)
        del self._items[entry.key]
        return entry.value

    # internal -----------------------------------------------------------
    def _push(self, key: str, item: T) -> None:
        entry = _Entry(item, key, next(self._seq), self._less)
        self._items[key] = entry
        heapq.heappush(self._heap, entry)

    def _kill(self, entry: "_Entry[T]") -> None:
        entry.alive = False
        self._dead += 1
        # Compact when dead entries dominate so repeated updates between
        # pops can't grow the backing list unboundedly.
        if self._dead > len(self._items) and self._dead > 64:
            self._heap = [e for e in self._heap if e.alive]
            heapq.heapify(self._heap)
            self._dead = 0

    def _drop_dead(self) -> None:
        while self._heap and not self._heap[0].alive:
            heapq.heappop(self._heap)
            self._dead -= 1


class _Entry(Generic[T]):
    __slots__ = ("value", "key", "seq", "alive", "_less")

    def __init__(self, value: T, key: str, seq: int, less):
        self.value = value
        self.key = key
        self.seq = seq
        self.alive = True
        self._less = less

    def __lt__(self, other: "_Entry[T]") -> bool:
        if self._less(self.value, other.value):
            return True
        if self._less(other.value, self.value):
            return False
        return self.seq < other.seq
