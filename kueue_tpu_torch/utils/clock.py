"""Injectable clock (k8s.io/utils/clock analog) for deterministic tests."""

from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        return time.time()


class FakeClock(Clock):
    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> None:
        self._now += seconds

    def set(self, t: float) -> None:
        self._now = t
