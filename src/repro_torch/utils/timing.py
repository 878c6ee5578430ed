"""Lightweight timing helpers used by profile measurement and benchmarks."""
from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Timer:
    """Accumulating wall-clock timer (seconds)."""

    total: float = 0.0
    count: int = 0
    _start: float = field(default=0.0, repr=False)

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._start
        self.total += dt
        self.count += 1
        return dt

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


@contextmanager
def timed(timer: Timer):
    timer.start()
    try:
        yield timer
    finally:
        timer.stop()
