"""Scoped-timer statistics.

Analog of the reference's ``StatSet`` / ``REGISTER_TIMER*`` machinery
(paddle/utils/Stat.h:63-242), used along the whole train path
(TrainerInternal.cpp:94-152, NeuralNetwork.cpp:260). Python-side timers cover the host
loop. A copy of ``paddle_tpu/utils/stats.py``: while a
``utils/profiler`` trace is active a timer also opens
``profiler.annotate`` (a ``torch.profiler`` range and the obs span of its
name).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, NamedTuple


class StatSnapshot(NamedTuple):
    """Immutable point-in-time view of one timer — what :meth:`StatSet.items`
    hands out. The live :class:`StatItem` never leaves the lock: returning
    it let callers read ``total``/``count`` mid-update from another thread
    (torn averages) or mutate accumulator state they don't own."""

    name: str
    total: float
    count: int
    max: float
    avg: float


class StatItem:
    __slots__ = ("name", "total", "count", "max")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def add(self, seconds: float):
        self.total += seconds
        self.count += 1
        if seconds > self.max:
            self.max = seconds

    @property
    def avg(self) -> float:
        return self.total / self.count if self.count else 0.0

    def __repr__(self):
        return (f"Stat={self.name:<30} total={self.total * 1e3:10.2f}ms "
                f"avg={self.avg * 1e3:8.3f}ms max={self.max * 1e3:8.3f}ms count={self.count}")


class StatSet:
    """Accumulates named timers; thread-safe like the reference's global StatSet."""

    def __init__(self):
        self._items: Dict[str, StatItem] = {}
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        """Accumulate one sample under the lock — the only mutation path,
        so concurrent timers never race on a shared StatItem."""
        with self._lock:
            item = self._items.get(name)
            if item is None:
                item = self._items[name] = StatItem(name)
            item.add(seconds)

    @contextmanager
    def timer(self, name: str):
        from contextlib import nullcontext

        from . import profiler
        # named range on the device trace (REGISTER_TIMER_INFO analog)
        span = profiler.annotate(name) if profiler.is_active() \
            else nullcontext()
        t0 = time.perf_counter()
        with span:
            try:
                yield
            finally:
                self.add(name, time.perf_counter() - t0)

    def reset(self):
        with self._lock:
            self._items.clear()

    def report(self) -> str:
        with self._lock:
            lines = [repr(i) for i in sorted(self._items.values(), key=lambda i: -i.total)]
        return "\n".join(lines)

    def items(self) -> Dict[str, StatSnapshot]:
        """Immutable snapshots keyed by name (see :class:`StatSnapshot`)."""
        with self._lock:
            return {n: StatSnapshot(i.name, i.total, i.count, i.max, i.avg)
                    for n, i in self._items.items()}


GLOBAL_STATS = StatSet()
timer = GLOBAL_STATS.timer
