"""The goodput ledger — where did the wall-clock actually go?

A training pass (or a serving scheduler loop) spends its wall time in
five places, and only one of them is the chip doing useful work:

* ``compile``   — CUDA graph captures (with the eager first run of
  their key) and the kernels' first-use builds, reported by
  ``core/graphs.py`` and ``ops/_build.py``; stolen out of whatever
  bucket they fired inside so nothing double-counts;
* ``host_input`` — waiting on the reader/feeder for the next batch, or
  assembling an admission group;
* ``device``    — dispatching device work and blocking on its result
  (under async dispatch the execution time surfaces wherever the host
  first blocks — the training and serving loops put that block in this
  bucket);
* ``host_sync`` — host-side bookkeeping on results (token collection,
  loss reads, evaluator updates);
* ``idle``      — everything else inside the open window (event
  handlers, logging, scheduler waits), computed at close as
  ``wall - sum(buckets)``.

Exported as ``goodput.<bucket>_seconds_total`` counters (labelled
``component=trainer|v2_sgd|serving``) plus the ``goodput.ratio`` gauge —
``device / wall`` over the window, the number the Ascend field study
calls goodput. One ledger is open per loop; concurrent loops
(a trainer and a serving engine under one session) sum into the same
counters under their own component label.

Everything is injectable for tests: ``GoodputLedger(registry=...,
clock=fake)`` runs the whole bucket accounting with no real sleeps.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

BUCKETS = ("compile", "host_input", "device", "host_sync", "idle")

#: minimum seconds between live ratio-gauge refreshes
_RATIO_WINDOW_S = 0.25

# per-thread stack of open ledgers: the capture hook forwards a
# compile duration to the ledger(s) open on the COMPILING thread, which
# is the thread whose bucket the compile time is hiding inside
_tls = threading.local()


def _open_stack() -> List["GoodputLedger"]:
    st = getattr(_tls, "ledgers", None)
    if st is None:
        st = _tls.ledgers = []
    return st


class GoodputLedger:
    """One open accounting window over a loop's wall time."""

    def __init__(self, registry, component: str = "run",
                 clock=time.monotonic):
        self.registry = registry
        self.component = component
        self.clock = clock
        self.totals: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self._t_open: Optional[float] = None
        self._t_ratio = 0.0
        self._lock = threading.Lock()
        # innermost open bucket per thread: (name, stolen_seconds) —
        # compile notes steal from it so the bucket reports its OWN time
        self._bucket_tls = threading.local()

    # -- lifecycle -----------------------------------------------------
    def open(self) -> "GoodputLedger":
        self._t_open = self.clock()
        _open_stack().append(self)
        return self

    def close(self) -> None:
        """Close the window: everything not accounted becomes ``idle``,
        and the ratio gauge gets its final value."""
        st = _open_stack()
        if self in st:
            st.remove(self)
        if self._t_open is None:
            return
        wall = max(self.clock() - self._t_open, 0.0)
        with self._lock:
            accounted = sum(self.totals.values()) - self.totals["idle"]
            idle = max(wall - accounted, 0.0)
            self.totals["idle"] += idle
        if idle:
            self._counter("idle").inc(idle)
        self._set_ratio(wall)
        self._t_open = None

    @contextmanager
    def window(self):
        self.open()
        try:
            yield self
        finally:
            self.close()

    # -- recording -----------------------------------------------------
    def _counter(self, bucket: str):
        return self.registry.counter(
            f"goodput.{bucket}_seconds_total").labels(
                component=self.component)

    def add(self, bucket: str, seconds: float) -> None:
        if bucket not in BUCKETS:
            raise ValueError(f"unknown goodput bucket {bucket!r} "
                             f"(one of {BUCKETS})")
        seconds = max(float(seconds), 0.0)
        with self._lock:
            self.totals[bucket] += seconds
        self._counter(bucket).inc(seconds)
        if self._t_open is not None:
            now = self.clock()
            if now - self._t_ratio >= _RATIO_WINDOW_S:
                self._t_ratio = now
                self._set_ratio(max(now - self._t_open, 0.0))

    @contextmanager
    def bucket(self, name: str):
        """Time a region into ``name``; compile seconds noted while it is
        open are STOLEN from it (they land in ``compile`` instead)."""
        tls = self._bucket_tls
        prev = getattr(tls, "top", None)
        tls.top = frame = [name, 0.0]
        t0 = self.clock()
        try:
            yield
        finally:
            t1 = self.clock()
            dur = t1 - t0 - frame[1]
            tls.top = prev
            if prev is not None:
                # a nested bucket's whole span (incl. its stolen compile
                # time) is not the OUTER bucket's own time either
                prev[1] += t1 - t0
            self.add(name, dur)

    def note_compile(self, seconds: float) -> None:
        """A backend compile ran inside this window (a graph capture or a kernel build):
        account it to ``compile`` and steal it from the innermost open
        bucket on this thread so the wall second is counted once."""
        seconds = max(float(seconds), 0.0)
        frame = getattr(self._bucket_tls, "top", None)
        if frame is not None:
            frame[1] += seconds
        self.add("compile", seconds)

    # -- derivation ----------------------------------------------------
    def _set_ratio(self, wall: float) -> None:
        if wall <= 0:
            return
        with self._lock:
            device = self.totals["device"]
        self.registry.gauge("goodput.ratio").set(
            min(device / wall, 1.0), component=self.component)

    def ratio(self) -> Optional[float]:
        """device / wall over the window so far (None before open)."""
        if self._t_open is None:
            return None
        wall = self.clock() - self._t_open
        if wall <= 0:
            return None
        with self._lock:
            return min(self.totals["device"] / wall, 1.0)


# -- module surface (what instrumented loops call) -----------------------------

def open_ledger(component: str, clock=time.monotonic
                ) -> Optional[GoodputLedger]:
    """Open a goodput window on the installed session's registry; None
    (and zero cost) when no session is installed."""
    from . import session
    s = session()
    if s is None:
        return None
    return GoodputLedger(s.registry, component=component,
                         clock=clock).open()


def note_compile(seconds: float) -> None:
    """Forward one backend-compile duration to the ledger(s) open on the
    current thread — called by ``core/graphs.py``'s capture hook and
    ``ops/_build.py``. Cheap no-op when none is open."""
    st = getattr(_tls, "ledgers", None)
    if not st:
        return
    for ledger in st:
        ledger.note_compile(seconds)


@contextmanager
def maybe_bucket(ledger: Optional[GoodputLedger], name: str):
    """``ledger.bucket(name)`` when a ledger is open, else a no-op — the
    one-liner instrumented loops use so the plane stays zero-cost off."""
    if ledger is None:
        yield
    else:
        with ledger.bucket(name):
            yield
