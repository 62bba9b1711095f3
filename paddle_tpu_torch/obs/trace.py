"""Span tracer: structured timing events with parent/child nesting.

The tracing half of the observability plane. A :class:`Tracer` records
*spans* — named intervals with monotonic timestamps, the recording thread's
id, and the id of the enclosing span on the same thread — plus *instant*
point events. The event stream exports to Chrome ``trace_event`` JSON
(viewable in Perfetto / chrome://tracing, where same-thread containment
renders the nesting) via :mod:`paddle_tpu_torch.obs.export`.

Two disciplines inherited from the rest of the runtime:

* **injectable clock** — tests drive a fake counter so span durations are
  exact and nothing sleeps (the utils/retry.py clock discipline);
* **per-thread parent stack** — nesting is attributed by the *recording*
  thread (checkpoint writers and prefetch workers each get their own
  lane), matching how Perfetto lays tracks out.

Unlike ``utils.profiler`` (which drives ``torch.profiler``), these
spans are host-side and structured: they survive as plain dicts, so the
JSONL dump, the Chrome exporter and test assertions all read one format.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional


class Tracer:
    """Collects span/instant events; thread-safe; clock injectable.

    ``max_events`` bounds host memory: a long training run records ~5
    events per batch, and an unbounded list would eventually OOM the job
    the tracer is observing. Past the cap new events are dropped and
    tallied in :attr:`dropped` (surfaced in the dump meta) — the trace
    keeps the run's beginning, the metrics registry keeps counting
    everything."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 max_events: int = 250_000, ring_size: int = 0):
        self.clock = clock or time.perf_counter
        self.events: List[Dict[str, Any]] = []
        self.max_events = max_events
        self.dropped = 0
        # RLock, not Lock: the flight recorder's SIGTERM handler runs on
        # the main thread and snapshots this tracer — if the signal lands
        # while that same thread is inside _record's critical section, a
        # plain Lock would deadlock the dying process instead of dumping
        self._lock = threading.RLock()
        self._local = threading.local()
        self._next_id = 1
        self.pid = os.getpid()
        #: flight-recorder tail (obs/flight.py): a bounded deque of the LAST
        #: ring_size events — the main list keeps the run's *beginning* when
        #: it fills, the ring keeps its *end*, which is what a post-mortem
        #: wants. None (the default) costs one is-None check per record.
        self.ring: Optional[Deque[Dict[str, Any]]] = (
            collections.deque(maxlen=ring_size) if ring_size else None)

    # -- internals ----------------------------------------------------------
    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _new_id(self) -> int:
        with self._lock:
            i = self._next_id
            self._next_id += 1
            return i

    def _record(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if self.ring is not None:
                # the ring ALWAYS appends (evicting its oldest) — a crash
                # after max_events must still leave the final spans behind
                self.ring.append(ev)
            if len(self.events) >= self.max_events:
                self.dropped += 1
                return
            self.events.append(ev)

    # -- recording ----------------------------------------------------------
    def span(self, name: str, remote: Optional[Dict[str, Any]] = None,
             **attrs) -> "_Span":
        """Context manager recording one interval event on exit.

        ``remote`` is a sanitized wire context (obs/context.py): the span
        event then carries a ``remote`` field naming its cross-process
        parent — the client span the request travelled in."""
        return _Span(self, name, attrs, remote=remote)

    def instant(self, name: str, **attrs) -> None:
        """Point event (the trace analog of a log line)."""
        stack = self._stack()
        self._record({"kind": "instant", "name": name, "ts": self.clock(),
                      "tid": threading.get_ident(), "pid": self.pid,
                      "parent": stack[-1] if stack else None,
                      "args": attrs or {}})

    def enable_ring(self, ring_size: int) -> None:
        """(Re)size the flight-recorder tail; 0 disables it."""
        with self._lock:
            self.ring = (collections.deque(self.ring or (),
                                           maxlen=ring_size)
                         if ring_size else None)

    # -- reading ------------------------------------------------------------
    def spans(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.events if e["kind"] == "span"]

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.events)

    def ring_snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.ring) if self.ring is not None else []

    def reset(self) -> None:
        with self._lock:
            self.events.clear()
            if self.ring is not None:
                self.ring.clear()
            self.dropped = 0


class _Span:
    """One live span; records its event when the ``with`` block exits, so a
    span that raises still lands in the trace (with ``error`` noted)."""

    __slots__ = ("_tracer", "name", "attrs", "id", "parent", "remote",
                 "_t0", "_dur")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any],
                 remote: Optional[Dict[str, Any]] = None):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.id = tracer._new_id()
        self.parent: Optional[int] = None
        self.remote = remote
        self._t0 = 0.0
        self._dur: Optional[float] = None

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = self._tracer.clock()
        self._dur = t1 - self._t0
        stack = self._tracer._stack()
        # tolerate a foreign unwind (a generator suspended mid-span): pop
        # our own id wherever it sits instead of corrupting siblings
        if stack and stack[-1] == self.id:
            stack.pop()
        elif self.id in stack:
            stack.remove(self.id)
        args = dict(self.attrs)
        if exc_type is not None:
            args["error"] = exc_type.__name__
        ev = {
            "kind": "span", "name": self.name, "ts": self._t0,
            "dur": self._dur, "tid": threading.get_ident(),
            "pid": self._tracer.pid, "id": self.id, "parent": self.parent,
            "args": args}
        if self.remote is not None:
            ev["remote"] = self.remote
        self._tracer._record(ev)
        return False

    @property
    def duration(self) -> float:
        """Elapsed seconds so far; the recorded duration once exited."""
        if self._dur is not None:
            return self._dur
        return self._tracer.clock() - self._t0


class NullSpan:
    """Shared no-op stand-in returned by the module hooks when no session
    is installed — stateless, so ONE instance serves every call site
    (the faults `_PLAN is None` zero-cost discipline)."""

    __slots__ = ()

    def __enter__(self) -> "NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = NullSpan()
