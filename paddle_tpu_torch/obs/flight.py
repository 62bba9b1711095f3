"""Crash flight recorder: the last N spans + metric deltas, dumped on death.

The faults plane makes processes die on purpose; an ObsSession alone
keeps its whole buffer in memory — so the runs whose telemetry matters most
(the crashed ones) were exactly the runs that lost it. The flight recorder
closes that hole the way an aircraft FDR does: a bounded ring of the most
*recent* events (the Tracer's ``ring`` — the main event list keeps a run's
beginning when it overflows; the ring keeps its end) plus counter deltas
since arming, written to disk at the moment of death:

* **SIGTERM** — the preemption signal; the previous handler is chained, so
  the trainer's checkpoint-then-exit still runs.
* **uncaught exception** — ``sys.excepthook`` chain (fatal hook).
* **interpreter exit** — ``atexit``, covering ``os._exit``-free paths and
  any death mode that unwinds normally.
* **faults-plane injected raise** — :func:`paddle_tpu_torch.faults.fire` calls
  :func:`paddle_tpu_torch.obs.flight_dump` just before raising, so the dump
  exists even if a retry layer later swallows the exception and the
  process is then SIGKILLed (which no hook can catch).

``kill -9`` during the dump itself can still lose it — the write is one
buffered pass over a small ring — but every *anticipated* death mode
leaves a self-describing artifact that ``python -m paddle_tpu_torch obs export`` reads
like any session dump.

Cost: one ``deque.append`` per trace event while armed (≪ 1µs; measured
≤ ~5µs/batch in tests/test_obs.py) and nothing at all on the metrics hot
path — deltas are computed at dump time from the registry.

Dump schema (public contract, the JAX package's observability design notes): a normal
JSONL dump whose meta carries ``{"flight": true, "reason": <why>,
"ring_size": N}`` and whose counter samples carry an extra ``"delta"``
field (value minus the arm-time baseline).
"""

from __future__ import annotations

import atexit
import os
import signal
import sys
import threading
from typing import Any, Dict, List, Optional

#: default ring length — ~100 batches of trainer spans; small enough that a
#: dump is one disk block burst, large enough to show what led to the crash
DEFAULT_RING = 2048


def _sample_key(s: Dict[str, Any]):
    return (s["name"], tuple(sorted((s.get("labels") or {}).items())))


class FlightRecorder:
    """Always-on tail capture for one :class:`ObsSession`.

    Usage::

        session = obs.ObsSession().install()
        rec = obs.FlightRecorder(session, "run.jsonl").arm()
        try:
            ...                      # crash anywhere -> run.jsonl exists
        finally:
            rec.disarm()             # clean exit: the caller's full
            session.save("run.jsonl")  # session.save owns the path now
    """

    def __init__(self, session, path: str, ring_size: int = DEFAULT_RING):
        self.session = session
        self.path = path
        self.ring_size = ring_size
        self._lock = threading.Lock()
        self._armed = False
        self._final = False          # a death-path dump already written
        self._baseline: Dict[Any, float] = {}
        self._prev_sigterm = None
        self._prev_excepthook = None

    # -- lifecycle ----------------------------------------------------------
    def arm(self) -> "FlightRecorder":
        """Enable the ring, snapshot the counter baseline, register the
        death hooks. Idempotent."""
        with self._lock:
            if self._armed:
                return self
            self._armed = True
        self.session.tracer.enable_ring(self.ring_size)
        self._baseline = {
            _sample_key(s): float(s.get("value", 0.0))
            for s in self.session.registry.collect()
            if s.get("type") == "counter"}
        from . import _set_flight
        _set_flight(self)
        atexit.register(self._atexit_dump)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._excepthook
        try:
            # main thread only; elsewhere the atexit/excepthook pair still
            # covers every catchable death mode
            self._prev_sigterm = signal.signal(signal.SIGTERM, self._sigterm)
        except ValueError:
            self._prev_sigterm = None
        return self

    def disarm(self) -> None:
        """Unregister the hooks — the clean-exit path, called before the
        owner writes its full session dump to the same file."""
        with self._lock:
            if not self._armed:
                return
            self._armed = False
        # release the ring too: "zero cost when not armed" includes the
        # per-event deque append and the up-to-ring_size pinned event dicts
        self.session.tracer.enable_ring(0)
        from . import _set_flight
        _set_flight(None)
        atexit.unregister(self._atexit_dump)
        # == not `is`: each `self._hook` access builds a fresh bound method,
        # so identity would never match; equality compares __self__/__func__
        if sys.excepthook == self._excepthook:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        try:
            if signal.getsignal(signal.SIGTERM) == self._sigterm:
                signal.signal(signal.SIGTERM,
                              self._prev_sigterm or signal.SIG_DFL)
        except ValueError:
            pass

    # -- capture ------------------------------------------------------------
    def snapshot(self, reason: str) -> Dict[str, Any]:
        """The flight dump: meta + full metric samples (counters annotated
        with their delta since arming) + the ring tail."""
        metrics: List[Dict[str, Any]] = []
        for s in self.session.registry.collect():
            if s.get("type") == "counter":
                s = dict(s)
                base = self._baseline.get(_sample_key(s), 0.0)
                s["delta"] = float(s.get("value", 0.0)) - base
            metrics.append(s)
        # the session's own meta block (shared shape) + the flight fields
        meta = dict(self.session.meta(), flight=True, reason=reason,
                    ring_size=self.ring_size)
        return {"meta": meta, "metrics": metrics,
                "events": self.session.tracer.ring_snapshot()}

    def dump(self, reason: str, final: bool = False) -> Optional[str]:
        """Write the flight dump to ``self.path`` (overwriting an earlier,
        staler one). ``final`` marks a death-path dump so the atexit hook
        does not clobber it with a later, emptier snapshot. Never raises —
        a failing dump must not mask the crash being recorded."""
        if final:
            self._final = True
        try:
            from .export import write_jsonl
            return write_jsonl(self.path, self.snapshot(reason))
        except Exception:
            return None

    # -- death hooks --------------------------------------------------------
    def _atexit_dump(self) -> None:
        if self._armed and not self._final:
            self.dump("atexit", final=True)

    def _excepthook(self, exc_type, exc, tb) -> None:
        if self._armed:
            self.dump(f"exception:{exc_type.__name__}", final=True)
        hook = self._prev_excepthook or sys.__excepthook__
        hook(exc_type, exc, tb)

    def _sigterm(self, signum, frame) -> None:
        if self._armed:
            self.dump("sigterm", final=True)
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        elif prev == signal.SIG_DFL:
            # restore + re-raise so the exit status stays "killed by
            # SIGTERM", not a bespoke exit code
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
