"""paddle_tpu_torch.obs — the unified observability plane, the port's copy
of ``paddle_tpu/obs`` with its module names, public names, metric and span
names and dump formats.

The chaos plane (:mod:`paddle_tpu_torch.faults`) has this as its twin:
typed metrics (:class:`Counter`/:class:`Gauge`/:class:`Histogram` behind a
:class:`MetricsRegistry`), a span :class:`Tracer` with parent/child nesting
and an injectable clock, and exporters (Chrome ``trace_event`` for
Perfetto, Prometheus text, JSONL, a human summary that subsumes
``StatSet.report()``). The metric and span catalogue (``obs/catalogue.py``) is a
public contract.

Zero cost when off — the ``faults`` no-op discipline: instrumented code
calls the module-level hooks below (``obs.count(...)``, ``obs.span(...)``)
which first check ``_SESSION is None``. With no session installed that is
one attribute load and a branch; production never pays for telemetry it
did not ask for.

Usage::

    from paddle_tpu_torch import obs
    with obs.ObsSession().installed() as s:
        trainer.train(reader, params, num_passes=2)
        print(s.summary())
        s.save("run.jsonl")   # -> python -m paddle_tpu_torch obs summary

Three places differ from JAX's plane, each written for the card: the
compile counter is ``core/graphs.py``'s capture hook
(``graphs.captures_total``, in place of the ``jax.monitoring`` bridge);
``obs/roofline.py`` counts a body's cost on meta tensors under
``torch.utils.flop_counter`` once per graph key, with peaks keyed by
``torch.cuda.get_device_name()``; ``obs/xplane.py`` also reads a
``torch.profiler`` run into the XSpace dict its consumers take.

**Counts inside a CUDA graph.** A replay runs no Python, so a count made
inside a graphed body fires only at capture: :func:`recording` (what
``GraphCache`` opens around a capture) takes the counts its body makes
and :func:`replay_counts` adds them again on every replay, as the graphs
do for ``LAUNCHES`` and ``ROUTES``.
"""

from __future__ import annotations

import threading
from typing import Optional

from . import alerts, context, goodput, health, roofline
from .catalogue import CATALOGUE, SPANS
from .export import (chrome_trace, merge_dumps, prometheus_text, read_jsonl,
                     summary, write_jsonl)
from .flight import FlightRecorder
from .metrics import (DEFAULT_BUCKETS, METRIC_NAME_RE, Counter, Gauge,
                      Histogram, MetricsRegistry)
from .session import ObsSession
from .trace import NULL_SPAN, NullSpan, Tracer

__all__ = [
    "ObsSession", "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "Tracer", "REGISTRY", "CATALOGUE", "SPANS", "METRIC_NAME_RE",
    "DEFAULT_BUCKETS", "chrome_trace", "prometheus_text", "summary",
    "read_jsonl", "write_jsonl", "merge_dumps", "is_active", "session",
    "install", "uninstall", "count", "gauge_set", "observe", "span",
    "instant", "server_span", "wire_context", "retry_observer",
    "FlightRecorder", "flight_recorder", "flight_dump", "NullSpan",
    "NULL_SPAN", "context", "goodput", "roofline", "health", "alerts",
    "req_phase", "request_ledger", "ensure_request_ledger",
]

#: process-global default registry — what an installed session reports into
#: unless the test injected its own
REGISTRY = MetricsRegistry()

#: the installed session; None = plane disabled (the fast path)
_SESSION: Optional[ObsSession] = None


def _install(s: ObsSession) -> None:
    global _SESSION
    if _SESSION is not None and _SESSION is not s:
        raise RuntimeError("another ObsSession is already installed")
    _SESSION = s


def _uninstall(s: ObsSession) -> None:
    global _SESSION, _REQUESTS
    if _SESSION is s:
        _SESSION = None
        _REQUESTS = None


def install(registry: Optional[MetricsRegistry] = None, **kw) -> ObsSession:
    """Convenience: build + install a session in one call."""
    return ObsSession(registry=registry, **kw).install()


def uninstall() -> None:
    global _SESSION, _REQUESTS
    _SESSION = None
    _REQUESTS = None


def is_active() -> bool:
    return _SESSION is not None


def session() -> Optional[ObsSession]:
    return _SESSION


# -- module-level hooks (what instrumented code calls) --------------------------
# Each first checks `_SESSION is None`: one load + branch when the plane is
# off — the same contract as faults.fire/filter_* (faults/inject.py).

def count(name: str, n: float = 1, **labels) -> None:
    s = _SESSION
    if s is None:
        return
    rec = getattr(_REC, "stack", None)
    if rec:
        rec[-1].append((name, n, tuple(sorted(labels.items()))))
        return
    s.registry.counter(name).inc(n, **labels)


# -- counts inside a CUDA graph --------------------------------------------------

_REC = threading.local()


class recording:
    """Take the counter increments made on this thread inside the block
    instead of applying them (``events``: (name, n, labels) in order) —
    what a graph capture opens: a capture computes nothing, and each
    replay adds the increments again through :func:`replay_counts`.
    A no-op list when no session is installed."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        st = getattr(_REC, "stack", None)
        if st is None:
            st = _REC.stack = []
        st.append(self.events)
        return self

    def __exit__(self, *exc):
        _REC.stack.pop()
        return False


def replay_counts(events) -> None:
    """Apply a recorded capture's counter increments once more (one
    replay)."""
    s = _SESSION
    if s is None or not events:
        return
    for name, n, labels in events:
        count(name, n, **dict(labels))


def gauge_set(name: str, value: float, **labels) -> None:
    s = _SESSION
    if s is None:
        return
    s.registry.gauge(name).set(value, **labels)


def observe(name: str, value: float, **labels) -> None:
    s = _SESSION
    if s is None:
        return
    s.registry.histogram(name).observe(value, **labels)


def span(name: str, metric: Optional[str] = None, metric_labels=None,
         **attrs):
    """Trace span context manager; the shared :data:`NULL_SPAN` when off."""
    s = _SESSION
    if s is None:
        return NULL_SPAN
    return s.span(name, metric=metric, metric_labels=metric_labels, **attrs)


def server_span(name: str, ctx, **attrs):
    """Server-side handler span parented on a wire context (the ``trace``
    key of an RPC envelope — obs/context.py). A malformed/absent context
    degrades to a plain span; :data:`NULL_SPAN` when the plane is off."""
    s = _SESSION
    if s is None:
        return NULL_SPAN
    return s.span(name, remote=context.sanitize(ctx), **attrs)


def wire_context(sp) -> Optional[dict]:
    """The ``trace`` envelope value for a request issued inside span ``sp``
    (as returned by :func:`span`); None when the plane is off — requests
    then stay byte-identical to un-instrumented ones."""
    if _SESSION is None:
        return None
    return context.wire_context(sp)


def instant(name: str, **attrs) -> None:
    s = _SESSION
    if s is None:
        return
    s.tracer.instant(name, **attrs)


# -- flight recorder plumbing ---------------------------------------------------

#: the armed FlightRecorder; None = no tail capture (the fast path)
_FLIGHT: Optional[FlightRecorder] = None


def _set_flight(rec: Optional[FlightRecorder]) -> None:
    global _FLIGHT
    _FLIGHT = rec


# named flight_recorder, NOT flight: the bare name would shadow the
# paddle_tpu_torch.obs.flight submodule attribute this package also exposes
def flight_recorder() -> Optional[FlightRecorder]:
    return _FLIGHT


def flight_dump(reason: str, final: bool = False) -> Optional[str]:
    """Dump the armed flight recorder's ring (no-op when none is armed) —
    what :func:`paddle_tpu_torch.faults.fire` calls just before an injected
    raise and the trainer calls on preemption. Never raises."""
    f = _FLIGHT
    if f is None:
        return None
    return f.dump(reason, final=final)


# -- per-request timeline ledger ------------------------------------------------

#: the installed RequestLedger (obs/requests.py); None = no timeline
#: capture. Cleared alongside _SESSION so test isolation is automatic.
_REQUESTS = None


def _set_requests(led) -> None:
    global _REQUESTS
    _REQUESTS = led


# named request_ledger, NOT requests: the bare name would shadow the
# paddle_tpu_torch.obs.requests submodule attribute this package also exposes
def request_ledger():
    return _REQUESTS


def ensure_request_ledger(ident: Optional[str] = None):
    """Install a default :class:`~paddle_tpu_torch.obs.requests.RequestLedger`
    iff a session is installed and none is present yet — what the
    serving daemons/router call at construction so per-request timelines
    are always-on whenever the obs plane is. Returns the active ledger,
    or None when the plane is off."""
    global _REQUESTS
    if _SESSION is None:
        return None
    if _REQUESTS is None:
        from .requests import RequestLedger
        _REQUESTS = RequestLedger(ident=ident or _SESSION.process)
    return _REQUESTS


def req_phase(key, phase: str, dur: Optional[float] = None,
              **extra) -> None:
    """Record a phase on the installed request ledger. The serving fast
    path calls this per request (not per token): same `_SESSION is None`
    one-load-one-branch discipline as the metric hooks, plus a None-key
    guard so un-keyed engine use (tests, embedded) records nothing."""
    if _SESSION is None:
        return
    led = _REQUESTS
    if led is None or key is None:
        return
    led.phase(key, phase, dur=dur, **extra)


def retry_observer(subsystem: str):
    """A :class:`paddle_tpu_torch.utils.retry.RetryPolicy` ``observer`` callback
    counting into ``<subsystem>.retries_total`` / ``.giveups_total`` /
    ``.backoff_seconds_total``. The policy stays obs-agnostic (no import
    cycle): it calls a plain callable; the callable checks the session."""

    def observer(event: str, **info) -> None:
        s = _SESSION
        if s is None:
            return
        if event == "attempt":
            s.registry.counter(f"{subsystem}.retries_total").inc()
            s.registry.counter(f"{subsystem}.backoff_seconds_total").inc(
                max(0.0, float(info.get("delay", 0.0))))
        elif event == "giveup":
            s.registry.counter(f"{subsystem}.giveups_total").inc()

    return observer
