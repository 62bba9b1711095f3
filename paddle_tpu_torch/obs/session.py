"""ObsSession: the installable unit binding a registry to a tracer.

Mirrors :class:`paddle_tpu_torch.faults.FaultPlan`'s lifecycle exactly — one
session installed at a time, ``install()``/``uninstall()``/``installed()``
context manager, and module-level hooks (paddle_tpu/obs/__init__.py) that
are a single ``is None`` check when nothing is installed. ``faults`` is the
chaos plane; this is its twin that makes the chaos (and everything else)
visible.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, Optional

from .metrics import MetricsRegistry
from .trace import Tracer


class ObsSession:
    """One observation window: metrics + trace + an injectable clock.

    Args:
      registry: metrics home; defaults to the process-global
        ``paddle_tpu_torch.obs.REGISTRY``. Tests pass a fresh
        :class:`MetricsRegistry` so counts are isolated.
      tracer: span collector; defaults to a new :class:`Tracer`.
      clock: convenience — forwarded to a default-constructed tracer so
        ``ObsSession(clock=fake)`` is enough for deterministic spans.
      process: human name for this process in merged multi-process views
        (the Chrome ``process_name`` lane, the merged-registry ``worker``
        label default). Defaults to ``PADDLE_TPU_OBS_PROCESS`` or a
        ``<script>:<pid>`` tag.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 clock: Optional[Callable[[], float]] = None,
                 process: Optional[str] = None):
        if registry is None:
            from . import REGISTRY
            registry = REGISTRY
        self.registry = registry
        self.tracer = tracer or Tracer(clock=clock)
        if process is None:
            import os
            import sys
            process = os.environ.get("PADDLE_TPU_OBS_PROCESS") or (
                f"{os.path.basename(sys.argv[0] or 'python')}:"
                f"{self.tracer.pid}")
        self.process = process

    # -- lifecycle ----------------------------------------------------------
    def install(self) -> "ObsSession":
        from . import _install
        _install(self)
        return self

    def uninstall(self) -> None:
        from . import _uninstall
        _uninstall(self)

    @contextlib.contextmanager
    def installed(self):
        self.install()
        try:
            yield self
        finally:
            self.uninstall()

    # -- recording ----------------------------------------------------------
    def span(self, name: str, metric: Optional[str] = None,
             metric_labels: Optional[Dict[str, Any]] = None,
             remote: Optional[Dict[str, Any]] = None, **attrs):
        """Trace span; ``metric=`` additionally lands the duration in that
        histogram (one timing source for both views, same clock);
        ``remote=`` records a cross-process parent (obs/context.py)."""
        sp = self.tracer.span(name, remote=remote, **attrs)
        if metric is None:
            return sp
        return _MeteredSpan(sp, self.registry, metric, metric_labels)

    # -- output -------------------------------------------------------------
    def meta(self) -> Dict[str, Any]:
        """The dump's identity block — ONE implementation shared by
        :meth:`dump` and the flight recorder so the two artifact schemas
        cannot drift."""
        from .context import trace_id
        meta = {"created_unix": time.time(), "pid": self.tracer.pid,
                "process": self.process, "trace_id": trace_id(),
                # maps this tracer's (monotonic) span timestamps onto the
                # wall clock so merge_dumps can align processes: a span at
                # ts T happened at unix time clock_origin_unix + T
                "clock_origin_unix": time.time() - self.tracer.clock()}
        if self.tracer.dropped:
            # the trace is truncated at max_events; say so in the artifact
            meta["events_dropped"] = self.tracer.dropped
        return meta

    def dump(self) -> Dict[str, Any]:
        """The canonical export shape (see obs/export.py)."""
        out = {"meta": self.meta(),
               "metrics": self.registry.collect(),
               "events": self.tracer.snapshot()}
        from . import request_ledger
        led = request_ledger()
        if led is not None:
            # request timelines ride every dump artifact (flight rings,
            # --obs_out files), so obs trace works from files alone
            out["requests"] = led.export()
        return out

    def save(self, path: str) -> str:
        """Persist as JSONL — the artifact ``python -m paddle_tpu_torch obs`` consumes."""
        from .export import write_jsonl
        return write_jsonl(path, self.dump())

    def summary(self, stats=None) -> str:
        from .export import summary
        return summary(self.dump(), stats=stats)


class _MeteredSpan:
    """Span that also observes its duration into a histogram on exit."""

    __slots__ = ("_span", "_registry", "_metric", "_labels")

    def __init__(self, span, registry: MetricsRegistry, metric: str,
                 labels: Optional[Dict[str, Any]] = None):
        self._span = span
        self._registry = registry
        self._metric = metric
        self._labels = labels or {}

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        out = self._span.__exit__(exc_type, exc, tb)
        self._registry.histogram(self._metric).observe(
            self._span.duration, **self._labels)
        return out

    @property
    def id(self):
        """Underlying span id — what wire context stamps into requests."""
        return self._span.id
