"""Observability — the typed metrics registry (``obs/metrics.py``),
which backs the trainer's counters, and the fleet telemetry the master
server holds: ``obs/aggregate.py`` (``ClusterAggregator``, ``ObsPusher``)
over ``obs/health.py`` (the windowed time-series store and derived
per-worker health, which the serving router places by). The session plane
of ``paddle_tpu/obs`` (spans, goodput, the flight recorder, alerts,
request timelines, roofline instrumentation, exporters) waits for
ROADMAP A.8."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
