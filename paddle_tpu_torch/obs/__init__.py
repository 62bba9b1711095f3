"""Observability — so far only the typed metrics registry
(``obs/metrics.py``), which backs the trainer's counters. The session
plane of ``paddle_tpu/obs`` (spans, goodput, the flight recorder,
roofline instrumentation, exporters) waits for ROADMAP A.8."""

from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
