"""Typed metrics: Counter / Gauge / Histogram behind a registry — a copy of
``paddle_tpu/obs/metrics.py``. The port has the registry only: the obs
session plane that mirrors it (spans, sessions, exporters, the ``L005``
lint) waits for ROADMAP A.8.

The reference's only numeric observability is the ``StatSet`` timer table
(paddle/utils/Stat.h) — unlabeled, untyped, print-only. This module is the
typed half of the observability plane (docs/design/observability.md): three
metric kinds with Prometheus-compatible semantics, label support, and a
registry that can be process-global (the default every instrumented module
reports into via :mod:`paddle_tpu.obs` hooks) or instantiated per-test so
assertions never see another test's counts.

Naming is a public contract: ``subsystem.noun_qualifier`` — exactly one
dot, snake_case atoms (``trainer.steps_total``, ``rpc.call_seconds``).
The registry enforces the shape at registration time; the suffix-per-kind
conventions (counters ``_total``, histograms ``_seconds``/``_bytes``) are
checked by the ``L005`` lint (analysis/lints.py:lint_metric_names), which
also runs over the static :mod:`~paddle_tpu.obs.catalogue` in
``paddle_tpu lint``.

Thread safety: every mutation takes the metric's lock — trainer threads,
prefetch workers and lease keepers all report concurrently. The cost is
only paid while a session is installed (see paddle_tpu/obs/__init__.py for
the zero-cost-when-off discipline).
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the naming contract: one dot, snake_case atoms on both sides
METRIC_NAME_RE = re.compile(
    r"^[a-z][a-z0-9]*(?:_[a-z0-9]+)*\.[a-z][a-z0-9]*(?:_[a-z0-9]+)*$")

#: default histogram boundaries (seconds): tuned for host-loop latencies —
#: sub-ms jit dispatch up through multi-second compiles/checkpoints
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Metric:
    """Family base: one name, many label-sets (children)."""

    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        # RLock (not Lock): the flight recorder's signal-handler dump
        # collects these on the main thread, which may itself be paused
        # inside a mutation's critical section — re-entry must not
        # deadlock the dying process (see obs/flight.py)
        self._lock = threading.RLock()


class Counter(Metric):
    """Monotonic accumulator. ``inc`` only; negative increments raise."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[LabelKey, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        key = _label_key(labels)
        with self._lock:
            self._vals[key] = self._vals.get(key, 0.0) + n

    def labels(self, **labels) -> "_BoundCounter":
        return _BoundCounter(self, labels)

    def get(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._vals.items())


class _BoundCounter:
    """A counter pinned to one label-set (Prometheus ``.labels()`` child)."""

    __slots__ = ("_c", "_labels")

    def __init__(self, counter: Counter, labels: Dict[str, object]):
        self._c = counter
        self._labels = labels

    def inc(self, n: float = 1) -> None:
        self._c.inc(n, **self._labels)

    def get(self) -> float:
        return self._c.get(**self._labels)


class Gauge(Metric):
    """Point-in-time value; ``set``/``inc``/``dec``. Tracks the high-water
    mark per label-set (``max``) so a sampled value like queue depth still
    reports its peak after the fact."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._vals: Dict[LabelKey, float] = {}
        self._max: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._vals[key] = float(value)
            if value > self._max.get(key, float("-inf")):
                self._max[key] = float(value)

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            v = self._vals.get(key, 0.0) + n
            self._vals[key] = v
            if v > self._max.get(key, float("-inf")):
                self._max[key] = v

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def get(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_label_key(labels), 0.0)

    def high_water(self, **labels) -> float:
        with self._lock:
            return self._max.get(_label_key(labels), 0.0)

    def samples(self) -> List[Tuple[LabelKey, float]]:
        with self._lock:
            return sorted(self._vals.items())


class _HistState:
    __slots__ = ("counts", "sum", "count", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1 = overflow (+Inf) bucket
        self.sum = 0.0
        self.count = 0
        self.max = 0.0


class Histogram(Metric):
    """Fixed-boundary histogram (``le``-style cumulative buckets at export).

    Boundaries are fixed at construction — re-registering the same name
    with different buckets is an error (the series would be unmergeable).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(set(b)):
            raise ValueError(
                f"histogram {name}: buckets must be strictly increasing")
        self.buckets = b
        self._states: Dict[LabelKey, _HistState] = {}

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                st = self._states[key] = _HistState(len(self.buckets))
            # first bucket whose boundary >= value; else overflow
            for i, le in enumerate(self.buckets):
                if value <= le:
                    st.counts[i] += 1
                    break
            else:
                st.counts[-1] += 1
            st.sum += value
            st.count += 1
            if value > st.max:
                st.max = value

    def snapshot(self, **labels) -> Dict[str, object]:
        """Cumulative (prometheus-style) view: ``buckets`` is a list of
        ``[le, cumulative_count]`` ending with ``["+Inf", count]``."""
        key = _label_key(labels)
        with self._lock:
            st = self._states.get(key)
            if st is None:
                return {"buckets": [], "sum": 0.0, "count": 0, "max": 0.0}
            cum, out = 0, []
            for le, c in zip(self.buckets, st.counts):
                cum += c
                out.append([le, cum])
            out.append(["+Inf", cum + st.counts[-1]])
            return {"buckets": out, "sum": st.sum, "count": st.count,
                    "max": st.max}

    def samples(self) -> List[Tuple[LabelKey, Dict[str, object]]]:
        with self._lock:
            keys = sorted(self._states)
        return [(k, self.snapshot(**dict(k))) for k in keys]


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create home for metric families.

    One process-global instance backs the installed session by default
    (``paddle_tpu.obs.REGISTRY``); tests construct their own so counts
    are isolated. Kind conflicts and malformed names raise immediately —
    a metric name is API surface, not a string that fails at scrape time.
    """

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}
        self._lock = threading.RLock()   # signal-safe: see Metric._lock

    def _get(self, cls, name: str, help: str, **kw) -> Metric:
        if not METRIC_NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the subsystem.noun_qualifier "
                "convention (one dot, snake_case atoms); see "
                "docs/design/observability.md")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif type(m) is not cls:
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            elif kw.get("buckets") is not None and \
                    tuple(float(x) for x in kw["buckets"]) != m.buckets:
                raise ValueError(
                    f"histogram {name!r} already registered with different "
                    "bucket boundaries")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        if buckets is None:
            with self._lock:
                m = self._metrics.get(name)
            if isinstance(m, Histogram):
                return m
            buckets = DEFAULT_BUCKETS
        return self._get(Histogram, name, help, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def collect(self) -> List[Dict[str, object]]:
        """Flat sample list every exporter consumes (and the JSONL dump
        serializes): one dict per (metric, label-set)."""
        out: List[Dict[str, object]] = []
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        for m in metrics:
            if isinstance(m, Histogram):
                for key, snap in m.samples():
                    out.append({"type": "histogram", "name": m.name,
                                "help": m.help, "labels": dict(key), **snap})
            elif isinstance(m, Gauge):
                for key, v in m.samples():
                    out.append({"type": "gauge", "name": m.name,
                                "help": m.help, "labels": dict(key),
                                "value": v,
                                "high_water": m.high_water(**dict(key))})
            else:
                for key, v in m.samples():
                    out.append({"type": "counter", "name": m.name,
                                "help": m.help, "labels": dict(key),
                                "value": v})
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
