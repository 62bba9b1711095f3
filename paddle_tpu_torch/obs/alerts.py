"""Declarative alert rules over the fleet's windowed time-series.

The rules half of the fleet health plane (:mod:`paddle_tpu_torch.obs.health` is
storage + derivation). Three rule kinds, all evaluated against a
:class:`~paddle_tpu_torch.obs.health.TimeSeriesStore` with an injectable clock
(no rule ever sleeps):

* **threshold** — the newest in-window value of every matching series
  compared against a bound (``op`` in ``> < >= <=``). Fires per SERIES
  (a straggler alert names its worker), after ``for_windows`` consecutive
  true evaluations, and resolves only after ``for_windows`` consecutive
  false ones — hysteresis both ways, so one noisy sample neither fires
  nor clears an alert.
* **absence** — the series family has no point newer than ``window_s``:
  a worker that stopped pushing, a heartbeat stream gone quiet. Evaluated
  per known series; a store that never saw the metric stays silent
  (absence of a series ≠ absence of data).
* **burn_rate** — the SLO rule for histogram series (serving ``ttft`` /
  ``tpot``): over a SHORT and a LONG window, the fraction of observations
  above ``slo_le`` (bad fraction) divided by the error ``budget`` is the
  burn rate; the rule is true only when BOTH windows burn faster than
  ``burn_factor`` — the classic multi-window discipline: the short window
  makes detection fast, the long window stops a single bad second from
  paging. ``slo_le`` must sit on (or below) an actual bucket boundary of
  the histogram; the math uses the nearest boundary <= slo_le and says so
  in the event.

Firing/resolving transitions are **structured events** shaped exactly
like Tracer instants (``name="alert"``), so every existing consumer gets
them for free: ``obs.instant`` puts them in the live Tracer (hence the
flight-recorder ring and every ``obs export`` chrome trace), the engine
keeps its own bounded deque for ``obs serve /alerts`` and the master's
``obs_health`` op, and ``alerts.fired_total``/``alerts.active`` make the
alert stream itself observable.

Rules must reference CATALOGUED metric names and declared label keys —
the ``L009`` lint (analysis/lints.py) enforces it over the shipped
defaults in ``python -m paddle_tpu_torch lint`` and the tree-clean suite test.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .health import TimeSeriesStore

KINDS = ("threshold", "absence", "burn_rate")
_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda v, t: v > t,
    "<": lambda v, t: v < t,
    ">=": lambda v, t: v >= t,
    "<=": lambda v, t: v <= t,
}


class AlertRule:
    """One declarative rule. Authoring errors (unknown kind/op, a
    burn-rate rule without an SLO bound) raise HERE — a malformed rule
    must fail at definition, not silently never fire."""

    __slots__ = ("name", "metric", "kind", "labels", "op", "threshold",
                 "for_windows", "window_s", "short_s", "long_s", "slo_le",
                 "budget", "burn_factor", "severity", "description")

    def __init__(self, name: str, metric: str, *, kind: str = "threshold",
                 labels: Optional[Dict[str, str]] = None, op: str = ">",
                 threshold: Optional[float] = None, for_windows: int = 2,
                 window_s: float = 60.0, short_s: float = 60.0,
                 long_s: float = 300.0, slo_le: Optional[float] = None,
                 budget: float = 0.1, burn_factor: float = 1.0,
                 severity: str = "warning", description: str = ""):
        if kind not in KINDS:
            raise ValueError(f"unknown alert kind {kind!r} (one of {KINDS})")
        if op not in _OPS:
            raise ValueError(f"unknown alert op {op!r} "
                             f"(one of {sorted(_OPS)})")
        if kind == "threshold" and threshold is None:
            raise ValueError(f"threshold rule {name!r} needs threshold=")
        if kind == "burn_rate":
            if slo_le is None:
                raise ValueError(f"burn_rate rule {name!r} needs slo_le=")
            if not (0.0 < budget < 1.0):
                raise ValueError(f"burn_rate rule {name!r}: budget must be "
                                 f"in (0, 1), got {budget!r}")
            if short_s >= long_s:
                raise ValueError(f"burn_rate rule {name!r}: short_s must "
                                 "be < long_s (multi-window contract)")
        if for_windows < 1:
            raise ValueError(f"rule {name!r}: for_windows must be >= 1")
        self.name = str(name)
        self.metric = str(metric)
        self.kind = kind
        self.labels = dict(labels or {})
        self.op = op
        self.threshold = threshold
        self.for_windows = int(for_windows)
        self.window_s = float(window_s)
        self.short_s = float(short_s)
        self.long_s = float(long_s)
        self.slo_le = slo_le
        self.budget = float(budget)
        self.burn_factor = float(burn_factor)
        self.severity = str(severity)
        self.description = str(description)

    def to_dict(self) -> Dict[str, Any]:
        d = {"name": self.name, "metric": self.metric, "kind": self.kind,
             "severity": self.severity}
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.kind == "threshold":
            d.update(op=self.op, threshold=self.threshold)
        if self.kind == "burn_rate":
            d.update(slo_le=self.slo_le, budget=self.budget,
                     short_s=self.short_s, long_s=self.long_s,
                     burn_factor=self.burn_factor)
        return d


class _RuleState:
    __slots__ = ("true_streak", "false_streak", "firing", "since", "value")

    def __init__(self):
        self.true_streak = 0
        self.false_streak = 0
        self.firing = False
        self.since: Optional[float] = None
        self.value: Optional[float] = None


def _bad_fraction(points, slo_le: float) -> Optional[Tuple[float, int]]:
    """(fraction of window observations above slo_le, window count) from
    a histogram series' cumulative snapshots; None without new traffic."""
    snaps = [(t, v) for t, v in points if isinstance(v, dict)]
    if len(snaps) < 2:
        return None
    first, last = snaps[0][1], snaps[-1][1]
    dn = last.get("count", 0) - first.get("count", 0)
    if dn <= 0:
        return None

    def good(snap):
        best = 0
        for le, cum in snap.get("buckets", ()):
            if le == "+Inf":
                continue
            try:
                if float(le) <= slo_le:
                    best = cum
            except (TypeError, ValueError):
                continue
        return best

    dgood = good(last) - good(first)
    bad = max(dn - max(dgood, 0), 0)
    return bad / dn, dn


class AlertEngine:
    """Evaluates rules over a store; owns the firing state machine.

    One engine per aggregator (the master's). ``evaluate()`` is driven by
    the aggregator's push path (rate-limited there) or directly by tests;
    the clock is the store's unless overridden, so a fake-clock test
    controls both with one counter.
    """

    def __init__(self, rules, store: TimeSeriesStore, *,
                 clock: Optional[Callable[[], float]] = None,
                 max_events: int = 256):
        self.rules: List[AlertRule] = list(rules or ())
        self.store = store
        self._clock = clock or store._clock
        self._lock = threading.Lock()
        # (rule name, series-identity tuple) -> state
        self._state: Dict[Tuple[str, Tuple], _RuleState] = {}
        #: bounded transition log, newest last (the /alerts payload)
        self.events: Deque[Dict[str, Any]] = collections.deque(
            maxlen=max_events)

    def add_rules(self, rules) -> None:
        """Append rules, REPLACING any same-named one — a serving daemon
        registering its engine's configured SLO targets must override the
        aggregator's same-named defaults, not be silently dropped (an
        operator-set slo_le evaluated at the default would be exactly the
        silent-alerting failure L009 exists to stop). Replaced rules'
        firing state resets (old streaks were judged under old params)."""
        with self._lock:
            by_name = {r.name: i for i, r in enumerate(self.rules)}
            for r in rules:
                i = by_name.get(r.name)
                if i is None:
                    by_name[r.name] = len(self.rules)
                    self.rules.append(r)
                else:
                    self.rules[i] = r
                    for k in [k for k in self._state if k[0] == r.name]:
                        del self._state[k]

    # -- evaluation ---------------------------------------------------------
    def _series_matching(self, rule: AlertRule):
        """(worker, labels, points) for every stored series of the rule's
        metric whose labels are a superset of the rule's filter."""
        out = []
        for worker, labels, pts in self.store.series_for(rule.metric):
            if all(labels.get(k) == v for k, v in rule.labels.items()):
                out.append((worker, labels, pts))
        return out

    def _condition(self, rule: AlertRule, worker, labels, pts,
                   now: float) -> Tuple[Optional[bool], Optional[float],
                                        Dict[str, Any]]:
        """(condition, representative value, extra event args); condition
        None = not evaluable this round (no streak movement either way)."""
        if rule.kind == "threshold":
            vals = [(t, v) for t, v in pts
                    if isinstance(v, (int, float))
                    and t >= now - rule.window_s]
            if not vals:
                return None, None, {}
            v = float(vals[-1][1])
            return _OPS[rule.op](v, rule.threshold), v, {}
        if rule.kind == "absence":
            newest = max((t for t, _ in pts), default=None)
            if newest is None:
                return None, None, {}
            silent = now - newest
            return silent > rule.window_s, silent, {"silent_s": silent}
        # burn_rate
        short = _bad_fraction([(t, v) for t, v in pts
                               if t >= now - rule.short_s], rule.slo_le)
        long_ = _bad_fraction([(t, v) for t, v in pts
                               if t >= now - rule.long_s], rule.slo_le)
        if short is None or long_ is None:
            return None, None, {}
        burn_s = short[0] / rule.budget
        burn_l = long_[0] / rule.budget
        cond = (burn_s > rule.burn_factor and burn_l > rule.burn_factor)
        return cond, burn_s, {"burn_short": burn_s, "burn_long": burn_l,
                              "slo_le": rule.slo_le}

    def evaluate(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One evaluation round; returns this round's TRANSITION events
        (fired / resolved), each already recorded and emitted."""
        from . import count as _count
        from . import gauge_set as _gauge_set
        from . import instant as _instant
        now = self._clock() if now is None else float(now)
        transitions: List[Dict[str, Any]] = []
        #: every (rule, series) whose series still EXISTS this round —
        #: state for anything else belongs to a vanished series (worker
        #: TTL'd/evicted out of the store) and is resolved+dropped below,
        #: so a dead incarnation can neither alert forever nor leak state
        seen: set = set()
        with self._lock:
            rules = list(self.rules)
        for rule in rules:
            for worker, labels, pts in self._series_matching(rule):
                key = (rule.name, (worker,) + tuple(sorted(labels.items())))
                seen.add(key)
                cond, value, extra = self._condition(
                    rule, worker, labels, pts, now)
                if cond is None:
                    continue
                with self._lock:
                    st = self._state.get(key)
                    if st is None:
                        st = self._state[key] = _RuleState()
                    st.value = value
                    if cond:
                        st.true_streak += 1
                        st.false_streak = 0
                    else:
                        st.false_streak += 1
                        st.true_streak = 0
                    fire = (not st.firing
                            and st.true_streak >= rule.for_windows)
                    resolve = (st.firing
                               and st.false_streak >= rule.for_windows)
                    if fire:
                        st.firing, st.since = True, now
                    elif resolve:
                        st.firing, st.since = False, None
                if not (fire or resolve):
                    continue
                state = "fired" if fire else "resolved"
                args: Dict[str, Any] = {
                    "rule": rule.name, "state": state,
                    "metric": rule.metric, "severity": rule.severity,
                    "worker": worker, "value": value}
                args.update(extra)
                if labels:
                    args["labels"] = dict(labels)
                ev = {"kind": "instant", "name": "alert", "ts": now,
                      "tid": 0, "parent": None, "args": args}
                with self._lock:
                    self.events.append(ev)
                transitions.append(ev)
                # the live tracer (-> flight ring -> chrome export) and
                # the metric stream see every transition
                _instant("alert", **args)
                if fire:
                    _count("alerts.fired_total", rule=rule.name)
                else:
                    _count("alerts.resolved_total", rule=rule.name)
        # series-gone reaping: state whose series vanished from the store
        with self._lock:
            gone = [(k, st) for k, st in self._state.items()
                    if k not in seen]
            for k, _ in gone:
                del self._state[k]
        for (name, ident), st in gone:
            if not st.firing:
                continue
            args = {"rule": name, "state": "resolved", "reason":
                    "series_gone", "worker": ident[0], "value": st.value}
            ev = {"kind": "instant", "name": "alert", "ts": now,
                  "tid": 0, "parent": None, "args": args}
            with self._lock:
                self.events.append(ev)
            transitions.append(ev)
            _instant("alert", **args)
            _count("alerts.resolved_total", rule=name)
        _gauge_set("alerts.active", float(len(self.active())))
        return transitions

    # -- reading ------------------------------------------------------------
    def active(self) -> List[Dict[str, Any]]:
        """Currently-firing alerts: rule, series identity, value, since."""
        with self._lock:
            out = []
            for (name, ident), st in sorted(self._state.items()):
                if st.firing:
                    out.append({"rule": name, "worker": ident[0],
                                "labels": dict(ident[1:]),
                                "value": st.value, "since": st.since,
                                "state": "firing"})
            return out

    def recent_events(self, n: int = 64) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self.events)[-n:]


# -- shipped rule sets ----------------------------------------------------------

def serving_slo_rules(ttft_slo_s: float = 1.0, tpot_slo_s: float = 0.25,
                      budget: float = 0.1, *, short_s: float = 60.0,
                      long_s: float = 300.0) -> List[AlertRule]:
    """Default multi-window burn-rate rules for the serving SLO pair.
    ``ServingEngine.alert_rules()`` parameterizes these with its
    configured targets; the bare defaults keep ``python -m paddle_tpu_torch lint`` and
    file-mode ``obs serve`` meaningful without an engine."""
    return [
        AlertRule("serving_ttft_slo_burn", "serving.ttft_seconds",
                  kind="burn_rate", slo_le=ttft_slo_s, budget=budget,
                  short_s=short_s, long_s=long_s, severity="page",
                  description="TTFT error-budget burn over both windows"),
        AlertRule("serving_tpot_slo_burn", "serving.tpot_seconds",
                  kind="burn_rate", slo_le=tpot_slo_s, budget=budget,
                  short_s=short_s, long_s=long_s, severity="page",
                  description="TPOT error-budget burn over both windows"),
    ]


def default_rules() -> List[AlertRule]:
    """The shipped rule set every master aggregator starts with: the
    derived-health detectors (thresholds match FleetHealth's constants —
    one owner) plus the serving SLO burn rates at their default targets.
    ``python -m paddle_tpu_torch lint`` runs L009 over exactly this list."""
    from .health import FleetHealth
    return [
        AlertRule("worker_straggler", "cluster.health_straggler_score",
                  kind="threshold", op=">",
                  threshold=FleetHealth.STRAGGLER_RATIO, for_windows=2,
                  description="worker shard latency over the fleet median"),
        AlertRule("worker_heartbeat_jitter",
                  "cluster.health_heartbeat_jitter",
                  kind="threshold", op=">", threshold=2.0, for_windows=2,
                  description="heartbeat arrival stddev (seconds)"),
        AlertRule("worker_goodput_collapse", "cluster.health_goodput_ewma",
                  kind="threshold", op="<", threshold=0.05, for_windows=3,
                  description="smoothed goodput ratio collapsed"),
        AlertRule("worker_telemetry_absent", "goodput.ratio",
                  kind="absence", window_s=60.0,
                  description="a worker's pushes went quiet"),
    ] + serving_slo_rules()
