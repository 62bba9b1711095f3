"""Fleet health plane: windowed cluster time-series + per-worker health.

The master-side :class:`~paddle_tpu_torch.obs.aggregate.ClusterAggregator`
keeps only the *latest* snapshot per worker — enough for a
point-in-time ``/metrics`` scrape, useless for trends: the elastic
autoscale hook reasoned from one instantaneous sample, no operator could
see a straggler forming, and no SLO burn rate existed to alert on. The
Ascend field study (PAPERS.md) is blunt that accelerator fleets die
without *continuous* utilization telemetry and per-worker health
attribution. This module is that plane's storage + derivation half
(``obs/alerts.py`` is the rules half):

* :class:`TimeSeriesStore` — a bounded ring of timestamped samples per
  ``worker|metric|labels`` series. Memory is bounded twice (``max_points``
  per ring, ``max_series`` total); the clock is injectable so every test
  time-travels instead of sleeping. :func:`rate` is the ONE shared
  counter-delta → per-second derivation (restart-tolerant); :func:`ewma`
  the shared exponentially-weighted mean/variance.
* :class:`FleetHealth` — per-worker derived signals: goodput-ratio EWMA +
  variance and step-time EWMA off the windowed store, a **straggler
  score** (this worker's recent median shard latency over the OTHER
  workers' median — fed from the elastic ``ela_grad`` timings), heartbeat-interval
  jitter (fed from accepted membership heartbeats), and a goodput-collapse
  flag. The snapshot lands in ``cluster.health_*`` gauges (worker-labeled,
  bounded by the fleet size) AND back into the store, so alert rules can
  threshold on derived health like any other series.
* :func:`health_table` — the per-worker operator table ``paddle_tpu obs
  top`` and ``obs serve /summary`` render.

Zero-cost contract: everything here runs on the MASTER, driven by pushes
that only happen when a worker installed an ObsSession + ObsPusher. The
worker-side hooks this plane feeds from (shard timing in
``trainer/elastic.py``, ``faults.fire`` chaos sites) are a clock read and
an is-None branch when the planes are off.

A copy of ``paddle_tpu/obs/health.py`` (it imports nothing of either
package), so that the port's ``ClusterAggregator`` and the router's
placement read the same history.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

SeriesKey = Tuple[str, str, Tuple[Tuple[str, str], ...]]


def _series_key(worker: str, name: str, labels: Optional[Dict]) -> SeriesKey:
    return (str(worker), str(name),
            tuple(sorted((str(k), str(v))
                         for k, v in (labels or {}).items())))


def _point_payload(sample: Dict[str, Any]):
    """What one ring point stores per sample kind: a float for
    counters/gauges, the (count, sum, cumulative buckets) triple for
    histograms — the minimum burn-rate math needs."""
    t = sample.get("type")
    if t == "histogram":
        return {"count": int(sample.get("count", 0)),
                "sum": float(sample.get("sum", 0.0)),
                "buckets": [[le, int(c)]
                            for le, c in (sample.get("buckets") or ())]}
    v = sample.get("value")
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


class TimeSeriesStore:
    """Bounded windowed sample store keyed ``worker|metric|labels``.

    Args:
      window_s: read horizon — :meth:`points` drops older samples (the
        rings may briefly hold older points; reads never return them).
      max_points: ring length per series (the hard per-series bound).
      max_series: total distinct series admitted; past the cap NEW series
        are dropped (and counted in :attr:`dropped_series`) rather than
        growing without bound — a worker minting runaway label values
        must not melt the master.
      clock: injectable monotonic clock (tests time-travel).
    """

    def __init__(self, window_s: float = 300.0, max_points: int = 240,
                 max_series: int = 4096,
                 clock: Optional[Callable[[], float]] = None):
        self.window_s = float(window_s)
        self.max_points = int(max_points)
        self.max_series = int(max_series)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._series: Dict[SeriesKey, Deque[Tuple[float, Any]]] = {}
        self.dropped_series = 0

    # -- writing ------------------------------------------------------------
    def record(self, worker: str, samples, ts: Optional[float] = None) -> int:
        """Append one timestamped point per sample (aggregator-cleaned
        shape); returns the number of points stored."""
        ts = self._clock() if ts is None else float(ts)
        stored = 0
        with self._lock:
            for s in samples or ():
                if not isinstance(s, dict) or not s.get("name"):
                    continue
                payload = _point_payload(s)
                if payload is None:
                    continue
                key = _series_key(worker, s["name"], s.get("labels"))
                ring = self._series.get(key)
                if ring is None:
                    if len(self._series) >= self.max_series:
                        self.dropped_series += 1
                        continue
                    ring = self._series[key] = collections.deque(
                        maxlen=self.max_points)
                ring.append((ts, payload))
                stored += 1
        return stored

    def record_value(self, worker: str, name: str, value: float,
                     labels: Optional[Dict] = None,
                     ts: Optional[float] = None) -> None:
        """Single-value convenience (derived gauges, master-side series)."""
        self.record(worker, [{"name": name, "type": "gauge",
                              "value": value, "labels": labels or {}}], ts)

    def drop_worker(self, worker: str) -> int:
        """Drop every series of ONE worker (the membership leave/evict
        reap — without it a health-fed-only worker's derived series, and
        any alert frozen on them, would outlive the worker forever);
        returns the number of series removed."""
        worker = str(worker)
        with self._lock:
            dead = [k for k in self._series if k[0] == worker]
            for k in dead:
                del self._series[k]
        return len(dead)

    def prune(self, live_workers) -> int:
        """Drop every series belonging to a worker not in ``live_workers``
        (the aggregator's TTL ageing applied to history); returns the
        number of series removed."""
        live = {str(w) for w in live_workers}
        # "_master" series (autoscale signal, backlog) are the master's
        # own and never age out with worker churn
        live.add(MASTER_WORKER)
        with self._lock:
            dead = [k for k in self._series if k[0] not in live]
            for k in dead:
                del self._series[k]
        return len(dead)

    # -- reading ------------------------------------------------------------
    def points(self, worker: str, name: str,
               labels: Optional[Dict] = None,
               window_s: Optional[float] = None,
               now: Optional[float] = None) -> List[Tuple[float, Any]]:
        """The series' points inside the window, oldest first."""
        now = self._clock() if now is None else float(now)
        horizon = now - (self.window_s if window_s is None
                         else float(window_s))
        key = _series_key(worker, name, labels)
        with self._lock:
            ring = self._series.get(key)
            pts = list(ring) if ring is not None else []
        return [(t, v) for t, v in pts if t >= horizon]

    def series_for(self, name: str) -> List[Tuple[str, Dict[str, str],
                                                  List[Tuple[float, Any]]]]:
        """Every stored series of ``name``: (worker, labels, points)."""
        with self._lock:
            items = [(k, list(ring)) for k, ring in self._series.items()
                     if k[1] == name]
        return [(k[0], dict(k[2]), pts) for k, pts in sorted(items)]

    def workers(self) -> List[str]:
        with self._lock:
            return sorted({k[0] for k in self._series}
                          - {MASTER_WORKER})

    def n_series(self) -> int:
        with self._lock:
            return len(self._series)

    def n_points(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._series.values())


#: the store's reserved worker id for master-side series (autoscale
#: signal, backlog) — never a real fleet member name (worker ids come
#: from worker processes; the underscore prefix keeps the namespace)
MASTER_WORKER = "_master"


# -- shared derivations ---------------------------------------------------------

def rate(points: List[Tuple[float, Any]], *, now: Optional[float] = None,
         min_span_s: float = 1e-9) -> Optional[float]:
    """Counter-delta → per-second rate over a series' windowed points —
    the shared derivation for anything consuming counter series out of
    the store (external scalers reading the history; a future rate-
    threshold rule kind; the built-in detectors read gauges/histograms
    directly). Restart-tolerant: a negative delta (worker restarted,
    counter reset) re-bases at the newest value instead of reporting a
    negative rate. None with < 2 points (no window)."""
    vals = [(t, v) for t, v in points if isinstance(v, (int, float))]
    if len(vals) < 2:
        return None
    (t0, v0), (t1, v1) = vals[0], vals[-1]
    span = t1 - t0
    if span < min_span_s:
        return None
    delta = v1 - v0
    if delta < 0:             # counter reset mid-window: count since reset
        delta = v1
    return delta / span


def ewma(values, alpha: float = 0.3) -> Tuple[Optional[float],
                                              Optional[float]]:
    """Exponentially-weighted mean AND variance over ``values`` (oldest
    first) — the smoothing the health snapshot applies to goodput ratio
    and step time. Returns (None, None) when empty."""
    mean = var = None
    for v in values:
        v = float(v)
        if mean is None:
            mean, var = v, 0.0
        else:
            d = v - mean
            mean += alpha * d
            var = (1.0 - alpha) * (var + alpha * d * d)
    return mean, var


def _median(vals: List[float]) -> Optional[float]:
    if not vals:
        return None
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _hist_mean_delta(points: List[Tuple[float, Any]]) -> Optional[float]:
    """Windowed mean of a histogram series: (Δsum / Δcount) between the
    window's first and last snapshots. None without new observations."""
    snaps = [(t, v) for t, v in points if isinstance(v, dict)]
    if len(snaps) < 2:
        return None
    a, b = snaps[0][1], snaps[-1][1]
    dc = b.get("count", 0) - a.get("count", 0)
    if dc <= 0:
        return None
    return (b.get("sum", 0.0) - a.get("sum", 0.0)) / dc


class FleetHealth:
    """Derived per-worker health over the windowed store.

    The master feeds the two signals the store cannot see from pushed
    snapshots alone:

    * :meth:`note_shard` — per accepted ``ela_grad``, the worker-reported
      shard gradient wall time (``trainer/elastic.py``); the straggler
      score derives from these.
    * :meth:`note_heartbeat` — per accepted membership heartbeat
      (``runtime/membership.py``); heartbeat-interval jitter derives from
      the arrival times.

    :meth:`snapshot` folds both with the store's ``goodput.ratio`` /
    ``trainer.step_seconds`` series into one per-worker dict. Detection
    thresholds live HERE (one owner); the alert rules threshold on the
    emitted ``cluster.health_*`` gauges, so rule values and these
    constants agree by construction (alerts.default_rules reads them).
    """

    #: straggler: worker median shard latency > this multiple of the
    #: OTHER workers' median (leave-one-out; needs >= 2 reporting workers)
    STRAGGLER_RATIO = 2.0
    #: heartbeat jitter: interval stddev beyond this fraction of the
    #: median interval marks arrival timing as unstable
    JITTER_RATIO = 0.5
    #: goodput collapse: EWMA below this fraction of the worker's own
    #: windowed peak (and the peak itself was a real signal)
    COLLAPSE_RATIO = 0.33

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 shard_window: int = 32, heartbeat_window: int = 16):
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._shards: Dict[str, Deque[Tuple[float, float]]] = {}
        self._beats: Dict[str, Deque[float]] = {}
        self.shard_window = int(shard_window)
        self.heartbeat_window = int(heartbeat_window)

    # -- feeds (master-side call sites) -------------------------------------
    def note_shard(self, worker: str, seconds: float,
                   now: Optional[float] = None) -> None:
        now = self._clock() if now is None else float(now)
        with self._lock:
            dq = self._shards.get(worker)
            if dq is None:
                dq = self._shards[worker] = collections.deque(
                    maxlen=self.shard_window)
            dq.append((now, float(seconds)))

    def note_heartbeat(self, worker: str,
                       now: Optional[float] = None) -> None:
        now = self._clock() if now is None else float(now)
        with self._lock:
            dq = self._beats.get(worker)
            if dq is None:
                dq = self._beats[worker] = collections.deque(
                    maxlen=self.heartbeat_window)
            dq.append(now)

    def forget(self, worker: str) -> None:
        """Drop a departed worker's feeds (the membership leave/evict
        hook) so a re-join starts clean."""
        with self._lock:
            self._shards.pop(worker, None)
            self._beats.pop(worker, None)

    def known_workers(self):
        """Workers any feed has seen (and not yet forgotten) — the
        aggregator's prune keeps their history alive even when they never
        obs_push (elastic CLI workers feed shard timings/heartbeats only;
        membership leave/evict forget()s them, closing the loop)."""
        with self._lock:
            return set(self._shards) | set(self._beats)

    # -- derivation ---------------------------------------------------------
    def _shard_median(self, worker: str, horizon: float) -> Optional[float]:
        with self._lock:   # note_shard appends concurrently (RPC threads)
            dq = self._shards.get(worker)
            if not dq:
                return None
            vals = [s for t, s in dq if t >= horizon]
        return _median(vals)

    def snapshot(self, store: Optional[TimeSeriesStore] = None,
                 now: Optional[float] = None) -> Dict[str, Dict[str, Any]]:
        """Per-worker health: ``{worker: {goodput_ewma, goodput_var,
        step_ewma, straggler_score, heartbeat_jitter, flags...}}``.

        The worker set is the union of everything any feed has seen —
        a worker that stopped pushing still shows up (with its stale
        signals), which is exactly when an operator needs the row.
        """
        now = self._clock() if now is None else float(now)
        window = store.window_s if store is not None else 300.0
        horizon = now - window
        with self._lock:
            workers = set(self._shards) | set(self._beats)
        # ONE store scan per metric family (not per worker — series_for
        # walks every stored series under the store lock)
        goodput_by_w: Dict[str, List[Tuple[float, float]]] = {}
        steps_by_w: Dict[str, List[Optional[float]]] = {}
        if store is not None:
            workers |= set(store.workers())
            for w, _labels, pts in store.series_for("goodput.ratio"):
                goodput_by_w.setdefault(w, []).extend(
                    (t, v) for t, v in pts
                    if t >= horizon and isinstance(v, (int, float)))
            for w, _labels, pts in store.series_for(
                    "trainer.step_seconds"):
                steps_by_w.setdefault(w, []).append(_hist_mean_delta(
                    [(t, v) for t, v in pts if t >= horizon]))
        out: Dict[str, Dict[str, Any]] = {}
        medians: Dict[str, Optional[float]] = {
            w: self._shard_median(w, horizon) for w in workers}
        for w in sorted(workers):
            h: Dict[str, Any] = {
                "goodput_ewma": None, "goodput_var": None,
                "step_ewma": None, "straggler_score": None,
                "heartbeat_jitter": None, "straggler": False,
                "heartbeat_unstable": False, "goodput_collapse": False}
            if store is not None:
                # goodput.ratio is per-component; a worker usually runs
                # one training loop — series merge time-ordered for the EWMA
                merged = sorted(goodput_by_w.get(w, ()),
                                key=lambda p: p[0])
                vals = [v for _, v in merged]
                if vals:
                    h["goodput_ewma"], h["goodput_var"] = ewma(vals)
                    peak = max(vals)
                    if (peak > 0.05 and h["goodput_ewma"] is not None
                            and h["goodput_ewma"]
                            < self.COLLAPSE_RATIO * peak):
                        h["goodput_collapse"] = True
                means = [m for m in steps_by_w.get(w, ()) if m is not None]
                h["step_ewma"] = ewma(means)[0] if means else None
            m = medians.get(w)
            # leave-one-out reference: the median of the OTHER workers'
            # medians. Including the candidate itself caps the score at
            # N/(N-1)-ish — on a 2-worker fleet an arbitrarily slow
            # worker could never cross 2.0 (found live)
            others = [v for k, v in medians.items()
                      if k != w and v is not None]
            ref = _median(others)
            if m is not None and ref:
                score = m / ref
                h["straggler_score"] = score
                if score > self.STRAGGLER_RATIO:
                    h["straggler"] = True
            with self._lock:
                beats = [t for t in self._beats.get(w, ()) if t >= horizon]
            if len(beats) >= 3:
                ivals = [b - a for a, b in zip(beats, beats[1:])]
                med = _median(ivals) or 0.0
                mean = sum(ivals) / len(ivals)
                sd = math.sqrt(sum((x - mean) ** 2 for x in ivals)
                               / len(ivals))
                h["heartbeat_jitter"] = sd
                if med > 0 and sd > self.JITTER_RATIO * med:
                    h["heartbeat_unstable"] = True
            out[w] = h
        return out


# -- the operator table ---------------------------------------------------------

def fold_alert_stream(alerts) -> set:
    """Chronological fold of an alert stream (transition events and/or
    live active entries, oldest first) into the currently-live
    ``{(worker, rule)}`` set: fired/firing adds, a later resolved clears.
    The ONE interpretation of the stream — the table and the ``obs top``
    header both read it, so they cannot disagree."""
    live: set = set()
    for a in alerts or ():
        if not isinstance(a, dict):
            continue
        args = a.get("args", a)
        key = (str(args.get("worker", "") or ""),
               str(args.get("rule", "?")))
        if args.get("state", "firing") in ("fired", "firing"):
            live.add(key)
        elif args.get("state") == "resolved":
            live.discard(key)
    return live

def _latest_by_worker(samples, name: str) -> Dict[str, float]:
    """worker -> last sample value of ``name`` from a flat merged sample
    list (every pushed series carries the worker label contract)."""
    out: Dict[str, float] = {}
    for s in samples or ():
        if not isinstance(s, dict) or s.get("name") != name:
            continue
        v = s.get("value")
        if not isinstance(v, (int, float)):
            continue
        out[(s.get("labels") or {}).get("worker", "?")] = float(v)
    return out


def health_table(samples, alerts=None, health=None, actions=None) -> str:
    """The per-worker fleet table (``obs top`` / ``obs serve /summary``):
    one row per worker with goodput ratio, mfu, queue depth, straggler
    score and its active alerts — read from a merged sample list (live
    ``obs_stats`` or a dump on disk), so the table renders with or
    without a live master. ``health`` optionally takes the master's
    derived per-worker snapshot (``obs_health``) and fills the straggler /
    jitter / goodput cells the samples alone cannot carry. ``actions``
    optionally takes the committed fleet-actor journal and
    appends an "autoscale actions" tail — the operator's one-glance
    answer to "did the actor ACT or is the recommendation just held?"."""
    goodput = _latest_by_worker(samples, "goodput.ratio")
    mfu = _latest_by_worker(samples, "roofline.mfu")
    queue = _latest_by_worker(samples, "serving.queue_depth")
    score = _latest_by_worker(samples, "cluster.health_straggler_score")
    jitter = _latest_by_worker(samples, "cluster.health_heartbeat_jitter")
    for w, h in (health or {}).items():
        for field, dest in (("straggler_score", score),
                            ("heartbeat_jitter", jitter),
                            ("goodput_ewma", goodput)):
            v = h.get(field)
            if v is not None and w not in dest:
                dest[w] = float(v)
    workers = sorted((set(goodput) | set(mfu) | set(queue) | set(score)
                      | set(jitter)) - {"?"})
    by_worker_alerts: Dict[str, List[str]] = {}
    for w, rule in fold_alert_stream(alerts):
        by_worker_alerts.setdefault(w, []).append(rule)
    if not workers:
        return _actions_tail(actions)
    fmt = "{:<20} {:>8} {:>7} {:>6} {:>10} {:>8}  {}"
    lines = [fmt.format("worker", "goodput", "mfu", "queue",
                        "straggler", "hb_jit", "alerts")]

    def cell(d, w, pat="{:.2f}"):
        return pat.format(d[w]) if w in d else "-"

    for w in workers:
        rules = sorted(set(by_worker_alerts.get(w, [])
                           + by_worker_alerts.get("", [])))
        lines.append(fmt.format(
            w[:20], cell(goodput, w), cell(mfu, w),
            cell(queue, w, "{:.0f}"), cell(score, w),
            cell(jitter, w, "{:.3f}"),
            ",".join(rules) if rules else "-"))
    tail = _actions_tail(actions)
    return "\n".join(lines) + (("\n\n" + tail) if tail else "")


def _actions_tail(actions) -> str:
    """Render the committed autoscale-action journal (newest last)."""
    if not actions:
        return ""
    fmt = "{:>10} {:<6} {:<12} {:<20} {}"
    lines = ["== autoscale actions ==",
             fmt.format("ts", "action", "population", "worker", "reason")]
    for a in actions:
        if not isinstance(a, dict):
            continue
        try:
            ts = "{:.1f}".format(float(a.get("ts", 0.0)))
        except (TypeError, ValueError):
            ts = "-"
        lines.append(fmt.format(
            ts, str(a.get("action", "-"))[:6],
            str(a.get("population", "-"))[:12],
            str(a.get("worker", "-"))[:20],
            str(a.get("reason", ""))[:60]))
    return "\n".join(lines)
