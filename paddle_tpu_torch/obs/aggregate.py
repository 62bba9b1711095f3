"""Cluster metrics aggregation: workers push, the master merges — a copy of
``paddle_tpu/obs/aggregate.py`` for the port's master server.

* :class:`ClusterAggregator` — the master-side store. Workers push their
  registry snapshots over the ``obs_push`` RPC
  (:meth:`MasterClient.obs_push`); the aggregator keeps the latest
  snapshot per worker and serves the merged sample list with every series
  label-tagged ``worker=<id>``. Every push also lands in the windowed
  :class:`~paddle_tpu_torch.obs.health.TimeSeriesStore` (``history``),
  which the serving router's placement reads, and an evaluation pass
  derives per-worker health (``health``).
* :class:`ObsPusher` — the worker-side background thread: every
  ``interval`` seconds (and once at stop) it pushes a registry's
  snapshot.

Left out until the port has the rest of the obs plane (ROADMAP A.8): the
alert engine (JAX's ``obs/alerts.py``: ``self.alerts``, the serving SLO
exemplars), the request-timeline store (``obs/requests.py``:
``self.requests``, ``push_requests``), the HTTP view ``ObsHttpServer``
(``obs/export.py``), the pusher's session registry, and the obs counters
and gauges JAX's copy emits (``master.obs_workers``,
``cluster.health_*``, ``cluster.autoscale_committed``,
``cluster.actor_actions_total``, ``obs.push*_total``); the derived health
values are still recorded into ``history``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

#: sample fields the aggregator accepts off the wire — anything else is
#: dropped (a worker running newer code must not smuggle unbounded junk
#: into the master's memory)
_SAMPLE_KEYS = frozenset((
    "type", "name", "help", "labels", "value", "high_water",
    "buckets", "sum", "count", "max", "delta"))
_MAX_SAMPLES_PER_PUSH = 10_000


def _clean_sample(s: Any) -> Optional[Dict[str, Any]]:
    if not isinstance(s, dict) or not isinstance(s.get("name"), str):
        return None
    # every exporter keys on "type" and does arithmetic on the numeric
    # fields — a sample that would crash a later /metrics render is
    # dropped HERE, not stored (one bad push must not poison every scrape)
    if s.get("type") not in ("counter", "gauge", "histogram"):
        return None
    out = {k: v for k, v in s.items() if k in _SAMPLE_KEYS}
    for k in ("value", "high_water", "sum", "max", "delta"):
        if k in out:
            try:
                out[k] = float(out[k])
            except (TypeError, ValueError):
                return None
    if "count" in out:
        try:
            out["count"] = int(out["count"])
        except (TypeError, ValueError):
            return None
    if "buckets" in out:
        # exporters iterate [le, cumulative] pairs and do arithmetic on
        # both; anything else would 500 every later scrape
        try:
            out["buckets"] = [
                [le if le == "+Inf" else float(le), int(cum)]
                for le, cum in out["buckets"]]
        except (TypeError, ValueError):
            return None
    labels = out.get("labels")
    out["labels"] = ({str(k): str(v) for k, v in labels.items()}
                     if isinstance(labels, dict) else {})
    return out


def telemetry_client(host: str, port: int):
    """Fail-fast MasterClient for telemetry traffic (pushes and scrapes):
    ONE attempt, short socket deadline. Telemetry must never inherit the
    data plane's 5-attempt backoff budget — a down master should cost a
    scrape a few seconds, not wedge it (or a lock-sharing caller) for the
    full retry window."""
    from ..runtime.master_service import MasterClient
    return MasterClient(host, int(port), retries=1, call_timeout=3.0)


def wire_safe_samples(samples: Any) -> List[Any]:
    """JSON-frame-safe copy of collect() samples: nonfinite floats become
    the strings ``"NaN"``/``"+Inf"``/``"-Inf"`` — ``json.dumps`` would
    otherwise emit bare ``NaN``/``Infinity`` tokens, which are not legal
    JSON and which the native frame parser rejects (one inf gauge would
    permanently fail a worker's pushes). The strings round-trip on the
    receiving side: ``float("+Inf")``/``float("NaN")`` in
    :func:`_clean_sample` restore the values."""
    import math

    def fix(v):
        if isinstance(v, float) and not math.isfinite(v):
            return "NaN" if math.isnan(v) else ("+Inf" if v > 0 else "-Inf")
        return v

    out: List[Any] = []
    for s in samples:
        if not isinstance(s, dict):
            out.append(s)
            continue
        s = {k: fix(v) for k, v in s.items()}
        try:
            if isinstance(s.get("buckets"), list):
                s["buckets"] = [[fix(le), cum] for le, cum in s["buckets"]]
        except (TypeError, ValueError):
            pass                      # malformed: the server will drop it
        out.append(s)
    return out


class ClusterAggregator:
    """Latest-snapshot-per-worker store behind the master's ``obs_push``
    — plus the fleet health plane: every push also lands in a bounded
    windowed :class:`~paddle_tpu_torch.obs.health.TimeSeriesStore`
    (``history``), and a rate-limited evaluation pass derives per-worker
    health (``health`` — straggler score, heartbeat jitter, goodput EWMA,
    recorded back into the store).

    ``ttl`` bounds both memory and staleness: worker ids embed pids, so a
    chaos-churned fleet (preempt, restart, repeat for days) would
    otherwise accumulate one frozen snapshot per dead incarnation forever.
    A worker that stops pushing for ``ttl`` seconds ages out of the
    merged view (and out of memory) on the next push or read; its history
    series age out with it.
    """

    def __init__(self, ttl: float = 900.0,
                 clock: Optional[Callable[[], float]] = None,
                 window_s: float = 300.0, max_points: int = 240,
                 eval_interval_s: float = 2.0):
        import time
        from .health import FleetHealth, TimeSeriesStore
        self.ttl = ttl
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        # worker -> (last_push_monotonic, cleaned samples)
        self._snaps: Dict[str, Any] = {}
        self.history = TimeSeriesStore(window_s=window_s,
                                       max_points=max_points,
                                       clock=self._clock)
        self.health = FleetHealth(clock=self._clock)
        self.eval_interval_s = float(eval_interval_s)
        self._last_eval = float("-inf")
        self._health_snapshot: Dict[str, Dict[str, Any]] = {}
        #: committed fleet-actor actions, newest last — what
        #: lets an operator tell "recommendation held" from "actor acted"
        self.actions: deque = deque(maxlen=64)

    def _prune_locked(self) -> None:
        cutoff = self._clock() - self.ttl
        dead = [w for w, (ts, _) in self._snaps.items() if ts < cutoff]
        for wid in dead:
            del self._snaps[wid]
        if dead:
            # prune history to workers still alive by EITHER signal:
            # pushing snapshots, or feeding the health plane (elastic
            # workers feed shard timings/heartbeats without ever
            # obs_pushing — membership leave/evict forget()s them, which
            # is what lets their series age out here)
            self.history.prune(set(self._snaps)
                               | self.health.known_workers())

    def push(self, worker: str, samples: Any) -> int:
        """Replace ``worker``'s snapshot; returns the accepted count. The
        cleaned samples also append to the windowed history, and (rate-
        limited by ``eval_interval_s``) the health/alert pass runs."""
        if not isinstance(samples, (list, tuple)):
            samples = []
        cleaned = []
        for s in samples[:_MAX_SAMPLES_PER_PUSH]:
            c = _clean_sample(s)
            if c is not None:
                cleaned.append(c)
        now = self._clock()
        with self._lock:
            self._snaps[str(worker)] = (now, cleaned)
            self._prune_locked()
        self.history.record(worker, cleaned, ts=now)
        self.maybe_evaluate(now)
        return len(cleaned)

    # -- the health/alert evaluation pass -----------------------------------
    def maybe_evaluate(self, now: Optional[float] = None) -> bool:
        """Run the derivation + alert pass if ``eval_interval_s`` elapsed
        since the last one (the push path's rate limit); tests drive
        :meth:`evaluate` directly."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            if now - self._last_eval < self.eval_interval_s:
                return False
            self._last_eval = now
        self.evaluate(now)
        return True

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Derive per-worker health and record the ``cluster.health_*``
        values into the history. Returns the health snapshot."""
        now = self._clock() if now is None else float(now)
        snap = self.health.snapshot(self.history, now=now)

        def record(metric: str, v: float, w: str) -> None:
            # back into the store: alert rules threshold derived health
            # exactly like any pushed series
            self.history.record_value(w, metric, v,
                                      labels={"worker": w}, ts=now)

        for w, h in snap.items():
            v = h.get("straggler_score")
            if v is not None:
                record("cluster.health_straggler_score", v, w)
            v = h.get("goodput_ewma")
            if v is not None:
                record("cluster.health_goodput_ewma", v, w)
            v = h.get("heartbeat_jitter")
            if v is not None:
                record("cluster.health_heartbeat_jitter", v, w)
        with self._lock:
            self._health_snapshot = snap
        return snap

    def forget_worker(self, worker: str) -> None:
        """A worker authoritatively departed (membership leave/eviction):
        drop its health feeds AND its history series now — the next alert
        evaluation then resolves anything firing on it (series_gone)
        instead of freezing a dead incarnation's alert as active."""
        self.health.forget(worker)
        self.history.drop_worker(worker)

    def note_action(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        """Journal one COMMITTED autoscale action (the ``act_report``
        ext-op lands here): stamps the aggregator clock, appends to the
        bounded journal, and records the committed-action signal —
        ``cluster.autoscale_committed`` is the acted-on twin of the
        tentative ``cluster.autoscale_signal``, and diverges from it
        exactly while hysteresis/cooldowns hold the fleet still."""
        from .health import MASTER_WORKER
        now = self._clock()
        e = {"ts": now,
             "actor": str(entry.get("actor", "")),
             "action": str(entry.get("action", "")),
             "population": str(entry.get("population", "")),
             "worker": str(entry.get("worker", "")),
             "reason": str(entry.get("reason", ""))[:400],
             "signal": float(entry.get("signal", 0.0) or 0.0)}
        with self._lock:
            self.actions.append(e)
        self.history.record_value(MASTER_WORKER,
                                  "cluster.autoscale_committed",
                                  e["signal"], ts=now)
        return e

    def recent_actions(self, n: int = 32) -> List[Dict[str, Any]]:
        """The newest ``n`` committed actions, oldest first (the
        ``obs_health`` reply's ``actions`` field)."""
        with self._lock:
            return list(self.actions)[-n:]

    def health_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """The last evaluated per-worker health (the ``obs_health`` op's
        payload); empty before the first evaluation."""
        with self._lock:
            return {w: dict(h) for w, h in self._health_snapshot.items()}

    def workers(self) -> List[str]:
        with self._lock:
            self._prune_locked()
            return sorted(self._snaps)

    def merged_samples(self) -> List[Dict[str, Any]]:
        """Live workers' samples, each tagged ``worker=<id>`` (an existing
        worker label — a relayed merge — wins)."""
        with self._lock:
            self._prune_locked()
            items = sorted((w, s) for w, (_, s) in self._snaps.items())
        out: List[Dict[str, Any]] = []
        for wid, samples in items:
            for s in samples:
                s = dict(s)
                labels = dict(s.get("labels") or {})
                labels.setdefault("worker", wid)
                s["labels"] = labels
                out.append(s)
        return out


class ObsPusher:
    """Background worker->master snapshot pusher.

    Args:
      client: a :class:`~paddle_tpu_torch.runtime.master_service.MasterClient`
        (or anything with ``obs_push(worker, samples)``).
      worker: this worker's id in the merged view.
      registry: the snapshot source, anything with ``collect()`` (JAX's
        default, the installed session's registry, waits for the port's
        session plane).
      interval: seconds between pushes; the stop path pushes once more so
        short runs still land their final counts.
    """

    def __init__(self, client, worker: str, registry, interval: float = 2.0):
        self.client = client
        self.worker = str(worker)
        self.registry = registry
        self.interval = interval
        self.failures = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def push_once(self) -> bool:
        try:
            self.client.obs_push(self.worker, self.registry.collect())
        except (OSError, ConnectionError):
            # the master being down is a data-plane problem the retry
            # layers already surface; telemetry just counts and moves on
            self.failures += 1
            return False
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.push_once()

    def start(self) -> "ObsPusher":
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="obs-pusher")
            self._thread.start()
        return self

    def stop(self, final_push: bool = True) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        if final_push:
            self.push_once()
