"""Cluster metrics aggregation: workers push, the master merges and serves.

The multi-process half of the session plane: each process has its own
registry and dump, but the system the paper describes is a trainer fleet plus a
master — fleet-level telemetry (the Ascend field-study lesson, PAPERS.md
arXiv 2607.08215) needs ONE merged view. Three pieces:

* :class:`ClusterAggregator` — the master-side store. Workers push their
  registry snapshots over the new ``obs_push`` RPC
  (:meth:`MasterClient.obs_push`); the aggregator keeps the latest
  snapshot per worker and serves the merged sample list with every series
  label-tagged ``worker=<id>`` (the merged-registry label contract:
  same-named series from different workers stay distinct series).
* :class:`ObsPusher` — the worker-side background thread: every
  ``interval`` seconds (and once at stop) it pushes the current registry
  snapshot. Push failures are counted, never raised — telemetry must not
  take down the training loop it observes.
* :class:`ObsHttpServer` — a read-only HTTP endpoint (``python -m paddle_tpu_torch obs
  serve``) exposing ``/metrics`` (Prometheus text), ``/trace`` (Chrome
  JSON) and ``/summary`` over any dump provider — merged files on disk or
  a live master's ``obs_stats``.
"""

from __future__ import annotations

import json
import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import count as _count
from . import gauge_set as _gauge_set

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
    — plus the fleet health plane: every push also lands
    in a bounded windowed :class:`~paddle_tpu_torch.obs.health.TimeSeriesStore`
    (``history``), and a rate-limited evaluation pass derives per-worker
    health (``health`` — straggler score, heartbeat jitter, goodput EWMA;
    emitted as ``cluster.health_*`` gauges and recorded back into the
    store) and runs the declarative ``alerts`` engine over it.

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
                 rules: Any = None, eval_interval_s: float = 2.0):
        import time
        from .alerts import AlertEngine, default_rules
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
        self.alerts = AlertEngine(
            default_rules() if rules is None else rules, self.history)
        self.eval_interval_s = float(eval_interval_s)
        self._last_eval = float("-inf")
        self._health_snapshot: Dict[str, Dict[str, Any]] = {}
        # per-request timeline aggregation (obs/requests.py): workers'
        # ledger exports land here; burn-rate alert transitions get the
        # slowest-K exemplars attached at evaluation time
        from .requests import RequestStore
        self.requests = RequestStore(clock=self._clock)
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
            n_workers = len(self._snaps)
        self.history.record(worker, cleaned, ts=now)
        _gauge_set("master.obs_workers", n_workers)
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
        """Derive per-worker health, emit/record the ``cluster.health_*``
        gauges, then evaluate the alert rules. Returns the health
        snapshot."""
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
                _gauge_set("cluster.health_straggler_score", v, worker=w)
                record("cluster.health_straggler_score", v, w)
            v = h.get("goodput_ewma")
            if v is not None:
                _gauge_set("cluster.health_goodput_ewma", v, worker=w)
                record("cluster.health_goodput_ewma", v, w)
            v = h.get("heartbeat_jitter")
            if v is not None:
                _gauge_set("cluster.health_heartbeat_jitter", v, worker=w)
                record("cluster.health_heartbeat_jitter", v, w)
        with self._lock:
            self._health_snapshot = snap
        transitions = self.alerts.evaluate(now)
        if transitions:
            # answer "burn driven by WHAT" at the moment it fires: the
            # slowest-K stitched timelines decorate each serving SLO
            # transition IN PLACE — the same dicts live in the engine's
            # bounded events deque, so /alerts and the flight ring see
            # the exemplars for free
            ex = None
            for ev in transitions:
                args = ev.get("args") or {}
                if args.get("state") != "fired" or not str(
                        args.get("metric", "")).startswith("serving."):
                    continue
                if ex is None:
                    ex = self.requests.exemplars()
                if ex:
                    args["exemplars"] = ex
        return snap

    def forget_worker(self, worker: str) -> None:
        """A worker authoritatively departed (membership leave/eviction):
        drop its health feeds AND its history series now — the next alert
        evaluation then resolves anything firing on it (series_gone)
        instead of freezing a dead incarnation's alert as active."""
        self.health.forget(worker)
        self.history.drop_worker(worker)
        # completed requests lose the departed worker's legs; in-flight
        # ones keep them — their re-routed remainder still needs to
        # stitch against what this worker recorded before it died
        self.requests.forget_worker(worker)

    def push_requests(self, worker: str, timelines: Any) -> int:
        """Absorb one worker's request-timeline export (the scrape pump
        and the daemons' loopback push land here); wire-tolerant."""
        return self.requests.push(str(worker), timelines)

    def note_action(self, entry: Dict[str, Any]) -> Dict[str, Any]:
        """Journal one COMMITTED autoscale action (the ``act_report``
        ext-op lands here): stamps the aggregator clock, appends to the
        bounded journal, and emits/records the committed-action signal —
        ``cluster.autoscale_committed`` is the acted-on twin of the
        tentative ``cluster.autoscale_signal`` gauge, and diverges from
        it exactly while hysteresis/cooldowns hold the fleet still."""
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
        _gauge_set("cluster.autoscale_committed", e["signal"])
        _count("cluster.actor_actions_total",
               population=e["population"] or "unknown",
               action=e["action"] or "unknown")
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
      registry: snapshot source; defaults to the installed session's
        registry at each push (so a late-installed session still reports).
      interval: seconds between pushes; the stop path pushes once more so
        short runs still land their final counts.
    """

    def __init__(self, client, worker: str, registry=None,
                 interval: float = 2.0):
        self.client = client
        self.worker = str(worker)
        self.registry = registry
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _samples(self) -> Optional[List[Dict[str, Any]]]:
        reg = self.registry
        if reg is None:
            from . import _SESSION   # read the live value at call time
            reg = _SESSION.registry if _SESSION is not None else None
        return reg.collect() if reg is not None else None

    def push_once(self) -> bool:
        samples = self._samples()
        if samples is None:
            return False
        try:
            self.client.obs_push(self.worker, samples)
        except (OSError, ConnectionError):
            # the master being down is a data-plane problem the retry
            # layers already surface; telemetry just counts and moves on
            _count("obs.push_failures_total")
            return False
        _count("obs.pushes_total")
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


class ObsHttpServer:
    """Read-only HTTP view over a dump provider (``python -m paddle_tpu_torch obs serve``).

    ``provider`` is called per request so the served view is always
    current (re-reading dump files, or re-polling a live master). GET
    only; any other method is 405; unknown paths 404.
    """

    ROUTES = ("/metrics", "/trace", "/summary", "/alerts", "/requests",
              "/")

    def __init__(self, provider: Callable[[], Dict[str, Any]],
                 host: str = "127.0.0.1", port: int = 0):
        import http.server

        from .export import chrome_trace, prometheus_text, summary
        from .health import health_table
        from .requests import group_legs, stitch
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):   # tests stay quiet
                pass

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = prometheus_text(outer.provider()).encode()
                        ctype = "text/plain; version=0.0.4"
                    elif path == "/trace":
                        body = json.dumps(
                            chrome_trace(outer.provider())).encode()
                        ctype = "application/json"
                    elif path == "/alerts":
                        # alert transitions are dump EVENTS (name="alert")
                        # plus whatever live state the provider attached
                        # ("alerts" key, master mode) — file mode works
                        # from the events alone
                        dump = outer.provider()
                        events = [e for e in dump.get("events", ())
                                  if e.get("name") == "alert"]
                        body = json.dumps(
                            {"active": dump.get("alerts") or [],
                             "events": events,
                             "actions": dump.get("actions") or []},
                            indent=1).encode()
                        ctype = "application/json"
                    elif path == "/requests":
                        # raw leg timelines ride the dump ("requests"
                        # key: session dumps, merged files, or the
                        # master's store) — stitched here so every
                        # consumer sees one timeline per request
                        dump = outer.provider()
                        reqs = []
                        for legs in group_legs(
                                dump.get("requests")).values():
                            st = stitch(legs)
                            if st is not None:
                                reqs.append(st)
                        reqs.sort(key=lambda s: s.get("t0_unix", 0.0))
                        body = json.dumps(
                            {"requests": reqs,
                             "exemplars": dump.get("exemplars") or []},
                            indent=1).encode()
                        ctype = "application/json"
                    elif path in ("/summary", "/"):
                        dump = outer.provider()
                        text = summary(dump)
                        table = health_table(
                            dump.get("metrics", ()),
                            alerts=[e for e in dump.get("events", ())
                                    if e.get("name") == "alert"]
                            + (dump.get("alerts") or []),
                            health=dump.get("health"),
                            actions=dump.get("actions"))
                        if table:
                            text += "\n== fleet health ==\n" + table
                        body = (text + "\n").encode()
                        ctype = "text/plain"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:    # a torn dump must not kill serve
                    # control chars stripped: the message lands in the
                    # HTTP status line, and a hostile upstream error
                    # string with CRLF would otherwise inject headers
                    detail = "".join(
                        ch for ch in f"{type(e).__name__}: {e}"[:200]
                        if ch.isprintable())
                    self.send_error(500, detail)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        class Server(http.server.ThreadingHTTPServer):
            daemon_threads = True

        self.provider = provider
        self._server = Server((host, port), Handler)
        self.address = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObsHttpServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="obs-serve")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
