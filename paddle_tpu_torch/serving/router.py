"""The serving router — placement over disaggregated workers; the
counterpart of ``paddle_tpu/serving/router.py`` over the port's daemons,
membership and aggregator, with JAX's obs calls: the scrape of the
workers' request timelines (``srv_requests``) and the router's own into
the aggregator, and the ``router.*`` counters and gauges.

One router (``python -m paddle_tpu_torch route``) fronts a fleet of serving workers
(:class:`~.daemon.ServingDaemon` decode engines and optional
:class:`~.daemon.PrefillDaemon` prefill workers). It is model-free: it
owns a :class:`~..runtime.membership.MembershipService` the workers join
(heartbeat leases, epoch-numbered views, eviction on TTL) and a windowed
health store their load is scraped into, and places every client submit
over that state:

* **Placement from health TRENDS, not instantaneous scrapes** — each
  candidate decode worker is scored by the EWMA of its windowed
  ``serving.queue_depth`` + ``serving.slots_live`` series
  (:func:`~..obs.health.ewma` over :meth:`TimeSeriesStore.points`), so
  one lucky idle scrape cannot steer a stampede at a saturated worker;
  a fresh worker with no history scores 0 and absorbs traffic first.
* **Disaggregation** — when prefill workers are joined, a submit is
  forwarded to the least-loaded prefill worker (``srv_prefill``) naming
  the chosen decode worker; the prefill worker admits, exports the KV
  pages (serving/ship.py) and ships them; the reply carries the DECODE
  worker's rid. With no prefill workers the router degrades to direct
  ``srv_submit`` on the decode worker.
* **Backpressure aggregation** — a candidate's structured ``overloaded``
  refusal moves placement to the next candidate; when EVERY pool
  refuses, the client gets one structured ``overloaded`` refusal with
  the MINIMUM ``retry_after_s`` hint seen (the soonest any pool expects
  to drain) — never a hang, never a traceback.
* **Re-route on eviction** — the membership subscription marks every
  in-flight request whose worker was evicted; the next poll re-places
  it by RE-PREFILLING ``prompt + delivered tokens`` with the remaining
  budget (greedy determinism makes the continuation exactly the tokens
  the dead worker would have produced; the prefix index makes the
  re-prefill near-free) under a DERIVED submit_key
  (``{key}#r{n}``), and the client-facing token buffer just keeps
  growing — cursors never see the seam, so zero tokens are lost or
  duplicated (tests/test_torch_router.py pins this).

Idempotency ladder (docs/design/serving.md "Disaggregation & routing"):
client ``submit_key`` → router replay cache (same rid; a resubmission
may not inflate its ``prefix_len`` claim — the shared replay-hardening
rule) → forwarded to workers under the same key → worker replay cache →
decode-side adopt replay cache. A restarted router holds none of its
records; the client ladder (:class:`RouterClient`) resubmits the
ORIGINAL request under the ORIGINAL key and resumes its cursor at the
last delivered token — whichever worker the retry lands on, greedy
determinism + the replay caches make the continuation exact.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import faults, obs
from ..obs.health import ewma
from ..runtime.master_service import MasterServer
from ..runtime.membership import MembershipService
from ..utils.retry import RetryPolicy
from .batcher import prefix_resubmission_error
from .daemon import ServingClient
from .engine import Overloaded

#: re-routes one request may burn before the router declares it failed
#: (reason="error") — each re-route re-prefills, so a flapping fleet
#: must not grind one stream forever
_MAX_REROUTES = 8


class _RouteRec:
    """One client-visible request: the original submission (enough to
    re-prefill it verbatim), the append-only token buffer client cursors
    read, and the CURRENT worker placement. ``plock`` serializes the
    poll-through/re-route path per request."""

    __slots__ = ("rid", "key", "prompt", "max_new", "eos_id", "timeout_s",
                 "tenant", "slo", "prefix_len", "tokens", "done", "reason",
                 "worker", "remote_rid", "remote_cursor", "reroutes",
                 "lost_reason", "plock")

    def __init__(self, rid, key, prompt, max_new, eos_id, timeout_s,
                 tenant, slo, prefix_len):
        self.rid = rid
        self.key = key
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos_id = eos_id
        self.timeout_s = timeout_s
        self.tenant = tenant
        self.slo = slo
        self.prefix_len = prefix_len
        self.tokens: List[int] = []
        self.done = False
        self.reason = ""
        self.worker: Optional[str] = None
        self.remote_rid: Optional[int] = None
        self.remote_cursor = 0
        self.reroutes = 0
        #: why the placement went away (set by the eviction subscriber;
        #: consumed as the reroutes_total reason label)
        self.lost_reason: Optional[str] = None
        self.plock = threading.Lock()


class ServingRouter:
    """Router daemon: membership + health + placement + re-route.

    ``start()`` brings up the RPC server, the membership expiry thread
    and the health-scrape pump; workers then ``join_router`` themselves.
    The route_* ops mirror the srv_* client contract (same reply shapes,
    same structured refusal codes), so :class:`RouterClient` is
    :class:`~.daemon.ServingClient` pointed at different op names."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 ttl: float = 3.0, scrape_interval_s: float = 0.25,
                 max_reroutes: int = _MAX_REROUTES):
        self.server = MasterServer(host, port)
        self.membership = MembershipService(ttl=ttl)
        self.membership.attach(self.server)
        self.membership.subscribe(self._on_membership)
        for op, fn in (("route_submit", self._route_submit),
                       ("route_poll", self._route_poll),
                       ("route_cancel", self._route_cancel),
                       ("route_stats", self._route_stats)):
            self.server.register_op(op, self._stamped(fn))
        # per-request timelines: the router records its own phases AND
        # aggregates every worker's (scrape pump + RequestStore) so a
        # re-routed request stitches across workers (obs/requests.py)
        obs.ensure_request_ledger()
        self._scrape_interval = scrape_interval_s
        self._max_reroutes = max_reroutes
        self._lock = threading.Lock()
        self._recs: Dict[int, _RouteRec] = {}
        self._by_key: Dict[str, int] = {}
        self._next_rid = 0
        self._clients: Dict[str, ServingClient] = {}
        self._clients_lock = threading.Lock()
        self._stop = threading.Event()
        self._pump: Optional[threading.Thread] = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def start(self) -> "ServingRouter":
        self.server.start()
        self.membership.start()
        self._pump = threading.Thread(target=self._run_pump, daemon=True,
                                      name="router-pump")
        self._pump.start()
        return self

    def stop(self) -> None:
        if self._stop.is_set():
            return                  # idempotent: restart tests stop twice
        self._stop.set()
        if self._pump is not None:
            self._pump.join(timeout=5.0)
            self._pump = None
        self.membership.stop()
        self.server.stop()
        with self._clients_lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()

    def _stamped(self, fn):
        """Every route_* reply carries the membership epoch — the client
        plumbing records it (`last_epoch`) and reports it in the final
        reconnect error."""
        def handler(req):
            resp = fn(req)
            if isinstance(resp, dict) and "epoch" not in resp:
                resp = dict(resp, epoch=self.membership.epoch)
            return resp
        return handler

    # -- membership + health ----------------------------------------------
    def _members(self, role: str) -> List[Tuple[str, str, int]]:
        """Live (worker, host, port) triples with the given role cap."""
        out = []
        for m in self.membership.view()["members"]:
            caps = m.get("caps") or {}
            if caps.get("role") == role and "rpc_port" in caps:
                out.append((m["worker"], str(caps.get("rpc_host",
                                                      "127.0.0.1")),
                            int(caps["rpc_port"])))
        return out

    def _worker_client(self, worker: str, host: str,
                       port: int) -> ServingClient:
        with self._clients_lock:
            c = self._clients.get(worker)
            if c is not None and c.endpoints[0] != (host, port):
                c.close()               # same name, new incarnation
                c = None
            if c is None:
                # short reconnect budget: a dead worker must fail the
                # poll/forward fast so the re-route ladder runs, instead
                # of riding the default multi-second backoff
                c = ServingClient(host, port, retries=2, retry_delay=0.05,
                                  call_timeout=10.0)
                self._clients[worker] = c
            return c

    def _on_membership(self, view, joined, left, reason) -> None:
        """Membership subscriber (runs outside the membership lock): a
        departed worker's in-flight requests are marked for re-route —
        the next poll on each re-places it."""
        for w in left:
            with self._clients_lock:
                c = self._clients.pop(w, None)
            if c is not None:
                c.close()
            self.server.aggregator.forget_worker(w)
            # membership notifies reason="evicted" (TTL expiry) vs
            # "leave"/"join" (graceful departure / replaced incarnation)
            why = "evicted" if reason == "evicted" else "left"
            with self._lock:
                for rec in self._recs.values():
                    if rec.worker == w and not rec.done:
                        rec.worker = None
                        rec.remote_rid = None
                        rec.lost_reason = why

    def _run_pump(self) -> None:
        """Health pump: scrape every member's srv_stats into the windowed
        time-series store — the TREND data placement scores read. A
        scrape failure records nothing (the lease TTL owns eviction)."""
        while not self._stop.wait(self._scrape_interval):
            try:
                self._scrape_once()
            except Exception:
                pass    # telemetry must never take the router down

    def _scrape_once(self) -> None:
        hist = self.server.aggregator.history
        n_role = {"decode": 0, "prefill": 0}
        for role in ("decode", "prefill"):
            for worker, host, port in self._members(role):
                n_role[role] += 1
                try:
                    st = self._worker_client(worker, host,
                                             port).serving_stats()
                except Exception:
                    continue
                hist.record_value(worker, "serving.queue_depth",
                                  float(st.get("queue_depth", 0)))
                hist.record_value(worker, "serving.slots_live",
                                  float(st.get("slots_live", 0)))
                try:
                    # timelines ride the same pump: pulled continuously,
                    # so a kill -9'd worker's phases survive here
                    rq = self._worker_client(worker, host,
                                             port).serving_requests()
                except Exception:
                    rq = None
                if rq:
                    self.server.aggregator.push_requests(worker, rq)
        led = obs.request_ledger()
        if led is not None:
            self.server.aggregator.push_requests("router",
                                                 led.export(n=256))
        with self._lock:
            inflight = sum(1 for r in self._recs.values() if not r.done)
        obs.gauge_set("router.inflight", inflight)
        obs.gauge_set("router.workers", n_role["decode"], role="decode")
        obs.gauge_set("router.workers", n_role["prefill"], role="prefill")

    def _score(self, worker: str) -> float:
        """A worker's load score: EWMA over its windowed queue-depth and
        live-slot series. Trends, not the last scrape — and a fresh
        worker with no history scores 0, so it absorbs traffic first."""
        hist = self.server.aggregator.history
        score = 0.0
        for name in ("serving.queue_depth", "serving.slots_live"):
            mean, _ = ewma([v for _, v in hist.points(worker, name)])
            score += 0.0 if mean is None else float(mean)
        return score

    def _candidates(self, role: str) -> List[Tuple[str, str, int]]:
        ms = self._members(role)
        return sorted(ms, key=lambda m: (self._score(m[0]), m[0]))

    # -- placement ---------------------------------------------------------
    def _place(self, prompt, max_new, *, eos_id, timeout_s, tenant, slo,
               prefix_len, submit_key) -> Tuple[str, int]:
        """Forward a submission to the best candidate; walks the
        candidate list past overloaded/unreachable workers. Returns
        ``(worker, remote_rid)``; raises :class:`Overloaded` with the
        minimum retry hint when every pool refused, ConnectionError when
        nothing was reachable."""
        decodes = self._candidates("decode")
        if not decodes:
            raise ConnectionError("no decode workers joined")
        prefills = self._candidates("prefill")
        retry_hints: List[float] = []
        unreachable = 0
        for worker, host, port in decodes:
            faults.fire("route.submit")
            try:
                if prefills:
                    rid = self._forward_via_prefill(
                        prefills, worker, host, port, prompt, max_new,
                        eos_id=eos_id, timeout_s=timeout_s, tenant=tenant,
                        slo=slo, prefix_len=prefix_len,
                        submit_key=submit_key)
                else:
                    rid = self._worker_client(worker, host, port).submit(
                        prompt, max_new, eos_id=eos_id,
                        timeout_s=timeout_s, tenant=tenant, slo=slo,
                        prefix_len=prefix_len, submit_key=submit_key)
            except Overloaded as e:
                retry_hints.append(float(e.retry_after_s))
                continue
            except ConnectionError:
                unreachable += 1
                continue
            return worker, rid
        if retry_hints:
            raise Overloaded(
                f"all {len(decodes)} decode pool(s) are saturated "
                f"({unreachable} unreachable)", min(retry_hints))
        raise ConnectionError(
            f"no decode worker reachable ({len(decodes)} joined)")

    def _forward_via_prefill(self, prefills, decode_worker, decode_host,
                             decode_port, prompt, max_new, *, eos_id,
                             timeout_s, tenant, slo, prefix_len,
                             submit_key) -> int:
        """Disaggregated forward: srv_prefill on the best prefill worker,
        naming the chosen decode worker. Falls past overloaded/dead
        prefill workers; with all of them out, falls back to direct
        decode-side prefill (degraded, but the request completes)."""
        last: Optional[Exception] = None
        for worker, host, port in prefills:
            req = {"op": "srv_prefill",
                   "prompt": [int(t) for t in np.asarray(prompt)
                              .reshape(-1)],
                   "max_new": int(max_new),
                   "decode_host": decode_host,
                   "decode_port": int(decode_port)}
            if eos_id is not None:
                req["eos_id"] = int(eos_id)
            if timeout_s is not None:
                req["timeout_s"] = float(timeout_s)
            if tenant != "default":
                req["tenant"] = str(tenant)
            if slo != "interactive":
                req["slo"] = str(slo)
            if prefix_len is not None:
                req["prefix_len"] = int(prefix_len)
            if submit_key is not None:
                req["submit_key"] = str(submit_key)
            try:
                r = self._worker_client(worker, host, port)._call(req)
            except ConnectionError as e:
                last = e
                continue
            if r.get("ok"):
                return int(r["rid"])
            code = r.get("code")
            if code == "overloaded":
                raise Overloaded(str(r.get("error")),
                                 float(r.get("retry_after_s", 0.2)))
            if code == "invalid_argument":
                raise ValueError(str(r.get("error", "prefill refused")))
            last = ConnectionError(str(r.get("error", "prefill failed")))
        # every prefill worker down or refusing: decode-side prefill
        # still serves the request (degraded but correct)
        obs.count("router.reroutes_total", reason="prefill_fallback")
        return self._worker_client(decode_worker, decode_host,
                                   decode_port).submit(
            prompt, max_new, eos_id=eos_id, timeout_s=timeout_s,
            tenant=tenant, slo=slo, prefix_len=prefix_len,
            submit_key=submit_key)

    # -- op handlers -------------------------------------------------------
    def _route_submit(self, req):
        key = req.get("submit_key")
        if key is not None:
            with self._lock:
                rid = self._by_key.get(str(key))
                rec = self._recs.get(rid) if rid is not None else None
            if rec is not None:
                # the shared replay-hardening rule: a resubmission may
                # not inflate its cached-prefix claim past the original
                err = prefix_resubmission_error(req.get("prefix_len"),
                                                rec.prefix_len)
                if err is not None:
                    obs.count("router.requests_total",
                              outcome="invalid_argument")
                    return {"ok": False, "error": err,
                            "code": "invalid_argument"}
                return {"ok": True, "rid": rec.rid}
        try:
            prompt = np.asarray(req.get("prompt", ()),
                                np.int32).reshape(-1)
            max_new = int(req.get("max_new", 0))
        except (TypeError, ValueError):
            obs.count("router.requests_total", outcome="invalid_argument")
            return {"ok": False, "code": "invalid_argument",
                    "error": "route_submit needs prompt + max_new"}
        eos = req.get("eos_id")
        timeout = req.get("timeout_s")
        prefix = req.get("prefix_len")
        kw = dict(eos_id=None if eos is None else int(eos),
                  timeout_s=None if timeout is None else float(timeout),
                  tenant=str(req.get("tenant", "default")),
                  slo=str(req.get("slo", "interactive")),
                  prefix_len=None if prefix is None else int(prefix))
        obs.req_phase(key, "admitted", via="router")
        try:
            worker, remote_rid = self._place(
                prompt, max_new, submit_key=key, **kw)
        except Overloaded as e:
            obs.count("router.requests_total", outcome="overloaded")
            return {"ok": False, "error": f"overloaded: {e}",
                    "code": "overloaded", "retry_after_s": e.retry_after_s}
        except ValueError as e:
            obs.count("router.requests_total", outcome="invalid_argument")
            return {"ok": False, "error": str(e),
                    "code": "invalid_argument"}
        except ConnectionError as e:
            obs.count("router.requests_total", outcome="unavailable")
            return {"ok": False, "error": str(e), "code": "unavailable"}
        with self._lock:
            # a concurrent identical-key submit may have won the insert
            # race while we forwarded; the first record wins (the extra
            # remote admission is orphaned — never polled, it times out
            # or runs to completion unobserved)
            if key is not None and str(key) in self._by_key:
                return {"ok": True,
                        "rid": self._recs[self._by_key[str(key)]].rid}
            self._next_rid += 1
            rec = _RouteRec(self._next_rid, None if key is None
                            else str(key), prompt, max_new, **kw)
            rec.worker, rec.remote_rid = worker, remote_rid
            self._recs[rec.rid] = rec
            if key is not None:
                self._by_key[str(key)] = rec.rid
            self._prune_done_locked()
        obs.count("router.requests_total", outcome="ok")
        # a point record (explicit zero dur): the forward wall it spans
        # is attributed by the WORKERS' phase records, not double-billed
        obs.req_phase(key, "route", dur=0.0, worker=str(worker))
        return {"ok": True, "rid": rec.rid}

    def _prune_done_locked(self) -> None:
        cap = 4096
        if len(self._recs) <= cap:
            return
        for rid in sorted(self._recs):
            rec = self._recs[rid]
            if rec.done:
                del self._recs[rid]
                if rec.key is not None:
                    self._by_key.pop(rec.key, None)
            if len(self._recs) <= cap:
                return

    def _route_poll(self, req):
        try:
            rid = int(req["rid"])
            cursor = int(req.get("cursor", 0))
        except (KeyError, TypeError, ValueError):
            return {"ok": False, "error": "route_poll needs an integer "
                    "rid (+ optional integer cursor)",
                    "code": "invalid_argument"}
        with self._lock:
            rec = self._recs.get(rid)
        if rec is None:
            return {"ok": False, "error": f"unknown rid {rid} (the "
                    "router may have restarted — resubmit under the "
                    "original submit_key and resume your cursor)",
                    "code": "not_found"}
        if not rec.done:
            self._advance(rec)
        with self._lock:
            toks = rec.tokens[cursor:]
            return {"ok": True, "tokens": [int(t) for t in toks],
                    "done": bool(rec.done), "reason": rec.reason}

    def _advance(self, rec: _RouteRec) -> None:
        """Poll-through: pull new tokens from the request's CURRENT
        worker into the append-only buffer; on a lost worker, re-route.
        Per-rec lock — concurrent client polls must not double-append."""
        with rec.plock:
            if rec.done:
                return
            if rec.worker is None and not self._reroute(rec):
                return
            worker_addr = None
            for w, host, port in self._members("decode"):
                if w == rec.worker:
                    worker_addr = (host, port)
                    break
            if worker_addr is None:
                rec.lost_reason = rec.lost_reason or "evicted"
                rec.worker = None
                self._reroute(rec)
                return
            client = self._worker_client(rec.worker, *worker_addr)
            try:
                toks, done, reason = client.poll(rec.remote_rid,
                                                 rec.remote_cursor)
            except KeyError:
                # the worker restarted (same name, empty engine) or
                # purged the record — the stream is gone there
                rec.lost_reason = "not_found"
                rec.worker = None
                self._reroute(rec)
                return
            except ConnectionError:
                rec.lost_reason = "unreachable"
                rec.worker = None
                self._reroute(rec)
                return
            if done and reason == "error":
                # the engine failed mid-stream (scheduler fault) — the
                # request itself is fine; re-prefill it elsewhere
                rec.lost_reason = "error"
                rec.worker = None
                self._reroute(rec)
                return
            with self._lock:
                rec.tokens.extend(int(t) for t in toks)
                rec.remote_cursor += len(toks)
                if done:
                    rec.done, rec.reason = True, reason

    def _reroute(self, rec: _RouteRec) -> bool:
        """Re-place a request whose worker went away: re-prefill
        ``prompt + delivered`` with the remaining budget under a derived
        submit_key. The buffer keeps growing in place — client cursors
        never see the seam. Returns True when placed (caller's next
        poll pulls from the new worker)."""
        why = rec.lost_reason or "lost"
        rec.lost_reason = None
        with self._lock:
            delivered = list(rec.tokens)
            remaining = rec.max_new - len(delivered)
        if remaining <= 0:
            # the budget was fully delivered before the worker died —
            # nothing is owed; close the stream as a normal completion
            with self._lock:
                rec.done, rec.reason = True, "length"
            return False
        if rec.reroutes >= self._max_reroutes:
            with self._lock:
                rec.done, rec.reason = True, "error"
            return False
        rec.reroutes += 1
        obs.count("router.reroutes_total", reason=why)
        key = (None if rec.key is None
               else f"{rec.key}#r{rec.reroutes}")
        try:
            worker, remote_rid = self._place(
                rec.prompt + delivered, remaining, eos_id=rec.eos_id,
                timeout_s=rec.timeout_s, tenant=rec.tenant, slo=rec.slo,
                prefix_len=rec.prefix_len, submit_key=key)
        except (Overloaded, ConnectionError, ValueError):
            # nowhere to land right now: leave the rec unplaced — the
            # next poll retries the re-route (the client keeps polling;
            # the stream stalls instead of dying)
            rec.reroutes -= 1    # this attempt placed nothing
            rec.lost_reason = why
            return False
        with self._lock:
            rec.worker, rec.remote_rid = worker, remote_rid
            rec.remote_cursor = 0
        # recorded under the BASE key: the new leg's own phases live
        # under the derived {key}#r{n} timeline the workers record
        obs.req_phase(rec.key, "reroute", dur=0.0, why=why,
                      to=str(worker), n=rec.reroutes)
        return True

    def _route_cancel(self, req):
        try:
            rid = int(req["rid"])
        except (KeyError, TypeError, ValueError):
            return {"ok": False, "error": "route_cancel needs an integer "
                    "rid", "code": "invalid_argument"}
        with self._lock:
            rec = self._recs.get(rid)
        if rec is None:
            return {"ok": True, "cancelled": False}
        with rec.plock:
            was_live = not rec.done
            with self._lock:
                if not rec.done:
                    rec.done, rec.reason = True, "cancelled"
            if was_live and rec.worker is not None:
                for w, host, port in self._members("decode"):
                    if w == rec.worker:
                        try:
                            self._worker_client(w, host, port).cancel(
                                rec.remote_rid)
                        except Exception:
                            pass    # its timeout still bounds the slot
                        break
        return {"ok": True, "cancelled": was_live}

    def _route_stats(self, req):
        with self._lock:
            inflight = sum(1 for r in self._recs.values() if not r.done)
        return {"ok": True,
                "n_decode_workers": len(self._members("decode")),
                "n_prefill_workers": len(self._members("prefill")),
                "inflight": inflight,
                "rpc_conns": self.server.active_connections()}


class RouterClient(ServingClient):
    """:class:`~.daemon.ServingClient` pointed at the route_* surface,
    plus the restart-recovery ladder in :meth:`stream`: a ``not_found``
    poll (the router restarted and lost its records) resubmits the
    ORIGINAL request under the ORIGINAL submit_key and resumes the
    cursor at the last delivered token. Whichever worker the retry
    lands on, the worker-side replay caches and greedy determinism make
    the continuation exactly the original stream's remainder — no lost,
    no duplicated tokens, no double admission under one key."""

    _rpc_name = "router rpc"
    _op_submit = "route_submit"
    _op_poll = "route_poll"
    _op_cancel = "route_cancel"
    _op_stats = "route_stats"

    def stream(self, prompt, max_new: int, *, eos_id: Optional[int] = None,
               timeout_s: Optional[float] = None, tenant: str = "default",
               slo: str = "interactive", prefix_len: Optional[int] = None,
               poll_interval_s: float = 0.02,
               policy: Optional[RetryPolicy] = None,
               max_recoveries: int = 8):
        key = uuid.uuid4().hex
        submit = lambda: self.submit_with_backoff(  # noqa: E731
            prompt, max_new, eos_id=eos_id, timeout_s=timeout_s,
            tenant=tenant, slo=slo, prefix_len=prefix_len, policy=policy,
            submit_key=key)
        rid = submit()
        cursor = 0          # tokens DELIVERED to the caller, ever
        recoveries = 0
        finished = False
        try:
            while True:
                try:
                    tokens, done, reason = self.poll(rid, cursor)
                except KeyError:
                    # the router restarted: its record of rid is gone,
                    # but ours isn't — resubmit the identical request
                    # under the identical key and keep our cursor. The
                    # router re-places it; the stream's tail re-emerges
                    # at exactly position `cursor`.
                    recoveries += 1
                    if recoveries > max_recoveries:
                        raise
                    try:
                        rid = submit()
                    except (Overloaded, ConnectionError):
                        # restart window: workers may not have rejoined
                        # the new router yet — wait and retry (the next
                        # poll raises KeyError again, re-entering here)
                        time.sleep(poll_interval_s * 10)
                    continue
                except ConnectionError:
                    # the router itself is down/restarting: bounded wait
                    # for it to come back, then poll again (rid may
                    # still be valid if only the connection dropped)
                    recoveries += 1
                    if recoveries > max_recoveries:
                        raise
                    time.sleep(poll_interval_s * 5)
                    continue
                for t in tokens:
                    yield t
                cursor += len(tokens)
                if done:
                    finished = True
                    if reason == "timeout":
                        raise TimeoutError(
                            f"request {rid} timed out server-side")
                    if reason in ("cancelled", "error"):
                        raise RuntimeError(
                            f"request {rid} ended server-side with "
                            f"reason={reason} after {cursor} token(s)")
                    return
                time.sleep(poll_interval_s)
        finally:
            if not finished:
                try:
                    self.cancel(rid)
                except Exception:
                    pass
