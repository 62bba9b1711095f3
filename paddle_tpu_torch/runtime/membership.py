"""Cluster membership — heartbeat-leased worker registration on the master.

A copy of ``paddle_tpu/runtime/membership.py`` over the port's master
server (``runtime/master_service.py``). The obs counters and gauges of
JAX's copy (``cluster.*``) are left out until the port has the session
plane (ROADMAP A.8); the history series the autoscale hook records are
kept.

The reference registers trainers/pservers in etcd (go/pserver/etcd_client.go
slot registration under a TTL lease; doc/design/cluster_train/README.md
"trainers are stateless consumers") but its master still assumed a FIXED
worker set. This module makes membership first-class, reusing the repo's
own lease semantics (JAX's ``runtime/lease.py`` — TTL + monotonic
fencing tokens) over the master's RPC plane:

* workers ``mbr_join`` under a heartbeat lease and receive a **member
  fencing token** (monotonic per service — the etcd-revision discipline of
  ``FileLease``). A re-join under the same
  worker name mints a NEW token; the old incarnation's heartbeats and
  submissions are refused with structured ``stale_member`` errors — a
  partitioned-but-alive zombie can never act for its replacement.
* the master maintains an **epoch-numbered membership view**: every change
  (join, graceful ``mbr_leave``, missed-heartbeat eviction) bumps the
  epoch and notifies ``on_change`` subscribers (the elastic trainer
  re-buckets its task queue there, JAX's ``trainer/elastic.py``).
* requests that mutate shared training state carry their sender's epoch;
  :func:`MembershipService.fence` answers an outdated one with a
  structured ``stale_epoch`` error instead of applying a stale worker's
  work — the split-brain guard the Ascend field study (PAPERS.md) shows
  accelerator clusters dying without.

Ops ride :meth:`MasterServer.register_op` (the native unknown-op fallback
path, like ``srv_submit``): ``mbr_join`` / ``mbr_heartbeat`` /
``mbr_leave`` / ``mbr_view``. ``mbr_view`` additionally carries the
**autoscale hook**: :func:`autoscale_recommendation` folds the master's
task-queue depth and the aggregated ``goodput.ratio`` / starvation
telemetry (gauges, via the in-process ClusterAggregator) into a
``join`` / ``leave`` / ``hold`` recommendation an external scaler can act
on without understanding the internals.

Worker side: :class:`MembershipClient` (a :class:`MasterClient` with the
mbr ops) and :class:`HeartbeatKeeper` (the LeaseKeeper analog). The
keeper distinguishes failure classes the way the hardened
``MasterClient._call`` reports them: connection-refused (master
restarting) is retried against the snapshot/restore window, and a
structured ``unknown_member``/``stale_member`` answer (we were evicted,
or the master restarted and lost the ephemeral member table) triggers an
automatic **re-join** — a rolling master restart costs one epoch bump,
not the fleet. The chaos site ``mbr.heartbeat`` (faults plane) injects
heartbeat failures to drive the eviction path deterministically.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import faults
from ..utils.logging import get_logger
from ..utils.retry import RetryPolicy
from .master_service import (CODE_STALE_EPOCH, CODE_STALE_MEMBER,
                             CODE_UNKNOWN_MEMBER, MasterClient,
                             StaleMemberError)

log = get_logger(__name__)


def _err(code: str, msg: str, **extra) -> Dict[str, Any]:
    d = {"ok": False, "code": code, "error": msg}
    d.update(extra)
    return d


class _Member:
    __slots__ = ("worker", "token", "deadline", "caps", "joined_at")

    def __init__(self, worker: str, token: int, deadline: float, caps,
                 joined_at: float):
        self.worker = worker
        self.token = token
        self.deadline = deadline
        self.caps = caps or {}
        self.joined_at = joined_at

    def describe(self) -> Dict[str, Any]:
        return {"worker": self.worker, "token": self.token,
                "caps": dict(self.caps)}


class MembershipService:
    """Epoch-numbered, heartbeat-leased membership table on the master.

    Args:
      ttl: seconds a member survives without a heartbeat before eviction
        (the lease TTL; workers heartbeat at ``ttl / 3``).
      clock: injectable monotonic clock — chaos tests time-travel
        evictions instead of sleeping.
      epoch0: starting epoch; a restarted master seeds it from its
        snapshot so epoch fencing stays monotonic ACROSS restarts (the
        FileLease ``.epoch`` sidecar discipline).
      tick_interval: expiry-check cadence of :meth:`start`'s thread.
    """

    def __init__(self, *, ttl: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 epoch0: int = 0, tick_interval: Optional[float] = None):
        self.ttl = ttl
        self._clock = clock
        self._lock = threading.Lock()
        self._members: Dict[str, _Member] = {}
        self.epoch = epoch0
        self._next_token = 0
        #: the registered fleet actor, (name, token) — single writer of
        #: committed autoscale actions; None until one registers
        self._actor: Optional[Tuple[str, int]] = None
        self._server = None
        self._on_change: List[Callable] = []
        self._tick_interval = (tick_interval if tick_interval is not None
                               else max(ttl / 4.0, 0.05))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wiring -------------------------------------------------------------
    def _aggregator(self):
        """The attached server's ClusterAggregator (None when detached —
        unit tests on a bare service)."""
        srv = self._server
        return getattr(srv, "aggregator", None) if srv is not None else None

    def _fleet_health(self):
        return getattr(self._aggregator(), "health", None)

    def _forget_worker(self, worker: str) -> None:
        """Authoritative departure: reap the worker's health feeds AND
        its history series so no alert freezes on a dead incarnation."""
        agg = self._aggregator()
        if agg is None:
            return
        if hasattr(agg, "forget_worker"):
            agg.forget_worker(worker)
        elif getattr(agg, "health", None) is not None:
            agg.health.forget(worker)

    def attach(self, server) -> "MembershipService":
        """Register the mbr_* ops on a MasterServer (before ``start()`` so
        no request can observe a half-wired op table)."""
        self._server = server
        server.register_op("mbr_join", self._op_join)
        server.register_op("mbr_heartbeat", self._op_heartbeat)
        server.register_op("mbr_leave", self._op_leave)
        server.register_op("mbr_view", self._op_view)
        server.register_op("act_register", self._op_act_register)
        server.register_op("act_report", self._op_act_report)
        return self

    def subscribe(self, fn: Callable[..., None]) -> None:
        """``fn(view, joined=[...], left=[...], reason=str)`` after every
        epoch bump. Called OUTSIDE the membership lock (subscribers
        re-bucket task queues and may call back into stats)."""
        self._on_change.append(fn)

    def start(self) -> "MembershipService":
        """Run the eviction housekeeping thread (real deployments; tests
        with a fake clock call :meth:`expire` directly)."""
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="membership-expiry")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self._tick_interval):
            self.expire()

    # -- the table ----------------------------------------------------------
    def members(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [m.describe() for m in self._members.values()]

    def view(self) -> Dict[str, Any]:
        """The epoch-stamped membership view (stable contract: epoch,
        members sorted by worker name)."""
        with self._lock:
            return {"epoch": self.epoch,
                    "members": sorted((m.describe()
                                       for m in self._members.values()),
                                      key=lambda d: d["worker"])}

    def join(self, worker: str, caps=None) -> Tuple[int, int]:
        """Register (or re-register) ``worker``; returns (token, epoch).
        A join over a live same-name member REPLACES it — the newer
        incarnation wins, the older one's token goes stale."""
        now = self._clock()
        with self._lock:
            replaced = worker in self._members
            self._next_token += 1
            token = self._next_token
            self._members[worker] = _Member(worker, token, now + self.ttl,
                                            caps, now)
            self._bump_locked()
            epoch = self.epoch
        log.info("member %s joined (token %d) -> epoch %d%s", worker, token,
                 epoch, " [replaced live incarnation]" if replaced else "")
        self._notify(joined=[worker], left=[worker] if replaced else [],
                     reason="join")
        return token, epoch

    def heartbeat(self, worker: str, token: int) -> Optional[Dict[str, Any]]:
        """Extend the member's lease. Returns a structured-error dict on a
        fencing refusal, None when the heartbeat was accepted."""
        with self._lock:
            m = self._members.get(worker)
            if m is None:
                return _err(CODE_UNKNOWN_MEMBER,
                            f"worker {worker!r} is not a member "
                            "(evicted, or the master restarted) — re-join",
                            epoch=self.epoch)
            if token != m.token:
                return _err(CODE_STALE_MEMBER,
                            f"worker {worker!r} token {token} superseded by "
                            f"{m.token} (a newer incarnation joined)",
                            epoch=self.epoch)
            m.deadline = self._clock() + self.ttl
        # feed the fleet health plane: heartbeat ARRIVAL times are the
        # jitter detector's raw signal (obs/health.py)
        h = self._fleet_health()
        if h is not None:
            h.note_heartbeat(worker)
        return None

    def leave(self, worker: str, token: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            m = self._members.get(worker)
            if m is None:
                return None                   # idempotent: already gone
            if token != m.token:
                return _err(CODE_STALE_MEMBER,
                            f"worker {worker!r} token {token} superseded by "
                            f"{m.token}", epoch=self.epoch)
            del self._members[worker]
            self._bump_locked()
        self._forget_worker(worker)
        log.info("member %s left gracefully -> epoch %d", worker, self.epoch)
        self._notify(joined=[], left=[worker], reason="leave")
        return None

    def expire(self, now: Optional[float] = None) -> List[str]:
        """Evict members whose heartbeat lease lapsed; returns the evicted
        worker names (one epoch bump covers the whole batch)."""
        now = self._clock() if now is None else now
        with self._lock:
            dead = [w for w, m in self._members.items() if m.deadline <= now]
            for w in dead:
                del self._members[w]
            if dead:
                self._bump_locked()
        for w in dead:
            self._forget_worker(w)
            log.warning("member %s missed its heartbeat window (ttl %.1fs): "
                        "evicted -> epoch %d", w, self.ttl, self.epoch)
        if dead:
            self._notify(joined=[], left=dead, reason="evicted")
        return dead

    def validate(self, worker: str, token) -> Optional[Dict[str, Any]]:
        """Member fencing for state-mutating ops (the elastic trainer's
        grad/task RPCs): structured error dict, or None when current."""
        with self._lock:
            m = self._members.get(worker)
            if m is None:
                return _err(CODE_UNKNOWN_MEMBER,
                            f"worker {worker!r} is not a member — re-join",
                            epoch=self.epoch)
            if token != m.token:
                return _err(CODE_STALE_MEMBER,
                            f"worker {worker!r} token {token} superseded by "
                            f"{m.token}", epoch=self.epoch)
        return None

    def fence(self, req_epoch) -> Optional[Dict[str, Any]]:
        """Epoch fencing: a submission stamped with an older view is
        answered with ``stale_epoch`` (and the current epoch, so the
        caller can resync at its next step boundary) instead of applied."""
        with self._lock:
            cur = self.epoch
        if req_epoch is None or int(req_epoch) == cur:
            return None
        return _err(CODE_STALE_EPOCH,
                    f"request epoch {req_epoch} != current {cur} "
                    "(membership changed; resync and retry)", epoch=cur)

    def _bump_locked(self) -> None:
        self.epoch += 1

    def _notify(self, **kw) -> None:
        view = self.view()
        for fn in list(self._on_change):
            try:
                fn(view, **kw)
            except Exception:
                log.exception("membership on_change subscriber failed")

    # -- op handlers (native fallback threads) ------------------------------
    def _fenced_master(self) -> Optional[Dict[str, Any]]:
        # a deposed master must not mutate membership any more than its
        # task queue: same "fenced:" wording, so clients rotate endpoints
        srv = self._server
        if srv is not None and srv._fenced_out():
            return {"ok": False,
                    "error": f"fenced: stale master token {srv.fence_token}"}
        return None

    def _op_join(self, req):
        fenced = self._fenced_master()
        if fenced is not None:
            return fenced
        worker = str(req.get("worker", ""))
        if not worker:
            return {"ok": False, "error": "mbr_join needs a worker name"}
        token, epoch = self.join(worker, req.get("caps"))
        return {"ok": True, "member_token": token, "epoch": epoch,
                "ttl": self.ttl, "view": self.view()}

    def _op_heartbeat(self, req):
        fenced = self._fenced_master()
        if fenced is not None:
            return fenced
        err = self.heartbeat(str(req.get("worker", "")),
                             req.get("member_token"))
        if err is not None:
            return err
        with self._lock:
            return {"ok": True, "epoch": self.epoch}

    def _op_leave(self, req):
        fenced = self._fenced_master()
        if fenced is not None:
            return fenced
        err = self.leave(str(req.get("worker", "")), req.get("member_token"))
        if err is not None:
            return err
        with self._lock:
            return {"ok": True, "epoch": self.epoch}

    def _op_view(self, req):
        view = self.view()
        rec = None
        srv = self._server
        if srv is not None:
            try:
                todo, pending, _, _, _ = srv.master.stats()
                samples = srv.aggregator.merged_samples()
                rec = autoscale_recommendation(
                    members=len(view["members"]), todo=todo,
                    pending=pending, samples=samples,
                    history=getattr(srv.aggregator, "history", None))
            except Exception as e:   # telemetry must not break the view
                rec = {"action": "hold",
                       "reason": f"recommendation unavailable: {e}"}
        view["ok"] = True
        view["ttl"] = self.ttl
        view["recommendation"] = rec
        return view

    # -- fleet-actor registration --------------------------------
    def _op_act_register(self, req):
        """Register the fleet actor that may journal committed autoscale
        actions. SINGLE-WRITER: a new registration replaces the old one
        and stales its token — two actors fighting over one fleet is the
        flapping the whole plane exists to prevent, so the deposed
        actor's next ``act_report`` gets a fencing refusal and stands
        down. Tokens share the member counter (monotonic per master
        incarnation)."""
        fenced = self._fenced_master()
        if fenced is not None:
            return fenced
        actor = str(req.get("actor", ""))
        if not actor:
            return {"ok": False, "error": "act_register needs an actor name"}
        with self._lock:
            self._next_token += 1
            self._actor = (actor, self._next_token)
            epoch = self.epoch
            token = self._next_token
        log.info("fleet actor %r registered (token %d)", actor, token)
        return {"ok": True, "actor_token": token, "epoch": epoch}

    def _op_act_report(self, req):
        """Journal one COMMITTED autoscale action into the aggregator
        (the ``cluster.autoscale_committed`` satellite): only the
        currently-registered actor's token is accepted, with the same
        structured fencing codes the member plane uses."""
        fenced = self._fenced_master()
        if fenced is not None:
            return fenced
        actor = str(req.get("actor", ""))
        token = req.get("actor_token")
        with self._lock:
            registered = self._actor
            epoch = self.epoch
        if registered is None or registered[0] != actor:
            return _err(CODE_UNKNOWN_MEMBER,
                        f"actor {actor!r} is not registered", epoch=epoch)
        if registered[1] != token:
            return _err(CODE_STALE_MEMBER,
                        f"actor {actor!r} token {token} superseded by a "
                        f"newer registration", epoch=epoch)
        agg = self._aggregator()
        if agg is not None and hasattr(agg, "note_action"):
            agg.note_action({
                "actor": actor,
                "action": str(req.get("action", "")),
                "population": str(req.get("population", "")),
                "worker": str(req.get("worker", "")),
                "reason": str(req.get("reason", "")),
                "signal": float(req.get("signal", 0.0) or 0.0)})
        return {"ok": True, "epoch": epoch}


# -- autoscale hook -------------------------------------------------------------

#: tentative action -> the cluster.autoscale_signal gauge encoding
_SIGNAL = {"join": 1.0, "hold": 0.0, "leave": -1.0}


def autoscale_recommendation(*, members: int, todo: int, pending: int,
                             samples=(), scale_up_backlog: float = 2.0,
                             scale_down_goodput: float = 0.25,
                             history=None, hysteresis_windows: int = 3,
                             now: Optional[float] = None
                             ) -> Dict[str, Any]:
    """Fold queue depth + fleet telemetry into a join/leave recommendation.

    Inputs are the master's own task-queue stats and the aggregated
    cluster samples (``ClusterAggregator.merged_samples()`` — every series
    carries a ``worker=<id>`` label). Heuristics, in priority order:

    * no live members → ``join`` (nothing can drain the queue);
    * backlog per worker above ``scale_up_backlog`` → ``join`` (the queue
      is outrunning the fleet);
    * empty queue AND (mean ``goodput.ratio`` below ``scale_down_goodput``
      OR reader starvation observed — ``data.starved_total`` /
      ``data.giveups_total``) with >1 member → ``leave`` (the fleet idles
      waiting for work);
    * otherwise ``hold``.

    **Hysteresis**: with ``history`` (the aggregator's
    :class:`~paddle_tpu_torch.obs.health.TimeSeriesStore`), each call records
    its inputs and TENTATIVE action as master-side series
    (``cluster.backlog_per_worker``, ``cluster.autoscale_signal``) and a
    non-``hold`` action only commits once the signal has pointed the same
    way for the last ``hysteresis_windows`` evaluations — a one-sample
    backlog spike (or one idle scrape) recommends ``hold`` with the
    hysteresis reason instead of flapping the fleet. The "no live
    members" branch bypasses hysteresis: a dead fleet with queued work
    must scale up NOW. Without ``history`` the function stays pure
    (unit tests, external scalers sharing the instantaneous policy).
    """
    ratios: List[float] = []
    starved = 0.0
    for s in samples or ():
        try:
            name, value = s.get("name"), s.get("value")
        except AttributeError:
            continue
        if value is None:
            continue
        if name == "goodput.ratio":
            ratios.append(float(value))
        elif name in ("data.starved_total", "data.giveups_total"):
            starved += float(value)
    goodput = sum(ratios) / len(ratios) if ratios else None
    backlog = todo + pending
    out = {"members": members, "backlog": backlog,
           "backlog_per_worker": (backlog / members) if members else None,
           "goodput_ratio": goodput, "starved": starved}
    if members == 0:
        out.update(action="join",
                   reason=f"no live workers for {backlog} queued task(s)")
        if history is not None:
            _record_autoscale(history, out, now)
        return out                     # bypass hysteresis: fleet is dead
    if backlog / members > scale_up_backlog:
        out.update(action="join",
                   reason=f"backlog {backlog} over {members} worker(s) "
                          f"exceeds {scale_up_backlog}/worker")
    elif backlog == 0 and members > 1 and (
            starved > 0 or (goodput is not None
                            and goodput < scale_down_goodput)):
        why = (f"reader starvation observed ({starved:.0f})" if starved > 0
               else f"mean goodput.ratio {goodput:.2f} < "
                    f"{scale_down_goodput}")
        out.update(action="leave", reason=f"queue empty and {why}")
    else:
        out.update(action="hold", reason="queue and fleet in balance")
    if history is not None:
        past = _record_autoscale(history, out, now)
        if out["action"] != "hold":
            want = _SIGNAL[out["action"]]
            recent = past[-hysteresis_windows:]
            # sustained = the last K evaluations agreed, OR — for callers
            # polling too sparsely to ever land K points inside the store
            # window — every in-window evaluation agreed AND they span at
            # least half the window (a single spike spans nothing; a
            # backlog persisting across sparse polls still scales)
            span = past[-1][0] - past[0][0] if len(past) >= 2 else 0.0
            sustained = (
                (len(recent) >= hysteresis_windows
                 and all(v == want for _, v in recent))
                or (len(past) >= 2
                    and all(v == want for _, v in past)
                    and span >= history.window_s / 2.0))
            if not sustained:
                out["tentative"] = out["action"]
                out.update(action="hold",
                           reason=f"hysteresis: '{out['tentative']}' "
                                  f"signal not sustained over "
                                  f"{hysteresis_windows} window(s)")
    return out


def _record_autoscale(history, out: Dict[str, Any], now) -> list:
    """Record this evaluation's inputs + tentative signal into the
    master-side history series; returns the signal points (incl. this
    one, oldest first)."""
    from ..obs.health import MASTER_WORKER
    signal = _SIGNAL[out["action"]]
    bpw = out.get("backlog_per_worker")
    if bpw is not None:
        history.record_value(MASTER_WORKER, "cluster.backlog_per_worker",
                             float(bpw), ts=now)
    history.record_value(MASTER_WORKER, "cluster.autoscale_signal",
                         signal, ts=now)
    return history.points(MASTER_WORKER, "cluster.autoscale_signal",
                          now=now)


# -- worker side ----------------------------------------------------------------

class MembershipClient(MasterClient):
    """MasterClient + the membership ops. Structured fencing refusals
    surface as :class:`StaleMemberError` (fail fast — the hardened
    ``_call`` contract); transport failures keep the reconnect/backoff
    behavior."""

    _rpc_name = "membership rpc"

    def join(self, worker: str, caps=None) -> Tuple[int, int, dict]:
        """-> (member_token, epoch, reply) — reply carries ``view`` (the
        epoch-stamped member list) and ``ttl`` (the heartbeat lease; beat
        at ttl/3, evicted after ttl)."""
        r = self._call({"op": "mbr_join", "worker": worker,
                        "caps": caps or {}})
        if not r.get("ok"):
            raise RuntimeError(f"mbr_join failed: {r.get('error')}")
        return int(r["member_token"]), int(r["epoch"]), r

    def heartbeat(self, worker: str, member_token: int) -> int:
        """-> current epoch. Raises StaleMemberError on a fencing refusal
        (evicted / superseded / master forgot us) and fires the
        ``mbr.heartbeat`` chaos site (faults plane) on the send edge."""
        faults.fire("mbr.heartbeat")
        r = self._call({"op": "mbr_heartbeat", "worker": worker,
                        "member_token": member_token})
        if not r.get("ok"):
            raise RuntimeError(f"mbr_heartbeat failed: {r.get('error')}")
        return int(r["epoch"])

    def leave(self, worker: str, member_token: int) -> None:
        r = self._call({"op": "mbr_leave", "worker": worker,
                        "member_token": member_token})
        if not r.get("ok"):
            raise RuntimeError(f"mbr_leave failed: {r.get('error')}")

    def cluster_view(self) -> dict:
        return self._call({"op": "mbr_view"})

    # -- fleet-actor plane ---------------------------------------
    def act_register(self, actor: str) -> Tuple[int, int]:
        """Register ``actor`` as THE fleet actor -> (actor_token, epoch).
        Replaces (and fences out) any previously registered actor."""
        r = self._call({"op": "act_register", "actor": actor})
        if not r.get("ok"):
            raise RuntimeError(f"act_register failed: {r.get('error')}")
        return int(r["actor_token"]), int(r["epoch"])

    def act_report(self, actor: str, actor_token: int, *, action: str,
                   population: str, worker: str, reason: str = "",
                   signal: float = 0.0) -> int:
        """Journal one committed autoscale action -> current epoch.
        Raises StaleMemberError when this actor has been superseded (the
        hardened ``_call`` fencing contract — the cue to stand down)."""
        r = self._call({"op": "act_report", "actor": actor,
                        "actor_token": actor_token, "action": action,
                        "population": population, "worker": worker,
                        "reason": reason, "signal": signal})
        if not r.get("ok"):
            raise RuntimeError(f"act_report failed: {r.get('error')}")
        return int(r["epoch"])


class HeartbeatKeeper:
    """Background heartbeat thread for one worker membership.

    The failure ladder, matching the hardened client contract:

    * transport errors (master restarting, connection refused) — already
      retried with backoff inside ``_call``; the keeper additionally
      tolerates them for up to ``grace`` seconds measured from the last
      accepted heartbeat (our server-side lease may still be live), then
      declares the membership LOST;
    * ``unknown_member`` / ``stale_member`` — we were evicted or the
      master restarted with an empty table: **re-join** under a
      RetryPolicy; success reports the new (token, epoch) through
      ``on_rejoin`` so the owner can resync; exhaustion → ``on_lost``;
    * an epoch moving in a heartbeat reply fires ``on_epoch`` — the cheap
      membership-changed signal the elastic worker barriers on.
    """

    def __init__(self, client: MembershipClient, worker: str, token: int,
                 *, ttl: float, epoch: int = 0,
                 on_epoch: Optional[Callable[[int], None]] = None,
                 on_rejoin: Optional[Callable[[int, int], None]] = None,
                 on_lost: Optional[Callable[[], None]] = None,
                 rejoin_policy: Optional[RetryPolicy] = None,
                 caps=None):
        self.client = client
        self.worker = worker
        self.token = token
        self.ttl = ttl
        self.epoch = epoch
        self.caps = caps or {}
        self.on_epoch = on_epoch
        self.on_rejoin = on_rejoin
        self.on_lost = on_lost
        self.grace = ttl * 3.0
        self._rejoin = rejoin_policy or RetryPolicy(
            max_attempts=6, base_delay=0.1, multiplier=2.0, max_delay=1.0,
            jitter=0.25)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatKeeper":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"heartbeat-{self.worker}")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        last_ok = time.monotonic()
        while not self._stop.wait(self.ttl / 3.0):
            try:
                epoch = self.client.heartbeat(self.worker, self.token)
            except StaleMemberError:
                if not self._try_rejoin():
                    self._lost()
                    return
                last_ok = time.monotonic()
                continue
            except Exception:
                # transport outage or injected chaos: our lease may still
                # be running server-side; only give up past the grace
                if time.monotonic() - last_ok >= self.grace:
                    self._lost()
                    return
                continue
            last_ok = time.monotonic()
            if epoch != self.epoch:
                self.epoch = epoch
                if self.on_epoch is not None:
                    self.on_epoch(epoch)

    def _try_rejoin(self) -> bool:
        def attempt():
            return self.client.join(self.worker, self.caps)
        try:
            token, epoch, _ = self._rejoin.call(
                attempt, describe=f"re-join {self.worker!r}")
        except Exception as e:  # noqa: BLE001 - any failure = not rejoined
            log.warning("worker %s could not re-register: %s", self.worker, e)
            return False
        self.token, old = token, self.epoch
        self.epoch = epoch
        log.info("worker %s re-registered (token %d, epoch %d)",
                 self.worker, token, epoch)
        if self.on_rejoin is not None:
            self.on_rejoin(token, epoch)
        if epoch != old and self.on_epoch is not None:
            self.on_epoch(epoch)
        return True

    def _lost(self) -> None:
        log.error("worker %s lost its membership (heartbeats failing "
                  "past the %.1fs grace)", self.worker, self.grace)
        if self.on_lost is not None:
            self.on_lost()
