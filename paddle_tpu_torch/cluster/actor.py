"""The fleet actor: the loop that ACTS on the autoscale signals — a copy of
``paddle_tpu/cluster/actor.py`` over the port's planes.

PR 14's membership plane recommends (``autoscale_recommendation``,
hysteresis-stable since PR 15), PR 15's alert engine pages on SLO burn,
PR 17's router re-routes around departures — and until now an operator
closed every one of those loops by hand. :class:`FleetActor` closes them
in software:

* each tick it POLLS every :class:`Population`'s control plane
  (``mbr_view`` for the member list + recommendation, ``obs_health`` for
  firing alerts, backlog/in-flight probes for busyness), so the actor
  holds no state the fleet cannot re-derive after an actor restart;
* non-``hold`` recommendations and TTFT/TPOT burn-rate alerts become
  spawns/drains through the injectable :class:`~.spawn.SpawnBackend`
  seam, gated by a per-(population, action) COOLDOWN and a fleet-wide
  max-concurrent-CHURN cap — hysteresis upstream, damping here, so the
  chaos bar's "zero flapping" holds end to end;
* drains are GRACEFUL-BEFORE-EVICT: the backend's drain (SIGTERM
  locally) lets the worker finish in-flight work and leave via
  membership (the router re-routes live streams, the elastic worker
  finishes its shard at the barrier); only a drain that overstays its
  grace is escalated to ``kill`` and journaled as an eviction;
* under a ``total_workers`` budget the populations share capacity
  through :class:`~.scheduler.FleetScheduler` — batch training soaks
  idle workers and YIELDS one to serving when an SLO burns, reclaiming
  it on resolve (the train/serve unification protocol);
* every COMMITTED action lands in the actor's bounded journal and — via
  the population's reporter — in the master's ``act_report`` ext-op,
  which drives the ``cluster.autoscale_committed`` gauge so operators
  can tell "recommendation held" from "actor acted". A second actor
  registering against the same master deposes the first (single-writer
  fencing): the deposed actor's next report raises
  :class:`StaleMemberError` and its loop exits rather than fight.

Safety invariant (the graceful-leave-storm bar): a rolling drain never
retires the LAST live worker of a population while that population is
busy (in-flight elastic shard, live decode stream), and never drains
below ``min_workers``.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs
from ..faults import inject as faults
from ..runtime.master_service import StaleMemberError
from .scheduler import FleetScheduler
from .spawn import SpawnBackend, SpawnHandle

log = logging.getLogger("paddle_tpu_torch.cluster")

#: alert rules whose firing marks a population URGENT (head-of-line in
#: the fleet scheduler, allowed to pull yielded workers from batch pops)
SLO_BURN_RULES = ("serving_ttft_slo_burn", "serving_tpot_slo_burn")

#: journal action -> the cluster.autoscale_committed gauge encoding
ACTION_SIGNAL = {"spawn": 1.0, "drain": -1.0, "evict": -1.0,
                 "spawn_failed": 0.0}


@dataclass
class Population:
    """One scalable pool the actor drives (elastic-DP training workers,
    a router's decode pool, ...).

    ``probe`` is a zero-arg callable returning the observation dict
    (:class:`MasterProbe` / :class:`RouterProbe`, or a fake in tests)::

        {"members": [{"worker": str, "token": int}, ...],
         "recommendation": {"action": "join"|"leave"|"hold", ...} | None,
         "alerts": [rule_name, ...],    # currently-firing alert rules
         "busy": bool}                  # in-flight work exists

    ``target`` pins a steady-state size (serve pools); None means the
    recommendation alone moves the size (train pools). ``reporter`` is
    an optional callable(entry) that journals committed actions to the
    population's master (``act_report``).
    """
    name: str
    backend: SpawnBackend
    probe: Callable[[], Dict[str, Any]]
    reporter: Optional[Callable[[Dict[str, Any]], None]] = None
    min_workers: int = 0
    max_workers: int = 8
    target: Optional[int] = None
    worker_prefix: Optional[str] = None

    def prefix(self) -> str:
        return self.worker_prefix or f"{self.name}-w"


@dataclass
class _Pending:
    handle: SpawnHandle
    deadline: float


class FleetActor:
    """See module docstring. Tests drive :meth:`step` directly under a
    fake clock; deployments call :meth:`run`."""

    def __init__(self, populations: List[Population], *,
                 scheduler: Optional[FleetScheduler] = None,
                 total_workers: Optional[int] = None,
                 interval_s: float = 1.0, cooldown_s: float = 5.0,
                 max_churn: int = 1, spawn_grace_s: float = 30.0,
                 drain_grace_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "autoscale-actor"):
        if not populations:
            raise ValueError("FleetActor needs at least one population")
        names = [p.name for p in populations]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate population names: {names}")
        self.populations = list(populations)
        self.scheduler = scheduler or FleetScheduler()
        self.total_workers = total_workers
        self.interval_s = float(interval_s)
        self.cooldown_s = float(cooldown_s)
        self.max_churn = int(max_churn)
        self.spawn_grace_s = float(spawn_grace_s)
        self.drain_grace_s = float(drain_grace_s)
        self.name = name
        self._clock = clock
        self.journal: deque = deque(maxlen=128)
        self.deposed = False
        self._spawn_seq = 0
        self._last_action: Dict[Tuple[str, str], float] = {}
        self._spawning: Dict[str, Dict[str, _Pending]] = \
            {p.name: {} for p in populations}
        #: every handle this actor ever spawned, so a later drain can
        #: signal the right process (bounded by max_workers per pop)
        self._handles: Dict[str, Dict[str, SpawnHandle]] = \
            {p.name: {} for p in populations}
        self._draining: Dict[str, Dict[str, _Pending]] = \
            {p.name: {} for p in populations}
        #: workers each population yielded to an urgent peer and may
        #: reclaim once budget frees up (train/serve unification)
        self._yielded: Dict[str, int] = {p.name: 0 for p in populations}

    # -- observation --------------------------------------------------------
    def _observe(self) -> Dict[str, Optional[Dict[str, Any]]]:
        out: Dict[str, Optional[Dict[str, Any]]] = {}
        for pop in self.populations:
            try:
                out[pop.name] = pop.probe()
            except Exception as e:  # noqa: BLE001 - a down plane skips a tick
                log.warning("population %s probe failed: %s", pop.name, e)
                out[pop.name] = None
        return out

    @staticmethod
    def _member_names(ob: Dict[str, Any]) -> List[str]:
        names = []
        for m in ob.get("members") or ():
            names.append(m["worker"] if isinstance(m, dict) else str(m))
        return names

    def _churn(self) -> int:
        return (sum(len(d) for d in self._spawning.values())
                + sum(len(d) for d in self._draining.values()))

    def _cooled(self, pop: Population, action: str, now: float) -> bool:
        last = self._last_action.get((pop.name, action))
        return last is None or now - last >= self.cooldown_s

    # -- the tick -----------------------------------------------------------
    def step(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One control tick; returns the journal entries it committed."""
        now = self._clock() if now is None else now
        committed: List[Dict[str, Any]] = []
        observations = self._observe()
        demands: Dict[str, int] = {}
        urgent: set = set()
        live: Dict[str, int] = {}
        effective: Dict[str, int] = {}
        for pop in self.populations:
            ob = observations[pop.name]
            if ob is None:
                continue
            names = set(self._member_names(ob))
            self._reap(pop, names, now, committed)
            n_live = len(names)
            draining_live = sum(1 for w in self._draining[pop.name]
                                if w in names)
            eff = n_live + len(self._spawning[pop.name]) - draining_live
            live[pop.name] = n_live
            effective[pop.name] = eff
            base = pop.target if pop.target is not None else n_live
            rec = ob.get("recommendation") or None
            action = (rec or {}).get("action")
            if action == "join":
                base = max(base, n_live + 1)
            elif action == "leave":
                base = min(base, n_live - 1)
            if any(r in SLO_BURN_RULES for r in ob.get("alerts") or ()):
                urgent.add(pop.name)
                base = max(base, n_live + 1)
            desired = max(pop.min_workers, min(pop.max_workers, base))
            delta = desired - eff
            if delta > 0:
                demands[pop.name] = delta
            elif delta < 0:
                # a spawn still inside its grace window counts toward
                # `eff` (it is capacity in flight) but is NOT a drainable
                # worker: clamp the drain to the LIVE surplus so a
                # `leave` racing a very slow boot never double-counts the
                # unjoined spawn and retires an extra live member. The
                # spawn either joins (next tick re-evaluates the real
                # surplus) or its grace reaps it.
                surplus_live = max(0, (n_live - draining_live) - desired)
                want = min(-delta, surplus_live)
                if want > 0:
                    self._drain_surplus(pop, ob, want, now, committed,
                                        reason=self._drain_reason(pop, rec))
        self._spawn_demand(demands, urgent, effective, observations, now,
                           committed)
        self.journal.extend(committed)
        self._report(committed)
        return committed

    def _drain_reason(self, pop: Population, rec) -> str:
        if rec is not None and rec.get("action") == "leave":
            return f"recommendation: {rec.get('reason', 'leave')}"
        return "over target (scale in)"

    # -- reaping in-flight churn --------------------------------------------
    def _reap(self, pop: Population, names: set, now: float,
              committed: List[Dict[str, Any]]) -> None:
        spawning = self._spawning[pop.name]
        for w in list(spawning):
            pend = spawning[w]
            if w in names:
                del spawning[w]            # joined: spawn confirmed
            elif not pop.backend.alive(pend.handle) or now >= pend.deadline:
                del spawning[w]
                obs.count("cluster.actor_failures_total", action="spawn")
                committed.append(self._entry(
                    now, "spawn_failed", pop.name, w,
                    "process died or never joined within grace"))
                self._last_action[(pop.name, "spawn")] = now
        draining = self._draining[pop.name]
        for w in list(draining):
            pend = draining[w]
            if w not in names and not pop.backend.alive(pend.handle):
                del draining[w]            # left AND exited: drain done
            elif w not in names:
                del draining[w]            # left; the lease reaps the rest
            elif now >= pend.deadline:
                del draining[w]
                pop.backend.kill(pend.handle)
                obs.count("cluster.actor_failures_total", action="drain")
                committed.append(self._entry(
                    now, "evict", pop.name, w,
                    "drain overstayed grace; escalated to kill"))

    # -- scale in -----------------------------------------------------------
    def _drain_surplus(self, pop: Population, ob: Dict[str, Any],
                       want: int, now: float,
                       committed: List[Dict[str, Any]], *,
                       reason: str) -> None:
        for _ in range(want):
            if not self._drain_one(pop, ob, now, committed, reason=reason):
                return

    def _drain_one(self, pop: Population, ob: Dict[str, Any], now: float,
                   committed: List[Dict[str, Any]], *,
                   reason: str) -> bool:
        """Gated graceful drain of the newest live member; False when a
        gate (cooldown / churn cap / safety floor) refuses."""
        if self._churn() >= self.max_churn or \
                not self._cooled(pop, "drain", now):
            return False
        draining = self._draining[pop.name]
        members = [m for m in ob.get("members") or ()
                   if isinstance(m, dict)
                   and m.get("worker") not in draining]
        if not members:
            return False
        remaining = len(members) - 1 + \
            sum(1 for w in draining
                if w in set(self._member_names(ob)))
        if remaining < pop.min_workers:
            return False
        if remaining < 1 and ob.get("busy"):
            return False   # never retire the last busy worker
        # newest incarnation leaves first (max token): deterministic, and
        # the longest-lived member keeps any warmed caches
        victim = max(members, key=lambda m: (m.get("token") or 0,
                                             m["worker"]))["worker"]
        handle = self._find_handle(pop, victim) or SpawnHandle(
            worker=victim, population=pop.name)
        try:
            faults.fire("actor.drain")
            pop.backend.drain(handle)
        except Exception as e:  # noqa: BLE001 - chaos or backend refusal
            obs.count("cluster.actor_failures_total", action="drain")
            log.warning("drain of %s (%s) failed: %s", victim, pop.name, e)
            self._last_action[(pop.name, "drain")] = now
            return False
        draining[victim] = _Pending(handle=handle,
                                    deadline=now + self.drain_grace_s)
        self._last_action[(pop.name, "drain")] = now
        committed.append(self._entry(now, "drain", pop.name, victim, reason))
        return True

    def _find_handle(self, pop: Population,
                     worker: str) -> Optional[SpawnHandle]:
        return self._handles[pop.name].get(worker)

    # -- scale out ----------------------------------------------------------
    def _spawn_demand(self, demands: Dict[str, int], urgent: set,
                      effective: Dict[str, int],
                      observations: Dict[str, Optional[Dict[str, Any]]],
                      now: float,
                      committed: List[Dict[str, Any]]) -> None:
        if not demands:
            return
        if self.total_workers is None:
            supply = sum(demands.values())
        else:
            supply = max(0, self.total_workers
                         - sum(effective.values()))
        grants = self.scheduler.allocate(supply, demands, urgent)
        by_name = {p.name: p for p in self.populations}
        for pname in sorted(demands, key=lambda q: (q not in urgent, q)):
            pop = by_name[pname]
            granted = grants.get(pname, 0)
            # the cooldown gates the TICK, not each spawn within it: a
            # granted batch (e.g. restoring a half-killed pool) commits
            # together under the churn cap, then the pop cools down
            if granted > 0 and self._cooled(pop, "spawn", now):
                for _ in range(granted):
                    if not self._spawn_one(pop, now, committed):
                        break
            unmet = demands[pname] - granted
            if unmet > 0 and pname in urgent and \
                    self.total_workers is not None:
                self._yield_for(pop, effective, urgent, now, committed)

    def _spawn_one(self, pop: Population, now: float,
                   committed: List[Dict[str, Any]]) -> bool:
        if self._churn() >= self.max_churn:
            return False
        self._spawn_seq += 1
        worker = f"{pop.prefix()}{self._spawn_seq}"
        reason = "scale out"
        if self._yielded[pop.name] > 0:
            reason = "reclaim: capacity yielded to serving returns"
        try:
            faults.fire("actor.spawn")
            handle = pop.backend.spawn(worker, pop.name)
        except Exception as e:  # noqa: BLE001 - chaos or backend refusal
            obs.count("cluster.actor_failures_total", action="spawn")
            self._last_action[(pop.name, "spawn")] = now
            committed.append(self._entry(
                now, "spawn_failed", pop.name, worker, f"spawn raised: {e}"))
            return False
        if self._yielded[pop.name] > 0:
            self._yielded[pop.name] -= 1
        self._spawning[pop.name][worker] = _Pending(
            handle=handle, deadline=now + self.spawn_grace_s)
        self._handles[pop.name][worker] = handle
        while len(self._handles[pop.name]) > 4 * pop.max_workers:
            self._handles[pop.name].pop(next(iter(self._handles[pop.name])))
        self._last_action[(pop.name, "spawn")] = now
        committed.append(self._entry(now, "spawn", pop.name, worker, reason))
        return True

    def _yield_for(self, pop: Population, effective: Dict[str, int],
                   urgent: set, now: float,
                   committed: List[Dict[str, Any]]) -> None:
        """Budget exhausted and ``pop`` is burning its SLO: drain one
        worker from the lowest-weight non-urgent population over its
        floor, freeing a slot the next tick's allocation will grant."""
        by_name = {p.name: p for p in self.populations}
        floors = {p.name: p.min_workers for p in self.populations}
        victim_name = self.scheduler.preempt(effective, floors, pop.name,
                                             urgent)
        if victim_name is None:
            return
        victim_pop = by_name[victim_name]
        ob = None
        try:
            ob = victim_pop.probe()
        except Exception:  # noqa: BLE001
            return
        if self._drain_one(victim_pop, ob, now, committed,
                           reason=f"yield: {pop.name} SLO burn pre-empts "
                                  f"batch capacity"):
            self._yielded[victim_name] += 1

    # -- journal + reporting ------------------------------------------------
    def _entry(self, now: float, action: str, population: str,
               worker: str, reason: str) -> Dict[str, Any]:
        return {"ts": now, "actor": self.name, "action": action,
                "population": population, "worker": worker,
                "reason": reason,
                "signal": ACTION_SIGNAL.get(action, 0.0)}

    def _report(self, committed: List[Dict[str, Any]]) -> None:
        by_name = {p.name: p for p in self.populations}
        for entry in committed:
            pop = by_name.get(entry["population"])
            if pop is None or pop.reporter is None:
                continue
            try:
                pop.reporter(entry)
            except StaleMemberError:
                # a newer actor registered: single-writer fencing — stop
                # acting rather than fight it for the fleet
                log.error("actor %s deposed (a newer actor registered); "
                          "stopping", self.name)
                self.deposed = True
                return
            except Exception as e:  # noqa: BLE001 - telemetry best-effort
                log.warning("act_report failed: %s", e)

    # -- the loop -----------------------------------------------------------
    def run(self, stop: Optional[threading.Event] = None,
            max_ticks: Optional[int] = None) -> None:
        stop = stop or threading.Event()
        ticks = 0
        while not stop.is_set() and not self.deposed:
            self.step()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                return
            stop.wait(self.interval_s)


# -- control-plane probes ---------------------------------------------------

class MasterProbe:
    """Observation off an elastic master (or any membership-bearing
    MasterServer): ``mbr_view`` supplies members + the hysteresis-stable
    recommendation, ``obs_health`` the firing alerts, and the
    recommendation's own backlog field answers busyness."""

    def __init__(self, host: str, port: int, *, client=None):
        from ..runtime.membership import MembershipClient
        self._client = client or MembershipClient(
            host, int(port), retries=1, call_timeout=3.0)

    def __call__(self) -> Dict[str, Any]:
        view = self._client.cluster_view()
        rec = view.get("recommendation") or None
        alerts: List[str] = []
        try:
            h = self._client.obs_health()
            alerts = [str(a.get("rule")) for a in h.get("active", ())]
        except Exception:  # noqa: BLE001 - health plane optional
            pass
        busy = bool(rec and (rec.get("backlog") or 0) > 0)
        return {"members": view.get("members") or [],
                "recommendation": rec, "alerts": alerts, "busy": busy}

    def close(self) -> None:
        self._client.close()


class RouterProbe:
    """Observation off a PR 17 router's decode pool.

    The router's membership answers who is in the pool; ``route_stats``
    answers busyness (in-flight streams). The TTFT/TPOT burn-rate
    alerts, though, fire on each DAEMON's own aggregator (the daemon
    self-pushes its serving histograms) — so the probe polls every
    member's rpc endpoint (from its join caps) for ``obs_health`` and
    merges the firing rule names, caching one fail-fast telemetry client
    per endpoint."""

    def __init__(self, host: str, port: int, *, role: str = "decode",
                 client=None):
        from ..runtime.membership import MembershipClient
        self.role = role
        self._client = client or MembershipClient(
            host, int(port), retries=1, call_timeout=3.0)
        self._workers: Dict[Tuple[str, int], Any] = {}

    def _worker_client(self, host: str, port: int):
        from ..obs.aggregate import telemetry_client
        key = (host, int(port))
        if key not in self._workers:
            self._workers[key] = telemetry_client(*key)
        return self._workers[key]

    def __call__(self) -> Dict[str, Any]:
        view = self._client.cluster_view()
        members = [m for m in view.get("members") or ()
                   if (m.get("caps") or {}).get("role") == self.role]
        alerts: List[str] = []
        for m in members:
            caps = m.get("caps") or {}
            host, port = caps.get("rpc_host"), caps.get("rpc_port")
            if not host or not port:
                continue
            try:
                h = self._worker_client(host, port).obs_health()
                alerts.extend(str(a.get("rule"))
                              for a in h.get("active", ()))
            except Exception:  # noqa: BLE001 - a dead member answers nothing
                continue
        try:
            h = self._client.obs_health()
            alerts.extend(str(a.get("rule")) for a in h.get("active", ()))
        except Exception:  # noqa: BLE001
            pass
        busy = False
        try:
            rs = self._client._call({"op": "route_stats"})
            busy = int(rs.get("inflight", 0)) > 0
        except Exception:  # noqa: BLE001
            pass
        return {"members": members,
                "recommendation": view.get("recommendation") or None,
                "alerts": sorted(set(alerts)), "busy": busy}

    def close(self) -> None:
        self._client.close()
        for c in self._workers.values():
            try:
                c.close()
            except Exception:  # noqa: BLE001
                pass
        self._workers.clear()


class ActorReporter:
    """Per-population action reporter: registers this actor with the
    population's master (``act_register``, single-writer) and forwards
    each committed action through ``act_report`` so the master journals it
    (the ``cluster.autoscale_committed`` satellite). A fencing refusal
    (a newer actor took over) propagates as StaleMemberError — the
    actor's cue to stand down."""

    def __init__(self, host: str, port: int, actor: str, *, client=None):
        from ..runtime.membership import MembershipClient
        self.actor = actor
        self._client = client or MembershipClient(
            host, int(port), retries=1, call_timeout=3.0)
        self._token: Optional[int] = None

    def __call__(self, entry: Dict[str, Any]) -> None:
        if self._token is None:
            self._token, _ = self._client.act_register(self.actor)
        self._client.act_report(
            self.actor, self._token, action=entry.get("action", ""),
            population=entry.get("population", ""),
            worker=entry.get("worker", ""),
            reason=entry.get("reason", ""),
            signal=float(entry.get("signal", 0.0)))

    def close(self) -> None:
        self._client.close()
