"""The port's fleet actor (paddle_tpu_torch/cluster: ``FleetActor``,
``FleetScheduler``, the spawn seam) over the port's membership, health
and elastic planes — the cases of tests/test_fleet_actor.py but the
``benchmarks.fleet_autoscale`` run (the port's benchmark comes in a PR of
its own) and the ``cluster autoscale`` CLI cases (the port's CLI
subcommands are ROADMAP A.8c).

The fake-clock cases hold the port to JAX's contract assertion for
assertion; :func:`test_actor_journal_equals_jax` drives one scripted
scenario through both packages' actors and compares the journals; the
elastic integration case trains tests/torch_elastic_net.py (weights
carried from JAX's ``params0``) and holds the actor-scaled fleet to the
static fleet bit for bit.
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.cluster as JC
from elastic_testnet import build as jbuild
from paddle_tpu_torch import obs
from paddle_tpu_torch.cluster import (ActorReporter, FleetActor,
                                      FleetScheduler, HookSpawnBackend,
                                      MasterProbe, Population, SpawnHandle)
from paddle_tpu_torch.convert import tree_from_numpy
from paddle_tpu_torch.core.pytree import tree_items
from paddle_tpu_torch.faults import FaultPlan
from paddle_tpu_torch.obs.aggregate import ClusterAggregator
from paddle_tpu_torch.obs.health import health_table
from paddle_tpu_torch.runtime.master_service import (MasterServer,
                                                     StaleMemberError)
from paddle_tpu_torch.runtime.membership import MembershipService
from paddle_tpu_torch.trainer.elastic import ElasticMaster, ElasticWorker
from torch_elastic_net import build

LOSS_FN, MK_OPT, BATCHES = build(steps=6)
_PARAMS0_NP = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
               for k, v in jbuild()[1]().items()}


def PARAMS0():
    return tree_from_numpy(_PARAMS0_NP, "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the fleet scheduler (weighted-fair deficit over workers)
# ---------------------------------------------------------------------------

def test_scheduler_weighted_allocation_favors_serving():
    s = FleetScheduler()                      # serve:4, train:1
    grants = s.allocate(5, {"serve": 4, "train": 4})
    assert grants == {"serve": 4, "train": 1}


def test_scheduler_urgent_population_served_first():
    s = FleetScheduler(weights={"serve": 1.0, "train": 8.0})
    grants = s.allocate(2, {"serve": 2, "train": 2}, urgent={"serve"})
    # urgency beats weight: the burning population takes the whole supply
    assert grants["serve"] == 2 and grants.get("train", 0) == 0


def test_scheduler_idle_population_credit_resets():
    s = FleetScheduler(weights={"a": 1.0, "b": 1.0})
    g = s.allocate(1, {"a": 4, "b": 4})       # the loser banks credit
    loser = "a" if g.get("b") else "b"
    assert s.credits()[loser] > 0.0
    s.allocate(0, {("b" if loser == "a" else "a"): 4})   # loser goes idle
    assert s.credits()[loser] == 0.0          # no banking while idle


def test_scheduler_preempt_picks_lowest_weight_over_floor():
    s = FleetScheduler()
    victim = s.preempt({"serve": 2, "train": 3},
                       {"serve": 1, "train": 1}, "serve")
    assert victim == "train"
    # at its floor the batch population is untouchable
    assert s.preempt({"serve": 2, "train": 1},
                     {"serve": 1, "train": 1}, "serve") is None
    # an urgent population is never a victim
    assert s.preempt({"serve": 2, "train": 3}, {"serve": 1, "train": 1},
                     "serve", urgent={"train"}) is None


# ---------------------------------------------------------------------------
# actor unit tests: a fake in-memory population under a fake clock
# ---------------------------------------------------------------------------

class _FakePool:
    """In-memory population: spawn joins on the next tick, drain leaves
    immediately (the graceful path), tokens are join order."""

    def __init__(self, workers=()):
        self._tok = 0
        self.members = {}
        self.recommendation = None
        self.alerts = []
        self.busy = False
        self.drained = []
        self.killed = []
        for w in workers:
            self.join(w)

    def join(self, worker):
        self._tok += 1
        self.members[worker] = self._tok

    def spawn_fn(self, worker, population):
        self.join(worker)                     # joins before the next probe

    def drain_fn(self, handle):
        self.drained.append(handle.worker)
        self.members.pop(handle.worker, None)

    def kill_fn(self, handle):
        self.killed.append(handle.worker)
        self.members.pop(handle.worker, None)

    def alive_fn(self, handle):
        return handle.worker in self.members

    def backend(self, **kw):
        hooks = {"spawn_fn": self.spawn_fn, "drain_fn": self.drain_fn,
                 "kill_fn": self.kill_fn, "alive_fn": self.alive_fn}
        hooks.update(kw)
        return HookSpawnBackend(hooks.pop("spawn_fn"), **hooks)

    def probe(self):
        return {"members": [{"worker": w, "token": t}
                            for w, t in sorted(self.members.items())],
                "recommendation": self.recommendation,
                "alerts": list(self.alerts), "busy": self.busy}


def _actor(pools, clock, **kw):
    kw.setdefault("cooldown_s", 5.0)
    kw.setdefault("max_churn", 1)
    return FleetActor(pools, clock=lambda: clock[0], **kw)


def test_actor_spawns_on_join_recommendation():
    clock = [0.0]
    pool = _FakePool(["w0", "w1"])
    pool.recommendation = {"action": "join", "reason": "backlog", "backlog": 9}
    pop = Population("train", backend=pool.backend(), probe=pool.probe)
    actor = _actor([pop], clock)
    committed = actor.step()
    assert [e["action"] for e in committed] == ["spawn"]
    assert committed[0]["worker"] in pool.members
    assert committed[0]["signal"] == 1.0
    # the recommendation satisfied, the next tick holds
    pool.recommendation = {"action": "hold"}
    clock[0] = 10.0
    assert actor.step() == []


def test_actor_cooldown_damps_repeat_spawns():
    clock = [0.0]
    pool = _FakePool(["w0"])
    pop = Population("serve", backend=pool.backend(), probe=pool.probe,
                     target=4, max_workers=4)
    actor = _actor([pop], clock, max_churn=4)
    assert len(actor.step()) > 0              # first batch commits
    n_after_first = len(pool.members)
    pool.members.pop(next(iter(pool.members)))  # still under target...
    clock[0] = 1.0                            # ...but inside the cooldown
    assert actor.step() == []
    clock[0] = 6.0                            # cooled: acts again
    assert len(actor.step()) > 0
    assert len(pool.members) >= n_after_first


def test_actor_churn_cap_bounds_one_tick():
    clock = [0.0]
    pool = _FakePool(["w0"])
    pop = Population("serve", backend=pool.backend(), probe=pool.probe,
                     target=5, max_workers=8)
    actor = _actor([pop], clock, max_churn=2)
    committed = actor.step()
    # 4 short of target but only 2 concurrent spawns allowed
    assert [e["action"] for e in committed] == ["spawn", "spawn"]


def test_actor_spawn_failure_is_journaled_not_fatal():
    clock = [0.0]
    reg = obs.MetricsRegistry()
    pool = _FakePool(["w0"])
    pool.recommendation = {"action": "join"}
    pop = Population("train", backend=pool.backend(), probe=pool.probe)
    actor = _actor([pop], clock)
    plan = FaultPlan(seed=0).add("actor.spawn", "raise")
    with obs.ObsSession(registry=reg).installed(), plan.installed():
        committed = actor.step()
    assert [e["action"] for e in committed] == ["spawn_failed"]
    assert committed[0]["signal"] == 0.0
    assert reg.counter("cluster.actor_failures_total").get(
        action="spawn") == 1
    assert reg.counter("faults.injected_total").get(
        site="actor.spawn", action="raise") == 1
    assert len(pool.members) == 1             # nothing half-spawned
    assert not actor.deposed                  # the loop survives chaos


def test_actor_spawn_that_never_joins_fails_after_grace():
    clock = [0.0]
    pool = _FakePool(["w0"])
    pool.recommendation = {"action": "join"}
    # a backend whose processes start but never reach membership
    pop = Population("train",
                     backend=pool.backend(spawn_fn=lambda w, p: None),
                     probe=pool.probe)
    actor = _actor([pop], clock, spawn_grace_s=30.0)
    assert [e["action"] for e in actor.step()] == ["spawn"]
    clock[0] = 31.0
    committed = actor.step()
    assert any(e["action"] == "spawn_failed" for e in committed)


def test_actor_leave_racing_spawn_grace_drains_at_most_one():
    """A `leave` recommendation arriving while a spawn is still inside
    its grace window (a very slow boot: process alive, not yet joined)
    must shrink the pool by ONE live member — the unjoined spawn counts
    toward effective capacity but is not a drainable worker, so it must
    not inflate the drain into a second live departure."""
    clock = [0.0]
    pool = _FakePool(["w0", "w1"])
    pool.recommendation = {"action": "join"}
    # the spawned process starts (alive) but never reaches membership
    pop = Population("serve",
                     backend=pool.backend(spawn_fn=lambda w, p: None,
                                          alive_fn=lambda h: True),
                     probe=pool.probe, min_workers=0)
    actor = _actor([pop], clock, max_churn=8, spawn_grace_s=60.0)
    assert [e["action"] for e in actor.step()] == ["spawn"]
    pool.recommendation = {"action": "leave", "reason": "idle"}
    clock[0] = 10.0                           # inside the spawn grace
    committed = actor.step()
    assert [e["action"] for e in committed] == ["drain"]
    assert len(pool.members) == 1, \
        "leave racing an in-grace spawn double-drained the live pool"
    # the pending spawn itself was neither failed nor drained
    assert len(actor._spawning["serve"]) == 1


def test_actor_drain_escalates_to_evict_after_grace():
    clock = [0.0]
    pool = _FakePool(["w0", "w1", "w2"])
    # a drain that hangs: the worker ignores the graceful request
    pop = Population("serve", backend=pool.backend(
        drain_fn=lambda h: pool.drained.append(h.worker)),
        probe=pool.probe, target=2, min_workers=1)
    actor = _actor([pop], clock, drain_grace_s=20.0)
    committed = actor.step()
    assert [e["action"] for e in committed] == ["drain"]
    victim = committed[0]["worker"]
    assert victim == "w2"                     # newest incarnation first
    clock[0] = 21.0                           # grace expires: escalate
    committed = actor.step()
    assert any(e["action"] == "evict" and e["worker"] == victim
               for e in committed)
    assert victim in pool.killed


def test_actor_faultplan_delay_on_drain_uses_fake_sleep():
    clock = [0.0]
    slept = []
    pool = _FakePool(["w0", "w1"])
    pop = Population("serve", backend=pool.backend(), probe=pool.probe,
                     target=1, min_workers=1)
    actor = _actor([pop], clock)
    plan = FaultPlan(seed=0, sleep=slept.append).add(
        "actor.drain", "delay", delay_s=3.0)
    with plan.installed():
        committed = actor.step()
    assert slept == [3.0]                     # chaos delay, zero real sleep
    assert [e["action"] for e in committed] == ["drain"]


# ---------------------------------------------------------------------------
# the graceful-leave-storm safety bar
# ---------------------------------------------------------------------------

def test_actor_never_drains_below_min_workers():
    clock = [0.0]
    pool = _FakePool(["w0", "w1", "w2"])
    pop = Population("serve", backend=pool.backend(), probe=pool.probe,
                     target=0, min_workers=2)
    actor = _actor([pop], clock, max_churn=8)
    for i in range(10):
        clock[0] = i * 10.0
        actor.step()
        assert len(pool.members) >= 2
    assert len(pool.members) == 2


def test_actor_never_retires_last_busy_worker():
    clock = [0.0]
    pool = _FakePool(["w0", "w1", "w2", "w3"])
    pool.busy = True                          # live decode stream /
    pop = Population("serve", backend=pool.backend(), probe=pool.probe,
                     target=0, min_workers=0)  # in-flight elastic shard
    actor = _actor([pop], clock, max_churn=8)
    for i in range(12):
        clock[0] = i * 10.0
        actor.step()
        assert len(pool.members) >= 1, "rolling drain evicted the fleet"
    assert len(pool.members) == 1             # drained down to the floor...
    pool.busy = False
    clock[0] = 200.0
    actor.step()
    assert len(pool.members) == 0             # ...and out once idle


def test_actor_rolling_drain_storm_is_one_at_a_time():
    clock = [0.0]
    pool = _FakePool([f"w{i}" for i in range(6)])
    pool.busy = True
    pop = Population("serve", backend=pool.backend(), probe=pool.probe,
                     target=1, min_workers=1)
    actor = _actor([pop], clock, max_churn=1, cooldown_s=5.0)
    sizes = []
    for i in range(20):
        clock[0] = i * 6.0
        actor.step()
        sizes.append(len(pool.members))
    # monotone rolling drain, never more than one departure per tick
    assert all(a - b in (0, 1) for a, b in zip(sizes, sizes[1:]))
    assert sizes[-1] == 1


# ---------------------------------------------------------------------------
# train/serve unification: yield on SLO burn, reclaim on resolve
# ---------------------------------------------------------------------------

def test_actor_training_yields_to_burning_serving_and_reclaims():
    clock = [0.0]
    serve, train = _FakePool(["s0", "s1"]), _FakePool(["t0", "t1", "t2"])
    serve_pop = Population("serve", backend=serve.backend(),
                           probe=serve.probe, target=2, min_workers=1,
                           max_workers=6)
    train_pop = Population("train", backend=train.backend(),
                           probe=train.probe, target=3, min_workers=1,
                           max_workers=6)
    actor = _actor([serve_pop, train_pop], clock, total_workers=5,
                   max_churn=2)
    assert actor.step() == []                 # budget-balanced steady state
    serve.alerts = ["serving_ttft_slo_burn"]  # serving starts burning
    clock[0] = 10.0
    committed = actor.step()
    # no free budget: training yields one worker for the urgent pool
    assert [(e["action"], e["population"]) for e in committed] == \
        [("drain", "train")]
    assert "yield" in committed[0]["reason"]
    clock[0] = 20.0
    committed = actor.step()                  # freed slot goes to serving
    assert ("spawn", "serve") in [(e["action"], e["population"])
                                  for e in committed]
    assert len(serve.members) == 3
    serve.alerts = []                         # burn resolves
    clock[0] = 30.0
    committed = actor.step()                  # serving back to target...
    assert [(e["action"], e["population"]) for e in committed] == \
        [("drain", "serve")]
    clock[0] = 40.0
    committed = actor.step()                  # ...and training reclaims
    assert [(e["action"], e["population"]) for e in committed] == \
        [("spawn", "train")]
    assert "reclaim" in committed[0]["reason"]
    assert len(train.members) == 3 and len(serve.members) == 2


# ---------------------------------------------------------------------------
# single-writer fencing + the committed-action journal (act_* ops)
# ---------------------------------------------------------------------------

class _DispatchActClient:
    """MembershipClient.act_* over in-process dispatch (no TCP)."""

    def __init__(self, srv):
        self.srv = srv

    def act_register(self, actor):
        r = self.srv._dispatch({"op": "act_register", "actor": actor})
        assert r.get("ok"), r
        return r["actor_token"], r["epoch"]

    def act_report(self, actor, token, *, action, population, worker,
                   reason="", signal=0.0):
        r = self.srv._dispatch({
            "op": "act_report", "actor": actor, "actor_token": token,
            "action": action, "population": population, "worker": worker,
            "reason": reason, "signal": signal})
        if not r.get("ok"):
            raise StaleMemberError(r.get("error", "?"),
                                   code=r.get("code", "unknown_member"),
                                   epoch=r.get("epoch"))
        return r["epoch"]

    def close(self):
        pass


def test_act_report_single_writer_fencing():
    srv = MasterServer()
    MembershipService(ttl=10.0).attach(srv)
    r1 = srv._dispatch({"op": "act_register", "actor": "a1"})
    assert r1["ok"]
    ok = srv._dispatch({"op": "act_report", "actor": "a1",
                        "actor_token": r1["actor_token"],
                        "action": "spawn", "population": "serve",
                        "worker": "w1", "reason": "scale out",
                        "signal": 1.0})
    assert ok["ok"]
    # a second actor registers: the first one's token goes stale
    r2 = srv._dispatch({"op": "act_register", "actor": "a2"})
    assert r2["actor_token"] > r1["actor_token"]
    stale = srv._dispatch({"op": "act_report", "actor": "a1",
                           "actor_token": r1["actor_token"],
                           "action": "drain", "population": "serve",
                           "worker": "w1", "signal": -1.0})
    assert not stale["ok"] and stale["code"] == "unknown_member"
    wrong_tok = srv._dispatch({"op": "act_report", "actor": "a2",
                               "actor_token": r1["actor_token"],
                               "action": "drain", "population": "serve",
                               "worker": "w1", "signal": -1.0})
    assert not wrong_tok["ok"] and wrong_tok["code"] == "stale_member"
    # only the accepted report landed in the journal
    actions = srv.aggregator.recent_actions()
    assert [a["action"] for a in actions] == ["spawn"]
    # ... and obs_health surfaces it to every health consumer
    h = srv._dispatch({"op": "obs_health"})
    assert h["ok"] and h["actions"][-1]["worker"] == "w1"


def test_deposed_actor_stands_down():
    srv = MasterServer()
    MembershipService(ttl=10.0).attach(srv)
    clock = [0.0]
    pool = _FakePool(["w0"])
    pool.recommendation = {"action": "join"}
    reporter = ActorReporter("x", 0, "actor-1",
                             client=_DispatchActClient(srv))
    pop = Population("train", backend=pool.backend(), probe=pool.probe,
                     reporter=reporter)
    actor = _actor([pop], clock)
    actor.step()
    assert not actor.deposed
    assert srv.aggregator.recent_actions()[-1]["actor"] == "actor-1"
    # a rival actor takes over the fleet
    ActorReporter("x", 0, "actor-2", client=_DispatchActClient(srv))(
        {"action": "spawn", "population": "train", "worker": "wx",
         "reason": "takeover", "signal": 1.0})
    pool.recommendation = {"action": "join"}
    clock[0] = 10.0
    actor.step()                              # report fenced -> stand down
    assert actor.deposed
    # run() exits immediately for a deposed actor
    actor.run(max_ticks=100)


# ---------------------------------------------------------------------------
# obs surfacing: committed gauge, action tail, /alerts endpoint
# ---------------------------------------------------------------------------

def test_note_action_emits_gauge_and_journal():
    reg = obs.MetricsRegistry()
    clock = [100.0]
    agg = ClusterAggregator(clock=lambda: clock[0])
    with obs.ObsSession(registry=reg).installed():
        agg.note_action({"actor": "a", "action": "spawn",
                         "population": "serve", "worker": "s-w1",
                         "reason": "scale out", "signal": 1.0})
        agg.note_action({"actor": "a", "action": "drain",
                         "population": "train", "worker": "t-w9",
                         "reason": "yield: serve SLO burn", "signal": -1.0})
    acts = agg.recent_actions()
    assert [a["action"] for a in acts] == ["spawn", "drain"]
    assert acts[0]["ts"] == 100.0
    # the committed gauge tracks the LAST action's signal
    assert reg.gauge("cluster.autoscale_committed").get() == -1.0
    assert reg.counter("cluster.actor_actions_total").get(
        population="serve", action="spawn") == 1
    # ... and the gauge is in history, so alert rules can threshold it
    from paddle_tpu_torch.obs.health import MASTER_WORKER
    pts = agg.history.points(MASTER_WORKER, "cluster.autoscale_committed",
                             now=clock[0])
    assert [v for _, v in pts] == [1.0, -1.0]


def test_health_table_renders_action_tail():
    acts = [{"ts": 12.0, "actor": "a", "action": "spawn",
             "population": "serve", "worker": "serve-w1",
             "reason": "scale out", "signal": 1.0}]
    txt = health_table({}, actions=acts)
    assert "autoscale actions" in txt
    assert "serve-w1" in txt and "scale out" in txt
    # with workers present the tail rides below the table
    samples = [{"type": "gauge", "name": "goodput.ratio",
                "labels": {"worker": "w1"}, "value": 0.9}]
    txt = health_table(samples, actions=acts)
    assert txt.index("w1") < txt.index("autoscale actions")


def test_alerts_endpoint_serves_actions():
    import http.client
    import json
    from paddle_tpu_torch.obs.aggregate import ObsHttpServer
    dump = {"workers": {}, "alerts": [],
            "actions": [{"ts": 1.0, "actor": "a", "action": "spawn",
                         "population": "serve", "worker": "w1",
                         "reason": "scale out", "signal": 1.0}]}
    srv = ObsHttpServer(lambda: dump).start()
    try:
        host, port = srv.address
        conn = http.client.HTTPConnection(host, port, timeout=5)
        conn.request("GET", "/alerts")
        resp = conn.getresponse()
        body = json.loads(resp.read().decode())
        conn.close()
        assert resp.status == 200
        assert body["actions"][0]["action"] == "spawn"
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# integration: the actor drives a REAL elastic fleet; trajectory is
# byte-stable across every fleet shape it chooses
# ---------------------------------------------------------------------------

def _flat(params):
    return {"/".join(p): v.detach().cpu().numpy()
            for p, v in tree_items(params)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _run_static_elastic(n_workers, batches):
    em = ElasticMaster(LOSS_FN, MK_OPT(), ttl=5.0, task_timeout_s=10.0,
                       shards_per_step=4, min_workers=n_workers,
                       device="cpu").start()
    host, port = em.address
    stop = threading.Event()
    threads = []
    for i in range(n_workers):
        w = ElasticWorker(build()[0], (host, port), worker=f"static{i}",
                          device="cpu")
        t = threading.Thread(target=w.run, kwargs={"stop": stop},
                             daemon=True)
        t.start()
        threads.append(t)
    try:
        params, _, loss = em.fit(batches, PARAMS0(), num_passes=1,
                                 progress_timeout=60.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=15)
        em.stop()
    return params, loss


@pytest.mark.chaos
def test_actor_scaled_elastic_fleet_is_byte_stable():
    """The actor spawns the training fleet from zero, then drains a
    worker mid-pass (graceful: the worker finishes its in-flight shard
    and leaves at the barrier). The parameter trajectory must equal the
    static two-worker run bit for bit — fleet shape is the actor's
    business, arithmetic is not."""
    em = ElasticMaster(LOSS_FN, MK_OPT(), ttl=5.0, task_timeout_s=10.0,
                       shards_per_step=4, min_workers=1,
                       device="cpu").start()
    host, port = em.address
    stops, threads = {}, {}

    def spawn_fn(worker, population):
        ev = threading.Event()
        w = ElasticWorker(build()[0], (host, port), worker=worker,
                          device="cpu")
        t = threading.Thread(target=w.run, kwargs={"stop": ev},
                             daemon=True)
        t.start()
        stops[worker], threads[worker] = ev, t

    def drain_fn(handle):
        ev = stops.get(handle.worker)
        if ev is not None:
            ev.set()            # graceful: drain at the next barrier

    def alive_fn(handle):
        t = threads.get(handle.worker)
        return t is not None and t.is_alive()

    real_probe = MasterProbe(host, port)

    def probe():
        ob = real_probe()
        ob["recommendation"] = None    # the target alone steers this test
        return ob

    pop = Population("train",
                     backend=HookSpawnBackend(spawn_fn, drain_fn,
                                              alive_fn=alive_fn),
                     probe=probe, min_workers=1, max_workers=2, target=2)
    actor = FleetActor([pop], cooldown_s=0.0, max_churn=2,
                       spawn_grace_s=30.0, drain_grace_s=30.0)
    result = {}

    def fit():
        result["params"], _, result["loss"] = em.fit(
            BATCHES, PARAMS0(), num_passes=1, progress_timeout=60.0)

    ft = threading.Thread(target=fit, daemon=True)
    ft.start()
    try:
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline \
                and len(em.membership.members()) < 2:
            actor.step()
            time.sleep(0.05)
        assert len(em.membership.members()) == 2, "actor never built fleet"
        pop.target = 1           # mid-pass scale-in
        while time.monotonic() < deadline and ft.is_alive() \
                and len(em.membership.members()) > 1:
            actor.step()
            time.sleep(0.05)
        ft.join(timeout=60.0)
        assert not ft.is_alive()
    finally:
        for ev in stops.values():
            ev.set()
        for t in threads.values():
            t.join(timeout=15)
        real_probe.close()
        em.stop()
    spawns = [e for e in actor.journal if e["action"] == "spawn"]
    assert len(spawns) == 2 and all(e["population"] == "train"
                                    for e in spawns)
    static_params, static_loss = _run_static_elastic(2, BATCHES)
    _assert_trees_equal(result["params"], static_params)
    assert result["loss"] == static_loss


# ---------------------------------------------------------------------------
# the serving daemon's drain ordering (graceful-drain-before-evict)
# ---------------------------------------------------------------------------

def test_daemon_stop_leaves_router_before_draining():
    """A routed daemon must leave membership FIRST so the router stops
    placing on it and re-routes, and only then wait out in-flight work —
    leaving last would strand every stream placed during the drain."""
    import types
    from paddle_tpu_torch.serving.daemon import ServingDaemon
    calls = []
    d = ServingDaemon.__new__(ServingDaemon)
    d._draining = threading.Event()
    d._stop = threading.Event()
    d._obs_thread = None
    d._keeper = object()                      # joined a router
    d.engine = types.SimpleNamespace(
        stats=lambda: (calls.append("drain-poll"),
                       {"slots_live": 0, "queue_depth": 0})[1],
        pending_results=lambda: 0,
        stop=lambda: calls.append("engine-stop"))
    d.server = types.SimpleNamespace(
        stop=lambda: calls.append("server-stop"),
        conn_count_supported=True,
        active_connections=lambda: 0)
    d._leave_router = lambda: calls.append("leave")
    d.stop(drain_s=0.5)
    assert calls[0] == "leave"                # left BEFORE the drain wait
    assert calls.index("leave") < calls.index("drain-poll")
    assert calls[-2:] == ["server-stop", "engine-stop"]


# ---------------------------------------------------------------------------
# the port's actor against JAX's, decision for decision
# ---------------------------------------------------------------------------

def _scripted_journal(cluster):
    """One scripted two-population scenario (a join recommendation, the
    serve burn and its resolve, a spawn that fails once, a drain storm)
    through ``cluster``'s FleetActor on a fake clock; the journal."""
    clock = [0.0]
    serve, train = _FakePool(["s0", "s1"]), _FakePool(["t0", "t1", "t2"])
    fails = {"n": 0}

    def flaky_spawn(worker, population):
        if population == "serve" and fails["n"] == 0:
            fails["n"] += 1
            raise RuntimeError("no capacity")
        serve.join(worker)

    serve_pop = cluster.Population(
        "serve", backend=cluster.HookSpawnBackend(
            flaky_spawn, drain_fn=serve.drain_fn, kill_fn=serve.kill_fn,
            alive_fn=serve.alive_fn),
        probe=serve.probe, target=2, min_workers=1, max_workers=6)
    train_pop = cluster.Population(
        "train", backend=cluster.HookSpawnBackend(
            train.spawn_fn, drain_fn=train.drain_fn, kill_fn=train.kill_fn,
            alive_fn=train.alive_fn),
        probe=train.probe, target=3, min_workers=1, max_workers=6)
    actor = cluster.FleetActor([serve_pop, train_pop], total_workers=6,
                               cooldown_s=5.0, max_churn=2,
                               clock=lambda: clock[0])
    script = [
        lambda: None,
        lambda: setattr(serve, "alerts", ["serving_ttft_slo_burn"]),
        lambda: None,
        lambda: setattr(train, "recommendation",
                        {"action": "join", "reason": "backlog"}),
        lambda: setattr(serve, "alerts", []),
        lambda: setattr(train, "recommendation",
                        {"action": "leave", "reason": "idle"}),
        lambda: setattr(train, "recommendation", {"action": "hold"}),
        lambda: None,
    ]
    for i, poke in enumerate(script):
        poke()
        clock[0] = 10.0 * i
        actor.step()
    return [{k: v for k, v in e.items() if k != "actor"}
            for e in actor.journal], sorted(serve.members), \
        sorted(train.members)


def test_actor_journal_equals_jax():
    import paddle_tpu_torch.cluster as TC
    got = _scripted_journal(TC)
    want = _scripted_journal(JC)
    assert got[0], "the scenario committed nothing"
    assert got == want
