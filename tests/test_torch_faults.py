"""The port's fault plane (paddle_tpu_torch/faults, utils/retry.py and the
two hooks it puts back: ``ckpt.write`` in trainer/checkpoint.py and
``step.grad`` in trainer/trainer.py) against the JAX package's, on the
CPU.

``FaultPlan`` semantics, seeded corruption and ``RetryPolicy`` schedules
(on a fake clock, no real sleep) mirror tests/test_faults.py:79-190 and
run through both packages: the same plan, payloads and seeds must give
the same outputs, hits and fired logs, the same schedules to the last
bit. The trainer cases run both packages' ``Trainer`` on an L1 linear
regression built to be exact in f32: x in {-1, 0, 1}, y in {-1, 0, 1}
+ 2**-9 (so no residual is ever 0, where the two frameworks' gradients
of |r| differ), batch 8, SGD at lr 2**-4 from zero. Each gradient entry
is a multiple of 1/8, so the parameters stay on a grid of 2**-7 and
every sum of a step, the cost included, is exact in any order (checked
against float64 in the first trainer test): costs, parameters and
checkpoint files must be equal bit for bit, not merely close.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.faults as JF
import paddle_tpu.trainer.checkpoint as JC
import paddle_tpu.utils.retry as JR
import paddle_tpu_torch.faults as PF
import paddle_tpu_torch.trainer.checkpoint as PC
import paddle_tpu_torch.utils.retry as PR
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.trainer import Trainer as JTrainer
from paddle_tpu_torch.optimizer import SGD as PSGD
from paddle_tpu_torch.trainer import Trainer as PTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = [pytest.param((JF, JR), id="jax"), pytest.param((PF, PR), id="port")]


def _fake_time():
    """(sleep, clock, t) over a virtual clock — no real sleeping."""
    t = [0.0]

    def sleep(s):
        t[0] += s

    return sleep, (lambda: t[0]), t


# -- FaultPlan semantics, both packages ---------------------------------------

def _window(F):
    plan = F.FaultPlan()
    plan.add("ckpt.write", "truncate", nth=2, count=2, truncate_to=3)
    with plan.installed():
        out = [F.filter_bytes("ckpt.write", b"abcdef") for _ in range(4)]
    return out, plan.fired, dict(plan.hits)


def test_fault_plan_nth_count_window_matches_jax():
    got, want = _window(PF), _window(JF)
    assert got == want
    assert got[0] == [b"abcdef", b"abc", b"abc", b"abcdef"]
    assert got[1] == [("ckpt.write", 2, "truncate"),
                      ("ckpt.write", 3, "truncate")]


@pytest.mark.parametrize("mods", BOTH)
def test_fault_plan_zero_cost_when_uninstalled(mods):
    F, _ = mods
    plan = F.FaultPlan()
    plan.add("reader.next", "raise")
    assert F.filter_bytes("ckpt.write", b"x") == b"x"
    assert F.filter_value("step.grad", 1.5) == 1.5
    F.fire("reader.next")
    assert not F.is_active()
    assert plan.hits == {}


@pytest.mark.parametrize("mods", BOTH)
def test_fault_plan_exclusive_install_and_bad_site(mods):
    F, _ = mods
    with pytest.raises(ValueError, match="unknown injection site"):
        F.Fault("not.a.site")
    with pytest.raises(ValueError, match="unknown fault action"):
        F.Fault("ckpt.write", "explode")
    a, b = F.FaultPlan(), F.FaultPlan()
    with a.installed():
        with pytest.raises(RuntimeError, match="already installed"):
            b.install()
    assert not F.is_active()


def test_plans_of_the_two_packages_are_separate():
    """A JAX plan never fires a port site and a port plan never a JAX site:
    each package has its own process-global plan."""
    jplan, pplan = JF.FaultPlan(), PF.FaultPlan()
    jplan.add("reader.next", "raise")
    pplan.add("ckpt.write", "truncate", truncate_to=1)
    with jplan.installed():
        assert JF.is_active() and not PF.is_active()
        PF.fire("reader.next")                 # the port's hook: no-op
        with pplan.installed():
            assert PF.filter_bytes("ckpt.write", b"abc") == b"a"
            assert JF.filter_bytes("ckpt.write", b"abc") == b"abc"
    assert jplan.hits == {"ckpt.write": 1}
    assert pplan.hits == {"ckpt.write": 1}
    assert set(PF.SITES) == set(JF.SITES)


#: the sites of runtime/lease.py and cluster/actor.py, which the port's
#: plan refused until those modules came across
_UNPORTED_SITES = ("actor.drain", "actor.spawn", "lease.renew")


def _fire_plane_site(site, plan):
    """Drive the port's code that fires ``site`` (a lease renewal, a
    fleet actor's spawn or drain) once with ``plan`` installed; returns
    what the caller sees."""
    import tempfile

    from paddle_tpu_torch.cluster import (FleetActor, HookSpawnBackend,
                                          Population)
    from paddle_tpu_torch.runtime import FileLease
    if site == "lease.renew":
        with tempfile.TemporaryDirectory() as d:
            lease = FileLease(d + "/l.lease", owner="a", ttl=5.0)
            assert lease.try_acquire()
            with plan.installed():
                with pytest.raises(PF.FaultError):
                    lease.renew()
            return lease.renew()
    members = {"w0": 1, "w1": 2}
    pop = Population(
        "serve", backend=HookSpawnBackend(
            lambda w, p: members.setdefault(w, 9),
            drain_fn=lambda h: members.pop(h.worker, None)),
        probe=lambda: {"members": [{"worker": w, "token": t}
                                   for w, t in sorted(members.items())],
                       "recommendation": None, "alerts": [],
                       "busy": False},
        target=3 if site == "actor.spawn" else 1, min_workers=1)
    actor = FleetActor([pop], cooldown_s=0.0, max_churn=1,
                       clock=lambda: 0.0)
    with plan.installed():
        return actor.step()


@pytest.mark.parametrize("site", _UNPORTED_SITES)
def test_the_port_refuses_a_site_it_does_not_fire(site):
    """The port's plan now takes every site of JAX's (its modules have
    come across), and a rule at ``site`` fires where the port's module
    fires it: the lease renewal raises, the actor's spawn or drain is
    journaled as failed (spawn) or skipped (drain) and counted, as in
    JAX."""
    from paddle_tpu_torch import obs as tobs
    assert set(JF.SITES) == set(PF.SITES)
    JF.FaultPlan().add(site, "raise")
    plan = PF.FaultPlan(seed=2).add(site, "raise", nth=1)
    reg = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=reg).installed():
        got = _fire_plane_site(site, plan)
    assert plan.fired and plan.fired[0][0] == site
    assert reg.counter("faults.injected_total").get(
        site=site, action="raise") == 1
    if site == "lease.renew":
        assert got is True           # the next renewal goes through
        assert reg.counter("lease.renews_total").get() == 2
    elif site == "actor.spawn":
        assert [e["action"] for e in got] == ["spawn_failed"]
        assert reg.counter("cluster.actor_failures_total").get(
            action="spawn") == 1
    else:
        assert got == []
        assert reg.counter("cluster.actor_failures_total").get(
            action="drain") == 1


def _fire_wire_site(site):
    """Drive the port's code path that fires ``site`` once under a plan
    that raises there (``srv.ship``: corrupts), and return the plan."""
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.runtime import (MasterClient, MasterServer,
                                          MembershipClient,
                                          MembershipService)
    from paddle_tpu_torch.serving import (ServingDaemon, ServingEngine,
                                          ServingRouter, ship)
    action = "corrupt" if site == "srv.ship" else "raise"
    plan = PF.FaultPlan(seed=1).add(site, action, nth=1,
                                    exc=ConnectionError("injected"))
    if site in ("rpc.send", "rpc.recv", "mbr.heartbeat"):
        srv = MasterServer()
        MembershipService(ttl=5.0).attach(srv)
        srv.start()
        try:
            if site == "mbr.heartbeat":
                mc = MembershipClient(*srv.address, call_timeout=10.0)
                token, _, _ = mc.join("w")
                with plan.installed():
                    with pytest.raises(ConnectionError, match="injected"):
                        mc.heartbeat("w", token)
                    assert mc.heartbeat("w", token) >= 1
            else:
                # the client's retry rides over the dropped frame
                mc = MasterClient(*srv.address, retry_delay=0.01,
                                  call_timeout=10.0)
                with plan.installed():
                    assert mc.stats()[0] == 0
            mc.close()
        finally:
            srv.stop()
    elif site == "srv.ship":
        with plan.installed():
            frames = list(ship.iter_chunks(b"\x01" * 64, chunk_bytes=32))
        asm = ship.ChunkAssembler(2)
        with pytest.raises(ship.ShipError, match="CRC"):
            asm.add(0, frames[0][2]["data"], frames[0][2]["crc"])
    elif site == "srv.adopt":
        lm = TransformerLM(11, d_model=16, n_heads=2, n_layers=1,
                           max_len=32).init(0, "cpu")
        d = ServingDaemon(ServingEngine(lm, slots=1, segment=4,
                                        page_block=8, cache_bucket=16,
                                        device="cpu"))
        with plan.installed(), pytest.raises(ConnectionError):
            d._srv_adopt_pages({"xid": "x"})
    else:
        router = ServingRouter()
        router.membership.join("d0", {"role": "decode",
                                      "rpc_host": "127.0.0.1",
                                      "rpc_port": 1})
        with plan.installed(), pytest.raises(ConnectionError):
            router._place([1, 2], 2, eos_id=None, timeout_s=None,
                          tenant="default", slo="interactive",
                          prefix_len=None, submit_key=None)
    return plan


@pytest.mark.parametrize("site", ["rpc.send", "rpc.recv", "mbr.heartbeat",
                                  "srv.ship", "srv.adopt", "route.submit"])
def test_the_wire_plane_fires_its_sites(site):
    """Each site the wire plane added fires where JAX's does: a client's
    frame out (rpc.send) and reply in (rpc.recv), a membership heartbeat,
    a shipped chunk after its CRC (srv.ship, caught by the receiver's
    CRC), an adopt request (srv.adopt) and a router placement attempt
    (route.submit)."""
    plan = _fire_wire_site(site)
    assert plan.fired[0] == (site, 1, "corrupt" if site == "srv.ship"
                             else "raise")


def test_every_port_site_has_a_hook_in_the_port():
    """Each name of the port's SITES is fired by a hook in the port's
    code, and no hook there names a site outside SITES."""
    import re
    pkg = os.path.join(ROOT, "paddle_tpu_torch")
    hooked = set()
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                text = open(os.path.join(dirpath, name)).read()
                hooked |= set(re.findall(
                    r'faults\.(?:fire|filter_bytes|filter_value)\("([^"]+)"',
                    text))
    assert hooked == set(PF.SITES)


def test_corrupt_is_seed_deterministic_and_matches_jax():
    def run(F, seed):
        plan = F.FaultPlan(seed=seed)
        plan.add("ckpt.write", "corrupt", nth=1, count=3)
        with plan.installed():
            return [F.filter_bytes("ckpt.write", b"hello world")
                    for _ in range(3)]

    for seed in (0, 42):
        got = run(PF, seed)
        assert got == run(PF, seed) == run(JF, seed)
        assert all(g != b"hello world" for g in got)


@pytest.mark.parametrize("mods", BOTH)
def test_value_hooks_and_payload_actions(mods):
    F, _ = mods
    plan = F.FaultPlan()
    plan.add("step.grad", "corrupt", nth=1)
    plan.add("step.grad", "corrupt", nth=2, mutate=lambda v: v * 10)
    plan.add("reader.next", "truncate")
    plan.add("step.grad", "truncate", nth=3)
    with plan.installed():
        assert np.isnan(F.filter_value("step.grad", 1.0))
        assert F.filter_value("step.grad", 1.5) == 15.0
        with pytest.raises(F.FaultError, match="only supports"):
            F.fire("reader.next")
        with pytest.raises(F.FaultError, match="carries"):
            F.filter_value("step.grad", 1.0)
    assert plan.fired == [("step.grad", 1, "corrupt"),
                          ("step.grad", 2, "corrupt"),
                          ("reader.next", 1, "truncate"),
                          ("step.grad", 3, "truncate")]


@pytest.mark.parametrize("mods", BOTH)
def test_raise_and_delay_actions(mods):
    F, _ = mods
    sleep, _, t = _fake_time()
    plan = F.FaultPlan(sleep=sleep)
    plan.add("reader.next", "delay", nth=1, delay_s=2.5)
    plan.add("reader.next", "raise", nth=2, exc=OSError("torn"))
    plan.add("reader.next", "raise", nth=3, exc=KeyError)
    plan.add("reader.next", "raise", nth=4)
    with plan.installed():
        F.fire("reader.next")
        assert t[0] == 2.5
        with pytest.raises(OSError, match="torn"):
            F.fire("reader.next")
        with pytest.raises(KeyError):
            F.fire("reader.next")
        with pytest.raises(F.FaultError, match="injected fault"):
            F.fire("reader.next")
    plan.reset()
    assert plan.hits == {} and plan.fired == []


# -- RetryPolicy, both packages -----------------------------------------------

def _fail(exc):
    def fn():
        raise exc
    return fn


def _capped_schedule(R):
    sleep, clock, _ = _fake_time()
    slept = []
    pol = R.RetryPolicy(max_attempts=5, base_delay=0.1, multiplier=2.0,
                        max_delay=0.3, jitter=0.0,
                        sleep=lambda s: (slept.append(s), sleep(s)),
                        clock=clock)
    with pytest.raises(R.RetryBudgetExceeded) as ei:
        pol.call(_fail(OSError("down")), describe="probe")
    assert isinstance(ei.value, ConnectionError)
    assert "5 attempt" in str(ei.value)
    return ei.value.attempts, slept


def test_retry_exponential_capped_schedule_matches_jax():
    got, want = _capped_schedule(PR), _capped_schedule(JR)
    assert got == want
    assert got[0] == 5
    np.testing.assert_allclose(got[1], [0.1, 0.2, 0.3, 0.3])


def _deadline(R):
    sleep, clock, t = _fake_time()
    pol = R.RetryPolicy(max_attempts=None, base_delay=1.0, multiplier=1.0,
                        max_delay=1.0, deadline=3.5, jitter=0.0,
                        sleep=sleep, clock=clock)
    with pytest.raises(R.RetryBudgetExceeded) as ei:
        pol.call(_fail(ConnectionError("down")))
    return ei.value.attempts, t[0]


def test_retry_deadline_bounds_total_wait_as_jax():
    got = _deadline(PR)
    assert got == _deadline(JR)
    assert got[0] == 4 and got[1] <= 3.5
    with pytest.raises(ValueError, match="unbounded"):
        PR.RetryPolicy(max_attempts=None)


def _jitter(R, seed):
    _, clock, _ = _fake_time()
    slept, events = [], []
    pol = R.RetryPolicy(max_attempts=4, base_delay=0.1, jitter=0.5,
                        seed=seed, sleep=slept.append, clock=clock,
                        observer=lambda ev, **kw: events.append(
                            (ev, kw.get("attempt"), kw.get("attempts"))))
    with pytest.raises(R.RetryBudgetExceeded):
        pol.call(_fail(OSError()))
    return slept, events


def test_retry_jitter_is_seeded_and_matches_jax():
    assert _jitter(PR, 7) == _jitter(PR, 7) == _jitter(JR, 7)
    assert _jitter(PR, 7)[0] != _jitter(PR, 8)[0]
    assert _jitter(PR, 7)[1][-1] == ("giveup", None, 4)


@pytest.mark.parametrize("mods", BOTH)
def test_retry_nonretryable_propagates_and_success_returns(mods):
    _, R = mods
    sleep, clock, _ = _fake_time()
    events = []
    pol = R.RetryPolicy(max_attempts=5, jitter=0.0, sleep=sleep, clock=clock,
                        observer=lambda ev, **kw: events.append(ev))
    with pytest.raises(ValueError):
        pol.call(_fail(ValueError("logic bug")))
    calls = {"n": 0}
    retries = []

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert pol.call(flaky, on_retry=lambda a, e: retries.append(a)) == "ok"
    assert retries == [1, 2]
    assert events == ["attempt", "attempt", "success"]


# -- the checkpoint and trainer hooks, both packages --------------------------

D, BS, LR = 4, 8, 2.0 ** -4


def _batches(n=4, seed=0, poison=None):
    """Batches (x, y) with entries in {-1, 0, 1}; batch ``poison`` has an
    inf in y."""
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        x = rs.randint(-1, 2, (BS, D)).astype(np.float32)
        y = (rs.randint(-1, 2, (BS, 1)) + 2.0 ** -9).astype(np.float32)
        if i == poison:
            y[0, 0] = np.inf
        out.append((x, y))
    return out


def _init():
    # keys in sorted order: JAX's pytree walk sorts a dict's keys, the
    # port's keeps the caller's order, and the checkpoint files list them
    # in walk order
    return {"b": np.zeros(1, np.float32), "w": np.zeros((D, 1), np.float32)}


def _jloss(p, x, y):
    return jnp.mean(jnp.abs(x @ p["w"] + p["b"] - y))


def _ploss(p, x, y):
    return torch.mean(torch.abs(x @ p["w"] + p["b"] - y))


class Run:
    """One package's trainer over the regression: its costs, result,
    counters and checkpoint directory."""

    def __init__(self, pkg, out=None, **kw):
        self.pkg = pkg
        self.out = out
        self.costs = []
        if pkg == "jax":
            self.F = JF
            self.C = JC
            self.t = JTrainer(_jloss, JSGD(LR), output_dir=out, **kw)
        else:
            self.F = PF
            self.C = PC
            self.t = PTrainer(_ploss, PSGD(LR), output_dir=out,
                              device="cpu", **kw)

    def reader(self, batches):
        if self.pkg == "jax":
            return lambda: iter(batches)
        return lambda: iter([tuple(torch.from_numpy(a) for a in b)
                             for b in batches])

    def params(self):
        if self.pkg == "jax":
            return _init()
        return {k: torch.from_numpy(v) for k, v in _init().items()}

    def train(self, batches, **kw):
        def on_event(e):
            if type(e).__name__ == "EndIteration":
                self.costs.append(e.cost)
        p, _ = self.t.train(self.reader(batches), self.params(),
                            event_handler=on_event, handle_signals=False,
                            **kw)
        return {k: np.asarray(v) for k, v in p.items()}


def _files(out):
    """Every file under ``out`` (relative path -> bytes)."""
    got = {}
    for root, _, names in os.walk(out):
        for n in names:
            path = os.path.join(root, n)
            with open(path, "rb") as f:
                got[os.path.relpath(path, out)] = f.read()
    return got


def _same_params(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _float64_run(passes=3):
    """The regression's SGD in float64 with numpy: (params, costs)."""
    w, b, costs = np.zeros((D, 1)), np.zeros(1), []
    for _ in range(passes):
        for x, y in _batches():
            r = x.astype(np.float64) @ w + b - y
            costs.append(float(np.mean(np.abs(r))))
            g = np.sign(r)
            w, b = w - LR * (x.T @ g) / BS, b - LR * g.mean(0)
    return {"w": w, "b": b}, costs


def test_the_regression_is_exact_in_both_packages(tmp_path):
    """The ground the trainer cases stand on: three passes of the
    regression give the float64 run's costs and parameters in both
    packages, and the same checkpoint files."""
    runs = {pkg: Run(pkg, str(tmp_path / pkg)) for pkg in ("jax", "port")}
    res = {pkg: r.train(_batches(), num_passes=3) for pkg, r in runs.items()}
    want_p, want_c = _float64_run()
    for pkg in runs:
        _same_params({k: v.astype(np.float64) for k, v in res[pkg].items()},
                     want_p)
        assert runs[pkg].costs == want_c
    assert _files(str(tmp_path / "jax")) == _files(str(tmp_path / "port"))


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_crash_mid_write_keeps_the_previous_pass(tmp_path, pkg):
    """A write that raises in pass 1's first member: the trainer fails,
    pass 0 stays the newest, the torn ``.tmp`` is ignored, and a resume
    finishes equal to the run without the crash (both packages, and the
    two packages equal)."""
    out = str(tmp_path / "ckpt")
    r = Run(pkg, out)
    plan = r.F.FaultPlan()
    per_pass = 3                    # params.tar, opt_state.tar, state.json
    plan.add("ckpt.write", "raise", nth=per_pass + 1,
             exc=OSError("torn write"))
    with plan.installed():
        with pytest.raises(OSError, match="torn write"):
            r.train(_batches(), num_passes=3)
    assert plan.fired == [("ckpt.write", per_pass + 1, "raise")]
    assert r.C.latest_pass(out) == 0
    assert os.path.exists(r.C.pass_dir(out, 1) + ".tmp")
    assert not os.path.exists(r.C.pass_dir(out, 1))
    resumed = Run(pkg, out).train(_batches(), num_passes=2, resume=True)
    clean = Run(pkg, str(tmp_path / "clean")).train(_batches(), num_passes=3)
    _same_params(resumed, clean)
    assert r.C.latest_pass(out, verify=True) == 2
    assert not os.path.exists(r.C.pass_dir(out, 1) + ".tmp")


def _truncated_last_pass(tmp_path, pkg):
    out = str(tmp_path / pkg)
    r = Run(pkg, out)
    plan = r.F.FaultPlan()
    plan.add("ckpt.write", "truncate", nth=2 * 3 + 1, truncate_to=32)
    with plan.installed():
        r.train(_batches(), num_passes=3)
    return r, out, plan


def test_truncated_member_fails_verification_and_falls_back(tmp_path):
    """The last pass's ``params.tar`` torn by the hook: its manifest is
    published, verification refuses it, the load falls back to pass 1,
    and the files are the same bytes in both packages."""
    got = {}
    for pkg in ("jax", "port"):
        r, out, plan = _truncated_last_pass(tmp_path, pkg)
        assert plan.fired == [("ckpt.write", 7, "truncate")]
        assert r.C.latest_pass(out) == 2
        assert not r.C.verify_checkpoint(r.C.pass_dir(out, 2))
        assert r.C.latest_pass(out, verify=True) == 1
        _, _, st = (r.C.load_checkpoint(out) if pkg == "jax"
                    else r.C.load_checkpoint(out, device="cpu"))
        assert st["pass_id"] == 1
        with pytest.raises(ValueError, match="verification"):
            if pkg == "jax":
                r.C.load_checkpoint(out, 2)
            else:
                r.C.load_checkpoint(out, 2, device="cpu")
        got[pkg] = _files(out)
    assert got["jax"] == got["port"]
    assert len(got["port"]["pass-00002/params.tar"]) == 32


def test_resume_after_a_truncated_last_pass_retrains_it(tmp_path):
    """``resume=True`` after the torn last pass starts from pass 1 and the
    retrained pass 2 equals the run with no fault, in both packages."""
    clean = Run("port", str(tmp_path / "clean")).train(_batches(),
                                                       num_passes=3)
    for pkg in ("jax", "port"):
        _, out, _ = _truncated_last_pass(tmp_path, pkg)
        r = Run(pkg, out)
        p = r.train(_batches(), num_passes=1, resume=True)
        _same_params(p, clean)
        assert r.C.verify_checkpoint(r.C.pass_dir(out, 2))
        assert len(r.costs) == len(_batches())


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_only_corrupt_checkpoints_start_fresh(tmp_path, pkg):
    out = str(tmp_path / "ckpt")
    r = Run(pkg, out)
    plan = r.F.FaultPlan()
    plan.add("ckpt.write", "truncate", nth=1, count=3, truncate_to=16)
    with plan.installed():
        r.train(_batches(n=2), num_passes=1)       # every member torn
    assert r.C.latest_pass(out) == 0
    assert r.C.latest_pass(out, verify=True) is None
    fresh = Run(pkg, out)
    p = fresh.train(_batches(n=2), num_passes=1, resume=True)
    _same_params(p, Run(pkg).train(_batches(n=2), num_passes=1))
    assert len(fresh.costs) == 2


def _step_grad(pkg, tmp_path, policy, nth=3):
    out = str(tmp_path / f"{pkg}-{policy}")
    r = Run(pkg, out, on_nonfinite=policy)
    plan = r.F.FaultPlan()
    plan.add("step.grad", "corrupt", nth=nth)
    err = None
    with plan.installed():
        try:
            p = r.train(_batches(), num_passes=2)
        except FloatingPointError as e:
            p, err = None, str(e)
    stats = dict(r.t.train_stats, steps=r.t._c_steps.get(),
                 examples=r.t._c_examples.get())
    return {"params": p, "costs": r.costs, "err": err,
            "stats": stats, "fired": plan.fired,
            "files": _files(out) if os.path.isdir(out) else {}}


@pytest.mark.parametrize("policy", ["raise", "skip", "halt"])
def test_step_grad_policies_match_jax(tmp_path, policy):
    """``step.grad`` corrupts the host's copy of batch 3's cost (the third
    step): ``raise`` stops there, ``halt`` checkpoints the state after
    that step's update (the graph's guard saw a finite loss) and raises,
    ``skip`` counts a skip whose update was applied — both packages alike,
    with the same counters, parameters and files."""
    got = _step_grad("port", tmp_path, policy)
    want = _step_grad("jax", tmp_path, policy)
    assert got["fired"] == want["fired"] == [("step.grad", 3, "corrupt")]
    assert got["stats"] == want["stats"]
    assert got["files"] == want["files"]
    np.testing.assert_array_equal(got["costs"], want["costs"])
    if policy == "skip":
        assert np.isnan(got["costs"][2]) and len(got["costs"]) == 8
        assert got["err"] is None and want["err"] is None
        _same_params(got["params"], want["params"])
        assert got["stats"]["skipped_batches"] == 1
        # the update of the corrupted step was applied: the result is the
        # clean run's
        clean = Run("port").train(_batches(), num_passes=2)
        _same_params(got["params"], clean)
    else:
        assert "non-finite loss nan at pass 0 batch 2" in got["err"]
        assert "non-finite loss nan at pass 0 batch 2" in want["err"]
        assert len(got["costs"]) == 2 and got["stats"]["steps"] == 3
    if policy == "halt":
        st = got["files"]["pass-00000/state.json"]
        assert b'"halted": true' in st and b'"batch_id": 2' in st
    elif policy == "raise":
        assert got["files"] == {}
    else:
        assert {f.split("/")[0] for f in got["files"]} == {"pass-00000",
                                                           "pass-00001"}


def test_step_grad_raise_without_output_dir_matches_jax():
    for pkg in ("jax", "port"):
        r = Run(pkg)
        plan = r.F.FaultPlan()
        plan.add("step.grad", "corrupt", nth=1)
        with plan.installed():
            with pytest.raises(FloatingPointError, match="non-finite"):
                r.train(_batches(n=2), num_passes=1)
        assert r.costs == []
