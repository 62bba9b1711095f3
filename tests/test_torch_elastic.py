"""The port's elastic cluster runtime (paddle_tpu_torch/trainer/elastic.py
over the port's membership and master planes) — the non-CLI cases of
tests/test_elastic.py, on the CPU.

The workload is tests/torch_elastic_net.py (the torch copy of
tests/elastic_testnet.py), its weights carried from JAX's ``params0``.
Held:

* the port's elastic fit is bit for bit the port's sequential reference:
  each step's fixed shards' gradients (``elastic.loss_and_grads``),
  reduced in shard order on the host (``elastic.reduce_shards``, JAX's
  ops), then one Adam ``update`` — whatever the fleet, kill -9s, rolling
  restarts and master restarts;
* it equals JAX's elastic fit of the same batches to 2e-5 (absolute and
  relative: f32 on both sides, each shard's gradient summed by XLA's and
  torch's CPU kernels in their own orders, then 12 Adam steps);
* the membership, fencing and wire behaviour is JAX's (the op names,
  the structured refusals, the counters).

Thread workers and subprocess workers (tests/torch_elastic_worker.py,
torch only) run over the real TCP RPC plane; each test takes one CPU
thread (bit-equality across runs).
"""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from elastic_testnet import build as jbuild
from paddle_tpu.trainer.elastic import ElasticMaster as JMaster
from paddle_tpu.trainer.elastic import ElasticWorker as JWorker
from paddle_tpu_torch import obs
from paddle_tpu_torch.convert import tree_from_numpy
from paddle_tpu_torch.core.pytree import tree_items
from paddle_tpu_torch.faults import FaultPlan
from paddle_tpu_torch.runtime.master_service import (MasterClient,
                                                     MasterServer,
                                                     StaleMemberError)
from paddle_tpu_torch.runtime.membership import (MembershipService,
                                                 autoscale_recommendation)
from paddle_tpu_torch.trainer.elastic import (ElasticMaster, ElasticWorker,
                                              _pack_arrays, _on_device,
                                              loss_and_grads, reduce_shards)
from torch_elastic_net import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_SCRIPT = os.path.join(REPO, "tests", "torch_elastic_worker.py")
#: the port's fit against JAX's (module docstring)
JAX_TOL = 2e-5

LOSS_FN, MK_OPT, BATCHES = build(steps=6)
_JLOSS, _JPARAMS0, _JMK_OPT, _ = jbuild(steps=6)
PARAMS0_NP = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in _JPARAMS0().items()}


def PARAMS0():
    return tree_from_numpy(PARAMS0_NP, "cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(params):
    return {"/".join(p): (v.detach().cpu().numpy()
                          if isinstance(v, torch.Tensor) else np.asarray(v))
            for p, v in tree_items(params)}


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _assert_trees_close(a, b, tol):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_allclose(fa[k], fb[k], rtol=tol, atol=tol,
                                   err_msg=k)


def _thread_worker(host, port, name, stop):
    # a loss of its own: functional_call swaps the module's parameters
    # for the call, so threads must not share one module
    w = ElasticWorker(build()[0], (host, port), worker=name, device="cpu")
    t = threading.Thread(target=w.run, kwargs={"stop": stop}, daemon=True)
    t.start()
    return w, t


def _run_static_elastic(n_workers, batches, num_passes=1, shards=4):
    em = ElasticMaster(LOSS_FN, MK_OPT(), ttl=5.0, task_timeout_s=10.0,
                       shards_per_step=shards, min_workers=n_workers,
                       device="cpu").start()
    host, port = em.address
    stop = threading.Event()
    pairs = [_thread_worker(host, port, f"static{i}", stop)
             for i in range(n_workers)]
    try:
        params, _, loss = em.fit(batches, PARAMS0(), num_passes=num_passes,
                                 progress_timeout=60.0)
    finally:
        stop.set()
        for _, t in pairs:
            t.join(timeout=10)
        em.stop()
    return params, loss


def _sequential_reference(batches, num_passes=1, shards=4):
    """The port's sequential reference: the fixed shards' gradients,
    reduced in shard order, one Adam ``update`` a step."""
    opt = MK_OPT()
    params = PARAMS0()
    state = opt.init(params)
    loss = float("nan")
    for _ in range(num_passes):
        for batch in batches:
            n = batch[0].shape[0]
            base, rem = divmod(n, shards)
            bounds, lo = [], 0
            for j in range(shards):
                hi = lo + base + (1 if j < rem else 0)
                bounds.append((lo, hi))
                lo = hi
            outs = [loss_and_grads(LOSS_FN, params, *(
                torch.from_numpy(a[lo:hi]) for a in batch))
                for lo, hi in bounds]
            rows = [hi - lo for lo, hi in bounds]
            acc = _on_device(reduce_shards([g for _, g in outs], rows, n),
                             torch.device("cpu"))
            params, state = opt.update(acc, state, params)
            loss = float(sum(r / n * float(lv) for r, (lv, _)
                             in zip(rows, outs)))
    return params, loss


def _jax_elastic(batches, num_passes=1, n_workers=2):
    """JAX's elastic fit of the same batches (two JAX thread workers)."""
    import jax
    em = JMaster(_JLOSS, _JMK_OPT(), ttl=5.0, task_timeout_s=10.0,
                 shards_per_step=4, min_workers=n_workers).start()
    host, port = em.address
    stop = threading.Event()
    threads = []
    for i in range(n_workers):
        w = JWorker(_JLOSS, (host, port), worker=f"j{i}")
        t = threading.Thread(target=w.run, kwargs={"stop": stop},
                             daemon=True)
        t.start()
        threads.append(t)
    try:
        params, _, loss = em.fit(batches, _JPARAMS0(),
                                 num_passes=num_passes,
                                 progress_timeout=60.0)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
        em.stop()
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params)), loss


# -- membership service (in-process dispatch, fake clock) --------------------------

def test_membership_join_heartbeat_expire_epoch():
    srv = MasterServer()
    clock = [0.0]
    ms = MembershipService(ttl=10.0, clock=lambda: clock[0]).attach(srv)
    r = srv._dispatch({"op": "mbr_join", "worker": "a",
                       "caps": {"devices": 2}})
    assert r["ok"] and r["epoch"] == 1 and r["ttl"] == 10.0
    tok_a = r["member_token"]
    r2 = srv._dispatch({"op": "mbr_join", "worker": "b"})
    assert r2["epoch"] == 2
    view = srv._dispatch({"op": "mbr_view"})
    assert [m["worker"] for m in view["members"]] == ["a", "b"]
    assert view["epoch"] == 2 and view["recommendation"]["action"] in (
        "join", "leave", "hold")
    clock[0] = 8.0
    assert srv._dispatch({"op": "mbr_heartbeat", "worker": "a",
                          "member_token": tok_a})["ok"]
    clock[0] = 15.0
    assert ms.expire() == ["b"]
    assert ms.epoch == 3
    assert [m["worker"] for m in ms.members()] == ["a"]
    r3 = srv._dispatch({"op": "mbr_heartbeat", "worker": "b",
                        "member_token": r2["member_token"]})
    assert not r3["ok"] and r3["code"] == "unknown_member"
    assert r3["epoch"] == 3
    assert srv._dispatch({"op": "mbr_leave", "worker": "a",
                          "member_token": tok_a})["ok"]
    assert ms.epoch == 4 and ms.members() == []


def test_membership_rejoin_fences_old_incarnation():
    srv = MasterServer()
    ms = MembershipService(ttl=10.0).attach(srv)
    t1, e1 = ms.join("w")
    t2, e2 = ms.join("w")
    assert t2 > t1 and e2 == e1 + 1
    stale = srv._dispatch({"op": "mbr_heartbeat", "worker": "w",
                           "member_token": t1})
    assert not stale["ok"] and stale["code"] == "stale_member"
    assert srv._dispatch({"op": "mbr_heartbeat", "worker": "w",
                          "member_token": t2})["ok"]
    err = ms.fence(e1)
    assert err["code"] == "stale_epoch" and err["epoch"] == e2
    assert ms.fence(e2) is None and ms.fence(None) is None


def test_elastic_grad_submission_fencing():
    em = ElasticMaster(LOSS_FN, MK_OPT(), device="cpu")
    join = em.server._dispatch({"op": "mbr_join", "worker": "w"})
    tok, epoch = join["member_token"], join["epoch"]
    r = em.server._dispatch({"op": "ela_grad", "worker": "ghost",
                             "member_token": 1, "epoch": epoch})
    assert r["code"] == "unknown_member"
    r = em.server._dispatch({"op": "ela_grad", "worker": "w",
                             "member_token": tok + 5, "epoch": epoch})
    assert r["code"] == "stale_member"
    em.server._dispatch({"op": "mbr_join", "worker": "w2"})
    r = em.server._dispatch({"op": "ela_grad", "worker": "w",
                             "member_token": tok, "epoch": epoch})
    assert r["code"] == "stale_epoch" and r["epoch"] == epoch + 1
    r = em.server._dispatch({"op": "ela_grad", "worker": "w",
                             "member_token": tok, "epoch": epoch + 1,
                             "pass": 0, "step": 0, "shard": 0})
    assert r["code"] == "stale_step"
    em.server.master.set_dataset(["shard-payload"])
    tid, _ = em.server.master.get_task()
    assert em.server.master.stats()[:2] == (0, 1)
    r = em.server._dispatch({"op": "ela_grad", "worker": "w",
                             "member_token": tok, "epoch": epoch,
                             "task_id": tid, "pass": 0, "step": 0,
                             "shard": 0, "grad": ""})
    assert r["code"] == "stale_epoch"
    assert em.server.master.stats()[:2] == (1, 0)


def test_worker_computes_uneven_shards_as_jax():
    """A ragged tail shard (7 rows) and an even one (8 rows): the worker's
    shard computation equals JAX's worker's on the same wire payload. The
    port refuses JAX's ``mesh=``/``layout=`` (each worker its own local
    mesh), naming the reason."""
    import jax
    w = ElasticWorker(LOSS_FN, ("127.0.0.1", 1), device="cpu")
    w._params = PARAMS0()
    jw = JWorker(_JLOSS, ("127.0.0.1", 1))
    jw._params = jax.device_put(_JPARAMS0())
    rs = np.random.RandomState(0)
    for rows in (7, 8):
        x = rs.randn(rows, 8).astype(np.float32)
        y = rs.randint(0, 2, rows).astype(np.int32)
        payload = {"batch": _pack_arrays([x, y])}
        loss, grads = w._grad_of(payload)
        jloss, jgrads = jw._grad_of(payload)
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, jloss, rtol=JAX_TOL, atol=JAX_TOL)
        _assert_trees_close(grads, jax.tree_util.tree_map(np.asarray,
                                                          jgrads), JAX_TOL)
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        ElasticWorker(LOSS_FN, ("127.0.0.1", 1), mesh=object(),
                      device="cpu")
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        ElasticMaster(LOSS_FN, MK_OPT(), layout=object(), device="cpu")


def test_autoscale_recommendation_branches():
    r = autoscale_recommendation(members=0, todo=3, pending=0)
    assert r["action"] == "join"
    r = autoscale_recommendation(members=2, todo=9, pending=1)
    assert r["action"] == "join" and r["backlog_per_worker"] == 5.0
    r = autoscale_recommendation(
        members=3, todo=0, pending=0,
        samples=[{"name": "goodput.ratio", "value": 0.1,
                  "labels": {"worker": "a"}}])
    assert r["action"] == "leave" and r["goodput_ratio"] == 0.1
    r = autoscale_recommendation(
        members=2, todo=0, pending=0,
        samples=[{"name": "data.giveups_total", "value": 4.0}])
    assert r["action"] == "leave" and "starvation" in r["reason"]
    r = autoscale_recommendation(members=2, todo=2, pending=0)
    assert r["action"] == "hold"
    r = autoscale_recommendation(
        members=1, todo=0, pending=0,
        samples=[{"name": "goodput.ratio", "value": 0.05}])
    assert r["action"] == "hold"


# -- MasterClient._call reconnect hardening -----------------------------------------

def test_client_fails_fast_on_structured_fence():
    srv = MasterServer()
    calls = []

    def fenced(req):
        calls.append(1)
        return {"ok": False, "code": "stale_epoch",
                "error": "request epoch 1 != current 7", "epoch": 7}

    srv.register_op("ela_fence", fenced)
    srv.start()
    try:
        c = MasterClient(*srv.address)
        with pytest.raises(StaleMemberError) as ei:
            c._call({"op": "ela_fence"})
        assert ei.value.code == "stale_epoch" and ei.value.epoch == 7
        assert len(calls) == 1
        assert c.last_epoch == 7
        c._call({"op": "stats"})
        assert c.last_epoch == 7
        c.close()
    finally:
        srv.stop()


def test_client_retries_refused_and_reports_attempts_and_epoch():
    srv = MasterServer()
    MembershipService(ttl=10.0).attach(srv)
    srv.start()
    host, port = srv.address
    c = MasterClient(host, port, retries=3, retry_delay=0.01)
    r = c._call({"op": "mbr_join", "worker": "probe"})
    assert r["ok"] and c.last_epoch == 1
    srv.stop()
    t0 = time.monotonic()
    with pytest.raises(ConnectionError) as ei:
        c._call({"op": "mbr_view"})
    msg = str(ei.value)
    assert "3 attempt(s)" in msg
    assert "last seen membership epoch 1" in msg
    assert time.monotonic() - t0 < 10.0
    c.close()


# -- elastic training: equivalence and chaos ----------------------------------------

def test_elastic_two_workers_matches_sequential():
    """Two RPC workers: the port's fit is bit for bit the port's
    sequential shard-ordered reference, and JAX's elastic fit of the same
    batches to JAX_TOL."""
    params, loss = _run_static_elastic(2, BATCHES, num_passes=2)
    ref_params, ref_loss = _sequential_reference(BATCHES, num_passes=2)
    _assert_trees_equal(params, ref_params)
    assert loss == ref_loss
    jparams, jloss = _jax_elastic(BATCHES, num_passes=2)
    _assert_trees_close(params, jparams, JAX_TOL)
    assert abs(loss - jloss) < 1e-4


@pytest.mark.chaos
def test_kill9_worker_mid_pass_matches_static_run():
    """3 subprocess workers, one SIGKILLed while it holds a shard of a step
    past the first: eviction bumps the epoch, its shard re-buckets onto
    the survivors (the dispatch timeout is too long to help), the pass
    completes, and the parameters are the static 2-worker run's and the
    sequential reference's, bit for bit."""
    batches = build(steps=8)[2]
    reg = obs.MetricsRegistry()
    with obs.ObsSession(registry=reg).installed():
        em = ElasticMaster(LOSS_FN, MK_OPT(), ttl=1.2, task_timeout_s=60.0,
                           shards_per_step=4, min_workers=3,
                           device="cpu").start()
        host, port = em.address
        env = dict(os.environ, PYTHONPATH=REPO)
        procs = [subprocess.Popen(
            [sys.executable, WORKER_SCRIPT, host, str(port), f"kw{i}",
             "180"], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT) for i in range(3)]
        state = {"killed": False, "epoch_at_kill": None}

        def killer():
            deadline = time.monotonic() + 90.0
            while time.monotonic() < deadline:
                with em._mu:
                    holding = "kw0" in em._assigned.values()
                    step = em._step
                if step >= 1 and holding:
                    state["epoch_at_kill"] = em.membership.epoch
                    os.kill(procs[0].pid, signal.SIGKILL)
                    state["killed"] = True
                    return
                time.sleep(0.001)

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        try:
            params, _, loss = em.fit(batches, PARAMS0(), num_passes=1,
                                     progress_timeout=120.0)
            kt.join(timeout=10)
            survivors_at_finish = len(em.membership.members())
        finally:
            logs = []
            for p in procs[1:]:
                try:
                    out, _ = p.communicate(timeout=60)
                    logs.append(out.decode(errors="replace"))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
                    logs.append("survivor hung")
            if procs[0].poll() is None:
                procs[0].kill()
            procs[0].wait()
            em.stop()
        assert state["killed"], logs
        assert em.membership.epoch > state["epoch_at_kill"], logs
        assert survivors_at_finish == 2
        assert reg.counter("cluster.leaves_total").get(
            reason="evicted") >= 1
        assert reg.counter("cluster.rebucket_tasks_total").get() >= 1
        assert all(p.returncode == 0 for p in procs[1:]), logs
    static_params, static_loss = _run_static_elastic(2, batches)
    _assert_trees_equal(params, static_params)
    assert loss == static_loss
    ref_params, _ = _sequential_reference(batches)
    _assert_trees_equal(params, ref_params)


@pytest.mark.chaos
def test_rolling_restart_completes_pass_byte_stably():
    batches = build(steps=6)[2]
    reg = obs.MetricsRegistry()
    with obs.ObsSession(registry=reg).installed():
        em = ElasticMaster(LOSS_FN, MK_OPT(), ttl=5.0, task_timeout_s=10.0,
                           shards_per_step=4, min_workers=3,
                           device="cpu").start()
        host, port = em.address
        fleet = {}
        for i in range(3):
            stop = threading.Event()
            w, t = _thread_worker(host, port, f"rw{i}", stop)
            fleet[f"rw{i}"] = (w, t, stop)

        def cycle(name):
            w, t, stop = fleet[name]
            stop.set()
            t.join(timeout=10)
            assert not t.is_alive()
            stop2 = threading.Event()
            w2, t2 = _thread_worker(host, port, name, stop2)
            fleet[name] = (w2, t2, stop2)

        def on_step(pass_id, step, loss):
            if step in (1, 2, 3):
                cycle(f"rw{step - 1}")

        em.on_step = on_step
        try:
            params, _, loss = em.fit(batches, PARAMS0(), num_passes=1,
                                     progress_timeout=60.0)
        finally:
            for _, t, stop in fleet.values():
                stop.set()
            for _, t, stop in fleet.values():
                t.join(timeout=10)
            em.stop()
        assert em.membership.epoch >= 9
        assert reg.counter("cluster.leaves_total").get(
            reason="graceful") >= 3
        assert reg.counter("cluster.joins_total").get() >= 6
        assert reg.counter("cluster.resyncs_total").get() >= 3
    static_params, static_loss = _run_static_elastic(3, batches)
    _assert_trees_equal(params, static_params)
    assert loss == static_loss


@pytest.mark.chaos
def test_heartbeat_fault_evicts_and_worker_rejoins():
    batches = build(steps=10)[2]
    reg = obs.MetricsRegistry()
    plan = FaultPlan(seed=3).add("mbr.heartbeat", "raise", nth=2, count=4)
    with obs.ObsSession(registry=reg).installed(), plan.installed():
        em = ElasticMaster(LOSS_FN, MK_OPT(), ttl=0.75,
                           task_timeout_s=30.0, shards_per_step=2,
                           min_workers=1, device="cpu").start()
        host, port = em.address
        stop = threading.Event()
        w, t = _thread_worker(host, port, "hbw", stop)
        em.on_step = lambda p, s, l: time.sleep(0.2)
        try:
            params, _, loss = em.fit(batches, PARAMS0(), num_passes=1,
                                     progress_timeout=60.0)
        finally:
            stop.set()
            t.join(timeout=15)
            em.stop()
    assert plan.fired and plan.fired[0][0] == "mbr.heartbeat"
    assert reg.counter("faults.injected_total").get(
        site="mbr.heartbeat", action="raise") >= 1
    assert reg.counter("cluster.leaves_total").get(reason="evicted") >= 1
    assert reg.counter("cluster.joins_total").get() >= 2
    assert em.membership.epoch >= 3
    assert np.isfinite(loss)
    # the shards' wall times fed the health plane
    assert reg.histogram("cluster.shard_seconds").samples()


@pytest.mark.chaos
def test_master_restart_snapshot_restore_resumes_pass(tmp_path):
    """The master dies mid-pass and restarts on the same port from its
    snapshot (the port's checkpoint files): the same pass resumes at the
    snapshotted step, and the result is the uninterrupted run's and the
    sequential reference's, bit for bit."""
    batches = build(steps=6)[2]
    snap = str(tmp_path / "elastic_snap")
    em1 = ElasticMaster(LOSS_FN, MK_OPT(), ttl=5.0, task_timeout_s=10.0,
                        shards_per_step=4, min_workers=2, snapshot_dir=snap,
                        device="cpu").start()
    host, port = em1.address
    stop = threading.Event()
    pairs = [_thread_worker(host, port, f"mrw{i}", stop) for i in range(2)]
    try:
        em1.fit(batches, PARAMS0(), num_passes=1, max_steps=2,
                progress_timeout=60.0)
        epoch1 = em1.membership.epoch
        em1.stop()
        em2 = ElasticMaster(LOSS_FN, MK_OPT(), host=host, port=port,
                            ttl=5.0, task_timeout_s=10.0, shards_per_step=4,
                            min_workers=2, snapshot_dir=snap,
                            device="cpu").start()
        assert (em2._pass, em2._step) == (0, 2)
        assert em2.membership.epoch >= epoch1
        params, _, loss = em2.fit(batches, num_passes=1,
                                  progress_timeout=90.0)
        em2.stop()
    finally:
        stop.set()
        for _, t in pairs:
            t.join(timeout=15)
    ref_params, ref_loss = _run_static_elastic(2, batches)
    _assert_trees_equal(params, ref_params)
    assert loss == ref_loss
    seq_params, _ = _sequential_reference(batches)
    _assert_trees_equal(params, seq_params)
