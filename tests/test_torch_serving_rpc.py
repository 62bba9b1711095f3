"""The port's RPC plane on the CPU: ``runtime/master_service.py``
(``MasterServer`` over the port's build of the native server, the
reconnecting clients), ``runtime/membership.py`` (join, heartbeat, TTL
eviction, token fencing) and ``serving/daemon.py`` (``ServingDaemon``'s
srv_* ops with their structured refusals), each against the JAX
package's on the same calls.

The frames are JAX's, so the clients and servers of the two packages
talk to each other: a port ``ServingClient`` drives a JAX
``ServingDaemon`` and a JAX client drives the port's, with tokens equal
to the solo greedy decode of both packages on the test model (the
port's attention runs its plain versions here). Every network wait has
a deadline of its own (``call_timeout=``, bounded poll loops).
"""

import time

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.runtime.master_service import MasterClient as JMasterClient
from paddle_tpu.runtime.master_service import MasterServer as JMasterServer
from paddle_tpu.serving import ServingClient as JServingClient
from paddle_tpu.serving import ServingDaemon as JServingDaemon
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import TransformerLM
from paddle_tpu_torch.runtime import (HeartbeatKeeper, MasterClient,
                                      MasterServer, MembershipClient,
                                      MembershipService, StaleMemberError)
from paddle_tpu_torch.serving import (Overloaded, ServingClient,
                                      ServingDaemon, ServingEngine)

VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
POOL = dict(segment=8, page_block=8, cache_bucket=32)
WAIT = dict(call_timeout=20.0)


@pytest.fixture(scope="module")
def models(paged_model_and_params):
    jmodel, jparams = paged_model_and_params
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    port = params_from_numpy(tree, TransformerLM(
        VOCAB, d_model=D, n_heads=H, n_layers=L, max_len=MAX_LEN), "cpu")
    return jmodel, jparams, port


def _solo(port, prompt, n):
    return port.generate_fused(torch.as_tensor(np.asarray(prompt)[None]), n,
                               route="plain")[0, len(prompt):].numpy()


def _drain(client, rid, timeout=60.0):
    deadline = time.monotonic() + timeout
    cursor, toks = 0, []
    while True:
        got, done, reason = client.poll(rid, cursor)
        toks.extend(got)
        cursor += len(got)
        if done:
            return np.asarray(toks, np.int32), reason
        assert time.monotonic() < deadline, "poll drain timed out"
        time.sleep(0.01)


def test_master_server_task_ops_cross_the_packages():
    """The native task-queue ops and the Python fallback ops through the
    port's server answer a JAX client and the port's client alike; the
    port's client drives a JAX server."""
    srv = MasterServer().start()
    jsrv = JMasterServer().start()
    clients = [JMasterClient(*srv.address, **WAIT),
               MasterClient(*srv.address, **WAIT),
               MasterClient(*jsrv.address, **WAIT)]
    try:
        for c in clients:
            c.set_dataset(["a", "b"])
            got = [c.get_task(), c.get_task()]
            assert sorted(p for _, p in got) == ["a", "b"]
            for tid, _ in got:
                c.task_finished(tid)
            assert c.get_task() is None
            todo, pending, done, _, _ = c.stats()
            assert (todo, pending, done) == (0, 0, 2)
            assert c.new_pass()
            accepted = c.obs_push("w0", [{"type": "gauge", "name": "g",
                                          "labels": {}, "value": 2.0}])
            assert accepted == 1
            workers, samples = c.obs_stats()
            assert workers == ["w0"]
            assert samples[0]["labels"] == {"worker": "w0"}
        unknown = clients[1]._call({"op": "no_such_op"})
        assert not unknown["ok"] and "unknown op" in unknown["error"]
        with pytest.raises(ValueError, match="already registered"):
            srv.register_op("stats", lambda req: {})
    finally:
        for c in clients:
            c.close()
        srv.stop()
        jsrv.stop()


def test_membership_join_heartbeat_eviction_against_jax():
    """The service's table on a fake clock (joins, heartbeats, a TTL
    eviction, a replaced incarnation) moves through the same epochs and
    refusals as JAX's; over the wire a stale token is a StaleMemberError
    at once, and the keeper heartbeats a member alive."""
    from paddle_tpu.runtime.membership import MembershipService as JService
    now = [0.0]
    events = []
    svcs = [MembershipService(ttl=1.0, clock=lambda: now[0]),
            JService(ttl=1.0, clock=lambda: now[0])]
    svcs[0].subscribe(lambda view, **kw: events.append(kw["reason"]))
    trace = [[] for _ in svcs]
    for i, svc in enumerate(svcs):
        now[0] = 0.0
        ta, _ = svc.join("a", {"role": "decode"})
        tb, _ = svc.join("b")
        now[0] = 0.6
        assert svc.heartbeat("a", ta) is None
        trace[i].append(svc.heartbeat("b", ta + 100)["code"])
        now[0] = 1.2
        trace[i].append(svc.expire())            # b missed its window
        trace[i].append(svc.heartbeat("b", tb)["code"])
        ta2, _ = svc.join("a")                   # a new incarnation
        trace[i].append(svc.heartbeat("a", ta)["code"])
        assert svc.leave("a", ta2) is None
        trace[i].append(svc.view())
    assert trace[0] == trace[1]
    assert events == ["join", "join", "evicted", "join", "leave"]

    srv = MasterServer()
    svc = MembershipService(ttl=0.6).attach(srv)
    srv.start()
    svc.start()
    client = MembershipClient(*srv.address, **WAIT)
    try:
        token, epoch, reply = client.join("w0", {"role": "prefill"})
        assert reply["ttl"] == 0.6 and reply["view"]["members"][0][
            "caps"] == {"role": "prefill"}
        with pytest.raises(StaleMemberError) as ei:
            client.heartbeat("w0", token + 1)
        assert ei.value.code == "stale_member" and ei.value.attempts == 1
        keeper = HeartbeatKeeper(client, "w0", token, ttl=0.6,
                                 epoch=epoch).start()
        time.sleep(1.5)                          # > 2 TTLs: kept alive
        assert [m["worker"] for m in svc.members()] == ["w0"]
        keeper.stop()
        deadline = time.monotonic() + 10.0
        while svc.members():                     # no beats: evicted
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        client.close()
        svc.stop()
        srv.stop()


@pytest.fixture()
def daemon(models):
    _, _, port = models
    eng = ServingEngine(port, slots=2, queue_cap=3, device="cpu", **POOL)
    d = ServingDaemon(eng).start()
    try:
        yield d
    finally:
        d.stop()


def test_daemon_submit_poll_cancel_and_structured_refusals(daemon, models):
    """srv_submit/srv_poll stream the solo tokens; a flood past the queue
    cap is refused with code overloaded and a retry hint on a connection
    that keeps working; malformed requests are invalid_argument, an
    unknown rid not_found; a replayed submit_key returns its original rid;
    cancel frees every page."""
    _, _, port = models
    c = ServingClient(*daemon.address, **WAIT)
    rs = np.random.RandomState(5)
    prompt = rs.randint(0, VOCAB, 9)
    np.testing.assert_array_equal(c.generate(prompt, 20),
                                  _solo(port, prompt, 20))
    rids, refused = [], 0
    for _ in range(12):
        try:
            rids.append(c.submit(rs.randint(0, VOCAB, 5), 80))
        except Overloaded as e:
            refused += 1
            assert e.retry_after_s > 0
    assert refused > 0 and rids
    st = c.serving_stats()
    assert st["role"] == "decode" and st["rpc_conns"] >= 1
    for rid in rids:
        c.cancel(rid)
    late = c.submit_with_backoff(rs.randint(0, VOCAB, 5), 3)
    assert _drain(c, late)[0].size == 3
    deadline = time.monotonic() + 20.0
    while c.serving_stats()["pages_used"] != 0:
        assert time.monotonic() < deadline
        time.sleep(0.02)
    raw = MasterClient(*daemon.address, **WAIT)
    try:
        bad = raw._call({"op": "srv_submit", "prompt": [], "max_new": 4})
        assert not bad["ok"] and bad["code"] == "invalid_argument"
        bad = raw._call({"op": "srv_submit", "prompt": [VOCAB + 5],
                         "max_new": 4})
        assert not bad["ok"] and bad["code"] == "invalid_argument"
        gone = raw._call({"op": "srv_poll", "rid": 10 ** 6})
        assert not gone["ok"] and gone["code"] == "not_found"
        req = {"op": "srv_submit", "prompt": [1, 2, 3], "max_new": 2,
               "submit_key": "k1"}
        first = raw._call(req)
        assert raw._call(req) == first
        assert raw._call({"op": "srv_requests"}) == {"ok": True,
                                                     "requests": []}
    finally:
        raw.close()
        c.close()


def test_clients_and_daemons_cross_the_packages(models):
    """A port ServingClient drives a JAX ServingDaemon, and a JAX client
    the port's: both streams equal the solo decode of either package."""
    jmodel, jparams, port = models
    rs = np.random.RandomState(8)
    prompt = rs.randint(0, VOCAB, 11)
    want = _solo(port, prompt, 16)
    jwant = np.asarray(jmodel.generate_cached(
        jparams, jax.numpy.asarray(prompt[None]), steps=16))[0, 11:]
    np.testing.assert_array_equal(want, jwant)
    jd = JServingDaemon(JServingEngine(jmodel, jparams, slots=2,
                                       **POOL)).start()
    pd = ServingDaemon(ServingEngine(port, slots=2, device="cpu",
                                     **POOL)).start()
    pc = ServingClient(*jd.address, **WAIT)
    jc = JServingClient(*pd.address, **WAIT)
    try:
        np.testing.assert_array_equal(pc.generate(prompt, 16), want)
        np.testing.assert_array_equal(jc.generate(prompt, 16), want)
        assert jc.serving_stats()["pages_total"] > 0
    finally:
        pc.close()
        jc.close()
        jd.stop()
        pd.stop()


def test_drain_stop_refuses_new_work_and_finishes_streams(models):
    """stop(drain_s=) refuses new submissions with overloaded while the
    in-flight stream finishes and is collected."""
    _, _, port = models
    d = ServingDaemon(ServingEngine(port, slots=2, device="cpu",
                                    **POOL)).start()
    c = ServingClient(*d.address, **WAIT)
    prompt = np.arange(1, 8)
    rid = c.submit(prompt, 24, submit_key="keep")
    import threading
    t = threading.Thread(target=d.stop, kwargs={"drain_s": 20.0})
    t.start()
    deadline = time.monotonic() + 10.0
    while not d._draining.is_set():
        assert time.monotonic() < deadline
        time.sleep(0.005)
    with pytest.raises(Overloaded, match="draining"):
        c.submit(prompt, 4)
    # a replay of the admitted submit still learns its rid while draining
    assert c.submit(prompt, 24, submit_key="keep") == rid
    got, reason = _drain(c, rid)
    np.testing.assert_array_equal(got, _solo(port, prompt, 24))
    c.close()
    t.join(timeout=30.0)
    assert not t.is_alive()
