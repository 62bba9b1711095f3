"""The port's serving router (``serving/router.py``) over its daemons on
the CPU: disaggregated placement (a prefill worker ships KV pages to the
decode worker it is told), backpressure aggregated into one structured
refusal, re-routing off a worker that left with no drain, the
idempotency ladder (the router's replay cache and the workers'), and the
router's fault sites — always held to the bar that the client's tokens
equal the solo plain decode (and JAX's, on the same weights), with none
lost or duplicated.

Each fleet runs in this process; every network wait has a deadline.
"""

import contextlib
import time

import jax
import numpy as np
import pytest
import torch

from paddle_tpu_torch import faults
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import TransformerLM
from paddle_tpu_torch.runtime import MasterClient
from paddle_tpu_torch.serving import (Overloaded, PagePool, PrefillDaemon,
                                      RouterClient, ServingDaemon,
                                      ServingEngine, ServingRouter)

VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
WAIT = dict(call_timeout=30.0)


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


@contextlib.contextmanager
def _fleet(port, n_decode=2, prefill=False, kv_dtype=None, **eng_kw):
    kw = dict(slots=2, segment=8, page_block=8, cache_bucket=32,
              kv_dtype=kv_dtype, device="cpu")
    kw.update(eng_kw)
    router = ServingRouter(ttl=1.0, scrape_interval_s=0.1).start()
    daemons = []
    try:
        for i in range(n_decode):
            d = ServingDaemon(ServingEngine(port, **kw)).start()
            d.join_router(router.address, f"d{i}", role="decode")
            daemons.append(d)
        if prefill:
            pool = PagePool(port, slots=2, segment=kw["segment"],
                            page_block=kw["page_block"],
                            cache_bucket=kw["cache_bucket"],
                            kv_dtype=kv_dtype, device="cpu")
            pd = PrefillDaemon(pool).start()
            pd.join_router(router.address, "p0", role="prefill")
            daemons.append(pd)
        yield router, daemons
    finally:
        for d in daemons:
            d.stop()
        router.stop()


def _throttle(daemons, delay_s=0.05):
    """Slow every decode segment so a stream is surely mid-flight when a
    worker goes away."""
    for d in daemons:
        orig = d.engine.decode_segment

        def slow(o=orig):
            time.sleep(delay_s)
            o()
        d.engine.decode_segment = slow


def _drain(client, work, timeout=60.0, cursors=None):
    """Round-robin poll {key: rid} to completion; cursors only advance, so
    a lost or duplicated token breaks parity."""
    cursors = {k: (cursors or {}).get(k, 0) for k in work}
    toks = {k: [] for k in work}
    live = set(work)
    deadline = time.monotonic() + timeout
    while live:
        assert time.monotonic() < deadline, "routed drain timed out"
        for k in list(live):
            got, done, reason = client.poll(work[k], cursors[k])
            toks[k].extend(got)
            cursors[k] += len(got)
            if done:
                assert reason in ("length", "eos"), (k, reason)
                live.discard(k)
        time.sleep(0.01)
    return {k: np.asarray(v, np.int32) for k, v in toks.items()}


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_disaggregated_fleet_streams_exact(models, kv_dtype):
    """One prefill and two decode workers: interleaved streams equal the
    solo decode (f32: also JAX's; int8: a solo int8 engine's), the pages
    went over the wire (every decode admission was an adoption), the
    pump scraped load into the aggregator's history, and replies carry
    the membership epoch."""
    jmodel, jparams, port = models
    rs = np.random.RandomState(21)
    reqs = {i: (rs.randint(0, VOCAB, n), g)
            for i, (n, g) in enumerate([(7, 18), (11, 20), (13, 24)])}
    if kv_dtype is None:
        want = {i: _solo(port, p, g) for i, (p, g) in reqs.items()}
        for i, (p, g) in reqs.items():
            np.testing.assert_array_equal(want[i], np.asarray(
                jmodel.generate_cached(jparams, jax.numpy.asarray(p[None]),
                                       steps=g))[0, len(p):])
    else:
        solo = ServingEngine(port, slots=1, segment=8, page_block=8,
                             cache_bucket=32, kv_dtype="int8", device="cpu")
        want = {}
        for i, (p, g) in reqs.items():
            rid = solo.submit(p, g)
            while not solo.poll(rid)[1]:
                solo.step()
            want[i] = np.asarray(solo.poll(rid)[0], np.int32)
    with _fleet(port, prefill=True, kv_dtype=kv_dtype) as (router, ds):
        c = RouterClient(*router.address, **WAIT)
        st = c.serving_stats()
        assert (st["n_decode_workers"], st["n_prefill_workers"]) == (2, 1)
        work = {i: c.submit(p, g) for i, (p, g) in reqs.items()}
        got = _drain(c, work)
        for i in reqs:
            np.testing.assert_array_equal(got[i], want[i])
        shipped = sum(d.engine.pool.prompt_tokens_total for d in ds[:2])
        assert shipped == sum(len(p) for p, _ in reqs.values())
        assert all(d.engine.pool.admissions_total == 0 for d in ds[:2])
        hist = router.server.aggregator.history
        deadline = time.monotonic() + 10.0
        while not hist.points("d0", "serving.queue_depth"):
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert c.last_epoch is not None
        c.close()


def test_placement_follows_load_trends_and_backpressure_aggregates(models):
    """A worker whose history shows load scores above an idle one and is
    placed on last; with both pools saturated the client gets one
    structured overloaded refusal (the least retry hint) on a connection
    that keeps serving, and backoff lands once a pool drains."""
    _, _, port = models
    with _fleet(port, n_decode=2, queue_cap=2) as (router, ds):
        router._stop.set()                  # the test writes the history
        hist = router.server.aggregator.history
        for _ in range(3):
            hist.record_value("d0", "serving.queue_depth", 5.0)
        assert router._score("d0") > router._score("d1") == 0.0
        assert [w for w, _, _ in router._candidates("decode")] == ["d1",
                                                                   "d0"]
        c = RouterClient(*router.address, **WAIT)
        rs = np.random.RandomState(3)
        rids, refusals = [], []
        for _ in range(16):
            try:
                rids.append(c.submit(rs.randint(0, VOCAB, 5), 80))
            except Overloaded as e:
                refusals.append(e)
        assert rids and refusals
        assert all(e.retry_after_s > 0 for e in refusals)
        assert any("saturated" in str(e) for e in refusals)
        assert c.serving_stats()["inflight"] >= 1
        for rid in rids:
            c.cancel(rid)
        late = c.submit_with_backoff(rs.randint(0, VOCAB, 5), 3)
        assert _drain(c, {"late": late})["late"].size == 3
        c.close()


def test_worker_stopped_without_drain_reroutes_exact(models):
    """Stop the decode worker holding a live stream with no drain: the
    membership notice marks the record, the next poll re-prefills prompt
    + delivered tokens on the survivor under a derived key, and the
    client's whole sequence is the solo decode — the seam is invisible."""
    _, _, port = models
    with _fleet(port, n_decode=2) as (router, ds):
        c = RouterClient(*router.address, **WAIT)
        _throttle(ds)
        rs = np.random.RandomState(9)
        prompt, max_new = rs.randint(0, VOCAB, 9), 24
        rid = c.submit(prompt, max_new, submit_key="s9")
        toks, cursor = [], 0
        deadline = time.monotonic() + 30.0
        while not toks:
            assert time.monotonic() < deadline
            got, done, _ = c.poll(rid, cursor)
            toks.extend(got)
            cursor += len(got)
            assert not done, "stream finished before the stop"
            time.sleep(0.005)
        rec = router._recs[rid]
        victim = next(d for i, d in enumerate(ds) if f"d{i}" == rec.worker)
        ds.remove(victim)
        victim.stop()
        got = _drain(c, {"s": rid}, cursors={"s": cursor})["s"]
        full = np.concatenate([np.asarray(toks, np.int32), got])
        np.testing.assert_array_equal(full, _solo(port, prompt, max_new))
        assert rec.reroutes == 1
        # the survivor admitted the re-route under the derived key
        assert "s9#r1" in ds[0]._submit_seen
        c.close()


def test_replay_caches_and_prefix_len_hardening(models):
    """A replayed route_submit returns the original rid; a replay may not
    inflate its prefix_len (router and worker alike refuse with
    invalid_argument); internal cache fields never leak."""
    _, _, port = models
    with _fleet(port, n_decode=1) as (router, ds):
        mc = MasterClient(*router.address, **WAIT)
        req = {"op": "route_submit", "prompt": list(range(1, 10)),
               "max_new": 2, "submit_key": "k-route", "prefix_len": 2}
        r1 = mc._call(dict(req))
        assert r1["ok"]
        replay = mc._call(dict(req, prefix_len=8))
        assert not replay["ok"] and replay["code"] == "invalid_argument"
        assert mc._call(dict(req))["rid"] == r1["rid"]
        mc.close()
        mw = MasterClient(*ds[0].address, **WAIT)
        wreq = {"op": "srv_submit", "prompt": list(range(1, 10)),
                "max_new": 2, "submit_key": "k-worker", "prefix_len": 2}
        w1 = mw._call(dict(wreq))
        wre = mw._call(dict(wreq, prefix_len=8))
        assert not wre["ok"] and wre["code"] == "invalid_argument"
        wsame = mw._call(dict(wreq))
        assert wsame["rid"] == w1["rid"] and "_prefix_len" not in wsame
        mw.close()


def test_router_fault_sites_are_structured_and_recoverable(models):
    """``route.submit`` raising fails one submit and the next places;
    ``srv.ship`` corrupting a chunk is refused with data_loss by the
    decode worker and never adopted (the prefill worker answers the
    refusal, and the router's fallback prefill on the decode worker still
    serves the request exactly); ``srv.adopt`` raising falls back the
    same way."""
    _, _, port = models
    rs = np.random.RandomState(17)
    prompt, max_new = rs.randint(0, VOCAB, 11), 12
    want = _solo(port, prompt, max_new)
    with _fleet(port, n_decode=1, prefill=True) as (router, ds):
        c = RouterClient(*router.address, **WAIT)
        plan = faults.FaultPlan().add("route.submit", "raise", nth=1)
        with plan.installed():
            with pytest.raises((ValueError, RuntimeError)):
                c.submit(prompt, 4)
            rid = c.submit(prompt, max_new)
        np.testing.assert_array_equal(_drain(c, {"s": rid})["s"], want)

        pd, dd = ds[1], ds[0]
        raw = MasterClient(*pd.address, **WAIT)
        host, port_ = dd.address
        plan = faults.FaultPlan(seed=3).add("srv.ship", "corrupt", nth=1)
        before = dd.engine._next_rid
        with plan.installed():
            r = raw._call({"op": "srv_prefill", "prompt": prompt.tolist(),
                           "max_new": max_new, "decode_host": host,
                           "decode_port": port_})
        assert not r["ok"] and r["code"] == "data_loss"
        assert "CRC" in r["error"]
        assert dd.engine._next_rid == before   # never adopted
        assert not dd._ships                   # the reassembly dropped
        raw.close()
        with faults.FaultPlan().add("srv.adopt", "raise",
                                    nth=1).installed() as plan:
            rid = c.submit_with_backoff(prompt, max_new)
            np.testing.assert_array_equal(_drain(c, {"s": rid})["s"], want)
        assert plan.fired == [("srv.adopt", 1, "raise")]
        c.close()
