"""Request timelines and alerts of the port's obs plane against the JAX
package's on the same series: the request ledger's telescoped phases,
stitched timelines (the re-route stitch included), grouping, the
``RequestStore``'s exemplars, the alert engine's transitions and the
exemplars a burn-rate transition carries; a small engine burst under a
session in both packages (the same ``decode.*``/``serving.*`` counts and
the same timeline phases) and its timeline reconciled with the observed
TTFT on one fake clock; the HTTP view over a dump.
"""

import json
import urllib.request

import jax
import numpy as np
import pytest

from paddle_tpu import obs as jobs
from paddle_tpu.obs import requests as jreq
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.obs import requests as treq

VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
POOL = dict(segment=8, page_block=8, cache_bucket=32)


def _clk(start=0.0):
    t = [start]
    return (lambda: t[0]), t


def _leg(key, recorder, origin, events, worker=None):
    tl = {"key": key, "recorder": recorder, "origin": origin,
          "events": events, "done": any(e["phase"] in ("done", "cancel")
                                        for e in events),
          "updated": events[-1]["t"] if events else 0.0}
    if worker is not None:
        tl["worker"] = worker
    return tl


def _slow_ship_legs(key="req-1", ship_s=0.30):
    router = _leg(key, "router", 1000.0, [
        {"phase": "admitted", "t": 0.000, "dur": 0.0},
        {"phase": "route", "t": 0.001, "dur": 0.0, "worker": "d0"},
    ], worker="router")
    prefill = _leg(key, "p0", 1000.0, [
        {"phase": "prefill", "t": 0.010, "dur": 0.008},
        {"phase": "ship", "t": 0.010 + ship_s, "dur": ship_s},
    ], worker="p0")
    decode = _leg(key, "d0", 1000.0, [
        {"phase": "queued", "t": 0.012, "dur": 0.002},
        {"phase": "scheduled", "t": 0.012 + ship_s, "dur": 0.001},
        {"phase": "adopt", "t": 0.015 + ship_s, "dur": 0.003},
        {"phase": "first_token", "t": 0.016 + ship_s, "dur": 0.0},
        {"phase": "decode", "t": 0.066 + ship_s, "dur": 0.05, "n": 8},
        {"phase": "done", "t": 0.066 + ship_s, "dur": 0.0,
         "reason": "length", "tokens": 9},
    ], worker="d0")
    return [router, prefill, decode]


def _reroute_legs(key="req-7"):
    leg0 = _leg(key, "d0", 1000.0, [
        {"phase": "queued", "t": 0.00, "dur": 0.0},
        {"phase": "prefill", "t": 0.02, "dur": 0.02},
        {"phase": "first_token", "t": 0.02, "dur": 0.0},
        {"phase": "decode", "t": 0.10, "dur": 0.08, "n": 4},
    ], worker="d0")
    router = _leg(key, "router", 1000.0, [
        {"phase": "admitted", "t": 0.00, "dur": 0.0},
        {"phase": "reroute", "t": 0.12, "dur": 0.0, "why": "evicted"},
    ], worker="router")
    leg1 = _leg(f"{key}#r1", "d1", 1000.0, [
        {"phase": "queued", "t": 0.13, "dur": 0.0},
        {"phase": "prefill", "t": 0.16, "dur": 0.03},
        {"phase": "first_token", "t": 0.16, "dur": 0.0},
        {"phase": "decode", "t": 0.26, "dur": 0.10, "n": 5},
        {"phase": "done", "t": 0.26, "dur": 0.0, "reason": "length"},
    ], worker="d1")
    return [leg1, router, leg0]


LEGS = {"slow_ship": _slow_ship_legs, "reroute": _reroute_legs}


@pytest.mark.parametrize("legs", sorted(LEGS))
def test_stitch_group_and_format_equal_jax(legs):
    for m in (jreq, treq):
        assert m.base_key("a#r3") == "a" and m.leg_of("a#r3") == 3
    j = jreq.stitch(LEGS[legs]())
    t = treq.stitch(LEGS[legs]())
    assert t == j
    assert treq.format_timeline(t) == jreq.format_timeline(j)
    assert treq.group_legs(LEGS[legs]()) == jreq.group_legs(LEGS[legs]())


def _ledger_run(mod, reqmod):
    clock, t = _clk()
    reg = mod.MetricsRegistry()
    with mod.ObsSession(registry=reg).installed():
        led = reqmod.RequestLedger(clock=clock, ident="w0").install()
        try:
            for i, (ph, dt) in enumerate((
                    ("admitted", 0.0), ("queued", 0.01), ("prefill", 0.02),
                    ("first_token", 0.0), ("decode", 0.05),
                    ("decode", 0.05), ("done", 0.0))):
                t[0] += dt
                led.phase("k", ph, n=i)
            out = led.export()
        finally:
            led.uninstall()
    return out, sorted((s["name"], tuple(sorted(s["labels"].items())),
                        s.get("count"), s.get("sum")) for s in reg.collect())


def test_ledger_telescopes_folds_and_observes_as_jax():
    (jt, jm), (tt, tm) = _ledger_run(jobs, jreq), _ledger_run(tobs, treq)
    for tl in jt + tt:
        tl.pop("origin", None)
    assert tt == jt
    assert tm == jm


def test_request_store_and_exemplars_equal_jax():
    out = {}
    for name, o, m in (("jax", jobs, jreq), ("torch", tobs, treq)):
        clock, t = _clk()
        store = m.RequestStore(exemplar_k=2, window_s=10.0, clock=clock)
        reg = o.MetricsRegistry()
        with o.ObsSession(registry=reg).installed():
            for i, ship_s in enumerate((0.05, 0.40, 0.20)):
                store.push("d0", _slow_ship_legs(f"r{i}", ship_s=ship_s))
        ex = store.exemplars()
        bad = store.push("d1", [None, 3, {"key": ""}, {"key": "x"}])
        t[0] = 11.0
        out[name] = (ex, bad, store.exemplars(), len(store),
                     sorted((s["name"], s["labels"].get("phase"),
                             s["value"]) for s in reg.collect()))
    assert out["torch"] == out["jax"]
    assert [e["key"] for e in out["torch"][0]] == ["r1", "r2"]


def _hist(name, count, total, buckets):
    return {"type": "histogram", "name": name, "count": count,
            "sum": total, "buckets": buckets, "labels": {}, "max": 0.0}


def _burn(o, agg_mod, alerts_mod):
    clock, t = _clk()
    rule = alerts_mod.AlertRule(
        "serving_ttft_slo_burn", "serving.ttft_seconds", kind="burn_rate",
        slo_le=1.0, budget=0.1, short_s=60.0, long_s=300.0, for_windows=1)
    qrule = alerts_mod.AlertRule(
        "queue_deep", "serving.queue_depth", kind="threshold", op=">",
        threshold=5.0, for_windows=2)
    reg = o.MetricsRegistry()
    with o.ObsSession(registry=reg).installed():
        agg = agg_mod.ClusterAggregator(clock=clock, rules=[rule, qrule],
                                        eval_interval_s=0.0)
        agg.push_requests("d0", _slow_ship_legs(ship_s=0.9))
        n = 0
        events = []
        for i in range(14):
            t[0] += 50.0
            n += 100
            good = int(n * 0.98) if i < 7 else int(700 * 0.98)
            agg.push("serving", [
                _hist("serving.ttft_seconds", n, n * 0.5,
                      [[0.5, good // 2], [1.0, good], ["+Inf", n]]),
                {"type": "gauge", "name": "serving.queue_depth",
                 "labels": {}, "value": float(i % 9)}])
            events.extend(agg.evaluate(t[0]) or ())
        active = agg.alerts.active()
        recent = agg.alerts.recent_events()
    clean = lambda evs: [{k: v for k, v in e.items()  # noqa: E731
                          if k not in ("ts", "tid", "pid")} for e in evs]
    return (clean(recent), active,
            sorted((s["name"], tuple(sorted(s["labels"].items())),
                    s.get("value")) for s in reg.collect()
                   if s["name"].startswith(("alerts.", "serving.ex"))))


def test_alert_engine_transitions_and_exemplars_equal_jax():
    """One series of pushes through each package's aggregator and alert
    engine: the same fired/resolved transitions, the same active set, the
    same alert counters, and the burn transition carrying the same
    ship-dominant exemplar."""
    from paddle_tpu.obs import aggregate as jagg
    from paddle_tpu.obs import alerts as jal
    from paddle_tpu_torch.obs import aggregate as tagg
    from paddle_tpu_torch.obs import alerts as tal
    j = _burn(jobs, jagg, jal)
    t = _burn(tobs, tagg, tal)
    assert t == j
    fired = [e for e in t[0] if e["args"].get("state") == "fired"
             and e["args"].get("rule") == "serving_ttft_slo_burn"]
    assert fired and fired[-1]["args"]["exemplars"][0]["dominant"] == "ship"


def test_default_and_slo_rules_equal_jax():
    from paddle_tpu.obs import alerts as jal
    from paddle_tpu_torch.obs import alerts as tal

    def desc(rules):
        return [sorted(vars(r).items()) if hasattr(r, "__dict__") else
                [(s, getattr(r, s)) for s in r.__slots__] for r in rules]

    assert desc(tal.default_rules()) == desc(jal.default_rules())
    assert desc(tal.serving_slo_rules(0.5, 0.1, 0.05)) == desc(
        jal.serving_slo_rules(0.5, 0.1, 0.05))


# -- the engine ----------------------------------------------------------------

@pytest.fixture(scope="module")
def models(paged_model_and_params):
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.models import TransformerLM
    jmodel, jparams = paged_model_and_params
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    port = params_from_numpy(tree, TransformerLM(
        VOCAB, d_model=D, n_heads=H, n_layers=L, max_len=MAX_LEN), "cpu")
    return jmodel, jparams, port


def _burst(o, make_engine):
    clock, t = _clk()
    reg = o.MetricsRegistry()
    with o.ObsSession(registry=reg).installed():
        led = o.requests.RequestLedger(clock=clock, ident="eng").install()
        eng = make_engine(clock)
        rs = np.random.RandomState(5)
        rids = [eng.submit(rs.randint(0, VOCAB, n), m, submit_key=f"k{i}")
                for i, (n, m) in enumerate(((9, 12), (17, 5), (4, 20)))]
        while not all(eng.poll(r)[1] for r in rids):
            t[0] += 0.01
            eng.step()
        toks = [eng.poll(r)[0] for r in rids]
        phases = {f"k{i}": [e["phase"] for e in led.get(f"k{i}")["events"]]
                  for i in range(3)}
        stitched = {f"k{i}": jreq.stitch([led.get(f"k{i}")])
                    for i in range(3)}
    counts = sorted((s["name"], tuple(sorted(s["labels"].items())),
                     s.get("value", s.get("count")))
                    for s in reg.collect()
                    if s["name"].startswith(("decode.", "serving."))
                    and s["type"] != "histogram"
                    or s["name"] in ("serving.ttft_seconds",
                                     "serving.tpot_seconds"))
    ttft = [s for s in reg.collect() if s["name"] == "serving.ttft_seconds"]
    return toks, phases, counts, stitched, ttft


def test_engine_burst_counts_and_timelines_equal_jax(models):
    """Three requests through each package's ServingEngine under a session
    on one fake clock: the same tokens, the same decode.*/serving.*
    counts and gauges, the same timeline phases a request."""
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.serving import ServingEngine as TEngine
    jmodel, jparams, port = models
    j = _burst(jobs, lambda c: JEngine(jmodel, jparams, slots=2, clock=c,
                                       **POOL))
    t = _burst(tobs, lambda c: TEngine(port, slots=2, clock=c,
                                       device="cpu", **POOL))
    assert [list(x) for x in t[0]] == [list(x) for x in j[0]]
    assert t[1] == j[1]
    assert t[2] == j[2]


def test_engine_timeline_reconciles_with_observed_ttft(models):
    """One fake clock drives the port's engine and the ledger: the
    stitched breakdown sums to the wall, and the stitched TTFT is the
    engine's own observation (queued + prefill)."""
    from paddle_tpu_torch.serving import ServingEngine
    _, _, port = models
    _, _, _, stitched, ttft = _burst(
        tobs, lambda c: ServingEngine(port, slots=2, clock=c, device="cpu",
                                      **POOL))
    total_ttft = sum(s["sum"] for s in ttft)
    assert sum(st["ttft_s"] for st in stitched.values()) == pytest.approx(
        total_ttft, abs=1e-6)
    for st in stitched.values():
        assert st["done"]
        assert st["total_s"] == pytest.approx(st["wall_s"], abs=1e-6)
        assert sum(st["breakdown"].values()) == pytest.approx(
            st["wall_s"], abs=1e-6)
        assert st["ttft_s"] == pytest.approx(
            st["breakdown"].get("queued", 0.0)
            + st["breakdown"]["prefill"], abs=1e-6)


def test_engine_alert_rules_are_jaxs(models):
    from paddle_tpu.serving import ServingEngine as JEngine
    from paddle_tpu_torch.serving import ServingEngine as TEngine
    jmodel, jparams, port = models
    je = JEngine(jmodel, jparams, slots=1, slo_ttft_s=0.5, **POOL)
    te = TEngine(port, slots=1, slo_ttft_s=0.5, device="cpu", **POOL)
    assert [r.name for r in te.alert_rules()] == [
        r.name for r in je.alert_rules()]
    with pytest.raises(ValueError, match="slo_budget"):
        TEngine(port, slots=1, slo_budget=1.5, device="cpu", **POOL)


def test_http_view_serves_metrics_trace_and_requests():
    from paddle_tpu_torch.obs.aggregate import ObsHttpServer
    legs = _slow_ship_legs("http-req")
    r = tobs.MetricsRegistry()
    r.counter("trainer.steps_total").inc(4)
    provider = lambda: {"metrics": r.collect(), "events": [],  # noqa: E731
                        "requests": legs,
                        "exemplars": [{"key": "http-req",
                                       "dominant": "ship"}]}
    srv = ObsHttpServer(provider).start()
    host, port = srv.address
    try:
        def get(path):
            with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                        timeout=10) as resp:
                assert resp.status == 200
                return resp.read().decode()
        assert "paddle_tpu_trainer_steps_total 4" in get("/metrics")
        assert "traceEvents" in json.loads(get("/trace"))
        body = json.loads(get("/requests"))
        assert "trainer.steps_total" in get("/summary")
    finally:
        srv.stop()
    assert [q["key"] for q in body["requests"]] == ["http-req"]
    assert body["requests"][0]["dominant"] == "ship"
