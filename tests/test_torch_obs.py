"""The port's obs session plane (``paddle_tpu_torch.obs``) against the JAX
package's on the same inputs: the same span and metric sequences under
one fake clock give byte-equal Chrome trace JSON, Prometheus text, JSONL
and summaries (nesting, threads, errors, the event cap, label escaping,
merged dumps, torn JSONL tails); the zero-cost hooks and the exclusive
install; goodput ledgers under a fake clock, compile stealing through
the port's graph-capture hook; the roofline's derived gauges and kernel
byte models, the meta-tensor cost count and the re-emission of a graphed
body's counts; the wire context across one RPC of the port's master
service; L007/L009 and the package surface; the CLI's obs subcommands
on the same dump; and a small classifier trained two passes under a
session in both packages.
"""

import io
import json
import os
import threading
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from paddle_tpu import obs as jobs
from paddle_tpu_torch import obs as tobs

PKGS = {"jax": jobs, "torch": tobs}
META = {"pid": 1, "process": "p", "trace_id": "t", "created_unix": 0.0,
        "clock_origin_unix": 100.0}


def _fake_clock(step=1.0):
    t = [0.0]

    def clock():
        t[0] += step
        return t[0]

    return clock


def _normalized(dump):
    """A dump with the identity fields that differ between two runs (the
    creation time, the trace id) fixed."""
    dump = dict(dump)
    dump["meta"] = dict(dump["meta"], **{k: META[k] for k in
                                         ("trace_id", "created_unix",
                                          "clock_origin_unix")})
    return dump


# -- scenarios: one span/metric sequence, run by each package -----------------

def _nesting(o):
    with o.span("trainer.pass", pass_id=0):
        with o.span("trainer.step", metric="trainer.step_seconds"):
            o.count("trainer.steps_total")
        with o.span("ckpt.publish", pass_id=0):
            o.observe("ckpt.write_seconds", 0.25, )
    o.instant("graphs.capture", label="x")


def _threads(o):
    with o.span("trainer.pass"):
        t = threading.Thread(target=lambda: o.span("data.prefetch")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    o.gauge_set("data.queue_depth", 3)
    o.gauge_set("data.queue_depth", 1)


def _errors(o):
    try:
        with o.span("fluid.run", metric="fluid.run_seconds"):
            raise RuntimeError("boom")
    except RuntimeError:
        pass
    o.count("faults.injected_total", site="rpc.send", action="raise")


def _labels(o):
    o.count("rpc.calls_total", op='we"ird\\path\nx', rpc="master")
    o.count("rpc.calls_total", 2, op="get_task", rpc="master")
    o.observe("rpc.call_seconds", 0.003, rpc="master")
    o.observe("rpc.call_seconds", 7.0, rpc="master")
    o.gauge_set("serving.page_occupancy", 0.625)


def _many(o):
    for i in range(6):
        with o.span("trainer.step", i=i):
            o.count("trainer.examples_total", 8)


SCENARIOS = {"nesting": _nesting, "threads": _threads, "errors": _errors,
             "labels": _labels, "event_cap": _many}


def _run(pkg, scenario):
    o = PKGS[pkg]
    cap = 3 if scenario == "event_cap" else 100_000
    s = o.ObsSession(registry=o.MetricsRegistry(),
                     tracer=o.Tracer(clock=_fake_clock(), max_events=cap),
                     process="p")
    with s.installed():
        SCENARIOS[scenario](o)
    return _normalized(s.dump())


def _jsonl(o, dump):
    from importlib import import_module
    return "\n".join(import_module(o.__name__ + ".export")
                     .jsonl_lines(dump))


EXPORTS = {
    "chrome": lambda o, d: json.dumps(o.chrome_trace(d), sort_keys=True),
    "prom": lambda o, d: o.prometheus_text(d),
    "jsonl": _jsonl,
    "summary": lambda o, d: o.summary(d),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("fmt", sorted(EXPORTS))
def test_exports_are_byte_equal_to_jax(scenario, fmt):
    j, t = _run("jax", scenario), _run("torch", scenario)
    assert EXPORTS[fmt](tobs, t) == EXPORTS[fmt](jobs, j)


def test_event_cap_reports_dropped_as_jax():
    t = _run("torch", "event_cap")
    assert t["meta"]["events_dropped"] == _run("jax", "event_cap")["meta"][
        "events_dropped"] == 3


def test_span_nesting_and_thread_lanes():
    t = _run("torch", "threads")
    by = {e["name"]: e for e in t["events"] if e["kind"] == "span"}
    assert by["data.prefetch"]["parent"] is None
    assert by["data.prefetch"]["tid"] != by["trainer.pass"]["tid"]
    t = _run("torch", "nesting")
    by = {e["name"]: e for e in t["events"] if e["kind"] == "span"}
    assert by["trainer.step"]["parent"] == by["trainer.pass"]["id"]
    (err,) = [e for e in _run("torch", "errors")["events"]
              if e["name"] == "fluid.run"]
    assert err["args"]["error"] == "RuntimeError"


def test_merge_dumps_equal_jax():
    worker = {"meta": {"pid": 100, "process": "worker-0",
                       "clock_origin_unix": 1000.0},
              "metrics": [{"type": "counter", "name": "trainer.steps_total",
                           "labels": {}, "value": 3}],
              "events": [{"kind": "span", "name": "rpc.call", "ts": 1.0,
                          "dur": 0.5, "tid": 1, "pid": 100, "id": 7,
                          "parent": None, "args": {"op": "obs_push"}}]}
    master = {"meta": {"pid": 200, "process": "master",
                       "clock_origin_unix": 1000.25},
              "metrics": [{"type": "counter", "name": "trainer.steps_total",
                           "labels": {}, "value": 9}],
              "events": [{"kind": "span", "name": "master.dispatch",
                          "ts": 0.9, "dur": 0.1, "tid": 9, "pid": 200,
                          "id": 3, "parent": None, "args": {"op": "x"},
                          "remote": {"id": "t", "span": 7, "pid": 100}}]}
    mj = jobs.merge_dumps([worker, master])
    mt = tobs.merge_dumps([worker, master])
    assert mt == mj
    assert json.dumps(tobs.chrome_trace(mt)) == json.dumps(
        jobs.chrome_trace(mj))


@pytest.mark.parametrize("cut", [1, 5, 40])
def test_read_jsonl_tolerates_torn_tail_as_jax(tmp_path, cut):
    s = tobs.ObsSession(registry=tobs.MetricsRegistry(),
                        tracer=tobs.Tracer(clock=_fake_clock()))
    with s.installed():
        tobs.count("trainer.steps_total", 5)
        with tobs.span("trainer.pass"):
            pass
    p = s.save(str(tmp_path / "torn.jsonl"))
    raw = open(p, "rb").read()
    open(p, "wb").write(raw[:-cut])
    assert tobs.read_jsonl(p) == jobs.read_jsonl(p)


def test_zero_cost_hooks_are_noops_without_session():
    assert not tobs.is_active()
    tobs.count("trainer.steps_total")
    tobs.gauge_set("data.queue_depth", 5)
    tobs.observe("rpc.call_seconds", 0.1)
    tobs.instant("graphs.capture")
    sp = tobs.span("trainer.step", metric="trainer.step_seconds")
    assert sp is tobs.NULL_SPAN
    with sp:
        pass
    assert tobs.wire_context(sp) is None
    assert tobs.flight_dump("x") is None
    assert tobs.goodput.open_ledger("trainer") is None
    r = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=r).installed():
        pass
    assert r.collect() == []


def test_exclusive_install():
    a = tobs.ObsSession(registry=tobs.MetricsRegistry())
    b = tobs.ObsSession(registry=tobs.MetricsRegistry())
    with a.installed():
        with pytest.raises(RuntimeError, match="already installed"):
            b.install()
    assert not tobs.is_active()


def test_retry_observer_counts_as_jax():
    from paddle_tpu.utils.retry import RetryBudgetExceeded as JB
    from paddle_tpu.utils.retry import RetryPolicy as JP
    from paddle_tpu_torch.utils.retry import RetryBudgetExceeded as TB
    from paddle_tpu_torch.utils.retry import RetryPolicy as TP
    out = {}
    for name, o, P, B in (("jax", jobs, JP, JB), ("torch", tobs, TP, TB)):
        r = o.MetricsRegistry()
        policy = P(max_attempts=3, base_delay=0.25, jitter=0.0,
                   sleep=lambda s: None, clock=lambda: 0.0,
                   observer=o.retry_observer("rpc"))
        with o.ObsSession(registry=r).installed():
            with pytest.raises(B):
                policy.call(lambda: (_ for _ in ()).throw(OSError("x")))
        out[name] = sorted((s["name"], s["value"]) for s in r.collect())
    assert out["torch"] == out["jax"]


# -- goodput ----------------------------------------------------------------------

def _goodput(o, note_compile):
    r = o.MetricsRegistry()
    clock = _fake_clock(0.5)
    gp = o.goodput.GoodputLedger(r, component="trainer", clock=clock).open()
    for _ in range(3):
        with gp.bucket("host_input"):
            pass
        with gp.bucket("device"):
            note_compile(0.25)
        with gp.bucket("host_sync"):
            pass
    gp.close()
    return sorted((s["name"], tuple(sorted(s["labels"].items())),
                   s["value"]) for s in r.collect())


def test_goodput_ledger_equals_jax_with_capture_stealing():
    """The same bucket sequence under one fake clock: equal counters and
    ratio. JAX steals compile seconds through its jax.monitoring bridge,
    the port through core/graphs.py's capture hook (note_capture)."""
    from paddle_tpu.obs import jaxhooks
    from paddle_tpu_torch.core import graphs
    rj = jobs.MetricsRegistry()
    with jobs.ObsSession(registry=rj).installed():
        want = _goodput(jobs, lambda s: jaxhooks._on_duration(
            "/jax/core/compile/backend_compile_duration", s))
    rt = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=rt).installed():
        got = _goodput(tobs, lambda s: graphs.note_capture(s, "k"))
    assert got == want
    assert rt.counter("graphs.captures_total").get() == 3
    assert rj.counter("jax.compiles_total").get() == 3
    assert rt.histogram("graphs.capture_seconds").snapshot()["count"] == 3


def test_trainer_goodput_and_spans_under_a_session():
    """Two passes of the port's Trainer on the CPU under a session: the
    trainer.* spans nest as JAX's, the goodput buckets and ratio are
    there, the counters mirror into the session, summary() renders."""
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.trainer import Trainer
    rs = np.random.RandomState(0)
    data = [(torch.tensor(rs.randn(8, 4), dtype=torch.float32),
             torch.tensor(rs.randn(8, 1), dtype=torch.float32))
            for _ in range(3)]
    w = {"w": torch.zeros(4, 1)}
    t = Trainer(lambda p, x, y: ((x @ p["w"] - y) ** 2).mean(), SGD(0.1),
                device="cpu")
    r = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=r).installed() as s:
        t.train(lambda: iter(data), w, num_passes=2, handle_signals=False)
    names = {e["name"] for e in s.dump()["events"] if e["kind"] == "span"}
    assert {"trainer.pass", "trainer.step", "trainer.device_step",
            "trainer.host_sync"} <= names
    assert r.counter("trainer.steps_total").get() == 6
    assert r.counter("trainer.examples_total").get() == 48
    for b in ("host_input", "device", "host_sync", "idle"):
        assert r.counter(f"goodput.{b}_seconds_total").get(
            component="trainer") >= 0
    assert 0 <= r.gauge("goodput.ratio").get(component="trainer") <= 1
    assert r.histogram("trainer.step_seconds").snapshot()["count"] == 6
    # the CPU step runs eagerly: its cost is counted on meta once and
    # accounted every step
    # (forward x @ w and the gradient of w: two 8x4x1 products a step)
    assert r.counter("fluid.device_flops_total").get() == 6 * 2 * 2 * 8 * 4
    assert "trainer.steps_total" in t.summary()


# -- roofline ----------------------------------------------------------------------

def test_peaks_resolve_none_off_the_card_and_env_overrides(monkeypatch):
    from paddle_tpu_torch.obs import roofline as tr
    monkeypatch.delenv("PADDLE_TPU_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("PADDLE_TPU_PEAK_HBM_GBPS", raising=False)
    assert tr.peak_flops_per_sec() is None
    assert tr.peak_hbm_bytes_per_sec() is None
    assert set(tr.PEAK_TFLOPS) == {"NVIDIA H100 80GB HBM3", "cpu"}
    assert tr.PEAK_TFLOPS["NVIDIA H100 80GB HBM3"] == 989.0
    assert tr.PEAK_HBM_GBPS["NVIDIA H100 80GB HBM3"] == 3350.0
    monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "100")
    monkeypatch.setenv("PADDLE_TPU_PEAK_HBM_GBPS", "bad")
    assert tr.peak_flops_per_sec() == 1e14
    with pytest.warns(RuntimeWarning):
        assert tr.peak_hbm_bytes_per_sec() is None


@pytest.mark.parametrize("flops,nbytes", [(1e12, 2e9), (0.0, 5e10),
                                          (3e15, 0.0)])
def test_derive_gauges_equal_jax(monkeypatch, flops, nbytes):
    from paddle_tpu.obs import roofline as jr
    from paddle_tpu_torch.obs import roofline as tr
    monkeypatch.setenv("PADDLE_TPU_PEAK_TFLOPS", "900")
    monkeypatch.setenv("PADDLE_TPU_PEAK_HBM_GBPS", "3000")
    out = {}
    for name, o, rl in (("jax", jobs, jr), ("torch", tobs, tr)):
        rl._reset_derivers()
        r = o.MetricsRegistry()
        rl.account(rl.Cost(flops=1.0, bytes=1.0), registry=r, now=0.0)
        rl.account(rl.Cost(flops=flops, bytes=nbytes), registry=r,
                   now=2.0)
        out[name] = sorted((s["name"], s["value"]) for s in r.collect())
    assert out["torch"] == out["jax"]


KERNEL_GRID = [
    ("decode_attention", dict(batch=8, read=1024, n_heads=12, d_head=64,
                              layers=12, kv_dtype=None, itemsize=2)),
    ("decode_attention", dict(batch=4, read=256, n_heads=16, d_head=128,
                              kv_dtype="int8", steps=32)),
    ("paged_decode_attention", dict(batch=8, pages=16, page_block=64,
                                    n_heads=12, d_head=64, layers=12,
                                    itemsize=2, steps=32)),
    ("paged_decode_attention", dict(batch=2, pages=3, page_block=8,
                                    n_heads=4, d_head=8, kv_dtype="int8")),
    ("paged_prefill_attention", dict(batch=8, pages=4, page_block=64,
                                     n_heads=12, d_head=64, layers=12)),
    ("lstm_sequence_fused", dict(batch=64, seq_len=128, hidden=256,
                                 itemsize=2)),
    ("lstm_sequence_fused", dict(batch=3, seq_len=7, hidden=8)),
    ("gru_sequence_fused", dict(batch=64, seq_len=32, hidden=512)),
]


@pytest.mark.parametrize("kernel,meta", KERNEL_GRID)
def test_kernel_byte_models_equal_jax(kernel, meta):
    import paddle_tpu.ops.pallas_kernels  # noqa: F401 - registers JAX's
    from paddle_tpu.obs import roofline as jr
    import paddle_tpu_torch.ops.rnn_kernels  # noqa: F401 - registers
    from paddle_tpu_torch.obs import roofline as tr
    assert tr.registered_kernels() == jr.registered_kernels()
    assert tr.kernel_cost(kernel, **meta) == jr.kernel_cost(kernel, **meta)


def test_body_cost_counts_matmul_flops_and_kernels_as_zero():
    """A body's cost on meta tensors: the products' FLOPs, the aten bytes,
    and a kernel wrapper's plain version opaque (zero), as XLA counts a
    Pallas custom call."""
    from paddle_tpu_torch.obs import roofline as tr
    from paddle_tpu_torch.ops import cuda_kernels as ck

    def body(x, w):
        return torch.relu(x @ w)

    x, w = torch.randn(8, 16), torch.randn(16, 32)
    c = tr.body_cost(body, {"x": x, "w": w})
    assert c.flops == 2 * 8 * 16 * 32
    assert c.bytes >= (8 * 16 + 16 * 32 + 8 * 32) * 4

    def attn(q, k, v):
        return ck.flash_attention_fwd(q, k, v, causal=True)[0]

    q = torch.randn(2, 16, 2, 32)
    assert tr.body_cost(attn, {"q": q, "k": q, "v": q}).flops is None


def test_graph_cache_accounts_each_call_and_replays_counts():
    """GraphCache.run(cost=): the key's cost counted once on meta,
    accounted on every call; a recorded capture's counts re-emitted per replay."""
    from paddle_tpu_torch.core.graphs import GraphCache
    cache = GraphCache("test", "cpu")

    def body(x):
        tobs.count("decode.dispatches_total", route="step")
        return x @ x

    r = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=r).installed():
        for _ in range(3):
            cache.run("b", body, {"x": torch.ones(4, 4)}, cost="test.body")
        assert len(cache.costs) == 1
        assert r.counter("fluid.device_flops_total").get() == 3 * 2 * 64
        assert r.counter("decode.dispatches_total").get(route="step") == 3
        with tobs.recording() as rec:
            body(torch.ones(2, 2))
        assert r.counter("decode.dispatches_total").get(route="step") == 3
        for _ in range(2):
            tobs.replay_counts(rec.events)
        assert r.counter("decode.dispatches_total").get(route="step") == 5


def test_executor_reemits_kernel_bytes_every_run():
    """The fluid executor's LSTM program under a session, the CPU planner
    forced to plan the kernel route (its tiles run the plain version
    here): kernels.bytes_total and the roofline's bytes grow by the
    registered model once a run, and kernels.routes_total says fused."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.obs import roofline as tr
    from paddle_tpu_torch.ops import rnn_kernels as rk
    fluid.reset_default_programs()
    L = fluid.layers
    words = L.data("words", shape=(-1,), dtype="int32")
    lens = L.data("lens", shape=(), dtype="int32")
    emb = L.embedding(words, (20, 8))
    out = L.sequence_last_step(L.dynamic_lstm(emb, lens, 8), lens)
    exe = fluid.Executor(scope=fluid.Scope(), device="cpu")
    exe.run(fluid.default_startup_program())
    feed = {"words": np.ones((4, 5), np.int32),
            "lens": np.full((4,), 5, np.int32)}
    r = tobs.MetricsRegistry()
    with rk.forced_limits(132, 232448), \
            tobs.ObsSession(registry=r).installed():
        for _ in range(3):
            exe.run(feed=feed, fetch_list=[out])
    one = tr.kernel_cost("lstm_sequence_fused", batch=4, seq_len=5,
                         hidden=8, itemsize=4)
    assert r.counter("kernels.bytes_total").get(
        kernel="lstm_sequence_fused") == 3 * one
    assert r.counter("kernels.routes_total").get(
        kernel="lstm_sequence_fused", route="fused") == 3
    assert r.counter("fluid.device_bytes_total").get() >= 3 * one
    assert r.counter("fluid.runs_total").get() == 3
    assert r.counter("fluid.cache_hits_total").get(bucketed="false") == 2


# -- the wire ------------------------------------------------------------------------

def test_master_dispatch_span_parents_under_client_rpc_call():
    """The port's master service: the server's master.dispatch span names
    the client's rpc.call span as its remote parent (the counterpart of
    test_coord_server_span_parents_under_client_rpc_call), the
    per-request-type counters count, and without a session no trace key
    reaches the server."""
    from paddle_tpu_torch.runtime.master_service import (MasterClient,
                                                         MasterServer)
    seen = []
    srv = MasterServer("127.0.0.1", 0)
    orig = srv._dispatch

    def spy(req):
        seen.append(req)
        return orig(req)

    srv._dispatch = spy
    srv.start()
    client = MasterClient(*srv.address)
    r = tobs.MetricsRegistry()
    try:
        client.obs_stats()
        with tobs.ObsSession(registry=r).installed() as s:
            client.obs_stats()
    finally:
        client.close()
        srv.stop()
    assert "trace" not in seen[0] and "trace" in seen[1]
    spans = {e["id"]: e for e in s.dump()["events"] if e["kind"] == "span"}
    disp = next(e for e in spans.values() if e["name"] == "master.dispatch")
    assert spans[disp["remote"]["span"]]["name"] == "rpc.call"
    assert disp["remote"]["id"] == tobs.context.trace_id()
    assert r.counter("master.requests_total").get(type="obs_stats") == 1
    assert r.counter("rpc.calls_total").get(rpc="master rpc",
                                            op="obs_stats") == 1


def test_wire_context_shape_and_sanitize():
    r = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=r).installed() as s:
        with tobs.span("rpc.call") as sp:
            ctx = tobs.wire_context(sp)
        assert ctx == {"id": tobs.context.trace_id(), "span": sp.id,
                       "pid": os.getpid()}
        for bad in (None, 42, "x", {}, {"id": 1},
                    {"id": "a", "span": -1, "pid": 1}):
            with tobs.server_span("master.dispatch", bad, op="t"):
                pass
    spans = [e for e in s.dump()["events"] if e["name"] == "master.dispatch"]
    assert all("remote" not in e for e in spans)


# -- flight recorder -------------------------------------------------------------------

def test_flight_dump_written_at_injected_fault(tmp_path):
    """The armed recorder dumps its ring's tail and the counter deltas
    before an injected raise unwinds, as JAX's does."""
    from paddle_tpu_torch import faults
    path = str(tmp_path / "flight.jsonl")
    r = tobs.MetricsRegistry()
    s = tobs.ObsSession(registry=r)
    plan = faults.FaultPlan().add("reader.next", "raise", nth=1)
    with s.installed():
        rec = tobs.FlightRecorder(s, path, ring_size=8).arm()
        try:
            for i in range(20):
                with tobs.span("trainer.step", batch=i):
                    pass
            with plan.installed():
                with pytest.raises(faults.FaultError):
                    faults.fire("reader.next")
        finally:
            rec.disarm()
    back = tobs.read_jsonl(path)
    assert back["meta"]["flight"] is True
    assert back["meta"]["reason"] == "fault:reader.next"
    steps = [e["args"]["batch"] for e in back["events"]
             if e.get("name") == "trainer.step"]
    assert steps == list(range(12, 20))
    inj = next(m for m in back["metrics"]
               if m["name"] == "faults.injected_total")
    assert inj["labels"] == {"site": "reader.next", "action": "raise"}
    assert not tobs.flight_dump("noop")


# -- lint and surfaces --------------------------------------------------------------------

def test_catalogue_drift_is_clean_and_flags_both_ways(tmp_path):
    from paddle_tpu_torch.analysis import lints
    assert lints.lint_catalogue_drift() == []
    (tmp_path / "m.py").write_text(
        "from paddle_tpu_torch import obs\n"
        "obs.count('serving.bogus_total')\n"
        "obs.count('trainer.steps_total')\n")
    cat = {"trainer.steps_total": ("counter", ""),
           "trainer.orphan_total": ("counter", "")}
    diags = lints.lint_catalogue_drift(root=str(tmp_path), catalogue=cat)
    assert sorted(d.var for d in diags) == ["serving.bogus_total",
                                           "trainer.orphan_total"]


def test_catalogue_is_jaxs_less_the_waiting_modules_with_the_rename():
    """The port's catalogue is JAX's, names and entries, but the compile
    counter's rename and the entries of the modules still to port."""
    want = dict(jobs.CATALOGUE)
    for n in ("jax.compiles_total", "jax.compile_seconds"):
        del want[n]
    got = dict(tobs.CATALOGUE)
    for n in ("graphs.captures_total", "graphs.capture_seconds"):
        assert n in got
        del got[n]
    waiting = set(tobs.catalogue.WAITING)
    assert set(got) == set(want) - waiting
    for n in got:
        assert got[n][0] == want[n][0]
        assert tuple(got[n][2:]) == tuple(want[n][2:])
    assert set(tobs.SPANS) == set(jobs.SPANS) - waiting


def test_alert_rule_lint_equals_jax():
    from paddle_tpu.analysis import lints as jl
    from paddle_tpu.obs.alerts import AlertRule as JRule
    from paddle_tpu_torch.analysis import lints as tl
    from paddle_tpu_torch.obs.alerts import AlertRule as TRule
    spec = [dict(name="a", metric="serving.ttft_seconds", kind="threshold",
                 op=">", value=1.0),
            dict(name="b", metric="nope.metric_total", kind="threshold",
                 op=">", value=1.0),
            dict(name="c", metric="trainer.steps_total", kind="burn_rate",
                 slo_le=0.5, labels={"tenant": "x"})]

    def run(lints, Rule):
        rules = []
        for kw in spec:
            try:
                rules.append(Rule(**kw))
            except (TypeError, ValueError) as e:
                rules.append(type(e).__name__)
        made = [r for r in rules if not isinstance(r, str)]
        return ([r for r in rules if isinstance(r, str)],
                [(d.code, d.var, d.message) for d in lints.lint_alert_rules(
                    rules=made)])

    assert run(tl, TRule) == run(jl, JRule)
    assert tl.lint_alert_rules() == jl.lint_alert_rules() == []


def test_obs_and_utils_surfaces_hold_jaxs_names():
    import paddle_tpu.utils as ju
    import paddle_tpu_torch.utils as tu
    assert set(tobs.__all__) == set(jobs.__all__)
    assert set(tu.__all__) == set(ju.__all__)
    reg = tu.Registry("layer")
    reg.register("x", obj=1)
    with pytest.raises(KeyError, match="registered twice"):
        reg.register("x", obj=2)
    assert reg.get("x") == 1 and "x" in reg


# -- the CLI -------------------------------------------------------------------------------

def _dump_file(tmp_path):
    s = tobs.ObsSession(registry=tobs.MetricsRegistry(),
                        tracer=tobs.Tracer(clock=_fake_clock()),
                        process="p")
    with s.installed():
        _nesting(tobs)
        _labels(tobs)
        led = tobs.ensure_request_ledger()
        for i, ph in enumerate(("admitted", "queued", "prefill",
                                "first_token", "decode", "done")):
            led.phase("k1", ph, dur=0.0 if i == 0 else 0.01 * i)
        d = s.dump()
    d["meta"] = dict(d["meta"], **{k: META[k] for k in
                                   ("trace_id", "created_unix",
                                    "clock_origin_unix", "pid")})
    p = str(tmp_path / "run.jsonl")
    tobs.write_jsonl(p, d)
    return p


@pytest.mark.parametrize("argv", [
    ["obs", "summary", "--input", "{p}"],
    ["obs", "export", "--format", "prom", "--input", "{p}"],
    ["obs", "export", "--format", "chrome", "--input", "{p}"],
    ["obs", "export", "--format", "jsonl", "--input", "{p}"],
    ["obs", "trace", "k1", "--input", "{p}"],
])
def test_cli_obs_prints_what_jax_prints(tmp_path, argv):
    from paddle_tpu import cli as jcli
    from paddle_tpu_torch import cli as tcli
    p = _dump_file(tmp_path)
    argv = [a.format(p=p) for a in argv]
    outs = []
    for main in (jcli.main, tcli.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(argv) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0]


def test_cli_obs_top_once_reads_a_dump(tmp_path, capsys):
    from paddle_tpu_torch import cli as tcli
    p = _dump_file(tmp_path)
    assert tcli.main(["obs", "top", "--once", "--input", p]) == 0
    assert "fleet:" in capsys.readouterr().out


# -- end to end: two passes of a classifier in both packages ------------------------

def _e2e_names(dump):
    spans = {}
    by_id = {e["id"]: e for e in dump["events"] if e["kind"] == "span"}
    for e in by_id.values():
        parent = by_id.get(e["parent"], {}).get("name")
        spans[(e["name"], parent)] = spans.get((e["name"], parent), 0) + 1
    metrics = {m["name"] for m in dump["metrics"]}
    return spans, metrics


def test_two_passes_same_spans_nesting_and_counts_as_jax(tmp_path):
    """A small softmax classifier, two passes of three batches through
    each package's Trainer under a session, with a checkpoint a pass:
    the same span names, parent names and counts, and the same metric
    names, but the compile counter's rename and the roofline counters
    (the port accounts its step's cost on the CPU; JAX's CPU run has no
    peak and no cost ledger difference in names)."""
    import jax.numpy as jnp

    from paddle_tpu.optimizer import SGD as JSGD
    from paddle_tpu.trainer import Trainer as JTrainer
    from paddle_tpu_torch.optimizer import SGD as TSGD
    from paddle_tpu_torch.trainer import Trainer as TTrainer
    rs = np.random.RandomState(0)
    data = [(rs.randn(8, 4).astype(np.float32),
             rs.randint(0, 3, 8).astype(np.int32)) for _ in range(3)]
    w0 = rs.randn(4, 3).astype(np.float32) * 0.1

    def jloss(p, x, y):
        logp = x @ p["w"] - jnp.log(jnp.sum(jnp.exp(x @ p["w"]), -1,
                                            keepdims=True))
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], 1))

    def tloss(p, x, y):
        return torch.nn.functional.cross_entropy(x @ p["w"], y.long())

    out = {}
    for name, o, T, S, loss, conv in (
            ("jax", jobs, JTrainer, JSGD, jloss, jnp.asarray),
            ("torch", tobs, TTrainer, TSGD, tloss, torch.as_tensor)):
        kw = {"device": "cpu"} if name == "torch" else {}
        t = T(loss, S(0.1), output_dir=str(tmp_path / name), **kw)
        r = o.MetricsRegistry()
        with o.ObsSession(registry=r).installed() as s:
            t.train(lambda: iter([(conv(x), conv(y)) for x, y in data]),
                    {"w": conv(w0.copy())}, num_passes=2,
                    handle_signals=False)
        out[name] = _e2e_names(s.dump())
        out[name + "_steps"] = r.counter("trainer.steps_total").get()
        out[name + "_saves"] = r.counter("ckpt.saves_total").get()
    (js, jm), (ts, tm) = out["jax"], out["torch"]
    assert ts == js
    assert out["torch_steps"] == out["jax_steps"] == 6
    assert out["torch_saves"] == out["jax_saves"] == 2
    rename = {"jax.compiles_total": None, "jax.compile_seconds": None}
    jm = {n for n in jm if n not in rename}
    extra = {"fluid.device_flops_total", "fluid.device_bytes_total",
             "graphs.captures_total", "graphs.capture_seconds"}
    assert tm - extra == jm - extra
