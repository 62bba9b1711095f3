"""The port's measured-only graph fusion pass (paddle_tpu_torch/tune/fusion.py
and ``Executor(fuse=...)``) and the bucket_grid consult, against the JAX
package's — the cases of tests/test_fusion.py.

Each program is built with both packages' fluid API and the port runs
from JAX's initial weights (``convert.scope_from_numpy``). Held: the
oracle certifies the same groups in both; a fused run is bit-equal to the
port's unfused run (the same ops in the same order) and equal to JAX's
fetches to 1e-5 (atol and rtol: XLA's CPU matmuls and torch's sum in
different orders); the consult's verdicts and counters are JAX's. The
port's consult reads the port's own cache (``tune.set_cache``), keyed
"cpu" on this host as JAX's is.
"""

import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu import tune as jtune
from paddle_tpu.tune import fusion as JF
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch import tune
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.fluid.executor import Executor, Scope
from paddle_tpu_torch.tune import fusion as F

#: the fetch tolerance against JAX (module docstring)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """Bit-equality across runs needs one CPU thread (MKL's reductions
    are not reproducible across runs on several)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tune_cache():
    c = tune.AutotuneCache()
    tune.set_cache(c)
    yield c
    tune.reset()


class Proxy:
    """The driver's proxy program built by both packages, JAX's startup
    run once; ``jvars`` are its initial weights."""

    def __init__(self, batch=8, width=16, depth=2, seed=0):
        (self.jmain, self.jstart, self.feed,
         self.fetch) = JF.build_proxy_program(batch=batch, width=width,
                                              depth=depth, seed=seed)
        (self.main, self.start, feed,
         fetch) = F.build_proxy_program(batch=batch, width=width,
                                        depth=depth, seed=seed)
        assert fetch == self.fetch
        for k in feed:
            np.testing.assert_array_equal(feed[k], self.feed[k])
        jexe = jfluid.Executor(scope=jfluid.Scope())
        jexe.run(self.jstart)
        self.jvars = {n: np.asarray(v) for n, v in jexe.scope.vars.items()}


def _param_names(program):
    return sorted(n for n, v in program.blocks[0].vars.items()
                  if v.persistable)


def _run_steps(main, jvars, feed, fetch, fuse, *, n=4, donate=None,
               buckets=None):
    """(fetches per step, final persistables) of the port from JAX's
    initial weights."""
    exe = Executor(scope=scope_from_numpy(jvars, "cpu"), fuse=fuse,
                   buckets=buckets, device="cpu")
    outs = [np.asarray(exe.run(main, feed=feed, fetch_list=fetch,
                               donate=donate)[0]) for _ in range(n)]
    params = {p: exe.scope.get(p).detach().numpy().copy()
              for p in _param_names(main) if exe.scope.has(p)}
    return outs, params


def _run_jax(jmain, jvars, feed, fetch, *, n=4, buckets=None):
    exe = jfluid.Executor(scope=jfluid.Scope(), buckets=buckets)
    for k, v in jvars.items():
        exe.scope.set(k, v)
    return [np.asarray(exe.run(jmain, feed=feed, fetch_list=fetch)[0])
            for _ in range(n)]


def _assert_bit_equal(a, b):
    outs_a, params_a = a
    outs_b, params_b = b
    for x, y in zip(outs_a, outs_b):
        assert x.tobytes() == y.tobytes()
    assert params_a.keys() == params_b.keys() and params_a
    for k in params_a:
        assert params_a[k].tobytes() == params_b[k].tobytes(), k


def _assert_jax_close(port_outs, jax_outs):
    assert len(port_outs) == len(jax_outs)
    for p, j in zip(port_outs, jax_outs):
        np.testing.assert_allclose(p, j, **TOL)


def _groups(gs):
    return [(g.kind, tuple(g.op_idxs), tuple(g.inputs), tuple(g.outputs))
            for g in gs]


def _put_measured(cache, program, feed, groups, fuse=True, space_hash=None,
                  mangle_cert=None):
    """Fusion entries for every given certified group of ``program``."""
    prog_sig = F.program_signature(program)
    shp = F.shape_family({k: np.shape(v) for k, v in feed.items()})
    for g in groups:
        cert = F.certificate(program, g)
        fam = F.fusion_family(prog_sig, shp, F.group_signature(cert))
        if mangle_cert is not None:
            cert = mangle_cert(cert)
        cache.put("fusion", g.kind, "cpu", fam, {"fuse": fuse},
                  space_hash or tune.space_hash("fusion"),
                  certificate=cert, program_signature=prog_sig,
                  shape_family=shp, methodology="measured")


def _counter(reg, name):
    return sum(v for _, v in reg.counter(name).samples())


# -- parity ----------------------------------------------------------------

def test_forced_fusion_multi_step_bit_parity():
    p = Proxy()
    groups = F._certified(p.main, list(p.feed), p.fetch)
    assert groups
    assert _groups(groups) == _groups(
        JF._certified(p.jmain, list(p.feed), p.fetch))
    assert F.program_signature(p.main) == JF.program_signature(p.jmain)
    un = _run_steps(p.main, p.jvars, p.feed, p.fetch, False)
    reg = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=reg).installed():
        fu = _run_steps(p.main, p.jvars, p.feed, p.fetch, True)
    # every group ran as a region (one plan decision, memoized)
    assert reg.counter("fluid.fused_regions_total").get(
        source="forced") == len(groups)
    _assert_bit_equal(un, fu)
    one = _run_steps(p.main, p.jvars, p.feed, p.fetch,
                     frozenset({groups[0].op_idxs[0]}))
    _assert_bit_equal(un, one)
    _assert_jax_close(fu[0], _run_jax(p.jmain, p.jvars, p.feed, p.fetch))


def test_forced_fusion_parity_composes_with_donation():
    p = Proxy()
    un = _run_steps(p.main, p.jvars, p.feed, p.fetch, False, donate=True)
    fu = _run_steps(p.main, p.jvars, p.feed, p.fetch, True, donate=True)
    _assert_bit_equal(un, fu)
    _assert_jax_close(fu[0], _run_jax(p.jmain, p.jvars, p.feed, p.fetch))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_randomized_elementwise_chain_parity(seed):
    """Randomized straight-line elementwise programs with bucketing in the
    loop: whatever the oracle certifies (the same groups as JAX's),
    forcing it is bit-invisible, and the fetches are JAX's."""
    def build(fluid):
        rs = np.random.RandomState(seed)
        fluid.reset_default_programs()
        width = int(rs.randint(4, 12))
        x = fluid.layers.data("rx", shape=(width,))
        binops = [fluid.layers.elementwise_add,
                  fluid.layers.elementwise_sub,
                  fluid.layers.elementwise_mul]
        h = fluid.layers.fc(x, width, act="relu")
        for _ in range(int(rs.randint(2, 6))):
            h = binops[rs.randint(len(binops))](h, x)
        loss = fluid.layers.mean(h)
        fluid.SGDOptimizer(1e-2).minimize(loss)
        feed = {"rx": rs.randn(6, width).astype(np.float32)}
        return (fluid.default_main_program(),
                fluid.default_startup_program(), feed, [loss.name])

    jmain, jstart, feed, fetch = build(jfluid)
    jexe = jfluid.Executor(scope=jfluid.Scope())
    jexe.run(jstart)
    jvars = {n: np.asarray(v) for n, v in jexe.scope.vars.items()}
    main, _, _, tfetch = build(tfluid)
    assert tfetch == fetch
    assert _groups(F._certified(main, ["rx"], fetch)) == _groups(
        JF._certified(jmain, ["rx"], fetch))
    buckets = {"rx": {"axis": 0, "buckets": (8, 16)}}
    un = _run_steps(main, jvars, feed, fetch, False, buckets=buckets)
    fu = _run_steps(main, jvars, feed, fetch, True, buckets=buckets)
    _assert_bit_equal(un, fu)
    _assert_jax_close(fu[0], _run_jax(jmain, jvars, feed, fetch,
                                      buckets=buckets))


# -- the measured-only gate --------------------------------------------------

def test_no_entry_means_no_fusion(tune_cache):
    p = Proxy()
    plan = F.plan_for(p.main, {k: v.shape for k, v in p.feed.items()},
                      fetch=p.fetch, feed=list(p.feed))
    assert not F.cache_has_fusion_entries("cpu")
    assert plan.groups == []
    reg = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=reg).installed():
        _run_steps(p.main, p.jvars, p.feed, p.fetch, None, n=1)
    assert _counter(reg, "fluid.fused_regions_total") == 0
    assert _counter(reg, "fluid.fusion_rejected_total") == 0


def test_measured_winner_activates_with_counters(tune_cache):
    p = Proxy()
    groups = F._certified(p.main, list(p.feed), p.fetch)
    _put_measured(tune_cache, p.main, p.feed, groups, fuse=True)
    assert F.cache_has_fusion_entries("cpu")
    reg = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=reg).installed():
        un = _run_steps(p.main, p.jvars, p.feed, p.fetch, False)
        fu = _run_steps(p.main, p.jvars, p.feed, p.fetch, None)
    _assert_bit_equal(un, fu)
    assert _counter(reg, "fluid.fused_regions_total") == len(groups)
    assert reg.counter("fluid.fused_regions_total").get(
        source="tuned") == len(groups)
    assert _counter(reg, "fluid.fusion_rejected_total") == 0


def test_measured_loser_refuses_measured_slower(tune_cache):
    p = Proxy()
    groups = F._certified(p.main, list(p.feed), p.fetch)
    _put_measured(tune_cache, p.main, p.feed, groups, fuse=False)
    plan = F.plan_for(p.main, {k: v.shape for k, v in p.feed.items()},
                      fetch=p.fetch, feed=list(p.feed))
    assert plan.groups == []
    assert {r for _, r in plan.rejected} == {"measured_slower"}
    assert len(plan.rejected) == len(groups)


def test_stale_space_hash_refused(tune_cache):
    """A stale hash refuses — JAX's own fusion hash included: an entry
    JAX's tuner wrote is stale here."""
    p = Proxy()
    groups = F._certified(p.main, list(p.feed), p.fetch)
    for stale in ("deadbeef0000", jtune.space_hash("fusion")):
        tune_cache.entries.clear()
        _put_measured(tune_cache, p.main, p.feed, groups, fuse=True,
                      space_hash=stale)
        plan = F.plan_for(p.main, {k: v.shape for k, v in p.feed.items()},
                          fetch=p.fetch, feed=list(p.feed))
        assert plan.groups == []
        assert {r for _, r in plan.rejected} == {"stale"}


def test_tampered_certificate_refused(tune_cache):
    p = Proxy()
    groups = F._certified(p.main, list(p.feed), p.fetch)

    def swap_an_op(cert):
        cert = dict(cert, op_types=list(cert["op_types"]))
        cert["op_types"][0] = "matmul"
        return cert

    _put_measured(tune_cache, p.main, p.feed, groups, fuse=True,
                  mangle_cert=swap_an_op)
    plan = F.plan_for(p.main, {k: v.shape for k, v in p.feed.items()},
                      fetch=p.fetch, feed=list(p.feed))
    assert plan.groups == []
    assert {r for _, r in plan.rejected} == {"cert_invalid"}


def test_unschedulable_interleaved_producer_refused():
    """a = relu(x); b = x * w; c = a + b: a group straddling b's producer
    is refused, forced or not, in both packages alike."""
    from paddle_tpu.analysis.dataflow import fusable_groups as jgroups
    from paddle_tpu_torch.analysis import region_schedulable
    from paddle_tpu_torch.analysis.dataflow import fusable_groups

    def build(fluid):
        fluid.reset_default_programs()
        x = fluid.layers.data("ux", shape=(4,))
        w = fluid.layers.data("uw", shape=(4,))
        a = fluid.layers.activation(x, "relu")
        b = fluid.layers.elementwise_mul(x, w)
        c = fluid.layers.elementwise_add(a, b)
        out = fluid.layers.mean(c)
        return fluid.default_main_program(), out.name

    jmain, jout = build(jfluid)
    main, out = build(tfluid)
    groups = fusable_groups(main, fetch=[out], feed=["ux", "uw"])
    assert _groups(groups) == _groups(jgroups(jmain, fetch=[jout],
                                              feed=["ux", "uw"]))
    block = main.blocks[0]
    for g in groups:
        if g.op_idxs[-1] - g.op_idxs[0] + 1 > len(g.op_idxs):
            assert not region_schedulable(block, g)
    plan = F.plan_for(main, {"ux": (2, 4), "uw": (2, 4)}, fetch=[out],
                      feed=["ux", "uw"], force=True)
    jplan = JF.plan_for(jmain, {"ux": (2, 4), "uw": (2, 4)}, fetch=[jout],
                        feed=["ux", "uw"], force=True)
    assert _groups(plan.groups) == _groups(jplan.groups)
    for g in plan.groups:
        assert g.op_idxs[-1] - g.op_idxs[0] + 1 == len(g.op_idxs)
    feed = {"ux": np.arange(8, dtype=np.float32).reshape(2, 4) - 3,
            "uw": np.full((2, 4), 0.5, np.float32)}
    got = Executor(scope=Scope(), fuse=True, device="cpu").run(
        main, feed=feed, fetch_list=[out])
    want = jfluid.Executor(scope=jfluid.Scope()).run(jmain, feed=feed,
                                                    fetch_list=[jout])
    np.testing.assert_allclose(got[0], np.asarray(want[0]), **TOL)


def test_fused_flops_equal_unfused():
    """A fused region runs inside the block's one graph, so the roofline
    ledger's counted FLOPs are the unfused run's; and the region runs
    under its one site range, JAX's tag ``b0_op{first}_fused_<kind>``."""
    p = Proxy()

    def flops(fuse):
        reg = tobs.MetricsRegistry()
        with tobs.ObsSession(registry=reg).installed():
            _run_steps(p.main, p.jvars, p.feed, p.fetch, fuse, n=2)
        return _counter(reg, "fluid.device_flops_total")

    f_un, f_fu = flops(False), flops(True)
    assert f_un > 0
    assert f_un == f_fu
    from torch.profiler import ProfilerActivity, profile
    groups = F._certified(p.main, list(p.feed), p.fetch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_steps(p.main, p.jvars, p.feed, p.fetch, True, n=1)
    names = {e.name for e in prof.events()}
    for g in groups:
        assert f"b0_op{g.op_idxs[0]}_fused_{g.kind}" in names, names
        for i in g.op_idxs[1:]:
            assert not any(n.startswith(f"b0_op{i}_") for n in names)


def test_measure_fusion_rows_and_e2e_consult(tune_cache):
    p = Proxy()
    rows = F.measure_fusion(p.main, p.start, p.feed, p.fetch, reps=1,
                            note="t", device="cpu")
    assert len(rows) == len(JF._certified(p.jmain, list(p.feed), p.fetch))
    for r in rows:
        assert r["space"] == "fusion"
        assert isinstance(r["plan"]["fuse"], bool)
        assert r["heuristic_plan"] == {"fuse": False}
        assert r["fused_ms"] > 0 and r["unfused_ms"] > 0
        assert r["certificate"]["op_types"]
        assert r["family"].split(":")[2] == F.group_signature(
            r["certificate"])
        # the certificate and its signature are JAX's: the same program
        assert r["family"].split(":")[2] == JF.group_signature(
            r["certificate"])
        tune_cache.put(r["space"], r["kernel"], "cpu", r["family"],
                       r["plan"], tune.space_hash("fusion"),
                       certificate=r["certificate"],
                       program_signature=r["program_signature"],
                       shape_family=r["shape_family"])
    plan = F.plan_for(p.main, {k: v.shape for k, v in p.feed.items()},
                      fetch=p.fetch, feed=list(p.feed))
    wins = sum(1 for r in rows if r["plan"]["fuse"])
    assert len(plan.groups) == wins
    assert len(plan.rejected) == len(rows) - wins
    assert all(reason == "measured_slower" for _, reason in plan.rejected)


# -- bucket_grid ---------------------------------------------------------------

def _put_grid(cache, kind, buckets, space_hash=None):
    cache.put("bucket_grid", "prefill_dispatch", "cpu", kind,
              {"buckets": list(buckets)},
              space_hash or tune.space_hash("bucket_grid"),
              methodology="measured")


def test_bucket_grid_consult_validation(tune_cache):
    """Every verdict of JAX's consult, on the same grids."""
    jc = jtune.AutotuneCache()
    jtune.set_cache(jc)
    try:
        def both(kind, buckets, stale=False, **kw):
            _put_grid(tune_cache, kind, buckets,
                      "0ld" if stale else None)
            jc.put("bucket_grid", "prefill_dispatch", "cpu", kind,
                   {"buckets": list(buckets)},
                   "0ld" if stale else jtune.space_hash("bucket_grid"))
            return tune.bucket_grid(kind, **kw), jtune.bucket_grid(kind,
                                                                    **kw)

        assert tune.bucket_grid("prompt") is None
        for kw in ({}, {"max_len": 128}, {"max_len": 16}, {"divisor": 64},
                   {"divisor": 32}):
            got, want = both("prompt", [32, 64, 256], **kw)
            assert got == want
        assert both("prompt", [32, 64, 256])[0] == (32, 64, 256)
        assert both("prompt", [32, 64, 256], max_len=128)[0] == (32, 64)
        for grid in ([64, 32], [], [0, 32]):
            assert both("cache", grid) == (None, None)
        assert both("cache", [128, 256], stale=True) == (None, None)
    finally:
        jtune.reset()


def test_pagepool_and_bucketspec_consult(tune_cache):
    from paddle_tpu_torch.data.feeder import BucketSpec
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.serving import PagePool
    model = TransformerLM(97, d_model=32, n_heads=4, n_layers=2,
                          max_len=128).init(0, "cpu")
    pool = PagePool(model, slots=2, device="cpu")
    assert pool.cache_bucket == 256
    assert tuple(pool.prompt_buckets) == (32, 64, 128, 256, 512)
    assert BucketSpec({"words": "tuned"}).spec["words"][1] == \
        (32, 64, 128, 256, 512)
    _put_grid(tune_cache, "prompt", [32, 64, 128, 512])
    _put_grid(tune_cache, "cache", [64, 128])
    pool = PagePool(model, slots=2, device="cpu")
    assert tuple(pool.prompt_buckets) == (32, 64, 128)
    assert pool.cache_bucket == 128
    assert BucketSpec({"words": "tuned"}).spec["words"][1] \
        == (32, 64, 128, 512)
    pool = PagePool(model, slots=2, cache_bucket=64,
                    prompt_buckets=(16, 32), device="cpu")
    assert pool.cache_bucket == 64
    assert tuple(pool.prompt_buckets) == (16, 32)


# -- lint and the seeded sweep ---------------------------------------------------

def test_l008_fusion_and_bucket_grid_findings(tmp_path, tune_cache):
    """L008's fusion and bucket_grid findings, message for message JAX's
    on the same (hash-adjusted) caches."""
    from paddle_tpu.analysis import lint_autotune_cache as jlint
    from paddle_tpu_torch.analysis import lint_autotune_cache
    p = Proxy()
    groups = F._certified(p.main, list(p.feed), p.fetch)
    _put_measured(tune_cache, p.main, p.feed, groups, fuse=True)
    _put_grid(tune_cache, "prompt", [32, 64])
    assert lint_autotune_cache(tune_cache.save(
        str(tmp_path / "ok.json"))) == []

    def mangle(cert):
        return dict(cert, op_types=["matmul"] + list(cert["op_types"])[1:])

    c2 = tune.AutotuneCache()
    _put_measured(c2, p.main, p.feed, groups[:1], fuse=True,
                  mangle_cert=mangle)
    diags = lint_autotune_cache(c2.save(str(tmp_path / "cert.json")))
    assert len(diags) == 1 and diags[0].code == "L008"
    assert "does not re-derive" in diags[0].message

    def bad(pkg, path):
        c = pkg.AutotuneCache()
        c.put("fusion", "elementwise_chain", "cpu", "a:b:c",
              {"fuse": True}, pkg.space_hash("fusion"))
        c.put("fusion", "elementwise_chain", "cpu", "a:b:d",
              {"fuse": "yes"}, pkg.space_hash("fusion"),
              certificate={"kind": "elementwise_chain"})
        c.put("bucket_grid", "prefill_dispatch", "cpu", "prompt",
              {"buckets": [64, 32]}, pkg.space_hash("bucket_grid"))
        return c.save(str(path))

    got = lint_autotune_cache(bad(tune, tmp_path / "bad.json"))
    want = jlint(bad(jtune, tmp_path / "jbad.json"))
    assert len(got) == 3
    assert [(d.code, d.severity.name, d.message, d.hint) for d in got] == \
        [(d.code, d.severity.name, d.message, d.hint) for d in want]


def test_tune_from_ledger_seeds_the_sweep(tmp_path):
    """``run_tune(from_ledger=...)``: profile sites seed the sweep (only
    the implicated spaces run, as JAX's picks them), the seeded families
    count on the obs plane, and the measured loop closes: persisted,
    reloaded and consulted."""
    from paddle_tpu.tune.driver import _ledger_seeding as jseed
    from paddle_tpu_torch.tune.driver import _ledger_seeding
    sites = [{"op": "b0_op5_fused_elementwise_chain", "self_ns": 900000},
             {"op": "b0_op9_paged_decode_attention", "self_ns": 400000},
             {"op": "b0_op2_layer_norm", "self_ns": 10}]
    assert _ledger_seeding(sites)[0] == jseed(sites)[0] == \
        ["fusion", "page_block"]
    ledger = tmp_path / "sites.json"
    ledger.write_text(json.dumps(sites))
    path = str(tmp_path / "autotune.json")
    reg = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=reg).installed():
        rep = tune.run_tune(profile="smoke", cache_path=path,
                            from_ledger=str(ledger), device="cpu")
    assert rep["ledger"]["seeded_spaces"] == ["fusion", "page_block"]
    cache = tune.load_cache(path)
    assert {e["space"] for e in cache.entries.values()} == \
        {"fusion", "page_block"}
    assert _counter(reg, "tune.ledger_seeded_families_total") > 0
    assert _counter(reg, "tune.measurements_total") > 0
    for e in cache.entries.values():
        assert e["methodology"] == "measured"
        if e["space"] == "fusion":
            assert isinstance(e["certificate"], dict)
            assert e["program_signature"]
            assert isinstance(e["plan"]["fuse"], bool)
    tune.reset()
    tune.set_cache(tune.load_cache(path))
    try:
        bs = cache.get("page_block", "paged_decode_attention", "cpu",
                       "default")["plan"]["page_block"]
        assert tune.page_block(128 * bs, bs) == bs
    finally:
        tune.reset()
