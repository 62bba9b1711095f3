"""The port's measured autotuning plane (paddle_tpu_torch/tune and the
routing consults) against the JAX package's — the cases of
tests/test_autotune.py, with the port's plan spaces, and the separation
of the two packages' caches.

The port's consults: ``ops.rnn_kernels.route_for`` (a row tile of
#8-#12, re-checked for residency), ``ops.cuda_kernels.decode_splits``
(the split count of #4-#7), ``serving.PagePool`` (page_block and the
bucket grids) and ``BucketSpec("tuned")``. On the CPU the recurrences
are planned only under ``rnn_kernels.forced_limits``, where each row
tile runs the kernels' plain versions. Tolerances: a forward under any
row tile is bit-equal to the untiled one (rows are independent); the
backward's dU partials are summed in tile order, so gradients are held
to 2e-5 (absolute and relative, as tests/test_torch_rnn_routes.py), and
against JAX's fused LSTM (its scan on the CPU) to the same.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import tune as jtune
from paddle_tpu.ops import rnn as JR
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch import tune
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.ops import rnn_kernels as rk

VOCAB, D, H, L, MAX_LEN = 97, 32, 4, 2, 128
GRAD_TOL = 2e-5
#: one SM of an H100's shared memory: at hidden width 8 the forward takes
#: B <= 64 and the backward B <= 32 (tests/test_torch_rnn_routes.py)
BIG = (1, 232448)


@pytest.fixture(autouse=True)
def _one_thread():
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


def _put_fused(cache, kernel, plan, *, gates, T, H_, batch, stale=False):
    return cache.put(
        "fused_rnn", kernel, "cpu",
        tune.fused_family(gates=gates, T=T, H=H_, batch=batch), plan,
        "deadbeef" if stale else tune.space_hash("fused_rnn"),
        methodology="measured")


def _route(name, B, T, H_):
    xw = torch.zeros(B, T, 4 * H_)
    return rk.route_for(name, xw, H_)


# -- cache mechanics ---------------------------------------------------------

def test_cache_roundtrip_env_and_schema(tmp_path, monkeypatch):
    c = tune.AutotuneCache()
    c.put("decode_route", "decode_attention", "cpu", "default",
          {"kernel_min_len": 1, "splits": {"96x256": 4}},
          tune.space_hash("decode_route"), methodology="measured",
          tuned_ms=1.0)
    path = c.save(str(tmp_path / "autotune.json"))
    loaded = tune.load_cache(path)
    e = loaded.get("decode_route", "decode_attention", "cpu", "default")
    assert e is not None and e["plan"]["kernel_min_len"] == 1
    assert e["methodology"] == "measured"
    # the file is JAX's schema: JAX's loader reads it as it wrote it
    assert jtune.load_cache(path).to_dict() == loaded.to_dict()
    monkeypatch.setenv(tune.CACHE_ENV, path)
    tune.reset()
    try:
        assert tune.decode_kernel_min_len() == 1
        assert tune._decode_splits(96, 256) == 4
        assert ck.decode_splits(96, 256) == (4, 64)
        assert tune.plan_source() == "tuned"
    finally:
        tune.reset()
    bad = dict(c.to_dict(), schema_version=99)
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(ValueError, match="schema_version"):
        tune.load_cache(str(tmp_path / "bad.json"))
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "bad.json"))
    tune.reset()
    try:
        with pytest.warns(RuntimeWarning, match="autotune cache"):
            assert tune.decode_kernel_min_len() is tune.MISS
    finally:
        tune.reset()


def test_consult_rejects_stale_and_illegal_entries(tune_cache):
    with rk.forced_limits(*BIG):
        heur = _route("lstm_seq_bwd", 64, 32, 8)
        assert heur.kind == "tiles"           # B 64 > the backward's 32
        _put_fused(tune_cache, "lstm_seq_bwd", 8, gates=4, T=32, H_=8,
                   batch=64, stale=True)
        assert _route("lstm_seq_bwd", 64, 32, 8) == heur
        # illegal: "whole" is not resident for the backward at B 64, nor
        # is a 64-row tile; malformed plans never raise
        for bad in ("whole", 64, 0, -8, True, [8, 8], "huge", None):
            _put_fused(tune_cache, "lstm_seq_bwd", bad, gates=4, T=32,
                       H_=8, batch=64)
            assert _route("lstm_seq_bwd", 64, 32, 8) == heur, bad
    tune_cache.put("page_block", "paged_decode_attention", "cpu",
                   "default", {"page_block": "huge"},
                   tune.space_hash("page_block"))
    assert tune.page_block(128, 32) is None
    tune_cache.put("decode_route", "decode_attention", "cpu", "default",
                   {"wrong_key": 1}, tune.space_hash("decode_route"))
    assert tune.decode_kernel_min_len() is tune.MISS
    assert tune._decode_splits(96, 256) is None
    tune_cache.put("decode_route", "decode_attention", "cpu", "default",
                   {"kernel_min_len": 1, "splits": {"4x64": 65}},
                   tune.space_hash("decode_route"))
    assert tune._decode_splits(4, 64) is None       # more chunks than rows
    # JAX's consult refuses the same malformed entries
    jc = jtune.AutotuneCache()
    jtune.set_cache(jc)
    try:
        jc.put("page_block", "paged_decode_attention", "cpu", "default",
               {"page_block": "huge"}, jtune.space_hash("page_block"))
        jc.put("decode_route", "decode_attention", "cpu", "default",
               {"wrong_key": 1}, jtune.space_hash("decode_route"))
        assert jtune.page_block(128, 32) is None
        assert jtune.decode_kernel_min_len() is jtune.MISS
    finally:
        jtune.reset()


def test_fused_plan_consult_swaps_plan(tune_cache):
    with rk.forced_limits(*BIG):
        heur = _route("lstm_seq_train", 32, 16, 8)
        assert heur.kind == "whole"
        cands = tune.fused_candidates(T=16, H=8, gates=4, batch=32,
                                      kernel="lstm_seq_train", limits=BIG)
        assert cands[0] == "whole" and 8 in cands and 16 in cands
        _put_fused(tune_cache, "lstm_seq_train", 8, gates=4, T=16, H_=8,
                   batch=32)
        got = _route("lstm_seq_train", 32, 16, 8)
        assert got.kind == "tiles" and [n for _, n in got.tiles] == [8] * 4
        assert got == rk.tile_route("lstm_seq_train", 32, 8, 8,
                                    torch.float32, *BIG)
        # another family (batch 16, or another T) misses
        assert _route("lstm_seq_train", 16, 16, 8) == \
            rk.plan_route("lstm_seq_train", 16, 8, torch.float32, *BIG)
        assert _route("lstm_seq_train", 32, 17, 8) == heur
        # the GRU's kernels are their own keys
        assert tune.fused_plan("gru_seq", T=16, H=8, gates=3, batch=32,
                               limits=BIG) is None
    # no forced limits on the CPU: unplanned, whatever the cache holds
    assert _route("lstm_seq_train", 32, 16, 8) is None


# -- the parity property ---------------------------------------------------------

def test_tuned_fused_plans_change_speed_never_outputs(tune_cache):
    """Forward and backward of the fused LSTM under a tuned row tile (the
    forward's and the backward's entries) against the heuristic route:
    the forward bit for bit, the gradients to GRAD_TOL; both against
    JAX's ``_lstm_fused`` (module docstring)."""
    T, B, H_ = 12, 16, 8
    rs = np.random.RandomState(0)
    x = rs.randn(B, T, 5).astype(np.float32) * 0.3
    lens = rs.randint(1, T + 1, B).astype(np.int32)
    w = rs.randn(5, 4 * H_).astype(np.float32) * 0.3
    u = rs.randn(H_, 4 * H_).astype(np.float32) * 0.3
    b = rs.randn(4 * H_).astype(np.float32) * 0.3
    h0 = np.zeros((B, H_), np.float32)
    g_out = rs.randn(B, T, H_).astype(np.float32)

    def run():
        args = [torch.tensor(a, requires_grad=True) for a in (x, w, u, b)]
        out, st = R.lstm(args[0], torch.tensor(lens), *args[1:],
                         torch.tensor(h0), torch.tensor(h0),
                         forget_bias=0.5)
        loss = (out * torch.tensor(g_out)).sum() + st.h.sum() \
            + 2.0 * st.c.sum()
        grads = torch.autograd.grad(loss, args)
        return [out, st.h, st.c], grads

    with rk.forced_limits(*BIG):
        heur = (_route("lstm_seq_train", B, T, H_),
                _route("lstm_seq_bwd", B, T, H_))
        assert heur[0].kind == heur[1].kind == "whole"
        out_h, g_h = run()
        _put_fused(tune_cache, "lstm_seq_train", 8, gates=4, T=T, H_=H_,
                   batch=B)
        _put_fused(tune_cache, "lstm_seq_bwd", 4, gates=4, T=T, H_=H_,
                   batch=B)
        assert _route("lstm_seq_train", B, T, H_).kind == "tiles"
        assert _route("lstm_seq_bwd", B, T, H_).kind == "tiles"
        before = dict(ck.ROUTES)
        out_t, g_t = run()
        tiled = {k: v - before.get(k, 0) for k, v in ck.ROUTES.items()}
        assert tiled.get(("lstm_seq_train", "tiles"), 0) >= 1
        assert tiled.get(("lstm_seq_bwd", "tiles"), 0) >= 1
    for a, bb in zip(out_t, out_h):
        assert torch.equal(a.detach(), bb.detach())
    for a, bb in zip(g_t, g_h):
        np.testing.assert_allclose(a.numpy(), bb.numpy(), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)

    def jrun(x, w, u, b):
        out, ht, ct = JR._lstm_fused(x, jnp.asarray(lens), w, u, b,
                                     jnp.asarray(h0), jnp.asarray(h0), 0.5,
                                     8, T)
        return (out, ht, ct)

    jout = jrun(*map(jnp.asarray, (x, w, u, b)))
    jloss = lambda *a: (jnp.sum(jrun(*a)[0] * g_out) + jnp.sum(jrun(*a)[1])
                        + 2.0 * jnp.sum(jrun(*a)[2]))
    jg = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                     (x, w, u, b)))
    for a, j in zip(out_t, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(j),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)
    for a, j in zip(g_t, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)


def test_tuned_decode_splits_greedy_token_parity(tune_cache,
                                                 paged_model_and_params):
    """An injected decode_route entry (a split count for every read of the
    decode) is consulted by ``decode_splits``, and the greedy stream
    through it equals the untuned stream and JAX's token for token (the
    CPU reads take the plain version whatever the count: the count
    changes how a card's read is split, never what it computes)."""
    from paddle_tpu_torch.convert import params_from_numpy
    from paddle_tpu_torch.models import TransformerLM
    jmodel, jparams = paged_model_and_params
    rs = np.random.RandomState(11)
    prompt = rs.randint(0, VOCAB, 7)
    want = np.asarray(jmodel.generate_cached(
        jparams, jnp.asarray(prompt[None]), steps=12))
    model = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams),
        TransformerLM(VOCAB, d_model=D, n_heads=H, n_layers=L,
                      max_len=MAX_LEN), "cpu")
    base = model.generate_cached(torch.tensor(prompt[None]), steps=12)
    np.testing.assert_array_equal(base.numpy(), want)
    bh = 1 * H
    heur = ck.decode_splits(bh, MAX_LEN)
    tune_cache.put("decode_route", "decode_attention", "cpu", "default",
                   {"kernel_min_len": None,
                    "splits": {f"{bh}x{MAX_LEN}": 8}},
                   tune.space_hash("decode_route"), methodology="measured")
    assert ck.decode_splits(bh, MAX_LEN) == (8, 16) != heur
    assert tune.decode_kernel_min_len() is None
    got = model.generate_cached(torch.tensor(prompt[None]), steps=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tuned_page_block_consult(tune_cache, paged_model_and_params):
    """PagePool(page_block=None) consults as JAX's pool does, verdict for
    verdict on the same entries."""
    from paddle_tpu.serving import PagePool as JPool
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.serving import PagePool
    jmodel, jparams = paged_model_and_params
    model = TransformerLM(VOCAB, d_model=D, n_heads=H, n_layers=L,
                          max_len=MAX_LEN).init(0, "cpu")
    jc = jtune.AutotuneCache()

    def both(**kw):
        jtune.set_cache(jc)
        try:
            want = JPool(jmodel, jparams, slots=2, **kw).bs
        finally:
            jtune.reset()
        return PagePool(model, slots=2, device="cpu", **kw).bs, want

    assert both(cache_bucket=128) == (64, 64)
    for bs, want in ((32, 32), (48, 64)):
        tune_cache.put("page_block", "paged_decode_attention", "cpu",
                       "default", {"page_block": bs},
                       tune.space_hash("page_block"), methodology="measured")
        jc.put("page_block", "paged_decode_attention", "cpu", "default",
               {"page_block": bs}, jtune.space_hash("page_block"))
        assert both(cache_bucket=128) == (want, want)
    assert both(page_block=8, cache_bucket=32) == (8, 8)


# -- lint and the sweep ------------------------------------------------------------

def test_lint_autotune_staleness_l008(tmp_path):
    """L008 over the port's cache, finding for finding JAX's over JAX's
    (the messages differ only in the spaces' hashes and the paths)."""
    from paddle_tpu.analysis import lint_autotune_cache as jlint
    from paddle_tpu_torch.analysis import lint_autotune_cache

    def scenario(pkg, lint, d):
        d.mkdir()
        out = [lint(str(d / "none.json"))]
        c = pkg.AutotuneCache()
        c.put("fused_rnn", "lstm_seq", "cpu", "g4_t8_h8_b8", "whole",
              pkg.space_hash("fused_rnn"))
        out.append(lint(c.save(str(d / "fresh.json"))))
        c.put("fused_rnn", "gru_seq", "cpu", "g3_t8_h8_b8", 8,
              "0ld5pacehash")
        out.append(lint(c.save(str(d / "stale.json"))))
        c2 = pkg.AutotuneCache()
        c2.put("warp_drive", "k", "cpu", "f", [1], "x")
        out.append(lint(c2.save(str(d / "unk.json"))))
        (d / "old.json").write_text(
            json.dumps({"schema_version": 0, "entries": {}}))
        out.append(lint(str(d / "old.json")))
        return out

    got = scenario(tune, lint_autotune_cache, tmp_path / "t")
    want = scenario(jtune, jlint, tmp_path / "j")
    assert got[0] == got[1] == [] == want[0] == want[1]
    assert len(got[2]) == 1 and got[2][0].code == "L008"
    assert "STALE" in got[2][0].message
    assert "unknown plan space" in got[3][0].message
    assert "schema_version" in got[4][0].message

    def norm(diags, root, pkg):
        out = []
        for d in diags:
            m = d.message.replace(str(root), "ROOT")
            for s in pkg.SPACE_NAMES:
                m = m.replace(pkg.space_hash(s), "HASH")
            m = m.replace(str(list(pkg.SPACE_NAMES)), "SPACES")
            out.append((d.code, d.severity.name, d.var, m, d.hint))
        return out

    for g, w in zip(got[2:], want[2:]):
        assert norm(g, tmp_path / "t", tune) == norm(w, tmp_path / "j",
                                                     jtune)


def test_tune_check_loop_smoke(tmp_path):
    """The whole loop on the CPU (JAX's ``tune --check``): a smoke sweep
    of every space, persisted, reloaded and consulted through the real
    entry points, clean under L008; JAX's lint finds every entry stale
    (the port's spaces hash apart) and the markdown table renders."""
    from paddle_tpu.analysis import lint_autotune_cache as jlint
    from paddle_tpu_torch.analysis import lint_autotune_cache
    from paddle_tpu_torch.data.feeder import BucketSpec
    path = str(tmp_path / "autotune.json")
    reg = tobs.MetricsRegistry()
    with tobs.ObsSession(registry=reg).installed():
        rep = tune.run_tune(profile="smoke", cache_path=path, device="cpu")
    assert rep["backend"] == "plain" and rep["device_kind"] == "cpu"
    cache = tune.load_cache(path)
    spaces = {e["space"] for e in cache.entries.values()}
    assert spaces == set(tune.SPACE_NAMES)
    for e in cache.entries.values():
        assert e["methodology"] == "measured"
        assert e["space_hash"] == tune.space_hash(e["space"])
    assert reg.counter("tune.measurements_total").get(
        space="fused_rnn") > 0
    assert lint_autotune_cache(path) == []
    assert len(jlint(path)) == len(cache.entries)
    assert all("STALE" in d.message for d in jlint(path))
    tune.set_cache(tune.load_cache(path))
    try:
        assert tune.plan_source() == "tuned"
        fam = next(e for e in cache.entries.values()
                   if e["space"] == "fused_rnn")
        with rk.forced_limits(*rk.H100):
            got = tune.fused_plan(fam["kernel"], T=8, H=8, gates=4,
                                  batch=16, limits=rk.H100)
        assert got == tune.spaces.route_of(fam["plan"], kernel=fam["kernel"],
                                           H=8, batch=16)
        bs = cache.get("page_block", "paged_decode_attention", "cpu",
                       "default")["plan"]["page_block"]
        assert tune.page_block(4 * bs, bs) == bs
        grid = cache.get("bucket_grid", "prefill_dispatch", "cpu",
                         "prompt")["plan"]["buckets"]
        assert BucketSpec({"w": "tuned"}).spec["w"][1] == tuple(grid)
        splits = cache.get("decode_route", "decode_attention", "cpu",
                           "default")["plan"]["splits"]
        key, n = next(iter(splits.items()))
        bh, Lr = map(int, key.split("x"))
        assert ck.decode_splits(bh, Lr)[0] == n
    finally:
        tune.reset()
    md = tune.results_markdown(rep)
    assert "| space | kernel |" in md and "page_block" in md


def test_plan_source_stamp(tune_cache):
    assert tune.plan_source() == "heuristic"
    tune_cache.put("decode_route", "decode_attention", "cpu", "default",
                   {"kernel_min_len": None},
                   tune.space_hash("decode_route"))
    assert tune.plan_source() == "tuned"
    stale = tune.AutotuneCache()
    stale.put("decode_route", "decode_attention", "cpu", "default",
              {"kernel_min_len": None}, "0ld")
    tune.set_cache(stale)
    assert tune.plan_source() == "heuristic"


# -- the two packages' caches --------------------------------------------------------

def test_a_jax_written_cache_never_steers_the_port(tmp_path, monkeypatch,
                                                   paged_model_and_params):
    """A cache JAX's tuner would write (JAX's hashes, keyed "cpu" as the
    port's are here) is never consulted by the port: not through JAX's
    environment variable (the port reads its own file) and not when the
    port is pointed at it (every space of the port hashes apart, so each
    entry is stale). JAX's own consult takes the same file."""
    from paddle_tpu.serving import PagePool as JPool
    from paddle_tpu_torch.data.feeder import BucketSpec
    from paddle_tpu_torch.models import TransformerLM
    from paddle_tpu_torch.serving import PagePool
    assert tune.CACHE_ENV != jtune.CACHE_ENV
    for s in tune.SPACE_NAMES:
        assert tune.space_hash(s) != jtune.space_hash(s)
    jc = jtune.AutotuneCache()
    jc.put("page_block", "paged_decode_attention", "cpu", "default",
           {"page_block": 32}, jtune.space_hash("page_block"))
    jc.put("decode_route", "decode_attention", "cpu", "default",
           {"kernel_min_len": 1, "splits": {"4x128": 8}},
           jtune.space_hash("decode_route"))
    jc.put("bucket_grid", "prefill_dispatch", "cpu", "prompt",
           {"buckets": [64, 128]}, jtune.space_hash("bucket_grid"))
    jc.put("fused_rnn", "lstm_seq_train", "cpu",
           tune.fused_family(gates=4, T=16, H=8, batch=32), 8,
           jtune.space_hash("fused_rnn"))
    path = jc.save(str(tmp_path / "jax.json"))
    jmodel, jparams = paged_model_and_params
    model = TransformerLM(VOCAB, d_model=D, n_heads=H, n_layers=L,
                          max_len=MAX_LEN).init(0, "cpu")
    heur_splits = ck.decode_splits(4, 128)

    def port_untouched():
        tune.reset()
        assert tune.plan_source() == "heuristic"
        assert tune.page_block(128, 128) is None
        assert PagePool(model, slots=2, cache_bucket=128,
                        device="cpu").bs == 64
        assert tune.decode_kernel_min_len() is tune.MISS
        assert ck.decode_splits(4, 128) == heur_splits
        assert tune.bucket_grid("prompt") is None
        assert BucketSpec({"w": "tuned"}).spec["w"][1] == \
            (32, 64, 128, 256, 512)
        with rk.forced_limits(*BIG):
            assert _route("lstm_seq_train", 32, 16, 8).kind == "whole"

    # JAX's variable names the file: JAX's consult takes it, the port's
    # does not read it
    monkeypatch.setenv(jtune.CACHE_ENV, path)
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "none.json"))
    jtune.reset()
    try:
        assert JPool(jmodel, jparams, slots=2, cache_bucket=128).bs == 32
    finally:
        jtune.reset()
    port_untouched()
    # the port pointed at JAX's file: every entry stale
    monkeypatch.setenv(tune.CACHE_ENV, path)
    port_untouched()
    tune.reset()


def test_tune_seeds_from_a_torch_profiler_trace(tmp_path):
    """``from_ledger`` reads the port's own profile rows: a
    ``torch.profiler`` Chrome trace of a fused executor run, through
    ``obs.xplane``'s reader; its hottest sites (the fused regions' site
    ranges among them) implicate the fusion space, as JAX's hints map
    them."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.fluid.executor import Executor, Scope
    from paddle_tpu_torch.tune import driver, fusion
    main, start, feed, fetch = fusion.build_proxy_program()
    exe = Executor(scope=Scope(), device="cpu", fuse=True)
    exe.run(start)
    exe.run(main, feed=feed, fetch_list=fetch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exe.run(main, feed=feed, fetch_list=fetch)
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    sites = driver._ledger_sites(trace, topk=16)
    assert any("_fused_elementwise_chain" in s["op"] for s in sites)
    spaces, gates, annotated = driver._ledger_seeding(sites)
    assert "fusion" in spaces and gates == []
    assert all(a["self_ns"] >= 0 for a in annotated)
