"""The fluid executor on a mesh (``Executor(mesh=, layout=)``, the port's
``fluid/_mesh.py``) against the JAX package's GSPMD executor on a mesh of
the same shape: the counterparts of every case of
``tests/test_fluid_sharding.py`` (resolution contract, ambient adoption,
2x2x2 parity, a quarter of the bytes on fsdp=4, donation, bucketing, the
cache key, restore onto another mesh), a ``reduce_sum`` loss held to
JAX's gradient, a loss with a replicated parameter-only term and one
with a batch statistic inside the rows, held to JAX's gradient, a small LSTM classifier, the refusal of an unhandled
batch reduction and of row-local ops along the batch axis, a training
dropout's global mask, and the persistables file JAX's byte for byte.

The port runs on one world of 8 gloo ranks on the CPU (``torch_spmd``,
the cases in ``torch_fluid_mesh``); JAX on its 8 virtual CPU devices.
Each test states its tolerance."""

import os

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import parallel as jpp
from paddle_tpu import obs as jobs

import torch_spmd

WORLD = 8
M = "torch_fluid_mesh"
# SGD over 3 steps: the gradient's sum over ranks reassociates the batch
# sum (JAX's own bound for its sharded run against the replicated one)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _jfresh():
    jfluid.reset_default_programs()
    jfluid.executor._global_scope = jfluid.Scope()


def _jscope(exe):
    return {n: np.asarray(v) for n, v in exe.scope.vars.items()}


def _jannotated(loss_kind="mean"):
    """JAX's program of the cases (torch_fluid_mesh.annotated_program)
    and its startup scope."""
    import torch_fluid_mesh as tm
    _jfresh()
    persample, loss = tm.annotated_program(jfluid, loss_kind)
    exe = jfluid.Executor(scope=jfluid.Scope())
    exe.run(jfluid.default_startup_program())
    return persample, loss, _jscope(exe)


def _jrun_mesh(scope_np, persample, loss, steps, mesh=None):
    import torch_fluid_mesh as tm
    sc = jfluid.Scope()
    for n, v in scope_np.items():
        sc.set(n, v)
    exe = jfluid.Executor(scope=sc, mesh=mesh or jpp.make_mesh(
        data=2, fsdp=2, tp=2), layout=jpp.SpecLayout(roles=False))
    feed = tm.annotated_feed()
    runs = [tuple(np.asarray(v) for v in exe.run(
        feed=feed, fetch_list=[persample, loss])) for _ in range(1 + steps)]
    return runs, exe


def _textcls_jax(steps=3):
    _jfresh()
    L = jfluid.layers
    words = L.data("words", shape=(-1,), dtype="int32")
    lens = L.data("lens", shape=(), dtype="int32")
    label = L.data("label", shape=(), dtype="int32")
    emb = L.embedding(words, (50, 8))
    last = L.sequence_last_step(L.dynamic_lstm(emb, lens, 8), lens)
    logits = L.fc(last, 2)
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    jfluid.SGDOptimizer(0.1).minimize(loss)
    exe = jfluid.Executor(scope=jfluid.Scope())
    exe.run(jfluid.default_startup_program())
    scope_np = _jscope(exe)
    rs = np.random.RandomState(3)
    feed = {"words": rs.randint(0, 50, (8, 6)).astype(np.int32),
            "lens": rs.randint(2, 7, 8).astype(np.int32),
            "label": rs.randint(0, 2, 8).astype(np.int32)}
    losses = [float(exe.run(feed=feed, fetch_list=[loss])[0])
              for _ in range(steps)]
    params = [n for n, v in jfluid.default_main_program().global_block()
              .vars.items() if v.persistable and v.trainable]
    return scope_np, feed, losses, {n: np.asarray(exe.scope.get(n))
                                    for n in params}


def _fsdp4_jax():
    _jfresh()
    x = jfluid.layers.data("x", shape=(64,))
    h = jfluid.layers.fc(x, 128, act="relu",
                         param_attr={"sharding": ("fsdp", None)},
                         bias_param_attr={"sharding": ("fsdp",)})
    out = jfluid.layers.fc(h, 8, param_attr={"sharding": ("fsdp", None)},
                           bias_param_attr={"sharding": ("fsdp",)})
    loss = jfluid.layers.mean(out)
    jfluid.SGDOptimizer(0.01).minimize(loss)
    sc = jfluid.Scope()
    exe0 = jfluid.Executor(scope=sc)
    exe0.run(jfluid.default_startup_program())
    scope_np = _jscope(exe0)
    exe = jfluid.Executor(scope=sc, mesh=jpp.make_mesh(data=2, fsdp=4),
                          layout=jpp.SpecLayout())
    feed = {"x": np.ones((8, 64), np.float32)}
    l0 = float(exe.run(feed=feed, fetch_list=[loss])[0])
    reg = jobs.MetricsRegistry()
    with jobs.ObsSession(registry=reg).installed():
        exe._mesh_stats_emitted = False
        l1 = float(exe.run(feed=feed, fetch_list=[loss])[0])
    return scope_np, {
        "losses": [l0, l1],
        "axis_size": {a: reg.gauge("mesh.axis_size").get(axis=a)
                      for a in ("data", "fsdp")},
        "axis_util": {a: reg.gauge("mesh.axis_utilization").get(axis=a)
                      for a in ("data", "fsdp")},
        "per_device": reg.gauge("fluid.param_bytes_per_device").get(),
        "global": reg.gauge("fluid.param_bytes_global").get()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """One world for the module: every case on all 8 ranks, with the JAX
    references the cases need computed first."""
    ref = {}
    ps, loss, ref["scope"] = _jannotated("mean")
    ref["runs"], _ = _jrun_mesh(ref["scope"], ps, loss, 3)
    ps_s, loss_s, ref["scope_sum"] = _jannotated("sum")
    ref["runs_sum"], _ = _jrun_mesh(ref["scope_sum"], ps_s, loss_s, 3)
    ps_l, loss_l, ref["scope_l2"] = _jannotated("mean_l2")
    ref["runs_l2"], _ = _jrun_mesh(ref["scope_l2"], ps_l, loss_l, 3)
    ps_c, loss_c, ref["scope_c"] = _jannotated("centered")
    ref["runs_c"], _ = _jrun_mesh(ref["scope_c"], ps_c, loss_c, 3)
    ref["fsdp_scope"], ref["fsdp"] = _fsdp4_jax()
    (ref["tc_scope"], ref["tc_feed"], ref["tc_losses"],
     ref["tc_final"]) = _textcls_jax()
    d = tmp_path_factory.mktemp("fluid_mesh")
    save_dir = str(d / "saved")
    cases = [
        ("spec", f"{M}:spec_resolution", {}),
        ("ambient", f"{M}:ambient_adoption", {}),
        ("parity", f"{M}:parity_222", {"scope_np": ref["scope"]}),
        ("parity_sum", f"{M}:parity_222",
         {"scope_np": ref["scope_sum"], "loss_kind": "sum"}),
        ("parity_l2", f"{M}:parity_222",
         {"scope_np": ref["scope_l2"], "loss_kind": "mean_l2"}),
        ("parity_c", f"{M}:parity_222",
         {"scope_np": ref["scope_c"], "loss_kind": "centered"}),
        ("fsdp4", f"{M}:fsdp4_bytes", {"scope_np": ref["fsdp_scope"]}),
        ("donation", f"{M}:donation", {"scope_np": ref["scope"]}),
        ("bucketing", f"{M}:bucketing", {}),
        ("cache_key", f"{M}:cache_key", {}),
        ("restore", f"{M}:restore",
         {"scope_np": ref["scope"], "out_dir": save_dir}),
        ("textcls", f"{M}:textcls",
         {"scope_np": ref["tc_scope"], "feed": ref["tc_feed"]}),
        ("batch_norm", f"{M}:batch_norm_raises", {}),
        ("batch_axis", f"{M}:batch_axis_ops", {}),
        ("dropout", f"{M}:dropout_global_mask", {}),
    ]
    ranks = torch_spmd.run_world(d / "world", cases, world=WORLD,
                                 timeout=240.0)
    return ranks, ref, save_dir


def _all(ranks, name):
    return [torch_spmd.result(ranks, name, r) for r in range(WORLD)]


def test_no_rank_imports_jax(world):
    ranks, _, _ = world
    for r in range(WORLD):
        assert torch_spmd.result(ranks, "_imports_jax", r) is False


def test_spec_layout_resolution_contract(world):
    """annotation > rule > role > replicated, with mesh/shape fitting —
    the same specs as JAX's SpecLayout on the same mesh shape."""
    from jax.sharding import PartitionSpec as P
    ranks, _, _ = world
    mesh = jpp.make_mesh(data=2, fsdp=2, tp=2)
    lay = jpp.SpecLayout(rules=[(r"special/w$", P("tp", None))])
    want = [lay.resolve(mesh, "special/w", (8, 8),
                        annotation=("fsdp", None)).spec,
            lay.resolve(mesh, "special/w", (8, 8)).spec,
            lay.resolve(mesh, "embedding_w", (64, 8)).spec,
            lay.resolve(mesh, "fc_w_0", (8, 16)).spec,
            lay.resolve(mesh, "fc_b_0", (16,)).spec,
            lay.resolve(mesh, "w", (8, 8), annotation=("seq", None)).spec,
            lay.resolve(mesh, "w", (7, 16),
                        annotation=("fsdp", "tp")).spec,
            jpp.SpecLayout(roles=False).resolve(mesh, "fc_w", (8, 8)).spec]
    for got in _all(ranks, "spec"):
        assert got == [tuple(s) for s in want]


def test_executor_adopts_ambient_mesh(world):
    ranks, _, _ = world
    for got in _all(ranks, "ambient"):
        assert got == {"adopted": True, "layout": True, "device": "cpu",
                       "outside": True}


def test_layout_without_a_mesh_raises_as_jax():
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import parallel as pp
    with pytest.raises(ValueError, match="needs a mesh"):
        fluid.Executor(layout=pp.SpecLayout(), device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        jfluid.Executor(layout=jpp.SpecLayout())


@pytest.mark.parametrize("case,runs", [("parity", "runs"),
                                       ("parity_sum", "runs_sum"),
                                       ("parity_l2", "runs_l2"),
                                       ("parity_c", "runs_c")])
def test_mesh_sharded_parity_2x2x2(world, case, runs):
    """The annotated program on 2x2x2 with genuinely sharded parameters
    against JAX's sharded run: the first forward equal to f32 rounding
    (the port sums the batch loss across ranks), 3 SGD steps within
    STEP_TOL; with a reduce_sum loss too, whose gradient is the sum's (no
    rank count divided by), with a replicated L2 term of the head's
    weight beside the mean, whose gradient GSPMD counts once, and with
    the batch mean of the error subtracted (a batch statistic entering a
    row-sharded op, whose cotangent is summed across the ranks)."""
    ranks, ref, _ = world
    for got in _all(ranks, case):
        (ps0, l0), (jps0, jl0) = got["runs"][0], ref[runs][0]
        np.testing.assert_array_equal(ps0, jps0)
        np.testing.assert_allclose(l0, jl0, rtol=1e-6, atol=1e-7)
        for (ps, lv), (jps, jl) in zip(got["runs"][1:], ref[runs][1:]):
            np.testing.assert_allclose(ps, jps, **STEP_TOL)
            np.testing.assert_allclose(lv, jl, **STEP_TOL)
        assert got["placed"][got["emb"]] == (("fsdp",), (8, 8))
        assert got["placed"][got["fc"]] == ((None, "tp"), (8, 8))
    finals = [g["final"] for g in _all(ranks, case)]
    for f in finals[1:]:                      # every rank holds one state
        for n, v in f.items():
            np.testing.assert_array_equal(v, finals[0][n])


def test_per_device_param_bytes_quarter_on_fsdp4(world):
    """data=2 x fsdp=4: the bytes a rank holds <= 1/4 of the replicated
    footprint, and the layout's gauges equal JAX's."""
    ranks, ref, _ = world
    want = ref["fsdp"]
    for got in _all(ranks, "fsdp4"):
        assert got["replicated"] > 0
        assert got["per_rank"] <= got["replicated"] / 4
        assert got["axis_size"] == want["axis_size"]
        assert got["axis_util"] == pytest.approx(want["axis_util"])
        assert got["axis_util"]["fsdp"] > 0.9
        assert got["per_device"] == want["per_device"]
        assert got["global"] == want["global"]
        assert got["per_device"] < got["global"] / 3
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5, atol=1e-6)


def test_donation_composes_with_sharding(world):
    ranks, _, _ = world
    for got in _all(ranks, "donation"):
        assert got["donated"] > 0
        assert got["same_spec"] and got["in_place"]
        assert got["losses"][1] < got["losses"][0]


def test_bucketing_composes_with_sharding(world):
    """Two misses and two hits over four lengths, three keys, no graph
    capture (a mesh run is eager), and each output's live columns."""
    ranks, _, _ = world
    for got in _all(ranks, "bucketing"):
        assert (got["misses"], got["hits"]) == (2, 2)
        assert got["captures"] == 0
        assert got["cache"] == 3
        for L, out in got["outs"].items():
            assert out.shape[1] in (8, 16)
            np.testing.assert_array_equal(
                out[:, :L], (np.arange(2 * L, dtype=np.float32)
                             .reshape(2, L)) ** 2)


def test_mesh_joins_cache_key(world):
    ranks, _, _ = world
    for got in _all(ranks, "cache_key"):
        assert got == {"distinct": True, "equal": True}


def test_restore_replaces_onto_current_mesh(world):
    """save_persistables on 2x2x2, load_persistables onto data=2 x fsdp=4:
    re-placed by the layout there, the same fetch."""
    ranks, _, _ = world
    for got in _all(ranks, "restore"):
        assert got["spec"] == ("fsdp",)
        np.testing.assert_array_equal(got["r1"], got["r2"])


def test_persistables_file_is_jaxs_and_loads_on_jaxs_mesh(world, tmp_path):
    """The file the port wrote on the mesh is the file JAX writes for the
    same scope byte for byte, and JAX's mesh executor loads it and
    computes the same fetch."""
    import torch_fluid_mesh as tm
    _, ref, save_dir = world
    ps, loss, _ = _jannotated("mean")
    sc = jfluid.Scope()
    for n, v in ref["scope"].items():
        sc.set(n, v)
    exe = jfluid.Executor(scope=sc, mesh=jpp.make_mesh(data=2, fsdp=2, tp=2),
                          layout=jpp.SpecLayout(roles=False))
    jfluid.io.save_persistables(exe, str(tmp_path))
    with open(os.path.join(save_dir, "persistables.tar"), "rb") as f:
        mine = f.read()
    with open(tmp_path / "persistables.tar", "rb") as f:
        assert f.read() == mine
    exe2 = jfluid.Executor(scope=jfluid.Scope(),
                           mesh=jpp.make_mesh(data=2, fsdp=4),
                           layout=jpp.SpecLayout(roles=False))
    jfluid.io.load_persistables(exe2, save_dir)
    r2, = exe2.run(feed=tm.annotated_feed(), fetch_list=[ps], donate=False)
    np.testing.assert_array_equal(np.asarray(r2), ref["runs"][0][0])


def test_lstm_classifier_on_data8_equals_single_device(world):
    """A small LSTM classifier on data=8 (one row a rank, the lstm and
    sequence ops row by row, the mean across ranks): 3 SGD losses and the
    final parameters against JAX's single-device run, to STEP_TOL."""
    ranks, ref, _ = world
    for got in _all(ranks, "textcls"):
        np.testing.assert_allclose(got["losses"], ref["tc_losses"],
                                   **STEP_TOL)
        for n, v in ref["tc_final"].items():
            np.testing.assert_allclose(got["final"][n], v, err_msg=n,
                                       **STEP_TOL)


def test_unhandled_batch_reduction_raises_naming_a7b(world):
    ranks, _, _ = world
    for got in _all(ranks, "batch_norm"):
        assert got is not None and "A.7b" in got and "batch_norm" in got


def test_row_local_ops_along_the_batch_axis_raise_naming_a7b(world):
    ranks, _, _ = world
    for got in _all(ranks, "batch_axis"):
        for key in ("l2_normalize:0", "argmax:0", "softmax:1d"):
            assert isinstance(got[key], str) and "A.7b" in got[key], key
            assert "batch axis" in got[key], key
        assert got["l2_normalize:1"] is True
        assert got["argmax:-1"] is True


def test_training_dropout_draws_the_single_device_mask(world):
    ranks, _, _ = world
    for got in _all(ranks, "dropout"):
        assert got["equal"] is True
        assert 0 < got["dropped"] < 8 * 16
