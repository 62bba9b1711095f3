"""The parallel plane of the port (``paddle_tpu_torch.parallel``) against
the JAX package's on a mesh of the same shape: the mesh, the collectives,
``SpecLayout``'s resolution contract, data parallelism (replicated, an
fsdp/tp layout, ZeRO-1, through ``Trainer``), the tensor-parallel layers
and the pipeline schedules.

The port runs on a world of 4 gloo ranks on the CPU (``torch_spmd``: one
world for the module, every case in it); JAX on 4 of its 8 virtual CPU
devices, with its Pallas bodies in interpret mode as
``tests/test_parallel.py`` runs them. Inputs and weights are numpy, made
here from seeds; each test states its tolerance."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from paddle_tpu import parallel as jpp
from paddle_tpu.nn import Linear as JLinear
from paddle_tpu.nn import Module as JModule
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.optimizer import Adam as JAdam

import torch_spmd

N = 4
# f32 training over 3-5 steps: the mean over ranks reassociates the batch
# sum, and Adam's first step turns any rounding-level gradient difference
# into up to lr; these are JAX's own DP-equivalence bounds
DP_TOL = dict(rtol=2e-5, atol=2e-5)
ADAM_TOL = dict(rtol=1e-5, atol=1e-5)


def _jmesh(**axes):
    return jpp.make_mesh(devices=jax.devices()[:N], **axes)


def _toy_data(n=64, din=12, classes=3, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, din).astype(np.float32)
    w = rs.randn(din, classes).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.int32)
    return x, y


class _JNet(JModule):
    def __init__(self):
        super().__init__()
        self.l1 = JLinear(12, 32, act=jax.nn.relu)
        self.l2 = JLinear(32, 3)

    def __call__(self, params, x, **kw):
        return self.l2(params["l2"], self.l1(params["l1"], x))


def _jloss(model):
    def loss(params, x, y):
        logp = jax.nn.log_softmax(model(params, x))
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()
    return loss


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(t))


def _jax_dp(params0, x, y, steps, opt, mesh, rules=None):
    model = _JNet()
    dp = jpp.DataParallel(_jloss(model), opt, mesh=mesh, param_rules=rules)
    p, s = dp.init(jax.tree_util.tree_map(jnp.asarray, params0))
    bx, by = dp.shard_batch((jnp.asarray(x), jnp.asarray(y)))
    for _ in range(steps):
        p, s, _ = dp.step(p, s, bx, by)
    return _np_tree(p)


def _close_trees(got, want, **tol):
    got = {f"{a}/{b}": v for a, sub in got.items() for b, v in sub.items()}
    want = {f"{a}/{b}": v for a, sub in want.items() for b, v in sub.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


PARAMS0 = _np_tree(_JNet().init(jax.random.PRNGKey(1)))
X, Y = _toy_data()
LAYOUT = [(r"l2/b$", ())]


def _stage_params():
    stage = jpp.PipelineStage(lambda: JLinear(16, 16, act=jnp.tanh),
                              n_stages=4)
    return stage, _np_tree(stage.init(jax.random.PRNGKey(6)))


def _pipe_inputs():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (8, 16)))
    out = {"x": x}
    for n in (4, 6):
        B = 8 * n // 4
        out[f"x{n}"] = np.asarray(jax.random.normal(jax.random.PRNGKey(12),
                                                    (B, 16)))
        out[f"y{n}"] = np.asarray(jax.random.normal(jax.random.PRNGKey(13),
                                                    (B, 16)))
    return out


class _TPNet(JModule):
    def __init__(self):
        super().__init__()
        self.up = jpp.ColumnParallelLinear(16, 64, act=jax.nn.relu)
        self.down = jpp.RowParallelLinear(64, 8)

    def __call__(self, params, x, **kw):
        return self.down(params["down"], self.up(params["up"], x))


TP_PARAMS = _np_tree(_TPNet().init(jax.random.PRNGKey(0)))
TP_X = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (32, 16)))
EMB_TABLE = _np_tree(jpp.ShardedEmbedding(64, 16).init(
    jax.random.PRNGKey(0)))["table"]
EMB_IDS = np.array([0, 5, 63, 17, 16, 48])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pipe = _pipe_inputs()
    cases = [
        ("mesh", "torch_spmd:mesh_shapes", {}),
        ("coll", "torch_spmd:collectives",
         {"x": np.arange(16, dtype=np.float32) * 1.5 - 3}),
        ("dp_sgd", "torch_spmd:dp_steps",
         dict(params0=PARAMS0, x=X, y=Y, steps=5, opt="sgd")),
        ("dp_adam", "torch_spmd:dp_steps",
         dict(params0=PARAMS0, x=X, y=Y, steps=3, opt="adam")),
        ("single_sgd", "torch_spmd:single_steps",
         dict(params0=PARAMS0, x=X, y=Y, steps=5, opt="sgd")),
        ("layout_adam", "torch_spmd:dp_steps",
         dict(params0=PARAMS0, x=X, y=Y, steps=3, opt="adam",
              layout=LAYOUT)),
        ("zero1", "torch_spmd:zero1_steps",
         dict(params0=PARAMS0, x=X, y=Y, steps=3)),
        ("trainer", "torch_spmd:trainer_mesh",
         dict(params0=PARAMS0, x=X, y=Y, steps=3,
              ckpt_dir=str(tmp_path_factory.mktemp("ckpt")))),
        ("tp", "torch_spmd:tp_layers",
         dict(params=TP_PARAMS, x=TP_X, table=EMB_TABLE, ids=EMB_IDS)),
        ("pipe", "torch_spmd:pipeline",
         dict(params=_stage_params()[1], x=pipe["x"], x6=pipe["x6"],
              y6=pipe["y6"], x4=pipe["x4"], y4=pipe["y4"])),
    ]
    return torch_spmd.run_world(tmp_path_factory.mktemp("parallel"), cases)


def test_ranks_import_no_jax(world):
    assert not any(torch_spmd.result(world, "_imports_jax", r)
                   for r in range(N))


def test_canonical_order_and_mesh_spec_resolution():
    """MeshSpec resolves as JAX's does (sizes, wildcard, the errors)."""
    from paddle_tpu.parallel.mesh import CANONICAL_ORDER as JORDER
    from paddle_tpu.parallel.mesh import MeshSpec as JSpec

    from paddle_tpu_torch.analysis import lints
    from paddle_tpu_torch.parallel.mesh import CANONICAL_ORDER, MeshSpec
    assert CANONICAL_ORDER == JORDER
    assert not hasattr(lints, "CANONICAL_ORDER")   # one home: parallel.mesh
    for axes in ({"data": -1}, {"data": 2, "model": -1}, {"model": 1},
                 {"data": 1, "fsdp": 2, "tp": 2}, {"seq": 2}, {}):
        assert MeshSpec(dict(axes)).resolve(8) == JSpec(dict(axes)).resolve(8)
    for axes, n in (({"data": -1, "model": -1}, 8), ({"data": 3}, 8),
                    ({"data": 3, "model": -1}, 8), ({"data": 16}, 8)):
        with pytest.raises(ValueError):
            JSpec(dict(axes)).resolve(n)
        with pytest.raises(ValueError):
            MeshSpec(dict(axes)).resolve(n)


def test_make_mesh_axes_wildcard_and_sub_mesh(world):
    """make_mesh on a world of 4 gives JAX's shapes and axis order on 4
    devices; a sub-mesh takes the first ranks and its outside ranks take
    no part in its collectives."""
    got = torch_spmd.result(world, "mesh")
    jm = _jmesh(data=-1)
    assert got["wild"] == (dict(jm.shape), jm.axis_names)
    jm = _jmesh(data=2, model=2)
    assert got["data_model"][:2] == (dict(jm.shape), jm.axis_names)
    assert got["data_model"][1][-1] == "model"
    assert "needs 9 devices" in got["bad"]
    coords = [torch_spmd.result(world, "mesh", r)["data_model"][2:]
              for r in range(N)]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]  # model innermost
    for r in range(N):
        res = torch_spmd.result(world, "mesh", r)
        assert res["sub_member"] == (r < 2)
        if r < 2:
            assert res["sub_sum"] == 2.0
        else:
            assert "outside this sub-mesh" in res["sub_outside"]
        assert res["ambient"] and res["after"]


def test_collectives_match_jax(world):
    """Every collective through shard_map over data=4 equals JAX's on the
    same input (exact: small integers' sums)."""
    x = np.arange(16, dtype=np.float32) * 1.5 - 3
    mesh = _jmesh(data=4)

    def f(x):
        s = jpp.all_reduce(x, "data")
        mean = jpp.all_reduce(x, "data", "mean")
        mx = jpp.all_reduce(x, "data", "max")
        mn = jpp.all_reduce(x, "data", "min")
        g = jpp.all_gather(x, "data")
        gu = jpp.all_gather(x, "data", tiled=False).reshape(-1)
        rs = jpp.reduce_scatter(g, "data")
        idx = jpp.axis_index("data")
        nxt = jpp.permute_ring(idx.astype(jnp.float32).reshape(1), "data")
        prv = jpp.permute_ring(idx.astype(jnp.float32).reshape(1), "data",
                               -1)
        bc = jpp.broadcast(x, "data", root=2)
        a2a = jpp.all_to_all(x, "data", split_axis=0, concat_axis=0)
        return s, mean, mx, mn, g, gu, rs, nxt, prv, bc, a2a

    want = jpp.shard_map(f, mesh=mesh, in_specs=JP("data"),
                         out_specs=(JP("data"),) * 11)(jnp.asarray(x))
    got = torch_spmd.result(world, "coll")
    names = "sum mean max min gather gather_untiled reduce_scatter ring_next " \
        "ring_prev broadcast all_to_all".split()
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_spec_layout_resolution_contract():
    """annotation > rule > role > replicated, with mesh/shape fitting:
    the port's SpecLayout returns JAX's specs for the same paths, shapes
    and mesh (tests/test_fluid_sharding.py's cases, on 2x2x2); the
    port's block-list paths read as JAX's."""
    from paddle_tpu_torch.parallel import SpecLayout
    from paddle_tpu_torch.parallel.sharding import P

    jmesh = jpp.make_mesh(data=2, fsdp=2, tp=2)
    fake = types.SimpleNamespace(shape={"data": 2, "fsdp": 2, "tp": 2})
    jlay = jpp.SpecLayout(rules=[(r"special/w$", JP("tp", None))])
    lay = SpecLayout(rules=[(r"special/w$", P("tp", None))])
    cases = [("special/w", (8, 8), ("fsdp", None)), ("special/w", (8, 8), None),
             ("embedding_w", (64, 8), None), ("fc_w_0", (8, 16), None),
             ("fc_b_0", (16,), None), ("w", (8, 8), ("seq", None)),
             ("w", (7, 16), ("fsdp", "tp")), ("conv/w", (3, 3, 4, 8), None),
             ("blocks_0/qkv/w", (8, 24), None), ("s", (), None)]
    for path, shape, ann in cases:
        want = jlay.resolve(jmesh, path, shape, annotation=ann).spec
        got = lay.fit(fake, lay.spec_for(path, shape, ann), shape)
        assert tuple(got) == tuple(want), (path, shape, ann, got, want)
    assert tuple(SpecLayout(roles=False).fit(
        fake, SpecLayout(roles=False).spec_for("fc_w", (8, 8)), (8, 8))) == ()
    # a port path (blocks/0/...) resolves as JAX's blocks_0/...
    rules = [(r".*blocks_\d+/qkv/w$", P(None, "tp"))]
    assert tuple(SpecLayout(rules=rules).spec_for("blocks/3/qkv/w",
                                                  (8, 24))) == (None, "tp")
    assert tuple(lay.batch_spec(3)) == tuple(jlay.batch_spec(3))


def test_data_parallel_matches_single_device_and_jax(world):
    """4-way DP (SGD, 5 steps) equals one device on the whole batch and
    JAX's 4-device DP (DP_TOL, JAX's own bound)."""
    want = _jax_dp(PARAMS0, X, Y, 5, JSGD(0.1), _jmesh(data=4))
    got = torch_spmd.result(world, "dp_sgd")
    _close_trees(got["params"], want, **DP_TOL)
    _close_trees(got["params"], torch_spmd.result(world, "single_sgd"),
                 **DP_TOL)
    for r in range(1, N):          # every rank holds the same parameters
        _close_trees(torch_spmd.result(world, "dp_sgd", r)["params"],
                     got["params"], rtol=0, atol=0)


def test_layout_dp_matches_replicated_and_stores_a_quarter(world):
    """DP under SpecLayout on fsdp=2 x tp=2 (the 2-D weights sharded four
    ways, l2/b pinned replicated by a rule) trains as replicated DP and as
    JAX's DP under the same layout (Adam, 3 steps; ADAM_TOL), and each
    rank stores its quarter of every sharded parameter and slot."""
    rules = jpp.SpecLayout(rules=[(pat, JP(*spec)) for pat, spec in LAYOUT])
    want = _jax_dp(PARAMS0, X, Y, 3, JAdam(1e-2), _jmesh(fsdp=2, tp=2),
                   rules)
    got = torch_spmd.result(world, "layout_adam")
    _close_trees(got["params"], want, **ADAM_TOL)
    _close_trees(got["params"], torch_spmd.result(world, "dp_adam")["params"],
                 **ADAM_TOL)
    assert got["specs"]["l1/w"] == ("fsdp", "tp")
    assert got["specs"]["l2/b"] == ()
    assert got["specs"]["l2/w"] == ("fsdp",)      # 3 columns: fsdp only
    sizes = {"fsdp": 2, "tp": 2}
    per_rank = 0
    for k, sub in PARAMS0.items():
        for n, v in sub.items():
            shards = 1
            for entry in got["specs"][f"{k}/{n}"]:
                for a in ((entry,) if isinstance(entry, str) else entry or ()):
                    shards *= sizes[a]
            per_rank += v.nbytes // shards
    # params + Adam's two slots, each its block and no more
    assert got["bytes"] == 3 * per_rank
    assert per_rank < sum(v.nbytes for sub in PARAMS0.values()
                          for v in sub.values()) / 2


def test_zero1_matches_dp_and_partitions_its_state(world):
    """ZeRO-1 (reduce-scatter, shard-local Adam, all-gather) trains as
    replicated DP and as JAX's ZeRO-1 (ADAM_TOL); the master vector and
    every slot hold 1/4 a rank."""
    model = _JNet()
    z = jpp.Zero1DataParallel(_jloss(model), JAdam(1e-2), mesh=_jmesh(data=4))
    zs = z.init(jax.tree_util.tree_map(jnp.asarray, PARAMS0))
    b = z.shard_batch((jnp.asarray(X), jnp.asarray(Y)))
    for _ in range(3):
        zs, _ = z.step(zs, *b)
    want = _np_tree(z.params(zs))
    got = torch_spmd.result(world, "zero1")
    _close_trees(got["params"], want, **ADAM_TOL)
    _close_trees(got["params"], torch_spmd.result(world, "dp_adam")["params"],
                 **ADAM_TOL)
    local, full = got["flat"]
    assert local[0] * N == full[0] == zs.flat.shape[0]
    for local, full in got["slots"]:
        assert local[0] * N == full[0]


def test_trainer_on_a_mesh_matches_one_rank(world):
    """Trainer(mesh=make_mesh(data=4)) and Trainer(layout=) under use_mesh
    train as the single-rank Trainer on the same global batches (Adam, 3
    steps; ADAM_TOL); layout= with no mesh raises JAX's ValueError."""
    got = torch_spmd.result(world, "trainer")
    _close_trees(got["mesh"], got["single"], **ADAM_TOL)
    _close_trees(got["layout"], got["single"], **ADAM_TOL)
    assert "needs mesh=" in got["no_mesh"]
    assert np.isfinite(got["test_cost"])


def test_trainer_on_a_mesh_checkpoints_global_tensors_and_resumes(world):
    """A mesh Trainer's pass checkpoint holds the gathered global tensors
    (exactly the trained parameters; the mesh's first rank writes it),
    and a resume on another mesh (data=2 x fsdp=2 under SpecLayout)
    re-places them and trains the next pass as one rank trains two in a
    row (Adam; ADAM_TOL)."""
    got = torch_spmd.result(world, "trainer")
    trained, saved, pass_id = got["ckpt"]
    assert pass_id == 0
    _close_trees(saved, trained, rtol=0, atol=0)
    _close_trees(got["resumed"], got["single2"], **ADAM_TOL)


def test_trainer_on_a_mesh_skips_a_non_finite_batch(world):
    """on_nonfinite="skip" on a mesh reverts to the trees from before the
    step on the host (JAX's mesh path) and ends where the single-rank
    trainer's in-step guard ends (ADAM_TOL), one batch skipped each."""
    got = torch_spmd.result(world, "trainer")
    (mesh_p, mesh_n), (one_p, one_n) = got["skip_mesh"], got["skip_single"]
    assert mesh_n == one_n == 1
    _close_trees(mesh_p, one_p, **ADAM_TOL)


def test_tensor_parallel_layers_match_dense_and_jax(world):
    """Column -> row parallel MLP on data=2 x model=2 and a vocab-sharded
    embedding on model=4 equal the dense math and JAX (1e-5, JAX's bound);
    collect_tp_rules gives JAX's rules."""
    net = _TPNet()
    want = np.asarray(net(jax.tree_util.tree_map(jnp.asarray, TP_PARAMS),
                          jnp.asarray(TP_X)))
    got = torch_spmd.result(world, "tp")
    for key in ("dense", "tp", "tp_data"):
        np.testing.assert_allclose(got[key], want, rtol=1e-5, atol=1e-5,
                                   err_msg=key)
    assert got["rules"] == [(pat, tuple(spec)) for pat, spec in
                            jpp.tensor_parallel.collect_tp_rules(net)]
    np.testing.assert_allclose(got["emb"], EMB_TABLE[EMB_IDS], rtol=0,
                               atol=0)


def test_pipeline_schedules_match_jax(world):
    """pipeline_spmd equals the sequential fold (and JAX's); 1F1B's loss
    and per-stage gradients equal JAX's 1F1B at 4 and 6 microbatches
    (rtol 1e-4, atol 1e-5, JAX's bound); autodiff through the GPipe ring
    trains."""
    stage, params = _stage_params()
    pipe = _pipe_inputs()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    got = torch_spmd.result(world, "pipe")
    want = np.asarray(stage(jp, jnp.asarray(pipe["x"])))
    np.testing.assert_allclose(got["sequential"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["spmd"], want, rtol=1e-5, atol=1e-5)
    mesh = _jmesh(pipe=4)

    def stage_fn(p, mb):
        return jnp.tanh(mb @ p["w"] + p["b"])

    def loss_fn(out, y):
        return jnp.mean((out - y) ** 2)

    for n in (4, 6):
        step = jpp.pipeline_1f1b(stage_fn, loss_fn, mesh, n_microbatches=n)
        with mesh:
            loss, grads = step(jp, jnp.asarray(pipe[f"x{n}"]),
                               jnp.asarray(pipe[f"y{n}"]))
        gl, gg = got[f"1f1b_{n}"]
        np.testing.assert_allclose(gl, float(loss), rtol=1e-5, atol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(gg[k], np.asarray(grads[k]),
                                       rtol=1e-4, atol=1e-5, err_msg=k)
    l0, l1 = got["trains"]
    assert l1 < l0


def test_chip_smoke_world_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 22 (its world of 4 gloo ranks, then a
    one-rank world) runs here at a small size on the CPU, where the
    kernels' plain versions run and nothing launches, and passes its own
    checks: the rings against one flash_attention call, the
    seq-parallel loss and gradients, the data-parallel steps and their
    bytes a rank, MoE, 1F1B and the TP layers."""
    import chip_smoke
    said = []
    figs = chip_smoke.world_phase(
        said.append, 0, device="cpu", ring=dict(B=2, T=32, H=4, D=8),
        lm=dict(vocab=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_len=32), batch=4, nccl="gloo")
    assert set(figs["ring"]) == {f"{c} {d}" for c in ("zigzag", "contiguous",
                                                      "full", "ulysses")
                                 for d in ("float32", "bfloat16")}
    assert set(figs["dp"]) == {"data=4", "fsdp=2 x tp=2", "zero1 data=4"}
    assert figs["nccl"]["backend"] == "gloo"
    assert any(line.startswith("phase 22:") for line in said)
