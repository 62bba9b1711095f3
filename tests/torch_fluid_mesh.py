"""Rank-side cases of tests/test_torch_fluid_sharding.py: the port's fluid
``Executor(mesh=, layout=)`` on a world of gloo ranks (``torch_spmd``).

torch only: no jax, nothing of ``paddle_tpu``. Not collected (no
``test_`` prefix). Each case builds its program with the port's fluid
API, loads the JAX startup scope it is given (numpy, made in the test
process) through ``convert.scope_from_numpy``, runs on its mesh and
returns numpy results that the test holds against JAX's executor on a
mesh of the same shape.
"""

from __future__ import annotations

import numpy as np


def _fluid():
    import paddle_tpu_torch.fluid as fluid
    fluid.reset_default_programs()
    fluid.executor._global_scope = fluid.Scope()
    return fluid


def _mesh(**axes):
    from paddle_tpu_torch import parallel as pp
    return pp.make_mesh(device="cpu", **axes)


def _np(v):
    from paddle_tpu_torch.parallel.sharding import to_global
    v = to_global(v)
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


def annotated_program(fluid, loss_kind="mean"):
    """JAX's tests/test_fluid_sharding.py ``_annotated_program``: an
    embedding (vocab over fsdp), a tp-column fc and a replicated head; the
    loss the mean (or, ``loss_kind="sum"``, the sum) of the per-sample
    squared error, SGD 0.05. ``loss_kind="mean_l2"`` adds a replicated
    term, 0.3 * reduce_sum(square(head weight)): a path from a parameter
    to the loss that skips every batch reduction. ``loss_kind="centered"``
    subtracts the batch mean of the error before squaring: a batch
    statistic (replicated) entering a row-sharded op."""
    ids = fluid.layers.data("ids", shape=(), dtype="int32",
                            sharding=("data",))
    y = fluid.layers.data("y", shape=(1,))
    emb = fluid.layers.embedding(ids, (16, 8),
                                 param_attr={"sharding": ("fsdp", None)})
    h = fluid.layers.fc(emb, 16, act="relu",
                        param_attr={"sharding": (None, "tp")})
    pred = fluid.layers.fc(h, 1)
    diff = fluid.layers.elementwise_sub(pred, y)
    if loss_kind == "centered":
        diff = fluid.layers.elementwise_sub(diff, fluid.layers.mean(diff))
    persample = fluid.layers.elementwise_mul(diff, diff)
    loss = (fluid.layers.reduce_sum(persample) if loss_kind == "sum"
            else fluid.layers.mean(persample))
    if loss_kind == "mean_l2":
        b = fluid.default_main_program().global_block()
        head = [v for n, v in b.vars.items()
                if v.persistable and n.startswith("fc_w")][-1]
        l2 = fluid.layers.reduce_sum(fluid.layers.activation(head, "square"))
        loss = fluid.layers.elementwise_add(loss, fluid.layers.elementwise_mul(
            l2, fluid.layers.fill_constant((), value=0.3)))
    fluid.SGDOptimizer(0.05).minimize(loss)
    return persample, loss


def annotated_feed():
    rs = np.random.RandomState(0)
    return {"ids": rs.randint(0, 16, 8).astype(np.int32),
            "y": rs.randn(8, 1).astype(np.float32)}


def _scope(fluid, scope_np):
    from paddle_tpu_torch.convert import scope_from_numpy
    return scope_from_numpy(scope_np, "cpu")


def _params(fluid, prefix=None):
    b = fluid.default_main_program().global_block()
    return [n for n, v in b.vars.items()
            if v.persistable and v.trainable
            and (prefix is None or n.startswith(prefix))]


# ---------------------------------------------------------------------------

def spec_resolution():
    """SpecLayout's resolution contract on the 2x2x2 mesh (the cases of
    JAX's test_spec_layout_resolution_contract), as spec strings."""
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.sharding import P
    mesh = _mesh(data=2, fsdp=2, tp=2)
    lay = pp.SpecLayout(rules=[(r"special/w$", P("tp", None))])
    got = [lay.resolve(mesh, "special/w", (8, 8),
                       annotation=("fsdp", None)).spec,
           lay.resolve(mesh, "special/w", (8, 8)).spec,
           lay.resolve(mesh, "embedding_w", (64, 8)).spec,
           lay.resolve(mesh, "fc_w_0", (8, 16)).spec,
           lay.resolve(mesh, "fc_b_0", (16,)).spec,
           lay.resolve(mesh, "w", (8, 8), annotation=("seq", None)).spec,
           lay.resolve(mesh, "w", (7, 16),
                       annotation=("fsdp", "tp")).spec,
           pp.SpecLayout(roles=False).resolve(mesh, "fc_w", (8, 8)).spec]
    return [tuple(s) for s in got]


def ambient_adoption():
    from paddle_tpu_torch import parallel as pp
    fluid = _fluid()
    with pp.use_mesh(_mesh(data=2, fsdp=2, tp=2)) as m:
        exe = fluid.Executor()
    outside = fluid.Executor(device="cpu")
    return {"adopted": exe.mesh is m, "layout": exe.layout is not None,
            "device": str(exe.device), "outside": outside.mesh is None}


def parity_222(scope_np, loss_kind="mean", steps=3):
    """The acceptance run: the annotated program on 2x2x2 with its
    parameters stored sharded; the first forward and ``steps`` training
    runs' fetches, and where the parameters live."""
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.sharding import local, spec_of
    fluid = _fluid()
    persample, loss = annotated_program(fluid, loss_kind)
    feed = annotated_feed()
    exe = fluid.Executor(scope=_scope(fluid, scope_np),
                         mesh=_mesh(data=2, fsdp=2, tp=2),
                         layout=pp.SpecLayout(roles=False))
    runs = []
    for _ in range(1 + steps):
        ps, lv = exe.run(feed=feed, fetch_list=[persample, loss])
        runs.append((ps, lv))
    emb = next(n for n in _params(fluid) if "embedding" in n)
    fc = next(n for n in _params(fluid) if n.startswith("fc_w"))
    placed = {n: (tuple(spec_of(exe.scope.get(n))),
                  tuple(local(exe.scope.get(n)).shape)) for n in (emb, fc)}
    final = {n: _np(exe.scope.get(n)) for n in _params(fluid)}
    return {"runs": runs, "placed": placed, "emb": emb, "fc": fc,
            "final": final}


def fsdp4_bytes(scope_np):
    """JAX's test_per_device_param_bytes_quarter_on_fsdp4 on data=2 x
    fsdp=4: the bytes this rank holds, and the layout's gauges."""
    from paddle_tpu_torch import obs
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.sharding import local
    fluid = _fluid()
    x = fluid.layers.data("x", shape=(64,))
    h = fluid.layers.fc(x, 128, act="relu",
                        param_attr={"sharding": ("fsdp", None)},
                        bias_param_attr={"sharding": ("fsdp",)})
    out = fluid.layers.fc(h, 8, param_attr={"sharding": ("fsdp", None)},
                          bias_param_attr={"sharding": ("fsdp",)})
    loss = fluid.layers.mean(out)
    fluid.SGDOptimizer(0.01).minimize(loss)
    exe = fluid.Executor(scope=_scope(fluid, scope_np),
                         mesh=_mesh(data=2, fsdp=4),
                         layout=pp.SpecLayout())
    feed = {"x": np.ones((8, 64), np.float32)}
    l0, = exe.run(feed=feed, fetch_list=[loss])
    replicated = per_rank = 0
    for n in _params(fluid):
        v = exe.scope.get(n)
        replicated += v.numel() * v.element_size()
        t = local(v)
        per_rank += t.numel() * t.element_size()
    reg = obs.MetricsRegistry()
    with obs.ObsSession(registry=reg).installed():
        exe._mesh_stats_emitted = False
        l1, = exe.run(feed=feed, fetch_list=[loss])
    return {"replicated": replicated, "per_rank": per_rank,
            "losses": [float(l0), float(l1)],
            "axis_size": {a: reg.gauge("mesh.axis_size").get(axis=a)
                          for a in ("data", "fsdp")},
            "axis_util": {a: reg.gauge("mesh.axis_utilization").get(axis=a)
                          for a in ("data", "fsdp")},
            "per_device": reg.gauge("fluid.param_bytes_per_device").get(),
            "global": reg.gauge("fluid.param_bytes_global").get(),
            "placed": reg.counter("fluid.placed_bytes_total").get()}


def donation(scope_np):
    """A donated sharded persistable updates in place: the same block
    storage, the same spec, fluid.donated_bytes_total counted, and the
    losses keep falling."""
    from paddle_tpu_torch import obs
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.sharding import local, spec_of
    fluid = _fluid()
    persample, loss = annotated_program(fluid)
    feed = annotated_feed()
    exe = fluid.Executor(scope=_scope(fluid, scope_np),
                         mesh=_mesh(data=2, fsdp=2, tp=2),
                         layout=pp.SpecLayout(roles=False))
    fc = next(n for n in _params(fluid) if n.startswith("fc_w"))
    exe.run(feed=feed, fetch_list=[loss])          # placement run
    ref = exe.scope.get(fc)
    spec0, ptr0 = spec_of(ref), local(ref).data_ptr()
    reg = obs.MetricsRegistry()
    with obs.ObsSession(registry=reg).installed():
        exe.run(feed=feed, fetch_list=[loss], return_numpy=False)
    new = exe.scope.get(fc)
    l1 = float(exe.run(feed=feed, fetch_list=[loss])[0])
    l2 = float(exe.run(feed=feed, fetch_list=[loss])[0])
    return {"donated": reg.counter("fluid.donated_bytes_total").get(),
            "same_spec": spec_of(new) == spec0,
            "in_place": local(new).data_ptr() == ptr0,
            "losses": [l1, l2]}


def bucketing():
    """Four lengths under a two-bucket spec: two misses and two hits under
    the session, three keys in the cache, the outputs' live columns."""
    from paddle_tpu_torch import obs
    from paddle_tpu_torch import parallel as pp
    fluid = _fluid()
    w = fluid.layers.data("w", shape=(-1,))
    sq = fluid.layers.elementwise_mul(w, w)
    exe = fluid.Executor(mesh=_mesh(data=2, fsdp=2, tp=2),
                         layout=pp.SpecLayout(), buckets={"w": (8, 16)})
    exe.run(feed={"w": np.ones((2, 20), np.float32)}, fetch_list=[sq])
    reg = obs.MetricsRegistry()
    outs = {}
    with obs.ObsSession(registry=reg).installed():
        for L in (3, 7, 9, 15):
            outs[L], = exe.run(
                feed={"w": np.arange(2 * L, dtype=np.float32)
                      .reshape(2, L)}, fetch_list=[sq])
    return {"misses": sum(v for _, v in
                          reg.counter("fluid.cache_misses_total").samples()),
            "hits": sum(v for _, v in
                        reg.counter("fluid.cache_hits_total").samples()),
            "captures": reg.counter("graphs.captures_total").get(),
            "cache": len(exe._cache), "outs": outs}


def cache_key():
    """The same program on a mesh and off it shares no cache key."""
    fluid = _fluid()
    x = fluid.layers.data("x", shape=(8,))
    out = fluid.layers.fc(x, 8, param_attr={"sharding": ("fsdp", "tp")})
    sc = fluid.Scope()
    exe_rep = fluid.Executor(scope=sc, device="cpu")
    exe_rep.run(fluid.default_startup_program())
    feed = {"x": np.ones((4, 8), np.float32)}
    r_rep, = exe_rep.run(feed=feed, fetch_list=[out])
    exe_sh = fluid.Executor(scope=sc, mesh=_mesh(data=2, fsdp=2, tp=2))
    r_sh, = exe_sh.run(feed=feed, fetch_list=[out])
    k_rep = next(iter(exe_rep._cache))
    k_sh = [k for k in exe_sh._cache if k[3]]
    return {"distinct": all(k != k_rep for k in k_sh) and bool(k_sh),
            "equal": bool(np.array_equal(r_rep, r_sh))}


def restore(scope_np, out_dir):
    """save_persistables on 2x2x2 (before any training run), then
    load_persistables onto data=2 x fsdp=4: the values re-placed by the
    layout there, and the restored program's fetch equal to the saved
    one's."""
    from paddle_tpu_torch import parallel as pp
    from paddle_tpu_torch.parallel.sharding import spec_of
    fluid = _fluid()
    persample, loss = annotated_program(fluid)
    feed = annotated_feed()
    exe = fluid.Executor(scope=_scope(fluid, scope_np),
                         mesh=_mesh(data=2, fsdp=2, tp=2),
                         layout=pp.SpecLayout(roles=False))
    fluid.io.save_persistables(exe, out_dir)
    r1, = exe.run(feed=feed, fetch_list=[persample], donate=False)
    exe2 = fluid.Executor(scope=fluid.Scope(),
                          mesh=_mesh(data=2, fsdp=4),
                          layout=pp.SpecLayout(roles=False))
    fluid.io.load_persistables(exe2, out_dir)
    emb = next(n for n in _params(fluid) if "embedding" in n)
    r2, = exe2.run(feed=feed, fetch_list=[persample], donate=False)
    return {"spec": tuple(spec_of(exe2.scope.get(emb))), "r1": r1,
            "r2": r2}


def textcls(scope_np, feed, steps=3):
    """A small LSTM text classifier (embedding -> dynamic_lstm ->
    sequence_last_step -> fc 2 -> softmax CE -> mean, SGD) on data=8: the
    losses and the final parameters."""
    from paddle_tpu_torch import parallel as pp
    fluid = _fluid()
    words = fluid.layers.data("words", shape=(-1,), dtype="int32")
    lens = fluid.layers.data("lens", shape=(), dtype="int32")
    label = fluid.layers.data("label", shape=(), dtype="int32")
    emb = fluid.layers.embedding(words, (50, 8))
    last = fluid.layers.sequence_last_step(
        fluid.layers.dynamic_lstm(emb, lens, 8), lens)
    logits = fluid.layers.fc(last, 2)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    fluid.SGDOptimizer(0.1).minimize(loss)
    exe = fluid.Executor(scope=_scope(fluid, scope_np),
                         mesh=_mesh(data=8), layout=pp.SpecLayout())
    losses = [float(exe.run(feed=feed, fetch_list=[loss])[0])
              for _ in range(steps)]
    return {"losses": losses,
            "final": {n: _np(exe.scope.get(n)) for n in _params(fluid)}}


def batch_norm_raises():
    """An op that reduces over the batch rows and that the mesh executor
    does not handle (a training batch_norm's statistics) raises naming
    ROADMAP A.7b."""
    fluid = _fluid()
    x = fluid.layers.data("x", shape=(4,))
    y = fluid.layers.batch_norm(x)
    loss = fluid.layers.mean(y)
    exe = fluid.Executor(mesh=_mesh(data=8))
    exe.run(fluid.default_startup_program())
    try:
        exe.run(feed={"x": np.ones((8, 4), np.float32)}, fetch_list=[loss])
    except NotImplementedError as e:
        return str(e)
    return None


def _axis_program(fluid, op_type, axis):
    x = fluid.layers.data("x", shape=(4,))
    b = fluid.default_main_program().global_block()
    out = b.create_var(shape=x.shape, dtype="float32")
    b.append_op(op_type, {"X": [x.name]}, {"Out": [out.name]},
                {"axis": axis})
    return out


def batch_axis_ops():
    """Row-local ops along the batch axis raise naming ROADMAP A.7b
    (l2_normalize and argmax along axis 0, softmax of a 1-d row-sharded
    input); along axis 1 they run and equal the single-device run."""
    feed = {"x": np.random.RandomState(1).randn(8, 4).astype(np.float32)}
    got = {}
    for op_type, axis in (("l2_normalize", 0), ("argmax", 0),
                          ("l2_normalize", 1), ("argmax", -1)):
        fluid = _fluid()
        out = _axis_program(fluid, op_type, axis)
        single, = fluid.Executor(device="cpu").run(feed=feed,
                                                    fetch_list=[out])
        try:
            r, = fluid.Executor(mesh=_mesh(data=8)).run(feed=feed,
                                                         fetch_list=[out])
            got[f"{op_type}:{axis}"] = bool(np.array_equal(r, single))
        except NotImplementedError as e:
            got[f"{op_type}:{axis}"] = str(e)
    fluid = _fluid()
    v = fluid.layers.data("v", shape=())
    sm = fluid.layers.softmax(v)
    try:
        fluid.Executor(mesh=_mesh(data=8)).run(
            feed={"v": np.arange(8, dtype=np.float32)}, fetch_list=[sm])
        got["softmax:1d"] = None
    except NotImplementedError as e:
        got["softmax:1d"] = str(e)
    return got


def dropout_global_mask():
    """A training dropout on data=8 draws the mask one device draws for
    the whole batch: the fetch equals the single-device run's."""
    feed = {"x": np.ones((8, 16), np.float32)}
    outs = []
    for mesh in (None, _mesh(data=8)):
        fluid = _fluid()
        x = fluid.layers.data("x", shape=(16,))
        y = fluid.layers.dropout(x, 0.5)
        exe = (fluid.Executor(device="cpu") if mesh is None
               else fluid.Executor(mesh=mesh))
        exe.run(fluid.default_startup_program())
        outs.append(exe.run(feed=feed, fetch_list=[y])[0])
    return {"equal": bool(np.array_equal(*outs)),
            "dropped": int((outs[1] == 0).sum())}
