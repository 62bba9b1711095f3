"""The port's analysis plane against the JAX package's, on the CPU.

Each program of ``tests/test_analysis.py`` and ``tests/test_dataflow.py``
is built with both packages' fluid API (from fresh default programs, so the
generated names agree), and both planes' diagnostics are held equal by
(code, severity, block, block path, op, op type, var) and message. The
messages the port words differently are L003's array attr (a CUDA graph
freezes the value at capture, where JAX's jit freezes it at trace time),
S003's (which names no XLA) and S001's, which quote each framework's own
error.
``infer_program_shapes`` gives the same shape and dtype as JAX's for
every var of those programs, of random programs, of a program with a
training ``dropout`` and of the v2 layer zoo's networks. ``run(verify=
True)`` refuses a malformed program in both packages, runs a sound one
with the outputs of an unverified run, and ``bench_schema`` gives JAX's
verdicts on the same rows.
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.analysis as JA
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.analysis as TA
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.analysis import bench_schema as jbench
from paddle_tpu_torch.analysis import bench_schema as tbench
from test_torch_v2_layer_zoo import CASES as ZOO
from test_torch_v2_layer_zoo import build_case
from torch_fluid_common import Pair

#: dtypes the port's ops give where JAX's give int32 (ROADMAP C.5: the
#: decoders return int64)
INT64_OPS = {"crf_decoding", "ctc_greedy_decode"}


def _plane(fl):
    return JA if fl is jfluid else TA


# ------------------------------------------------------------- programs --
# each: fl -> dict(prog, feed=None, fetch=(), and analyze_program kwargs)

def while_tensor_array(fl):
    L = fl.layers
    V, T = 5, 6
    table = L.data("table", shape=(V,))
    start = L.data("start", shape=())
    i = L.fill_constant((), "int32", 0)
    n = L.fill_constant((), "int32", T - 1)
    cur = L.cast(start, "int64")
    toks = L.array_write(cur, i, capacity=T)
    cond = L.less_than(i, n)
    with fl.While(cond).block():
        b = fl.default_main_program().current_block()
        row = b.create_var(shape=(V,), dtype="float32")
        b.append_op("gather", {"X": [table.name], "Index": [cur.name]},
                    {"Out": [row.name]})
        _, idx = L.topk(row, 1)
        L.assign(L.cast(L.reshape(idx, ()), "int64"), cur)
        L.increment(i)
        L.array_write(cur, i, array=toks)
        L.less_than(i, n, cond=cond)
    return dict(feed={"table": np.zeros((V, V), np.float32),
                      "start": np.asarray(0.0, np.float32)},
                fetch=[toks.name])


def undefined_input(fl):
    x = fl.layers.data("x", shape=(4,))
    g = fl.default_main_program().global_block()
    out = g.create_var(shape=(-1, 4))
    g.append_op("elementwise_add", {"X": [x.name], "Y": ["ghost"]},
                {"Out": [out.name]})
    return dict(fetch=[out.name])


def unregistered_op(fl):
    fl.layers.fc(fl.layers.data("x", shape=(4,)), 8)
    fl.default_main_program().global_block().ops[0].type = "totally_bogus_op"
    return dict()


def duplicate_write(fl):
    x = fl.layers.data("x", shape=(4,))
    g = fl.default_main_program().global_block()
    a = g.create_var(shape=(-1, 4))
    g.append_op("scale", {"X": [x.name]}, {"Out": [a.name]}, {"scale": 2.0})
    g.append_op("scale", {"X": [x.name]}, {"Out": [a.name]}, {"scale": 3.0})
    c = g.create_var(shape=(-1, 4))
    g.append_op("scale", {"X": [x.name]}, {"Out": [c.name]}, {"scale": 2.0})
    g.append_op("elementwise_add", {"X": [c.name], "Y": [x.name]},
                {"Out": [c.name]})
    return dict(fetch=[a.name, c.name])


def sibling_branch_scope(fl):
    L = fl.layers
    x = L.data("x", shape=())
    outv = L.fill_constant((), "float32", 0.0)
    pred = L.greater_than(x, L.fill_constant((), "float32", 5.0))
    c = fl.Cond(pred)
    with c.true_block():
        doubled = L.elementwise_add(x, x)
        L.assign(doubled, outv)
    with c.false_block():
        b = fl.default_main_program().current_block()
        bad = b.create_var(shape=(), dtype="float32")
        b.append_op("scale", {"X": [doubled.name]}, {"Out": [bad.name]},
                    {"scale": 1.0})
        L.assign(bad, outv)
    return dict(fetch=[outv.name])


def _counting_loop(fl, n_value=3, dtype="int32", shape=()):
    L = fl.layers
    i = L.fill_constant(shape, dtype, 0)
    n = L.fill_constant(shape, dtype, n_value)
    return i, n, L.less_than(i, n)


def bad_sub_block_index(fl):
    i, n, cond = _counting_loop(fl)
    with fl.While(cond).block():
        fl.layers.increment(i)
        fl.layers.less_than(i, n, cond=cond)
    fl.default_main_program().global_block().ops[-1].attrs[
        "sub_block_idx"] = 99
    return dict(fetch=[i.name])


def cyclic_sub_block(fl):
    i, n, cond = _counting_loop(fl)
    with fl.While(cond).block():
        fl.layers.increment(i)
        fl.layers.less_than(i, n, cond=cond)
    prog = fl.default_main_program()
    prog.blocks[1].append_op("while", {"Condition": [cond.name]}, {},
                             {"sub_block_idx": 1})
    return dict(fetch=[i.name])


def while_condition_never_updated(fl):
    i, n, cond = _counting_loop(fl)
    with fl.While(cond).block():
        fl.layers.increment(i)
    return dict(fetch=[i.name])


def shape_mismatch(fl):
    x = fl.layers.data("x", shape=(8,))
    g = fl.default_main_program().global_block()
    g.create_var(name="w", shape=(4, 2), persistable=True)
    o = g.create_var(shape=(-1, 2))
    g.append_op("mul", {"X": [x.name], "Y": ["w"]}, {"Out": [o.name]})
    return dict(fetch=[o.name])


def loop_carry_dtype_change(fl):
    i, n, cond = _counting_loop(fl)
    v = fl.layers.fill_constant((), "float32", 0.0)
    with fl.While(cond).block():
        b = fl.default_main_program().current_block()
        b.append_op("cast", {"X": [v.name]}, {"Out": [v.name]},
                    {"dtype": "int32"})
        fl.layers.increment(i)
        fl.layers.less_than(i, n, cond=cond)
    return dict(fetch=[v.name])


def dead_op(fl):
    L = fl.layers
    x = L.data("x", shape=(4,))
    L.fc(x, 8)
    loss = L.mean(L.elementwise_mul(x, x))
    return dict(fetch=[loss.name],
                severity_overrides={"L001": _plane(fl).Severity.ERROR})


def fetch_undefined(fl):
    fl.layers.fc(fl.layers.data("x", shape=(4,)), 8)
    return dict(fetch=["never_defined"])


def trace_safety_attrs(fl):
    x = fl.layers.data("x", shape=(4,))
    g = fl.default_main_program().global_block()
    o = g.create_var(shape=(-1, 4))
    g.append_op("scale", {"X": [x.name]}, {"Out": [o.name]},
                {"scale": 1.0, "post_hook": lambda v: v})
    o2 = g.create_var(shape=(-1, 4))
    g.append_op("scale", {"X": [o.name]}, {"Out": [o2.name]},
                {"scale": 1.0, "table": np.ones((2, 2), np.float32)})
    fl.layers.fc(x, 4)
    return dict(fetch=[o2.name], run_shapes=False)


def sharding_annotations(fl):
    L = fl.layers
    x = L.data("x", shape=(4,), sharding=("data", None))
    y = L.data("y", shape=(4,), sharding=("warp", "warp"))
    g = fl.default_main_program().global_block()
    o = g.create_var(shape=(-1, 4))
    g.append_op("scale", {"X": [x.name]}, {"Out": [o.name]},
                {"scale": 1.0, "sharding": 7})
    return dict(fetch=[x.name, y.name, o.name])


def sharding_pinned_axes(fl):
    out = sharding_annotations(fl)
    out["mesh_axes"] = ["data", "model"]
    return out


def unused_var(fl):
    fl.layers.data("x", shape=(4,))
    fl.default_main_program().global_block().create_var(name="orphan",
                                                        shape=(3,))
    return dict()


def read_after_donate(fl, donate=None):
    """v aliases persistable w, sgd overwrites w, then v is read."""
    prog = fl.default_main_program()
    b = prog.global_block()
    w = b.create_var(name="w", shape=[4], dtype="float32", persistable=True)
    x = fl.layers.data(name="x", shape=[4], dtype="float32")
    v = b.create_var(name="v", shape=[4], dtype="float32")
    b.append_op("reshape", {"X": [w.name]}, {"Out": [v.name]}, {"shape": [4]})
    g = b.create_var(name="g", shape=[4], dtype="float32")
    b.append_op("fill_constant", {}, {"Out": [g.name]},
                {"shape": [4], "dtype": "float32", "value": 1.0})
    lr = b.create_var(name="lr", shape=[1], dtype="float32")
    b.append_op("fill_constant", {}, {"Out": [lr.name]},
                {"shape": [1], "dtype": "float32", "value": 0.1})
    b.append_op("sgd", {"Param": [w.name], "Grad": [g.name],
                        "LearningRate": [lr.name]},
                {"ParamOut": [w.name]}, {"learning_rate": 0.1})
    z = b.create_var(name="z", shape=[4], dtype="float32")
    b.append_op("elementwise_add", {"X": [v.name], "Y": [x.name]},
                {"Out": [z.name]}, {})
    return dict(fetch=[z.name], donate=donate,
                feed={"x": np.zeros(4, np.float32)})


def read_after_donate_donated(fl):
    return read_after_donate(fl, donate=True)


def read_after_donate_kept(fl):
    return read_after_donate(fl, donate=False)


def adam_training(fl):
    L = fl.layers
    loss = L.mean(L.fc(input=L.data(name="x", shape=[8], dtype="float32"),
                       size=4))
    fl.AdamOptimizer(1e-3).minimize(loss)
    return dict(fetch=[loss.name], donate=True,
                feed={"x": np.ones((2, 8), np.float32)})


def dead_write_across_sub_block(fl):
    L = fl.layers
    t = L.fill_constant(shape=[1], dtype="float32", value=1.0)
    i, n, cond = _counting_loop(fl, 2, "int64", [1])
    with fl.While(cond).block():
        L.assign(L.fill_constant(shape=[1], dtype="float32", value=2.0), t)
        L.increment(i)
        L.less_than(i, n, cond=cond)
    L.assign(L.fill_constant(shape=[1], dtype="float32", value=3.0), t)
    return dict(fetch=[L.relu(t).name])


def loop_carried_state(fl):
    L = fl.layers
    i, n, cond = _counting_loop(fl, 3, "int64", [1])
    acc = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    with fl.While(cond).block():
        L.assign(L.elementwise_add(acc, acc), acc)
        L.increment(i)
        L.less_than(i, n, cond=cond)
    return dict(fetch=[acc.name])


def alias_escape(fl):
    L = fl.layers
    m = L.fill_constant(shape=[4], dtype="float32", value=1.0)
    i, n, cond = _counting_loop(fl, 2, "int64", [1])
    with fl.While(cond).block():
        v = L.reshape(m, shape=[2, 2])
        L.reduce_sum(v)
        b = fl.default_main_program().current_block()
        fresh = b.create_var(shape=[2, 2], dtype="float32")
        b.append_op("assign", {"X": [v.name]}, {"Out": [fresh.name]}, {})
        L.increment(i)
        L.less_than(i, n, cond=cond)
    return dict()


def structural_errors_gate_dataflow(fl):
    b = fl.default_main_program().global_block()
    out = b.create_var(shape=[4], dtype="float32")
    b.append_op("elementwise_add", {"X": ["ghost"], "Y": ["ghost2"]},
                {"Out": [out.name]}, {})
    return dict()


def nested_whiles(fl):
    L = fl.layers
    i, n, cond = _counting_loop(fl, 2, "int64", [1])
    with fl.While(cond).block():
        j, m, cond2 = _counting_loop(fl, 2, "int64", [1])
        with fl.While(cond2).block():
            L.increment(j)
            L.less_than(j, m, cond=cond2)
        L.increment(i)
        L.less_than(i, n, cond=cond)
    return dict(fetch=[i.name])


def training_dropout(fl):
    L = fl.layers
    x = L.data("x", shape=(6,))
    h = L.dropout(L.fc(x, 8, act="relu"), 0.5, is_test=False)
    loss = L.mean(L.fc(h, 2))
    fl.SGDOptimizer(0.1).minimize(loss)
    return dict(fetch=[loss.name], feed={"x": np.ones((3, 6), np.float32)})


def golden_lstm_text_model(fl):
    from test_torch_v2_layer_zoo import pkg
    P = pkg(fl)
    words = P.L.data("words", P.DT.integer_value_sequence(100))
    label = P.L.data("label", P.DT.integer_value(2))
    lstm = P.L.lstmemory(P.L.embedding(words, 16), 16)
    cost = P.L.classification_cost(P.L.fc(P.L.pooling(lstm, "max"), 2),
                                   label)
    return dict(fetch=[cost.var.name])


PROGRAMS = {f.__name__: f for f in (
    while_tensor_array, undefined_input, unregistered_op, duplicate_write,
    sibling_branch_scope, bad_sub_block_index, cyclic_sub_block,
    while_condition_never_updated, shape_mismatch, loop_carry_dtype_change,
    dead_op, fetch_undefined, trace_safety_attrs, sharding_annotations,
    sharding_pinned_axes, unused_var, read_after_donate,
    read_after_donate_donated, read_after_donate_kept, adam_training,
    dead_write_across_sub_block, loop_carried_state, alias_escape,
    structural_errors_gate_dataflow, nested_whiles, training_dropout,
    golden_lstm_text_model)}


def _build(name, fl):
    fl.reset_default_programs()
    spec = PROGRAMS[name](fl)
    spec["prog"] = fl.default_main_program()
    return spec


def _analyze(fl, spec):
    kw = {k: spec[k] for k in ("fetch", "mesh_axes", "severity_overrides",
                               "donate", "run_shapes") if k in spec}
    feed = spec.get("feed")
    if fl is tfluid and feed is not None:
        feed = {k: torch.from_numpy(np.asarray(v)) for k, v in feed.items()}
    return _plane(fl).analyze_program(spec["prog"], feed=feed, **kw)


def _key(d):
    return (d.code, d.severity.name, d.block_idx, d.block_path, d.op_idx,
            d.op_type, d.var)


def _message(d):
    """The message, with the wordings the port changes taken out: S001
    quotes the framework's own error, L003's array attr and S003 name what
    freezes a value on each side."""
    if d.code == "S001" or (d.code == "L003"
                            and "baked into the desc" in d.message):
        return d.code
    if d.code == "S003":
        return d.message.replace("(XLA loop", "(loop")
    return d.message


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_diagnostics_equal_jax(name):
    jspec, tspec = _build(name, jfluid), _build(name, tfluid)
    want, got = _analyze(jfluid, jspec), _analyze(tfluid, tspec)
    assert sorted(map(_key, got), key=repr) == \
        sorted(map(_key, want), key=repr), TA.format_diagnostics(got)
    assert sorted(map(_message, got)) == sorted(map(_message, want))
    assert [d.hint for d in got if d.code != "L011"] == \
        [d.hint for d in want if d.code != "L011"]


def test_the_l003_array_message_names_graph_capture():
    spec = _build("trace_safety_attrs", tfluid)
    msgs = [d.message for d in _analyze(tfluid, spec) if d.code == "L003"]
    assert any("under a CUDA graph its value is frozen at capture" in m
               for m in msgs), msgs


# ------------------------------------------------------- shape inference --

def _shape_env(fl, prog, feed_shapes):
    env, diags = _plane(fl).infer_program_shapes(prog,
                                                 feed_shapes=feed_shapes)
    return env, diags


def _described(env, plane):
    out = {}
    for name, v in env.items():
        if v is plane.UNKNOWN:
            out[name] = None
        else:
            out[name] = (tuple(int(s) for s in v.shape),
                         plane.shape_infer.dtype_name(v.dtype)
                         if plane is TA else np.dtype(v.dtype).name)
    return out


def _int64_vars(prog):
    return {n for b in prog.blocks for op in b.ops if op.type in INT64_OPS
            for n in op.output_vars()}


def _assert_shapes_equal(jprog, tprog, feed):
    shapes = {k: (np.asarray(v).shape, np.asarray(v).dtype.name)
              for k, v in (feed or {}).items()}
    jenv, jd = _shape_env(jfluid, jprog, shapes)
    tenv, td = _shape_env(tfluid, tprog, shapes)
    assert sorted(map(_key, td), key=repr) == sorted(map(_key, jd), key=repr)
    want, got = _described(jenv, JA), _described(tenv, TA)
    assert set(got) == set(want)
    wide = _int64_vars(tprog)
    checked = 0
    for name, w in want.items():
        g = got[name]
        if name in wide and w is not None and w[1] == "int32":
            w = (w[0], "int64")
        assert g == w, (name, g, w)
        checked += w is not None
    return checked


#: a sub-block that runs itself: shape inference recurses until Python's
#: recursion limit, which each plane meets at another op (analyze_program
#: never infers it: V004 stops it first)
_RECURSIVE = {"cyclic_sub_block"}


@pytest.mark.parametrize("name", sorted(set(PROGRAMS) - _RECURSIVE))
def test_program_shapes_equal_jax(name):
    jspec, tspec = _build(name, jfluid), _build(name, tfluid)
    _assert_shapes_equal(jspec["prog"], tspec["prog"], jspec.get("feed"))


def test_training_dropout_infers_a_shape():
    """A random op infers on meta tensors with nothing drawn (JAX's
    eval_shape infers it too), so the training program has no S001."""
    tspec = _build("training_dropout", tfluid)
    env, diags = TA.infer_program_shapes(
        tspec["prog"], feed_shapes={"x": ((3, 6), "float32")})
    assert not TA.errors(diags), TA.format_diagnostics(diags)
    drop = [op for op in tspec["prog"].global_block().ops
            if op.type == "dropout"]
    assert drop and not drop[0].attrs.get("is_test", True)
    out = env[drop[0].outputs["Out"][0]]
    assert tuple(out.shape) == (3, 8) and out.device.type == "meta"


@pytest.mark.parametrize("name", sorted(ZOO))
def test_v2_zoo_shapes_equal_jax(name):
    pair, spec = build_case(name)
    checked = _assert_shapes_equal(pair.jmain, pair.tmain, spec["feed"])
    assert checked >= len(pair.tmain.global_block().ops) // 2


_PROP_UNARY = ("relu", "sigmoid", "tanh", "exp", "abs")
_PROP_BINARY = ("elementwise_add", "elementwise_mul", "elementwise_sub")


def _random_program(fl, rs):
    """``tests/test_dataflow.py``'s random straight-line program."""
    batch, width = int(rs.randint(1, 5)), int(rs.randint(2, 7))
    fl.layers.data(name="px", shape=[width], dtype="float32")
    b = fl.default_main_program().global_block()
    feeds = {"px": rs.randn(batch, width).astype(np.float32)}
    avail = [("px", width)]
    for _ in range(int(rs.randint(2, 7))):
        name, w = avail[rs.randint(len(avail))]
        kind = rs.randint(5)
        out = b.create_var(shape=[-1, w], dtype="float32")
        if kind == 0:
            b.append_op(_PROP_UNARY[rs.randint(len(_PROP_UNARY))],
                        {"X": [name]}, {"Out": [out.name]}, {})
            avail.append((out.name, w))
        elif kind == 1:
            other = [n for n, ww in avail if ww == w]
            b.append_op(_PROP_BINARY[rs.randint(len(_PROP_BINARY))],
                        {"X": [name], "Y": [other[rs.randint(len(other))]]},
                        {"Out": [out.name]}, {})
            avail.append((out.name, w))
        elif kind == 2:
            w2 = int(rs.randint(2, 7))
            wm = b.create_var(shape=[w, w2], dtype="float32",
                              persistable=True)
            out2 = b.create_var(shape=[-1, w2], dtype="float32")
            b.append_op("matmul", {"X": [name], "Y": [wm.name]},
                        {"Out": [out2.name]}, {})
            avail.append((out2.name, w2))
        elif kind == 3:
            out2 = b.create_var(shape=[-1], dtype="float32")
            b.append_op("reduce_sum", {"X": [name]}, {"Out": [out2.name]},
                        {"dim": [1], "keep_dim": False})
        else:
            out2 = b.create_var(shape=[-1, w], dtype="float16")
            b.append_op("cast", {"X": [name]}, {"Out": [out2.name]},
                        {"dtype": "float16"})
    return fl.default_main_program(), feeds


@pytest.mark.parametrize("seed", range(8))
def test_random_program_shapes_equal_jax(seed):
    progs = {}
    for fl in (jfluid, tfluid):
        fl.reset_default_programs()
        progs[fl] = _random_program(fl, np.random.RandomState(seed))
    (jprog, feeds), (tprog, _) = progs[jfluid], progs[tfluid]
    assert _assert_shapes_equal(jprog, tprog, feeds) >= 2


# ------------------------------------------------------- executor wiring --

def test_verify_true_refuses_a_malformed_program_in_both():
    for fl in (jfluid, tfluid):
        spec = _build("undefined_input", fl)
        kw = {"device": "cpu"} if fl is tfluid else {}
        exe = fl.Executor(scope=fl.Scope(), **kw)
        with pytest.raises(_plane(fl).ProgramVerificationError) as ei:
            exe.run(spec["prog"], feed={"x": np.zeros((2, 4), np.float32)},
                    fetch_list=spec["fetch"], verify=True)
        assert [d.code for d in ei.value.diagnostics
                if d.severity.name == "ERROR"] == ["V001"]


def test_verify_true_refuses_a_bad_feed_shape():
    tfluid.reset_default_programs()
    L = tfluid.layers
    out = L.elementwise_add(L.data("x", shape=(4,)), L.data("w", shape=(4,)))
    exe = tfluid.Executor(scope=tfluid.Scope(), device="cpu")
    with pytest.raises(TA.ProgramVerificationError) as ei:
        exe.run(feed={"x": np.zeros((2, 4), np.float32),
                      "w": np.zeros((2, 5), np.float32)},
                fetch_list=[out], verify=True)
    assert any(d.code == "S001" for d in ei.value.diagnostics)


def test_verify_true_l011_follows_the_donation_switch():
    """donate=True: JAX's L011 refusal; donate=False: a warning only, and
    the run reads the value from before the update."""
    for donate in (True, False):
        spec = _build("read_after_donate", tfluid)
        exe = tfluid.Executor(scope=tfluid.Scope(), device="cpu")
        exe.scope.set("w", np.arange(4, dtype=np.float32))
        run = lambda: exe.run(spec["prog"], feed=spec["feed"],  # noqa: E731
                              fetch_list=spec["fetch"], verify=True,
                              donate=donate)
        if donate:
            with pytest.raises(TA.ProgramVerificationError) as ei:
                run()
            s = str(ei.value)
            assert "L011" in s and "block 0, op #3 (sgd)" in s
        else:
            out, = run()
            np.testing.assert_array_equal(out, np.arange(4, dtype=np.float32))


def test_verified_training_equals_unverified_and_is_memoized():
    def build(fl):
        L = fl.layers
        x = L.data("x", shape=(6,))
        loss = L.mean(L.fc(L.fc(x, 8, act="tanh"), 2))
        fl.AdamOptimizer(1e-2).minimize(loss)
        return loss
    feed = {"x": np.random.RandomState(1).randn(3, 6).astype(np.float32)}
    runs = []
    for verify in (False, True):
        p = Pair(build)
        outs = [p.texe.run(p.tmain, feed=feed, fetch_list=[p.tout.name],
                           verify=verify)[0] for _ in range(3)]
        runs.append((outs, {n: p.texe.scope.get(n).clone()
                            for n in p.texe.scope.vars}))
        if verify:
            assert len(p.texe._verified) == 1
    (a, sa), (b, sb) = runs
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for n in sa:
        assert torch.equal(sa[n], sb[n]), n


def test_verify_true_warns_nothing_on_a_sound_training_program():
    spec = _build("adam_training", tfluid)
    exe = tfluid.Executor(scope=tfluid.Scope(), device="cpu")
    exe.run(tfluid.default_startup_program())
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        l0, = exe.run(spec["prog"], feed=spec["feed"],
                      fetch_list=spec["fetch"], verify=True, donate=True)
        l1, = exe.run(spec["prog"], feed=spec["feed"],
                      fetch_list=spec["fetch"], verify=True, donate=True)
    assert not [w for w in rec if "L011" in str(w.message)]
    assert float(l1) != float(l0)


# ----------------------------------------------------------- the rest --

def test_the_public_surface_equals_jax():
    assert sorted(TA.__all__) == sorted(JA.__all__)
    assert TA.LINT_CATALOGUE.keys() == JA.LINT_CATALOGUE.keys()
    for code, (name, sev) in JA.LINT_CATALOGUE.items():
        assert TA.LINT_CATALOGUE[code][0] == name
        assert TA.LINT_CATALOGUE[code][1].name == sev.name


@pytest.mark.parametrize("lint", ["lint_catalogue_drift", "lint_alert_rules",
                                  "lint_autotune_cache"])
def test_obs_and_tune_lints_raise_naming_a8(lint):
    """The tune lint (L008) raises naming A.8; the obs lints run since the
    port has the session plane: clean over the port's tree and rules."""
    if lint == "lint_autotune_cache":
        with pytest.raises(NotImplementedError, match="A.8"):
            getattr(TA, lint)()
    else:
        assert getattr(TA, lint)() == []


def test_metric_name_lint_equals_jax():
    cat = {"trainer.steps_total": ("counter", "steps"),
           "trainer.step_seconds": ("histogram", "s"),
           "BadName": ("gauge", "x"), "serving.queue_total": ("gauge", "q"),
           "data.rows": ("counter", "r", ("path",))}
    samples = [{"name": "data.rows", "labels": {"file": "/a/b"}}]
    want = JA.lint_metric_names(cat, samples=samples)
    got = TA.lint_metric_names(cat, samples=samples)
    assert [(d.code, d.var, d.message) for d in got] == \
        [(d.code, d.var, d.message) for d in want]


def test_bench_schema_verdicts_equal_jax():
    rows = [
        {"metric": "tokens_per_sec", "value": 10.0, "unit": "tok/s",
         "vs_baseline": 1.0},
        {"metric": "x", "value": None, "unit": "ms"},
        {"metric": "train_speedup_x", "value": 2.0, "unit": "x",
         "vs_baseline": None, "methodology": "guessed"},
        {"metric": "decode_tpot_ms", "value": 3.0, "unit": "ms",
         "vs_baseline": 0.9, "plan_source": "tuned"},
        "not a row",
    ]
    for r in rows:
        assert tbench.validate_row(r) == jbench.validate_row(r), r
    assert tbench.validate_rows(rows) == jbench.validate_rows(rows)


def test_topology_programs_lint_clean_in_both():
    """The golden LSTM config's startup and main programs: no error in
    either plane."""
    for fl in (jfluid, tfluid):
        spec = _build("golden_lstm_text_model", fl)
        plane = _plane(fl)
        for prog in (spec["prog"], fl.default_startup_program()):
            assert not plane.errors(plane.analyze_program(prog))
