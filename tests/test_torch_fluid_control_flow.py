"""The port's fluid control flow and expanded registry against the JAX
package, on the CPU: the counterparts of tests/test_fluid_control_flow.py
on the same programs (While, Cond, StaticRNN, TensorArrays, training
batch norm, the CRF tagger, a while-loop greedy decode), plus
``beam_search_gen``. Fetches agree at atol and rtol 1e-5 (f32, the
summation order only). A block holding a While or a Cond runs eagerly on
the port (its predicate is read on the host) and is counted."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from torch_fluid_common import Pair, host


@pytest.fixture(autouse=True)
def fresh_programs():
    for f in (jfluid, tfluid):
        f.reset_default_programs()
        f.executor._global_scope = f.Scope()
    yield


def _accumulate(fl):
    layers = fl.layers
    i = layers.fill_constant((), "int32", 0)
    n = layers.fill_constant((), "int32", 10)
    acc = layers.fill_constant((), "int32", 0)
    cond = layers.less_than(i, n)
    with fl.While(cond).block():
        layers.elementwise_add(acc, i)
        b = fl.default_main_program().current_block()
        b.append_op("elementwise_add", {"X": [acc.name], "Y": [i.name]},
                    {"Out": [acc.name]})
        layers.increment(i)
        layers.less_than(i, n, cond=cond)
    return acc, i


def test_while_loop_accumulates():
    p = Pair(_accumulate, startup=False)
    j, t = p.run({}, list(p.tout))
    assert int(t[0]) == int(j[0]) == 45 and int(t[1]) == 10
    assert p.texe.stats["eager_runs"] == 1


def test_while_requires_cond_update():
    def build(fl):
        i = fl.layers.fill_constant((), "int32", 0)
        n = fl.layers.fill_constant((), "int32", 3)
        cond = fl.layers.less_than(i, n)
        with fl.While(cond).block():
            fl.layers.increment(i)
        return i
    p = Pair(build, startup=False)
    with pytest.raises(ValueError, match="never updated"):
        p.texe.run(p.tmain, feed={}, fetch_list=[p.tout])


def test_while_array_write_read():
    cap = 8

    def build(fl):
        layers = fl.layers
        i = layers.fill_constant((), "int32", 0)
        n = layers.fill_constant((), "int32", cap)
        sq = layers.fill_constant((), "float32", 0.0)
        arr = layers.array_write(sq, i, capacity=cap)
        cond = layers.less_than(i, n)
        with fl.While(cond).block():
            fi = layers.cast(i, "float32")
            layers.array_write(layers.elementwise_mul(fi, fi), i, array=arr)
            layers.increment(i)
            layers.less_than(i, n, cond=cond)
        return arr
    p = Pair(build, startup=False)
    j, t = p.run({}, [p.tout])
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[0], np.arange(cap, dtype=np.float32) ** 2)


def _branches(fl, sibling_read=False):
    layers = fl.layers
    x = layers.data("x", shape=())
    out = layers.fill_constant((), "float32", 0.0)
    thresh = layers.fill_constant((), "float32", 5.0)
    c = fl.Cond(layers.greater_than(x, thresh))
    with c.true_block():
        doubled = layers.elementwise_add(x, x)
        layers.assign(doubled, out)
    with c.false_block():
        if sibling_read:
            b = fl.default_main_program().current_block()
            bad = b.create_var(shape=(), dtype="float32")
            b.append_op("scale", {"X": [doubled.name]}, {"Out": [bad.name]},
                        {"scale": 1.0})
            layers.assign(bad, out)
        else:
            layers.assign(x, out)
    return out, doubled


def test_conditional_block_both_branches():
    p = Pair(_branches, startup=False)
    hi = p.run({"x": np.float32(7.0)}, [p.tout[0]])
    lo = p.run({"x": np.float32(3.0)}, [p.tout[0]])
    assert float(hi[1][0]) == float(hi[0][0]) == 14.0
    assert float(lo[1][0]) == float(lo[0][0]) == 3.0


def test_sibling_branch_read_rejected_by_verifier():
    """Both verifiers reject a read of a sibling branch's var (V001, on
    that var) before any op runs."""
    from paddle_tpu.analysis import ProgramVerificationError as JError
    from paddle_tpu_torch.analysis import ProgramVerificationError as TError
    p = Pair(lambda fl: _branches(fl, sibling_read=True), startup=False)
    errs = []
    for exe, prog, out, error in ((p.jexe, p.jmain, p.jout, JError),
                                  (p.texe, p.tmain, p.tout, TError)):
        with pytest.raises(error) as ei:
            exe.run(prog, feed={"x": np.float32(3.0)},
                    fetch_list=[out[0]], verify=True)
        errs.append([(d.code, d.var) for d in ei.value.diagnostics
                     if d.severity.name == "ERROR"])
    assert errs[1] == errs[0] == [("V001", p.tout[1].name)]


def test_sibling_branch_read_fails_cleanly_at_trace_time():
    """The false branch reading the true branch's var fails with the var's
    name and the op site, as JAX's trace does."""
    p = Pair(lambda fl: _branches(fl, sibling_read=True), startup=False)
    out, doubled = p.tout
    with pytest.raises(Exception) as ei:
        p.texe.run(p.tmain, feed={"x": np.float32(3.0)}, fetch_list=[out])
    msg = str(ei.value) + "\n".join(getattr(ei.value, "__notes__", []))
    assert doubled.name in msg and "op #" in msg and "(scale)" in msg


def test_while_body_var_not_visible_after_loop():
    """A temp defined only inside a while body is out of scope after it:
    a global-block read of it fails naming the var and the site."""
    def build(fl):
        layers = fl.layers
        i = layers.fill_constant((), "int32", 0)
        n = layers.fill_constant((), "int32", 3)
        cond = layers.less_than(i, n)
        with fl.While(cond).block():
            b = fl.default_main_program().current_block()
            tmp = b.create_var(shape=(), dtype="int32")
            b.append_op("scale", {"X": [i.name]}, {"Out": [tmp.name]},
                        {"scale": 2.0})
            layers.increment(i)
            layers.less_than(i, n, cond=cond)
        g = fl.default_main_program().global_block()
        leak = g.create_var(shape=(), dtype="int32")
        g.append_op("scale", {"X": [tmp.name]}, {"Out": [leak.name]},
                    {"scale": 1.0})
        return leak, tmp
    p = Pair(build, startup=False)
    leak, tmp = p.tout
    with pytest.raises(KeyError) as ei:
        p.texe.run(p.tmain, feed={}, fetch_list=[leak])
    msg = str(ei.value) + "\n".join(getattr(ei.value, "__notes__", []))
    assert tmp.name in msg and "block 0, op #" in msg


def test_static_rnn_matches_manual_accumulation():
    B, T, D = 2, 5, 3

    def build(fl):
        x = fl.layers.data("x", shape=(T, D))
        rnn = fl.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(shape=(D,), value=0.0, batch_ref=x_t)
            h_new = fl.layers.elementwise_add(h, x_t)
            rnn.update_memory(h, h_new)
            rnn.step_output(h_new)
        return rnn()[0]
    p = Pair(build, startup=False)
    xs = np.random.RandomState(0).randn(B, T, D).astype(np.float32)
    j, t = p.run({"x": xs}, [p.tout])
    np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
    np.testing.assert_allclose(t[0], np.cumsum(xs, axis=1), rtol=1e-5)
    assert p.texe.stats["eager_runs"] == 0      # no host predicate


def test_static_rnn_trains_through_scan():
    B, T, D, H = 4, 6, 3, 8

    def build(fl):
        layers = fl.layers
        x = layers.data("x", shape=(T, D))
        y = layers.data("y", shape=(), dtype="int64")
        rnn = fl.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(shape=(H,), value=0.0, batch_ref=x_t)
            h_new = layers.fc(layers.concat([x_t, h], axis=1), H, act="tanh")
            rnn.update_memory(h, h_new)
            rnn.step_output(h_new)
        rnn()
        logits = layers.fc(rnn.get_last_mem(h), 2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        fl.AdamOptimizer(0.05).minimize(loss)
        return loss
    p = Pair(build)
    rng = np.random.RandomState(1)
    xs = rng.randn(B, T, D).astype(np.float32)
    feed = {"x": xs, "y": (xs.sum(axis=(1, 2)) > 0).astype(np.int64)}
    losses = [float(o[0]) for o in p.steps(3, feed, [p.tout], atol=1e-4,
                                           rtol=1e-4)]
    for _ in range(27):
        losses.append(float(p.texe.run(p.tmain, feed=feed,
                                       fetch_list=[p.tout])[0]))
    assert losses[-1] < losses[0] * 0.7


def test_batch_norm_trains_and_updates_stats():
    def build(fl):
        layers = fl.layers
        img = layers.data("img", shape=(8, 8, 3))
        label = layers.data("label", shape=(), dtype="int64")
        c = layers.conv2d(img, num_filters=4, filter_size=3, act=None)
        bn = layers.batch_norm(c, act="relu")
        logits = layers.fc(layers.pool2d(bn, global_pooling=True), 2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        fl.SGDOptimizer(0.1).minimize(loss)
        return loss
    p = Pair(build)
    mean_name = [n for n in p.texe.scope.vars if "bn_mean" in n][0]
    mean0 = host(p.texe.scope.get(mean_name)).copy()
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(8, 8, 8, 3).astype(np.float32) + 2.0,
            "label": rng.randint(0, 2, size=(8,)).astype(np.int64)}
    losses = [float(o[0]) for o in p.steps(5, feed, [p.tout], atol=1e-4,
                                           rtol=1e-4)]
    p.assert_scopes_close(atol=1e-4, rtol=1e-4)
    for _ in range(5):
        losses.append(float(p.texe.run(p.tmain, feed=feed,
                                       fetch_list=[p.tout])[0]))
    assert losses[-1] < losses[0]
    assert np.abs(host(p.texe.scope.get(mean_name)) - mean0).max() > 1e-3


def test_crf_tagger_in_ir_trains_and_decodes():
    B, T, D, N = 8, 6, 5, 3

    def build(fl):
        layers = fl.layers
        x = layers.data("x", shape=(T, D))
        tags = layers.data("tags", shape=(T,), dtype="int32")
        lengths = layers.data("lengths", shape=(), dtype="int32")
        emission = layers.reshape(layers.fc(layers.reshape(x, (-1, D)), N),
                                  (B, T, N))
        nll, trans = layers.linear_chain_crf(emission, tags, lengths)
        loss = layers.mean(nll)
        fl.AdamOptimizer(0.1).minimize(loss)
        return loss, layers.crf_decoding(emission, lengths, trans)
    p = Pair(build)
    rng = np.random.RandomState(0)
    xs = rng.randn(B, T, D).astype(np.float32)
    ys = np.argmax(xs[:, :, :N], axis=-1).astype(np.int32)
    feed = {"x": xs, "tags": ys, "lengths": np.full((B,), T, np.int32)}
    loss, path = p.tout
    losses = [float(o[0]) for o in p.steps(3, feed, [loss], atol=1e-4,
                                           rtol=1e-4)]
    for _ in range(57):
        losses.append(float(p.texe.run(p.tmain, feed=feed,
                                       fetch_list=[loss])[0]))
    assert losses[-1] < losses[0] * 0.5
    decoded, = p.texe.run(p.tmain, feed=feed, fetch_list=[path])
    assert (decoded == ys).mean() > 0.9


def test_while_loop_greedy_decode():
    V, T = 5, 6

    def build(fl):
        layers = fl.layers
        table = layers.data("table", shape=(V,))
        start = layers.data("start", shape=())
        i = layers.fill_constant((), "int32", 0)
        n = layers.fill_constant((), "int32", T - 1)
        cur = layers.cast(start, "int64")
        toks = layers.array_write(cur, i, capacity=T)
        cond = layers.less_than(i, n)
        with fl.While(cond).block():
            b = fl.default_main_program().current_block()
            row = b.create_var(shape=(V,), dtype="float32")
            b.append_op("gather", {"X": [table.name], "Index": [cur.name]},
                        {"Out": [row.name]})
            _, idx = layers.topk(row, 1)
            layers.assign(layers.cast(layers.reshape(idx, ()), "int64"), cur)
            layers.increment(i)
            layers.array_write(cur, i, array=toks)
            layers.less_than(i, n, cond=cond)
        return toks
    p = Pair(build, startup=False)
    table = np.random.RandomState(0).randn(V, V).astype(np.float32)
    j, t = p.run({"table": table, "start": np.int32(2)}, [p.tout])
    want = [2]
    for _ in range(T - 1):
        want.append(int(np.argmax(table[want[-1]])))
    np.testing.assert_array_equal(t[0][:T], np.asarray(want)[:T])
    np.testing.assert_array_equal(t[0], np.asarray(j[0]))


def test_new_optimizer_ops_registered_and_run():
    """The port registers every op type JAX does (the sweep of each op's
    values is tests/test_torch_fluid_registry.py)."""
    from paddle_tpu.fluid.registry import OpRegistry as J
    assert tfluid.OpRegistry.registered() == J.registered()
    assert len(tfluid.OpRegistry.registered()) >= 110


def test_bn_stats_not_trainable_and_not_decayed():
    def build(fl):
        img = fl.layers.data("img", shape=(4, 4, 2))
        bn = fl.layers.batch_norm(fl.layers.conv2d(img, 2, 3, padding=1))
        loss = fl.layers.mean(bn)
        params = [v.name for v in
                  fl.default_main_program().global_block().all_parameters()]
        fl.SGDOptimizer(0.1).minimize(loss, regularization=fl.L2Decay(0.5))
        return loss, params
    p = Pair(build)
    assert not any("bn_mean" in n or "bn_var" in n for n in p.tout[1])
    xs = np.random.RandomState(0).randn(4, 4, 4, 2).astype(np.float32)
    p.steps(5, {"img": xs}, [p.tout[0]], atol=1e-4, rtol=1e-4)
    var_name = [n for n in p.texe.scope.vars if "bn_var" in n][0]
    v = host(p.texe.scope.get(var_name))
    np.testing.assert_allclose(v, np.asarray(p.jexe.scope.get(var_name)),
                               rtol=1e-4)
    assert v.min() > 0.1


def test_persistable_written_in_while_subblock_syncs():
    def build(fl):
        layers = fl.layers
        main = fl.default_main_program()
        counter = main.global_block().create_var(
            name="counter", shape=(), dtype="float32", persistable=True,
            trainable=False)
        i = layers.fill_constant((), "int32", 0)
        n = layers.fill_constant((), "int32", 4)
        cond = layers.less_than(i, n)
        one = layers.fill_constant((), "float32", 1.0)
        with fl.While(cond).block():
            main.current_block().append_op(
                "elementwise_add", {"X": [counter.name], "Y": [one.name]},
                {"Out": [counter.name]})
            layers.increment(i)
            layers.less_than(i, n, cond=cond)
        return i
    p = Pair(build, startup=False)
    p.jexe.scope.set("counter", np.float32(0.0))
    p.texe.scope.set("counter", np.float32(0.0))
    p.run({}, [p.tout])
    assert float(host(p.texe.scope.get("counter"))) == 4.0 == \
        float(np.asarray(p.jexe.scope.get("counter")))


def test_beam_search_gen_matches_jax():
    """A beam_search_gen op over a step block (an fc over the token's
    embedding and a memory) gives JAX's tokens and scores, inside the
    port's graph route (no host predicate)."""
    V, E, B, K, L = 7, 4, 2, 3, 5

    def build(fl):
        layers = fl.layers
        main = fl.default_main_program()
        g = main.global_block()
        boot = layers.data("boot", shape=(E,))
        emb = layers.embedding(layers.data("ids", shape=(), dtype="int32"),
                               (V, E))
        embed_w = main.global_block().ops[-1].inputs["W"][0]
        sub = main.create_block()
        with main.block_guard(sub):
            tok = sub.create_var(shape=(-1, E), dtype="float32")
            mem = sub.create_var(shape=(-1, E), dtype="float32")
            h = layers.fc(layers.concat([tok, mem], axis=1), E, act="tanh")
            probs = layers.softmax(layers.fc(h, V))
        toks = g.create_var(shape=(-1, K, L), dtype="int32")
        scores = g.create_var(shape=(-1, K), dtype="float32")
        g.append_op("beam_search_gen", {"Embed": [embed_w]},
                    {"Tokens": [toks.name], "Scores": [scores.name]},
                    {"sub_block_idx": sub.idx, "embed_param": embed_w,
                     "token_embed_name": tok.name, "static_outer": [],
                     "static_in_names": [], "boot_mems": [boot.name],
                     "mem_names": [mem.name], "mem_update_names": [h.name],
                     "prob_name": probs.name, "beam_size": K,
                     "max_length": L, "bos_id": 0, "eos_id": 1,
                     "length_penalty": 0.0, "constraint": ""})
        return toks, scores, emb
    p = Pair(build)
    boot = np.random.RandomState(3).randn(B, E).astype(np.float32)
    j, t = p.run({"boot": boot, "ids": np.zeros((B,), np.int32)},
                 list(p.tout[:2]))
    np.testing.assert_array_equal(t[0], np.asarray(j[0]))
    np.testing.assert_allclose(t[1], np.asarray(j[1]), atol=1e-5, rtol=1e-5)
    assert p.texe.stats["eager_runs"] == 0
