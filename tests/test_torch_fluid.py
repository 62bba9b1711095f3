"""The port's fluid plane (Program IR + Executor) against the JAX package,
on the CPU: the counterparts of tests/test_fluid.py, on the same
programs. Each program is built with both packages' fluid API, JAX's
startup weights reach the port through ``convert.scope_from_numpy``, and
the fetches of both executors agree run by run (atol and rtol 1e-5 unless
a test says otherwise: f32 on both sides, the summation order only).
The port's executor runs each key through ``GraphCache`` (bodies run
directly on the CPU; the card replays CUDA graphs, tests/test_torch_gpu.py
and chip_smoke.py)."""

import json
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.data.dataset import mnist, uci_housing
from paddle_tpu_torch.core.graphs import GraphCache
from torch_fluid_common import Pair, host


@pytest.fixture(autouse=True)
def fresh_programs():
    for f in (jfluid, tfluid):
        f.reset_default_programs()
        f.executor._global_scope = f.Scope()
    yield


def _line(fl):
    x = fl.layers.data("x", shape=(13,))
    y = fl.layers.data("y", shape=(1,))
    pred = fl.layers.fc(x, 1)
    diff = fl.layers.elementwise_sub(pred, y)
    loss = fl.layers.mean(fl.layers.elementwise_mul(diff, diff))
    fl.SGDOptimizer(0.01).minimize(loss)
    return loss


def test_fit_a_line():
    """Linear regression: 5 runs equal JAX's, then the port's loss halves."""
    p = Pair(_line)
    data = list(uci_housing.train(256)())
    feed = {"x": np.stack([d[0] for d in data]),
            "y": np.stack([d[1] for d in data])}
    first = p.steps(5, feed, [p.tout])[0][0]
    p.assert_scopes_close(atol=1e-4, rtol=1e-4)
    for _ in range(45):
        out, = p.texe.run(p.tmain, feed=feed, fetch_list=[p.tout])
    assert float(out) < float(first) * 0.5


def _mlp(fl):
    img = fl.layers.data("img", shape=(784,))
    label = fl.layers.data("label", shape=(), dtype="int32")
    h1 = fl.layers.fc(img, 32, act="relu")
    h2 = fl.layers.fc(h1, 16, act="relu")
    logits = fl.layers.fc(h2, 10)
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(logits,
                                                               label))
    acc = fl.layers.accuracy(logits, label)
    fl.AdamOptimizer(1e-3).minimize(loss)
    return loss, acc


def test_recognize_digits_mlp():
    """The MNIST MLP under Adam: loss and accuracy equal JAX's for 5 runs,
    then the port trains on."""
    p = Pair(_mlp)
    data = list(mnist.train(256)())
    feed = {"img": np.stack([d[0] for d in data]),
            "label": np.array([d[1] for d in data], np.int32)}
    costs = [float(t[0]) for t in p.steps(5, feed, list(p.tout))]
    for _ in range(25):
        c, a = p.texe.run(p.tmain, feed=feed, fetch_list=list(p.tout))
        costs.append(float(c))
    assert costs[-1] < costs[0] * 0.5
    assert float(a) > 0.5


def test_executable_cache_reused():
    def build(fl):
        x = fl.layers.data("x", shape=(4,))
        return fl.layers.fc(x, 2)
    p = Pair(build)
    exe = p.texe
    p.run({"x": np.ones((3, 4), np.float32)}, [p.tout])
    n1 = len(exe._cache)
    j, t = p.run({"x": np.zeros((3, 4), np.float32)}, [p.tout])
    np.testing.assert_allclose(t[0], j[0], atol=1e-6)
    assert len(exe._cache) == n1          # same shapes -> cache hit
    p.run({"x": np.ones((5, 4), np.float32)}, [p.tout])
    assert len(exe._cache) == n1 + 1      # new batch shape -> new key
    assert exe.stats["cache_hits"] == 1 and exe.stats["cache_misses"] == 2


def test_program_serialization_roundtrip():
    """A program's JSON is the same from both packages, and each package
    reads the other's into a program with the same ops and vars."""
    def build(fl):
        x = fl.layers.data("x", shape=(4,))
        h = fl.layers.fc(x, 8, act="tanh")
        return fl.layers.fc(h, 2)
    p = Pair(build, startup=False)
    jd = json.dumps(p.jmain.to_dict(), default=str)
    td = json.dumps(p.tmain.to_dict(), default=str)
    assert jd == td
    back_t = tfluid.Program.from_dict(json.loads(jd))
    back_j = jfluid.Program.from_dict(json.loads(td))
    assert json.dumps(back_t.to_dict()) == json.dumps(back_j.to_dict())
    assert set(back_t.global_block().vars) == set(p.jmain.global_block().vars)


def test_prune_drops_dead_ops():
    def build(fl):
        x = fl.layers.data("x", shape=(4,))
        used = fl.layers.fc(x, 2)
        dead = fl.layers.fc(x, 3)
        return used, dead
    p = Pair(build, startup=False)
    (used, dead), (tused, _) = p.jout, p.tout
    jp, tp = p.jmain.prune([used.name]), p.tmain.prune([tused.name])
    assert [o.type for o in tp.global_block().ops] == \
        [o.type for o in jp.global_block().ops]
    assert len(tp.global_block().ops) < len(p.tmain.global_block().ops)
    assert all(dead.name not in o.output_vars()
               for o in tp.global_block().ops)


def _momentum(fl):
    x = fl.layers.data("x", shape=(4,))
    y = fl.layers.data("y", shape=(1,))
    pred = fl.layers.fc(x, 1)
    diff = fl.layers.elementwise_sub(pred, y)
    loss = fl.layers.mean(fl.layers.elementwise_mul(diff, diff))
    fl.MomentumOptimizer(0.01, momentum=0.9).minimize(loss)
    return loss


def test_momentum_optimizer_runs():
    p = Pair(_momentum)
    rs = np.random.RandomState(0)
    xs = rs.randn(32, 4).astype(np.float32)
    feed = {"x": xs, "y": (xs @ rs.randn(4, 1)).astype(np.float32)}
    costs = [float(t[0]) for t in p.steps(31, feed, [p.tout])]
    assert costs[-1] < costs[0] * 0.5
    p.assert_scopes_close()


def test_save_load_persistables(tmp_path):
    """Both packages write the same persistables.tar bytes from the same
    weights, and each loads the other's into the same outputs."""
    def build(fl):
        x = fl.layers.data("x", shape=(4,))
        return fl.layers.fc(x, 2)
    p = Pair(build)
    feed = {"x": np.ones((2, 4), np.float32)}
    j, t = p.run(feed, [p.tout])
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jfluid.io.save_persistables(p.jexe, str(jdir), p.jmain)
    tfluid.io.save_persistables(p.texe, str(tdir), p.tmain)
    assert (jdir / "persistables.tar").read_bytes() == \
        (tdir / "persistables.tar").read_bytes()
    exe2 = tfluid.Executor(scope=tfluid.Scope(), device="cpu")
    tfluid.io.load_persistables(exe2, str(jdir), p.tmain)
    r2, = exe2.run(p.tmain, feed=feed, fetch_list=[p.tout])
    np.testing.assert_allclose(r2, j[0], rtol=1e-6)
    jexe2 = jfluid.Executor(scope=jfluid.Scope())
    jfluid.io.load_persistables(jexe2, str(tdir), p.jmain)
    r3, = jexe2.run(p.jmain, feed=feed, fetch_list=[p.jout])
    np.testing.assert_allclose(np.asarray(r3), t[0], rtol=1e-6)


def _sgd_line(fl):
    x = fl.layers.data("x", shape=(4,))
    y = fl.layers.data("y", shape=(1,))
    pred = fl.layers.fc(x, 1)
    diff = fl.layers.elementwise_sub(pred, y)
    loss = fl.layers.mean(fl.layers.elementwise_mul(diff, diff))
    fl.SGDOptimizer(0.05).minimize(loss)
    return loss


def _sgd_feed():
    rs = np.random.RandomState(0)
    xs = rs.randn(16, 4).astype(np.float32)
    return {"x": xs, "y": (xs @ rs.randn(4, 1)).astype(np.float32)}


def _weight(p):
    return next(v.name for v in p.tmain.global_block().all_parameters())


def test_donation_updates_persistables_in_place():
    """3 donating runs with return_numpy=False: the fetch is a tensor, the
    updates land in the scope in place (the scope keeps its tensors, now
    the executor's), and the values equal JAX's."""
    p = Pair(_sgd_line)
    feed, w = _sgd_feed(), _weight(p)
    costs, held = [], []
    for _ in range(3):
        j = p.jexe.run(p.jmain, feed=feed, fetch_list=[p.jout])
        out, = p.texe.run(p.tmain, feed=feed, fetch_list=[p.tout],
                          return_numpy=False)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_allclose(host(out), np.asarray(j[0]), rtol=1e-5)
        costs.append(float(out))
        held.append(p.texe.scope.get(w))
    assert costs[2] < costs[0]
    assert held[1] is held[2]                 # written in place
    np.testing.assert_allclose(host(held[0]), np.asarray(p.jexe.scope.get(w)),
                               rtol=1e-5)


def test_donation_opt_outs():
    """A persistable fetched in the same run is kept (the fetch sees the new
    value, JAX's), and donate=False leaves every old tensor as it was."""
    p = Pair(_sgd_line)
    feed, w = _sgd_feed(), _weight(p)
    w_old = host(p.texe.scope.get(w)).copy()
    j, t = p.run(feed, [w, p.tout.name])
    assert not np.allclose(t[0], w_old)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    np.testing.assert_allclose(t[0], host(p.texe.scope.get(w)))
    ref = p.texe.scope.get(w)
    before = host(ref).copy()
    p.texe.run(p.tmain, feed=feed, fetch_list=[p.tout], donate=False)
    np.testing.assert_array_equal(host(ref), before)
    assert p.texe.scope.get(w) is not ref


def test_fed_persistable_overrides_scope_value():
    p = Pair(_sgd_line)
    feed, w = _sgd_feed(), _weight(p)
    j, t = p.run(feed, [p.tout], donate=False)
    big = np.full(host(p.texe.scope.get(w)).shape, 100.0, np.float32)
    j2, t2 = p.run({**feed, w: big}, [p.tout])
    np.testing.assert_allclose(t2[0], j2[0], rtol=1e-5)
    assert float(t2[0]) > float(t[0]) * 10
    w_after = host(p.texe.scope.get(w))
    np.testing.assert_allclose(w_after, np.asarray(p.jexe.scope.get(w)),
                               rtol=1e-5)
    assert np.abs(w_after).max() > 50


def test_donation_while_subblock_persistable():
    """A persistable written only inside a while sub-block updates across 3
    runs as JAX's does; the block holds a While, so it runs eagerly and is
    counted."""
    def build(fl):
        layers = fl.layers
        b = fl.default_main_program().global_block()
        acc = b.create_var(name="acc", shape=(), dtype="int32",
                           persistable=True, trainable=False)
        i = layers.fill_constant((), "int32", 0)
        n = layers.fill_constant((), "int32", 5)
        cond = layers.less_than(i, n)
        with fl.While(cond).block():
            sb = fl.default_main_program().current_block()
            sb.append_op("elementwise_add", {"X": [acc.name], "Y": [i.name]},
                         {"Out": [acc.name]})
            layers.increment(i)
            layers.less_than(i, n, cond=cond)
        return i
    p = Pair(build, startup=False)
    p.jexe.scope.set("acc", np.int32(0))
    p.texe.scope.set("acc", np.int32(0))
    vals = []
    for _ in range(3):
        p.run({}, [p.tout])
        vals.append(int(host(p.texe.scope.get("acc"))))
        assert vals[-1] == int(np.asarray(p.jexe.scope.get("acc")))
    assert vals == [10, 20, 30]
    assert p.texe.stats["eager_runs"] == 3


def _square(fl):
    w = fl.layers.data("w", shape=(-1,))
    return fl.layers.elementwise_mul(w, w)


def test_bucketing_bounds_recompiles_and_matches_unbucketed():
    """8 lengths under a 2-bucket spec make 2 keys (2 misses, 6 hits) and
    equal JAX's bucketed outputs and the unbucketed run on the true
    lengths."""
    p = Pair(_square, startup=False, jax_kw={"buckets": {"w": (8, 16)}},
             torch_kw={"buckets": {"w": (8, 16)}})
    lengths = (3, 5, 6, 7, 9, 10, 12, 15)
    plain = tfluid.Executor(scope=tfluid.Scope(), device="cpu")
    for L in lengths:
        x = np.arange(2 * L, dtype=np.float32).reshape(2, L)
        j, t = p.run({"w": x}, [p.tout])
        np.testing.assert_array_equal(t[0], j[0])
        assert t[0].shape[1] in (8, 16)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            u, = plain.run(p.tmain, feed={"w": x}, fetch_list=[p.tout])
        np.testing.assert_array_equal(t[0][:, :L], u)
        assert np.all(t[0][:, L:] == 0)
    assert p.texe.stats["cache_misses"] == 2
    assert p.texe.stats["cache_hits"] == 6


def test_bucketing_feeds_true_length():
    def build(fl):
        w = fl.layers.data("w", shape=(-1,))
        ln = fl.default_main_program().global_block().create_var(
            name="w@LEN", shape=(), dtype="int32", is_data=True)
        return fl.layers.elementwise_add(fl.layers.mean(w),
                                         fl.layers.cast(ln, "float32"))
    p = Pair(build, startup=False, jax_kw={"buckets": {"w": (8,)}},
             torch_kw={"buckets": {"w": (8,)}})
    j, t = p.run({"w": np.zeros((2, 5), np.float32)}, [p.tout])
    assert float(t[0]) == float(j[0]) == 5.0


def _fc2(fl):
    x = fl.layers.data("x", shape=(4,))
    return fl.layers.fc(x, 2)


def test_cache_lru_bounded_with_evictions():
    """3 feed shapes through a 2-key LRU: an eviction, which drops its
    key's graph (GraphCache.drop), and an evicted shape runs again (a
    second eviction)."""
    p = Pair(_fc2, torch_kw={"cache_capacity": 2})
    exe = p.texe
    dropped = []
    real = exe.graphs.drop
    exe.graphs.drop = lambda match: dropped.append(match) or real(match)
    for bs in (1, 2, 3):
        j, t = p.run({"x": np.ones((bs, 4), np.float32)}, [p.tout])
        np.testing.assert_allclose(t[0], j[0], atol=1e-6)
    assert len(exe._cache) == 2
    assert exe.stats["cache_evictions"] == 1 and len(dropped) == 1
    res, = exe.run(p.tmain, feed={"x": np.ones((1, 4), np.float32)},
                   fetch_list=[p.tout])
    assert res.shape == (1, 2) and len(exe._cache) == 2
    assert exe.stats["cache_evictions"] == 2 and len(dropped) == 2


def _l006(got):
    return [str(w.message) for w in got if "L006" in str(w.message)]


def test_shape_churn_warns_l006():
    def build(fl):
        return fl.layers.mean(fl.layers.data("x", shape=(-1,)))
    p = Pair(build, startup=False)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for L in range(1, 8):
            p.texe.run(p.tmain, feed={"x": np.ones((2, L), np.float32)},
                       fetch_list=[p.tout])
    msgs = _l006(got)
    assert len(msgs) == 1 and "buckets" in msgs[0]
    exe_b = tfluid.Executor(scope=tfluid.Scope(), device="cpu",
                            buckets={"x": (8,)})
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for L in range(1, 8):
            exe_b.run(p.tmain, feed={"x": np.ones((2, L), np.float32)},
                      fetch_list=[p.tout])
    assert not _l006(got)


def test_shape_churn_warns_when_spec_misses_the_varying_feed():
    def build(fl):
        x = fl.layers.data("x", shape=(-1,))
        z = fl.layers.data("z", shape=(-1,))
        return fl.layers.elementwise_add(fl.layers.mean(x),
                                         fl.layers.mean(z))
    p = Pair(build, startup=False, torch_kw={"buckets": {"x": (8,)}})
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for L in range(1, 8):
            p.texe.run(p.tmain, feed={"x": np.ones((2, 3), np.float32),
                                      "z": np.ones((2, L), np.float32)},
                       fetch_list=[p.tout])
    msgs = _l006(got)
    assert len(msgs) == 1 and "extend the BucketSpec" in msgs[0]


def test_covering_spec_warmup_is_not_shape_churn():
    def build(fl):
        return fl.layers.mean(fl.layers.data("x", shape=(-1,)))
    p = Pair(build, startup=False,
             torch_kw={"buckets": {"x": (2, 4, 8, 16)}})
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for L in (2, 3, 7, 12, 20):
            p.texe.run(p.tmain, feed={"x": np.ones((2, L), np.float32)},
                       fetch_list=[p.tout])
    assert not _l006(got)
    assert len(p.texe._cache) == 5


def test_lru_eviction_thrash_is_not_shape_churn():
    p = Pair(_fc2, torch_kw={"cache_capacity": 2})
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        for _ in range(3):
            for bs in (1, 2, 3):
                p.texe.run(p.tmain, feed={"x": np.ones((bs, 4), np.float32)},
                           fetch_list=[p.tout])
    assert not _l006(got)
    assert p.texe.stats["cache_evictions"] == 7


def test_bucketing_static_feed_axis_is_an_error():
    def build(fl):
        return fl.layers.fc(fl.layers.data("img", shape=(784,)), 2)
    p = Pair(build, torch_kw={"buckets": {"img": (1024,)}})
    with pytest.raises(ValueError, match="cannot infer a bucket axis"):
        p.texe.run(p.tmain, feed={"img": np.ones((2, 784), np.float32)},
                   fetch_list=[p.tout])


def test_graph_cache_drop_on_meta_tensors():
    """GraphCache.drop removes exactly the graphs its predicate accepts
    (the executor's evictions pass the evicted key's token); a cache on
    meta tensors runs its bodies directly and holds none."""
    cache = GraphCache("test", "meta")
    x = torch.empty(3, 4, device="meta")
    out = cache.run("body", lambda x, key: x * 2, {"x": x},
                    static={"key": 7})
    assert out.device.type == "meta" and not cache._graphs
    for token in (1, 2, 3):
        cache._graphs[("fluid.run", None, (("key", token),), ())] = token
    assert cache.drop(lambda k: ("key", 2) in k[2]) == 1
    assert sorted(cache._graphs.values()) == [1, 3]
    assert cache.drop(lambda k: True) == 2 and not cache._graphs


def test_pruned_program_autodiff_grads_run():
    """A program pruned to its gradients still differentiates (autodiff_grad
    at its own position), and the grads equal JAX's."""
    def build(fl):
        x = fl.layers.data("x", shape=(4,))
        fl.layers.fc(x, 3)                       # dangling
        h = fl.layers.fc(x, 8, act="tanh")
        loss = fl.layers.mean(fl.layers.fc(h, 2))
        fl.SGDOptimizer(0.1).minimize(loss)
        return loss
    p = Pair(build)
    params = [v.name for v in p.tmain.global_block().all_parameters()
              if not v.name.startswith("fc_w_1")]
    grads = [n + "@GRAD" for n in params if "fc" in n]
    jp, tp = p.jmain.prune(grads), p.tmain.prune(grads)
    j, t = p.run({"x": np.ones((3, 4), np.float32)}, grads, jprog=jp,
                 tprog=tp)
    for a, b in zip(j, t):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=1e-5)
