"""The port's fluid API (nets, regularizers, evaluators, the optimizer zoo)
against the JAX package, on the CPU: the counterparts of
tests/test_fluid_api.py, on the same programs and from the same weights
(``convert.scope_from_numpy``). Fetches agree run by run at atol and rtol
1e-5 (f32, the summation order only), the convolution nets at 1e-4 (the
port's convolutions run through PyTorch's, JAX's through XLA's)."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from torch_fluid_common import Pair, assert_adaptive_close, host


@pytest.fixture(autouse=True)
def fresh_programs():
    for f in (jfluid, tfluid):
        f.reset_default_programs()
        f.executor._global_scope = f.Scope()
    yield


def _toy(opt_name, kw, regularization=None):
    def build(fl):
        layers = fl.layers
        x = layers.data("x", shape=(10,))
        y = layers.data("y", shape=(), dtype="int64")
        h = layers.fc(x, 16, act="tanh")
        logits = layers.fc(h, 2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        reg = None if regularization is None else \
            getattr(fl, regularization[0])(regularization[1])
        getattr(fl, opt_name)(**kw).minimize(loss, regularization=reg)
        return loss
    return build


def _toy_feed():
    rng = np.random.RandomState(0)
    xs = rng.randn(32, 10).astype(np.float32)
    return {"x": xs, "y": (xs.sum(1) > 0).astype(np.int64)}


@pytest.mark.parametrize("opt_name,kw", [
    ("AdagradOptimizer", {"learning_rate": 0.1}),
    ("AdadeltaOptimizer", {"learning_rate": 1.0}),
    ("RMSPropOptimizer", {"learning_rate": 0.01}),
    ("AdamaxOptimizer", {"learning_rate": 0.05}),
    ("DecayedAdagradOptimizer", {"learning_rate": 0.1}),
    ("FtrlOptimizer", {"learning_rate": 0.1}),
])
def test_optimizer_zoo_learns(opt_name, kw):
    """The first run equals JAX's: the loss, the gradients (to 1e-5 of each
    tensor's largest) and the updated parameters within the adaptive-step
    bound (torch_fluid_common.assert_adaptive_close); 4 more runs give
    JAX's losses (to 1e-4), and the port's loss keeps falling. Parameters
    are held entry by entry after the first update only: an adaptive
    optimizer divides each entry's gradient by that entry's own history,
    so a rounding-size difference at an entry whose gradient is tiny
    grows into its unit's later gradients however right both sides are."""
    p = Pair(_toy(opt_name, kw))
    feed = _toy_feed()
    params = [v.name for v in p.tmain.global_block().all_parameters()]
    j, t = p.run(feed, [p.tout.name] + [n + "@GRAD" for n in params])
    np.testing.assert_allclose(t[0], j[0], atol=1e-5, rtol=1e-5)
    for a, b in zip(j[1:], t[1:]):
        np.testing.assert_allclose(b, a, atol=1e-5 * np.abs(a).max(),
                                   rtol=0)
    assert_adaptive_close(p, dict(zip(params, j[1:])), kw["learning_rate"],
                          1)
    losses = [float(t[0])] + [float(o[0]) for o in p.steps(
        4, feed, [p.tout], atol=1e-4, rtol=1e-4)]
    for _ in range(20):
        losses.append(float(p.texe.run(p.tmain, feed=feed,
                                       fetch_list=[p.tout])[0]))
    assert losses[-1] < losses[0] * 0.9, (opt_name, losses[:3], losses[-3:])


def test_l2_regularization_shrinks_weights():
    p = Pair(_toy("SGDOptimizer", {"learning_rate": 0.1}, ("L2Decay", 0.5)))
    p.steps(10, _toy_feed(), [p.tout])
    p.assert_scopes_close()
    q = Pair(_toy("SGDOptimizer", {"learning_rate": 0.1}))
    q.steps(10, _toy_feed(), [q.tout])

    def norm(pair):
        scope = pair.texe.scope
        return sum(float(np.square(host(scope.get(n))).sum())
                   for n in scope.vars if n.startswith("fc_w"))
    assert norm(p) < norm(q)


def test_l1_regularization_runs():
    p = Pair(_toy("SGDOptimizer", {"learning_rate": 0.05}, ("L1Decay", 0.01)))
    out = p.steps(5, _toy_feed(), [p.tout])
    assert np.isfinite(out[-1][0])
    p.assert_scopes_close()


def test_simple_img_conv_pool_trains():
    def build(fl):
        layers = fl.layers
        img = layers.data("img", shape=(12, 12, 1))
        y = layers.data("y", shape=(), dtype="int64")
        feat = fl.nets.simple_img_conv_pool(img, num_filters=4,
                                            filter_size=3, pool_size=2,
                                            pool_stride=2, act="relu")
        logits = layers.fc(feat, 2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, y))
        fl.AdamOptimizer(0.01).minimize(loss)
        return loss
    p = Pair(build)
    rng = np.random.RandomState(0)
    feed = {"img": rng.randn(8, 12, 12, 1).astype(np.float32),
            "y": rng.randint(0, 2, (8,)).astype(np.int64)}
    out = p.steps(5, feed, [p.tout], atol=1e-4, rtol=1e-4)
    for _ in range(10):
        last = p.texe.run(p.tmain, feed=feed, fetch_list=[p.tout])
    assert float(last[0]) < float(out[0][0])


def test_img_conv_group_with_batchnorm():
    def build(fl):
        img = fl.layers.data("img", shape=(8, 8, 3))
        return fl.nets.img_conv_group(img, conv_num_filter=[4, 4],
                                      pool_size=2, pool_stride=2,
                                      conv_act="relu",
                                      conv_with_batchnorm=True)
    p = Pair(build)
    xs = np.random.RandomState(0).randn(4, 8, 8, 3).astype(np.float32)
    j, t = p.run({"img": xs}, [p.tout])
    assert t[0].shape == (4, 4, 4, 4) and np.isfinite(t[0]).all()
    np.testing.assert_allclose(t[0], j[0], atol=1e-4, rtol=1e-4)


def test_accuracy_evaluator_accumulates():
    def build(fl):
        x = fl.layers.data("x", shape=(4,))
        y = fl.layers.data("y", shape=(), dtype="int64")
        return fl.AccuracyEvaluator(fl.layers.fc(x, 2), y)
    p = Pair(build)
    jev, tev = p.jout, p.tout
    jev.reset(p.jexe)
    tev.reset(p.texe)
    rng = np.random.RandomState(0)
    for _ in range(3):
        feed = {"x": rng.randn(16, 4).astype(np.float32),
                "y": rng.randint(0, 2, (16,)).astype(np.int64)}
        j, t = p.run(feed, [tev.batch_acc])
        np.testing.assert_allclose(t[0], j[0])
    assert tev.eval(p.texe) == pytest.approx(jev.eval(p.jexe))
    assert float(host(p.texe.scope.get(tev._tot_total.name))) == 48.0


def test_chunk_evaluator_f1():
    def build(fl):
        tags = fl.layers.data("tags", shape=(6,), dtype="int32")
        labels = fl.layers.data("labels", shape=(6,), dtype="int32")
        lengths = fl.layers.data("lengths", shape=(), dtype="int32")
        return fl.ChunkEvaluator(tags, labels, lengths)
    p = Pair(build)
    p.tout.reset(p.texe)
    t = np.array([[0, 1, 1, 0, 1, 0]], np.int32)
    p.texe.run(p.tmain, feed={"tags": t, "labels": t,
                              "lengths": np.array([6], np.int32)},
               fetch_list=[])
    assert p.tout.eval(p.texe) == pytest.approx(1.0)


def test_failing_op_names_itself_in_the_error():
    """A failure deep in a Program names the op in the op_site format the
    JAX executor uses ("block 0, op #3 (concat)") and the chain leading to
    it, on the original exception."""
    def build(fl):
        x = fl.layers.data("x", shape=(4,))
        h = fl.layers.fc(x, 8, act="relu")
        y = fl.layers.data("y", shape=(3,))
        return fl.layers.concat([h, y], axis=0)
    p = Pair(build)
    with pytest.raises(RuntimeError) as ei:
        p.texe.run(p.tmain, feed={"x": np.zeros((2, 4), np.float32),
                                  "y": np.zeros((2, 3), np.float32)},
                   fetch_list=[p.tout])
    msg = str(ei.value) + "\n".join(getattr(ei.value, "__notes__", []))
    assert "block 0, op #3 (concat)" in msg and "op chain" in msg
