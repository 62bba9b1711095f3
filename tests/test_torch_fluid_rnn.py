"""The port's fluid recurrences, inference bundles and gaps against the
JAX package, on the CPU: a ``dynamic_lstm`` text classifier (the LSTM
flagship's program at small widths) and a ``dynamic_gru`` program trained
a few Adam steps from the same weights (``convert.scope_from_numpy``),
with losses at atol/rtol 1e-5, the first step's gradients to 1e-5 of each
tensor's largest plus 1e-7 (the f32 rounding of the O(1/B) terms a
gradient that cancels to near zero sums) and parameters within the adaptive-step bound of
torch_fluid_common; inference bundles and persistables written by each
package byte-equal and loaded by the other; and the executor options that
wait for other planes raise naming their ROADMAP item. On the card the
``lstm`` and ``gru`` ops run kernels #8-#12 (chip_smoke.py, the fluid
phase); here their plain versions."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.convert import scope_from_numpy
from paddle_tpu_torch.ops import cuda_kernels as ck
from torch_fluid_common import Pair, assert_adaptive_close, host

V, E, H, B, T = 40, 8, 12, 6, 9
LR = 1e-2


@pytest.fixture(autouse=True)
def fresh_programs():
    for f in (jfluid, tfluid):
        f.reset_default_programs()
        f.executor._global_scope = f.Scope()
    yield


def _textcls(cell):
    def build(fl):
        layers = fl.layers
        words = layers.data("words", shape=(-1,), dtype="int32")
        lens = layers.data("lens", shape=(), dtype="int32")
        label = layers.data("label", shape=(), dtype="int32")
        emb = layers.embedding(words, (V, E))
        rnn = layers.dynamic_lstm if cell == "lstm" else layers.dynamic_gru
        last = layers.sequence_last_step(rnn(emb, lens, H), lens)
        logits = layers.fc(last, 2)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        fl.AdamOptimizer(LR).minimize(loss)
        return logits, loss
    return build


def _feed(seed=0):
    rs = np.random.RandomState(seed)
    return {"words": rs.randint(0, V, (B, T)).astype(np.int32),
            "lens": np.array([9, 3, 5, 1, 9, 7], np.int32),
            "label": rs.randint(0, 2, B).astype(np.int32)}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_adam_steps_match_jax(cell):
    """3 Adam steps: the losses equal JAX's, the first step's gradients
    too, and every parameter stays within the adaptive-step bound; the
    kernels' plain versions ran (no launch on the CPU)."""
    p = Pair(_textcls(cell))
    logits, loss = p.tout
    params = [v.name for v in p.tmain.global_block().all_parameters()]
    ck.reset_launch_counts()
    feed = _feed()
    j, t = p.run(feed, [loss.name] + [n + "@GRAD" for n in params])
    np.testing.assert_allclose(t[0], j[0], atol=1e-5, rtol=1e-5)
    for name, a, b in zip(params, j[1:], t[1:]):
        np.testing.assert_allclose(b, a, atol=1e-5 * np.abs(a).max() + 1e-7,
                                   rtol=0, err_msg=name)
    assert_adaptive_close(p, dict(zip(params, j[1:])), LR, 1)
    losses = [float(t[0])] + [float(o[0]) for o in p.steps(2, feed, [loss])]
    assert losses[-1] < losses[0]
    assert sum(ck.LAUNCHES.values()) == 0


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_inference_bundle_is_jax_byte_for_byte(cell, tmp_path):
    """``export_inference_model`` of both packages writes the same
    model.json and params.tar bytes from the same weights, and each
    package's ``load_inference_model`` reads the other's bundle into JAX's
    outputs."""
    p = Pair(_textcls(cell))
    (jlogits, _), (tlogits, _) = p.jout, p.tout
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jfluid.io.export_inference_model(str(jdir), ["words", "lens"],
                                     [jlogits], p.jexe, p.jmain)
    tfluid.io.export_inference_model(str(tdir), ["words", "lens"],
                                     [tlogits], p.texe, p.tmain)
    for f in ("model.json", "params.tar"):
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    feed = {k: v for k, v in _feed(1).items() if k != "label"}
    texe = tfluid.Executor(scope=tfluid.Scope(), device="cpu")
    prog, feeds, fetches = tfluid.io.load_inference_model(str(jdir), texe)
    got, = texe.run(prog, feed=feed, fetch_list=fetches)
    jexe = jfluid.Executor(scope=jfluid.Scope())
    jprog, _, jfetch = jfluid.io.load_inference_model(str(tdir), jexe)
    want, = jexe.run(jprog, feed=feed, fetch_list=jfetch)
    assert feeds == ["words", "lens"]
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_scope_from_numpy_keeps_names_and_dtypes():
    scope = scope_from_numpy({"w": np.ones((2, 3), np.float32),
                              "step": np.int32(4)}, "cpu")
    assert scope.get("w").dtype.is_floating_point
    assert str(scope.get("step").dtype) == "torch.int32"
    assert int(scope.get("step")) == 4 and tuple(scope.get("w").shape) == (2, 3)


@pytest.mark.parametrize("kw,item", [({"fuse": True}, "A.8"),
                                     ({"fuse": {0, 2}}, "A.8"),
                                     ({"mesh": object()}, "A.7")])
def test_options_that_wait_for_other_planes_raise(kw, item):
    """fuse waits for the tune plane (A.8). The mesh executor is in since
    A.7b (held in tests/test_torch_fluid_sharding.py): what stays refused
    is a layout with no mesh to lay it on, as JAX refuses it."""
    if item == "A.7":
        from paddle_tpu_torch.parallel import SpecLayout
        with pytest.raises(ValueError, match="needs a mesh"):
            tfluid.Executor(device="cpu", layout=SpecLayout())
        return
    with pytest.raises(NotImplementedError, match=item):
        tfluid.Executor(device="cpu", **kw)


def test_verify_waits_for_the_analysis_plane():
    """The analysis plane has come (A.6b): a verified run of the LSTM
    program equals JAX's verified run; fuse=None and fuse=False run
    unfused."""
    p = Pair(_textcls("lstm"))
    j, t = p.run(_feed(), [p.tout[1]], verify=True)
    np.testing.assert_allclose(t[0], j[0], atol=1e-5, rtol=1e-5)
    for fuse in (None, False):       # run unfused, as JAX's with no cache
        exe = tfluid.Executor(device="cpu", fuse=fuse,
                              scope=scope_from_numpy(p.jax_vars(), "cpu"))
        out, = exe.run(p.tmain, feed=_feed(), fetch_list=[p.tout[1]])
        assert np.isfinite(host(out))
