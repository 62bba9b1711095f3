"""The port's image models (paddle_tpu_torch/models/image.py, mlp.py)
against the JAX models on the CPU, with the JAX weights carried across by
``convert.params_from_numpy`` and the same numpy inputs from a seed.

ResNets go through ``benchmarks/resnet50.py``'s training step rebuilt at
a small width: train-mode batch norm with the stat updates merged, one
``Momentum(0.1, 0.9)`` step, in f32 and in the bench's bf16 recipe (every
f32 leaf, the running stats too, cast to bf16; the stat updates cast back
to f32 and merged). The port's step is ``Trainer.step`` on a loss that
returns (loss, stat updates); one Momentum step from a zero velocity
leaves the gradient in the velocity slot.

Tolerances, each with its reason:
* f32: the port's step against JAX's directly, leaf by leaf (the worst
  leaf, relative L2), at bounds set from each model's own readings on
  1-8 CPU threads (``RESNETS``: logits, every trainable gradient, every
  merged stat). ResNet-18 agrees to 1e-5-4e-5 at its worst leaf. It
  runs at batch 8: at batch 4 its last stage normalizes 4 values a
  channel, and one ReLU input there lies within f32 rounding of 0 (on
  one thread the port's f32 step fell on its other side: 13% at a
  leaf). ResNet-50 at width 0.125 (8 channels a bottleneck, train-mode
  BN through 53 layers at initialization) is ill-conditioned: JAX's own
  step with only the BN moments in f32 and the rest in float64 lies
  1.1e-1 from the port's float64 step at its worst leaf, and the two f32
  steps lie 2.8e-2-6.9e-2 apart, the distance of single channels (one
  channel of ``layer3_0/b/bn/beta`` held all of it): its leaves are held
  to 0.2, which a wrong or missing gradient (relative distance ~1) does
  not meet. The loss to 1e-4 of JAX's; the updated params are
  p - lr * g of the port's own gradients.
* The bf16 recipe: bf16 rounding then dominates (JAX's own bf16 step
  differs from its f32 step by 2-40% in logits and by up to 3x a leaf's
  norm in ResNet-50's gradients), and the two frameworks' bf16 steps
  fall on either side of the f32 step (ResNet-50's loss on two threads:
  port 3.016, JAX f32 3.190, JAX bf16 3.332). So the loss, the logits
  and each gradient leaf of the port's bf16 step are held no further
  from JAX's f32 step than twice JAX's bf16 step is (plus 2**-8 of the
  loss for the loss). Every merged stat is a bf16 value as JAX's are
  (rounded through the bf16 running stats) and is held to JAX's bf16
  step's: the stem's, whose input both sides round alike, within one
  bf16 ulp of their largest magnitude. Every other BN's input went
  through convs that the two frameworks sum and round to bf16 in
  different orders, up to 5 ulps apart in these models: each of those
  is held within one ulp plus twice JAX's own bf16-against-f32 distance
  of that stat.
* The other models in f32: 1e-5 of the largest magnitude.
* Several steps on one repeated batch: ResNet-18 in f32 follows JAX's
  losses step for step, each within 1e-3 of its value plus 1e-5 of the
  first step's loss: the loss falls 470x in 8 steps (2.116 to 0.0045)
  while the two sides stay (1-5)e-6 apart from the first step to the
  last, so a bound relative to the last, vanishing loss alone measures
  the host's rounding (1e-4 on one host, 1.02e-3 on another); the
  absolute term ties it to the loss scale where the run starts. A wrong
  gradient moves the second loss (0.17) by orders of magnitude more.
  ResNet-50 at width 0.125 follows them only for its first step (its
  2e-2 gradient distance grows under lr 0.1); there the test holds what
  both sides do under the bench's Momentum(0.1, 0.9): the loss rises
  above the first step's within 8 steps, as it does for the full-size
  model on the card (chip_smoke.py phase 13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import models as JM
from paddle_tpu import nn as jnn
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu_torch import models as TM
from paddle_tpu_torch.convert import (params_from_numpy, port_tree,
                                      tree_from_numpy)
from paddle_tpu_torch.core.pytree import (tree_from_items, tree_items,
                                          tree_map)
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.trainer import Trainer

ATOL = 1e-5
LR, MU = 0.1, 0.9
# (config, image, batch, f32 bounds port against JAX: logits, worst
# gradient leaf, worst merged stat, all relative L2; read on 1-8 CPU
# threads: 4.2e-6-4.7e-6, 1.1e-5-1.4e-5, 2.7e-6-3.0e-6 /
# 1.2e-5-1.4e-5, 3.2e-5-3.5e-5, 4.1e-6-4.4e-6 / 2.9e-4-3.1e-4,
# 2.8e-2-6.9e-2, 9.8e-5-1.0e-4)
RESNETS = {
    "resnet18_small": (dict(depth=18, width_mult=0.25, small_input=True),
                       16, 4, (5e-5, 1e-4, 3e-5)),
    "resnet18": (dict(depth=18, width_mult=0.25), 32, 8,
                 (1e-4, 3e-4, 3e-5)),
    "resnet50": (dict(depth=50, width_mult=0.125), 64, 8,
                 (3e-3, 0.2, 1e-3)),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """{path: float64 numpy} of a port tree or a JAX tree (port layout)."""
    return {p: np.asarray(v.detach().double() if isinstance(v, torch.Tensor)
                          else np.asarray(v, np.float64))
            for p, v in tree_items(tree)}


def _rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _all(flat, keys):
    return np.concatenate([flat[k].ravel() for k in keys])


def _data(img, B, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, img, img, 3).astype(np.float32),
            rs.randint(0, 10, B).astype(np.int32))


def _resnets(name):
    cfg, img, B, _ = RESNETS[name]
    jm = JM.ResNet(classes=10, **cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm = params_from_numpy(_np(params), TM.ResNet(classes=10, **cfg), "cpu")
    return jm, params, tm, _data(img, B)


def _jax_step_fn(jm, opt, bf16):
    """benchmarks/resnet50.py's step_fn at this model: (params, state, x,
    y) -> (new params with the stat updates merged, new state, loss,
    logits, grads)."""
    def loss_fn(params, x, y):
        mut = {}
        if bf16:
            p16 = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.bfloat16)
                if a.dtype == jnp.float32 else a, params)
            logits = jm(p16, x.astype(jnp.bfloat16), train=True,
                        mutable=mut).astype(jnp.float32)
        else:
            logits = jm(params, x, train=True, mutable=mut)
        logp = jax.nn.log_softmax(logits)
        loss = -jnp.take_along_axis(logp, y[:, None], axis=1).mean()
        return loss, (mut, logits)

    def step(params, state, x, y):
        (loss, (mut, logits)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, x, y)
        params, state = opt.update(grads, state, params)
        mut = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), mut)
        return (jnn.apply_stat_updates(params, mut), state, loss, logits,
                grads)
    return step


def _jax_step(jm, params, x, y, bf16):
    """One step of ``_jax_step_fn`` from a fresh state: (loss, logits,
    grads, new params), the trees as numpy in the port's layout."""
    opt = JMomentum(LR, momentum=MU)
    new, _, loss, logits, grads = jax.jit(_jax_step_fn(jm, opt, bf16))(
        params, opt.init(params), x, y)
    return (float(loss), np.asarray(logits, np.float64),
            _flat(port_tree(_np(grads))), _flat(port_tree(_np(new))))


def _port_loss(model, dtype, seen=None):
    """The same loss for ``Trainer``: (loss, stat updates); the logits
    go to ``seen`` if given."""
    def loss_fn(params, x, y):
        mut = {}
        p = tree_map(lambda a: a.to(dtype), params)
        logits = model.call(p, x.to(dtype), train=True,
                            mutable=mut).to(torch.float32)
        if seen is not None:
            seen.append(logits.detach())
        logp = torch.log_softmax(logits, -1)
        return -logp.gather(1, y.long()[:, None]).mean(), mut
    return loss_fn


def _port_step(model, x, y, dtype):
    """The same step through ``Trainer.step``: (loss, logits, grads, new
    params)."""
    seen = []
    tr = Trainer(_port_loss(model, dtype, seen), Momentum(LR, MU),
                 device="cpu")
    tree = model.tree()
    new, state, loss = tr.step(tree, tr.opt.init(tree), torch.from_numpy(x),
                               torch.from_numpy(y))
    grads = {p[:-1]: v for p, v in tree_items(state["slots"])}
    return (loss.item(), seen[0].double().numpy(), _flat(tree_from_items(
        grads.items())), _flat(new))


def _trainable(flat):
    return sorted(k for k in flat if "stats" not in k)


def _worst(got, want, keys):
    """(relative L2, key) of the leaf of ``keys`` farthest apart."""
    return max((_rel(got[k], want[k]), k) for k in keys)


@pytest.mark.parametrize("name", list(RESNETS))
def test_f32_step_matches_jax(name):
    jm, params, tm, (x, y) = _resnets(name)
    logit_tol, grad_tol, stat_tol = RESNETS[name][3]
    jl, jlog, jg, jnew = _jax_step(jm, params, x, y, bf16=False)
    tl, tlog, tg, tnew = _port_step(tm, x, y, torch.float32)
    keys = _trainable(jg)
    assert keys == _trainable(tg) and set(jnew) == set(tnew)
    assert _rel(tlog, jlog) <= logit_tol
    assert abs(tl - jl) <= 1e-4 * abs(jl)
    assert _worst(tg, jg, keys)[0] <= grad_tol, _worst(tg, jg, keys)
    stats = sorted(k for k in jnew if "stats" in k)
    assert _worst(tnew, jnew, stats)[0] <= stat_tol, _worst(tnew, jnew,
                                                            stats)
    old = _flat(tm.tree())
    for k in keys:     # a first Momentum step: p - lr * g
        np.testing.assert_allclose(tnew[k], old[k] - LR * tg[k], atol=1e-6)
    # the stats moved (merged) and their gradients were zero
    stem_var = ("stem", "bn", "stats", "moving_var")
    assert not np.array_equal(tnew[stem_var], _flat(tm.tree())[stem_var])
    assert not any(tg[k].any() for k in tg if "stats" in k)


def _bf16_ulp(a):
    """One bf16 ulp of ``a``'s largest magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(a).max())) - 7)


@pytest.mark.parametrize("name", list(RESNETS))
def test_bf16_recipe_step_matches_jax_within_its_bf16_noise(name):
    jm, params, tm, (x, y) = _resnets(name)
    l32, log32, g32, new32 = _jax_step(jm, params, x, y, bf16=False)
    l16, log16, g16, new16 = _jax_step(jm, params, x, y, bf16=True)
    tl, tlog, tg, tnew = _port_step(tm, x, y, torch.bfloat16)
    keys = _trainable(g16)
    # each side's bf16 step lies on its own side of the f32 step: the
    # port's is held no further from JAX's f32 step than twice JAX's is
    assert abs(tl - l32) <= 2 * abs(l16 - l32) + 2.0 ** -8 * abs(l32)
    assert _rel(tlog, log32) <= 2 * _rel(log16, log32)
    for k in keys:
        assert _rel(tg[k], g32[k]) <= 2 * _rel(g16[k], g32[k]), k
    stats = sorted(k for k in new16 if "stats" in k)
    for k in stats:
        as_bf16 = torch.from_numpy(tnew[k]).to(torch.bfloat16).double()
        assert np.array_equal(as_bf16.numpy(), tnew[k]), k
        ulp = _bf16_ulp(new16[k])
        bound = ulp if k[0] == "stem" else (
            ulp + 2 * np.abs(new16[k] - new32[k]).max())
        assert np.abs(tnew[k] - new16[k]).max() <= bound, k


@pytest.mark.parametrize("name, dtype", [("resnet18_small", "f32"),
                                         ("resnet50", "f32"),
                                         ("resnet50", "bf16")])
def test_repeated_batch_losses_follow_jax(name, dtype):
    """8 steps of benchmarks/resnet50.py's recipe on one repeated batch,
    JAX's steps against ``Trainer.step`` (module docstring)."""
    jm, params, tm, (x, y) = _resnets(name)
    bf16 = dtype == "bf16"
    steps, opt = 8, JMomentum(LR, momentum=MU)
    step = jax.jit(_jax_step_fn(jm, opt, bf16))
    state, want = opt.init(params), []
    for _ in range(steps):
        params, state, loss = step(params, state, x, y)[:3]
        want.append(float(loss))
    tr = Trainer(_port_loss(tm, torch.bfloat16 if bf16 else torch.float32),
                 Momentum(LR, MU), device="cpu")
    p = tm.tree()
    s, got = tr.opt.init(p), []
    for _ in range(steps):
        p, s, loss = tr.step(p, s, torch.from_numpy(x), torch.from_numpy(y))
        got.append(loss.item())
    want, got = np.array(want), np.array(got)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    if name == "resnet18_small":
        np.testing.assert_allclose(got, want, rtol=1e-3,
                                   atol=1e-5 * want[0])
    else:
        if not bf16:
            assert abs(got[0] - want[0]) <= 1e-4 * abs(want[0])
        assert want.max() > 1.5 * want[0] and got.max() > 1.5 * got[0], (
            want, got)


# -- the other image models ---------------------------------------------------

OTHERS = {
    "lenet": (lambda m: m.LeNet(classes=10), (28, 28, 1), 4),
    "smallnet": (lambda m: m.SmallNet(classes=10), (32, 32, 3), 4),
    "vgg": (lambda m: m.VGG(classes=10, width_mult=0.125), (32, 32, 3), 4),
    "mlp": (lambda m: m.MnistMLP(), (784,), 4),
    "alexnet": (lambda m: m.AlexNet(classes=10), (224, 224, 3), 2),
    "googlenet": (lambda m: m.GoogleNet(classes=10), (224, 224, 3), 2),
}


@pytest.mark.parametrize("name", list(OTHERS))
def test_image_model_loss_and_logits_match_jax(name):
    make, shape, B = OTHERS[name]
    jm = make(JM)
    params = jm.init(jax.random.PRNGKey(1))
    tm = params_from_numpy(_np(params), make(TM), "cpu")
    rs = np.random.RandomState(2)
    x = rs.rand(B, *shape).astype(np.float32)
    y = rs.randint(0, 10, B).astype(np.int32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    want = jax.jit(jm)(params, x)
    got = tm(xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL * max(1.0, np.abs(want).max()))
    jl = float(jax.jit(jm.loss)(params, x, y))
    assert abs(tm.loss(xt, yt).item() - jl) <= ATOL * max(1.0, abs(jl))
    if name == "googlenet":
        # training mode without a generator: the aux towers, no dropout
        jl = float(jax.jit(lambda p, x, y: jm.loss(p, x, y, train=True))(
            params, x, y))
        tl = tm.loss(xt, yt, train=True).item()
        assert abs(tl - jl) <= ATOL * max(1.0, abs(jl))
    if name == "vgg":
        jmut, tmut = {}, {}
        jl = float(jm.loss(params, x, y, train=True, mutable=jmut))
        tl = tm.loss(xt, yt, train=True, mutable=tmut).item()
        assert abs(tl - jl) <= ATOL * max(1.0, abs(jl))
        assert sorted(tmut) == sorted(jmut)


@pytest.mark.parametrize("name", ["alexnet", "googlenet"])
def test_dropout_models_draw_from_the_generator(name):
    """Training mode with a generator drops out: the same seed gives the
    same loss, another seed another, and no generator none."""
    make, shape, _ = OTHERS[name]
    tm = make(TM).init(0, "cpu")
    x = torch.rand(2, *shape, generator=torch.Generator().manual_seed(0))
    y = torch.tensor([1, 2])
    loss = lambda s: tm.loss(x, y, train=True,
                             generator=torch.Generator().manual_seed(s))
    a, b, c = loss(1), loss(1), loss(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a)
    assert not torch.equal(a, tm.loss(x, y, train=True))


# -- weights and optimizer state from JAX --------------------------------------

def test_a_jax_resnet50_tree_and_momentum_state_load_into_resnet50():
    """Every key of JAX's full-size ResNet-50 tree (stats included) and of
    its Momentum state matches the port's ``resnet50()`` and
    ``Momentum.init``: no missing or extra key, every shape equal."""
    jm = JM.resnet50()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(jm.init, key)
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = params_from_numpy(zeros, TM.resnet50(), "cpu")
    tree = model.tree()
    assert tree["layer2_0"]["proj"]["bn"]["stats"]["moving_var"].shape == (
        1024,)
    assert set(tree["stem"]["bn"]) == {"gamma", "beta", "stats"}
    state = tree_from_numpy(_np(JMomentum(0.1).init(zeros)), "cpu")
    mine = Momentum(0.1).init(tree)
    got = {p: tuple(v.shape) for p, v in tree_items(state["slots"])}
    want = {p: tuple(v.shape) for p, v in tree_items(mine["slots"])}
    assert got == want
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({k: v for k, v in zeros.items() if k != "head"},
                          TM.resnet50(), "cpu")
