"""The port's optimizer zoo (paddle_tpu_torch/optimizer/: every optimizer,
``l1_decay``, the three clip kinds, the nine schedules, the hooks and
``ParameterAverager``) against the JAX package's, on the CPU.

The same numpy parameter tree (with a ``stats`` leaf, which both sides
pass through) and the same numpy gradients for 4 steps go through JAX's
``update`` and through the port's ``update`` and ``apply_`` (in place).
Tolerance: rtol 2e-5 and atol 1e-6 on every parameter and state leaf.
Both sides run the same f32 ops in the same order; XLA's CPU pow, exp and
sqrt may round an ulp away from torch's, and 4 steps carry that into a
few ulps. ``apply_`` must equal the port's own ``update`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.optimizer as J
import paddle_tpu_torch.optimizer as P
from paddle_tpu_torch.core.pytree import tree_get, tree_items, tree_map

RTOL, ATOL = 2e-5, 1e-6
STEPS = 4


def _tree(rs):
    f = lambda *s: rs.randn(*s).astype(np.float32)
    return {"emb": {"w": f(5, 2)}, "l1": {"w": f(4, 3), "b": f(3)},
            "bn": {"g": f(3), "stats": {"mean": f(3)}}}


def _grads(rs, n):
    return [tree_map(lambda a: (rs.randn(*a.shape) * 0.5).astype(np.float32),
                     _tree(np.random.RandomState(0))) for _ in range(n)]


def _torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(port_tree, jax_tree, what):
    for path, a in tree_items(port_tree):
        want = np.asarray(tree_get(jax_tree, path))
        np.testing.assert_allclose(a.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {'/'.join(path)}")


def _equal(a_tree, b_tree, what):
    for (path, a), (_, b) in zip(tree_items(a_tree), tree_items(b_tree),
                                 strict=True):
        assert torch.equal(a, b), f"{what} {'/'.join(path)}"


def _hooks(mod):
    return mod.HookSet([(r"emb/w$", mod.StaticHook()),
                        (r"l1/w$", mod.PruningHook(0.5))])


# name -> callable(module) building the optimizer from J or P
CONFIGS = {
    "sgd": lambda m: m.SGD(0.1),
    "momentum": lambda m: m.Momentum(0.1, 0.9),
    "nesterov": lambda m: m.Momentum(0.1, 0.9, use_nesterov=True),
    "adagrad": lambda m: m.Adagrad(0.1),
    "decayed_adagrad": lambda m: m.DecayedAdagrad(0.1, decay=0.9),
    "adadelta": lambda m: m.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda m: m.RMSProp(0.05, rho=0.9, momentum=0.5),
    "adam": lambda m: m.Adam(0.01),
    "adamax": lambda m: m.Adamax(0.01),
    "proximal_gd": lambda m: m.ProximalGD(0.1, l1=0.05, l2=0.1),
    "ftrl": lambda m: m.Ftrl(0.1, l1=0.01, l2=0.1),
    "weight_decay": lambda m: m.Momentum(0.1, 0.9, weight_decay=0.01),
    "l1_decay": lambda m: m.SGD(0.1, l1_decay=0.02),
    "l1_l2_decay_adam": lambda m: m.Adam(0.01, weight_decay=0.01,
                                         l1_decay=0.02),
    "clip_value": lambda m: m.SGD(0.1, grad_clip=("value", 0.3)),
    "clip_norm": lambda m: m.SGD(0.1, grad_clip=("norm", 0.5)),
    "clip_global_norm": lambda m: m.Adam(0.01,
                                         grad_clip=("global_norm", 0.8)),
    "hooks_sgd": lambda m: m.SGD(0.1, hooks=_hooks(m)),
    "hooks_adam": lambda m: m.Adam(0.01, hooks=_hooks(m)),
    "sched_constant": lambda m: m.SGD(m.constant_lr(0.1)),
    "sched_exponential": lambda m: m.SGD(m.exponential_decay(0.1, 2, 0.5)),
    "sched_exponential_staircase": lambda m: m.Adam(
        m.exponential_decay(0.01, 2, 0.5, staircase=True)),
    "sched_natural_exp": lambda m: m.SGD(m.natural_exp_decay(0.1, 2, 0.3)),
    "sched_inverse_time": lambda m: m.SGD(m.inverse_time_decay(0.1, 2, 0.5,
                                                               True)),
    "sched_poly": lambda m: m.SGD(m.poly_decay(0.1, 3, 0.01, 2.0)),
    "sched_poly_cycle": lambda m: m.SGD(m.poly_decay(0.1, 3, 0.01, 1.0,
                                                     cycle=True)),
    "sched_piecewise": lambda m: m.Momentum(m.piecewise_decay(
        [2, 3], [0.1, 0.05, 0.01]), 0.9),
    "sched_discexp": lambda m: m.SGD(m.discexp_lr(0.1, 0.5, 2)),
    "sched_warmup": lambda m: m.Adam(m.linear_warmup(
        m.exponential_decay(0.01, 2, 0.7), 3, 0.1)),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_optimizer_follows_jax(name):
    rs = np.random.RandomState(1)
    params = _tree(rs)
    grads = _grads(rs, STEPS)
    jopt, popt = CONFIGS[name](J), CONFIGS[name](P)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    pp = _torch(params)
    ps = popt.init(pp)
    ap = _torch(params)               # written in place by apply_
    aps = popt.init(ap)
    for g in grads:
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        pp, ps = popt.update(_torch(g), ps, pp)
        popt.apply_(_torch(g), aps, ap)
        _close(pp, jp, f"{name} params")
        _close(ps["slots"], js["slots"], f"{name} slots")
        assert int(ps["step"]) == int(js["step"])
        _equal(ap, pp, f"{name} apply_ params")
        _equal(aps["slots"], ps["slots"], f"{name} apply_ slots")
        assert int(aps["step"]) == int(ps["step"])
        assert aps["step"].dtype == torch.int32
    assert ("hooks" in ps) == ("hooks" in js) == name.startswith("hooks")
    if name.startswith("hooks"):
        _close(ps["hooks"], js["hooks"], f"{name} hook state")
        assert torch.equal(pp["emb"]["w"], torch.from_numpy(
            params["emb"]["w"]))                       # frozen
        assert int((pp["l1"]["w"] == 0).sum()) == 6    # half of 12 pruned
    # the stats leaf passes through both sides untouched
    assert torch.equal(pp["bn"]["stats"]["mean"],
                       torch.from_numpy(params["bn"]["stats"]["mean"]))


SCHEDULES = {
    "constant": lambda m: m.constant_lr(0.1),
    "exponential": lambda m: m.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda m: m.exponential_decay(0.1, 3, 0.5,
                                                           True),
    "natural_exp": lambda m: m.natural_exp_decay(0.1, 3, 0.3, True),
    "inverse_time": lambda m: m.inverse_time_decay(0.1, 3, 0.5),
    "poly": lambda m: m.poly_decay(0.1, 5, 0.01, 2.0),
    "poly_cycle": lambda m: m.poly_decay(0.1, 5, 0.01, 1.0, cycle=True),
    "piecewise": lambda m: m.piecewise_decay([3, 7], [0.1, 0.05, 0.01]),
    "discexp": lambda m: m.discexp_lr(0.1, 0.5, 3),
    "warmup": lambda m: m.linear_warmup(m.constant_lr(0.1), 4, 0.25),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_follows_jax_over_steps(name):
    """Each schedule at f32 steps 0..15, as the optimizer calls it (rtol
    2e-6: the same f32 op, an ulp apart at most)."""
    js, ps = SCHEDULES[name](J), SCHEDULES[name](P)
    for s in range(16):
        want = float(js(jnp.asarray(s, jnp.float32)))
        got = ps(torch.tensor(float(s)))
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), want, rtol=2e-6,
                                   err_msg=f"{name} step {s}")


@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
def test_clip_functions_follow_jax(kind):
    rs = np.random.RandomState(3)
    g = _grads(rs, 1)[0]
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    if kind == "value":
        want, got = J.clip_by_value(jg, -0.2, 0.3), P.clip_by_value(
            _torch(g), -0.2, 0.3)
    elif kind == "norm":
        want, got = J.clip_by_norm(jg, 0.4), P.clip_by_norm(_torch(g), 0.4)
    else:
        want, got = (J.clip_by_global_norm(jg, 0.9),
                     P.clip_by_global_norm(_torch(g), 0.9))
        from paddle_tpu.optimizer.clip import global_norm
        np.testing.assert_allclose(float(P.global_norm(_torch(g))),
                                   float(global_norm(jg)), rtol=1e-6)
    _close(got, want, f"clip {kind}")


@pytest.mark.parametrize("window", [0.0, 0.8])
def test_parameter_averager_follows_jax(window):
    rs = np.random.RandomState(4)
    trees = [_tree(rs) for _ in range(3)]
    ja, pa = J.ParameterAverager(window, min_count=2), P.ParameterAverager(
        window, min_count=2)
    js = ja.init(jax.tree_util.tree_map(jnp.asarray, trees[0]))
    ps = pa.init(_torch(trees[0]))
    for i, t in enumerate(trees):
        jt = jax.tree_util.tree_map(jnp.asarray, t)
        js = ja.accumulate(js, jt)
        ps = pa.accumulate(ps, _torch(t))
        want, got = ja.average(js, jt), pa.average(ps, _torch(t))
        _close(got, want, f"average after {i + 1}")
        if i == 0:     # below min_count: the raw params
            _equal(got, _torch(t), "raw params")
