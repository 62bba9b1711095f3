"""The port's op zoo (paddle_tpu_torch/ops/activations.py, loss.py,
math.py, random.py, sequence.py) against the JAX package's, on the CPU,
on the same numpy inputs from a seed.

Every op is held in f32 on its value and, where JAX differentiates it,
on the gradient of ``sum(out * cot)`` (a random cotangent) with respect
to each float input. Tolerance: ``ATOL`` (2e-5) of the reference's
largest magnitude (at least 1) plus rtol 1e-5 — both sides compute in
f32 and differ only in summation order and libm's last bits (the JAX
side runs jitted, so XLA may fuse its elementwise chains). Ties are
planted where JAX fixes an order (``top_k``, ``argmax``,
``kmax_seq_score``) and the results must be equal, not close. The
random fills draw other bits than JAX: they are held to moments and
ranges.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.lod import NestedSeqBatch as JNested
from paddle_tpu.ops import activations as JA
from paddle_tpu.ops import loss as JL
from paddle_tpu.ops import math as JM
from paddle_tpu.ops import random as JRand
from paddle_tpu.ops import rnn as JR
from paddle_tpu.ops import sequence as JS
from paddle_tpu_torch.core.lod import NestedSeqBatch
from paddle_tpu_torch.ops import activations as A
from paddle_tpu_torch.ops import loss as L
from paddle_tpu_torch.ops import math as M
from paddle_tpu_torch.ops import random as R
from paddle_tpu_torch.ops import rnn as TR
from paddle_tpu_torch.ops import sequence as S

ATOL = 2e-5


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.as_tensor(np.array(a))


def close(got, want, exact=False):
    want = np.asarray(want)
    got = (got.detach().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got))
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or want.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want)
        return
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    scale = max(np.abs(want[finite]).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got[finite], want[finite], rtol=1e-5,
                               atol=ATOL * scale)


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def vjp_check(jfn, tfn, args, diff=(0,), seed=0, jit=True):
    """jfn(*jnp args) against tfn(*tensors): every output, then the
    gradient of sum(out0 * cot) with respect to args[i] for i in diff.
    The JAX side runs under ``jax.jit`` (one compile, where eager JAX
    compiles each primitive) unless ``jit=False``."""
    wrap = jax.jit if jit else (lambda f: f)
    jargs = [_j(a) for a in args]
    targs = [_t(a) for a in args]
    jouts = _outs(wrap(jfn)(*jargs))
    for w, g in zip(jouts, _outs(tfn(*targs))):
        close(g, w)
    if not diff:
        return
    out0 = np.asarray(jouts[0])
    cot = np.asarray(np.random.RandomState(seed).randn(*out0.shape),
                     np.float32)

    def jf(*d):
        a = list(jargs)
        for i, v in zip(diff, d):
            a[i] = v
        return jnp.sum(_outs(jfn(*a))[0] * cot)

    jg = wrap(jax.grad(jf, argnums=tuple(range(len(diff)))))(
        *(jargs[i] for i in diff))
    leaves = [targs[i].clone().requires_grad_(True) for i in diff]
    a = list(targs)
    for i, v in zip(diff, leaves):
        a[i] = v
    out = torch.sum(_outs(tfn(*a))[0] * torch.from_numpy(cot))
    tg = torch.autograd.grad(out, leaves, allow_unused=True,
                             materialize_grads=True)
    for g, w in zip(tg, jg):
        close(g, w)


# ---------------------------------------------------------------- activations

def _act_input(name, rs):
    x = rs.randn(4, 7).astype(np.float32) * 2.0
    x[0, :3] = (50.0, -50.0, 0.3)      # softrelu's clip, big softplus args
    if name in ("sqrt", "log", "reciprocal", "pow"):
        x = np.abs(x) + 0.5
    return x


def test_the_registry_holds_every_jax_name():
    assert sorted(A.ACTIVATIONS) == sorted(JA.ACTIVATIONS.keys())


@pytest.mark.parametrize("name", sorted(JA.ACTIVATIONS.keys()))
def test_activation_matches_jax(name):
    x = _act_input(name, np.random.RandomState(1))
    vjp_check(JA.get(name), A.get(name), [x])


@pytest.mark.parametrize("name,kw", [
    ("brelu", dict(t_min=-1.0, t_max=2.0)), ("leaky_relu", dict(alpha=0.3)),
    ("elu", dict(alpha=0.5)), ("softrelu", dict(threshold=2.0)),
    ("stanh", dict(scale_a=1.1, scale_b=0.5)),
    ("hard_sigmoid", dict(slope=0.3, offset=0.1)),
    ("hard_shrink", dict(threshold=1.2)), ("soft_shrink", dict(lam=0.9)),
    ("thresholded_relu", dict(threshold=0.2)), ("pow", dict(factor=2.5)),
    ("swish", dict(beta=1.7)), ("softmax", dict(axis=0)),
    ("log_softmax", dict(axis=0))])
def test_activation_constants_match_jax(name, kw):
    x = _act_input(name, np.random.RandomState(2))
    vjp_check(lambda a: JA.get(name)(a, **kw),
              lambda a: A.get(name)(a, **kw), [x])


@pytest.mark.parametrize("axis", [1, 2])
def test_sequence_softmax_matches_jax(axis):
    rs = np.random.RandomState(3)
    x = rs.randn(4, 5, 6).astype(np.float32)
    lens = np.array([0, 1, 5, 3] if axis == 1 else [0, 2, 6, 4], np.int32)
    vjp_check(lambda a, l: JA.sequence_softmax(a, l, axis=axis),
              lambda a, l: A.sequence_softmax(a, l, axis=axis), [x, lens])


def test_linear_resolves_every_registered_name():
    from paddle_tpu_torch import nn
    for name in ("gelu", "relu", "tanh", "elu", "softsign", "swish"):
        layer = nn.Linear(3, 2, act=name).init(0, "cpu")
        x = torch.randn(4, 3)
        torch.testing.assert_close(layer(x),
                                   A.get(name)(x @ layer.w + layer.b))


# ---------------------------------------------------------------------- losses

def _losses():
    rs = np.random.RandomState(4)
    B, C = 6, 5
    logits = rs.randn(B, C).astype(np.float32) * 2
    probs = np.asarray(jax.nn.softmax(logits))
    soft = np.asarray(jax.nn.softmax(rs.randn(B, C).astype(np.float32)))
    hard = rs.randint(0, C, B).astype(np.int32)
    bits = rs.randint(0, 2, (B, C)).astype(np.float32)
    lab01 = rs.randint(0, 2, B).astype(np.float32)
    col = rs.randn(B, 1).astype(np.float32) * 1.5
    p01 = (rs.rand(B, C) * 0.98 + 0.01).astype(np.float32)
    x3 = rs.randn(B, 3, 2).astype(np.float32)
    y3 = rs.randn(B, 3, 2).astype(np.float32)
    lens = np.array([0, 1, 7, 3, 5, 2], np.int32)
    return {
        "cross_entropy_hard": ("cross_entropy", [probs, hard], {}, (0,)),
        "cross_entropy_soft": ("cross_entropy", [probs, soft],
                               dict(soft_label=True), (0, 1)),
        "softmax_ce_hard": ("softmax_with_cross_entropy", [logits, hard],
                            {}, (0,)),
        "softmax_ce_soft": ("softmax_with_cross_entropy", [logits, soft],
                            dict(soft_label=True), (0, 1)),
        "sigmoid_ce": ("sigmoid_cross_entropy_with_logits",
                       [logits * 5, p01], {}, (0, 1)),
        "square_error": ("square_error", [x3, y3], {}, (0, 1)),
        "smooth_l1": ("smooth_l1", [x3, y3], {}, (0, 1)),
        "smooth_l1_sigma": ("smooth_l1", [x3, y3], dict(sigma=2.0), (0, 1)),
        "huber_regression": ("huber_regression", [x3, y3], dict(delta=0.7),
                             (0, 1)),
        "huber_classification": ("huber_classification", [col, lab01], {},
                                 (0,)),
        "modified_huber": ("modified_huber", [col[:, 0], lab01], {}, (0,)),
        "hinge": ("hinge", [col, lab01], {}, (0,)),
        "log_loss": ("log_loss", [p01[:, :1], lab01], {}, (0,)),
        "rank_loss": ("rank_loss", [col, col[::-1].copy(), lab01], {},
                      (0, 1)),
        "margin_rank_loss": ("margin_rank_loss",
                             [col, col[::-1].copy(), 2 * lab01 - 1],
                             dict(margin=0.1), (0, 1)),
        "multi_binary_label_ce": ("multi_binary_label_cross_entropy",
                                  [logits, bits], {}, (0,)),
        "soft_binary_class_ce": ("soft_binary_class_cross_entropy",
                                 [p01, bits], {}, (0,)),
        "squared_l2_norm": ("squared_l2_norm", [x3], {}, (0,)),
        "kldiv_loss": ("kldiv_loss", [np.log(probs), soft], {}, (0, 1)),
        "nce_loss": ("nce_loss", [col[:, 0], logits], {}, (0, 1)),
        "masked_seq_loss": ("masked_seq_loss",
                            [rs.randn(B, 7).astype(np.float32), lens], {},
                            (0,)),
    }


LOSSES = _losses()


def test_every_jax_loss_has_a_case():
    names = {n for n, f in vars(JL).items() if inspect.isfunction(f)
             and f.__module__ == JL.__name__ and not n.startswith("_")}
    assert names == {fn for fn, *_ in LOSSES.values()}


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case):
    fn, args, kw, diff = LOSSES[case]
    vjp_check(lambda *a: getattr(JL, fn)(*a, **kw),
              lambda *a: getattr(L, fn)(*a, **kw), args, diff)


# ------------------------------------------------------------------------ math

def _math_cases():
    rs = np.random.RandomState(5)
    a = rs.randn(3, 4).astype(np.float32)
    b = rs.randn(4, 5).astype(np.float32)
    x4 = rs.randn(2, 3, 4, 5).astype(np.float32)
    y2 = rs.randn(3, 4).astype(np.float32)
    v = rs.randn(6, 4).astype(np.float32)
    w = rs.rand(6).astype(np.float32)
    idx = np.array([[2, 0], [5, 2]], np.int32)
    upd = rs.randn(3, 4).astype(np.float32)
    return {
        "matmul": (lambda m: lambda x, y: m.matmul(x, y), [a, b], (0, 1)),
        "matmul_t": (lambda m: lambda x, y: m.matmul(
            x, y, transpose_x=True, transpose_y=True),
            [a.T.copy(), b.T.copy()], (0, 1)),
        "matmul_batched": (lambda m: lambda x, y: m.matmul(x, y),
                           [x4, rs.randn(5, 2).astype(np.float32)], (0, 1)),
        "mul": (lambda m: lambda x, y: m.mul(x, y, x_num_col_dims=2,
                                             y_num_col_dims=2),
                [x4, rs.randn(4, 5, 3).astype(np.float32)], (0, 1)),
        "fc": (lambda m: lambda x, ww, bb: m.fc(x, ww, bb),
               [x4[:, :1].copy(), rs.randn(20, 3).astype(np.float32),
                rs.randn(3).astype(np.float32)], (0, 1, 2)),
        **{f"elementwise_{op}": (
            lambda m, op=op: lambda x, y: getattr(m, f"elementwise_{op}")(
                x, y, axis=1),
            [np.abs(x4) + 0.5 if op == "pow" else x4,
             (np.abs(y2) if op == "pow" else y2 + (3.0 if op == "div"
                                                    else 0.0))], (0, 1))
           for op in ("add", "sub", "mul", "div", "max", "min", "pow")},
        "elementwise_add_trailing": (
            lambda m: lambda x, y: m.elementwise_add(x, y),
            [x4, rs.randn(5).astype(np.float32)], (0, 1)),
        "scale": (lambda m: lambda x: m.scale(x, 1.5, 0.3), [a], (0,)),
        "scale_bias_first": (lambda m: lambda x: m.scale(
            x, 1.5, 0.3, bias_after_scale=False), [a], (0,)),
        "clip": (lambda m: lambda x: m.clip(x, -0.4, 0.6), [a], (0,)),
        "clip_by_norm": (lambda m: lambda x: m.clip_by_norm(x, 1.0), [a],
                         (0,)),
        "clip_by_norm_under": (lambda m: lambda x: m.clip_by_norm(x, 100.0),
                               [a], (0,)),
        **{f"reduce_{op}_{ax}": (
            lambda m, op=op, ax=ax: lambda x: getattr(m, f"reduce_{op}")(
                x, axis=ax, keepdims=ax == 1), [x4], (0,))
           for op in ("sum", "mean", "max", "min")
           for ax in (None, 1, (0, 2))},
        "mean": (lambda m: lambda x: m.mean(x), [x4], (0,)),
        "reshape": (lambda m: lambda x: m.reshape(x, (6, -1)), [x4], (0,)),
        "transpose": (lambda m: lambda x: m.transpose(x, (2, 0, 3, 1)), [x4],
                      (0,)),
        "transpose_rev": (lambda m: lambda x: m.transpose(x), [x4], (0,)),
        "concat": (lambda m: lambda x, y: m.concat([x, y, x], axis=1),
                   [a, rs.randn(3, 2).astype(np.float32)], (0, 1)),
        "split_equal": (lambda m: lambda x: m.split(x, 2, axis=1), [a],
                        (0,)),
        "split_sections": (lambda m: lambda x: m.split(x, [1, 3, 1], axis=0),
                           [rs.randn(5, 2).astype(np.float32)], (0,)),
        "expand": (lambda m: lambda x: m.expand(x, (2, 1, 3)), [a], (0,)),
        "pad": (lambda m: lambda x: m.pad(x, [(1, 2), (0, 3)], 0.5), [a],
                (0,)),
        "crop": (lambda m: lambda x: m.crop(x, (1, 3), (2, 2)), [a], (0,)),
        "cast": (lambda m: lambda x: m.cast(x, (jnp.int32 if m is JM
                                                else torch.int32)),
                 [a * 4], ()),
        "gather": (lambda m: lambda x, i: m.gather(x, i, axis=0), [v, idx],
                   (0,)),
        "gather_axis1": (lambda m: lambda x, i: m.gather(x, i, axis=1),
                         [v, np.array([[2], [0], [3]], np.int32)], (0,)),
        "scatter_overwrite": (lambda m: lambda x, u: m.scatter(
            x, np.array([4, 0, 2]), u), [v, upd], (0, 1)),
        "scatter_add": (lambda m: lambda x, u: m.scatter(
            x, np.array([4, 0, 4]), u, overwrite=False), [v, upd], (0, 1)),
        "cos_sim": (lambda m: lambda x, y: m.cos_sim(x, y),
                    [v, v[::-1].copy()], (0, 1)),
        "l2_normalize": (lambda m: lambda x: m.l2_normalize(x, axis=0), [v],
                         (0,)),
        "interpolation": (lambda m: lambda x, y, ww: m.interpolation(x, y,
                                                                     ww),
                          [v, v[::-1].copy(), w], (0, 1, 2)),
        "sum_op": (lambda m: lambda x, y: m.sum_op([x, y, x]),
                   [v, v[::-1].copy()], (0, 1)),
    }


MATH = _math_cases()


@pytest.mark.parametrize("case", sorted(MATH))
def test_math_op_matches_jax(case):
    make, args, diff = MATH[case]
    # JAX's split with sections reads the cut points to the host
    vjp_check(make(JM), make(M), args, diff, jit=case != "split_sections")


def test_top_k_and_argmax_take_the_lower_index_on_a_tie():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [5.0, 1.0, 5.0, 1.0, 2.0, 5.0]], np.float32)
    jv, ji = JM.top_k(_j(x), 4)
    tv, ti = M.top_k(_t(x), 4)
    close(tv, jv, exact=True)
    close(ti, ji, exact=True)
    np.testing.assert_array_equal(ti.numpy()[0], [1, 2, 4, 5])
    for axis in (0, 1):
        close(M.argmax(_t(x), axis), JM.argmax(_j(x), axis), exact=True)
    np.testing.assert_array_equal(M.argmax(_t(x)).numpy(), [1, 0, 0])


def test_split_refuses_an_unequal_split():
    with pytest.raises(ValueError, match="equal parts"):
        M.split(torch.zeros(5, 2), 2)


# ---------------------------------------------------------------------- random

def test_gaussian_and_uniform_fills_hold_their_moments_and_ranges():
    g = torch.Generator().manual_seed(0)
    x = R.gaussian_random(g, (200, 500), mean=1.5, std=0.5, device="cpu")
    assert x.shape == (200, 500) and x.dtype == torch.float32
    assert abs(x.mean().item() - 1.5) < 0.01
    assert abs(x.std().item() - 0.5) < 0.01
    u = R.uniform_random(g, (200, 500), low=-2.0, high=3.0, device="cpu")
    assert u.min() >= -2.0 and u.max() < 3.0
    assert abs(u.mean().item() - 0.5) < 0.03
    assert abs(u.var().item() - 25.0 / 12.0) < 0.05
    # JAX's fills at the same arguments hold the same moments
    jg = np.asarray(JRand.gaussian_random(jax.random.PRNGKey(0), (200, 500),
                                          1.5, 0.5))
    ju = np.asarray(JRand.uniform_random(jax.random.PRNGKey(1), (200, 500),
                                         -2.0, 3.0))
    assert abs(jg.mean() - 1.5) < 0.01 and abs(jg.std() - 0.5) < 0.01
    assert ju.min() >= -2.0 and ju.max() < 3.0
    # the same seed gives the same draw, another seed another
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    assert torch.equal(R.uniform_random(g1, (5,), device="cpu"),
                       R.uniform_random(g2, (5,), device="cpu"))
    bf = R.gaussian_random(g, (4,), dtype=torch.bfloat16, device="cpu")
    assert bf.dtype == torch.bfloat16


def test_fills_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        R.gaussian_random(torch.Generator(), (3,))


# -------------------------------------------------------------------- sequence

LENS = np.array([0, 1, 6, 3, 5], np.int32)


def _seq(seed=6, B=5, T=6, D=4):
    rs = np.random.RandomState(seed)
    return rs.randn(B, T, D).astype(np.float32), rs


@pytest.mark.parametrize("pool", ["average", "avg", "sum", "sqrt", "max",
                                  "min", "last", "first"])
def test_sequence_pool_matches_jax(pool):
    x, _ = _seq()
    vjp_check(lambda a, l: JS.sequence_pool(a, l, pool),
              lambda a, l: S.sequence_pool(a, l, pool), [x, LENS])


def _seq_cases():
    x, rs = _seq()
    b = rs.randn(5, 4, 4).astype(np.float32)
    lb = np.array([2, 0, 4, 1, 3], np.int32)
    off = np.array([0, 1, 2, 0, 4], np.int32)
    ln = np.array([0, 1, 3, 2, 2], np.int32)
    w = rs.randn(3, 4).astype(np.float32)
    filt = rs.randn(12, 7).astype(np.float32)
    bias = rs.randn(7).astype(np.float32)
    return {
        "expand": (lambda m: lambda v, l: m.sequence_expand(v, l, 6),
                   [x[:, 0].copy(), LENS], (0,)),
        "reverse": (lambda m: lambda v, l: m.sequence_reverse(v, l),
                    [x, LENS], (0,)),
        "slice": (lambda m: lambda v, l, o, n: m.sequence_slice(v, l, o, n,
                                                                4),
                  [x, LENS, off, ln], (0,)),
        "concat": (lambda m: lambda a, la, bb, lb_: m.sequence_concat(
            a, la, bb, lb_), [x, LENS, b, lb], (0, 2)),
        "concat_max_out": (lambda m: lambda a, la, bb, lb_:
                           m.sequence_concat(a, la, bb, lb_, max_out=8),
                           [x, LENS, b, lb], (0, 2)),
        **{f"context_{start}_{n}": (
            lambda m, start=start, n=n: lambda v, l: m.context_projection(
                v, l, start, n), [x, LENS], (0,))
           for start, n in ((-1, 3), (0, 2), (-2, 5), (1, 2))},
        **{f"context_w_{start}_{n}": (
            lambda m, start=start, n=n: lambda v, l, ww:
            m.context_projection(v, l, start, n, ww), [x, LENS, w], (0, 2))
           for start, n in ((-1, 3), (-2, 5), (0, 3))},
        "conv": (lambda m: lambda v, l, f, bb: m.sequence_conv(
            v, l, f, -1, 3, bb), [x, LENS, filt, bias], (0, 2, 3)),
        "conv_no_bias": (lambda m: lambda v, l, f: m.sequence_conv(
            v, l, f[:8], 0, 2), [x, LENS, filt], (0, 2)),
    }


SEQ = _seq_cases()


@pytest.mark.parametrize("case", sorted(SEQ))
def test_sequence_op_matches_jax(case):
    make, args, diff = SEQ[case]
    vjp_check(make(JS), make(S), args, diff)


def _nested(seed=7):
    rs = np.random.RandomState(seed)
    sub = np.array([[3, 1, 0], [4, 2, 2], [0, 0, 0]], np.int32)
    seq = np.array([2, 3, 0], np.int32)
    data = rs.randn(3, 3, 4, 5).astype(np.float32)
    data *= (np.arange(4)[None, None, :] < sub[..., None])[..., None]
    return data, sub, seq, rs


def _nb(m, data, sub, seq):
    if m is JS:
        return JNested(_j(data), _j(sub), _j(seq))
    return NestedSeqBatch(_t(data), _t(sub), _t(seq))


@pytest.mark.parametrize("op", ["pool_average", "pool_max", "pool_sum",
                                "last", "first"])
def test_nested_pools_match_jax(op):
    data, sub, seq, _ = _nested()

    def make(m):
        def f(d):
            nb = _nb(m, data, sub, seq)
            nb = type(nb)(d, nb.sub_lengths, nb.seq_lengths)
            if op.startswith("pool_"):
                out = m.nested_seq_pool(nb, op[5:])
            else:
                out = getattr(m, f"nested_{op}_step")(nb)
            return out.data, out.lengths
        return f

    vjp_check(make(JS), make(S), [data])


def test_sub_seq_expand_matches_jax():
    data, sub, seq, rs = _nested()
    vals = rs.randn(3, 3, 5).astype(np.float32)
    vjp_check(lambda v: JS.sub_seq_expand(v, _nb(JS, data, sub, seq)),
              lambda v: S.sub_seq_expand(v, _nb(S, data, sub, seq)), [vals])


@pytest.mark.parametrize("rnn", ["lstm", "gru"])
def test_nested_rnn_matches_jax(rnn):
    data, sub, seq, rs = _nested()
    H = 6
    g = 4 if rnn == "lstm" else 3
    w = (rs.randn(5, g * H) * 0.3).astype(np.float32)
    u = (rs.randn(H, g * H) * 0.3).astype(np.float32)
    b = (rs.randn(g * H) * 0.1).astype(np.float32)

    def make(m, rnn_mod):
        def f(d, ww, uu, bb):
            nb = _nb(m, data, sub, seq)
            nb = type(nb)(d, nb.sub_lengths, nb.seq_lengths)
            out, last = m.nested_rnn(getattr(rnn_mod, rnn), nb, ww, uu, bb)
            return out, last.data
        return f

    vjp_check(make(JS, JR), make(S, TR), [data, w, u, b], (0, 1, 2, 3))


def test_kmax_seq_score_takes_the_lower_position_on_a_tie():
    scores = np.array([[1.0, 4.0, 4.0, 2.0, 4.0, 9.0],
                       [3.0, 3.0, 3.0, 3.0, 3.0, 3.0],
                       [0.5, 7.0, 1.0, 7.0, 0.0, 0.0],
                       [2.0, 2.0, 1.0, 1.0, 0.0, 0.0]], np.float32)
    lens = np.array([5, 6, 4, 2], np.int32)
    for k in (1, 3, 4):
        want = JS.kmax_seq_score(_j(scores), _j(lens), k)
        got = S.kmax_seq_score(_t(scores), _t(lens), k)
        close(got, want, exact=True)
        assert got.dtype == torch.int32
    got = S.kmax_seq_score(_t(scores)[..., None], _t(lens), 4).numpy()
    np.testing.assert_array_equal(got[0], [1, 2, 4, 3])   # 9.0 is padding
    np.testing.assert_array_equal(got[3], [0, 1, 2, 3])   # tail: padding


def test_sub_nested_seq_matches_jax():
    data, sub, _, rs = _nested()
    idx = np.array([[2, 0], [1, 5], [-1, 1]], np.int32)   # clamped
    vjp_check(lambda d, i: JS.sub_nested_seq(d, _j(sub), i),
              lambda d, i: S.sub_nested_seq(d, _t(sub), i), [data, idx])
