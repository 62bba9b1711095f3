"""The port's image stack (paddle_tpu_torch/ops/conv.py, pool.py, norm.py,
random.py; nn layers, initializers, module stats, Sequential/Lambda;
optimizer Momentum; the trainer's stat merge and generators) against the
JAX package, on the CPU, on the same numpy inputs from a seed.

Tolerances, each with its reason:
* f32: ``F32_ATOL`` (1e-5) of the largest magnitude of the reference,
  rtol 1e-5 — both sides compute in f32 and differ only in summation
  order (XLA's convolutions and reductions against PyTorch's).
* bf16 results of one op: ``bf16_close`` — one bf16 ulp of the
  reference's largest magnitude plus 2**-7 of each entry: both sides
  round one f32 result to bf16, and where JAX rounds between steps (the
  scale-shift ``x * a + b``, LRN's sums) an entry may land one ulp away.
* Dropout draws other bits than JAX: its keep rate and scale are held as
  statistics (``test_dropout_keeps_and_scales_as_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import nn as jnn
from paddle_tpu.nn import initializer as JI
from paddle_tpu.ops import conv as jconv
from paddle_tpu.ops import norm as jnorm
from paddle_tpu.ops import pool as jpool
from paddle_tpu.ops import random as jrandom
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu_torch import nn
from paddle_tpu_torch.convert import params_from_numpy, port_tree
from paddle_tpu_torch.core.pytree import tree_items, tree_map
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.ops import conv, norm, pool
from paddle_tpu_torch.ops.random import dropout
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.trainer import Trainer

F32_ATOL = 1e-5
META = torch.device("meta")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(x)) - 7) if x > 0 else 0.0


def f32_close(got, want, scale=None):
    want = np.asarray(want, np.float32)
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    s = scale if scale is not None else max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=F32_ATOL * s, rtol=1e-5)


def bf16_close(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    np.testing.assert_allclose(got, want, atol=_bf16_ulp(np.abs(want).max()),
                               rtol=2.0 ** -7)


def _pair(rs, shape, dtype, scale=1.0, shift=0.0):
    a = (rs.randn(*shape) * scale + shift).astype(np.float32)
    j, t = jnp.asarray(a), torch.from_numpy(a)
    if dtype == "bf16":
        return j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


def _close(dtype):
    return bf16_close if dtype == "bf16" else f32_close


def trees_close(got, want):
    """Every leaf of a port tree against the same path of a JAX tree (JAX
    sorts a dict's keys when it maps a tree, so paths, not orders)."""
    g = dict(tree_items(got))
    w = dict(tree_items(port_tree(_np(want))))
    assert g.keys() == w.keys()
    for path in w:
        f32_close(g[path], w[path])


# -- convolutions -------------------------------------------------------------

CONVS = [
    # (H, W, cin, cout, k, stride, padding, dilation, groups)
    (12, 12, 8, 16, 3, 1, 1, 1, 1),        # a ResNet 3x3
    (12, 12, 16, 32, 1, 2, 0, 1, 1),       # a 1x1 stride-2 projection
    (13, 11, 8, 8, 3, 2, "SAME", 1, 1),    # asymmetric SAME pads
    (12, 12, 8, 8, 4, 2, "SAME", 1, 1),    # even kernel, SAME
    (11, 11, 8, 8, 5, 3, "SAME", 1, 1),
    (12, 12, 8, 8, 3, 1, "VALID", 1, 1),
    (12, 12, 8, 8, 3, 1, 2, 2, 1),         # dilation
    (12, 12, 8, 16, 3, 1, 1, 1, 4),        # groups
    (12, 10, 4, 8, (3, 5), (1, 2), (1, 2), 1, 1),   # pairs
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CONVS, ids=[str(c) for c in CONVS])
def test_conv2d_matches_jax(case, dtype):
    H, W, cin, cout, k, s, p, d, g = case
    kh, kw = (k, k) if isinstance(k, int) else k
    rs = np.random.RandomState(0)
    xj, xt = _pair(rs, (2, H, W, cin), dtype)
    wj, wt = _pair(rs, (kh, kw, cin // g, cout), dtype, 0.2)
    want = jconv.conv2d(xj, wj, stride=s, padding=p, dilation=d, groups=g)
    got = conv.conv2d(xt, wt, stride=s, padding=p, dilation=d, groups=g)
    assert tuple(got.shape) == want.shape and got.dtype == xt.dtype
    _close(dtype)(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("hw", [(16, 16), (14, 10)])
def test_stem_space_to_depth_matches_jax_and_the_direct_conv(hw, dtype):
    rs = np.random.RandomState(1)
    xj, xt = _pair(rs, (2,) + hw + (3,), dtype)
    wj, wt = _pair(rs, (7, 7, 3, 16), dtype, 0.1)
    want = jconv.conv7s2_space_to_depth(xj, wj)
    got = conv.conv7s2_space_to_depth(xt, wt)
    _close(dtype)(got, want)
    _close(dtype)(conv.conv7s2(xt, wt), jconv.conv7s2(xj, wj))
    direct = jconv.conv2d(xj, wj, stride=2, padding=3)
    _close(dtype)(conv.conv2d(xt, wt, stride=2, padding=3), direct)
    if dtype == "f32":
        f32_close(got, direct)


def test_stem_space_to_depth_rejects_odd_sizes():
    with pytest.raises(ValueError, match="even"):
        conv.conv7s2_space_to_depth(torch.zeros(1, 15, 16, 3),
                                    torch.zeros(7, 7, 3, 8))
    # conv7s2 takes the direct route there, as JAX does
    assert conv.conv7s2(torch.zeros(1, 15, 16, 3),
                        torch.zeros(7, 7, 3, 8)).shape == (1, 8, 8, 8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mult,stride,padding", [(1, 1, 1), (2, 2, "SAME"),
                                                 (1, 2, "VALID")])
def test_depthwise_conv2d_matches_jax(mult, stride, padding, dtype):
    rs = np.random.RandomState(2)
    xj, xt = _pair(rs, (2, 11, 12, 8), dtype)
    wj, wt = _pair(rs, (3, 3, 1, 8 * mult), dtype, 0.3)
    want = jconv.depthwise_conv2d(xj, wj, stride=stride, padding=padding)
    _close(dtype)(conv.depthwise_conv2d(xt, wt, stride=stride,
                                        padding=padding), want)


TRANSPOSES = [(3, 1, 0), (3, 1, 1), (3, 2, 0), (3, 2, 1), (4, 2, 1),
              (3, 2, "SAME"), (4, 2, "SAME"), (2, 3, "SAME"), (3, 2, "VALID"),
              (2, 3, "VALID")]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,stride,padding", TRANSPOSES,
                         ids=[str(c) for c in TRANSPOSES])
def test_conv2d_transpose_matches_lax_conv_transpose(k, stride, padding,
                                                     dtype):
    """JAX does not flip the kernel (``transpose_kernel=False``); the port
    gives ``conv_transpose2d`` the flipped one, so the two agree."""
    rs = np.random.RandomState(3)
    xj, xt = _pair(rs, (2, 7, 6, 8), dtype)
    wj, wt = _pair(rs, (k, k, 8, 5), dtype, 0.3)
    want = jconv.conv2d_transpose(xj, wj, stride=stride, padding=padding)
    got = conv.conv2d_transpose(xt, wt, stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    _close(dtype)(got, want)


def test_conv_gradients_match_jax():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 9, 9, 4).astype(np.float32)
    w = (rs.randn(3, 3, 4, 6) * 0.3).astype(np.float32)
    wt_ = (rs.randn(3, 3, 4, 6) * 0.3).astype(np.float32)

    def jf(x, w, wt_):
        a = jconv.conv2d(x, w, stride=2, padding="SAME")
        b = jconv.conv2d_transpose(x, wt_, stride=2, padding=1)
        return jnp.sum(a ** 2) + jnp.sum(jnp.sin(b))

    want = jax.grad(jf, argnums=(0, 1, 2))(x, w, wt_)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, wt_)]
    a = conv.conv2d(ts[0], ts[1], stride=2, padding="SAME")
    b = conv.conv2d_transpose(ts[0], ts[2], stride=2, padding=1)
    got = torch.autograd.grad(torch.sum(a ** 2) + torch.sum(torch.sin(b)),
                              ts)
    for g, w_ in zip(got, want):
        f32_close(g, w_)


# -- pools --------------------------------------------------------------------

POOLS = [(3, 2, 1), (2, 2, 0), (3, 2, "SAME"), (3, 1, 1), (3, 2, "VALID"),
         (3, 1, 2), ((3, 2), (2, 1), (1, 0)), (5, 3, 0)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,s,p", POOLS, ids=[str(c) for c in POOLS])
def test_max_pool2d_matches_jax(k, s, p, dtype):
    rs = np.random.RandomState(5)
    xj, xt = _pair(rs, (2, 13, 12, 8), dtype)
    want = jpool.max_pool2d(xj, k, s, p)
    got = pool.max_pool2d(xt, k, s, p)
    assert tuple(got.shape) == want.shape
    _close(dtype)(got, want)


@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("k,s,p", POOLS, ids=[str(c) for c in POOLS])
def test_avg_pool2d_matches_jax(k, s, p, count_include_pad):
    rs = np.random.RandomState(6)
    xj, xt = _pair(rs, (2, 13, 12, 8), "f32")
    want = jpool.avg_pool2d(xj, k, s, p, count_include_pad=count_include_pad)
    got = pool.avg_pool2d(xt, k, s, p, count_include_pad=count_include_pad)
    f32_close(got, want)


def test_avg_pool2d_bf16_and_global_pools_match_jax():
    rs = np.random.RandomState(7)
    for dtype in ("f32", "bf16"):
        xj, xt = _pair(rs, (3, 7, 9, 16), dtype)
        _close(dtype)(pool.avg_pool2d(xt, 5, 3), jpool.avg_pool2d(xj, 5, 3))
        _close(dtype)(pool.global_avg_pool2d(xt),
                      jpool.global_avg_pool2d(xj))
        _close(dtype)(pool.global_max_pool2d(xt),
                      jpool.global_max_pool2d(xj))


def test_pool_gradients_match_jax():
    rs = np.random.RandomState(8)
    x = rs.randn(2, 9, 8, 4).astype(np.float32)

    def jf(x):
        return (jnp.sum(jpool.max_pool2d(x, 3, 2, 1) ** 2)
                + jnp.sum(jpool.avg_pool2d(x, 3, 2, 1, False) ** 3)
                + jnp.sum(jpool.global_avg_pool2d(x) ** 2))

    xt = torch.from_numpy(x).requires_grad_(True)
    out = (torch.sum(pool.max_pool2d(xt, 3, 2, 1) ** 2)
           + torch.sum(pool.avg_pool2d(xt, 3, 2, 1, False) ** 3)
           + torch.sum(pool.global_avg_pool2d(xt) ** 2))
    f32_close(torch.autograd.grad(out, xt)[0], jax.grad(jf)(x))


# -- batch norm, LRN ----------------------------------------------------------

def _bn_inputs(rs, dtype, shape=(4, 6, 5, 8)):
    C = shape[-1]
    x = _pair(rs, shape, dtype, 2.0, 3.0)
    gamma = _pair(rs, (C,), dtype, 0.5, 1.0)
    beta = _pair(rs, (C,), dtype, 0.5)
    rmean = _pair(rs, (C,), dtype, 0.5, 2.5)
    rvar = tuple(v * v + 0.5 for v in _pair(rs, (C,), dtype))
    return x, gamma, beta, rmean, rvar


BN_PASSES = ("fused", "shifted")


def _bn(form, x, gamma, beta, rmean, rvar, train=True):
    """``batch_norm`` with its training pass named: "fused" is the pass
    ``batch_norm`` runs (``_train_fused``; ``_train_shifted`` for one
    element a channel), "shifted" JAX's one-pass form, ``_train_shifted``
    with the running stats merged as ``batch_norm`` merges them."""
    if form == "fused" or not train:
        return norm.batch_norm(x, gamma, beta, rmean, rvar, train=train)
    y, mean, var = norm._train_shifted(x, gamma, beta, rmean, 1e-5)
    return (y,) + norm._merge_running(rmean, rvar, mean, var, 0.9)


@pytest.mark.parametrize("form", BN_PASSES)
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batch_norm_matches_jax(dtype, train, form):
    rs = np.random.RandomState(9)
    args = _bn_inputs(rs, dtype)
    want = jnorm.batch_norm(*(a[0] for a in args), train=train)
    got = _bn(form, *(a[1] for a in args), train=train)
    for g, w in zip(got, want):
        assert g.dtype == args[0][1].dtype and tuple(g.shape) == w.shape
        _close(dtype)(g, w)


@pytest.mark.parametrize("form", BN_PASSES)
@pytest.mark.parametrize("shape", [(4, 6, 5, 8), (16, 8), (5, 1, 1, 3),
                                   (1, 1, 1, 3)])
def test_batch_norm_training_gradients_match_jax(shape, form):
    """Gradients flow through the batch moments, as in JAX (the running
    mean only shifts them, under stop_gradient); a channel of one element
    has variance 0."""
    rs = np.random.RandomState(10)
    (xj, xt), (gj, gt), (bj, bt), (mj, mt), (vj, vt) = _bn_inputs(
        rs, "f32", shape)
    cot = rs.randn(*shape).astype(np.float32)

    def jf(x, g, b, m):
        y, nm, nv = jnorm.batch_norm(x, g, b, m, vj, train=True)
        return jnp.sum(y * cot), (nm, nv)

    (_, (nm, nv)), want = jax.value_and_grad(jf, argnums=(0, 1, 2, 3),
                                             has_aux=True)(xj, gj, bj, mj)
    ts = [t.clone().requires_grad_(True) for t in (xt, gt, bt, mt)]
    y, tm, tv = _bn(form, *ts, vt)
    got = torch.autograd.grad(torch.sum(y * torch.from_numpy(cot)), ts,
                              materialize_grads=True)
    for g, w in zip(got, want):
        f32_close(g, w)
    f32_close(tm, nm)
    f32_close(tv, nv)


@pytest.mark.parametrize("shape", [(4, 6, 5, 8), (1, 1, 1, 3)])
def test_batch_norm_trains_through_the_fused_pass(shape):
    """``batch_norm`` in training mode returns what ``_train_fused`` and
    ``_merge_running`` give, bit for bit; for one element a channel, which
    ``F.batch_norm`` refuses, what ``_train_shifted`` gives."""
    rs = np.random.RandomState(12)
    x, g, b, m, v = (a[1] for a in _bn_inputs(rs, "f32", shape))
    if x.numel() == x.shape[-1]:
        with pytest.raises(ValueError):
            norm._train_fused(x, g, b, 1e-5)
        y, mean, var = norm._train_shifted(x, g, b, m, 1e-5)
    else:
        y, mean, var = norm._train_fused(x, g, b, 1e-5)
    want = (y,) + norm._merge_running(m, v, mean, var, 0.9)
    for got, w in zip(norm.batch_norm(x, g, b, m, v, train=True), want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_lrn_and_cross_map_norm_match_jax(dtype):
    rs = np.random.RandomState(11)
    xj, xt = _pair(rs, (2, 5, 4, 12), dtype, 3.0)
    _close(dtype)(norm.lrn(xt), jnorm.lrn(xj))
    _close(dtype)(norm.lrn(xt, size=3, alpha=1e-2, beta=0.5, k=2.0),
                  jnorm.lrn(xj, size=3, alpha=1e-2, beta=0.5, k=2.0))
    _close(dtype)(norm.cross_map_norm(xt, 7, 1e-3, 0.6),
                  jnorm.cross_map_norm(xj, 7, 1e-3, 0.6))


# -- dropout ------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.1, 0.5, 0.7])
def test_dropout_keeps_and_scales_as_jax(rate):
    """torch and JAX draw different bits: both keep a share 1 - rate of
    the elements (within 5 standard deviations over 200k draws) and scale
    the kept ones by 1 / (1 - rate) exactly; eval and rate 0 pass x."""
    n = 200_000
    x = np.full((n,), 2.0, np.float32)
    want = np.asarray(jrandom.dropout(jnp.asarray(x), rate,
                                      jax.random.PRNGKey(0)))
    got = dropout(torch.from_numpy(x), rate,
                  torch.Generator().manual_seed(0)).numpy()
    keep = 1.0 - rate
    tol = 5 * np.sqrt(keep * (1 - keep) / n)
    for out in (want, got):
        kept = out != 0
        assert abs(kept.mean() - keep) < tol
        assert np.all(out[kept] == np.float32(2.0) / np.float32(keep))
    xt = torch.from_numpy(x)
    assert dropout(xt, rate, None, train=False) is xt
    assert torch.equal(dropout(xt, rate, None, train=False,
                               scale_in_train=False), xt * (1.0 - rate))
    np.testing.assert_array_equal(
        np.asarray(jrandom.dropout(jnp.asarray(x), rate, None, train=False,
                                   scale_in_train=False)),
        (xt * (1.0 - rate)).numpy())


def test_dropout_draws_from_its_generator():
    x = torch.ones(1000)
    a = dropout(x, 0.5, torch.Generator().manual_seed(3))
    b = dropout(x, 0.5, torch.Generator().manual_seed(3))
    c = dropout(x, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- initializers -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 3, 16, 32), (7, 7, 3, 64), (5, 7),
                                   (9,), (2, 3, 4)])
def test_fans_match_jax(shape):
    assert I._fans(shape) == JI._fans(shape)


@pytest.mark.parametrize("make,std", [
    (lambda m: m.msra(), lambda fi, fo: np.sqrt(2.0 / fi)),
    (lambda m: m.msra(uniform_dist=True), lambda fi, fo: np.sqrt(2.0 / fi)),
    (lambda m: m.xavier(), lambda fi, fo: np.sqrt(2.0 / (fi + fo))),
    (lambda m: m.xavier(uniform_dist=False),
     lambda fi, fo: np.sqrt(2.0 / (fi + fo))),
    (lambda m: m.gen1_default(), lambda fi, fo: 1.0 / np.sqrt(fi)),
    (lambda m: m.gen1_default(0.05), lambda fi, fo: 0.05),
], ids=["msra", "msra_uniform", "xavier", "xavier_normal", "gen1",
        "gen1_std"])
def test_initializers_draw_jax_distributions_on_a_conv_kernel(make, std):
    """A 4-D kernel's fans multiply in the receptive field; the port's and
    JAX's draws have the same mean (0) and std (within 3% over 73k draws)
    and, for the uniform ones, the same bound."""
    shape = (3, 3, 64, 128)
    want = std(*JI._fans(shape))
    jw = np.asarray(make(JI)(jax.random.PRNGKey(0), shape))
    tw = torch.empty(shape)
    make(I)(tw, torch.Generator().manual_seed(0))
    tw = tw.numpy()
    for w in (jw, tw):
        assert abs(w.std() / want - 1.0) < 0.03
        assert abs(w.mean()) < 0.03 * want
    assert abs(np.abs(tw).max() - np.abs(jw).max()) < 0.5 * want


# -- layers and the module system ---------------------------------------------

def _load(jmod, tmod, seed=0):
    params = jmod.init(jax.random.PRNGKey(seed))
    return params, params_from_numpy(_np(params), tmod, "cpu")


def test_conv2d_stem_layer_matches_jax_and_the_direct_conv():
    """The stem layer (7x7/s2/p3 over 3 channels) runs the direct conv,
    JAX's layer the space-to-depth rewrite: both give the direct conv."""
    jl = jnn.Conv2D(3, 16, 7, stride=2, padding=3, act="relu")
    tl = nn.Conv2D(3, 16, 7, stride=2, padding=3, act="relu")
    params, tl = _load(jl, tl)
    assert jl._is_stem7s2()
    x = np.random.RandomState(12).rand(2, 16, 16, 3).astype(np.float32)
    got = tl(torch.from_numpy(x))
    f32_close(got, jl(params, jnp.asarray(x)))
    f32_close(got, jax.nn.relu(jconv.conv2d(
        jnp.asarray(x), params["w"], stride=2, padding=3) + params["b"]))


def test_conv2d_transpose_and_pool_layers_match_jax():
    rs = np.random.RandomState(13)
    x = rs.randn(2, 6, 6, 4).astype(np.float32)
    jl = jnn.Conv2DTranspose(4, 6, 3, stride=2, padding=1, act="relu")
    params, tl = _load(jl, nn.Conv2DTranspose(4, 6, 3, stride=2, padding=1,
                                              act="relu"))
    f32_close(tl(torch.from_numpy(x)), jl(params, jnp.asarray(x)))
    for jm, tm in ((jnn.MaxPool2D(3, 2, 1), nn.MaxPool2D(3, 2, 1)),
                   (jnn.AvgPool2D(2), nn.AvgPool2D(2))):
        f32_close(tm(torch.from_numpy(x)), jm({}, jnp.asarray(x)))


def test_linear_flattens_a_map_and_takes_a_callable_act():
    jl = jnn.Linear(4 * 4 * 3, 5, act=jax.nn.relu)
    params, tl = _load(jl, nn.Linear(4 * 4 * 3, 5, act=torch.relu))
    x = np.random.RandomState(14).randn(2, 4, 4, 3).astype(np.float32)
    f32_close(tl(torch.from_numpy(x)), jl(params, jnp.asarray(x)))


def test_batch_norm_layer_records_stats_under_its_path():
    """The tree holds the moving stats under ``stats``, as JAX's ``init``;
    training mode records the new ones under the module's path, equal to
    JAX's, and ``apply_stat_updates`` merges them as JAX does."""
    jm = jnn.Sequential(jnn.Linear(6, 8), jnn.BatchNorm(8, act="relu"))
    tm = nn.Sequential(nn.Linear(6, 8), nn.BatchNorm(8, act="relu"))
    params, tm = _load(jm, tm)
    tree = tm.tree()
    assert set(tree["mods_1"]) == {"gamma", "beta", "stats"}
    assert set(tree["mods_1"]["stats"]) == {"moving_mean", "moving_var"}
    x = np.random.RandomState(15).randn(16, 6).astype(np.float32) * 2 + 1
    jmut, tmut = {}, {}
    want = jm(params, jnp.asarray(x), train=True, mutable=jmut)
    got = tm(torch.from_numpy(x), train=True, mutable=tmut)
    f32_close(got, want)
    assert list(tmut) == list(jmut) == ["mods_1"]
    for k in ("moving_mean", "moving_var"):
        f32_close(tmut["mods_1"][k], jmut["mods_1"][k])
    merged = nn.apply_stat_updates(tree, tmut)
    trees_close(merged, jnn.apply_stat_updates(params, jmut))
    assert merged["mods_0"]["w"] is tree["mods_0"]["w"]
    assert not torch.equal(merged["mods_1"]["stats"]["moving_mean"],
                           tree["mods_1"]["stats"]["moving_mean"])
    # eval mode records nothing and reads the running stats
    f32_close(tm(torch.from_numpy(x)), jm(params, jnp.asarray(x)))
    # in place, each value cast to the stat's dtype
    nn.apply_stat_updates_(tree, tree_map(lambda v: v.to(torch.bfloat16),
                                          tmut))
    want_mean = tmut["mods_1"]["moving_mean"].to(torch.bfloat16).float()
    assert torch.equal(tree["mods_1"]["stats"]["moving_mean"], want_mean)
    assert tree["mods_1"]["stats"]["moving_mean"].dtype == torch.float32


def test_sequential_and_lambda_match_jax():
    jm = jnn.Sequential(jnn.Linear(5, 7), jnn.Lambda(jnp.tanh),
                        jnn.Sequential(jnn.Linear(7, 3), jnn.Lambda(
                            lambda h: h * 2.0)))
    tm = nn.Sequential(nn.Linear(5, 7), nn.Lambda(torch.tanh),
                       nn.Sequential(nn.Linear(7, 3), nn.Lambda(
                           lambda h: h * 2.0)))
    params, tm = _load(jm, tm)
    assert ({p for p, _ in tree_items(tm.tree())}
            == {p for p, _ in tree_items(port_tree(_np(params)))})
    assert nn.param_count(tm.tree()) == jnn.param_count(params) == 66
    x = np.random.RandomState(16).randn(4, 5).astype(np.float32)
    f32_close(tm(torch.from_numpy(x), train=True),
              jm(params, jnp.asarray(x), train=True))


# -- Momentum -----------------------------------------------------------------

def _stat_tree(rs):
    return {"w": rs.randn(3, 4).astype(np.float32),
            "b": rs.randn(4).astype(np.float32),
            "bn": {"gamma": rs.randn(4).astype(np.float32),
                   "stats": {"moving_mean": rs.randn(4).astype(np.float32)}}}


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("decay", [0.0, 0.01])
def test_momentum_matches_jax(nesterov, decay):
    """Three steps from the same params and grads: params and velocities
    equal (f32); the stats pass through untouched, with a velocity slot
    that stays 0, as in JAX."""
    rs = np.random.RandomState(17)
    params = _stat_tree(rs)
    jopt = JMomentum(0.1, momentum=0.9, use_nesterov=nesterov,
                     weight_decay=decay)
    topt = Momentum(0.1, momentum=0.9, use_nesterov=nesterov,
                    weight_decay=decay)
    jp, js = params, jopt.init(params)
    tp = tree_map(torch.from_numpy, params)
    ts = topt.init(tp)
    for i in range(3):
        grads = _stat_tree(np.random.RandomState(100 + i))
        jp, js = jopt.update(grads, js, jp)
        tp, ts = topt.update(tree_map(torch.from_numpy, grads), ts, tp)
    trees_close(tp, jp)
    trees_close(ts["slots"], js["slots"])
    assert torch.equal(tp["bn"]["stats"]["moving_mean"],
                       torch.from_numpy(params["bn"]["stats"]["moving_mean"]))
    assert not ts["slots"]["bn"]["stats"]["moving_mean"]["velocity"].any()
    assert int(ts["step"]) == int(js["step"]) == 3


# -- the trainer: stats, unused leaves, generators ------------------------------

class _BNNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(6, 8)
        self.bn = nn.BatchNorm(8)
        self.drop = nn.Dropout(0.5)
        self.out = nn.Linear(8, 3)

    def forward(self, x, train=False, mutable=None, generator=None):
        h = torch.relu(self.bn(self.fc(x), train=train, mutable=mutable))
        return self.out(self.drop(h, train=train, generator=generator))


def _bn_loss(model):
    def loss(params, x, y, gen=None):
        mut = {}
        logits = model.call(params, x, train=True, mutable=mut,
                            generator=gen)
        return -torch.log_softmax(logits, -1).gather(
            1, y.long()[:, None]).mean(), mut
    return loss


def test_trainer_merges_stats_and_zeroes_the_unused_leaves():
    """A loss that returns (loss, stat updates): the stats get zero
    gradients (their velocity stays 0), the optimizer skips them, and the
    recorded updates are merged in place after the update."""
    model = _BNNet().init(0, "cpu")
    rs = np.random.RandomState(18)
    x = torch.from_numpy(rs.randn(10, 6).astype(np.float32) * 2 + 1)
    y = torch.from_numpy(rs.randint(0, 3, 10))
    mut = {}
    model.call(model.tree(), x, train=True, mutable=mut)
    tr = Trainer(_bn_loss(model), Momentum(0.1, 0.9), device="cpu")
    p, s, loss = tr.step(model.tree(), tr.opt.init(model.tree()), x, y)
    assert torch.isfinite(loss)
    for k in ("moving_mean", "moving_var"):
        assert torch.equal(p["bn"]["stats"][k], mut["bn"][k])
        assert not s["slots"]["bn"]["stats"][k]["velocity"].any()
    assert s["slots"]["fc"]["w"]["velocity"].abs().sum() > 0
    assert torch.equal(model.tree()["bn"]["stats"]["moving_var"],
                       torch.ones(8))


@pytest.mark.parametrize("bad", ["triple", "list", "flat", "not_tensor"])
def test_trainer_refuses_a_tuple_that_is_not_loss_and_stat_updates(bad):
    """A loss's tuple must be (loss, {module path: {stat name: tensor}}):
    any other tuple raises TypeError, in the step and in the test pass."""
    model = _BNNet().init(0, "cpu")
    x, y = torch.ones(4, 6), torch.zeros(4, dtype=torch.long)
    stats = model.tree()["bn"]["stats"]
    second = {"triple": {"bn": stats}, "list": [stats], "flat": stats,
              "not_tensor": {"bn": {"moving_mean": 0.0}}}[bad]

    def loss(params, x, y):
        out = model.call(params, x).square().mean()
        return (out, second, None) if bad == "triple" else (out, second)
    tr = Trainer(loss, Momentum(0.1, 0.9), device="cpu")
    with pytest.raises(TypeError, match="stat updates"):
        tr.step(model.tree(), tr.opt.init(model.tree()), x, y)
    with pytest.raises(TypeError, match="stat updates"):
        tr.test(lambda: [(x, y)], model.tree())


def test_trainer_takes_a_generator_in_the_batch():
    """A generator in the batch reaches the loss (dropout draws from it):
    the same seed gives the same step, another seed another; the test pass
    takes one too."""
    model = _BNNet().init(0, "cpu")
    rs = np.random.RandomState(19)
    x = torch.from_numpy(rs.randn(10, 6).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 3, 10))
    outs = []
    for seed in (5, 5, 6):
        tr = Trainer(_bn_loss(model), Momentum(0.1, 0.9), device="cpu")
        gen = torch.Generator().manual_seed(seed)
        p, _, loss = tr.step(model.tree(), tr.opt.init(model.tree()), x, y,
                             gen)
        assert not torch.equal(gen.get_state(),
                               torch.Generator().manual_seed(seed)
                               .get_state())
        outs.append((loss.item(), p["out"]["w"].clone()))
        cost = tr.test(lambda: [(x, y, gen)], p)["cost"]
        assert np.isfinite(cost)
    assert outs[0][0] == outs[1][0] and torch.equal(outs[0][1], outs[1][1])
    assert outs[0][0] != outs[2][0]


def test_trainer_step_body_with_stats_and_a_generator_runs_on_meta():
    """The graphed step body of a BN model with dropout reads nothing back
    from the device (tests/test_torch_graphs.py's meta convention)."""
    model = _BNNet()
    tr = Trainer(_bn_loss(model), Momentum(0.1, 0.9), device=META)
    params = model.tree()
    state = tr.opt.init(params)
    batch, gens = (torch.zeros(4, 6, device=META),
                   torch.zeros(4, dtype=torch.int64, device=META), None), {
        "generator2": torch.Generator()}
    p, s, cost = tr._step_body(params, state, batch, **gens)
    assert p is params and s is state and cost.device == META
