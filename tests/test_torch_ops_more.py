"""The ops ROADMAP A.4 left (paddle_tpu_torch/ops/{rnn,norm,pool,conv}.py)
against the JAX package's, on the CPU, on the same inputs made with
numpy: ``lstm_peephole_step``, ``group_norm``, ``batch_norm``'s
``axis_mask``, ``max_pool2d_with_index``, ``max_pool3d``, ``avg_pool3d``,
``spatial_pyramid_pool``, ``roi_pool``, ``conv3d``, ``row_conv``,
``im2col``, ``bilinear_interp`` and ``maxout``.

Tolerances (f32 on both sides): 1e-5 absolute and relative for sums
(the ops' reductions and products run in another order than XLA's);
maxima, indices, copies and the tie rules exactly; gradients 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import conv as JC
from paddle_tpu.ops import norm as JN
from paddle_tpu.ops import pool as JP
from paddle_tpu.ops import rnn as JR
from paddle_tpu_torch.ops import conv as C
from paddle_tpu_torch.ops import norm as N
from paddle_tpu_torch.ops import pool as P
from paddle_tpu_torch.ops import rnn as R

TOL = 1e-5


def _rs(seed=0):
    return np.random.RandomState(seed)


def _arr(rs, *shape, scale=1.0):
    return (rs.randn(*shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("bias,fb", [(True, 1.0), (False, 0.0)])
def test_lstm_peephole_step_matches_jax(bias, fb):
    rs = _rs(1)
    B, H = 3, 5
    xw, c, wp = _arr(rs, B, 4 * H), _arr(rs, B, H), _arr(rs, 3, H)
    b = _arr(rs, 4 * H) if bias else None
    h, c2 = R.lstm_peephole_step(
        torch.tensor(xw), torch.tensor(c), torch.tensor(wp),
        None if b is None else torch.tensor(b), forget_bias=fb)
    jh, jc = JR.lstm_peephole_step(jnp.asarray(xw), jnp.asarray(c),
                                   jnp.asarray(wp),
                                   None if b is None else jnp.asarray(b),
                                   forget_bias=fb)
    _close(h, jh)
    _close(c2, jc)


@pytest.mark.parametrize("shape,groups", [((2, 5, 4, 8), 4), ((3, 6, 6), 2),
                                          ((2, 3, 3, 32), 32)])
def test_group_norm_matches_jax(shape, groups):
    rs = _rs(2)
    x = _arr(rs, *shape, scale=2.0) + 0.5
    g, b = _arr(rs, shape[-1]), _arr(rs, shape[-1])
    got = N.group_norm(torch.tensor(x), torch.tensor(g), torch.tensor(b),
                       groups)
    _close(got, JN.group_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                              groups))


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape,mask", [((4, 5, 3), (0,)),
                                        ((2, 3, 4, 6), (0, 1)),
                                        ((2, 3, 4, 6), (0, 1, 2)),
                                        ((2, 3, 4, 6), (-4, -3))])
def test_batch_norm_axis_mask_matches_jax(shape, mask, train):
    rs = _rs(3)
    x = _arr(rs, *shape) + 1.0
    stat = tuple(n for a, n in enumerate(shape)
                 if a not in {m % len(shape) for m in mask})
    g, b = _arr(rs, *stat), _arr(rs, *stat)
    rm, rv = _arr(rs, *stat, scale=0.1), np.abs(_arr(rs, *stat)) + 0.5
    xt = torch.tensor(x, requires_grad=True)
    got = N.batch_norm(xt, torch.tensor(g), torch.tensor(b),
                       torch.tensor(rm), torch.tensor(rv), train=train,
                       axis_mask=mask)
    jf = lambda x: JN.batch_norm(x, jnp.asarray(g), jnp.asarray(b),
                                 jnp.asarray(rm), jnp.asarray(rv),
                                 train=train, axis_mask=mask)
    want = jf(jnp.asarray(x))
    for o, w in zip(got, want):
        _close(o, w)
    gy = _arr(rs, *shape)
    (dx,) = torch.autograd.grad(got[0], xt, torch.tensor(gy))
    jdx = jax.vjp(lambda x: jf(x)[0], jnp.asarray(x))[1](jnp.asarray(gy))[0]
    _close(dx, jdx, 2e-5)


@pytest.mark.parametrize("kernel,stride,padding", [(2, None, 0), (3, 2, 1),
                                                   ((3, 2), (1, 2), 0),
                                                   (2, 1, 2)])
def test_max_pool2d_with_index_matches_jax(kernel, stride, padding):
    rs = _rs(4)
    x = _arr(rs, 2, 7, 6, 3)
    v, i = P.max_pool2d_with_index(torch.tensor(x), kernel, stride, padding)
    jv, ji = JP.max_pool2d_with_index(jnp.asarray(x), kernel, stride,
                                      padding)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i.dtype == torch.int32


def test_max_pool2d_with_index_takes_the_first_of_tied_maxima():
    """The port's rule: the first maximum in row-major window order (the
    smallest flat index), which JAX's strict ``>`` reducer gives on the
    CPU."""
    x = np.zeros((1, 4, 4, 2), np.float32)
    x[0, 1, 1, 0] = x[0, 0, 1, 0] = x[0, 1, 0, 0] = 5.0   # 3 ties, window 0
    x[0, 2:, 2:, 1] = 1.0                                 # all tied
    v, i = P.max_pool2d_with_index(torch.tensor(x), 2)
    jv, ji = JP.max_pool2d_with_index(jnp.asarray(x), 2)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert i[0, 0, 0, 0] == 1                  # (0, 1): the first of three
    assert i[0, 1, 1, 1] == 2 * 4 + 2          # the window's first cell
    assert i[0, 0, 0, 1] == 0                  # zeros tie: first cell


@pytest.mark.parametrize("kernel,stride,padding", [(2, None, 0),
                                                   ((2, 3, 2), 1, (1, 0, 1)),
                                                   (3, 2, 1)])
def test_pool3d_matches_jax(kernel, stride, padding):
    rs = _rs(5)
    x = _arr(rs, 2, 5, 6, 7, 3)
    xt, xj = torch.tensor(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        P.max_pool3d(xt, kernel, stride, padding).numpy(),
        np.asarray(JP.max_pool3d(xj, kernel, stride, padding)))
    _close(P.avg_pool3d(xt, kernel, stride, padding),
           JP.avg_pool3d(xj, kernel, stride, padding))


@pytest.mark.parametrize("pool_type", ["max", "avg"])
def test_spatial_pyramid_pool_matches_jax(pool_type):
    rs = _rs(6)
    x = _arr(rs, 2, 7, 5, 3)
    got = P.spatial_pyramid_pool(torch.tensor(x), 3, pool_type)
    assert got.shape == (2, 3 * (1 + 4 + 16))
    _close(got, JP.spatial_pyramid_pool(jnp.asarray(x), 3, pool_type))


def test_roi_pool_matches_jax_and_splits_tied_gradients_evenly(monkeypatch):
    rs = _rs(7)
    H, W, Cc = 9, 11, 4
    monkeypatch.setattr(P, "_ROI_CHUNK_ELEMS", 2 * H * W * Cc)  # 3 chunks
    feat = _arr(rs, H, W, Cc)
    feat[2:4, 2:4, 0] = 7.0                  # a tie inside one bin
    rois = np.array([[0, 0, 10, 8], [2, 2, 5, 5], [3, 1, 3, 1],
                     [8, 6, 12, 14], [1.5, 2.5, 7.2, 6.9]], np.float32)
    ft = torch.tensor(feat, requires_grad=True)
    got = P.roi_pool(ft, torch.tensor(rois), (3, 2), spatial_scale=0.9)
    jf = lambda f: JP.roi_pool(f, jnp.asarray(rois), (3, 2),
                               spatial_scale=0.9)
    want = jf(jnp.asarray(feat))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    finite = np.isfinite(np.asarray(want))
    gy = np.where(finite, _arr(rs, *want.shape), 0.0).astype(np.float32)
    (dg,) = torch.autograd.grad(got, ft, torch.tensor(gy))
    jg = jax.vjp(jf, jnp.asarray(feat))[1](jnp.asarray(gy))[0]
    _close(dg, jg, 2e-5)


@pytest.mark.parametrize("stride,padding,dilation,groups", [
    (1, 0, 1, 1), (2, 1, 1, 1), ((1, 2, 1), "SAME", 1, 2),
    (1, "VALID", (1, 2, 1), 1), (2, "SAME", 1, 1)])
def test_conv3d_matches_jax(stride, padding, dilation, groups):
    rs = _rs(8)
    x = _arr(rs, 2, 5, 6, 7, 4)
    w = _arr(rs, 3, 2, 3, 4 // groups, 6, scale=0.3)
    got = C.conv3d(torch.tensor(x), torch.tensor(w), stride=stride,
                   padding=padding, dilation=dilation, groups=groups)
    want = JC.conv3d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                     padding=padding, dilation=dilation, groups=groups)
    assert got.shape == want.shape
    _close(got, want)


def test_row_conv_im2col_bilinear_and_maxout_match_jax():
    rs = _rs(9)
    x, w = _arr(rs, 2, 7, 5), _arr(rs, 3, 5)
    np.testing.assert_array_equal(
        C.row_conv(torch.tensor(x), torch.tensor(w)).numpy(),
        np.asarray(JC.row_conv(jnp.asarray(x), jnp.asarray(w))))
    img = _arr(rs, 2, 6, 5, 3)
    for kernel, stride, padding in [(3, 1, 0), ((2, 3), (2, 1), 1)]:
        np.testing.assert_array_equal(
            C.im2col(torch.tensor(img), kernel, stride, padding).numpy(),
            np.asarray(JC.im2col(jnp.asarray(img), kernel, stride,
                                 padding)))
    for oh, ow in [(11, 9), (6, 5), (3, 1), (1, 4)]:
        _close(C.bilinear_interp(torch.tensor(img), oh, ow),
               JC.bilinear_interp(jnp.asarray(img), oh, ow))
    m = _arr(rs, 2, 3, 4, 6)
    np.testing.assert_array_equal(
        C.maxout(torch.tensor(m), 3).numpy(),
        np.asarray(JC.maxout(jnp.asarray(m), 3)))
