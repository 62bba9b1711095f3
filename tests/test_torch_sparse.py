"""The port's sparse ops (paddle_tpu_torch/ops/sparse.py) against
``paddle_tpu.ops.sparse``, on the CPU, on the same ids and gradients made
with numpy, repeated ids included.

The SelectedRows path is held bit-equal: JAX's scatter-add sums a
repeated row's values in their order from the row's value, and the port
keeps that order (its stated rule), so the same f32 additions run. The
sparse-matrix products differ from BCOO's only in summation order
(atol/rtol 1e-5); constructors and ``to_dense`` of distinct entries are
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import sparse as JS
from paddle_tpu_torch.ops import sparse as S

TOL = 1e-5


def _ids_grads(seed, vocab=40, shape=(6, 9), dim=8, hot=None):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, shape).astype(np.int32)
    if hot is not None:
        ids.reshape(-1)[::3] = hot          # one row repeated many times
    g = (rs.randn(*shape, dim) * 10.0 ** rs.randint(-3, 3, shape + (1,))
         ).astype(np.float32)
    return ids, g


def _pair(ids, g, vocab):
    return (S.embedding_grad_rows(torch.tensor(ids), torch.tensor(g), vocab),
            JS.embedding_grad_rows(jnp.asarray(ids), jnp.asarray(g), vocab))


@pytest.mark.parametrize("seed,hot", [(0, None), (1, 7), (2, 0)])
def test_selected_rows_to_dense_is_bit_equal(seed, hot):
    ids, g = _ids_grads(seed, hot=hot)
    sr, jsr = _pair(ids, g, 40)
    assert sr.rows.shape == (54,) and sr.values.shape == (54, 8)
    np.testing.assert_array_equal(sr.to_dense().numpy(),
                                  np.asarray(jsr.to_dense()))


@pytest.mark.parametrize("seed,hot", [(3, None), (4, 5)])
def test_sgd_sparse_update_is_bit_equal(seed, hot):
    ids, g = _ids_grads(seed, hot=hot)
    table = np.random.RandomState(seed + 10).randn(40, 8).astype(np.float32)
    sr, jsr = _pair(ids, g, 40)
    got = S.sgd_sparse_update(torch.tensor(table), sr, 0.3)
    want = JS.sgd_sparse_update(jnp.asarray(table), jsr, 0.3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,hot", [(5, None), (6, 11)])
def test_adagrad_sparse_update_is_bit_equal(seed, hot):
    ids, g = _ids_grads(seed, hot=hot)
    rs = np.random.RandomState(seed + 20)
    table = rs.randn(40, 8).astype(np.float32)
    moment = np.abs(rs.randn(40, 8)).astype(np.float32)
    sr, jsr = _pair(ids, g, 40)
    t, m = S.adagrad_sparse_update(torch.tensor(table), torch.tensor(moment),
                                   sr, 0.2)
    jt, jm = JS.adagrad_sparse_update(jnp.asarray(table),
                                      jnp.asarray(moment), jsr, 0.2)
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    untouched = np.setdiff1d(np.arange(40), ids)
    np.testing.assert_array_equal(t.numpy()[untouched], table[untouched])


def test_repeated_rows_add_in_their_order():
    """The stated rule: a row's values add one at a time in their order,
    from the row's value (f32): eight 1s then 1e8 and -1e8 leave 8, 1e8
    first swallows every 1."""
    def sequential(vals):
        acc = np.float32(0.0)
        for v in vals:
            acc = np.float32(acc + np.float32(v))
        return acc

    for vals in ([1.0] * 8 + [1e8, -1e8], [1e8] + [1.0] * 8 + [-1e8]):
        got = S.scatter_add_ordered(torch.zeros(2, 1),
                                    torch.zeros(len(vals), dtype=torch.long),
                                    torch.tensor(vals)[:, None])
        assert got[0, 0].item() == sequential(vals)
        assert got[1, 0].item() == 0.0
    assert sequential([1.0] * 8 + [1e8, -1e8]) == 8.0
    assert sequential([1e8] + [1.0] * 8 + [-1e8]) == 0.0


@pytest.mark.parametrize("padding_idx", [None, 3])
def test_lookup_table_matches_jax(padding_idx):
    rs = np.random.RandomState(7)
    table = rs.randn(10, 4).astype(np.float32)
    ids = rs.randint(0, 10, (3, 5)).astype(np.int32)
    ids[0, :2] = 3
    np.testing.assert_array_equal(
        S.lookup_table(torch.tensor(table), torch.tensor(ids),
                       padding_idx).numpy(),
        np.asarray(JS.lookup_table(jnp.asarray(table), jnp.asarray(ids),
                                   padding_idx)))


def _csr():
    values = np.array([1.5, -2.0, 3.0, 0.5, 4.0], np.float32)
    cols = np.array([0, 3, 1, 1, 2])
    row_ptr = np.array([0, 2, 2, 4, 5])     # an empty row; a repeat at (2, 1)
    return values, cols, row_ptr, (4, 5)


def test_constructors_and_to_dense_match_jax():
    values, cols, row_ptr, shape = _csr()
    np.testing.assert_array_equal(
        S.sparse_to_dense(S.csr_matrix(values, cols, row_ptr, shape)).numpy(),
        np.asarray(JS.sparse_to_dense(JS.csr_matrix(values, cols, row_ptr,
                                                    shape))))
    col_ptr = np.array([0, 1, 3, 4, 5, 5])
    rows = np.array([0, 2, 2, 3, 0])
    np.testing.assert_array_equal(
        S.sparse_to_dense(S.csc_matrix(values, rows, col_ptr, (4, 5))).numpy(),
        np.asarray(JS.sparse_to_dense(JS.csc_matrix(values, rows, col_ptr,
                                                    (4, 5)))))
    r, c = np.array([0, 1, 1, 3, 3]), np.array([4, 0, 0, 2, 1])
    np.testing.assert_array_equal(
        S.sparse_to_dense(S.coo_matrix(values, r, c, (4, 5))).numpy(),
        np.asarray(JS.sparse_to_dense(JS.coo_matrix(values, r, c, (4, 5)))))


def test_products_and_their_gradients_match_jax():
    import jax
    values, cols, row_ptr, shape = _csr()
    rs = np.random.RandomState(8)
    rhs = rs.randn(5, 3).astype(np.float32)
    lhs = rs.randn(2, 4).astype(np.float32)
    sp = S.csr_matrix(torch.tensor(values), cols, row_ptr, shape)
    jsp = JS.csr_matrix(values, cols, row_ptr, shape)
    d = torch.tensor(rhs, requires_grad=True)
    out = S.sparse_dense_matmul(sp, d)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(JS.sparse_dense_matmul(
                                   jsp, jnp.asarray(rhs))), atol=TOL,
                               rtol=TOL)
    gy = rs.randn(4, 3).astype(np.float32)
    (gd,) = torch.autograd.grad(out, d, torch.tensor(gy))
    jg = jax.vjp(lambda r: JS.sparse_dense_matmul(jsp, r),
                 jnp.asarray(rhs))[1](jnp.asarray(gy))[0]
    np.testing.assert_allclose(gd.numpy(), np.asarray(jg), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(
        S.dense_sparse_matmul(torch.tensor(lhs), sp).numpy(),
        np.asarray(JS.dense_sparse_matmul(jnp.asarray(lhs), jsp)),
        atol=TOL, rtol=TOL)


@pytest.mark.parametrize("nse", [None, 9])
def test_dense_to_bcoo_round_trips(nse):
    x = np.zeros((4, 6), np.float32)
    x[0, 2], x[3, 0], x[1, 5], x[3, 5] = 1.0, -2.0, 3.5, 0.25
    sp = S.dense_to_bcoo(torch.tensor(x), nse=nse)
    jsp = JS.dense_to_bcoo(jnp.asarray(x), nse=nse)
    np.testing.assert_array_equal(S.sparse_to_dense(sp).numpy(), x)
    np.testing.assert_array_equal(np.asarray(JS.sparse_to_dense(jsp)), x)
    # the nonzeros in row-major order, as BCOO.fromdense lists them
    np.testing.assert_array_equal(sp._values()[:4].numpy(),
                                  np.asarray(jsp.data)[:4])
    assert sp._nnz() == (4 if nse is None else nse)
