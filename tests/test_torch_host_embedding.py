"""The port's host-offloaded embedding table
(paddle_tpu_torch/runtime/host_embedding.py, runtime/optimizer.py)
against ``paddle_tpu.runtime.host_embedding`` on the CPU, and against an
in-memory table, as tests/test_host_embedding.py pins the JAX one.

Both packages drive the same C library (the port builds its own copy of
native/optimizer.cc), so on the same ids and gradients, repeated ids
included, the tables are bit-equal. The device step is a toy objective
over the looked-up rows; its gradients differ between JAX and torch only
in the f32 rounding of tanh and a product, so the JAX comparison feeds
each side's table the same (numpy) gradient rows instead. The port's own
gradient of ``rows`` (``F.embedding``'s backward) is held against the
on-device dense path bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.runtime import HostEmbeddingTable as JTable
from paddle_tpu.runtime import native_available as jax_native
from paddle_tpu_torch.runtime import (HostEmbeddingTable, HostEmbedPrefetcher,
                                      HostOptimizer, native_available)

pytestmark = pytest.mark.skipif(
    not native_available() or not jax_native(),
    reason="the host runtime library does not build here")

VOCAB, DIM, B, T = 50, 8, 4, 6


def _init(seed=3):
    return (np.random.RandomState(seed).standard_normal((VOCAB, DIM))
            * 0.1).astype(np.float32)


def _w(seed=1):
    return torch.tensor(np.random.RandomState(seed).standard_normal(
        (DIM,)).astype(np.float32))


def _grad(rows, inverse, w):
    """The gradient of sum(tanh(lookup @ w)) w.r.t. rows."""
    rows = rows.detach().requires_grad_()
    e = HostEmbeddingTable.lookup(rows, inverse)
    (g,) = torch.autograd.grad(torch.tanh(e @ w).sum(), rows)
    return g


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_tables_equal_jax_on_the_same_gradients(optimizer):
    """The same ids (repeats included) and the same gradient rows through
    both packages' tables: bit-equal host masters and streamed rows."""
    rs = np.random.RandomState(5)
    port = HostEmbeddingTable(VOCAB, DIM, optimizer=optimizer, lr=0.1,
                              capacity=B * T, init=_init(), device="cpu")
    jt = JTable(VOCAB, DIM, optimizer=optimizer, lr=0.1, capacity=B * T,
                init=_init())
    for step in range(4):
        ids = rs.randint(0, 12 if step % 2 else VOCAB, (B, T))
        b, jb = port.prefetch(ids), jt.prefetch(ids)
        np.testing.assert_array_equal(b.rows.numpy(), np.asarray(jb.rows))
        np.testing.assert_array_equal(b.inverse.numpy(),
                                      np.asarray(jb.inverse))
        assert b.count == jb.count
        g = rs.standard_normal((B * T, DIM)).astype(np.float32)
        g[b.count:] = 0.0
        port.apply_grad(b, torch.tensor(g))
        jt.apply_grad(jb, jnp.asarray(g))
        np.testing.assert_array_equal(port.rows_host(np.arange(VOCAB)),
                                      jt.rows_host(np.arange(VOCAB)))
    assert port.serialize() == jt.serialize()


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_offloaded_matches_an_in_memory_table(optimizer):
    """Steps through the host table == the same steps over the whole table
    in memory (F.embedding over the table, the update as the C library
    computes it: lr a double, the step rounded to f32)."""
    lr, w = 0.1, _w()
    rs = np.random.RandomState(7)
    batches = [rs.randint(0, VOCAB, (B, T)) for _ in range(5)]
    table = HostEmbeddingTable(VOCAB, DIM, optimizer=optimizer, lr=lr,
                               capacity=B * T, init=_init(), device="cpu")
    for ids in batches:
        b = table.prefetch(ids)
        table.apply_grad(b, _grad(b.rows, b.inverse, w))
    dense = torch.tensor(_init())
    accum = torch.zeros_like(dense)
    for ids in batches:
        touched = torch.tensor(np.unique(ids)).long()
        g = _grad(dense, torch.tensor(ids).long(), w)[touched]
        if optimizer == "sgd":
            dense[touched] -= (lr * g.double()).float()
        else:
            accum[touched] += g * g
            dense[touched] -= (lr * g.double() / (
                accum[touched].double().sqrt() + 1e-6)).float()
    np.testing.assert_array_equal(table.rows_host(np.arange(VOCAB)),
                                  dense.numpy())


def test_prefetcher_is_bit_equal_to_the_serial_path():
    """Batches sharing many ids: the prefetch of batch i+1 runs before
    batch i's update, and the patch of the rows it touched makes every
    step read the post-update table (as tests/test_host_embedding.py)."""
    lr, w = 0.2, _w()
    rs = np.random.RandomState(9)
    batches = [rs.randint(0, 12, (B, T)) for _ in range(6)]
    serial = HostEmbeddingTable(VOCAB, DIM, lr=lr, capacity=B * T,
                                init=_init(), device="cpu")
    seen = []
    for ids in batches:
        b = serial.prefetch(ids)
        seen.append(b.rows[:b.count].clone())
        serial.apply_grad(b, _grad(b.rows, b.inverse, w))
    over = HostEmbeddingTable(VOCAB, DIM, lr=lr, capacity=B * T,
                              init=_init(), device="cpu")
    pf = HostEmbedPrefetcher(over, iter(batches))
    steps = 0
    while (b := pf.next()) is not None:
        # the real rows (the padding reads row 0 as the gather found it)
        assert torch.equal(b.rows[:b.count], seen[steps])
        pf.commit(b, _grad(b.rows, b.inverse, w))
        steps += 1
    assert steps == len(batches)
    np.testing.assert_array_equal(over.rows_host(np.arange(VOCAB)),
                                  serial.rows_host(np.arange(VOCAB)))


def test_bf16_rows_and_the_untouched_rows():
    init = np.ones((VOCAB, DIM), np.float32) * 1.001
    table = HostEmbeddingTable(VOCAB, DIM, optimizer="adagrad", lr=0.5,
                               capacity=8, init=init.copy(),
                               compute_dtype=torch.bfloat16, device="cpu")
    ids = np.array([[1, 2, 3, 1]])
    b = table.prefetch(ids)
    assert b.rows.dtype == torch.bfloat16
    assert torch.equal(b.rows[:3], torch.tensor(init[:3]).bfloat16())
    table.apply_grad(b, _grad(b.rows.float(), b.inverse, _w()))
    untouched = np.setdiff1d(np.arange(VOCAB), [1, 2, 3])
    np.testing.assert_array_equal(table.rows_host(untouched),
                                  init[untouched])
    with pytest.raises(ValueError, match="capacity"):
        table.prefetch(np.arange(10))


def test_host_optimizer_round_trips_and_refuses_bad_rows():
    opt = HostOptimizer("adagrad", _init(), lr=0.3)
    opt.update_rows(np.array([4, 4, 9]), np.ones((3, DIM), np.float32))
    blob = opt.serialize()
    other = HostOptimizer("adagrad", (VOCAB, DIM), lr=0.3)
    other.deserialize(blob)
    np.testing.assert_array_equal(other.param, opt.param)
    with pytest.raises(IndexError):
        opt.get_rows(np.array([VOCAB]), DIM)
    with pytest.raises(RuntimeError, match="row updates"):
        HostOptimizer("adam", _init()).update_rows(
            np.array([0]), np.ones((1, DIM), np.float32))


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        HostEmbeddingTable(VOCAB, DIM)
