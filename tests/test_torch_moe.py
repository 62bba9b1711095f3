"""Expert parallelism of the port (``parallel/moe.py``) against the JAX
package's: the dense top-k reference, the expert-sharded all-to-all
pipeline over ``expert=4`` (k = 1 and 2; JAX's test shapes), capacity
drops, the load-balance loss, gradients through the sharded path and a
training loop. JAX's weights and tokens cross over as numpy; the port's
sharded runs are on a world of 4 gloo CPU ranks (``torch_spmd``), JAX's
on 4 of its 8 virtual CPU devices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel.moe import ExpertParallelMoE as JMoE
from paddle_tpu.parallel.moe import init_moe_params as jinit
from paddle_tpu.parallel.moe import moe_ffn_dense as jdense

from paddle_tpu_torch.convert import tree_from_numpy
from paddle_tpu_torch.parallel.moe import (_route, init_moe_params,
                                           moe_ffn_dense)

import torch_spmd

D, F, E = 8, 16, 8
N = 4
T = 64
# f32 einsums over 8-16 wide contractions: JAX's own sharded-vs-dense bound
MOE_TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(T=T, seed=0):
    params = jax.tree_util.tree_map(np.asarray,
                                    jinit(jax.random.PRNGKey(seed), D, F, E))
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(seed + 1), (T, D)))
    return params, x


PARAMS, X = _setup()
Y_TARGET = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (T, D)))


def _torch(params):
    return tree_from_numpy(params, device="cpu")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return torch_spmd.run_world(
        tmp_path_factory.mktemp("moe"),
        [("moe", "torch_spmd:moe_cases",
          dict(params=PARAMS, x=X, y_target=Y_TARGET))])


@pytest.mark.parametrize("k", [1, 2])
def test_dense_matches_jax(k):
    """moe_ffn_dense (the routing, dispatch and combine) equals JAX's, at
    full capacity and at a capacity that drops tokens (MOE_TOL)."""
    for cap in (None, 3):
        y, aux = moe_ffn_dense(_torch(PARAMS), torch.as_tensor(X), k=k,
                               capacity=cap)
        yj, auxj = jdense(jax.tree_util.tree_map(jnp.asarray, PARAMS),
                          jnp.asarray(X), k=k, capacity=cap)
        np.testing.assert_allclose(y.numpy(), np.asarray(yj), **MOE_TOL)
        np.testing.assert_allclose(float(aux), float(auxj), rtol=1e-6)


def test_route_dispatch_equals_jax():
    """The GShard dispatch and combine tensors are JAX's exactly (slots
    from the cumsum, greedy per choice, drops)."""
    from paddle_tpu.parallel.moe import _route as jroute
    for k, cap in ((1, 4), (2, 4), (2, 16)):
        d, c, _ = _route(torch.as_tensor(X[:16]),
                         torch.as_tensor(PARAMS["gate_w"]), E, k, cap)
        dj, cj, _ = jroute(jnp.asarray(X[:16]), jnp.asarray(PARAMS["gate_w"]),
                           E, k, cap)
        np.testing.assert_array_equal(d.numpy(), np.asarray(dj))
        np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_matches_dense_and_jax(world, k):
    """With capacity >= the local tokens nothing drops: the expert-sharded
    all_to_all pipeline over expert=4 equals the dense math routed per
    shard and JAX's ExpertParallelMoE on 4 devices (MOE_TOL)."""
    T_local = T // N
    mesh = jmake_mesh(devices=jax.devices()[:N], expert=N)
    moe = JMoE(mesh, k=k, capacity=T_local)
    jp = jax.tree_util.tree_map(jnp.asarray, PARAMS)
    want, want_aux = moe(moe.shard_params(jp), moe.shard_tokens(jnp.asarray(X)))
    got, aux = torch_spmd.result(world, "moe")[f"k{k}"]
    np.testing.assert_allclose(got, np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(aux, float(want_aux), rtol=1e-5)
    dense = np.concatenate([np.asarray(moe_ffn_dense(
        _torch(PARAMS), torch.as_tensor(X[s * T_local:(s + 1) * T_local]),
        k=k, capacity=T_local)[0]) for s in range(N)])
    np.testing.assert_allclose(got, dense, **MOE_TOL)


def test_capacity_drops_tokens(world):
    """One slot an expert a shard: some tokens drop (a zero row), not all."""
    ys = torch_spmd.result(world, "moe")["drops"]
    dropped = (np.abs(ys).max(axis=-1) < 1e-9).sum()
    assert 0 < dropped < T


def test_aux_loss_balanced_vs_skewed():
    """The load-balance loss is ~1 for random routing and ~E when one
    expert takes every token, as JAX's."""
    p = _torch(PARAMS)
    skew = dict(p)
    skew["gate_w"] = torch.zeros(D, E)
    skew["gate_w"][:, 0] = 5.0
    x = torch.as_tensor(_setup(T=256)[1])
    _, aux_skew = moe_ffn_dense(skew, x, k=1)
    _, aux_rand = moe_ffn_dense(p, x, k=1)
    assert float(aux_skew) > 2.0
    assert 0.5 < float(aux_rand) < 3.0


def test_gradients_flow_through_sharded_path(world):
    """d(loss)/d(params) through the all-to-all pipeline equals the dense
    reference's (JAX's bound: rtol 3e-4, atol 3e-5)."""
    gs, gd = torch_spmd.result(world, "moe")["grads"]
    for name, a, b in zip(("gate_w", "w1", "w2"), gs, gd):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-5, err_msg=name)


def test_train_step_reduces_loss(world):
    """30 Adam steps over the expert mesh fit random targets."""
    losses = torch_spmd.result(world, "moe")["losses"]
    assert losses[-1] < losses[0] * 0.9, (losses[0], losses[-1])


def test_k_exceeding_experts_rejected():
    with pytest.raises(ValueError, match="k <= n_experts"):
        moe_ffn_dense(_torch(PARAMS), torch.as_tensor(X[:8]), k=E + 1)


def test_init_moe_params_shapes_and_scales():
    """The port's initializer draws JAX's shapes and scales from a seed."""
    p = init_moe_params(0, D, F, E, device="cpu")
    j = jinit(jax.random.PRNGKey(0), D, F, E)
    for name in ("gate_w", "w1", "w2"):
        assert tuple(p[name].shape) == tuple(j[name].shape)
    assert abs(float(p["w1"].std()) - 1 / np.sqrt(D)) < 0.05
    assert abs(float(p["w2"].std()) - 1 / np.sqrt(F)) < 0.05
    torch.testing.assert_close(init_moe_params(0, D, F, E, device="cpu")["w1"],
                               p["w1"], rtol=0, atol=0)


def test_ranks_import_no_jax(world):
    assert not any(torch_spmd.result(world, "_imports_jax", r)
                   for r in range(N))
