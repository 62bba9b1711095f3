"""Sequence parallelism of the port (``parallel/ring_attention.py``)
against the JAX package's on a ``seq`` mesh of 4: ring attention in the
zigzag, contiguous and non-causal layouts and Ulysses, forward and
gradients; the zigzag fallback; blockwise attention and the zigzag
order; and the seq-sharded ``TransformerLM`` forward and
``shifted_loss`` with its gradients.

The port runs on a world of 4 gloo ranks on the CPU (``torch_spmd``),
each ring step through the flash kernels' plain versions (the tensors
lie on the CPU); JAX on 4 of its 8 virtual CPU devices with its Pallas
kernels in interpret mode, as ``tests/test_parallel.py`` runs them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from paddle_tpu import parallel as jpp
from paddle_tpu.models import TransformerLM as JLM

import torch_spmd

N = 4
# f32 attention: the ring merges n partial softmaxes where JAX's merges
# in the same order; both sides' plain/interpret bodies round differently
# inside a block, so hold to JAX's own ring-vs-dense bound
ATT_TOL = dict(rtol=2e-4, atol=2e-4)
V, D, H, L = 50, 32, 4, 2


def _jmesh(**axes):
    return jpp.make_mesh(devices=jax.devices()[:N], **axes)


def _normal(seed, shape):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))


QKV = [_normal(s, (2, 32, 2, 8)) for s in (11, 12, 13, 14)]
QKV36 = [_normal(s, (1, 36, 2, 8)) for s in (21, 22, 23)]
QKVU = [_normal(s, (2, 32, 4, 8)) for s in (31, 32, 33, 34)]
LM_PARAMS = jax.tree_util.tree_map(
    np.asarray, JLM(V, d_model=D, n_heads=H, n_layers=L, max_len=33).init(
        jax.random.PRNGKey(0)))
IDS = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (2, 32), 0, V))
IDS33 = np.asarray(jax.random.randint(jax.random.PRNGKey(8), (2, 33), 0, V))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    q, k, v, g = QKV
    qu, ku, vu, gu = QKVU
    cases = [
        ("ring", "torch_spmd:ring_cases",
         dict(q=q, k=k, v=v, g=g, q36=QKV36[0], k36=QKV36[1], v36=QKV36[2],
              qu=qu, ku=ku, vu=vu, gu=gu)),
        ("lm", "torch_spmd:lm_seq_cases",
         dict(params=LM_PARAMS, ids=IDS, ids33=IDS33, vocab=V, d=D,
              heads=H, layers=L)),
    ]
    return torch_spmd.run_world(tmp_path_factory.mktemp("ring"), cases)


@functools.lru_cache(maxsize=None)
def _jax_ring_of(causal, layout, which):
    """JAX's ring on the inputs ``which`` (QKV or QKVU), computed once."""
    return _jax_ring(causal, layout, *{"qkv": QKV, "u": QKVU}[which])


def _jax_ring(causal, layout, q, k, v, g):
    mesh = _jmesh(seq=N)

    def f(q, k, v):
        o = jpp.ring_self_attention(mesh, q, k, v, causal=causal,
                                    layout=layout)
        return jnp.sum(o * g), o

    (_, o), grads = jax.value_and_grad(f, (0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    return np.asarray(o), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("name,causal,layout", [
    ("full", False, None), ("zigzag", True, None),
    ("contiguous", True, "contiguous")])
def test_ring_self_attention_forward_and_grads_match_jax(world, name, causal,
                                                         layout):
    """ring_self_attention over seq=4 (non-causal; causal zigzag; causal
    contiguous): output and dq, dk, dv equal JAX's ring (ATT_TOL)."""
    want_o, want_g = _jax_ring_of(causal, layout, "qkv")
    got_o, got_g = torch_spmd.result(world, "ring")[name]
    np.testing.assert_allclose(got_o, want_o, **ATT_TOL)
    for n, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, err_msg=f"d{n}", **ATT_TOL)
    for r in range(1, N):      # every rank holds the same global result
        o_r, g_r = torch_spmd.result(world, "ring", r)[name]
        np.testing.assert_array_equal(o_r, got_o)
        for a, b in zip(g_r, got_g):
            np.testing.assert_array_equal(a, b)


def test_zigzag_fallback_warns_and_stays_exact(world):
    """T = 36 does not split into 2 x 4 zigzag chunks: the contiguous
    causal layout, loudly, and still JAX's result (ATT_TOL)."""
    mesh = _jmesh(seq=N)
    q, k, v = map(jnp.asarray, QKV36)
    with pytest.warns(UserWarning, match="CONTIGUOUS causal layout"):
        want = jpp.ring_self_attention(mesh, q, k, v, causal=True)
    got, warned = torch_spmd.result(world, "ring")["fallback"]
    assert any("CONTIGUOUS causal layout" in w for w in warned)
    np.testing.assert_allclose(got, np.asarray(want), **ATT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_attention_forward_and_grads_match_jax(world, causal):
    """Ulysses (all-to-all to heads, flash, all-to-all back) over seq=4
    with 4 heads equals JAX's, and its gradients JAX's ring's (the same
    function; ATT_TOL)."""
    q, k, v, g = QKVU
    mesh = _jmesh(seq=N)
    want = jpp.ulysses_attention(mesh, *map(jnp.asarray, (q, k, v)),
                                 causal=causal)
    got_o, got_g = torch_spmd.result(world, "ring")[
        "ulysses_causal" if causal else "ulysses"]
    np.testing.assert_allclose(got_o, np.asarray(want), **ATT_TOL)
    _, want_g = _jax_ring_of(causal, "contiguous", "u")
    for n, a, b in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(a, b, err_msg=f"d{n}", **ATT_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_jax(causal):
    """blockwise_attention (plain PyTorch, 16-key blocks) equals JAX's
    (ATT_TOL)."""
    import torch

    from paddle_tpu_torch.parallel import blockwise_attention
    q, k, v = (_normal(s, (2, 48, 2, 8)) for s in (41, 42, 43))
    want = jpp.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                   block_size=16, causal=causal)
    got = blockwise_attention(*map(torch.as_tensor, (q, k, v)),
                              block_size=16, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATT_TOL)


def test_zigzag_order_and_work_balance():
    """The zigzag order, its inverse and the step work model are JAX's."""
    import importlib
    # the packages export the function ring_attention under the module's
    # name, so the modules are taken by their full names
    jra = importlib.import_module("paddle_tpu.parallel.ring_attention")
    ra = importlib.import_module("paddle_tpu_torch.parallel.ring_attention")
    for T, n in ((128, 8), (32, 4), (8, 2)):
        np.testing.assert_array_equal(ra.zigzag_order(T, n).numpy(),
                                      np.asarray(jra.zigzag_order(T, n)))
        np.testing.assert_array_equal(ra.zigzag_inverse(T, n).numpy(),
                                      np.asarray(jra.zigzag_inverse(T, n)))
        c = T // (2 * n)
        assert ra._zigzag_step_pairs(c) == jra._zigzag_step_pairs(c)
    with pytest.raises(ValueError):
        ra.zigzag_order(36, 4)


def _jax_lm():
    return JLM(V, d_model=D, n_heads=H, n_layers=L, max_len=33), \
        jax.tree_util.tree_map(jnp.asarray, LM_PARAMS)


@functools.lru_cache(maxsize=None)
def _jax_lm_forward():
    """JAX's unsharded and seq-sharded forward of IDS, computed once."""
    model, params = _jax_lm()
    ids = jnp.asarray(IDS)
    positions = jnp.broadcast_to(jnp.arange(32), ids.shape)
    want = np.asarray(model(params, ids))
    sharded = jpp.shard_map(
        lambda p, i, pos: model(p, i, positions=pos, seq_axis="seq"),
        mesh=_jmesh(seq=N), in_specs=(JP(), JP(None, "seq"),
                                      JP(None, "seq")),
        out_specs=JP(None, "seq"), check_vma=False)
    return want, np.asarray(sharded(params, ids, positions))


@pytest.mark.parametrize("remat", [False, True])
def test_seq_sharded_lm_forward_matches_jax(world, remat):
    """TransformerLM(ids, positions=, seq_axis="seq") inside shard_map over
    seq=4 equals JAX's seq-sharded forward and its unsharded one (3e-4,
    JAX's bound), with and without remat."""
    want, want_sharded = _jax_lm_forward()
    got = torch_spmd.result(world, "lm")[("remat_" if remat else "")
                                         + "forward"]
    np.testing.assert_allclose(got, want_sharded, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)


@functools.lru_cache(maxsize=None)
def _jax_lm_loss():
    """JAX's unsharded masked loss and gradients and its seq-sharded
    loss on IDS33, computed once."""
    model, params = _jax_lm()
    ids = jnp.asarray(IDS33)
    ids_in, targets = ids[:, :-1], ids[:, 1:]
    positions = jnp.broadcast_to(jnp.arange(32), ids_in.shape)
    mask = jnp.broadcast_to(jnp.arange(32) < 29, ids_in.shape)

    def full(p):
        return model.shifted_loss(p, ids_in, targets, mask=mask)

    want, want_g = jax.value_and_grad(full)(params)
    sharded = jpp.shard_map(
        lambda p, a, b, c, m: model.shifted_loss(p, a, b, mask=m,
                                                 positions=c,
                                                 seq_axis="seq"),
        mesh=_jmesh(seq=N), in_specs=(JP(),) + (JP(None, "seq"),) * 4,
        out_specs=JP(), check_vma=False)
    want_sharded = float(sharded(params, ids_in, targets, positions, mask))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(want_g)}
    return float(want), want_sharded, flat


@pytest.mark.parametrize("remat", [False, True])
def test_seq_sharded_shifted_loss_and_grads_match_jax(world, remat):
    """shifted_loss over globally shifted ids (T 32 = 4 x 8), a mask and
    global positions, seq-sharded: the loss equals JAX's seq-sharded
    loss and its unsharded masked loss (rtol 2e-5, JAX's bound), and the
    gradients of every parameter equal JAX's unsharded gradients (the
    ring's backward; within 1e-4 of each leaf's largest entry)."""
    want, want_sharded, flat = _jax_lm_loss()
    tag = "remat_" if remat else ""
    res = torch_spmd.result(world, "lm")
    np.testing.assert_allclose(res[tag + "loss"], want_sharded, rtol=2e-5)
    np.testing.assert_allclose(res[tag + "loss"], want, rtol=2e-5)
    got = {_jax_name(k): v for k, v in res[tag + "grads"].items()}
    assert sorted(got) == sorted(flat)
    for k, w in flat.items():
        scale = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-4 * scale,
                                   err_msg=k)
    for r in range(1, N):         # the same gradient on every rank
        for k, v in torch_spmd.result(world, "lm", r)[tag + "grads"].items():
            np.testing.assert_array_equal(v, res[tag + "grads"][k])


def _jax_name(path: str) -> str:
    from paddle_tpu_torch.parallel.sharding import jax_path
    return jax_path(path)


def test_loss_refuses_seq_axis_and_kv_lens_with_it(world):
    """loss(seq_axis=) refuses, naming the shift, as JAX's; kv_lens under
    seq_axis raises NotImplementedError, as JAX's."""
    res = torch_spmd.result(world, "lm")
    assert "shift" in res["refused"]
    assert "kv_lens" in res["kv_lens"]
    model, params = _jax_lm()
    with pytest.raises(ValueError, match="shift"):
        model.loss(params, jnp.asarray(IDS33), seq_axis="seq")


def test_ranks_import_no_jax(world):
    assert not any(torch_spmd.result(world, "_imports_jax", r)
                   for r in range(N))
