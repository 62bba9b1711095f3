"""Head widths other than 64 in the port (ROADMAP B.1.3) against the JAX
package, on the CPU.

On the card #1-#3 are built for D = 64 and 128 and take any other
multiple of 8 up to 128 by zero-padding to the next of them
(``cuda_kernels.flash_fwd_by_route`` / ``flash_bwd_by_route``, the
``pad64``/``pad128`` routes); #4-#7 read every width natively. Here the
same route runs around the plain versions (the CPU's launch): its output
and gradients at D in {8, 32, 48, 80, 96, 128}, with the scale of the
real width, equal JAX's Pallas forward and backward in interpret mode
(atol 2e-5: f32 on both sides, summation order only, as
tests/test_torch_flash_bwd.py). Causal attention at S < T and S > T
(top-left aligned, ``tril(ones(T, S))``) equals JAX's dense route, with
its gradients; and ``TransformerLM``s with 32- and 128-wide heads give
JAX's logits and greedy decode tokens. The kernels themselves are held
to the plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py
phase 18).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import TransformerLM as JTransformerLM
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import TransformerLM
from paddle_tpu_torch.ops import cuda_kernels as ck

ATOL = 2e-5
WIDTHS = (8, 32, 48, 80, 96, 128)


def _plain_fwd(q, k, v, causal, scale, kv_lens):
    return ck.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale,
                                        kv_lens=kv_lens)


def _plain_bwd(q, k, v, o, lse, do, causal, scale, kv_lens, delta):
    return ck.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        scale=scale, kv_lens=kv_lens,
                                        delta=delta)


def _inputs(seed, T, S, D, B=2, H=2):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, n, H, D).astype(np.float32) for n in (T, S, S, T)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", WIDTHS)
def test_pad_route_matches_jax_forward_and_gradients(D, causal):
    """The route pads q, k, v (and o, dO) to the built width, runs the
    launch there and slices back: o, lse, dq, dk and dv equal JAX's at the
    real width's scale, and the route is counted as the kernel would
    count it."""
    T = S = 40
    q, k, v, do = _inputs(D, T, S, D)
    lens = [40, 17]
    scale = D ** -0.5
    jl = jnp.asarray(lens)
    o, lse = pk._fa_fwd_call(*(jnp.asarray(a) for a in (q, k, v)), causal,
                             scale, 16, 16, True, kv_lens=jl)
    want = pk._fa_bwd_call(*(jnp.asarray(a) for a in (q, k, v)), o, lse,
                           jnp.asarray(do), causal, scale, 16, 16, True,
                           kv_lens=jl)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tl = torch.tensor(lens)
    ck.reset_launch_counts()
    go, glse = ck.flash_fwd_by_route(tq, tk, tv, causal, scale, tl,
                                     _plain_fwd)
    assert go.shape == (2, T, 2, D)
    assert go.is_contiguous() or D in ck.KERNEL_HEAD_DIMS   # a sliced pad
    np.testing.assert_allclose(go.numpy(), np.asarray(o), atol=ATOL, rtol=0)
    np.testing.assert_allclose(glse.numpy(), np.asarray(lse), atol=ATOL,
                               rtol=0)
    got = ck.flash_bwd_by_route(tq, tk, tv, go, glse, tdo, causal, scale, tl,
                                None, _plain_bwd)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == (2, T, 2, D), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)
    route = f"pad{64 if D <= 64 else 128}"
    want_routes = {} if D in ck.KERNEL_HEAD_DIMS else {
        ("flash_attention_fwd", route): 1,
        ("flash_attention_bwd_dq", route): 1,
        ("flash_attention_bwd_dkv", route): 1}
    assert ck.ROUTES == want_routes


def test_widths_the_kernels_do_not_take_raise():
    """Past 128, or off the multiples of 8, the route raises naming the
    widths it takes (ROADMAP B.1.4); plain calls still compute."""
    for D in (12, 136, 256):
        x = torch.zeros(1, 4, 1, D)
        with pytest.raises(ValueError, match="head width"):
            ck.flash_fwd_by_route(x, x, x, False, 1.0, None, _plain_fwd)
        assert ck.flash_attention(x, x, x).shape == x.shape


def test_views_that_break_the_16_byte_rule_are_copied():
    """A view off the 16-byte rule reaches the launch as a contiguous
    copy (route copy16); one that keeps it is passed as it is."""
    flat = torch.randn(2 * 9 * 2 * 64 + 1)
    bad = flat[1:].view(2, 9, 2, 64)
    good = torch.randn(2, 9, 2, 64)
    seen = []

    def launch(q, k, v, causal, scale, kv_lens):
        seen.append((q, k, v))
        return _plain_fwd(q, k, v, causal, scale, kv_lens)

    ck.reset_launch_counts()
    o, _ = ck.flash_fwd_by_route(bad, good, good, True, 0.125, None, launch)
    q, k, v = seen[-1]
    assert q.data_ptr() % 16 == 0 and q.is_contiguous() and k is good
    assert ck.ROUTES == {("flash_attention_fwd", "copy16"): 1}
    want, _ = _plain_fwd(bad, good, good, True, 0.125, None)
    assert torch.equal(o, want)
    ck.flash_fwd_by_route(good, good, good, True, 0.125, None, launch)
    assert seen[-1][0] is good and len(ck.ROUTES) == 1


@pytest.mark.parametrize("T,S", [(24, 40), (40, 24)])
def test_causal_with_s_not_t_matches_jax_dense_route(T, S):
    """Causal at S != T is top-left aligned on both sides: the port's
    ``flash_attention`` (plain on the CPU, with kv_lens, through
    autograd) equals JAX's dense route, forward and gradients."""
    q, k, v, do = _inputs(T + S, T, S, 16)
    lens = np.array([S, S // 2], np.int32)

    def jf(q, k, v):
        return pk.flash_attention(q, k, v, causal=True,
                                  kv_lens=jnp.asarray(lens))

    jo, vjp = jax.vjp(jf, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = ck.flash_attention(tq, tk, tv, causal=True,
                           kv_lens=torch.from_numpy(lens))
    o.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               atol=ATOL, rtol=0)
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("d_model,n_heads", [(64, 2), (256, 2)])
def test_transformer_lm_with_other_head_widths_matches_jax(d_model,
                                                           n_heads):
    """TransformerLMs with 32- and 128-wide heads (2 layers): logits
    equal JAX's (atol 1e-4, as tests/test_torch_transformer.py) and the
    greedy decode equals JAX's token for token."""
    kw = dict(d_model=d_model, n_heads=n_heads, n_layers=2, max_len=64)
    jmodel = JTransformerLM(61, **kw)
    jparams = jmodel.init(jax.random.PRNGKey(d_model))
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             TransformerLM(61, **kw), "cpu")
    assert port.blocks[0].d_head == d_model // n_heads
    ids = np.random.RandomState(4).randint(0, 61, (2, 19)).astype(np.int32)
    np.testing.assert_allclose(port(torch.from_numpy(ids)).detach().numpy(),
                               np.asarray(jmodel(jparams, jnp.asarray(ids))),
                               atol=1e-4, rtol=0)
    want = np.asarray(jmodel.generate_cached(jparams,
                                             jnp.asarray(ids[:, :7]),
                                             steps=12))
    got = port.generate_fused(torch.from_numpy(ids[:, :7]), 12).numpy()
    np.testing.assert_array_equal(got, want)
