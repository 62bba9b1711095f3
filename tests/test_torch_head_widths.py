"""Head widths other than 64 in the port (ROADMAP B.1.3, B.1.4) against
the JAX package, on the CPU.

On the card #1-#3 are built for D = 64, 128 and 256 and take any other
width up to 256 by zero-padding to the next of them
(``cuda_kernels.flash_fwd_by_route`` / ``flash_bwd_by_route``, the
``pad64``/``pad128``/``pad256`` routes); #4-#7 read every multiple of 8
up to 256 natively and pad any other width to the next multiple of 8
(``decode_by_route``, the ``pad8`` route). Here the same routes run
around the plain versions (the CPU's launch): the flash route's output
and gradients at D in {8, 12, 32, 48, 80, 96, 100, 128, 160, 256}, with
the scale of the real width and with a scale of the caller's, equal JAX's
Pallas forward and backward in interpret mode (atol 2e-5: f32 on both
sides, summation order only, as tests/test_torch_flash_bwd.py), and the
decode route's at D in {12, 100, 160, 256} equals JAX's
``decode_attention`` and ``paged_decode_attention`` in interpret mode
(atol 1e-5). Causal attention at S < T and S > T
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
WIDTHS = (8, 12, 32, 48, 80, 96, 100, 128, 160, 256)
#: the widths of B.1.4's checks: off the multiples of 8, between the built
#: widths, and the widest built one
WIDE = (12, 100, 160, 256)


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


def _route_name(D):
    return f"pad{next(w for w in ck.KERNEL_HEAD_DIMS if w >= D)}"


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", WIDTHS)
def test_pad_route_matches_jax_forward_and_gradients(D, causal):
    """The route pads q, k, v (and o, dO) to the built width, runs the
    launch there and slices back: o, lse, dq, dk and dv equal JAX's at the
    real width's scale (a scale of the caller's at widths off the
    multiples of 8), and the route is counted as the kernel would count
    it."""
    T = S = 40
    q, k, v, do = _inputs(D, T, S, D)
    lens = [40, 17]
    scale = D ** -0.5 if D % 8 == 0 else 0.7 * D ** -0.5
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
    route = _route_name(D)
    want_routes = {} if D in ck.KERNEL_HEAD_DIMS else {
        ("flash_attention_fwd", route): 1,
        ("flash_attention_bwd_dq", route): 1,
        ("flash_attention_bwd_dkv", route): 1}
    assert ck.ROUTES == want_routes


def test_widths_the_kernels_do_not_take_raise():
    """Past 256 the routes raise naming the widths they take and ROADMAP
    B.1.5 (no model of the repo or its catalogue has such heads); plain
    calls still compute."""
    for D in (264, 512):
        x = torch.zeros(1, 4, 1, D)
        with pytest.raises(ValueError, match="B.1.5"):
            ck.flash_fwd_by_route(x, x, x, False, 1.0, None, _plain_fwd)
        with pytest.raises(ValueError, match="head width"):
            ck._decode_query("decode_attention", x[:, 0], torch.zeros(1))
        assert ck.flash_attention(x, x, x).shape == x.shape


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("D", WIDE)
def test_decode_route_matches_jax(D, kv):
    """#4-#7's route at the B.1.4 widths around the plain versions: the
    dense and the paged read equal JAX's decode_attention and
    paged_decode_attention in interpret mode, and a width off the
    multiples of 8 is counted as "pad8" under the kernel that would run."""
    rs = np.random.RandomState(D)
    B, L, H, P, bs, NB = 2, 24, 2, 7, 8, 3
    q = rs.randn(B, H, D).astype(np.float32)
    kc, vc = (rs.randn(B, L, H, D).astype(np.float32) for _ in range(2))
    kp, vp = (rs.randn(P, bs, H, D).astype(np.float32) for _ in range(2))
    tables = rs.randint(1, P, (B, NB)).astype(np.int32)
    pos = np.array([L - 1, 9], np.int32)
    scale = 0.25
    tq, tpos = torch.from_numpy(q), torch.from_numpy(pos)

    def cache(a):
        if kv == "f32":
            return (a,), ()
        codes, sc = pk.quantize_kv(jnp.asarray(a))
        return (np.array(codes), np.array(sc)), None

    (kd, *ks), (vd, *vs) = cache(kc)[0], cache(vc)[0]
    (kq, *kps), (vq, *vps) = cache(kp)[0], cache(vp)[0]
    jsc = {} if kv == "f32" else {"k_scale": jnp.asarray(ks[0]),
                                  "v_scale": jnp.asarray(vs[0])}
    psc = {} if kv == "f32" else {"k_scale": jnp.asarray(kps[0]),
                                  "v_scale": jnp.asarray(vps[0])}
    want = pk.decode_attention(jnp.asarray(q), jnp.asarray(kd),
                               jnp.asarray(vd), jnp.asarray(pos),
                               scale=scale, interpret=True, route="kernel",
                               **jsc)
    pwant = pk.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tables), jnp.asarray(pos), scale=scale, interpret=True,
        route="kernel", **psc)
    tsc = {k: torch.from_numpy(np.array(v)) for k, v in jsc.items()}
    tpsc = {k: torch.from_numpy(np.array(v)) for k, v in psc.items()}
    name = "decode_attention" + ("_q" if kv == "int8" else "")
    ck.reset_launch_counts()
    got = ck.decode_by_route(
        tq, (torch.from_numpy(kd), torch.from_numpy(vd)),
        lambda q, kv_: ck.decode_attention_plain(q, *kv_, tpos, scale=scale,
                                                 **tsc), name)
    pgot = ck.decode_by_route(
        tq, (torch.from_numpy(kq), torch.from_numpy(vq)),
        lambda q, kv_: ck.paged_decode_attention_plain(
            q, *kv_, torch.from_numpy(tables), tpos, scale=scale, **tpsc),
        "paged_" + name)
    assert got.shape == pgot.shape == (B, H, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pgot.numpy(), np.asarray(pwant), atol=1e-5,
                               rtol=0)
    assert ck.ROUTES == ({} if D % 8 == 0 else {
        (name, "pad8"): 1, ("paged_" + name, "pad8"): 1})


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
