"""The port's flash-attention backward (paddle_tpu_torch/ops/cuda_kernels.py
``flash_attention_bwd`` and the ``_FlashAttention`` autograd Function)
against the JAX package's Pallas backward kernels, on the CPU.

On the CPU the wrappers take their plain PyTorch versions (the tensors lie
on the CPU); these are held against ``_fa_bwd_call`` and the custom VJP of
``flash_attention``, both run in interpret mode with 16 x 16 blocks (so T
not a multiple of 16 pads a tail block there), on the same inputs made
with numpy. Tolerance: atol 2e-5 — f32 on both sides, differing only in
summation order over at most 48 products of O(1) terms per element. The
CUDA kernels are held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.ops import cuda_kernels as ck

ATOL = 2e-5
BLOCK = dict(block_q=16, block_k=16, interpret=True)
SCALE = 16 ** -0.5

# (causal, T, S, kv_lens)
CASES = [
    (True, 48, 48, None),
    (True, 40, 40, None),              # T not a multiple of the blocks
    (False, 40, 40, None),
    (False, 24, 40, None),             # S != T (cross-attention shape)
    (False, 24, 40, [40, 0, 17]),      # kv_lens with an empty sample
    (True, 40, 40, [40, 5, 0]),
    (False, 40, 21, [3, 21, 0]),       # S < T, S not a block multiple
]


def _inputs(seed, T, S, B=3, H=2, D=16):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, T, H, D).astype(np.float32)
    k = rs.randn(B, S, H, D).astype(np.float32)
    v = rs.randn(B, S, H, D).astype(np.float32)
    do = rs.randn(B, T, H, D).astype(np.float32)
    return q, k, v, do


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


@pytest.mark.parametrize("given_delta", [False, True])
@pytest.mark.parametrize("causal,T,S,lens", CASES)
def test_bwd_plain_matches_pallas_interpret(causal, T, S, lens, given_delta):
    """dq, dk, dv of ``flash_attention_bwd`` (the plain version on the CPU)
    against ``_fa_bwd_call`` from the same (o, lse), which come from the
    Pallas forward. Both get the lengths clamped to [1, S], as both
    ``flash_attention`` entries clamp them before these calls."""
    q, k, v, do = _inputs(0, T, S)
    lens_j = None if lens is None else jnp.clip(jnp.asarray(lens), 1, S)
    o, lse = pk._fa_fwd_call(*(jnp.asarray(a) for a in (q, k, v)), causal,
                             SCALE, 16, 16, True, kv_lens=lens_j)
    delta = jnp.sum(jnp.asarray(do) * o, axis=-1) if given_delta else None
    want = pk._fa_bwd_call(*(jnp.asarray(a) for a in (q, k, v)), o, lse,
                           jnp.asarray(do), causal, SCALE, 16, 16, True,
                           delta=delta, kv_lens=lens_j)
    got = ck.flash_attention_bwd(
        *_t(q, k, v, o, lse, do), causal=causal, scale=SCALE,
        kv_lens=None if lens is None else torch.tensor(lens),
        delta=None if delta is None else _t(delta)[0])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0, err_msg=name)
    if lens is not None:
        for b, n in enumerate(lens):
            n = max(n, 1)
            assert not got[1][b, n:].any() and not got[2][b, n:].any()


@pytest.mark.parametrize("causal,T,S,lens", CASES)
def test_flash_attention_grads_match_jax_custom_vjp(causal, T, S, lens):
    """Gradients of <flash_attention(q, k, v), w> through ``_FlashAttention``
    against ``jax.grad`` of the same loss through the JAX custom VJP: a
    0-length sample's output is zeroed outside the Function on both
    sides, so no gradient reaches its q, k or v."""
    q, k, v, w = _inputs(1, T, S)
    lens_j = None if lens is None else jnp.asarray(lens, jnp.int32)

    def jloss(q, k, v):
        o = pk.flash_attention(q, k, v, causal=causal, kv_lens=lens_j,
                               **BLOCK)
        return jnp.sum(o * jnp.asarray(w))
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [t.requires_grad_(True) for t in _t(q, k, v)]
    o = ck.flash_attention(*leaves, causal=causal,
                           kv_lens=None if lens is None
                           else torch.tensor(lens))
    got = torch.autograd.grad(torch.sum(o * torch.from_numpy(w)), leaves)
    for name, g, wnt in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=ATOL,
                                   rtol=0, err_msg=name)
    if lens is not None:
        for b, n in enumerate(lens):
            if n == 0:
                assert not any(g[b].any() for g in got)
            assert not got[1][b, n:].any() and not got[2][b, n:].any()


def test_grads_flow_through_strided_qkv_views():
    """The model hands attention q/k/v as views of one fused projection;
    the gradient of the projection equals the one through contiguous
    copies (autograd assembles dq, dk, dv into it)."""
    rs = np.random.RandomState(2)
    qkv = torch.from_numpy(rs.randn(2, 24, 3 * 4 * 8).astype(np.float32))
    w = torch.from_numpy(rs.randn(2, 24, 4, 8).astype(np.float32))

    def grad(copy):
        x = qkv.clone().requires_grad_(True)
        q, k, v = (t.unflatten(-1, (4, 8)) for t in x.chunk(3, dim=-1))
        if copy:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o = ck.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(torch.sum(o * w), x)[0]
    torch.testing.assert_close(grad(False), grad(True), atol=0, rtol=0)


def test_forward_only_without_grad_and_launch_counts_stay_zero():
    """Without grad (or with no input requiring it) ``flash_attention`` is
    the forward alone; on CPU tensors no kernel launches are counted."""
    ck.reset_launch_counts()
    q, k, v, do = _t(*_inputs(3, 16, 16, D=64))
    o = ck.flash_attention(q, k, v, causal=True)
    assert o.grad_fn is None
    q.requires_grad_(True)
    with torch.no_grad():
        assert ck.flash_attention(q, k, v, causal=True).grad_fn is None
    o = ck.flash_attention(q, k, v, causal=True)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.backward(do)
    assert q.grad is not None and q.grad.shape == q.shape
    assert all(n == 0 for n in ck.LAUNCHES.values())


def test_bwd_returns_each_input_dtype_and_refuses_unknown_routes():
    q, k, v, do = _t(*_inputs(4, 8, 8))
    o, lse = ck.flash_attention_fwd(q, k, v)
    dq, dk, dv = ck.flash_attention_bwd(q, k, v, o, lse, do)
    assert (dq.dtype, dk.dtype, dv.dtype) == (torch.float32,) * 3
    assert dk.shape == k.shape and dq.shape == q.shape
    b = [t.to(torch.bfloat16) for t in (q, k, v, o, do)]
    got = ck.flash_attention_bwd(b[0], b[1], b[2], b[3], lse, b[4])
    assert all(t.dtype == torch.bfloat16 for t in got)
    with pytest.raises(ValueError, match="unknown route"):
        ck.flash_attention_bwd(q, k, v, o, lse, do, route="kernel")
