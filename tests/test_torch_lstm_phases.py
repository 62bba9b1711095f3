"""The order of operations of the port's LSTM backward kernel
(``csrc/lstm_seq_bwd.cu``), written out in plain PyTorch and held against
the JAX package's ``lstm_sequence_fused_bwd`` (the Pallas kernel in
interpret mode, as tests/test_torch_rnn.py runs it), on the CPU.

The kernel runs in three phases: (1) every step's gates recomputed from
the saved outputs before the recurrence starts, (2) the reverse
recurrence with only the dh product inside it, formed as one partial a
block of 4 hidden units (its 16 gate columns of dgates against U's same
columns), the H/4 partials of a row summed by 8 threads, each over a
contiguous eighth of the blocks in block order, then across the 8 by a
butterfly (a pairwise tree), (3) dU per batch tile of 32 rows in stages
of NS steps, each stage's product summed on its own and added to the
running sum, the tiles' sums added in tile order. :func:`three_phase_bwd`
is that phase split and that order of the sums between products; the
order inside one tensor-core product (a block's 16 columns, a stage's
rows) is the matmul's here and cannot be modelled. The CUDA kernel
itself, which has no CPU version, is held against the plain version on
the card (tests/test_torch_gpu.py, chip_smoke.py). The same order is held
against the port's plain version (``lstm_sequence_fused_bwd_plain``, the
reference's one-loop order).

Tolerances, as tests/test_torch_gru.py states them: f32 outputs atol/rtol
1e-5 (both sides compute in f32 and differ only in summation order);
bf16 outputs one bf16 ulp (rtol 2**-7, atol 1e-6: the same f32 values
rounded once); du, an f32 sum of B*T products, rtol 1e-5 plus 1e-5 of
its largest magnitude.

Also here: the 16-byte rule of the attention kernels' loads
(``cuda_kernels._check_tma``), which the f32 forward (#1) now keeps too,
against the views the models hand over.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu_torch.models import TransformerLM, TransformerSeq2Seq
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.ops import rnn_kernels as rk

ATOL = RTOL = 1e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6
TILE, UNITS = 32, 4     # a block's batch rows and hidden units
SLICES = 8              # threads that sum one row's dh partials
# steps a dU stage: the kernel's plan (make_plan) takes 4 at these widths;
# it takes fewer only at wider H (past 176 in f32), where shared memory
# runs short
NS = 4

# (B, T, H, lengths, nonzero h0/c0, forget_bias), H a multiple of 4 as the
# kernel takes it: ragged lengths with a 0;
# B=40 spans two batch tiles of 32; H=72 gives 18 blocks of units, no
# multiple of the 8 threads that share a row's sum in the kernel
CASES = [
    (5, 7, 8, [0, 1, 7, 3, 5], True, 1.0),
    (40, 6, 8, "ragged", True, 1.0),
    (4, 5, 72, [5, 0, 2, 4], False, 0.0),
]


def _inputs(B, T, H, lens, state, seed=0):
    rs = np.random.RandomState(seed)
    G = 4 * H
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    zeros = lambda *s: np.zeros(s, np.float32)
    if lens == "ragged":
        lens = rs.randint(0, T + 1, B)
        lens[3] = 0
    return dict(xw=arr(B, T, G, scale=0.7),
                lengths=np.asarray(lens, np.int32),
                u=arr(H, G, scale=0.3), b=arr(G, scale=0.1),
                h0=arr(B, H, scale=0.5) if state else zeros(B, H),
                c0=arr(B, H, scale=0.5) if state else zeros(B, H),
                g_out=arr(B, T, H), g_ht=arr(B, H), g_ct=arr(B, H))


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def _j(a, dtype=None):
    return jnp.asarray(a, dtype) if dtype is not None and np.asarray(
        a).dtype == np.float32 else jnp.asarray(a)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def three_phase_bwd(xw, lengths, u, b, h0, c0, out, c_seq, g_out, g_ht,
                    g_ct, *, forget_bias):
    """``lstm_sequence_fused_bwd`` in the kernel's three-phase order and
    order of sums; every product and adjoint in f32, outputs in xw's
    dtype, du in f32."""
    B, T, G = xw.shape
    H = G // 4
    f = lambda a: a.to(torch.float32)
    u32 = f(u)
    # phase 1: the gates of every step, from the saved outputs
    h_prev = torch.cat([f(h0)[None], f(out).transpose(0, 1)[:-1]])  # [T,B,H]
    pre = (f(xw).transpose(0, 1) + h_prev @ u32) + f(b)             # [T,B,G]
    gi = torch.sigmoid(pre[..., :H])
    gf = torch.sigmoid(pre[..., H:2 * H] + forget_bias)
    gg = torch.tanh(pre[..., 2 * H:3 * H])
    go = torch.sigmoid(pre[..., 3 * H:])
    c_prev = torch.cat([f(c0)[None], f(c_seq).transpose(0, 1)[:-1]])
    # each block's 16 gate columns: gate k's units j0 .. j0 + 3
    blocks = [[k * H + j for k in range(4) for j in range(j0, j0 + UNITS)]
              for j0 in range(0, H, UNITS)]
    # phase 2: the reverse recurrence, one product a step
    lens = f(lengths)[:, None]
    dh, dc = f(g_ht), f(g_ct)
    dg_seq = torch.empty((T, B, G))
    for t in reversed(range(T)):
        i, fg, g, o, cp = gi[t], gf[t], gg[t], go[t], c_prev[t]
        tc = torch.tanh(fg * cp + i * g)
        m = (t < lens).to(torch.float32)
        dh_t = dh + m * f(g_out[:, t])
        dhp = m * dh_t
        dct = m * dc + dhp * o * (1.0 - tc * tc)
        dg_seq[t] = torch.cat([(dct * g) * i * (1.0 - i),
                               (dct * cp) * fg * (1.0 - fg),
                               (dct * i) * (1.0 - g * g),
                               (dhp * tc) * o * (1.0 - o)], dim=1)
        parts = [dg_seq[t][:, cols] @ u32[:, cols].t() for cols in blocks]
        dh = (1.0 - m) * dh_t + _sum_partials(parts)
        dc = (1.0 - m) * dc + dct * fg
    # phase 3: dU per batch tile over its live steps in stages of NS,
    # each stage's product on its own, then the tiles in order
    du = torch.zeros((H, G))
    for y in range(0, B, TILE):
        t_end = int(lengths[y:y + TILE].clamp(max=T).max())
        acc = torch.zeros((H, G))
        for t0 in range(0, t_end, NS):
            t1 = min(t0 + NS, t_end)
            hs = h_prev[t0:t1, y:y + TILE].reshape(-1, H)
            acc = acc + hs.t() @ dg_seq[t0:t1, y:y + TILE].reshape(-1, G)
        du = du + acc
    dt = xw.dtype
    return (dg_seq.transpose(0, 1).to(dt), dh.to(dt), dc.to(dt), du)


def _sum_partials(parts):
    """The kernel's sum of a row's X block partials: thread p of 8 adds
    blocks p*xper .. in order, then a butterfly over the 8 (xor 1, 2, 4)
    adds the slices pairwise."""
    X = len(parts)
    xper = -(-X // SLICES)
    sl = []
    for p in range(SLICES):
        s = torch.zeros_like(parts[0])
        for x in range(p * xper, min(X, (p + 1) * xper)):
            s = s + parts[x]
        sl.append(s)
    while len(sl) > 1:
        sl = [sl[i] + sl[i + 1] for i in range(0, len(sl), 2)]
    return sl[0]


DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]
NAMES = ("dxw", "dh0", "dc0", "du")


def _check(got, want, dname, B, T):
    for name, g, w in zip(NAMES, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        if name == "du":
            w32 = _np32(w)
            atol, rtol = 1e-5 * np.abs(w32).max(), 1e-5
        elif dname == "float32":
            atol, rtol = ATOL, RTOL
        else:
            atol, rtol = BF16_ATOL, BF16_RTOL
        np.testing.assert_allclose(_np32(g), _np32(w), atol=atol, rtol=rtol,
                                   err_msg=name)


def _residuals(a, tdt, jdt, fb):
    """The forward's save_cell residuals from JAX (Pallas interpret), in
    the I/O dtype, for both sides."""
    keys = ("xw", "lengths", "u", "b", "h0", "c0")
    jf = [_j(a[k], jdt) for k in keys]
    out, _, _, c_seq = pk.lstm_sequence_fused(*jf, forget_bias=fb,
                                              save_cell=True, interpret=True)
    cot = [_j(a[k], jdt) for k in ("g_out", "g_ht", "g_ct")]
    tf = [_t(a[k], tdt) for k in keys]
    to = lambda x: _t(np.asarray(jnp.asarray(x, jnp.float32)), tdt)
    tcot = [_t(a[k], tdt) for k in ("g_out", "g_ht", "g_ct")]
    return (jf, out, c_seq, cot), tf + [to(out), to(c_seq)] + tcot


@pytest.mark.parametrize("dname,tdt,jdt", DTYPES)
@pytest.mark.parametrize("B,T,H,lens,state,fb", CASES)
def test_three_phase_order_matches_pallas_interpret(B, T, H, lens, state, fb,
                                                   dname, tdt, jdt):
    a = _inputs(B, T, H, lens, state, seed=3)
    (jf, out, c_seq, cot), targs = _residuals(a, tdt, jdt, fb)
    want = pk.lstm_sequence_fused_bwd(*jf, out, c_seq, *cot, forget_bias=fb,
                                      block_b=8, interpret=True)
    got = three_phase_bwd(*targs, forget_bias=fb)
    assert [g.dtype for g in got] == [tdt] * 3 + [torch.float32]
    _check(got, want, dname, B, T)


@pytest.mark.parametrize("dname,tdt,jdt", DTYPES)
@pytest.mark.parametrize("B,T,H,lens,state,fb", CASES)
def test_three_phase_order_matches_the_plain_version(B, T, H, lens, state,
                                                    fb, dname, tdt, jdt):
    """The kernel's order and the port's plain version (the reference's
    one loop with all three products a step) agree to summation order."""
    a = _inputs(B, T, H, lens, state, seed=4)
    _, targs = _residuals(a, tdt, jdt, fb)
    want = rk.lstm_sequence_fused_bwd(*targs, forget_bias=fb)
    got = three_phase_bwd(*targs, forget_bias=fb)
    _check(got, want, dname, B, T)


def test_three_phase_order_masks_dead_steps():
    """A sample of length 0 passes its cotangents through unchanged and
    gives zero dgates at every step (as the kernel's owners compute)."""
    a = _inputs(5, 7, 8, [0, 1, 7, 3, 5], True, seed=5)
    _, targs = _residuals(a, torch.float32, jnp.float32, 1.0)
    dxw, dh0, dc0, _ = three_phase_bwd(*targs, forget_bias=1.0)
    assert not dxw[0].any()
    assert torch.equal(dh0[0], targs[-2][0]) and torch.equal(dc0[0],
                                                             targs[-1][0])


# ---------------------------------------------------------------------------
# the 16-byte rule of the attention kernels' loads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_views_of_the_models_keep_the_16_byte_rule(dtype):
    """The [B, T, H, 64] views of the fused projections that TransformerLM
    (qkv) and TransformerSeq2Seq's decoder (q_x, kv_x) hand to the
    attention kernels pass ``_check_tma``, which every attention kernel's
    wrapper runs (since this change the f32 forward too); a view whose
    base sits off 16 bytes, or whose head stride is no multiple of 16
    bytes, raises."""
    B, T = 2, 12
    lm = TransformerLM(50, d_model=128, n_heads=2, n_layers=1,
                       max_len=32).init(0, "cpu").to(dtype)
    x = torch.randn(B, T, 128).to(dtype)
    with torch.no_grad():
        q, k, v = lm.blocks[0].heads(x)
    assert not q.is_contiguous() and q.shape == (B, T, 2, 64)
    ck._check_tma("flash_attention_fwd", q=q, k=k, v=v)
    nmt = TransformerSeq2Seq(40, 40, d_model=128, n_heads=2, n_enc=1,
                             n_dec=1, max_len=32).init(0, "cpu").to(dtype)
    dec = nmt.dec_blocks[0]
    with torch.no_grad():
        qx, = dec._split(dec.q_x(x), 1)
        kx, vx = dec._split(dec.kv_x(torch.randn(B, 9, 128).to(dtype)), 2)
    assert not kx.is_contiguous() and kx.shape == (B, 9, 2, 64)
    ck._check_tma("flash_attention_fwd", q=qx, k=kx, v=vx)
    flat = torch.randn(B * T * 2 * 64 + 1).to(dtype)
    off = flat[1:].view(B, T, 2, 64)                  # base off 16 bytes
    wide = torch.randn(B, T, 2, 66).to(dtype)[..., :64]  # head stride 66
    for bad in (off, wide):
        with pytest.raises(ValueError, match="TMA rule"):
            ck._check_tma("flash_attention_fwd", q=bad, k=k, v=v)
