"""The port's LSTM (paddle_tpu_torch/ops/rnn.py, ops/rnn_kernels.py)
against the JAX package's, on the CPU.

On the CPU the kernel wrappers take their plain PyTorch versions (the
tensors lie on the CPU); those are held here against the Pallas LSTM
kernels run in interpret mode, as tests/test_pallas.py runs them, on the
same inputs made with numpy. ``_LSTMFused`` (the autograd Function in
place of the JAX custom VJP) is held against JAX ``_lstm_fused``'s VJP,
against autodiff of JAX's scan and against autograd through the port's
own ``_lstm_scan``. Tolerance: f32 atol/rtol 1e-5 for the kernels (both
sides compute in f32 and differ only in summation order); 2e-5 for the
gradients, which add the dx/dW products over B*T rows. The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_gpu.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.lod import sequence_mask as jax_sequence_mask
from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import rnn as JR
from paddle_tpu.ops import sequence as JS
from paddle_tpu_torch.core import SeqBatch, pack_sequences, sequence_mask
from paddle_tpu_torch.core.pytree import (tree_from_items, tree_get,
                                          tree_items, tree_map)
from paddle_tpu_torch.ops import loss as L
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.ops import rnn_kernels as rk
from paddle_tpu_torch.ops import sequence as S

ATOL = RTOL = 1e-5
GRAD_TOL = 2e-5

# (B, T, H, lengths, nonzero h0/c0, forget_bias): a batch that is no
# multiple of the JAX tile (B=5 with block_b 2 leaves a tail), lengths
# 0, 1 and T, nonzero initial state, forget_bias 0 and 1
CASES = [
    (5, 7, 6, [0, 1, 7, 3, 5], True, 1.0),
    (5, 7, 6, [7, 7, 2, 1, 4], False, 0.0),
    (3, 12, 16, [12, 5, 9], True, 1.0),
    (8, 4, 8, [4, 0, 1, 2, 3, 4, 4, 1], False, 1.0),
]


def _inputs(B, T, H, lens, state, seed=0):
    rs = np.random.RandomState(seed)
    G = 4 * H
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    zeros = lambda *s: np.zeros(s, np.float32)
    return dict(xw=arr(B, T, G, scale=0.7), lengths=np.asarray(lens, np.int32),
                u=arr(H, G, scale=0.3), b=arr(G, scale=0.1),
                h0=arr(B, H, scale=0.5) if state else zeros(B, H),
                c0=arr(B, H, scale=0.5) if state else zeros(B, H),
                g_out=arr(B, T, H), g_ht=arr(B, H), g_ct=arr(B, H))


def _t(a):
    return torch.tensor(np.asarray(a))


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), atol=atol,
        rtol=rtol, err_msg=msg)


FWD = ("xw", "lengths", "u", "b", "h0", "c0")


@pytest.mark.parametrize("save_cell", [False, True])
@pytest.mark.parametrize("B,T,H,lens,state,fb", CASES)
def test_plain_forward_matches_pallas_interpret(B, T, H, lens, state, fb,
                                                save_cell):
    a = _inputs(B, T, H, lens, state)
    want = pk.lstm_sequence_fused(
        *(jnp.asarray(a[k]) for k in FWD), forget_bias=fb, block_b=2,
        save_cell=save_cell, interpret=True)
    got = rk.lstm_sequence_fused(*(_t(a[k]) for k in FWD), forget_bias=fb,
                                 save_cell=save_cell)
    assert len(got) == len(want) == (4 if save_cell else 3)
    for name, g, w in zip(("out", "hT", "cT", "c_seq"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w, msg=name)
    for b, n in enumerate(lens):
        if n == 0:                       # JAX: state left at h0/c0, out 0
            assert not got[0][b].any()
            _close(got[1][b], a["h0"][b], atol=0, rtol=0)


@pytest.mark.parametrize("B,T,H,lens,state,fb", CASES)
def test_plain_backward_matches_pallas_interpret(B, T, H, lens, state, fb):
    a = _inputs(B, T, H, lens, state, seed=1)
    jf = [jnp.asarray(a[k]) for k in FWD]
    out, _, _, c_seq = pk.lstm_sequence_fused(*jf, forget_bias=fb,
                                              save_cell=True, interpret=True)
    cot = [jnp.asarray(a[k]) for k in ("g_out", "g_ht", "g_ct")]
    want = pk.lstm_sequence_fused_bwd(*jf, out, c_seq, *cot, forget_bias=fb,
                                      block_b=2, interpret=True)
    got = rk.lstm_sequence_fused_bwd(
        *(_t(a[k]) for k in FWD), _t(out), _t(c_seq),
        *(_t(a[k]) for k in ("g_out", "g_ht", "g_ct")), forget_bias=fb)
    for name, g, w in zip(("dxw", "dh0", "dc0", "du"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w, msg=name)


def test_plain_versions_keep_the_io_dtype_and_f32_du():
    """bf16 in, bf16 out (out, hT, cT, c_seq, dxw, dh0, dc0), du in f32 —
    the JAX wrappers' dtypes — while the arithmetic stays in f32: the
    bf16 result is the f32 result of the same bf16 inputs rounded once."""
    a = _inputs(3, 6, 8, [6, 2, 0], True)
    f32 = {k: _t(a[k]) for k in a}
    bf = {k: (v.to(torch.bfloat16) if v.is_floating_point() else v)
          for k, v in f32.items()}
    fwd = rk.lstm_sequence_fused(*(bf[k] for k in FWD), forget_bias=1.0,
                                 save_cell=True)
    ref = rk.lstm_sequence_fused(*(bf[k].float() if bf[k].is_floating_point()
                                   else bf[k] for k in FWD),
                                 forget_bias=1.0, save_cell=True)
    for g, w in zip(fwd, ref):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.to(torch.bfloat16), atol=0, rtol=0)
    bwd = rk.lstm_sequence_fused_bwd(*(bf[k] for k in FWD), fwd[0], fwd[3],
                                     bf["g_out"], bf["g_ht"], bf["g_ct"],
                                     forget_bias=1.0)
    assert [t.dtype for t in bwd] == [torch.bfloat16] * 3 + [torch.float32]


def test_wrappers_fill_defaults_and_check_routes():
    """b, h0 and c0 default to zeros as in JAX; ``route`` takes only None
    or "plain"; the kernels' argument check names the hidden widths it
    takes and refuses mixed dtypes."""
    a = _inputs(2, 3, 6, [3, 1], False)
    full = rk.lstm_sequence_fused(*(_t(a[k]) for k in FWD))
    bare = rk.lstm_sequence_fused(_t(a["xw"]), _t(a["lengths"]), _t(a["u"]),
                                  _t(a["b"]))
    for x, y in zip(full, bare):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    with pytest.raises(ValueError, match="route"):
        rk.lstm_sequence_fused(*(_t(a[k]) for k in FWD), route="kernel")
    args = [_t(a[k]) for k in FWD]
    with pytest.raises(ValueError, match="multiple of 4"):
        rk._check_lstm_args("lstm", *args)
    b8 = _inputs(2, 3, 8, [3, 1], False)
    args8 = [_t(b8[k]) for k in FWD]
    assert rk._check_lstm_args("lstm", *args8).dtype == torch.int32
    args8[2] = args8[2].to(torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        rk._check_lstm_args("lstm", *args8)


# ---------------------------------------------------------------------------
# lstm and its gradients
# ---------------------------------------------------------------------------

def _seq_inputs(B, T, D, H, lens, state, seed=7):
    rs = np.random.RandomState(seed)
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    return dict(x=arr(B, T, D), w=arr(D, 4 * H, scale=0.3),
                u=arr(H, 4 * H, scale=0.3), b=arr(4 * H, scale=0.1),
                h0=arr(B, H, scale=0.2) if state
                else np.zeros((B, H), np.float32),
                c0=arr(B, H, scale=0.2) if state
                else np.zeros((B, H), np.float32),
                wo=arr(B, T, H), wh=arr(B, H), wc=arr(B, H),
                lens=np.asarray(lens, np.int32))


ARGS = ("x", "w", "u", "b", "h0", "c0")


def _jax_grads(a, path):
    """Grads of sum(out*wo) + sum(hT*wh) + sum(cT*wc) in JAX through
    ``path`` ("fused": the custom VJP over the Pallas kernels; "scan":
    autodiff of the masked scan)."""
    lens = jnp.asarray(a["lens"])

    def loss(x, w, u, b, h0, c0):
        if path == "fused":
            out, ht, ct = JR._lstm_fused(x, lens, w, u, b, h0, c0, 1.0, 2,
                                         None)
        else:
            out, st = JR.lstm(x, lens, w, u, b, h0=h0, c0=c0,
                              forget_bias=1.0, fused=False)
            ht, ct = st
        return (jnp.sum(out * a["wo"]) + jnp.sum(ht * a["wh"])
                + jnp.sum(ct * a["wc"]))
    return jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a[k]) for k in ARGS))


def _port_grads(a, fused):
    leaves = [_t(a[k]).requires_grad_(True) for k in ARGS]
    x, w, u, b, h0, c0 = leaves
    out, st = R.lstm(x, _t(a["lens"]), w, u, b, h0, c0, forget_bias=1.0,
                     fused=fused)
    loss = ((out * _t(a["wo"])).sum() + (st.h * _t(a["wh"])).sum()
            + (st.c * _t(a["wc"])).sum())
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("against", ["jax_fused_vjp", "jax_scan",
                                     "port_scan"])
@pytest.mark.parametrize("B,T,D,H,lens,state", [
    (5, 7, 4, 6, [0, 1, 7, 3, 5], True),
    (3, 9, 5, 8, [9, 4, 2], False),
])
def test_lstm_fused_grads(B, T, D, H, lens, state, against):
    """dx, dw, du, db, dh0 and dc0 of ``_LSTMFused`` (the plain kernel
    versions on the CPU) against JAX's custom VJP, JAX's scan autodiff
    and autograd through the port's own scan."""
    a = _seq_inputs(B, T, D, H, lens, state)
    got = _port_grads(a, fused=True)
    if against == "port_scan":
        want = [g.numpy() for g in _port_grads(a, fused=False)]
    else:
        want = _jax_grads(a, "fused" if against == "jax_fused_vjp"
                          else "scan")
    for name, g, w in zip(ARGS, got, want):
        _close(g, w, atol=GRAD_TOL, rtol=GRAD_TOL, msg=name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("fused", [True, False])
def test_lstm_outputs_match_jax(reverse, fused):
    """Outputs and final state, both directions; ``reverse=True`` rides
    the forward kernels through ``_reverse_within_length``."""
    a = _seq_inputs(5, 7, 4, 8, [0, 1, 7, 3, 5], True, seed=3)
    out_j, st_j = JR.lstm(*(jnp.asarray(a[k]) for k in ("x",)),
                          jnp.asarray(a["lens"]),
                          *(jnp.asarray(a[k]) for k in ARGS[1:4]),
                          h0=jnp.asarray(a["h0"]), c0=jnp.asarray(a["c0"]),
                          reverse=reverse, forget_bias=1.0)
    out, st = R.lstm(_t(a["x"]), _t(a["lens"]),
                     *(_t(a[k]) for k in ARGS[1:]), reverse=reverse,
                     forget_bias=1.0, fused=fused)
    _close(out, out_j, msg="out")
    _close(st.h, st_j.h, msg="hT")
    _close(st.c, st_j.c, msg="cT")


def test_reverse_lstm_grads_match_jax():
    a = _seq_inputs(4, 6, 3, 8, [6, 0, 2, 5], True, seed=4)
    lens = jnp.asarray(a["lens"])

    def jloss(x, w, u, b, h0, c0):
        out, st = JR.lstm(x, lens, w, u, b, h0=h0, c0=c0, reverse=True,
                          forget_bias=1.0)
        return jnp.sum(out * a["wo"]) + jnp.sum(st.h * a["wh"])
    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a[k]) for k in ARGS))
    leaves = [_t(a[k]).requires_grad_(True) for k in ARGS]
    out, st = R.lstm(leaves[0], _t(a["lens"]), *leaves[1:], reverse=True,
                     forget_bias=1.0)
    loss = (out * _t(a["wo"])).sum() + (st.h * _t(a["wh"])).sum()
    for name, g, w in zip(ARGS, torch.autograd.grad(loss, leaves), want):
        _close(g, w, atol=GRAD_TOL, rtol=GRAD_TOL, msg=name)


def test_lstm_runs_the_inference_forward_without_grad(monkeypatch):
    """With gradients off, or no input that needs one, ``lstm`` calls the
    forward without ``save_cell`` (the inference kernel); under autograd
    it goes through ``_LSTMFused`` (the training kernel)."""
    calls = []
    real = R.lstm_sequence_fused

    def spy(*args, save_cell=False, **kw):
        calls.append(save_cell)
        return real(*args, save_cell=save_cell, **kw)
    monkeypatch.setattr(R, "lstm_sequence_fused", spy)
    a = _seq_inputs(2, 3, 4, 8, [3, 2], False)
    args = [_t(a[k]) for k in ARGS]
    R.lstm(args[0], _t(a["lens"]), *args[1:])
    with torch.no_grad():
        R.lstm(args[0], _t(a["lens"]), *[t.requires_grad_(True)
                                         for t in args[1:]])
    R.lstm(args[0], _t(a["lens"]), *args[1:])
    assert calls == [False, False, True]


def test_reverse_within_length_matches_jax():
    rs = np.random.RandomState(5)
    x = rs.randn(4, 6, 3).astype(np.float32)
    lens = np.asarray([6, 0, 1, 4], np.int32)
    want = JR._reverse_within_length(jnp.asarray(x), jnp.asarray(lens))
    _close(R._reverse_within_length(_t(x), _t(lens)), want, atol=0, rtol=0)


# ---------------------------------------------------------------------------
# the LoD, sequence and loss helpers of the slice
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", ["max", "average", "sum", "last", "first"])
def test_sequence_pool_matches_jax(pool):
    rs = np.random.RandomState(6)
    x = rs.randn(5, 7, 3).astype(np.float32)
    lens = np.asarray([0, 1, 7, 3, 5], np.int32)
    want = JS.sequence_pool(jnp.asarray(x), jnp.asarray(lens), pool)
    _close(S.sequence_pool(_t(x), _t(lens), pool), want, atol=1e-6, rtol=0)


def test_softmax_cross_entropy_and_mask_match_jax():
    from paddle_tpu.ops import loss as JL
    rs = np.random.RandomState(8)
    logits = rs.randn(6, 4).astype(np.float32) * 3
    labels = rs.randint(0, 4, 6).astype(np.int32)
    want = JL.softmax_with_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels))
    _close(L.softmax_with_cross_entropy(_t(logits), _t(labels)), want,
           atol=1e-6, rtol=0)
    soft = rs.dirichlet(np.ones(4), 6).astype(np.float32)
    want = JL.softmax_with_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(soft), soft_label=True)
    _close(L.softmax_with_cross_entropy(_t(logits), _t(soft),
                                        soft_label=True), want, atol=1e-6,
           rtol=0)
    lens = np.asarray([3, 0, 5], np.int32)
    _close(sequence_mask(_t(lens), 5),
           jax_sequence_mask(jnp.asarray(lens), 5), atol=0, rtol=0)


def test_pack_sequences_and_seq_batch():
    seqs = [np.arange(n, dtype=np.int32) + 1 for n in (3, 9, 1)]
    sb = pack_sequences(seqs, device="cpu")
    assert isinstance(sb, SeqBatch) and sb.max_len == 16     # bucketed
    assert sb.lengths.tolist() == [3, 9, 1] and sb.batch_size == 3
    assert sb.data[1, :9].tolist() == list(range(1, 10))
    assert not sb.data[1, 9:].any()
    cut = pack_sequences(seqs, max_len=4, pad_value=-1, device="cpu")
    assert cut.lengths.tolist() == [3, 4, 1]
    assert cut.data[0].tolist() == [1, 2, 3, -1]
    assert sb.mask().sum().item() == 13


def test_tree_helpers_round_trip():
    tree = {"embed": {"w": 1}, "w0": 2, "fc": {"w": 3, "b": 4}}
    items = tree_items(tree)
    assert [p for p, _ in items] == [("embed", "w"), ("w0",), ("fc", "w"),
                                     ("fc", "b")]
    assert tree_from_items(items) == tree
    assert tree_get(tree, ("fc", "b")) == 4
    slots = tree_map(lambda v: {"m": v, "v": -v}, tree)
    assert tree_map(lambda v, s: v + s["m"] - s["v"], tree, slots) == \
        tree_map(lambda v: 3 * v, tree)
