"""The port's GRU (paddle_tpu_torch/ops/rnn.py ``gru``, ``gru_cell``,
``_GRUFused``, ``bidirectional``, ``simple_rnn``; ops/rnn_kernels.py
``gru_sequence_fused`` and ``gru_sequence_fused_bwd``) against the JAX
package's, on the CPU.

On the CPU the kernel wrappers take their plain PyTorch versions (the
tensors lie on the CPU); those are held against the Pallas GRU kernels
run in interpret mode, as tests/test_pallas.py runs them, on the same
inputs made with numpy. ``_GRUFused`` (the autograd Function in place of
the JAX custom VJP) is held against ``jax.grad`` through JAX's
``_gru_fused`` (the Pallas kernels in interpret mode) and through JAX's
scan. Tolerances: f32 kernels atol/rtol 1e-5 (both sides compute in f32
and differ only in summation order); bf16 outputs one bf16 ulp (rtol
2**-7, atol 1e-6: the same f32 values rounded once, where a summation
order difference may round to the neighbouring value); du, an f32 sum of
B*T products, rtol 1e-5 plus 1e-5 of its largest magnitude; gradients
2e-5 (they add the dx/dW products over B*T rows). The fused path adds
the bias to x@W before the recurrence and the scan after the product
(as in JAX), so fused-vs-scan comparisons hold to 1e-5, not bit-equal.
The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_gpu.py and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_kernels as pk
from paddle_tpu.ops import rnn as JR
from paddle_tpu_torch.ops import cuda_kernels as ck
from paddle_tpu_torch.ops import rnn as R
from paddle_tpu_torch.ops import rnn_kernels as rk

ATOL = RTOL = 1e-5
GRAD_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6

# (B, T, H, lengths, nonzero h0): a batch that is no multiple of the JAX
# tile (B=5 with block_b 2 leaves a tail), lengths 0, 1 and T
CASES = [
    (5, 7, 6, [0, 1, 7, 3, 5], True),
    (4, 8, 16, [8, 8, 2, 1], False),
    (3, 5, 8, [5, 0, 1], True),
]


def _inputs(B, T, H, lens, state, seed=0):
    rs = np.random.RandomState(seed)
    G = 3 * H
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    return dict(xw=arr(B, T, G, scale=0.7), lengths=np.asarray(lens, np.int32),
                u=arr(H, G, scale=0.3), b=arr(G, scale=0.1),
                h0=arr(B, H, scale=0.5) if state
                else np.zeros((B, H), np.float32),
                g_out=arr(B, T, H), g_ht=arr(B, H))


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


def _close(got, want, atol=ATOL, rtol=RTOL, msg=""):
    np.testing.assert_allclose(_np32(got), _np32(want), atol=atol,
                               rtol=rtol, err_msg=msg)


DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def _tol(dname):
    return (ATOL, RTOL) if dname == "float32" else (BF16_ATOL, BF16_RTOL)


@pytest.mark.parametrize("dname,tdt,jdt", DTYPES)
@pytest.mark.parametrize("B,T,H,lens,state", CASES)
def test_plain_forward_matches_pallas_interpret(B, T, H, lens, state, dname,
                                                tdt, jdt):
    a = _inputs(B, T, H, lens, state)
    keys = ("xw", "lengths", "u", "b", "h0")
    want = pk.gru_sequence_fused(*(_j(a[k], jdt) for k in keys[:4]),
                                 h0=_j(a["h0"], jdt), block_b=2,
                                 interpret=True)
    got = rk.gru_sequence_fused(*(_t(a[k], tdt) for k in keys[:4]),
                                h0=_t(a["h0"], tdt))
    atol, rtol = _tol(dname)
    for name, g, w in zip(("out", "hT"), got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        _close(g, w, atol=atol, rtol=rtol, msg=name)
    for b, n in enumerate(lens):
        if n == 0:                   # JAX: state left at h0, out 0
            assert not got[0][b].any()
            assert torch.equal(got[1][b], _t(a["h0"], tdt)[b])


@pytest.mark.parametrize("dname,tdt,jdt", DTYPES)
@pytest.mark.parametrize("B,T,H,lens,state", CASES)
def test_plain_backward_matches_pallas_interpret(B, T, H, lens, state, dname,
                                                 tdt, jdt):
    a = _inputs(B, T, H, lens, state, seed=1)
    jx = {k: _j(a[k], jdt) for k in a}
    xw = jx["xw"] + jx["b"]                 # the kernel's xw: bias added
    out, _ = pk.gru_sequence_fused(xw, jx["lengths"], jx["u"], h0=jx["h0"],
                                   interpret=True)
    want = pk.gru_sequence_fused_bwd(xw, jx["lengths"], jx["u"], jx["h0"],
                                     out, jx["g_out"], jx["g_ht"], block_b=2,
                                     interpret=True)
    got = rk.gru_sequence_fused_bwd(
        _t(np.asarray(xw, np.float32), tdt), _t(a["lengths"]),
        _t(a["u"], tdt), _t(a["h0"], tdt),
        _t(np.asarray(jnp.asarray(out, jnp.float32)), tdt),
        _t(a["g_out"], tdt), _t(a["g_ht"], tdt))
    atol, rtol = _tol(dname)
    for name, g, w in zip(("dxw", "dh0"), got[:2], want[:2]):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        _close(g, w, atol=atol, rtol=rtol, msg=name)
    du_w = _np32(want[2])
    assert got[2].dtype == torch.float32
    _close(got[2], du_w, atol=1e-5 * np.abs(du_w).max(), rtol=1e-5,
           msg="du")


def test_wrappers_fill_defaults_and_check_routes():
    """b and h0 default as in JAX (no bias, zero state); ``route`` takes
    only None or "plain"; the kernels' argument check names the hidden
    widths it takes and refuses mixed dtypes; xw must be 3*H wide."""
    a = _inputs(2, 3, 6, [3, 1], False)
    full = rk.gru_sequence_fused(_t(a["xw"]), _t(a["lengths"]), _t(a["u"]),
                                 _t(np.zeros(18, np.float32)),
                                 _t(a["h0"]))
    bare = rk.gru_sequence_fused(_t(a["xw"]), _t(a["lengths"]), _t(a["u"]))
    for x, y in zip(full, bare):
        torch.testing.assert_close(x, y, atol=0, rtol=0)
    with pytest.raises(ValueError, match="route"):
        rk.gru_sequence_fused(_t(a["xw"]), _t(a["lengths"]), _t(a["u"]),
                              route="kernel")
    with pytest.raises(ValueError, match="3\\*H"):
        rk.gru_sequence_fused(_t(a["xw"])[..., :17], _t(a["lengths"]),
                              _t(a["u"]))
    xw, u, h0 = _t(a["xw"]), _t(a["u"]), _t(a["h0"])
    shapes = [("u", u, (6, 18)), ("h0", h0, (2, 6))]
    with pytest.raises(ValueError, match="multiple of 4"):
        rk._check_args("gru", xw, _t(a["lengths"]), 6, shapes)
    b8 = _inputs(2, 3, 8, [3, 1], False)
    xw8, u8 = _t(b8["xw"]), _t(b8["u"]).to(torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        rk._check_args("gru", xw8, _t(b8["lengths"]), 8,
                       [("u", u8, (8, 24))])


# ---------------------------------------------------------------------------
# gru and its gradients
# ---------------------------------------------------------------------------

def _seq_inputs(B, T, D, H, lens, state, seed=7):
    rs = np.random.RandomState(seed)
    arr = lambda *s, scale=1.0: (rs.randn(*s) * scale).astype(np.float32)
    return dict(x=arr(B, T, D), w=arr(D, 3 * H, scale=0.3),
                u=arr(H, 3 * H, scale=0.3), b=arr(3 * H, scale=0.1),
                h0=arr(B, H, scale=0.2) if state
                else np.zeros((B, H), np.float32),
                wo=arr(B, T, H), wh=arr(B, H),
                lens=np.asarray(lens, np.int32))


ARGS = ("x", "w", "u", "b", "h0")


def _jax_grads(a, path, reverse=False):
    """Grads of sum(out*wo) + sum(hT*wh) in JAX through ``path`` ("fused":
    the custom VJP over the Pallas kernels, in interpret mode off the TPU;
    "scan": autodiff of the masked scan)."""
    lens = jnp.asarray(a["lens"])

    def loss(x, w, u, b, h0):
        if path == "fused":
            out, ht = JR._gru_fused(x, lens, w, u, b, h0, 2, None)
        else:
            out, ht = JR.gru(x, lens, w, u, b, h0=h0, reverse=reverse,
                             fused=False)
        return jnp.sum(out * a["wo"]) + jnp.sum(ht * a["wh"])
    return jax.grad(loss, argnums=tuple(range(5)))(
        *(jnp.asarray(a[k]) for k in ARGS))


def _port_grads(a, fused, reverse=False):
    leaves = [_t(a[k]).requires_grad_(True) for k in ARGS]
    x, w, u, b, h0 = leaves
    out, ht = R.gru(x, _t(a["lens"]), w, u, b, h0, reverse=reverse,
                    fused=fused)
    loss = (out * _t(a["wo"])).sum() + (ht * _t(a["wh"])).sum()
    return torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("against", ["jax_fused_vjp", "jax_scan",
                                     "port_scan"])
@pytest.mark.parametrize("B,T,D,H,lens,state", [
    (5, 7, 4, 6, [0, 1, 7, 3, 5], True),
    (3, 8, 5, 8, [8, 4, 2], False),
])
def test_gru_fused_grads(B, T, D, H, lens, state, against):
    """dx, dw, du, db and dh0 of ``_GRUFused`` (the plain kernel versions
    on the CPU) against JAX's custom VJP, JAX's scan autodiff and autograd
    through the port's own scan."""
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
def test_gru_outputs_match_jax(reverse, fused):
    """Outputs and final state against JAX's masked scan, both directions;
    ``reverse=True`` rides the forward kernel through
    ``_reverse_within_length``."""
    a = _seq_inputs(5, 7, 4, 8, [0, 1, 7, 3, 5], True, seed=3)
    out_j, h_j = JR.gru(jnp.asarray(a["x"]), jnp.asarray(a["lens"]),
                        *(jnp.asarray(a[k]) for k in ARGS[1:4]),
                        h0=jnp.asarray(a["h0"]), reverse=reverse, fused=False)
    out, h = R.gru(_t(a["x"]), _t(a["lens"]), *(_t(a[k]) for k in ARGS[1:]),
                   reverse=reverse, fused=fused)
    _close(out, out_j, msg="out")
    _close(h, h_j, msg="hT")


def test_reverse_gru_grads_match_jax():
    a = _seq_inputs(4, 6, 3, 8, [6, 0, 2, 5], True, seed=4)
    want = _jax_grads(a, "scan", reverse=True)
    for name, g, w in zip(ARGS, _port_grads(a, fused=True, reverse=True),
                          want):
        _close(g, w, atol=GRAD_TOL, rtol=GRAD_TOL, msg=name)


def test_gru_runs_the_forward_kernel_without_autograd(monkeypatch):
    """With gradients off, or no input that needs one, ``gru`` calls the
    forward wrapper directly; under autograd it goes through
    ``_GRUFused``, whose backward calls the backward wrapper once."""
    calls = []
    real_f, real_b = R.gru_sequence_fused, R.gru_sequence_fused_bwd
    monkeypatch.setattr(R, "gru_sequence_fused",
                        lambda *a, **k: calls.append("fwd") or real_f(*a, **k))
    monkeypatch.setattr(R, "gru_sequence_fused_bwd",
                        lambda *a, **k: calls.append("bwd") or real_b(*a, **k))
    monkeypatch.setattr(R._GRUFused, "apply", _spy_apply(calls))
    a = _seq_inputs(2, 3, 4, 8, [3, 2], False)
    args = [_t(a[k]) for k in ARGS]
    R.gru(args[0], _t(a["lens"]), *args[1:])
    with torch.no_grad():
        R.gru(args[0], _t(a["lens"]), *[t.requires_grad_(True)
                                        for t in args[1:]])
    out, _ = R.gru(args[0], _t(a["lens"]), *args[1:])
    out.sum().backward()
    assert calls == ["fwd", "fwd", "apply", "fwd", "bwd"]


def _spy_apply(calls):
    real = R._GRUFused.apply

    def apply(*a):
        calls.append("apply")
        return real(*a)
    return apply


def test_gru_cell_bidirectional_and_simple_rnn_match_jax():
    rs = np.random.RandomState(9)
    B, T, D, H = 4, 6, 5, 8
    arr = lambda *s: (rs.randn(*s) * 0.4).astype(np.float32)
    xw, h, u, b = arr(B, 3 * H), arr(B, H), arr(H, 3 * H), arr(3 * H)
    for bias in (b, None):
        want = JR.gru_cell(jnp.asarray(xw), jnp.asarray(h), jnp.asarray(u),
                           None if bias is None else jnp.asarray(bias))
        _close(R.gru_cell(_t(xw), _t(h), _t(u),
                          None if bias is None else _t(bias)), want)

    x, lens = arr(B, T, D), np.asarray([6, 0, 1, 4], np.int32)
    pf = dict(w=arr(D, 3 * H), u=arr(H, 3 * H), b=arr(3 * H))
    pb = dict(w=arr(D, 3 * H), u=arr(H, 3 * H), b=arr(3 * H))
    jmap = lambda p: {k: jnp.asarray(v) for k, v in p.items()}
    tmap = lambda p: {k: _t(v) for k, v in p.items()}
    for merge in ("concat", "sum"):
        want = JR.bidirectional(JR.gru, jnp.asarray(x), jnp.asarray(lens),
                                jmap(pf), jmap(pb), merge=merge)
        got = R.bidirectional(R.gru, _t(x), _t(lens), tmap(pf), tmap(pb),
                              merge=merge)
        _close(got, want, msg=merge)
    with pytest.raises(ValueError, match="merge"):
        R.bidirectional(R.gru, _t(x), _t(lens), tmap(pf), tmap(pb),
                        merge="max")

    w, uu, bb, h0 = arr(D, H), arr(H, H), arr(H), arr(B, H)
    for reverse in (False, True):
        jw = JR.simple_rnn(jnp.asarray(x), jnp.asarray(lens), jnp.asarray(w),
                           jnp.asarray(uu), jnp.asarray(bb),
                           h0=jnp.asarray(h0), reverse=reverse)
        pw = R.simple_rnn(_t(x), _t(lens), _t(w), _t(uu), _t(bb),
                          h0=_t(h0), reverse=reverse)
        _close(pw[0], jw[0], msg="simple_rnn out")
        _close(pw[1], jw[1], msg="simple_rnn h")
    # w=None: x is already at the hidden width
    xh = arr(B, T, H)
    jw = JR.simple_rnn(jnp.asarray(xh), None, None, jnp.asarray(uu))
    pw = R.simple_rnn(_t(xh), None, None, _t(uu))
    _close(pw[0], jw[0], msg="simple_rnn w=None")


def test_gru_launch_counters_exist_and_stay_put_on_the_cpu():
    """The GRU kernels count under their own names; the plain versions
    the CPU runs launch nothing."""
    before = dict(ck.LAUNCHES)
    a = _seq_inputs(2, 3, 4, 8, [3, 2], False)
    R.gru(_t(a["x"]), _t(a["lens"]), *(_t(a[k]) for k in ARGS[1:]))
    assert {"gru_seq", "gru_seq_bwd"} <= set(ck.LAUNCHES)
    assert ck.LAUNCHES == before
