"""Recurrent ops — the counterpart of ``paddle_tpu/ops/rnn.py``: the
LSTM, the GRU, ``bidirectional``, ``simple_rnn`` and the peephole step
``lstm_peephole_step``.

The input projection x@W of all steps is one [B*T, D] x [D, G] product
before the recurrence; only h@U runs step by step. Every step is masked:
for t >= length the state carries through unchanged and the output is 0.
LSTM gate order i, f, g (candidate), o; GRU gate order z (update), r
(reset), candidate, with U packed [u_z | u_r | u_c].

``lstm`` and ``gru`` run the recurrence through the whole-sequence
kernels of ``ops/rnn_kernels.py`` (``fused=True``, the default): under
autograd the backward is the hand-written reverse recurrence, bound by
:class:`_LSTMFused` / :class:`_GRUFused` in place of the JAX custom VJPs
``_lstm_fused`` / ``_gru_fused`` (the LSTM's training forward also saves
the cell sequence); with gradients off they run the forward kernel only.
``fused=False`` runs the step-by-step masked loop that autograd
differentiates, as the reference. The fused GRU adds the bias to x@W
before the kernel and the loop adds it after the product (as in JAX), so
the two round differently in the last bits.

Routing follows JAX's (``_fused_plan``, ``_fused_bwd_plan``), with the
card's residency in place of VMEM (``rnn_kernels.plan_route``): before
the forward, ``lstm``/``gru`` take one route for the forward and, under
autograd, one for the backward — one launch over the batch, one launch
a row tile, or the step loop where no tile fits (JAX's ``_lstm_scan``
and ``lax.scan``). A backward with no tile replays the step loop under
autograd, as JAX's ``_lstm_fused_bwd`` replays ``_lstm_scan`` under
``jax.vjp``. Tensors on the CPU take the kernels' plain versions over the
whole batch, unless ``rnn_kernels.forced_limits`` asks for the card's
routes there.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core.lod import sequence_mask
from .rnn_kernels import (count_route, gru_sequence_fused,
                          gru_sequence_fused_bwd, lstm_sequence_fused,
                          lstm_sequence_fused_bwd, route_for)


class LSTMState(NamedTuple):
    h: torch.Tensor
    c: torch.Tensor


def lstm_cell(xw: torch.Tensor, state: LSTMState, u: torch.Tensor,
              b: Optional[torch.Tensor], forget_bias: float = 0.0
              ) -> LSTMState:
    """One LSTM step. xw: precomputed x@W [B, 4H]; u: [H, 4H]."""
    h, c = state
    gates = xw + torch.matmul(h, u)
    if b is not None:
        gates = gates + b
    i, f, g, o = gates.chunk(4, dim=-1)
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    g = torch.tanh(g)
    o = torch.sigmoid(o)
    c_new = f * c + i * g
    return LSTMState(o * torch.tanh(c_new), c_new)


def gru_cell(xw: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
             b: Optional[torch.Tensor]) -> torch.Tensor:
    """One GRU step (gate order z, r, candidate). xw: x@W [B, 3H];
    u: [H, 3H] packed [u_z | u_r | u_c]; the bias added after the
    products."""
    xz, xr, xc = xw.chunk(3, dim=-1)
    uz, ur, uc = u.chunk(3, dim=-1)
    bz = br = bc = 0.0
    if b is not None:
        bz, br, bc = b.chunk(3, dim=-1)
    z = torch.sigmoid(xz + torch.matmul(h, uz) + bz)
    r = torch.sigmoid(xr + torch.matmul(h, ur) + br)
    c = torch.tanh(xc + torch.matmul(r * h, uc) + bc)
    return (1.0 - z) * h + z * c


def _xw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, T, D = x.shape
    return torch.matmul(x.reshape(B * T, D), w).reshape(B, T, -1)


def _reverse_within_length(x: torch.Tensor, lengths: torch.Tensor
                           ) -> torch.Tensor:
    """Flip each sample's first ``length`` steps along time; positions at
    or past the length become zero. x: [B, T, ...].

    A masked reverse scan over a right-padded batch is a forward scan over
    the within-length-flipped input, with the output flipped back, so
    ``reverse=True`` rides the forward kernels. Plain gather and where:
    autograd flows through it around :class:`_LSTMFused`."""
    T = x.shape[1]
    idx = (lengths.to(device=x.device, dtype=torch.long)[:, None] - 1
           - torch.arange(T, device=x.device)[None, :])
    ok = idx >= 0
    idx = idx.clamp(0, T - 1)
    tail = (1,) * (x.dim() - 2)
    out = torch.gather(x, 1, idx.reshape(idx.shape + tail).expand(x.shape))
    return torch.where(ok.reshape(ok.shape + tail), out,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _mask(lengths, B, T, x):
    """[B, T] step masks of ``lengths`` (all ones when None)."""
    return (sequence_mask(lengths.to(x.device), T, x.dtype)
            if lengths is not None
            else torch.ones((B, T), dtype=x.dtype, device=x.device))


def _lstm_scan(x, lengths, w, u, b, h0, c0, reverse, forget_bias):
    """The step-by-step masked LSTM (``lax.scan`` in JAX, a loop here)."""
    B, T, _ = x.shape
    H = u.shape[0]
    xw = _xw(x, w)
    mask = _mask(lengths, B, T, x)
    h = h0 if h0 is not None else x.new_zeros((B, H))
    c = c0 if c0 is not None else x.new_zeros((B, H))
    ys = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        new = lstm_cell(xw[:, t], LSTMState(h, c), u, b, forget_bias)
        m = mask[:, t, None]
        h = m * new.h + (1.0 - m) * h
        c = m * new.c + (1.0 - m) * c
        ys[t] = m * h
    return torch.stack(ys, dim=1), LSTMState(h, c)


class _LSTMFused(torch.autograd.Function):
    """The whole-sequence LSTM under autograd — the counterpart of the JAX
    custom VJP ``_lstm_fused``: the forward runs the training kernel (it
    saves the cell sequence); the backward runs the reverse-recurrence
    kernel over the whole sequence, then dx, dW and db as f32 products
    outside it (rnn.py:388-394 of the JAX package)."""

    @staticmethod
    def forward(ctx, x, lens, w, u, b, h0, c0, forget_bias, route, plans):
        xw = _xw(x, w)
        out, h_t, c_t, c_seq = lstm_sequence_fused(
            xw, lens, u, b, h0, c0, forget_bias=forget_bias, save_cell=True,
            route=route, plan=plans[0])
        ctx.save_for_backward(x, lens, w, u, b, h0, c0, xw, out, c_seq)
        ctx.forget_bias, ctx.route, ctx.bwd = forget_bias, route, plans[1]
        return out, h_t, c_t

    @staticmethod
    def backward(ctx, g_out, g_ht, g_ct):
        x, lens, w, u, b, h0, c0, xw, out, c_seq = ctx.saved_tensors
        if ctx.bwd is not None and ctx.bwd.kind == "scan":
            count_route("lstm_seq_bwd", "scan")

            def replay(x, w, u, b, h0, c0):
                out, state = _lstm_scan(x, lens, w, u, b, h0, c0, False,
                                        ctx.forget_bias)
                return out, state.h, state.c

            grads = _replay(replay, (x, w, u, b, h0, c0),
                            (g_out, g_ht, g_ct))
            return grads[:1] + (None,) + grads[1:] + (None, None, None)
        dxw, dh0, dc0, du = lstm_sequence_fused_bwd(
            xw, lens, u, b, h0, c0, out, c_seq, g_out.contiguous(),
            g_ht.contiguous(), g_ct.contiguous(),
            forget_bias=ctx.forget_bias, route=ctx.route, plan=ctx.bwd)
        B, T, D = x.shape
        dxw2 = dxw.reshape(B * T, -1).to(torch.float32)
        dx = torch.matmul(dxw2, w.t().to(torch.float32)).reshape(x.shape)
        dw = torch.matmul(x.reshape(B * T, D).t().to(torch.float32), dxw2)
        db = dxw2.sum(0)
        return (dx.to(x.dtype), None, dw.to(w.dtype), du.to(u.dtype),
                db.to(b.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype), None,
                None, None)


def _replay(fn, inputs, cotangents):
    """The gradients of ``fn(*inputs)`` (a tuple of outputs) against
    ``cotangents``, by running fn again under autograd: the backward of a
    training call whose backward kernel no tile of fits (JAX's
    ``jax.vjp`` of ``_lstm_scan`` in ``_lstm_fused_bwd``)."""
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_() for t in inputs)
        return torch.autograd.grad(fn(*leaves), leaves, cotangents,
                                   allow_unused=True)


def _training(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _plans(fwd_name: str, bwd_name: str, xk, H, route, training):
    """The forward's route and, in training, the backward's, decided
    together before anything runs (None where unplanned)."""
    fwd = route_for(fwd_name, xk, H, route)
    bwd = route_for(bwd_name, xk, H, route) if training else None
    return fwd, bwd


def lstm(x: torch.Tensor, lengths: Optional[torch.Tensor], w: torch.Tensor,
         u: torch.Tensor, b: Optional[torch.Tensor] = None,
         h0: Optional[torch.Tensor] = None, c0: Optional[torch.Tensor] = None,
         reverse: bool = False, forget_bias: float = 0.0, fused: bool = True,
         route: Optional[str] = None) -> Tuple[torch.Tensor, LSTMState]:
    """Full-sequence LSTM. x: [B, T, D]; w: [D, 4H]; u: [H, 4H].

    Returns (outputs [B, T, H], final LSTMState); for t >= length the state
    carries through and the output is zero. ``fused=True`` runs the
    whole-sequence kernels (``route="plain"`` asks for their plain
    versions on any device); ``fused=False`` the step-by-step loop."""
    if not fused:
        return _lstm_scan(x, lengths, w, u, b, h0, c0, reverse, forget_bias)
    B, T, _ = x.shape
    H = u.shape[0]
    training = _training(x, w, u, *(t for t in (b, h0, c0) if t is not None))
    fwd, bwd = _plans("lstm_seq_train" if training else "lstm_seq",
                      "lstm_seq_bwd", x, H, route, training)
    if fwd is not None and fwd.kind == "scan":
        count_route("lstm_seq_train" if training else "lstm_seq", "scan")
        if training:
            count_route("lstm_seq_bwd", "scan")
        return _lstm_scan(x, lengths, w, u, b, h0, c0, reverse, forget_bias)
    lens = (lengths.to(x.device) if lengths is not None
            else torch.full((B,), T, dtype=torch.int32, device=x.device))
    b = b if b is not None else x.new_zeros((4 * H,))
    h0 = h0 if h0 is not None else x.new_zeros((B, H))
    c0 = c0 if c0 is not None else x.new_zeros((B, H))
    xk = _reverse_within_length(x, lens) if reverse else x
    if training:
        out, h_t, c_t = _LSTMFused.apply(xk, lens, w, u, b, h0, c0,
                                         forget_bias, route, (fwd, bwd))
    else:
        out, h_t, c_t = lstm_sequence_fused(_xw(xk, w), lens, u, b, h0, c0,
                                            forget_bias=forget_bias,
                                            route=route, plan=fwd)
    if reverse:
        out = _reverse_within_length(out, lens)
    return out, LSTMState(h_t, c_t)


def _masked_scan(step, xw, mask, h, reverse):
    """``h_t = m * step(xw_t, h) + (1 - m) * h``, output ``m * h_t``, over
    the steps of xw [B, T, ...] (``lax.scan`` with the step masks in JAX,
    a loop here). Returns (outputs [B, T, H], final h)."""
    T = xw.shape[1]
    ys = [None] * T
    for t in (reversed(range(T)) if reverse else range(T)):
        m = mask[:, t, None]
        h = m * step(xw[:, t], h) + (1.0 - m) * h
        ys[t] = m * h
    return torch.stack(ys, dim=1), h


class _GRUFused(torch.autograd.Function):
    """The whole-sequence GRU under autograd — the counterpart of the JAX
    custom VJP ``_gru_fused``: the forward computes xw = x@W + b and runs
    the forward kernel; the backward runs the reverse-recurrence kernel
    over the whole sequence, then dx, dW and db as f32 products outside it
    (rnn.py:512-519 of the JAX package; db is the sum of dxw, since the
    bias rides in xw)."""

    @staticmethod
    def forward(ctx, x, lens, w, u, b, h0, route, plans):
        xw = _xw(x, w) + b
        out, h_t = gru_sequence_fused(xw, lens, u, None, h0, route=route,
                                      plan=plans[0])
        ctx.save_for_backward(x, lens, w, u, b, h0, xw, out)
        ctx.route, ctx.bwd = route, plans[1]
        return out, h_t

    @staticmethod
    def backward(ctx, g_out, g_ht):
        x, lens, w, u, b, h0, xw, out = ctx.saved_tensors
        if ctx.bwd is not None and ctx.bwd.kind == "scan":
            count_route("gru_seq_bwd", "scan")
            T = x.shape[1]
            grads = _replay(
                lambda x, w, u, b, h0: _masked_scan(
                    lambda xw_t, h_: gru_cell(xw_t, h_, u, b), _xw(x, w),
                    _mask(lens, x.shape[0], T, x), h0, False),
                (x, w, u, b, h0), (g_out, g_ht))
            return grads[:1] + (None,) + grads[1:] + (None, None)
        dxw, dh0, du = gru_sequence_fused_bwd(
            xw, lens, u, h0, out, g_out.contiguous(), g_ht.contiguous(),
            route=ctx.route, plan=ctx.bwd)
        B, T, D = x.shape
        dxw2 = dxw.reshape(B * T, -1).to(torch.float32)
        dx = torch.matmul(dxw2, w.t().to(torch.float32)).reshape(x.shape)
        dw = torch.matmul(x.reshape(B * T, D).t().to(torch.float32), dxw2)
        db = dxw2.sum(0)
        return (dx.to(x.dtype), None, dw.to(w.dtype), du.to(u.dtype),
                db.to(b.dtype), dh0.to(h0.dtype), None, None)


def gru(x: torch.Tensor, lengths: Optional[torch.Tensor], w: torch.Tensor,
        u: torch.Tensor, b: Optional[torch.Tensor] = None,
        h0: Optional[torch.Tensor] = None, reverse: bool = False,
        fused: bool = True, route: Optional[str] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence GRU. x: [B, T, D]; w: [D, 3H]; u: [H, 3H].

    Returns (outputs [B, T, H], final h [B, H]); for t >= length the state
    carries through and the output is zero. ``fused=True`` runs the
    whole-sequence kernels (``route="plain"`` asks for their plain
    versions on any device), ``reverse=True`` through the forward kernel
    on the within-length flipped input; ``fused=False`` the step-by-step
    loop."""
    B, T, _ = x.shape
    H = u.shape[0]
    training = fused and _training(
        x, w, u, *(t for t in (b, h0) if t is not None))
    fwd, bwd = (_plans("gru_seq", "gru_seq_bwd", x, H, route, training)
                if fused else (None, None))
    if fwd is not None and fwd.kind == "scan":
        count_route("gru_seq", "scan")
        if training:
            count_route("gru_seq_bwd", "scan")
        fused = False
    if not fused:
        h = h0 if h0 is not None else x.new_zeros((B, H))
        return _masked_scan(lambda xw_t, h_: gru_cell(xw_t, h_, u, b),
                            _xw(x, w), _mask(lengths, B, T, x), h, reverse)
    lens = (lengths.to(x.device) if lengths is not None
            else torch.full((B,), T, dtype=torch.int32, device=x.device))
    b = b if b is not None else x.new_zeros((3 * H,))
    h0 = h0 if h0 is not None else x.new_zeros((B, H))
    xk = _reverse_within_length(x, lens) if reverse else x
    if training:
        out, h_t = _GRUFused.apply(xk, lens, w, u, b, h0, route, (fwd, bwd))
    else:
        out, h_t = gru_sequence_fused(_xw(xk, w), lens, u, b, h0,
                                      route=route, plan=fwd)
    if reverse:
        out = _reverse_within_length(out, lens)
    return out, h_t


def lstm_peephole_step(xw: torch.Tensor, c_prev: torch.Tensor,
                       w_peep: torch.Tensor, b: Optional[torch.Tensor] = None,
                       forget_bias: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step with pre-projected gates and peephole connections
    (the reference's LstmStepLayer): xw [B, 4H] packed (i, f, c, o),
    w_peep [3, H] packed (ci, cf, co); i and f peep at c_prev, o at the
    new cell. Returns (h, c)."""
    H = c_prev.shape[-1]
    gi, gf, gc, go = xw.split(H, dim=-1)
    if b is not None:
        bi, bf, bc, bo = b.split(H, dim=-1)
        gi, gf, gc, go = gi + bi, gf + bf, gc + bc, go + bo
    i = torch.sigmoid(gi + c_prev * w_peep[0])
    f = torch.sigmoid(gf + c_prev * w_peep[1] + forget_bias)
    c = f * c_prev + i * torch.tanh(gc)
    o = torch.sigmoid(go + c * w_peep[2])
    return o * torch.tanh(c), c


def bidirectional(rnn_fn: Callable, x, lengths, fwd_params: dict,
                  bwd_params: dict, merge: str = "concat"):
    """Run ``rnn_fn`` forward and with ``reverse=True`` and merge the two
    output sequences ("concat" on the last axis, or "sum")."""
    out_f, _ = rnn_fn(x, lengths, reverse=False, **fwd_params)
    out_b, _ = rnn_fn(x, lengths, reverse=True, **bwd_params)
    if merge == "concat":
        return torch.cat([out_f, out_b], dim=-1)
    if merge == "sum":
        return out_f + out_b
    raise ValueError(f"unknown merge '{merge}'")


def simple_rnn(x: torch.Tensor, lengths: Optional[torch.Tensor],
               w: Optional[torch.Tensor], u: torch.Tensor,
               b: Optional[torch.Tensor] = None, act: Callable = torch.tanh,
               h0: Optional[torch.Tensor] = None, reverse: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vanilla masked RNN, h' = act(x@W + h@U + b). ``w=None``: x is
    already projected to the hidden width and only U applies."""
    B, T, _ = x.shape
    H = u.shape[0]
    xw = x if w is None else _xw(x, w)
    h = h0 if h0 is not None else x.new_zeros((B, H))
    return _masked_scan(
        lambda xw_t, h_: act(xw_t + torch.matmul(h_, u)
                             + (b if b is not None else 0.0)),
        xw, _mask(lengths, B, T, x), h, reverse)
