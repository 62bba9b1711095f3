"""Recurrent ops — the LSTM part of ``paddle_tpu/ops/rnn.py``.

The input projection x@W of all steps is one [B*T, D] x [D, 4H] product
before the recurrence; only h@U runs step by step. Every step is masked:
for t >= length the state carries through unchanged and the output is 0.
Gate order i, f, g (candidate), o.

``lstm`` runs the recurrence through the whole-sequence kernels of
``ops/rnn_kernels.py`` (``fused=True``, the default): in training the
forward saves the cell sequence and the backward is the hand-written
reverse recurrence, bound by :class:`_LSTMFused` in place of the JAX
custom VJP ``_lstm_fused``; with gradients off it runs the inference
kernel. ``fused=False`` runs :func:`_lstm_scan`, the step-by-step loop
that autograd differentiates, as the reference.

The JAX routing by a VMEM plan (``_fused_plan``, ``plan_is_legal``,
``chunk_t``, the 15.5 MB VMEM model) sets nothing on the card: the CUDA
kernels run all T steps in one launch, so tensors on the card always go
to the kernels, and tensors on the CPU to the kernels' plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.lod import sequence_mask
from .rnn_kernels import lstm_sequence_fused, lstm_sequence_fused_bwd


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


def _lstm_scan(x, lengths, w, u, b, h0, c0, reverse, forget_bias):
    """The step-by-step masked LSTM (``lax.scan`` in JAX, a loop here)."""
    B, T, _ = x.shape
    H = u.shape[0]
    xw = _xw(x, w)
    mask = (sequence_mask(lengths.to(x.device), T, x.dtype)
            if lengths is not None
            else torch.ones((B, T), dtype=x.dtype, device=x.device))
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
    def forward(ctx, x, lens, w, u, b, h0, c0, forget_bias, route):
        xw = _xw(x, w)
        out, h_t, c_t, c_seq = lstm_sequence_fused(
            xw, lens, u, b, h0, c0, forget_bias=forget_bias, save_cell=True,
            route=route)
        ctx.save_for_backward(x, lens, w, u, b, h0, c0, xw, out, c_seq)
        ctx.forget_bias, ctx.route = forget_bias, route
        return out, h_t, c_t

    @staticmethod
    def backward(ctx, g_out, g_ht, g_ct):
        x, lens, w, u, b, h0, c0, xw, out, c_seq = ctx.saved_tensors
        dxw, dh0, dc0, du = lstm_sequence_fused_bwd(
            xw, lens, u, b, h0, c0, out, c_seq, g_out.contiguous(),
            g_ht.contiguous(), g_ct.contiguous(),
            forget_bias=ctx.forget_bias, route=ctx.route)
        B, T, D = x.shape
        dxw2 = dxw.reshape(B * T, -1).to(torch.float32)
        dx = torch.matmul(dxw2, w.t().to(torch.float32)).reshape(x.shape)
        dw = torch.matmul(x.reshape(B * T, D).t().to(torch.float32), dxw2)
        db = dxw2.sum(0)
        return (dx.to(x.dtype), None, dw.to(w.dtype), du.to(u.dtype),
                db.to(b.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype), None,
                None)


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
    lens = (lengths.to(x.device) if lengths is not None
            else torch.full((B,), T, dtype=torch.int32, device=x.device))
    b = b if b is not None else x.new_zeros((4 * H,))
    h0 = h0 if h0 is not None else x.new_zeros((B, H))
    c0 = c0 if c0 is not None else x.new_zeros((B, H))
    xk = _reverse_within_length(x, lens) if reverse else x
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xk, w, u, b, h0, c0)):
        out, h_t, c_t = _LSTMFused.apply(xk, lens, w, u, b, h0, c0,
                                         forget_bias, route)
    else:
        out, h_t, c_t = lstm_sequence_fused(_xw(xk, w), lens, u, b, h0, c0,
                                            forget_bias=forget_bias,
                                            route=route)
    if reverse:
        out = _reverse_within_length(out, lens)
    return out, LSTMState(h_t, c_t)
