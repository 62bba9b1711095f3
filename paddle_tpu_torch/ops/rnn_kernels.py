"""LSTM sequence kernels of the text-classification training path — the
counterpart of the three LSTM bodies of ``paddle_tpu/ops/pallas_kernels.py``:

* :func:`lstm_sequence_fused` replaces ``_lstm_seq_kernel`` (inference
  forward) and, with ``save_cell=True``, ``_lstm_seq_train_kernel`` (the
  training forward, which also saves the cell sequence);
* :func:`lstm_sequence_fused_bwd` replaces ``_lstm_seq_bwd_kernel`` (the
  reverse recurrence of the backward).

Each wrapper launches its hand-written CUDA kernel (``csrc/lstm_seq.cu``,
``csrc/lstm_seq_bwd.cu``) for tensors on the card and takes the plain
PyTorch version beside it for tensors on the CPU, or when a caller asks
with ``route="plain"``. A kernel runs the whole sequence in one launch
and carries h and c in f32 from the first step to the last; the JAX
wrappers' ``block_b`` and ``chunk_t`` tile for VMEM and have no
counterpart here (in bf16, ``chunk_t`` rounds h and c to bf16 at each
chunk boundary, which the port never does).

The plain versions follow the op order of the JAX kernel bodies: all
arithmetic in f32, stores in the input dtype; gates i, f, g, o with
``forget_bias`` added to f before the sigmoid; step t of sample b is live
when ``t < lengths[b]``, and a dead step freezes the state and outputs 0.
Launches are counted in ``cuda_kernels.LAUNCHES`` under ``lstm_seq``,
``lstm_seq_train`` and ``lstm_seq_bwd``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .cuda_kernels import (LAUNCHES, _DTYPE_CODE, _check_float, _raise_on,
                           _route, _stream)

#: the kernels give each block this many hidden units: H must be a multiple
KERNEL_HIDDEN_MULTIPLE = 4
#: the C entries' code when the grid does not fit in one wave of the card,
#: or a block's slice of U does not fit its shared memory
#: (cudaErrorCooperativeLaunchTooLarge)
_TOO_LARGE = 720


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _defaults(xw, lengths, u, b, h0, c0):
    """Fill the optional arguments as the JAX wrapper does: zero bias and
    zero initial state in xw's dtype, lengths on xw's device."""
    B, T, G = xw.shape
    if G % 4:
        raise ValueError(f"xw last dim {G} must be 4*H (i/f/g/o gates)")
    H = G // 4
    if u.shape != (H, G):
        raise ValueError(f"u {tuple(u.shape)} is not [{H}, {G}]")
    z = lambda *shape: torch.zeros(shape, dtype=xw.dtype, device=xw.device)
    b = z(G) if b is None else b
    h0 = z(B, H) if h0 is None else h0
    c0 = z(B, H) if c0 is None else c0
    return lengths.to(xw.device), b, h0, c0


# ---------------------------------------------------------------------------
# forward (replaces _lstm_seq_kernel and _lstm_seq_train_kernel)
# ---------------------------------------------------------------------------

def lstm_sequence_fused_plain(xw, lengths, u, b, h0, c0, *,
                              forget_bias: float, save_cell: bool):
    """The op order of ``_lstm_seq_kernel`` / ``_lstm_seq_train_kernel``
    over [B, T, *] tensors: (out, hT, cT[, c_seq]) in xw's dtype."""
    B, T, G = xw.shape
    H = G // 4
    dt = xw.dtype
    u32, bias = _f32(u), _f32(b)
    lens = _f32(lengths)[:, None]
    h, c = _f32(h0), _f32(c0)
    outs, cells = [], []
    for t in range(T):
        gates = _f32(xw[:, t]) + h @ u32 + bias
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H] + forget_bias)
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_new = f * c + i * g
        h_new = o * torch.tanh(c_new)
        m = (t < lens).to(torch.float32)
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        outs.append((m * h).to(dt))
        if save_cell:
            cells.append(c.to(dt))
    res = (torch.stack(outs, dim=1), h.to(dt), c.to(dt))
    return res + (torch.stack(cells, dim=1),) if save_cell else res


def _check_lstm_args(name, xw, lengths, u, b, h0, c0, extra=()):
    """What the kernels take: contiguous f32 or bf16 tensors of one dtype,
    H a multiple of KERNEL_HIDDEN_MULTIPLE, lengths [B]."""
    B, T, G = xw.shape
    H = G // 4
    if H % KERNEL_HIDDEN_MULTIPLE:
        raise ValueError(f"{name}: hidden width {H} not taken by the kernel "
                         f"(a multiple of {KERNEL_HIDDEN_MULTIPLE})")
    shapes = [("u", u, (H, G)), ("b", b, (G,)), ("h0", h0, (B, H)),
              ("c0", c0, (B, H))] + list(extra)
    for arg, t, shape in [("xw", xw, (B, T, G))] + shapes:
        _check_float(f"{name} {arg}", t, xw.dtype)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} is not "
                             f"{list(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte "
                             "aligned")
    if lengths.shape != (B,):
        raise ValueError(f"{name}: lengths {tuple(lengths.shape)} != ({B},)")
    return lengths.to(dtype=torch.int32).contiguous()


def _raise_launch(err: int, name: str, B: int, H: int) -> None:
    if err == _TOO_LARGE:
        raise ValueError(
            f"{name}: B={B}, H={H} needs more blocks, or more shared memory "
            "per block, than the card holds at once (the kernel's grid "
            "barrier needs every block resident); split the batch")
    _raise_on(err, name)


def _lstm_sequence_fused_kernel(xw, lengths, u, b, h0, c0, forget_bias,
                                save_cell):
    B, T, G = xw.shape
    H = G // 4
    lens = _check_lstm_args("lstm_sequence_fused", xw, lengths, u, b, h0, c0)
    out = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    h_t = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    c_t = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    c_seq = torch.empty_like(out) if save_cell else None
    res = (out, h_t, c_t) + ((c_seq,) if save_cell else ())
    if B == 0 or T == 0:
        h_t.copy_(h0)
        c_t.copy_(c0)
        return res
    h_x = torch.empty((2, B, H), dtype=torch.float32, device=xw.device)
    lib = _build.load().lib
    entry = lib.paddle_lstm_seq_train if save_cell else lib.paddle_lstm_seq
    args = [xw.data_ptr(), lens.data_ptr(), u.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out.data_ptr(), h_t.data_ptr(),
            c_t.data_ptr()]
    if save_cell:
        args.append(c_seq.data_ptr())
    with torch.cuda.device(xw.device):
        err = entry(*args, h_x.data_ptr(), B, T, H, float(forget_bias),
                    _DTYPE_CODE[xw.dtype], _stream(xw.device))
    name = "lstm_seq_train" if save_cell else "lstm_seq"
    _raise_launch(err, name, B, H)
    LAUNCHES[name] += 1
    return res


def lstm_sequence_fused(xw: torch.Tensor, lengths: torch.Tensor,
                        u: torch.Tensor, b: Optional[torch.Tensor] = None,
                        h0: Optional[torch.Tensor] = None,
                        c0: Optional[torch.Tensor] = None, *,
                        forget_bias: float = 0.0, save_cell: bool = False,
                        route: Optional[str] = None):
    """Masked LSTM over a whole sequence — the
    ``pallas_kernels.lstm_sequence_fused`` contract: xw = x@W [B, T, 4H],
    lengths [B] int, u [H, 4H], b [4H], h0/c0 [B, H] (zeros when None) ->
    (out [B, T, H], hT [B, H], cT [B, H]) in xw's dtype, plus the
    post-mask cell sequence c_seq [B, T, H] when ``save_cell`` (the
    residual :func:`lstm_sequence_fused_bwd` consumes)."""
    lengths, b, h0, c0 = _defaults(xw, lengths, u, b, h0, c0)
    if _route(route, xw, lengths, u, b, h0, c0) == "plain":
        return lstm_sequence_fused_plain(xw, lengths, u, b, h0, c0,
                                         forget_bias=forget_bias,
                                         save_cell=save_cell)
    return _lstm_sequence_fused_kernel(xw, lengths, u, b, h0, c0,
                                       forget_bias, save_cell)


# ---------------------------------------------------------------------------
# backward (replaces _lstm_seq_bwd_kernel)
# ---------------------------------------------------------------------------

def lstm_sequence_fused_bwd_plain(xw, lengths, u, b, h0, c0, out_seq, c_seq,
                                  g_out, g_ht, g_ct, *, forget_bias: float):
    """The op order of ``_lstm_seq_bwd_kernel``: gates recomputed from xw
    and the saved masked output (h0 at t = 0), the adjoints in f32, dU
    summed over steps in f32. -> (dxw [B, T, 4H], dh0, dc0 [B, H]) in xw's
    dtype and du [H, 4H] f32."""
    B, T, G = xw.shape
    H = G // 4
    dt = xw.dtype
    u32, bias = _f32(u), _f32(b)
    lens = _f32(lengths)[:, None]
    h0, c0 = _f32(h0), _f32(c0)
    dh, dc = _f32(g_ht), _f32(g_ct)
    du = torch.zeros((H, G), dtype=torch.float32, device=xw.device)
    dxw = torch.empty_like(xw)
    for t in reversed(range(T)):
        h_prev = _f32(out_seq[:, t - 1]) if t > 0 else h0
        c_prev = _f32(c_seq[:, t - 1]) if t > 0 else c0
        gates = _f32(xw[:, t]) + h_prev @ u32 + bias
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H] + forget_bias)
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c_cur = f * c_prev + i * g
        tc = torch.tanh(c_cur)
        m = (t < lens).to(torch.float32)
        dh_t = dh + m * _f32(g_out[:, t])
        dhp = m * dh_t
        dct = m * dc + dhp * o * (1.0 - tc * tc)
        do_ = dhp * tc
        dgi = (dct * g) * i * (1.0 - i)
        dgf = (dct * c_prev) * f * (1.0 - f)
        dgg = (dct * i) * (1.0 - g * g)
        dgo = do_ * o * (1.0 - o)
        dgates = torch.cat([dgi, dgf, dgg, dgo], dim=1)
        dxw[:, t] = dgates.to(dt)
        du = du + h_prev.t() @ dgates
        dh = (1.0 - m) * dh_t + dgates @ u32.t()
        dc = (1.0 - m) * dc + dct * f
    return dxw, dh.to(dt), dc.to(dt), du


def _lstm_sequence_fused_bwd_kernel(xw, lengths, u, b, h0, c0, out_seq, c_seq,
                                    g_out, g_ht, g_ct, forget_bias):
    B, T, G = xw.shape
    H = G // 4
    seq, vec = (B, T, H), (B, H)
    lens = _check_lstm_args(
        "lstm_sequence_fused_bwd", xw, lengths, u, b, h0, c0,
        [("out_seq", out_seq, seq), ("c_seq", c_seq, seq),
         ("g_out", g_out, seq), ("g_ht", g_ht, vec), ("g_ct", g_ct, vec)])
    dxw = torch.empty_like(xw)
    dh0 = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    dc0 = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    du = torch.empty((H, G), dtype=torch.float32, device=xw.device)
    if B == 0 or T == 0:
        dh0.copy_(g_ht)
        dc0.copy_(g_ct)
        du.zero_()
        return dxw, dh0, dc0, du
    lib = _build.load().lib
    tiles = -(-B // lib.paddle_lstm_batch_tile())
    dg_x = torch.empty((2, B, G), dtype=torch.float32, device=xw.device)
    du_part = torch.empty((tiles, H, G), dtype=torch.float32,
                          device=xw.device) if tiles > 1 else None
    with torch.cuda.device(xw.device):
        err = lib.paddle_lstm_seq_bwd(
            xw.data_ptr(), lens.data_ptr(), u.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out_seq.data_ptr(),
            c_seq.data_ptr(), g_out.data_ptr(), g_ht.data_ptr(),
            g_ct.data_ptr(), dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            du.data_ptr(), dg_x.data_ptr(),
            None if du_part is None else du_part.data_ptr(), B, T, H,
            float(forget_bias), _DTYPE_CODE[xw.dtype], _stream(xw.device))
    _raise_launch(err, "lstm_seq_bwd", B, H)
    LAUNCHES["lstm_seq_bwd"] += 1
    return dxw, dh0, dc0, du


def lstm_sequence_fused_bwd(xw, lengths, u, b, h0, c0, out_seq, c_seq, g_out,
                            g_ht, g_ct, *, forget_bias: float = 0.0,
                            route: Optional[str] = None):
    """Backward of :func:`lstm_sequence_fused` from its ``save_cell``
    residuals — the ``pallas_kernels.lstm_sequence_fused_bwd`` contract:
    -> (dxw [B, T, 4H], dh0 [B, H], dc0 [B, H]) in xw's dtype and
    du [H, 4H] f32."""
    lengths = lengths.to(xw.device)
    if _route(route, xw, lengths, u, b, h0, c0, out_seq, c_seq, g_out, g_ht,
              g_ct) == "plain":
        return lstm_sequence_fused_bwd_plain(
            xw, lengths, u, b, h0, c0, out_seq, c_seq, g_out, g_ht, g_ct,
            forget_bias=forget_bias)
    return _lstm_sequence_fused_bwd_kernel(xw, lengths, u, b, h0, c0, out_seq,
                                           c_seq, g_out, g_ht, g_ct,
                                           forget_bias)
