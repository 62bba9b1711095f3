"""Recurrent sequence kernels — the counterpart of the LSTM and GRU bodies
of ``paddle_tpu/ops/pallas_kernels.py``:

* :func:`lstm_sequence_fused` replaces ``_lstm_seq_kernel`` (inference
  forward) and, with ``save_cell=True``, ``_lstm_seq_train_kernel`` (the
  training forward, which also saves the cell sequence);
* :func:`lstm_sequence_fused_bwd` replaces ``_lstm_seq_bwd_kernel`` (the
  reverse recurrence of the backward);
* :func:`gru_sequence_fused` replaces ``_gru_seq_kernel`` (the GRU
  forward, in training and inference alike: its backward needs only the
  outputs);
* :func:`gru_sequence_fused_bwd` replaces ``_gru_seq_bwd_kernel``.

Each wrapper launches its hand-written CUDA kernel (``csrc/lstm_seq.cu``,
``csrc/lstm_seq_bwd.cu``, ``csrc/gru_seq.cu``, ``csrc/gru_seq_bwd.cu``)
for tensors on the card and takes the plain
PyTorch version beside it for tensors on the CPU, or when a caller asks
with ``route="plain"``. A kernel runs the whole sequence in one launch
and carries h and c in f32 from the first step to the last; the JAX
wrappers' ``block_b`` and ``chunk_t`` tile for VMEM and have no
counterpart here (in bf16, ``chunk_t`` rounds h and c to bf16 at each
chunk boundary, which the port never does).

The plain versions follow the op order of the JAX kernel bodies: all
arithmetic in f32, stores in the input dtype; LSTM gates i, f, g, o with
``forget_bias`` added to f before the sigmoid; GRU gates z, r, candidate
with U packed [u_z | u_r | u_c] and the bias added to xw before the
recurrence; step t of sample b is live when ``t < lengths[b]``, and a dead
step freezes the state and outputs 0. Launches are counted in
``cuda_kernels.LAUNCHES`` under ``lstm_seq``, ``lstm_seq_train``,
``lstm_seq_bwd``, ``gru_seq`` and ``gru_seq_bwd``.

The kernels share one grid partition (4 hidden units x 32 batch rows a
block, every block resident for the grid barriers): a shape whose grid
does not fit the card at once raises ``ValueError`` ("split the batch"),
as does a hidden width that is not a multiple of 4.
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
    """What the LSTM kernels take (see :func:`_check_args`)."""
    B, T, G = xw.shape
    H = G // 4
    return _check_args(name, xw, lengths, H, [
        ("u", u, (H, G)), ("b", b, (G,)), ("h0", h0, (B, H)),
        ("c0", c0, (B, H))] + list(extra))


def _check_args(name, xw, lengths, H, shapes):
    """What the kernels take: contiguous, 16-byte aligned f32 or bf16
    tensors of xw's dtype with the (name, tensor, shape) ``shapes``, H a
    multiple of KERNEL_HIDDEN_MULTIPLE, lengths [B]. Returns the lengths
    as contiguous int32."""
    B, T, G = xw.shape
    if H % KERNEL_HIDDEN_MULTIPLE:
        raise ValueError(f"{name}: hidden width {H} not taken by the kernel "
                         f"(a multiple of {KERNEL_HIDDEN_MULTIPLE})")
    for arg, t, shape in [("xw", xw, (B, T, G))] + list(shapes):
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
    # f32 scratch: the recomputed gates of every step [T, B, 4H], which the
    # kernel overwrites with the gate cotangents; the blocks' partials of
    # dh, two steps' worth [2, H / 4, B, H]; the batch tiles' dU partials
    f32 = dict(dtype=torch.float32, device=xw.device)
    gates = torch.empty((T, B, G), **f32)
    dh_part = torch.empty((2, H // 4, B, H), **f32)
    du_part = torch.empty((tiles, H, G), **f32) if tiles > 1 else None
    with torch.cuda.device(xw.device):
        err = lib.paddle_lstm_seq_bwd(
            xw.data_ptr(), lens.data_ptr(), u.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out_seq.data_ptr(),
            c_seq.data_ptr(), g_out.data_ptr(), g_ht.data_ptr(),
            g_ct.data_ptr(), dxw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            du.data_ptr(), gates.data_ptr(), dh_part.data_ptr(),
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


# ---------------------------------------------------------------------------
# GRU forward (replaces _gru_seq_kernel)
# ---------------------------------------------------------------------------

def _gru_gates(xw_t, h, u32, H):
    """z, r, r*h and c of one step in the JAX kernel body's op order (f32;
    u32 packed [u_z | u_r | u_c], the bias already in xw_t)."""
    z = torch.sigmoid(xw_t[:, :H] + h @ u32[:, :H])
    r = torch.sigmoid(xw_t[:, H:2 * H] + h @ u32[:, H:2 * H])
    rh = r * h
    c = torch.tanh(xw_t[:, 2 * H:] + rh @ u32[:, 2 * H:])
    return z, r, rh, c


def gru_sequence_fused_plain(xw, lengths, u, h0):
    """The op order of ``_gru_seq_kernel`` over [B, T, 3H] tensors (the
    bias already added to xw): (out [B, T, H], hT [B, H]) in xw's dtype,
    h carried in f32."""
    B, T, G = xw.shape
    H = G // 3
    dt = xw.dtype
    u32 = _f32(u)
    lens = _f32(lengths)[:, None]
    h = _f32(h0)
    outs = []
    for t in range(T):
        z, _, _, c = _gru_gates(_f32(xw[:, t]), h, u32, H)
        h_new = (1.0 - z) * h + z * c
        m = (t < lens).to(torch.float32)
        h = m * h_new + (1.0 - m) * h
        outs.append((m * h).to(dt))
    return torch.stack(outs, dim=1), h.to(dt)


def _gru_shapes(xw, u):
    B, T, G = xw.shape
    if G % 3:
        raise ValueError(f"xw last dim {G} must be 3*H (z/r/candidate gates)")
    H = G // 3
    if tuple(u.shape) != (H, G):
        raise ValueError(f"u {tuple(u.shape)} is not [{H}, {G}]")
    return B, T, H


def _gru_sequence_fused_kernel(xw, lengths, u, h0):
    B, T, H = _gru_shapes(xw, u)
    lens = _check_args("gru_sequence_fused", xw, lengths, H,
                       [("u", u, (H, 3 * H)), ("h0", h0, (B, H))])
    out = torch.empty((B, T, H), dtype=xw.dtype, device=xw.device)
    h_t = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    if B == 0 or T == 0:
        h_t.copy_(h0)
        return out, h_t
    # the two f32 exchanges of the grid: h and r*h of every unit
    h_x = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    rh_x = torch.empty((B, H), dtype=torch.float32, device=xw.device)
    lib = _build.load().lib
    with torch.cuda.device(xw.device):
        err = lib.paddle_gru_seq(
            xw.data_ptr(), lens.data_ptr(), u.data_ptr(), h0.data_ptr(),
            out.data_ptr(), h_t.data_ptr(), h_x.data_ptr(), rh_x.data_ptr(),
            B, T, H, _DTYPE_CODE[xw.dtype], _stream(xw.device))
    _raise_launch(err, "gru_seq", B, H)
    LAUNCHES["gru_seq"] += 1
    return out, h_t


def gru_sequence_fused(xw: torch.Tensor, lengths: torch.Tensor,
                       u: torch.Tensor, b: Optional[torch.Tensor] = None,
                       h0: Optional[torch.Tensor] = None, *,
                       route: Optional[str] = None):
    """Masked GRU over a whole sequence — the
    ``pallas_kernels.gru_sequence_fused`` contract: xw = x@W [B, T, 3H],
    lengths [B] int, u [H, 3H] packed [u_z | u_r | u_c], b [3H] (added to
    xw in xw's dtype before the recurrence, as the JAX wrapper does), h0
    [B, H] (zeros when None) -> (out [B, T, H], hT [B, H]) in xw's dtype.

    The kernel runs all T steps in one launch (the JAX ``block_b`` and
    ``chunk_t`` tile VMEM and have no counterpart; ``chunk_t`` rounds h to
    bf16 at chunk boundaries, which the port never does) and saves nothing
    beyond this contract: :func:`gru_sequence_fused_bwd` recomputes the
    gates from xw and ``out``."""
    _gru_shapes(xw, u)
    if b is not None:
        xw = xw + b
    if h0 is None:
        h0 = torch.zeros((xw.shape[0], u.shape[0]), dtype=xw.dtype,
                         device=xw.device)
    lengths = lengths.to(xw.device)
    if _route(route, xw, lengths, u, h0) == "plain":
        return gru_sequence_fused_plain(xw, lengths, u, h0)
    return _gru_sequence_fused_kernel(xw, lengths, u, h0)


# ---------------------------------------------------------------------------
# GRU backward (replaces _gru_seq_bwd_kernel)
# ---------------------------------------------------------------------------

def gru_sequence_fused_bwd_plain(xw, lengths, u, h0, out_seq, g_out, g_ht):
    """The op order of ``_gru_seq_bwd_kernel``: gates recomputed from xw
    and h_{t-1} = the saved masked output (h0 at t = 0) in f32, the
    adjoints in f32, dU summed over steps in f32. -> (dxw [B, T, 3H],
    dh0 [B, H]) in xw's dtype and du [H, 3H] f32."""
    B, T, G = xw.shape
    H = G // 3
    dt = xw.dtype
    u32 = _f32(u)
    uz, ur, uc = u32[:, :H], u32[:, H:2 * H], u32[:, 2 * H:]
    lens = _f32(lengths)[:, None]
    h0 = _f32(h0)
    dh = _f32(g_ht)
    du = torch.zeros((H, G), dtype=torch.float32, device=xw.device)
    dxw = torch.empty_like(xw)
    for t in reversed(range(T)):
        h_prev = _f32(out_seq[:, t - 1]) if t > 0 else h0
        z, r, rh, c = _gru_gates(_f32(xw[:, t]), h_prev, u32, H)
        m = (t < lens).to(torch.float32)
        dh_t = dh + m * _f32(g_out[:, t])
        dhp = m * dh_t
        dgz = (dhp * (c - h_prev)) * z * (1.0 - z)
        dgc = (dhp * z) * (1.0 - c * c)
        drh = dgc @ uc.t()
        dgr = (drh * h_prev) * r * (1.0 - r)
        dh = ((1.0 - m) * dh_t + dhp * (1.0 - z) + drh * r + dgz @ uz.t()
              + dgr @ ur.t())
        dxw[:, t] = torch.cat([dgz, dgr, dgc], dim=1).to(dt)
        du = du + torch.cat([h_prev.t() @ dgz, h_prev.t() @ dgr,
                             rh.t() @ dgc], dim=1)
    return dxw, dh.to(dt), du


def _gru_sequence_fused_bwd_kernel(xw, lengths, u, h0, out_seq, g_out, g_ht):
    B, T, H = _gru_shapes(xw, u)
    G = 3 * H
    seq, vec = (B, T, H), (B, H)
    lens = _check_args(
        "gru_sequence_fused_bwd", xw, lengths, H,
        [("u", u, (H, G)), ("h0", h0, vec), ("out_seq", out_seq, seq),
         ("g_out", g_out, seq), ("g_ht", g_ht, vec)])
    dxw = torch.empty_like(xw)
    dh0 = torch.empty((B, H), dtype=xw.dtype, device=xw.device)
    du = torch.empty((H, G), dtype=torch.float32, device=xw.device)
    if B == 0 or T == 0:
        dh0.copy_(g_ht)
        du.zero_()
        return dxw, dh0, du
    lib = _build.load().lib
    # scratch for the B*T (b, t) rows, of which the kernel uses the live
    # ones, compacted: the gates z, r, c of each (overwritten by their
    # cotangents) and r*h_{t-1} in f32, h_{t-1} in xw's dtype, and each
    # row's b*T + t
    rows = B * T
    f32 = dict(dtype=torch.float32, device=xw.device)
    gates = torch.empty((rows, G), **f32)
    rh_seq = torch.empty((rows, H), **f32)
    hp_seq = torch.empty((rows, H), dtype=xw.dtype, device=xw.device)
    rowmap = torch.empty(rows, dtype=torch.int32, device=xw.device)
    with torch.cuda.device(xw.device):
        err = lib.paddle_gru_seq_bwd(
            xw.data_ptr(), lens.data_ptr(), u.data_ptr(), h0.data_ptr(),
            out_seq.data_ptr(), g_out.data_ptr(), g_ht.data_ptr(),
            dxw.data_ptr(), dh0.data_ptr(), du.data_ptr(), gates.data_ptr(),
            rh_seq.data_ptr(), hp_seq.data_ptr(), rowmap.data_ptr(), B, T, H,
            _DTYPE_CODE[xw.dtype], _stream(xw.device))
    _raise_launch(err, "gru_seq_bwd", B, H)
    LAUNCHES["gru_seq_bwd"] += 1
    return dxw, dh0, du


def gru_sequence_fused_bwd(xw, lengths, u, h0, out_seq, g_out, g_ht, *,
                           route: Optional[str] = None):
    """Backward of :func:`gru_sequence_fused` — the
    ``pallas_kernels.gru_sequence_fused_bwd`` contract: xw with the bias
    added (its gradient is also the bias's, summed outside), the saved
    out_seq and the cotangents g_out [B, T, H], g_ht [B, H] ->
    (dxw [B, T, 3H], dh0 [B, H]) in xw's dtype and du [H, 3H] f32. The
    kernel keeps its recomputed gates and f32 cotangents of the live
    steps in scratch allocated per call; nothing is read from the forward
    but ``out_seq``."""
    _gru_shapes(xw, u)
    lengths = lengths.to(xw.device)
    if _route(route, xw, lengths, u, h0, out_seq, g_out, g_ht) == "plain":
        return gru_sequence_fused_bwd_plain(xw, lengths, u, h0, out_seq,
                                            g_out, g_ht)
    return _gru_sequence_fused_bwd_kernel(xw, lengths, u, h0, out_seq, g_out,
                                          g_ht)
