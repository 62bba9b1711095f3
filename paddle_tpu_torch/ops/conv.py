"""Convolutions — the counterpart of ``paddle_tpu/ops/conv.py``:
``conv2d``, the stem's ``conv7s2`` (and its space-to-depth form),
``depthwise_conv2d`` and ``conv2d_transpose`` for the image models;
``conv3d`` (NDHWC, DHWIO), ``row_conv``, ``im2col``, ``bilinear_interp``
and ``maxout``.

The JAX package computes them with ``lax.conv_general_dilated`` and has
no Pallas kernel for them; here they go through
``torch.nn.functional.conv2d`` / ``conv_transpose2d`` (cuDNN on the
card), as a plain large product goes through ``torch.matmul``.

Layouts are the JAX package's: activations NHWC, weights HWIO
([kh, kw, cin/groups, cout]). ``x.permute(0, 3, 1, 2)`` of an NHWC tensor
is an NCHW view in PyTorch's channels-last memory format, which cuDNN
takes as it is and answers in kind, so the result permutes back to a
contiguous NHWC tensor without a copy. The HWIO weight's OIHW view is not
channels-last: cuDNN converts it on each call (its cost at ResNet-50's
shapes is in PERF.md).

Padding: an int or a pair pads both sides of each spatial axis;
``"SAME"`` and ``"VALID"`` follow XLA, which pads ``"SAME"`` at stride > 1
asymmetrically (the extra row and column at the end), where PyTorch's
``padding="same"`` takes stride 1 only.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntOr2 = Union[int, Sequence[int]]
Padding = Union[str, IntOr2]


def _pair(v: IntOr2) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    return tuple(v)  # type: ignore[return-value]


def same_pads(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one axis (``lax.padtype_to_pads``):
    ceil(size / stride) outputs, the odd row at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def spatial_pads(padding: Padding, hw: Sequence[int],
                 windows: Sequence[int], strides: Sequence[int]
                 ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """(lo, hi) pads of H and W for an int, pair or ``"SAME"``/``"VALID"``
    padding of windows ``windows`` (dilated kernel extents)."""
    if isinstance(padding, str):
        kind = padding.upper()
        if kind == "VALID":
            return (0, 0), (0, 0)
        if kind != "SAME":
            raise ValueError(f"padding {padding!r} is not SAME or VALID")
        return tuple(same_pads(n, k, s)
                     for n, k, s in zip(hw, windows, strides))
    p = _pair(padding)
    return (p[0], p[0]), (p[1], p[1])


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: IntOr2 = 1,
           padding: Padding = 0, dilation: IntOr2 = 1,
           groups: int = 1) -> torch.Tensor:
    """NHWC conv with an HWIO weight ``w`` [kh, kw, cin/groups, cout]."""
    s, d = _pair(stride), _pair(dilation)
    windows = [(k - 1) * dk + 1 for k, dk in zip(w.shape[:2], d)]
    (ht, hb), (wl, wr) = spatial_pads(padding, x.shape[1:3], windows, s)
    xc = _nchw(x)
    if ht == hb and wl == wr:
        pad = (ht, wl)
    else:
        xc, pad = F.pad(xc, (wl, wr, ht, hb)), (0, 0)
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=s, padding=pad,
                 dilation=d, groups=groups)
    return _nhwc(y)


def conv7s2_space_to_depth(x: torch.Tensor, w7: torch.Tensor
                           ) -> torch.Tensor:
    """The 7x7 / stride-2 / pad-3 stem conv as an exact 4x4 / stride-1 conv
    over a 2x2 space-to-depth view of x (``paddle_tpu/ops/conv.py``
    ``conv7s2_space_to_depth``): with a leading zero tap (i' = i + 1 in
    0..7, i' = 2a + p) out[h] = sum x[2(h + a - 2) + p], a 4-cell window
    of the view, over 4 * cin channels. The weight is the same [7, 7, cin,
    cout] parameter regrouped, so trees and inits are unchanged. Needs
    even H and W."""
    B, H, W, C = x.shape
    if H % 2 or W % 2 or tuple(w7.shape[:2]) != (7, 7):
        raise ValueError(f"space-to-depth stem needs even H, W and a 7x7 "
                         f"kernel, got x {tuple(x.shape)}, w "
                         f"{tuple(w7.shape)}")
    cout = w7.shape[-1]
    xp = F.pad(x, (0, 0, 4, 4, 4, 4))
    hc, wc = (H + 8) // 2, (W + 8) // 2
    x2 = xp.reshape(B, hc, 2, wc, 2, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, hc, wc, 4 * C)
    w8 = F.pad(w7, (0, 0, 0, 0, 1, 0, 1, 0))
    w2 = w8.reshape(4, 2, 4, 2, C, cout).permute(0, 2, 1, 3, 4, 5).reshape(
        4, 4, 4 * C, cout)
    out = conv2d(x2, w2, stride=1, padding=0)
    return out[:, :H // 2, :W // 2]


def conv7s2(x: torch.Tensor, w7: torch.Tensor) -> torch.Tensor:
    """7x7 / stride-2 / pad-3 conv through the space-to-depth form when H
    and W are even, the direct conv otherwise (the JAX dispatch)."""
    if x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
        return conv7s2_space_to_depth(x, w7)
    return conv2d(x, w7, stride=2, padding=3)


def depthwise_conv2d(x: torch.Tensor, w: torch.Tensor, *,
                     stride: IntOr2 = 1, padding: Padding = 0
                     ) -> torch.Tensor:
    """w: [kh, kw, 1, channels * mult], one group a channel."""
    return conv2d(x, w, stride=stride, padding=padding, groups=x.shape[-1])


def _transpose_pads(padding: Padding, k: int, s: int) -> Tuple[int, int]:
    """The (lo, hi) pads of the stride-dilated input that ``lax.
    conv_transpose`` applies: an int p gives k - 1 - p on both sides;
    a string, JAX's ``_conv_transpose_padding``."""
    if not isinstance(padding, str):
        return k - 1 - padding, k - 1 - padding
    kind = padding.upper()
    if kind == "SAME":
        total = k + s - 2
        lo = k - 1 if s > k - 1 else -(-total // 2)
    elif kind == "VALID":
        total = k + s - 2 + max(k - s, 0)
        lo = k - 1
    else:
        raise ValueError(f"padding {padding!r} is not SAME or VALID")
    return lo, total - lo


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *,
                     stride: IntOr2 = 1, padding: Padding = 0
                     ) -> torch.Tensor:
    """``lax.conv_transpose(x, w, strides, pads, ("NHWC", "HWIO", "NHWC"))``
    with ``w`` [kh, kw, cin, cout]: the input dilated by the stride,
    padded, and correlated with w as it is (JAX does not flip the kernel:
    ``transpose_kernel=False``). ``conv_transpose2d`` correlates with the
    kernel flipped, so it is given the flipped kernel; its symmetric
    ``padding`` q and ``output_padding`` o pad the dilated input by
    k - 1 - q below and k - 1 - q + o above, and a high pad one below the
    low pad is one row cropped from the end."""
    s = _pair(stride)
    pads = [_transpose_pads(p, k, si) for p, k, si in
            zip(_pair(padding) if not isinstance(padding, str)
                else (padding, padding), w.shape[:2], s)]
    q = [k - 1 - lo for (lo, _), k in zip(pads, w.shape[:2])]
    extra = [hi - lo for lo, hi in pads]
    y = F.conv_transpose2d(_nchw(x), w.flip(0, 1).permute(2, 3, 0, 1),
                           stride=s, padding=q,
                           output_padding=[max(e, 0) for e in extra])
    y = _nhwc(y)
    return y[:, :y.shape[1] + min(extra[0], 0),
             :y.shape[2] + min(extra[1], 0)]


def conv3d(x: torch.Tensor, w: torch.Tensor, *, stride=1, padding=0,
           dilation=1, groups: int = 1) -> torch.Tensor:
    """NDHWC 3-D conv with a DHWIO weight [kd, kh, kw, cin/groups, cout]:
    an int or a triple pads both sides, ``"SAME"``/``"VALID"`` as XLA."""
    t3 = lambda v: (v,) * 3 if isinstance(v, int) else tuple(v)
    s, d = t3(stride), t3(dilation)
    xc = x.permute(0, 4, 1, 2, 3)
    if isinstance(padding, str):
        kind = padding.upper()
        if kind not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r} is not SAME or VALID")
        windows = [(k - 1) * dk + 1 for k, dk in zip(w.shape[:3], d)]
        pads = [same_pads(n, k, st) if kind == "SAME" else (0, 0)
                for n, k, st in zip(x.shape[1:4], windows, s)]
        xc = F.pad(xc, pads[2] + pads[1] + pads[0])
        pad = 0
    else:
        pad = t3(padding)
    y = F.conv3d(xc, w.permute(4, 3, 0, 1, 2), stride=s, padding=pad,
                 dilation=d, groups=groups)
    return y.permute(0, 2, 3, 4, 1)


def row_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Lookahead row convolution over time: x [B, T, D], w [context, D];
    out[t] = sum_i x[t + i] * w[i], zero past T, summed i by i as JAX."""
    context = w.shape[0]
    xpad = F.pad(x, (0, 0, 0, context - 1))
    out = torch.zeros_like(x)
    for i in range(context):
        out = out + xpad[:, i:i + x.shape[1], :] * w[i][None, None, :]
    return out


def im2col(x: torch.Tensor, kernel: IntOr2, stride: IntOr2 = 1,
           padding: IntOr2 = 0) -> torch.Tensor:
    """Patches of x [B, H, W, C] -> [B, oh, ow, kh * kw * C] in patch-major
    (kh, kw, C) order (``F.unfold``, which is exact: it copies)."""
    kh, kw = _pair(kernel)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    B, H, W, C = x.shape
    oh = (H + 2 * ph - kh) // sh + 1
    ow = (W + 2 * pw - kw) // sw + 1
    cols = F.unfold(_nchw(x), (kh, kw), padding=(ph, pw), stride=(sh, sw))
    # [B, C * kh * kw, oh * ow], channel-major: reorder to (kh, kw, C)
    cols = cols.reshape(B, C, kh, kw, oh, ow).permute(0, 4, 5, 2, 3, 1)
    return cols.reshape(B, oh, ow, kh * kw * C)


def bilinear_interp(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize NHWC with aligned corners, in JAX's op order (the
    rows' blend of the columns' blends)."""
    B, H, W, C = x.shape
    ry = (H - 1) / max(out_h - 1, 1)
    rx = (W - 1) / max(out_w - 1, 1)
    ys = torch.arange(out_h, device=x.device) * ry
    xs = torch.arange(out_w, device=x.device) * rx
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (ys - y0).to(x.dtype)[None, :, None, None]
    wx = (xs - x0).to(x.dtype)[None, None, :, None]
    g = lambda yi, xi: x[:, yi][:, :, xi]
    top = g(y0, x0) * (1 - wx) + g(y0, x1) * wx
    bot = g(y1, x0) * (1 - wx) + g(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def maxout(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Maxout over channel groups, NHWC: C -> C / groups channels, each
    the max of ``groups`` consecutive channels."""
    B, H, W, C = x.shape
    return torch.amax(x.reshape(B, H, W, C // groups, groups), dim=-1)
