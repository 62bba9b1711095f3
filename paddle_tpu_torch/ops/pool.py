"""Pooling — the part of ``paddle_tpu/ops/pool.py`` the image models need:
``max_pool2d``, ``avg_pool2d`` and the global pools, NHWC.

JAX computes them with ``lax.reduce_window`` (no Pallas kernel); here
they go through ``torch.nn.functional.max_pool2d`` / ``avg_pool2d`` on
the channels-last NCHW view of the NHWC tensor (``ops/conv.py``). Padding
is JAX's: an int or a pair pads both sides, ``"SAME"``/``"VALID"`` as XLA
pads them. A max pool pads with -inf. An average pool divides by the
window's area where ``count_include_pad`` or the padding is a string (as
JAX does), else by the count of input cells in the window.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from .conv import IntOr2, _nchw, _nhwc, _pair, spatial_pads

Padding = Union[str, IntOr2]


def _window(x, kernel, stride, padding):
    k = _pair(kernel)
    s = _pair(stride if stride is not None else kernel)
    (ht, hb), (wl, wr) = spatial_pads(padding, x.shape[1:3], k, s)
    # the pooling functions pad both sides alike, by at most half a window
    native = ht == hb and wl == wr and ht <= k[0] // 2 and wl <= k[1] // 2
    return k, s, (ht, hb, wl, wr), native


def max_pool2d(x: torch.Tensor, kernel: IntOr2,
               stride: Optional[IntOr2] = None,
               padding: Padding = 0) -> torch.Tensor:
    k, s, (ht, hb, wl, wr), native = _window(x, kernel, stride, padding)
    xc = _nchw(x)
    if native:
        return _nhwc(F.max_pool2d(xc, k, s, padding=(ht, wl)))
    xc = F.pad(xc, (wl, wr, ht, hb), value=float("-inf"))
    return _nhwc(F.max_pool2d(xc, k, s))


def avg_pool2d(x: torch.Tensor, kernel: IntOr2,
               stride: Optional[IntOr2] = None, padding: Padding = 0,
               count_include_pad: bool = True) -> torch.Tensor:
    k, s, (ht, hb, wl, wr), native = _window(x, kernel, stride, padding)
    by_area = count_include_pad or isinstance(padding, str)
    xc = _nchw(x)
    if native:
        return _nhwc(F.avg_pool2d(xc, k, s, padding=(ht, wl),
                                  count_include_pad=by_area))
    pad = (wl, wr, ht, hb)
    out = F.avg_pool2d(F.pad(xc, pad), k, s)
    if not by_area:
        ones = torch.ones_like(xc[:1, :1])
        out = out / F.avg_pool2d(F.pad(ones, pad), k, s)
    return _nhwc(out)


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x, dim=(1, 2))


def global_max_pool2d(x: torch.Tensor) -> torch.Tensor:
    return torch.amax(x, dim=(1, 2))
