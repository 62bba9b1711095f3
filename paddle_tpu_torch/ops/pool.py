"""Pooling — the counterpart of ``paddle_tpu/ops/pool.py``, NHWC:
``max_pool2d``, ``avg_pool2d`` and the global pools for the image
models; ``max_pool2d_with_index`` (for unpooling), ``max_pool3d`` and
``avg_pool3d`` (NDHWC), ``spatial_pyramid_pool`` and ``roi_pool``.

JAX computes them with ``lax.reduce_window`` (no Pallas kernel); here
they go through ``torch.nn.functional.max_pool2d`` / ``avg_pool2d`` on
the channels-last NCHW view of the NHWC tensor (``ops/conv.py``). Padding
is JAX's: an int or a pair pads both sides, ``"SAME"``/``"VALID"`` as XLA
pads them. A max pool pads with -inf. An average pool divides by the
window's area where ``count_include_pad`` or the padding is a string (as
JAX does), else by the count of input cells in the window.

Where JAX leaves an order open the port states its rule:
``max_pool2d_with_index`` gives, among tied maxima of a window, the
first in row-major order (the smallest flat index, as JAX's strict ``>``
reducer keeps the first it meets on the CPU); ``roi_pool`` returns
values only, and its gradient splits evenly among tied maxima, as the
gradient of JAX's ``jnp.max`` does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

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


def max_pool2d_with_index(x: torch.Tensor, kernel: IntOr2,
                          stride: Optional[IntOr2] = None,
                          padding: IntOr2 = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, the flat index h * W + w of each window's maximum in its
    input plane, int32): ``F.max_pool2d(return_indices=True)``, whose
    window scan keeps the first of tied maxima. A padding past half a
    window pads with -inf by hand and maps the padded plane's indices
    back (a window of padding alone gives -1, as JAX's reducer's init)."""
    k = _pair(kernel)
    s = _pair(stride if stride is not None else kernel)
    p = _pair(padding)
    B, H, W, C = x.shape
    xc = _nchw(x)
    if p[0] <= k[0] // 2 and p[1] <= k[1] // 2:
        vals, idx = F.max_pool2d(xc, k, s, padding=p, return_indices=True)
    else:
        xc = F.pad(xc, (p[1], p[1], p[0], p[0]), value=float("-inf"))
        vals, idx = F.max_pool2d(xc, k, s, return_indices=True)
        Wp = W + 2 * p[1]
        r, c = idx // Wp - p[0], idx % Wp - p[1]
        inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        idx = torch.where(inside, r * W + c, torch.full_like(idx, -1))
    return _nhwc(vals), _nhwc(idx).to(torch.int32)


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _pool3d(x, kernel, stride, padding, value):
    k = _triple(kernel)
    s = k if stride is None else _triple(stride)
    p = _triple(padding)
    xc = F.pad(x.permute(0, 4, 1, 2, 3),
               (p[2], p[2], p[1], p[1], p[0], p[0]), value=value)
    return xc, k, s


def max_pool3d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    """NDHWC max pool, padded with -inf."""
    xc, k, s = _pool3d(x, kernel, stride, padding, float("-inf"))
    return F.max_pool3d(xc, k, s).permute(0, 2, 3, 4, 1)


def avg_pool3d(x: torch.Tensor, kernel, stride=None,
               padding=0) -> torch.Tensor:
    """NDHWC average pool: zero padding counted, the sum divided by the
    window's volume (as JAX divides its summed window)."""
    xc, k, s = _pool3d(x, kernel, stride, padding, 0.0)
    return F.avg_pool3d(xc, k, s).permute(0, 2, 3, 4, 1)


def spatial_pyramid_pool(x: torch.Tensor, pyramid_height: int,
                         pool_type: str = "max") -> torch.Tensor:
    """Pool [B, H, W, C] at levels of 1, 2, 4, ... bins a side (bin i of
    n spans rows floor(i H / n) .. ceil((i + 1) H / n)) and concatenate
    the [B, C] pools level by level, row by row: [B, C * sum 4**l]."""
    B, H, W, C = x.shape
    outs = []
    for level in range(pyramid_height):
        bins = 2 ** level
        for i in range(bins):
            y0, y1 = (i * H) // bins, -(-((i + 1) * H) // bins)
            for j in range(bins):
                x0, x1 = (j * W) // bins, -(-((j + 1) * W) // bins)
                region = x[:, y0:y1, x0:x1, :]
                outs.append(torch.amax(region, dim=(1, 2))
                            if pool_type == "max"
                            else torch.mean(region, dim=(1, 2)))
    return torch.cat(outs, dim=-1)


# Masked elements one chunk of roi_pool's rois may hold (2**26 f32: 256 MiB).
_ROI_CHUNK_ELEMS = 1 << 26


def roi_pool(feat: torch.Tensor, rois: torch.Tensor,
             out_size: Sequence[int],
             spatial_scale: float = 1.0) -> torch.Tensor:
    """ROI max pooling of one image's feature map feat [H, W, C] over rois
    [N, 4] (x1, y1, x2, y2 in input scale) -> [N, oh, ow, C]. Bin (i, j)
    of a roi covers the rows floor(y1 + i rh) .. ceil(y1 + (i + 1) rh)
    and the columns likewise, with rh = max(y2 - y1 + 1, 1) / oh; an
    empty bin gives -inf, as JAX's masked max. The max is taken over the
    bin's columns, then its rows (a max of maxima: the same value), with
    the rois in chunks of at most ``_ROI_CHUNK_ELEMS`` masked elements."""
    H, W, C = feat.shape
    oh, ow = out_size
    f32 = torch.float32
    r = rois.to(f32) * spatial_scale
    x1, y1, x2, y2 = r.unbind(-1)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0) / oh
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0) / ow
    ys = torch.arange(H, dtype=f32, device=feat.device)
    xs = torch.arange(W, dtype=f32, device=feat.device)

    def masks(lo, step, n, grid):
        i = torch.arange(n, dtype=f32, device=feat.device)
        b_lo = torch.floor(lo[:, None] + i[None] * step[:, None])
        b_hi = torch.ceil(lo[:, None] + (i[None] + 1.0) * step[:, None])
        return ((grid[None, None] >= b_lo[..., None])
                & (grid[None, None] < b_hi[..., None]))       # [N, n, len]

    my, mx = masks(y1, rh, oh, ys), masks(x1, rw, ow, xs)
    neg = torch.tensor(float("-inf"), dtype=feat.dtype, device=feat.device)
    per = max(1, _ROI_CHUNK_ELEMS // max(H * W * C, 1))
    outs = []
    for n0 in range(0, r.shape[0], per):
        cols = []
        for j in range(ow):
            m = mx[n0:n0 + per, j][:, None, :, None]           # [n, 1, W, 1]
            cols.append(torch.amax(torch.where(m, feat[None], neg), dim=2))
        colmax = torch.stack(cols, dim=1)                      # [n, ow, H, C]
        rows = []
        for i in range(oh):
            m = my[n0:n0 + per, i][:, None, :, None]           # [n, 1, H, 1]
            rows.append(torch.amax(torch.where(m, colmax, neg), dim=2))
        outs.append(torch.stack(rows, dim=1))                  # [n, oh, ow, C]
    if not outs:
        return feat.new_zeros((0, oh, ow, C))
    return torch.cat(outs, dim=0)
