"""Dense math ops — the counterpart of ``paddle_tpu/ops/math.py``: the
flattening and batched matmuls, the elementwise family with Paddle's
``axis`` broadcast, scale and clips, the reductions, the shape ops,
gather and scatter, cosine similarity, ``top_k``, ``argmax``,
interpolation and ``sum_op``.

The big products stay ``torch.matmul``, as JAX leaves them to XLA.
Ties resolve as JAX's do: ``top_k`` returns the lower index first
(a stable descending sort, as ``lax.top_k``; ``torch.topk`` promises no
order among ties on the card) and ``argmax`` the first maximum.
"""

from __future__ import annotations

import math as _math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, y: torch.Tensor, *, transpose_x: bool = False,
           transpose_y: bool = False, precision=None) -> torch.Tensor:
    """Batched matmul: leading batch dims broadcast, 1-D operands get the
    usual vector promotion. ``precision`` is JAX's MXU knob and sets
    nothing here (f32 products stay f32: TF32 is off in the port)."""
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mul(x: torch.Tensor, y: torch.Tensor, *, x_num_col_dims: int = 1,
        y_num_col_dims: int = 1) -> torch.Tensor:
    """Flattening matmul: x's leading ``x_num_col_dims`` dims become the
    rows and the rest the columns, likewise for y."""
    xs, ys = tuple(x.shape), tuple(y.shape)
    xm = x.reshape(_math.prod(xs[:x_num_col_dims]), -1)
    ym = y.reshape(_math.prod(ys[:y_num_col_dims]), -1)
    return torch.matmul(xm, ym).reshape(xs[:x_num_col_dims]
                                        + ys[y_num_col_dims:])


def fc(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
       ) -> torch.Tensor:
    """x (flattened to [B, -1]) @ w + b."""
    out = torch.matmul(x.reshape(x.shape[0], -1), w)
    return out if b is None else out + b


def _ewise(op, x, y, axis: int = -1):
    """``op(x, y)``; with ``axis`` and a y of fewer dims, y's shape aligns
    to x's dims from ``axis`` on (Paddle's elementwise broadcast)."""
    if x.dim() != y.dim() and axis != -1 and y.dim() > 0:
        shape = [1] * x.dim()
        for i, s in enumerate(y.shape):
            shape[axis + i] = s
        y = y.reshape(shape)
    return op(x, y)


elementwise_add = partial(_ewise, torch.add)
elementwise_sub = partial(_ewise, torch.sub)
elementwise_mul = partial(_ewise, torch.mul)
elementwise_div = partial(_ewise, torch.div)
elementwise_max = partial(_ewise, torch.maximum)
elementwise_min = partial(_ewise, torch.minimum)
elementwise_pow = partial(_ewise, torch.pow)


def scale(x, scale_factor=1.0, bias=0.0, bias_after_scale=True):
    if bias_after_scale:
        return x * scale_factor + bias
    return (x + bias) * scale_factor


def clip(x, min_val, max_val):
    return torch.clamp(x, min_val, max_val)


def clip_by_norm(x, max_norm):
    """x scaled down to L2 norm ``max_norm`` where its norm is larger."""
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm,
                       x * (max_norm / torch.clamp(norm, min=1e-12)), x)


def _dims(x: torch.Tensor, axis):
    """A reduction's dims: all of x's for None, else as a tuple."""
    if axis is None:
        return tuple(range(x.dim()))
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def reduce_sum(x, axis=None, keepdims=False):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims)


def reduce_mean(x, axis=None, keepdims=False):
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdims)


def reduce_max(x, axis=None, keepdims=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdims)


def reduce_min(x, axis=None, keepdims=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdims)


def mean(x):
    return torch.mean(x)


def reshape(x, shape):
    return torch.reshape(x, tuple(shape))


def transpose(x, axes=None):
    """x with its axes permuted (reversed for None, as ``jnp.transpose``)."""
    return x.permute(tuple(axes) if axes is not None
                     else tuple(reversed(range(x.dim()))))


def concat(xs: Sequence[torch.Tensor], axis: int = 0):
    return torch.cat(list(xs), dim=axis)


def split(x, num_or_sections, axis=0):
    """``num_or_sections`` equal parts (it must divide the axis, as
    ``jnp.split`` asks) or parts of the given sizes."""
    if isinstance(num_or_sections, int):
        if x.shape[axis] % num_or_sections:
            raise ValueError(f"axis {axis} of size {x.shape[axis]} does not "
                             f"split into {num_or_sections} equal parts")
        return list(torch.tensor_split(x, num_or_sections, dim=axis))
    return list(torch.split(x, list(num_or_sections), dim=axis))


def expand(x, expand_times: Sequence[int]):
    """x tiled ``expand_times`` along each axis."""
    return x.tile(tuple(expand_times))


def pad(x, paddings, pad_value=0.0):
    """x padded by [(lo, hi)] a dim with ``pad_value``."""
    flat = []
    for lo, hi in reversed(list(paddings)):
        flat += [lo, hi]
    return F.pad(x, flat, value=pad_value)


def crop(x, offsets: Sequence[int], shape: Sequence[int]):
    """The block of ``shape`` at ``offsets``, each offset clamped so the
    block fits (``lax.dynamic_slice``)."""
    out = x
    for d, (o, s) in enumerate(zip(offsets, shape)):
        o = min(max(int(o), 0), x.shape[d] - s)
        out = out.narrow(d, o, s)
    return out


def cast(x, dtype):
    return x.to(dtype)


def gather(x, index, axis=0):
    """The slices of x at ``index`` along ``axis`` (``jnp.take``): the
    result's shape is x's with that axis replaced by index's."""
    index = torch.as_tensor(index, device=x.device).to(torch.long)
    out = x.index_select(axis, index.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(index.shape)
                       + tuple(x.shape[axis + 1:]))


def scatter(x, index, updates, overwrite=True):
    """x with the rows of ``updates`` written (``overwrite``) or added at
    ``index`` along axis 0, out of place. Where an index repeats, which
    written row is kept is unspecified, as in XLA's scatter."""
    index = torch.as_tensor(index, device=x.device).to(torch.long)
    if overwrite:
        return x.index_copy(0, index, updates.to(x.dtype))
    return x.index_add(0, index, updates.to(x.dtype))


def cos_sim(x, y, eps: float = 1e-8):
    """Row-wise cosine similarity over the last axis."""
    nx = torch.sqrt(torch.sum(torch.square(x), -1) + eps)
    ny = torch.sqrt(torch.sum(torch.square(y), -1) + eps)
    return torch.sum(x * y, -1) / (nx * ny)


def l2_normalize(x, axis=-1, eps=1e-12):
    return x / torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True)
                          + eps)


def top_k(x, k: int):
    """(values, indices) of the k largest over the last axis, largest
    first, the lower index first among equal values (``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def argmax(x, axis=-1):
    """The index of the first maximum (``jnp.argmax``)."""
    return torch.argmax(x, dim=axis)


def interpolation(x, y, w):
    """w * x + (1 - w) * y, w broadcast over x's trailing dims."""
    w = w.reshape(tuple(w.shape) + (1,) * (x.dim() - w.dim()))
    return w * x + (1.0 - w) * y


def sum_op(xs: Sequence[torch.Tensor]):
    """xs added in order."""
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out
