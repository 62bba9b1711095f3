"""Normalization — the counterpart of ``paddle_tpu/ops/norm.py``:
``layer_norm`` for the transformers, ``batch_norm``, ``lrn`` and
``cross_map_norm`` for the image models, and ``group_norm``.

JAX computes them with plain jnp (no Pallas kernel), and so does the
port, but for the training pass of ``batch_norm``:

* ``_train_fused``: ``torch.nn.functional.batch_norm`` in training mode,
  one fused pass each way (cuDNN on the card). The batch moments come
  out of its running-stat buffers: fresh f32 buffers at momentum 1.0
  receive the batch mean and the *unbiased* variance, which is scaled
  back to the biased one; ``_merge_running`` then updates the running
  stats under JAX's rules.
* ``_train_shifted``: JAX's own one-pass form written out op by op: f32
  moments of x shifted by the running mean (under ``detach``, as
  ``stop_gradient``), then ``y = x * a + b`` in x's dtype. ``batch_norm``
  takes it only for one element a channel, which ``F.batch_norm``
  refuses.

Both give the JAX function's results (``tests/test_torch_image.py``).
``chip_smoke.py`` times both at ResNet-50's 53 BN shapes at batch 64 in
bf16, forward and backward: 9.32 ms a step fused, 41.3 ms shifted on an
H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md, PR 14), which made the
fused pass the one ``batch_norm`` runs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis with the population variance, in x's
    dtype (``jnp.mean``/``jnp.var`` then ``(x - mean) * rsqrt(var + eps)
    * gamma + beta``)."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def _scale_shift(x, gamma, beta, mean, var, eps):
    """JAX's scale-shift form: a and b in f32, y = x * a + b in x's
    dtype."""
    a = gamma.to(torch.float32) * torch.rsqrt(var + eps)
    b = beta.to(torch.float32) - mean * a
    return x * a.to(x.dtype) + b.to(x.dtype)


def _train_shifted(x, gamma, beta, running_mean, eps, red=None):
    """JAX's one pass: f32 sums of d = x - shift and d * d over the axes
    ``red`` (every axis but the last by default), shifted by the running
    mean; the mean and the biased variance (clamped at 0) normalize x."""
    red = tuple(range(x.dim() - 1)) if red is None else red
    n = 1
    for a in red:
        n *= x.shape[a]
    shift = running_mean.detach().to(torch.float32)
    d = x.to(torch.float32) - shift
    dm = d.sum(dim=red) / n
    var = torch.clamp(torch.sum(d * d, dim=red) / n - dm * dm, min=0.0)
    mean = shift + dm
    return _scale_shift(x, gamma, beta, mean, var, eps), mean, var


def _train_fused(x, gamma, beta, eps):
    """``F.batch_norm`` in training mode over the channels-first view; the
    batch mean and unbiased variance land in fresh running buffers (f32,
    or f64 for an f64 x) at momentum 1.0, and the variance is scaled back
    to the biased one."""
    C = x.shape[-1]
    n = x.numel() // C
    acc = torch.promote_types(x.dtype, torch.float32)
    mean = torch.zeros(C, dtype=acc, device=x.device)
    unbiased = torch.ones(C, dtype=acc, device=x.device)
    y = F.batch_norm(x.movedim(-1, 1), mean, unbiased, gamma.to(acc),
                     beta.to(acc), training=True, momentum=1.0,
                     eps=eps).movedim(1, -1)
    return y, mean, unbiased * ((n - 1) / n)


def _merge_running(running_mean, running_var, mean, var, momentum):
    """JAX's running update: ``momentum * old + (1 - momentum) * batch``
    in f32, stored in the running stats' dtype."""
    f32 = torch.float32
    new_mean = (momentum * running_mean.to(f32)
                + (1.0 - momentum) * mean).to(running_mean.dtype)
    new_var = (momentum * running_var.to(f32)
               + (1.0 - momentum) * var).to(running_var.dtype)
    return new_mean, new_var


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               running_mean: torch.Tensor, running_var: torch.Tensor, *,
               train: bool, momentum: float = 0.9, eps: float = 1e-5,
               axis_mask: Optional[Tuple[int, ...]] = None):
    """Batch normalization over every axis but the last (channels last),
    or over the axes ``axis_mask`` (the statistics then have the shape of
    the axes left, broadcast against x from the right as in JAX).

    Returns (y, new_mean, new_var) as JAX does: in training mode the batch
    mean and biased variance normalize x and the running stats become
    ``momentum * old + (1 - momentum) * batch``, computed in f32 and
    stored in the running stats' dtype; in eval mode the running stats
    normalize x and come back unchanged. Gradients flow through the batch
    moments. Training runs the fused pass, or the shifted one for one
    element a channel or an ``axis_mask`` other than every axis but the
    last (module docstring)."""
    red = None if axis_mask is None else tuple(
        a % x.dim() for a in axis_mask)
    if red == tuple(range(x.dim() - 1)):
        red = None
    if not train:
        y = _scale_shift(x, gamma, beta, running_mean.to(torch.float32),
                         running_var.to(torch.float32), eps)
        return y, running_mean, running_var
    if red is not None or x.numel() == x.shape[-1]:
        y, mean, var = _train_shifted(x, gamma, beta, running_mean, eps, red)
    else:
        y, mean, var = _train_fused(x, gamma, beta, eps)
    return (y,) + _merge_running(running_mean, running_var, mean, var,
                                 momentum)


def lrn(x: torch.Tensor, size: int = 5, alpha: float = 1e-4,
        beta: float = 0.75, k: float = 1.0) -> torch.Tensor:
    """Local response norm across channels, NHWC: x / (k + alpha * sum of
    x^2 over ``size`` neighbouring channels)^beta, the window summed as
    JAX sums it (zero-padded, one shifted slice at a time)."""
    sq = torch.square(x)
    half = size // 2
    pad = F.pad(sq, (half, half))
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + pad[..., i:i + x.shape[-1]]
    return x / torch.pow(k + alpha * acc, beta)


def cross_map_norm(x: torch.Tensor, size: int = 5, scale: float = 1e-4,
                   pow_: float = 0.75) -> torch.Tensor:
    """The gen-1 name of ``lrn`` (CMRProjectionNormLayer)."""
    return lrn(x, size=size, alpha=scale, beta=pow_, k=1.0)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int, eps: float = 1e-5) -> torch.Tensor:
    """Group norm, channels last: the C channels in ``groups`` groups,
    each normalized over its channels and every axis but the batch's by
    the population variance, then ``* gamma + beta``."""
    shape = x.shape
    C = shape[-1]
    xg = x.reshape(shape[:-1] + (groups, C // groups))
    red = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    mean = xg.mean(dim=red, keepdim=True)
    var = xg.var(dim=red, keepdim=True, correction=0)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(shape)
    return xn * gamma + beta
