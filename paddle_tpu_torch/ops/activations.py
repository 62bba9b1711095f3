"""Activations — the counterpart of ``paddle_tpu/ops/activations.py``.

Each activation is a plain function of a tensor, registered under the JAX
registry's names (``get(name)``, which ``nn.Linear(act=...)`` resolves).
The formulas and default constants are JAX's, not PyTorch's look-alikes:
``gelu`` is the tanh approximation (``jax.nn.gelu``'s default, not
PyTorch's exact one), ``softrelu`` clips its input at the threshold
before ``log1p(exp(.))``, ``softplus`` is ``logaddexp(x, 0)``
(``jax.nn.softplus``; no threshold branch as in ``F.softplus``),
``leaky_relu`` keeps JAX's slope 0.02 and ``elu`` is
``where(x > 0, x, alpha * expm1(x))``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..core.lod import sequence_mask

ACTIVATIONS: Dict[str, Callable] = {}


def _reg(name: str):
    def deco(fn):
        if name in ACTIVATIONS:
            raise KeyError(f"activation {name!r} is registered twice")
        ACTIVATIONS[name] = fn
        return fn
    return deco


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


@_reg("linear")
@_reg("identity")
def identity(x):
    return x


@_reg("sigmoid")
def sigmoid(x):
    return torch.sigmoid(x)


@_reg("tanh")
def tanh(x):
    return torch.tanh(x)


@_reg("relu")
def relu(x):
    return torch.relu(x)


@_reg("brelu")
def brelu(x, t_min=0.0, t_max=24.0):
    """Bounded relu: x clipped to [t_min, t_max]."""
    return torch.clamp(x, t_min, t_max)


@_reg("relu6")
def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


@_reg("leaky_relu")
def leaky_relu(x, alpha=0.02):
    return torch.where(x >= 0, x, alpha * x)


@_reg("elu")
def elu(x, alpha=1.0):
    # expm1 of the negative part only, as JAX: a large x would put
    # 0 * inf into the unselected branch's gradient
    return torch.where(x > 0, x,
                       alpha * torch.expm1(torch.where(x > 0, _zero(x), x)))


@_reg("gelu")
def gelu(x):
    return F.gelu(x, approximate="tanh")


@_reg("softrelu")
def softrelu(x, threshold=40.0):
    """log(1 + exp(x)) of x clipped to [-threshold, threshold]."""
    return torch.log1p(torch.exp(torch.clamp(x, -threshold, threshold)))


@_reg("softplus")
def softplus(x):
    return torch.logaddexp(x, _zero(x))


@_reg("softsign")
def softsign(x):
    return x / (torch.abs(x) + 1)


@_reg("stanh")
def stanh(x, scale_a=0.67, scale_b=1.7159):
    """Scaled tanh: scale_b * tanh(scale_a * x)."""
    return scale_b * torch.tanh(scale_a * x)


@_reg("hard_sigmoid")
def hard_sigmoid(x, slope=0.2, offset=0.5):
    return torch.clamp(slope * x + offset, 0.0, 1.0)


@_reg("hard_shrink")
def hard_shrink(x, threshold=0.5):
    return torch.where(torch.abs(x) > threshold, x, _zero(x))


@_reg("soft_shrink")
def soft_shrink(x, lam=0.5):
    return torch.where(x > lam, x - lam,
                       torch.where(x < -lam, x + lam, _zero(x)))


@_reg("thresholded_relu")
def thresholded_relu(x, threshold=1.0):
    return torch.where(x > threshold, x, _zero(x))


@_reg("abs")
def abs_act(x):
    return torch.abs(x)


@_reg("square")
def square(x):
    return torch.square(x)


@_reg("sqrt")
def sqrt(x):
    return torch.sqrt(x)


@_reg("exponential")
@_reg("exp")
def exponential(x):
    return torch.exp(x)


@_reg("log")
def log(x):
    return torch.log(x)


@_reg("reciprocal")
def reciprocal(x):
    return 1.0 / x


@_reg("pow")
def pow_act(x, factor=1.0):
    return torch.pow(x, factor)


@_reg("swish")
def swish(x, beta=1.0):
    return x * torch.sigmoid(beta * x)


@_reg("softmax")
def softmax(x, axis=-1):
    return torch.softmax(x, dim=axis)


@_reg("log_softmax")
def log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=axis)


def sequence_softmax(x: torch.Tensor, lengths: torch.Tensor, axis: int = 1
                     ) -> torch.Tensor:
    """Softmax over the valid steps of a padded batch [B, T, ...] along
    ``axis``; padded steps give 0 (a length-0 row is all 0)."""
    mask = sequence_mask(lengths.to(x.device), x.shape[axis], torch.bool)
    shape = [1] * x.dim()
    shape[0], shape[axis] = mask.shape
    mask = mask.reshape(shape)
    z = torch.where(mask, x, torch.full((), torch.finfo(x.dtype).min,
                                        dtype=x.dtype, device=x.device))
    return torch.where(mask, torch.softmax(z, dim=axis), _zero(x))


def get(name: str) -> Callable:
    if name not in ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r} "
                       f"(registered: {sorted(ACTIVATIONS)})")
    return ACTIVATIONS[name]
