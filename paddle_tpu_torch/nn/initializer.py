"""Parameter initializers — the counterpart of
``paddle_tpu/nn/initializer.py``.

An initializer fills a parameter in place. Random draws come from an
explicit CPU ``torch.Generator`` and are then copied to the parameter's
device, so one seed gives the same weights on the CPU and on the card.
(torch and JAX draw different numbers from one seed; no test relies on
them agreeing — weights cross over through ``convert.params_from_numpy``.)
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

Initializer = Callable[[torch.Tensor, torch.Generator], None]


def constant(value: float = 0.0) -> Initializer:
    def init(p: torch.Tensor, gen: torch.Generator) -> None:
        with torch.no_grad():
            p.fill_(value)
    return init


zeros = constant(0.0)
ones = constant(1.0)


def normal(mean: float = 0.0, std: float = 1.0) -> Initializer:
    def init(p: torch.Tensor, gen: torch.Generator) -> None:
        draw = torch.randn(p.shape, generator=gen, dtype=torch.float32)
        with torch.no_grad():
            p.copy_(mean + std * draw)
    return init


def uniform(low: float = -1.0, high: float = 1.0) -> Initializer:
    def init(p: torch.Tensor, gen: torch.Generator) -> None:
        draw = torch.rand(p.shape, generator=gen, dtype=torch.float32)
        with torch.no_grad():
            p.copy_(low + (high - low) * draw)
    return init


def _fans(shape) -> Tuple[int, int]:
    """(fan_in, fan_out) as JAX counts them: a vector's length twice, a
    matrix's [in, out], and for a conv kernel [kh, kw, cin, cout] the
    channels times the receptive field kh * kw."""
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def xavier(uniform_dist: bool = True) -> Initializer:
    """Glorot: uniform in +-sqrt(6 / (fan_in + fan_out)) (``Linear``'s
    default), or normal with std sqrt(2 / (fan_in + fan_out))."""
    def init(p: torch.Tensor, gen: torch.Generator) -> None:
        fan_in, fan_out = _fans(p.shape)
        if uniform_dist:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            uniform(-limit, limit)(p, gen)
        else:
            normal(0.0, math.sqrt(2.0 / (fan_in + fan_out)))(p, gen)
    return init


def msra(uniform_dist: bool = False) -> Initializer:
    """He: normal with std sqrt(2 / fan_in) (``Conv2D``'s default), or
    uniform in +-sqrt(6 / fan_in)."""
    def init(p: torch.Tensor, gen: torch.Generator) -> None:
        fan_in, _ = _fans(p.shape)
        if uniform_dist:
            limit = math.sqrt(6.0 / fan_in)
            uniform(-limit, limit)(p, gen)
        else:
            normal(0.0, math.sqrt(2.0 / fan_in))(p, gen)
    return init


def gen1_default(initial_std: Optional[float] = None) -> Initializer:
    """The gen-1 default: normal with std ``initial_std``, else
    1 / sqrt(fan_in)."""
    def init(p: torch.Tensor, gen: torch.Generator) -> None:
        std = (initial_std if initial_std is not None
               else 1.0 / math.sqrt(_fans(p.shape)[0]))
        normal(0.0, std)(p, gen)
    return init
