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
from typing import Callable

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


def xavier() -> Initializer:
    """Glorot uniform over (fan_in, fan_out) of a [in, out] matrix, the JAX
    ``xavier()`` default of ``Linear``."""
    def init(p: torch.Tensor, gen: torch.Generator) -> None:
        fan_in, fan_out = (p.shape[0], p.shape[0]) if p.dim() == 1 \
            else (p.shape[-2], p.shape[-1])
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        uniform(-limit, limit)(p, gen)
    return init
