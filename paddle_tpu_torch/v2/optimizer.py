"""v2 optimizer facade (python/paddle/v2/optimizer.py analog) — maps the
settings() vocabulary onto fluid program-level optimizers."""

from __future__ import annotations

from ..fluid.optimizer import (AdamOptimizer, MomentumOptimizer, SGDOptimizer)


class Optimizer:
    def __init__(self, fluid_opt):
        self.fluid_opt = fluid_opt


def SGD(learning_rate: float = 0.01):  # noqa: N802 — reference name
    return Optimizer(SGDOptimizer(learning_rate))


def Momentum(learning_rate: float = 0.01, momentum: float = 0.9):  # noqa: N802
    return Optimizer(MomentumOptimizer(learning_rate, momentum))


def Adam(learning_rate: float = 1e-3, beta1: float = 0.9,  # noqa: N802
         beta2: float = 0.999, epsilon: float = 1e-8):
    return Optimizer(AdamOptimizer(learning_rate, beta1, beta2, epsilon))
