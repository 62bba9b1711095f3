"""Weight-decay regularizers as op-emitting decorators.

Analog of python/paddle/v2/fluid/regularizer.py (L2DecayRegularizer /
L1DecayRegularizer append ops transforming each gradient before the optimizer
consumes it) and the gen-1 Regularizer.cpp L1/L2 pair. The decay op lands in
the same block as the optimizer ops, so it fuses into the single compiled
train step.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .framework import Program, Variable, default_main_program


class WeightDecayRegularizer:
    def append_decay(self, block, param: Variable, grad: Variable) -> Variable:
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    """grad += coeff * param (L2DecayRegularizer semantics)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_decay(self, block, param, grad):
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("scale", {"X": [param.name]}, {"Out": [decay.name]},
                        {"scale": self.coeff})
        out = block.create_var(shape=grad.shape, dtype=grad.dtype)
        block.append_op("elementwise_add",
                        {"X": [grad.name], "Y": [decay.name]},
                        {"Out": [out.name]})
        return out


class L1Decay(WeightDecayRegularizer):
    """grad += coeff * sign(param) (L1DecayRegularizer; the gen-1
    Regularizer.cpp L1 path the round-1 build lacked)."""

    def __init__(self, regularization_coeff: float = 0.0):
        self.coeff = regularization_coeff

    def append_decay(self, block, param, grad):
        sgn = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("sign", {"X": [param.name]}, {"Out": [sgn.name]})
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op("scale", {"X": [sgn.name]}, {"Out": [decay.name]},
                        {"scale": self.coeff})
        out = block.create_var(shape=grad.shape, dtype=grad.dtype)
        block.append_op("elementwise_add",
                        {"X": [grad.name], "Y": [decay.name]},
                        {"Out": [out.name]})
        return out


def append_regularization_ops(
        params_grads: List[Tuple[Variable, Variable]],
        regularization: Optional[WeightDecayRegularizer] = None,
        program: Optional[Program] = None
) -> List[Tuple[Variable, Variable]]:
    """Transform each grad with its regularizer (param-level attr wins over
    the global one, mirroring fluid append_regularization_ops)."""
    program = program or default_main_program()
    block = program.global_block()
    out = []
    for param, grad in params_grads:
        reg = getattr(param, "regularizer", None) or regularization
        out.append((param, reg.append_decay(block, param, grad) if reg
                    else grad))
    return out
