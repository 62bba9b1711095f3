"""Program-level optimizers: minimize() appends backward + update ops.

Reference: fluid/optimizer.py — SGD/Momentum/Adam emit optimizer OpDescs plus
learning-rate and accumulator variables into the program
(operators/{sgd,momentum,adam}_op.cc compute the updates). Same structure here;
the update ops run inside the executor's single compiled computation, so the
whole train step (fwd+bwd+update) is one CUDA graph — the fusion the reference
could not get from per-op dispatch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..nn import initializer as I
from .backward import append_backward
from .framework import (Program, Variable, default_main_program,
                        default_startup_program)


class Optimizer:
    def __init__(self, learning_rate: float = 0.01):
        self.learning_rate = learning_rate
        self._lr_var: Optional[Variable] = None

    # -- helpers -----------------------------------------------------------
    def _ensure_lr(self, program: Program) -> Variable:
        if self._lr_var is not None:
            return self._lr_var
        b = program.global_block()
        name = program.unique_name("learning_rate")
        v = b.create_var(name=name, shape=(), dtype="float32",
                         persistable=True, trainable=False)
        sb = default_startup_program().global_block()
        sb.create_var(name=name, shape=(), dtype="float32", persistable=True)
        sb.append_op("fill_init", {}, {"Out": [name]},
                     {"shape": (), "dtype": "float32",
                      "init": I.constant(self.learning_rate), "seed": 0})
        self._lr_var = v
        return v

    def _accumulator(self, program: Program, param: Variable, suffix: str,
                     shape=None, value: float = 0.0) -> Variable:
        b = program.global_block()
        name = f"{param.name}@{suffix}"
        shape = tuple(param.shape if shape is None else shape)
        v = b.create_var(name=name, shape=shape, dtype=param.dtype,
                         persistable=True, trainable=False)
        sb = default_startup_program().global_block()
        sb.create_var(name=name, shape=shape, dtype=param.dtype,
                      persistable=True)
        sb.append_op("fill_init", {}, {"Out": [name]},
                     {"shape": shape, "dtype": param.dtype,
                      "init": I.constant(value), "seed": 0})
        return v

    def _append_update(self, program, param, grad, lr):
        raise NotImplementedError

    # -- public ------------------------------------------------------------
    def minimize(self, loss: Variable, program: Optional[Program] = None,
                 regularization=None) -> List[Tuple]:
        program = program or default_main_program()
        pg = append_backward(loss, program=program)
        if regularization is not None:
            from .regularizer import append_regularization_ops
            # a per-param l2_rate (ParamAttr) REPLACES the global default
            # for that parameter (ParameterAttribute semantics), so exclude
            # those pairs from the global pass
            rest = [(p, g) for p, g in pg
                    if getattr(p, "l2_rate", None) is None]
            decayed = dict(
                (p.name, (p, g))
                for p, g in append_regularization_ops(rest, regularization,
                                                      program))
            pg = [(p, g) if getattr(p, "l2_rate", None) is not None
                  else decayed[p.name] for p, g in pg]
        lr = self._ensure_lr(program)
        blk = program.global_block()
        for param, grad in pg:
            # per-parameter ParamAttr settings (ParameterAttribute
            # l2_rate/learning_rate, parameter/ParameterOptimizer semantics):
            # decay folds into the grad; lr scaling produces a scaled lr
            # variable so the rule is exact for adaptive optimizers too
            l2 = getattr(param, "l2_rate", None)
            if l2:
                decay = blk.create_var(shape=param.shape, dtype=param.dtype)
                blk.append_op("scale", {"X": [param.name]},
                              {"Out": [decay.name]}, {"scale": l2})
                g2 = blk.create_var(shape=grad.shape, dtype=grad.dtype)
                blk.append_op("elementwise_add",
                              {"X": [grad.name], "Y": [decay.name]},
                              {"Out": [g2.name]})
                grad = g2
            scale = getattr(param, "lr_scale", None)
            lr_eff = lr
            if scale is not None and scale != 1.0:
                lr_eff = blk.create_var(shape=lr.shape, dtype=lr.dtype)
                blk.append_op("scale", {"X": [lr.name]},
                              {"Out": [lr_eff.name]}, {"scale": scale})
            self._append_update(program, param, grad, lr_eff)
        return pg


class SGDOptimizer(Optimizer):
    def _append_update(self, program, param, grad, lr):
        program.global_block().append_op(
            "sgd",
            {"Param": [param.name], "Grad": [grad.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [param.name]})


class MomentumOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, momentum: float = 0.9,
                 use_nesterov: bool = False):
        super().__init__(learning_rate)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _append_update(self, program, param, grad, lr):
        vel = self._accumulator(program, param, "velocity")
        program.global_block().append_op(
            "momentum",
            {"Param": [param.name], "Grad": [grad.name],
             "Velocity": [vel.name], "LearningRate": [lr.name]},
            {"ParamOut": [param.name], "VelocityOut": [vel.name]},
            {"mu": self.momentum, "use_nesterov": self.use_nesterov})


class AdamOptimizer(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_update(self, program, param, grad, lr):
        m1 = self._accumulator(program, param, "moment1")
        m2 = self._accumulator(program, param, "moment2")
        b1p = self._accumulator(program, param, "beta1_pow", shape=(),
                                value=self.beta1)
        b2p = self._accumulator(program, param, "beta2_pow", shape=(),
                                value=self.beta2)
        program.global_block().append_op(
            "adam",
            {"Param": [param.name], "Grad": [grad.name],
             "Moment1": [m1.name], "Moment2": [m2.name],
             "Beta1Pow": [b1p.name], "Beta2Pow": [b2p.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [param.name], "Moment1Out": [m1.name],
             "Moment2Out": [m2.name], "Beta1PowOut": [b1p.name],
             "Beta2PowOut": [b2p.name]},
            {"beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon})


class AdagradOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, epsilon: float = 1e-6):
        super().__init__(learning_rate)
        self.epsilon = epsilon

    def _append_update(self, program, param, grad, lr):
        m = self._accumulator(program, param, "moment")
        program.global_block().append_op(
            "adagrad",
            {"Param": [param.name], "Grad": [grad.name], "Moment": [m.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [param.name], "MomentOut": [m.name]},
            {"epsilon": self.epsilon})


class AdadeltaOptimizer(Optimizer):
    def __init__(self, learning_rate=1.0, rho: float = 0.95,
                 epsilon: float = 1e-6):
        super().__init__(learning_rate)
        self.rho, self.epsilon = rho, epsilon

    def _append_update(self, program, param, grad, lr):
        ag = self._accumulator(program, param, "avg_squared_grad")
        au = self._accumulator(program, param, "avg_squared_update")
        program.global_block().append_op(
            "adadelta",
            {"Param": [param.name], "Grad": [grad.name],
             "AvgSquaredGrad": [ag.name], "AvgSquaredUpdate": [au.name]},
            {"ParamOut": [param.name], "AvgSquaredGradOut": [ag.name],
             "AvgSquaredUpdateOut": [au.name]},
            {"rho": self.rho, "epsilon": self.epsilon})


class RMSPropOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, decay: float = 0.9,
                 momentum: float = 0.0, epsilon: float = 1e-6):
        super().__init__(learning_rate)
        self.decay, self.momentum, self.epsilon = decay, momentum, epsilon

    def _append_update(self, program, param, grad, lr):
        ms = self._accumulator(program, param, "mean_square")
        mom = self._accumulator(program, param, "rms_moment")
        program.global_block().append_op(
            "rmsprop",
            {"Param": [param.name], "Grad": [grad.name],
             "MeanSquare": [ms.name], "Moment": [mom.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [param.name], "MeanSquareOut": [ms.name],
             "MomentOut": [mom.name]},
            {"decay": self.decay, "momentum": self.momentum,
             "epsilon": self.epsilon})


class AdamaxOptimizer(Optimizer):
    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _append_update(self, program, param, grad, lr):
        m = self._accumulator(program, param, "adamax_moment")
        u = self._accumulator(program, param, "inf_norm")
        b1p = self._accumulator(program, param, "beta1_pow_ax", shape=(),
                                value=self.beta1)
        program.global_block().append_op(
            "adamax",
            {"Param": [param.name], "Grad": [grad.name], "Moment": [m.name],
             "InfNorm": [u.name], "Beta1Pow": [b1p.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [param.name], "MomentOut": [m.name],
             "InfNormOut": [u.name], "Beta1PowOut": [b1p.name]},
            {"beta1": self.beta1, "beta2": self.beta2,
             "epsilon": self.epsilon})


class DecayedAdagradOptimizer(Optimizer):
    def __init__(self, learning_rate=0.01, decay: float = 0.95,
                 epsilon: float = 1e-6):
        super().__init__(learning_rate)
        self.decay, self.epsilon = decay, epsilon

    def _append_update(self, program, param, grad, lr):
        m = self._accumulator(program, param, "decayed_moment")
        program.global_block().append_op(
            "decayed_adagrad",
            {"Param": [param.name], "Grad": [grad.name], "Moment": [m.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [param.name], "MomentOut": [m.name]},
            {"decay": self.decay, "epsilon": self.epsilon})


class FtrlOptimizer(Optimizer):
    """FTRL-proximal (ref: operators/ftrl_op.cc) — the CTR-model staple."""

    def __init__(self, learning_rate=0.01, l1: float = 0.0, l2: float = 0.0):
        super().__init__(learning_rate)
        self.l1, self.l2 = l1, l2

    def _append_update(self, program, param, grad, lr):
        sq = self._accumulator(program, param, "squared_accum")
        lin = self._accumulator(program, param, "linear_accum")
        program.global_block().append_op(
            "ftrl",
            {"Param": [param.name], "Grad": [grad.name],
             "SquaredAccumulator": [sq.name], "LinearAccumulator": [lin.name],
             "LearningRate": [lr.name]},
            {"ParamOut": [param.name], "SquaredAccumOut": [sq.name],
             "LinearAccumOut": [lin.name]},
            {"l1": self.l1, "l2": self.l2})
