"""Fluid evaluators: metric ops + cross-batch accumulator state.

Analog of python/paddle/v2/fluid/evaluator.py — an Evaluator owns persistable
state vars accumulated every batch inside the SAME compiled train step, plus
a host-side ``eval()`` that combines them and ``reset()`` that zeroes them
(the reference resets by re-running the state init ops).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..nn import initializer as I
from .framework import Variable, default_main_program, default_startup_program


class Evaluator:
    def __init__(self, name: str):
        main = default_main_program()
        self.name = main.unique_name(name)
        self._states: List[Variable] = []

    def _create_state(self, suffix: str, shape, dtype="float32") -> Variable:
        main = default_main_program()
        name = f"{self.name}_{suffix}"
        v = main.global_block().create_var(name=name, shape=shape, dtype=dtype,
                                           persistable=True, trainable=False)
        sb = default_startup_program().global_block()
        sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
        sb.append_op("fill_init", {}, {"Out": [name]},
                     {"shape": tuple(shape), "dtype": dtype,
                      "init": I.constant(0.0), "seed": 0})
        self._states.append(v)
        return v

    def reset(self, executor):
        import torch
        for v in self._states:
            executor.scope.set(v.name, torch.zeros(
                v.shape, dtype=getattr(torch, v.dtype),
                device=executor.device))

    def eval(self, executor) -> float:
        raise NotImplementedError


class Accuracy(Evaluator):
    """Streaming accuracy (fluid/evaluator.py Accuracy): per-batch correct and
    total accumulate into persistable states updated by IR ops."""

    def __init__(self, input: Variable, label: Variable):
        super().__init__("accuracy")
        main = default_main_program()
        b = main.global_block()
        correct = b.create_var(shape=(), dtype="float32")
        total = b.create_var(shape=(), dtype="float32")
        acc = b.create_var(shape=(), dtype="float32")
        b.append_op("accuracy", {"Out": [input.name], "Label": [label.name]},
                    {"Accuracy": [acc.name], "Correct": [correct.name],
                     "Total": [total.name]})
        self.batch_acc = acc
        self._tot_correct = self._create_state("correct", ())
        self._tot_total = self._create_state("total", ())
        for state, batch in ((self._tot_correct, correct),
                             (self._tot_total, total)):
            b.append_op("elementwise_add",
                        {"X": [state.name], "Y": [batch.name]},
                        {"Out": [state.name]})

    def eval(self, executor) -> float:
        c = float(np.asarray(executor.scope.get(self._tot_correct.name)))
        t = float(np.asarray(executor.scope.get(self._tot_total.name)))
        return c / max(t, 1.0)


class ChunkEvaluator(Evaluator):
    """Streaming chunk F1 (fluid evaluator ChunkEvaluator; ChunkEvaluator.cpp)."""

    def __init__(self, inference: Variable, label: Variable, lengths: Variable,
                 chunk_scheme: str = "IOB", num_chunk_types: int = 1):
        super().__init__("chunk")
        from . import layers
        b = default_main_program().global_block()
        c, p, l = layers.chunk_eval(inference, label, lengths,
                                    chunk_scheme, num_chunk_types)
        self._c = self._create_state("correct", ())
        self._p = self._create_state("predicted", ())
        self._l = self._create_state("labeled", ())
        for state, batch in ((self._c, c), (self._p, p), (self._l, l)):
            b.append_op("elementwise_add",
                        {"X": [state.name], "Y": [batch.name]},
                        {"Out": [state.name]})

    def eval(self, executor) -> float:
        c = float(np.asarray(executor.scope.get(self._c.name)))
        p = float(np.asarray(executor.scope.get(self._p.name)))
        l = float(np.asarray(executor.scope.get(self._l.name)))
        precision = c / p if p else 0.0
        recall = c / l if l else 0.0
        return (2 * precision * recall / (precision + recall)
                if precision + recall else 0.0)
