"""fluid — the Program-IR front end, the counterpart of
``paddle_tpu/fluid``, with JAX's names.

Build a Program of ops via ``layers``, differentiate with
``backward.append_backward`` (or optimizer.minimize), and run it with
``Executor`` — which runs each block's ops over torch tensors and replays
them as one cached CUDA graph per signature on the card.
"""

from . import (backward, evaluator, executor, io, layers, nets, optimizer,
               registry, regularizer)
from ..nn import initializer
from .backward import append_backward
from .evaluator import Accuracy as AccuracyEvaluator
from .evaluator import ChunkEvaluator
from ..data.feeder import BucketSpec
from .executor import Executor, Scope, global_scope
from .framework import (Block, Operator, Program, Variable,
                        default_main_program, default_startup_program,
                        program_guard, reset_default_programs)
from .layers import Cond, StaticRNN, While
from .optimizer import (AdadeltaOptimizer, AdagradOptimizer, AdamaxOptimizer,
                        AdamOptimizer, DecayedAdagradOptimizer, FtrlOptimizer,
                        MomentumOptimizer, RMSPropOptimizer, SGDOptimizer)
from .registry import OpRegistry
from .regularizer import L1Decay, L2Decay, append_regularization_ops

__all__ = ["layers", "backward", "io", "optimizer", "registry", "executor",
           "nets", "regularizer", "evaluator", "initializer",
           "append_backward", "Executor", "Scope", "global_scope",
           "BucketSpec",
           "Program", "Block", "Operator", "Variable",
           "default_main_program", "default_startup_program", "program_guard",
           "reset_default_programs", "While", "Cond", "StaticRNN",
           "SGDOptimizer", "MomentumOptimizer", "AdamOptimizer",
           "AdagradOptimizer", "AdadeltaOptimizer", "RMSPropOptimizer",
           "AdamaxOptimizer", "DecayedAdagradOptimizer", "FtrlOptimizer",
           "L1Decay", "L2Decay", "append_regularization_ops",
           "AccuracyEvaluator", "ChunkEvaluator", "OpRegistry"]
