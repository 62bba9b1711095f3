from .clip import (clip_by_global_norm, clip_by_norm, clip_by_value,
                   global_norm)
from .hooks import HookSet, ParameterHook, PruningHook, StaticHook
from .lr_scheduler import (constant_lr, discexp_lr, exponential_decay,
                           inverse_time_decay, linear_warmup,
                           natural_exp_decay, piecewise_decay, poly_decay)
from .optimizers import (SGD, Adadelta, Adagrad, Adam, Adamax,
                         DecayedAdagrad, Ftrl, Momentum, Optimizer,
                         ParameterAverager, ProximalGD, RMSProp)

__all__ = [
    "HookSet", "ParameterHook", "PruningHook", "StaticHook",
    "Optimizer", "SGD", "Momentum", "Adagrad", "DecayedAdagrad", "Adadelta",
    "RMSProp", "Adam", "Adamax", "ProximalGD", "Ftrl", "ParameterAverager",
    "constant_lr", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "poly_decay", "piecewise_decay", "linear_warmup",
    "discexp_lr", "clip_by_value", "clip_by_norm", "clip_by_global_norm",
    "global_norm",
]
