from .initializer import (constant, gen1_default, msra, normal, ones,
                          uniform, xavier, zeros)
from .layers import (AvgPool2D, BatchNorm, Conv2D, Conv2DTranspose, Dropout,
                     Embedding, Fc, LayerNorm, Linear, MaxPool2D)
from .module import (Lambda, Module, Sequential, apply_stat_updates,
                     apply_stat_updates_, param_count, run_initializers)

__all__ = ["AvgPool2D", "BatchNorm", "Conv2D", "Conv2DTranspose", "Dropout",
           "Embedding", "Fc", "Lambda", "LayerNorm", "Linear", "MaxPool2D",
           "Module", "Sequential", "apply_stat_updates",
           "apply_stat_updates_", "param_count", "run_initializers",
           "constant", "zeros", "ones", "uniform", "normal", "xavier", "msra",
           "gen1_default"]
