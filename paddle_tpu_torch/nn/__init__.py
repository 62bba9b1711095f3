from .layers import Embedding, LayerNorm, Linear
from .module import Module, run_initializers

__all__ = ["Embedding", "LayerNorm", "Linear", "Module", "run_initializers"]
