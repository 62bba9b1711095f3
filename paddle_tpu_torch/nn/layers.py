"""Core layers — the part of ``paddle_tpu/nn/layers.py`` the ported models
need: ``Linear``, ``Embedding`` and ``LayerNorm``, with the JAX layers'
default initializers (``Linear.w`` xavier-uniform, ``Embedding.w``
normal(0, 0.01)).

Parameters keep the JAX package's names and layouts (``Linear.w`` is
[in, out] and the layer computes ``x @ w + b``), so a JAX parameter tree
loads without reshaping (``paddle_tpu_torch/convert.py``). A layer is
built with its parameters on the ``meta`` device; the owning model's
``init`` materializes them on a real device and runs the initializers in
``_inits`` (``nn/module.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import activations as A
from ..ops import norm as norm_ops
from . import initializer as I
from .module import Module


class Linear(Module):
    def __init__(self, in_dim: int, out_dim: int, act: Optional[str] = None,
                 bias: bool = True, w_init: Optional[I.Initializer] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.act = None if act is None else A.get(act)
        self.use_bias = bias
        self.param("w", (in_dim, out_dim), w_init or I.xavier())
        if bias:
            self.param("b", (out_dim,), I.zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.matmul(x, self.w)
        if self.use_bias:
            y = y + self.b
        return y if self.act is None else self.act(y)


class Embedding(Module):
    def __init__(self, vocab_size: int, dim: int,
                 w_init: Optional[I.Initializer] = None):
        super().__init__()
        self.vocab_size, self.dim = vocab_size, dim
        self.param("w", (vocab_size, dim), w_init or I.normal(0.0, 0.01))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w[ids.long()]


class LayerNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.param("gamma", (dim,), I.ones)
        self.param("beta", (dim,), I.zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_ops.layer_norm(x, self.gamma, self.beta, self.eps)
