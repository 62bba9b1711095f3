"""Core layers — the part of ``paddle_tpu/nn/layers.py`` the ported models
need: ``Linear``, ``Embedding``, ``LayerNorm``, and for the image models
``Conv2D``, ``Conv2DTranspose``, ``BatchNorm``, ``Dropout``,
``MaxPool2D`` and ``AvgPool2D``, with the JAX layers' default
initializers (``Linear.w`` xavier-uniform, ``Embedding.w`` normal(0,
0.01), conv weights msra).

Parameters keep the JAX package's names and layouts (``Linear.w`` is
[in, out] and the layer computes ``x @ w + b``; a conv weight is HWIO
over NHWC activations; ``BatchNorm`` keeps its moving stats under
``stats``), so a JAX parameter tree loads without reshaping
(``paddle_tpu_torch/convert.py``). A layer is built with its parameters
on the ``meta`` device; the owning model's ``init`` materializes them on
a real device and runs the initializers in ``_inits`` (``nn/module.py``).
Every forward takes and ignores keywords it has no use for, as JAX's
``__call__`` does, so that ``Sequential`` can hand ``train=`` to all.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..ops import activations as A
from ..ops import conv as conv_ops
from ..ops import norm as norm_ops
from ..ops import pool as pool_ops
from ..ops.random import dropout as dropout_op
from . import initializer as I
from .module import Module

Act = Union[None, str, Callable]


def _act(act: Act) -> Optional[Callable]:
    """None, a function, or the name of one in ``ops.activations``."""
    return A.get(act) if isinstance(act, str) else act


def _apply(act: Optional[Callable], y: torch.Tensor) -> torch.Tensor:
    return y if act is None else act(y)


class Linear(Module):
    def __init__(self, in_dim: int, out_dim: int, act: Act = None,
                 bias: bool = True, w_init: Optional[I.Initializer] = None):
        super().__init__()
        self.in_dim, self.out_dim = in_dim, out_dim
        self.act = _act(act)
        self.use_bias = bias
        self.param("w", (in_dim, out_dim), w_init or I.xavier())
        if bias:
            self.param("b", (out_dim,), I.zeros)

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        """``x @ w + b``; an input of more than two axes whose last is not
        ``in_dim`` is flattened to [B, -1] first (a conv map into a
        classifier), as JAX's ``Linear`` does."""
        if x.dim() > 2 and x.shape[-1] != self.in_dim:
            x = x.reshape(x.shape[0], -1)
        y = torch.matmul(x, self.w)
        if self.use_bias:
            y = y + self.b
        return _apply(self.act, y)


# gen-1 name
Fc = Linear


class Embedding(Module):
    def __init__(self, vocab_size: int, dim: int,
                 w_init: Optional[I.Initializer] = None):
        super().__init__()
        self.vocab_size, self.dim = vocab_size, dim
        self.param("w", (vocab_size, dim), w_init or I.normal(0.0, 0.01))

    def forward(self, ids: torch.Tensor, **kw) -> torch.Tensor:
        return self.w[ids.long()]


class LayerNorm(Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.param("gamma", (dim,), I.ones)
        self.param("beta", (dim,), I.zeros)

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return norm_ops.layer_norm(x, self.gamma, self.beta, self.eps)


class Conv2D(Module):
    """2-D conv + bias + act, NHWC, weight ``w`` [kh, kw, in/groups, out].

    The JAX layer routes the ImageNet stem (7x7, stride 2, pad 3, at most
    4 input channels) through the exact space-to-depth rewrite
    (``ops/conv.py`` ``conv7s2``) to deepen the TPU's contraction. Here
    every conv, the stem too, is the direct one: the same function, and on
    an H100 the faster (bf16 forward and weight gradient at 64x224x224x3 ->
    64: 0.768 against 1.019 ms, chip_smoke phase 13); its output is also a
    contiguous channels-last map, where the rewrite's crop hands the next
    batch norm a strided one that PyTorch's slow generic BN kernel takes
    (PERF.md, PR 14)."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1,
                 padding=0, dilation=1, groups: int = 1, act: Act = None,
                 bias: bool = True, w_init: Optional[I.Initializer] = None):
        super().__init__()
        k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.act = _act(act)
        self.use_bias = bias
        self.param("w", k + (in_ch // groups, out_ch), w_init or I.msra())
        if bias:
            self.param("b", (out_ch,), I.zeros)

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        y = conv_ops.conv2d(x, self.w, stride=self.stride,
                            padding=self.padding, dilation=self.dilation,
                            groups=self.groups)
        if self.use_bias:
            y = y + self.b
        return _apply(self.act, y)


class Conv2DTranspose(Module):
    """Transposed conv (``ops/conv.py`` ``conv2d_transpose``) + bias + act,
    weight ``w`` [kh, kw, in, out]."""

    def __init__(self, in_ch: int, out_ch: int, kernel, stride=1, padding=0,
                 act: Act = None, bias: bool = True):
        super().__init__()
        k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        self.stride, self.padding = stride, padding
        self.act = _act(act)
        self.use_bias = bias
        self.param("w", k + (in_ch, out_ch), I.msra())
        if bias:
            self.param("b", (out_ch,), I.zeros)

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        y = conv_ops.conv2d_transpose(x, self.w, stride=self.stride,
                                      padding=self.padding)
        if self.use_bias:
            y = y + self.b
        return _apply(self.act, y)


class BatchNorm(Module):
    """Batch norm over the last axis (``ops/norm.py`` ``batch_norm``) with
    ``gamma``, ``beta`` and the running ``stats/moving_mean`` and
    ``stats/moving_var``. In training mode the new stats are recorded in
    ``mutable`` (``Module.record_stats``), not written."""

    def __init__(self, channels: int, momentum: float = 0.9,
                 eps: float = 1e-5, act: Act = None):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.act = _act(act)
        self.param("gamma", (channels,), I.ones)
        self.param("beta", (channels,), I.zeros)
        self.stat("moving_mean", (channels,), I.zeros)
        self.stat("moving_var", (channels,), I.ones)

    def forward(self, x: torch.Tensor, train: bool = False,
                mutable: Optional[dict] = None, **kw) -> torch.Tensor:
        y, new_mean, new_var = norm_ops.batch_norm(
            x, self.gamma, self.beta, self.stats.moving_mean,
            self.stats.moving_var, train=train, momentum=self.momentum,
            eps=self.eps)
        if train:
            self.record_stats(mutable, {"moving_mean": new_mean,
                                        "moving_var": new_var})
        return _apply(self.act, y)


class Dropout(Module):
    """Dropout at ``rate`` in training mode with a ``generator`` (none:
    x as it is)."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None, **kw
                ) -> torch.Tensor:
        if not train or generator is None:
            return x
        return dropout_op(x, self.rate, generator, train=True)


class MaxPool2D(Module):
    def __init__(self, kernel, stride=None, padding=0):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return pool_ops.max_pool2d(x, self.kernel, self.stride, self.padding)


class AvgPool2D(Module):
    def __init__(self, kernel, stride=None, padding=0):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x: torch.Tensor, **kw) -> torch.Tensor:
        return pool_ops.avg_pool2d(x, self.kernel, self.stride, self.padding)
