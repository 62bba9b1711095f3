"""Gradient clipping — the counterpart of ``paddle_tpu/optimizer/clip.py``
(the reference's OptimizerWithGradientClipping, clip_op and fluid's
GradientClipByGlobalNorm), with the per-tensor ``clip_by_norm`` of
``paddle_tpu/ops/math.py`` folded in. Trees are nested dicts of tensors
(``core/pytree.py``)."""

from __future__ import annotations

from typing import Mapping

import torch

from ..core.pytree import tree_items, tree_map


def clip_by_value(grads: Mapping, min_val: float, max_val: float):
    return tree_map(lambda g: torch.clamp(g, min_val, max_val), grads)


def clip_tensor_by_norm(x: torch.Tensor, max_norm: float) -> torch.Tensor:
    """One tensor scaled to L2 norm ``max_norm`` when its norm is larger
    (``paddle_tpu/ops/math.py`` ``clip_by_norm``)."""
    norm = torch.sqrt(torch.sum(torch.square(x)))
    return torch.where(norm > max_norm,
                       x * (max_norm / torch.clamp(norm, min=1e-12)), x)


def clip_by_norm(grads: Mapping, max_norm: float):
    """Each leaf clipped to its own norm ``max_norm``."""
    return tree_map(lambda g: clip_tensor_by_norm(g, max_norm), grads)


def global_norm(grads: Mapping) -> torch.Tensor:
    """The L2 norm of all the leaves together."""
    return torch.sqrt(sum(torch.sum(torch.square(g))
                          for _, g in tree_items(grads)))


def clip_by_global_norm(grads: Mapping, max_norm: float):
    """Every leaf scaled by min(1, max_norm / global norm)."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale, grads)
