"""Activations — the part of ``paddle_tpu/ops/activations.py`` the
ported models need (``gelu`` for the transformers, ``tanh`` for the
seq2seq decoder's ``init_fc``, ``relu`` for the image models).

``jax.nn.gelu`` defaults to the tanh approximation, so the port's ``gelu``
is ``approximate="tanh"``, not PyTorch's exact default."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"gelu": gelu, "relu": torch.relu, "tanh": torch.tanh}


def get(name: str):
    if name not in ACTIVATIONS:
        raise KeyError(f"unknown activation {name!r} "
                       f"(the port has {sorted(ACTIVATIONS)})")
    return ACTIVATIONS[name]
