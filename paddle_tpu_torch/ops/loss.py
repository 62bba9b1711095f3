"""Losses — ``softmax_with_cross_entropy`` of ``paddle_tpu/ops/loss.py``,
per example ([B]); reduce with ``mean`` for the scalar cost."""

from __future__ import annotations

import torch


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               soft_label: bool = False) -> torch.Tensor:
    """-log softmax(logits)[label], through ``log_softmax`` (numerically
    stable); ``soft_label``: label is a distribution over classes."""
    logp = torch.log_softmax(logits, dim=-1)
    if soft_label:
        return -torch.sum(label * logp, dim=-1)
    return -torch.gather(logp, -1, label.to(torch.long)[..., None])[..., 0]
