"""Sequence pooling over padded LoD batches — the part of
``paddle_tpu/ops/sequence.py`` the text classifiers use: ``sequence_pool``
(max, average, sum), ``sequence_last_step`` and ``sequence_first_step``.
All take (x [B, T, ...], lengths [B]) in place of LoD offsets."""

from __future__ import annotations

import torch

from ..core.lod import sequence_mask


def _masked(x: torch.Tensor, lengths: torch.Tensor, fill: float):
    m = sequence_mask(lengths, x.shape[1], torch.bool)
    m = m.reshape(m.shape + (1,) * (x.dim() - 2))
    return torch.where(m, x, torch.full((), fill, dtype=x.dtype,
                                        device=x.device))


def sequence_pool(x: torch.Tensor, lengths: torch.Tensor,
                  pool_type: str = "average") -> torch.Tensor:
    """[B, T, D] -> [B, D] over each sample's first ``length`` steps.
    ``pool_type``: average | sum | max | last | first. A length-0 sample
    averages to 0 (its count is clamped to 1) and max-pools to 0."""
    lengths = lengths.to(x.device)
    tail = (1,) * (x.dim() - 2)
    if pool_type in ("average", "avg"):
        n = torch.clamp(lengths.to(x.dtype), min=1).reshape((-1,) + tail)
        return torch.sum(_masked(x, lengths, 0.0), dim=1) / n
    if pool_type == "sum":
        return torch.sum(_masked(x, lengths, 0.0), dim=1)
    if pool_type == "max":
        empty = (lengths == 0).reshape((-1,) + tail)
        return torch.where(empty, torch.zeros((), dtype=x.dtype,
                                              device=x.device),
                           torch.amax(_masked(x, lengths, -torch.inf),
                                      dim=1))
    if pool_type == "last":
        idx = torch.clamp(lengths - 1, min=0).to(torch.long)
        return x[torch.arange(x.shape[0], device=x.device), idx]
    if pool_type == "first":
        return x[:, 0]
    raise ValueError(f"unknown pool_type {pool_type!r}")


def sequence_last_step(x: torch.Tensor, lengths: torch.Tensor):
    return sequence_pool(x, lengths, "last")


def sequence_first_step(x: torch.Tensor, lengths: torch.Tensor):
    return sequence_pool(x, lengths, "first")
