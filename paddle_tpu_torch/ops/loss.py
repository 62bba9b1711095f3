"""Losses — the counterpart of ``paddle_tpu/ops/loss.py``: the cost-layer
zoo (cross-entropy, sigmoid cross-entropy, squared error, smooth L1, the
huber losses, hinge, log and rank losses, NCE's two-logit form, the
masked sequence mean). Each returns per-example losses ([B]) as JAX's
do; reduce with ``mean`` for the scalar cost. The formulas are JAX's:
``sigmoid_cross_entropy_with_logits`` is ``max(x, 0) - x * l +
log1p(exp(-|x|))``, not ``F.binary_cross_entropy_with_logits``.
"""

from __future__ import annotations

import torch

from ..core.lod import sequence_mask


def _first(x: torch.Tensor) -> torch.Tensor:
    """x[..., 0] of a [B, 1] score, a [B] score as it is."""
    return x[..., 0] if x.dim() > 1 else x


def _per_example_sum(per: torch.Tensor) -> torch.Tensor:
    return torch.sum(per.reshape(per.shape[0], -1), dim=-1)


def cross_entropy(probs: torch.Tensor, label: torch.Tensor,
                  soft_label: bool = False, eps: float = 1e-8
                  ) -> torch.Tensor:
    """-log p[label] over probabilities (``soft_label``: label is a
    distribution over classes)."""
    if soft_label:
        return -torch.sum(label * torch.log(probs + eps), dim=-1)
    p = torch.gather(probs, -1, label.to(torch.long)[..., None])
    return -torch.log(p[..., 0] + eps)


def softmax_with_cross_entropy(logits: torch.Tensor, label: torch.Tensor,
                               soft_label: bool = False) -> torch.Tensor:
    """-log softmax(logits)[label], through ``log_softmax`` (numerically
    stable); ``soft_label``: label is a distribution over classes."""
    logp = torch.log_softmax(logits, dim=-1)
    if soft_label:
        return -torch.sum(label * logp, dim=-1)
    return -torch.gather(logp, -1, label.to(torch.long)[..., None])[..., 0]


def sigmoid_cross_entropy_with_logits(x: torch.Tensor, label: torch.Tensor
                                      ) -> torch.Tensor:
    """Elementwise ``max(x, 0) - x * label + log1p(exp(-|x|))``."""
    return (torch.clamp(x, min=0.0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))


def square_error(x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Half the sum of squares of x - label per example."""
    return 0.5 * _per_example_sum(torch.square(x - label))


def smooth_l1(x: torch.Tensor, label: torch.Tensor, sigma: float = 1.0
              ) -> torch.Tensor:
    s2 = sigma * sigma
    d = torch.abs(x - label)
    per = torch.where(d < 1.0 / s2, 0.5 * s2 * torch.square(d), d - 0.5 / s2)
    return _per_example_sum(per)


def huber_regression(x: torch.Tensor, label: torch.Tensor,
                     delta: float = 1.0) -> torch.Tensor:
    d = torch.abs(x - label)
    per = torch.where(d <= delta, 0.5 * torch.square(d),
                      delta * (d - 0.5 * delta))
    return _per_example_sum(per)


def huber_classification(x: torch.Tensor, label: torch.Tensor
                         ) -> torch.Tensor:
    """Two-class huber; label in {0, 1}."""
    a = (2.0 * label - 1.0) * _first(x)
    return torch.where(a < -1.0, -4.0 * a,
                       torch.where(a < 1.0, torch.square(1.0 - a),
                                   torch.zeros_like(a)))


def modified_huber(x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """label in {0, 1}."""
    a = (2.0 * label - 1.0) * _first(x)
    return torch.where(a < -1.0, -4.0 * a,
                       torch.square(torch.clamp(1.0 - a, min=0.0)))


def hinge(x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """label in {0, 1}."""
    return torch.clamp(1.0 - (2.0 * label - 1.0) * _first(x), min=0.0)


def log_loss(prob: torch.Tensor, label: torch.Tensor, eps: float = 1e-7
             ) -> torch.Tensor:
    p = _first(prob)
    return (-label * torch.log(p + eps)
            - (1.0 - label) * torch.log(1.0 - p + eps))


def rank_loss(left: torch.Tensor, right: torch.Tensor, label: torch.Tensor
              ) -> torch.Tensor:
    """Pairwise RankNet loss; label = 1 where left should rank higher."""
    d = _first(left - right)
    return torch.log1p(torch.exp(d)) - label * d


def margin_rank_loss(left: torch.Tensor, right: torch.Tensor,
                     label: torch.Tensor, margin: float = 0.0
                     ) -> torch.Tensor:
    """label in {-1, 1}."""
    return torch.clamp(-label * (_first(left) - _first(right)) + margin,
                       min=0.0)


def multi_binary_label_cross_entropy(logits: torch.Tensor,
                                     labels: torch.Tensor) -> torch.Tensor:
    """Sigmoid cross-entropy summed over the classes."""
    return torch.sum(sigmoid_cross_entropy_with_logits(logits, labels),
                     dim=-1)


def soft_binary_class_cross_entropy(p: torch.Tensor, label: torch.Tensor,
                                    eps: float = 1e-8) -> torch.Tensor:
    per = (-label * torch.log(p + eps)
           - (1.0 - label) * torch.log(1.0 - p + eps))
    return _per_example_sum(per)


def squared_l2_norm(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares of all of x (a scalar)."""
    return torch.sum(torch.square(x))


def kldiv_loss(logp: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sum(target * (torch.log(torch.clamp(target, min=1e-12))
                               - logp), dim=-1)


def nce_loss(logits_pos: torch.Tensor, logits_neg: torch.Tensor
             ) -> torch.Tensor:
    """NCE over given logits: the positive's [B] against ones, the
    negatives' [B, K] against zeros, summed per example (``ops/nce.py``
    draws the negatives)."""
    pos = sigmoid_cross_entropy_with_logits(logits_pos,
                                            torch.ones_like(logits_pos))
    neg = sigmoid_cross_entropy_with_logits(logits_neg,
                                            torch.zeros_like(logits_neg))
    return pos + torch.sum(neg, dim=-1)


def masked_seq_loss(per_step_loss: torch.Tensor, lengths: torch.Tensor
                    ) -> torch.Tensor:
    """The mean of a padded per-step loss [B, T] over each sequence's valid
    steps (the count held at >= 1)."""
    lengths = lengths.to(per_step_loss.device)
    m = sequence_mask(lengths, per_step_loss.shape[1], per_step_loss.dtype)
    return (torch.sum(per_step_loss * m, dim=1)
            / torch.clamp(lengths.to(per_step_loss.dtype), min=1.0))
