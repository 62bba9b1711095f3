"""Large-vocabulary output approximations — the counterpart of
``paddle_tpu/ops/nce.py``: noise-contrastive estimation with sampled
negatives, and the hierarchical sigmoid over a complete binary tree.

Where JAX draws the negatives from a PRNG key, the port draws them from
an explicit ``torch.Generator``; the draw (:func:`_draw_negatives`) is
kept apart from the arithmetic (:func:`_nce_from_negatives`), so the
arithmetic can be held to JAX's on negatives JAX drew. ``-log
sigmoid(x)`` is ``logaddexp(-x, 0)`` (``jax.nn.softplus``), with no
threshold branch as in ``F.softplus``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.place import DeviceLike, require_device


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _draw_negatives(generator: Optional[torch.Generator], vocab: int,
                    num_neg_samples: int,
                    sample_dist: Optional[torch.Tensor] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """``num_neg_samples`` class ids on ``device`` (default: the card),
    uniform over ``vocab`` or drawn from ``sample_dist`` [V] (with
    replacement), from ``generator`` (on that device)."""
    dev = require_device(device)
    if sample_dist is None:
        return torch.randint(0, vocab, (num_neg_samples,),
                             generator=generator, device=dev)
    return torch.multinomial(sample_dist.to(dev), num_neg_samples,
                             replacement=True, generator=generator)


def _nce_from_negatives(hidden: torch.Tensor, labels: torch.Tensor,
                        weight: torch.Tensor, bias: Optional[torch.Tensor],
                        neg: torch.Tensor, *,
                        sample_dist: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The NCE loss, the batch's mean, over the negatives ``neg`` [S]:
    each logit less log(S * q(class)), data against noise through
    -log sigmoid."""
    B = hidden.shape[0]
    V = weight.shape[0]
    S = neg.shape[0]
    labels = labels.to(device=hidden.device, dtype=torch.long)
    neg = neg.to(device=hidden.device, dtype=torch.long)
    if sample_dist is None:
        logq = torch.log(torch.tensor(float(V), dtype=hidden.dtype,
                                      device=hidden.device))
        logq_neg = (-logq).expand(S)
        logq_pos = (-logq).expand(B)
    else:
        logq_neg = torch.log(sample_dist[neg] + 1e-20)
        logq_pos = torch.log(sample_dist[labels] + 1e-20)
    s_pos = torch.sum(hidden * weight[labels], dim=-1)
    s_neg = torch.matmul(hidden, weight[neg].t())               # [B, S]
    if bias is not None:
        s_pos = s_pos + bias[labels]
        s_neg = s_neg + bias[neg][None, :]
    log_k = math.log(float(S))
    pos_logit = s_pos - (log_k + logq_pos)
    neg_logit = s_neg - (log_k + logq_neg[None, :])
    return torch.mean(_softplus(-pos_logit)
                      + torch.sum(_softplus(neg_logit), dim=-1))


def nce_loss(hidden: torch.Tensor, labels: torch.Tensor,
             weight: torch.Tensor, bias: Optional[torch.Tensor],
             generator: Optional[torch.Generator], *,
             num_neg_samples: int = 10,
             sample_dist: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Noise-contrastive estimation loss, the batch's mean. hidden [B, D];
    labels [B]; weight [V, D]; bias [V]. One set of negatives a batch,
    drawn from ``sample_dist`` (default uniform) with ``generator`` (on
    hidden's device)."""
    neg = _draw_negatives(generator, weight.shape[0], num_neg_samples,
                          sample_dist, device=hidden.device)
    return _nce_from_negatives(hidden, labels, weight, bias, neg,
                               sample_dist=sample_dist)


def build_huffman_codes(num_classes: int, device: DeviceLike = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The complete binary tree's codes: class c's path follows the bits
    of c + num_classes (leaves at [V, 2V), inner nodes [1, V)). Returns
    (paths [V, L] inner-node ids, codes [V, L] 0/1 with -1 padding), int32
    on ``device`` (default: the card)."""
    dev = require_device(device)
    L = max(1, int(np.ceil(np.log2(max(num_classes, 2)))))
    paths = np.zeros((num_classes, L), np.int32)
    codes = np.full((num_classes, L), -1, np.int32)
    for c in range(num_classes):
        node = c + num_classes
        bits = []
        while node > 1:
            bits.append((node // 2, node & 1))
            node //= 2
        bits.reverse()
        for i, (parent, bit) in enumerate(bits[:L]):
            paths[c, i] = parent
            codes[c, i] = bit
    return (torch.tensor(paths, device=dev), torch.tensor(codes, device=dev))


def _path_nll(logits: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """-log P of each path step: bit 1 -> sigmoid(logit), bit 0 -> 1 -
    sigmoid; padding steps (code -1) give 0."""
    signed = torch.where(codes == 1, logits, -logits)
    return _softplus(-signed) * (codes >= 0).to(logits.dtype)


def hsigmoid_loss(hidden: torch.Tensor, labels: torch.Tensor,
                  inner_w: torch.Tensor, inner_b: Optional[torch.Tensor],
                  paths: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Hierarchical-sigmoid NLL, the batch's mean. inner_w [2V, D] (rows
    for the inner nodes); paths/codes from :func:`build_huffman_codes`."""
    labels = labels.to(device=hidden.device, dtype=torch.long)
    p = paths[labels].to(torch.long)                           # [B, L]
    logits = torch.einsum("bld,bd->bl", inner_w[p], hidden)
    if inner_b is not None:
        logits = logits + inner_b[p]
    return torch.mean(torch.sum(_path_nll(logits, codes[labels]), dim=-1))


def hsigmoid_logprobs(hidden: torch.Tensor, inner_w: torch.Tensor,
                      inner_b: Optional[torch.Tensor], paths: torch.Tensor,
                      codes: torch.Tensor) -> torch.Tensor:
    """The full log-distribution [B, V] (small V: evaluation, tests)."""
    p = paths.to(torch.long)
    logits = torch.einsum("vld,bd->bvl", inner_w[p], hidden)
    if inner_b is not None:
        logits = logits + inner_b[p][None]
    return -torch.sum(_path_nll(logits, codes[None]), dim=-1)
