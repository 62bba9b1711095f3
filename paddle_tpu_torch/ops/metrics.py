"""Metric ops — the counterpart of ``paddle_tpu/ops/metrics.py``: the
per-batch counts the evaluators (``trainer/evaluator.py``) accumulate
(the reference's accuracy, auc, precision_recall and chunk_eval
operators and the gserver evaluators' cores), on tensors. Each returns
raw counts so that an evaluator sums them across batches.

The scans of ``chunk_count`` and the dynamic program of
``edit_distance`` (``lax.scan`` and ``fori_loop`` in JAX) are Python
loops over time of batched tensor ops.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.lod import sequence_mask


def accuracy(logits_or_pred: torch.Tensor, labels: torch.Tensor,
             weights: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(num_correct, num_total); ``logits_or_pred`` is argmaxed over its
    last axis when it has one more axis than ``labels``."""
    pred = (torch.argmax(logits_or_pred, -1)
            if logits_or_pred.ndim > labels.ndim else logits_or_pred)
    correct = (pred == labels).to(torch.float32)
    if weights is not None:
        return torch.sum(correct * weights), torch.sum(weights)
    return torch.sum(correct), torch.tensor(float(correct.numel()),
                                            device=correct.device)


def top_k_accuracy(logits: torch.Tensor, labels: torch.Tensor, k: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    _, idx = torch.topk(logits, k)
    hit = torch.any(idx == labels[..., None], dim=-1).to(torch.float32)
    return torch.sum(hit), torch.tensor(float(hit.numel()),
                                        device=hit.device)


def auc_histogram(probs: torch.Tensor, labels: torch.Tensor,
                  num_thresholds: int = 200
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos_hist, neg_hist) [num_thresholds]: positive and negative
    examples per probability bin, for a streaming AUC."""
    p = torch.clamp(probs, 0.0, 1.0)
    bin_idx = torch.clamp((p * num_thresholds).to(torch.int64),
                          max=num_thresholds - 1).reshape(-1)
    lab = labels.to(torch.float32).reshape(-1)
    zeros = torch.zeros(num_thresholds, dtype=torch.float32,
                        device=probs.device)
    return (zeros.index_add(0, bin_idx, lab),
            zeros.index_add(0, bin_idx, 1.0 - lab))


def auc_from_histogram(pos_hist: torch.Tensor, neg_hist: torch.Tensor
                       ) -> torch.Tensor:
    """Trapezoidal AUC over the ROC built from per-bin counts."""
    tp = torch.cumsum(torch.flip(pos_hist, (0,)), 0)
    fp = torch.cumsum(torch.flip(neg_hist, (0,)), 0)
    tot_p = torch.clamp(tp[-1], min=1e-12)
    tot_n = torch.clamp(fp[-1], min=1e-12)
    zero = torch.zeros(1, dtype=tp.dtype, device=tp.device)
    tpr = torch.cat([zero, tp / tot_p])
    fpr = torch.cat([zero, fp / tot_n])
    return torch.sum((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0)


def precision_recall_counts(pred: torch.Tensor, labels: torch.Tensor,
                            num_classes: int) -> torch.Tensor:
    """Per-class [TP, FP, FN] counts of [B] int predictions and labels:
    [num_classes, 3]."""
    onehot_p = F.one_hot(pred.long(), num_classes).to(torch.float32)
    onehot_l = F.one_hot(labels.long(), num_classes).to(torch.float32)
    tp = torch.sum(onehot_p * onehot_l, dim=0)
    fp = torch.sum(onehot_p * (1.0 - onehot_l), dim=0)
    fn = torch.sum((1.0 - onehot_p) * onehot_l, dim=0)
    return torch.stack([tp, fp, fn], dim=1)


def _run(init: torch.Tensor, values: torch.Tensor, starts: torch.Tensor,
         reset_to_value: bool, and_values: bool) -> torch.Tensor:
    """[B, T] running state over time: at a start the state becomes the
    step's value; elsewhere it is kept (``and_values``: ANDed with the
    step's value)."""
    out, run = [], init
    for t in range(values.shape[1]):
        v, s = values[:, t], starts[:, t]
        kept = run & v if and_values else run
        run = torch.where(s, v, kept) if reset_to_value else kept
        out.append(run)
    return torch.stack(out, dim=1)


def chunk_count(pred_tags: torch.Tensor, label_tags: torch.Tensor,
                lengths: torch.Tensor, scheme: str = "IOB",
                num_chunk_types: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunk (NER span) counting for F1, IOB tags (tag = chunk_type * 2 +
    {0: B, 1: I}). Returns (num_correct_chunks, num_pred_chunks,
    num_label_chunks)."""
    B, T = pred_tags.shape
    mask = sequence_mask(lengths, T, torch.bool)

    def starts(tags):
        # a B tag, or an I tag after another chunk type or no tag
        is_b = (tags % 2) == 0
        ctype = tags // 2
        prev = torch.cat([torch.full((B, 1), -1, dtype=tags.dtype,
                                     device=tags.device), tags[:, :-1]], 1)
        is_i = (tags % 2) == 1
        broken = is_i & ((prev < 0) | (prev // 2 != ctype))
        return (is_b | broken) & mask

    ps, ls = starts(pred_tags), starts(label_tags)
    n_pred = torch.sum(ps.to(torch.float32))
    n_label = torch.sum(ls.to(torch.float32))
    same = (pred_tags == label_tags) & mask
    ones = torch.ones(B, dtype=torch.bool, device=pred_tags.device)
    # tags equal all along the label chunk so far (reset at its start)
    run_eq = _run(ones, same, ls, reset_to_value=True, and_values=True)
    # both chunks started at the label chunk's start
    aligned = _run(~ones, ps & ls, ls, reset_to_value=True,
                   and_values=False)
    end_col = torch.ones((B, 1), dtype=torch.bool, device=mask.device)
    nxt_invalid = torch.cat([~mask[:, 1:], end_col], 1)
    chunk_end = mask & (torch.cat([ls[:, 1:], end_col], 1) | nxt_invalid)
    p_end = mask & (torch.cat([ps[:, 1:], end_col], 1) | nxt_invalid)
    correct = torch.sum((chunk_end & p_end & run_eq & aligned)
                        .to(torch.float32))
    return correct, n_pred, n_label


def edit_distance(pred: torch.Tensor, pred_len: torch.Tensor,
                  label: torch.Tensor, label_len: torch.Tensor
                  ) -> torch.Tensor:
    """Levenshtein distance per row of padded [B, Tp] and [B, Tl] ids:
    [B] f32, the dynamic program over the padded shapes, frozen past each
    row's lengths."""
    B, Tp = pred.shape
    Tl = label.shape[1]
    pred_len = pred_len.to(torch.int64)
    label_len = label_len.to(torch.int64)
    dp = torch.arange(Tl + 1, dtype=torch.float32,
                      device=pred.device).expand(B, Tl + 1).clone()
    for i in range(Tp):
        live = i < pred_len
        new = dp.clone()
        new[:, 0] = torch.where(live, dp[:, 0] + 1.0, dp[:, 0])
        for j in range(1, Tl + 1):
            sub = dp[:, j - 1] + (pred[:, i] != label[:, j - 1]).to(
                torch.float32)
            val = torch.minimum(torch.minimum(dp[:, j] + 1.0,
                                              new[:, j - 1] + 1.0), sub)
            new[:, j] = torch.where(live & (j <= label_len), val, dp[:, j])
        dp = new
    return torch.gather(dp, 1, label_len[:, None])[:, 0]


def pnpair_counts(scores: torch.Tensor, labels: torch.Tensor,
                  query_ids: torch.Tensor):
    """Among same-query pairs with different labels: (correctly ordered,
    wrongly ordered, ties) by score, for [N] scores, labels, query ids."""
    s_i, s_j = scores[:, None], scores[None, :]
    cand = ((query_ids[:, None] == query_ids[None, :])
            & (labels[:, None] > labels[None, :]))
    return (torch.sum(cand & (s_i > s_j)), torch.sum(cand & (s_i < s_j)),
            torch.sum(cand & (s_i == s_j)))


def average_precision(scores, matched, n_gt) -> float:
    """Integral AP of one class from decision scores and 0/1 match flags
    (host numpy, as JAX's)."""
    scores = np.asarray(scores, np.float64)
    matched = np.asarray(matched, np.float64)
    if n_gt <= 0 or scores.size == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = np.cumsum(matched[order])
    fp = np.cumsum(1.0 - matched[order])
    rec = tp / n_gt
    prec = tp / np.maximum(tp + fp, 1e-12)
    ap, prev_r = 0.0, 0.0
    for r, p in zip(rec, prec):
        ap += p * (r - prev_r)
        prev_r = r
    return float(ap)
