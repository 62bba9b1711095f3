"""Object detection — the counterpart of ``paddle_tpu/ops/detection.py``:
the SSD suite (prior boxes, IoU, box encoding, prior matching, the
multibox loss with hard-negative mining, fixed-shape NMS and the
detection output).

Boxes are [xmin, ymin, xmax, ymax] normalized to [0, 1]. As in JAX,
``match_priors``, ``multibox_loss``, ``nms`` and ``detection_output``
take ONE image, and a caller batches them with ``torch.func.vmap`` (JAX's
callers ``jax.vmap`` them): every body is functional, with no in-place
write and no host read, so a batch of them runs inside a CUDA graph.
``detection_output`` runs its classes' NMS as one loop over the k
candidates of a [classes, k] batch, not one loop a class; the result is
the class-by-class loop's.

Ties and duplicate indices resolve by fixed rules (JAX's where it has
one):

* ``nms`` ranks its candidates by a stable descending sort, the lower
  index first among equal scores (``lax.top_k``'s order);
  ``torch.topk`` promises no order among ties on the card.
* ``multibox_loss`` ranks the negatives by a stable sort of -ce, as
  ``jnp.argsort`` (stable) does.
* ``match_priors``: when two real ground-truth boxes have the same best
  prior, the one with the HIGHER index is force-matched to it. JAX
  scatters both onto that prior, and XLA's order among duplicate
  indices is unspecified; here the rule is a max over the gts, with no
  scatter.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..core.place import DeviceLike, require_device
from .loss import smooth_l1


def prior_box(feature_hw: Tuple[int, int], image_hw: Tuple[int, int],
              min_size: float, max_size: Optional[float] = None,
              aspect_ratios: Sequence[float] = (2.0,), flip: bool = True,
              clip: bool = True,
              variance: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
              device: DeviceLike = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD prior (anchor) boxes for one feature map on ``device`` (default:
    the card; no card raises). Returns (boxes [H*W*P, 4], variances
    [H*W*P, 4]) with P priors a cell: min, sqrt(min*max) if max_size,
    and one an aspect ratio (two with ``flip``)."""
    dev = require_device(device)
    H, W = feature_hw
    img_h, img_w = image_hw
    sizes_w, sizes_h = [min_size / img_w], [min_size / img_h]
    if max_size is not None:
        sp = (min_size * max_size) ** 0.5
        sizes_w.append(sp / img_w)
        sizes_h.append(sp / img_h)
    for ar in aspect_ratios:
        for a in ((ar, 1.0 / ar) if flip else (ar,)):
            sizes_w.append(min_size * (a ** 0.5) / img_w)
            sizes_h.append(min_size / (a ** 0.5) / img_h)
    P = len(sizes_w)
    f32 = dict(dtype=torch.float32, device=dev)
    cy, cx = torch.meshgrid((torch.arange(H, **f32) + 0.5) / H,
                            (torch.arange(W, **f32) + 0.5) / W,
                            indexing="ij")
    cx = cx[..., None].expand(H, W, P)
    cy = cy[..., None].expand(H, W, P)
    w2 = torch.tensor(sizes_w, **f32) / 2.0
    h2 = torch.tensor(sizes_h, **f32) / 2.0
    boxes = torch.stack([cx - w2, cy - h2, cx + w2, cy + h2],
                        dim=-1).reshape(-1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes, torch.tensor(variance, **f32).expand(boxes.shape)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a [..., N, 4], b [..., M, 4] -> [..., N, M]."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (torch.clamp(a[..., 2] - a[..., 0], min=0.0)
              * torch.clamp(a[..., 3] - a[..., 1], min=0.0))
    area_b = (torch.clamp(b[..., 2] - b[..., 0], min=0.0)
              * torch.clamp(b[..., 3] - b[..., 1], min=0.0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def encode_boxes(gt: torch.Tensor, priors: torch.Tensor,
                 variances: torch.Tensor) -> torch.Tensor:
    """Ground-truth boxes -> regression targets relative to the priors."""
    p_wh = torch.clamp(priors[:, 2:] - priors[:, :2], min=1e-8)
    p_c = (priors[:, :2] + priors[:, 2:]) / 2
    g_wh = torch.clamp(gt[:, 2:] - gt[:, :2], min=1e-8)
    g_c = (gt[:, :2] + gt[:, 2:]) / 2
    d_c = (g_c - p_c) / (p_wh * variances[:, :2])
    d_wh = torch.log(g_wh / p_wh) / variances[:, 2:]
    return torch.cat([d_c, d_wh], dim=-1)


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances: torch.Tensor) -> torch.Tensor:
    """Regression outputs -> boxes."""
    p_wh = priors[:, 2:] - priors[:, :2]
    p_c = (priors[:, :2] + priors[:, 2:]) / 2
    c = loc[..., :2] * variances[:, :2] * p_wh + p_c
    wh = torch.exp(loc[..., 2:] * variances[:, 2:]) * p_wh
    return torch.cat([c - wh / 2, c + wh / 2], dim=-1)


def match_priors(priors: torch.Tensor, gt_boxes: torch.Tensor,
                 gt_mask: torch.Tensor, threshold: float = 0.5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each prior's ground-truth box, for ONE image.

    gt_boxes [G, 4] padded, gt_mask [G] 1.0 for the real boxes. Returns
    (matched gt index [N], positive mask [N]): each prior's best gt,
    positive at IoU >= threshold, and each real gt's best prior
    force-matched to it and positive. Where two real gts share a best
    prior, the higher gt index is the one matched (module docstring)."""
    iou = iou_matrix(priors, gt_boxes) * gt_mask[None, :]
    best_gt = torch.argmax(iou, dim=1)
    pos = torch.amax(iou, dim=1) >= threshold
    N, G = iou.shape
    best_prior = torch.argmax(iou, dim=0)                      # [G]
    # [N, G]: prior n is real gt g's best prior
    is_best = ((best_prior[None, :] == torch.arange(N, device=iou.device)
                [:, None]) & (gt_mask[None, :] > 0))
    gts = torch.arange(G, device=iou.device)
    forced = torch.amax(torch.where(is_best, gts, -1), dim=1)  # -1: none
    force_mask = forced >= 0
    return torch.where(force_mask, forced, best_gt), pos | force_mask


def multibox_loss(loc_pred: torch.Tensor, conf_logits: torch.Tensor,
                  priors: torch.Tensor, variances: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_mask: torch.Tensor, *, neg_pos_ratio: float = 3.0,
                  overlap_threshold: float = 0.5,
                  background_id: int = 0) -> torch.Tensor:
    """The SSD loss of ONE image: smooth L1 on the matched locations plus
    softmax cross-entropy over the positives and the hardest
    ``neg_pos_ratio`` x as many negatives, each over the number of
    positives (at least 1). conf_logits [N, C]; gt_labels [G] (the
    background id is reserved).

    As in JAX the location term is the smooth L1 summed over all priors
    (the negatives' targets are their own predictions, so they add 0)
    times the positive count over the positive count at least 1."""
    matched, pos = match_priors(priors, gt_boxes, gt_mask, overlap_threshold)
    n_pos = torch.sum(pos.to(torch.float32))
    # negatives' targets are the prediction itself (zero loss), put in
    # before the loss: padded gt slots may hold anything, NaN included
    targets = encode_boxes(gt_boxes[matched], priors, variances)
    targets = torch.where(pos[:, None], targets, loc_pred.detach())
    loc_l = torch.sum(smooth_l1(loc_pred, targets), dim=-1)
    loc_loss = torch.sum(loc_l * pos) / torch.clamp(n_pos, min=1.0)

    labels = torch.where(pos, gt_labels[matched].to(torch.long),
                         background_id)
    logp = torch.log_softmax(conf_logits, dim=-1)
    ce = -torch.gather(logp, 1, labels[:, None])[:, 0]
    neg_ce = torch.where(pos, -torch.inf, ce)
    n_neg = torch.minimum(neg_pos_ratio * torch.clamp(n_pos, min=1.0),
                          torch.sum(1.0 - pos.to(torch.float32)))
    order = torch.sort(-neg_ce.detach(), stable=True).indices
    rank = torch.argsort(order)                  # order's inverse
    neg = (~pos) & (rank < n_neg)
    conf_loss = torch.sum(ce * (pos | neg)) / torch.clamp(n_pos, min=1.0)
    return loc_loss + conf_loss


def _ranked(scores: torch.Tensor, k: int, score_threshold: float):
    """The k best candidates of each row of scores [..., N] (below the
    threshold: -inf), best first, the lower index first on a tie."""
    masked = torch.where(scores >= score_threshold, scores, -torch.inf)
    sc, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return sc[..., :k], idx[..., :k]


def _suppress(iou: torch.Tensor, keep: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """Greedy NMS over ranked candidates: candidate i is dropped when a
    kept candidate ranked above it overlaps it by more than the
    threshold. iou [..., k, k], keep [..., k] bool; one step a rank for
    all the leading dims at once."""
    k = keep.shape[-1]
    ranks = torch.arange(k, device=keep.device)
    for i in range(k):
        sup = (iou[..., :, i] > iou_threshold) & keep & (ranks < i)
        keep_i = keep[..., i] & ~torch.any(sup, dim=-1)
        keep = torch.where(ranks == i, keep_i[..., None], keep)
    return keep


def _nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
         score_threshold: float, top_k: int):
    """NMS of boxes [N, 4] under each row of scores [C, N]."""
    k = min(top_k, scores.shape[-1])
    sc, idx = _ranked(scores, k, score_threshold)
    bx = boxes[idx]                                            # [C, k, 4]
    keep = _suppress(iou_matrix(bx, bx), sc > -torch.inf, iou_threshold)
    return (bx, torch.where(keep, sc, torch.zeros((), dtype=sc.dtype,
                                                  device=sc.device)),
            keep.to(torch.float32))


def nms(boxes: torch.Tensor, scores: torch.Tensor, *,
        iou_threshold: float = 0.45, score_threshold: float = 0.01,
        top_k: int = 100) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape NMS of ONE image: boxes [N, 4], scores [N] ->
    (boxes [k, 4], scores [k], valid [k]) ranked by score, k =
    min(top_k, N); a suppressed or empty slot has score 0 and valid 0."""
    bx, sc, valid = _nms(boxes, scores[None], iou_threshold,
                         score_threshold, top_k)
    return bx[0], sc[0], valid[0]


def detection_output(loc_pred: torch.Tensor, conf_logits: torch.Tensor,
                     priors: torch.Tensor, variances: torch.Tensor, *,
                     num_classes: int, background_id: int = 0,
                     iou_threshold: float = 0.45,
                     score_threshold: float = 0.01, keep_top_k: int = 100):
    """Decoded boxes and per-class NMS for ONE image -> (boxes
    [C-1, K, 4], scores [C-1, K], valid [C-1, K]) over the classes but
    the background, in class order."""
    boxes = decode_boxes(loc_pred, priors, variances)
    probs = torch.softmax(conf_logits, dim=-1)
    classes = [c for c in range(num_classes) if c != background_id]
    return _nms(boxes, probs.t()[classes], iou_threshold, score_threshold,
                keep_top_k)
