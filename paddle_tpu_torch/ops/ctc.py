"""CTC — the counterpart of ``paddle_tpu/ops/ctc.py``: the loss as a masked
log-space forward algorithm and the greedy (best-path) decode.

The extended label sequence (blanks interleaved) lives in a fixed
[B, 2L+1] tensor; each step is branch-free selects, and the input and
label lengths are masks, so the loss has no host read (JAX's
``lax.scan`` is a Python loop over T, captured whole in a CUDA graph).
Log-space "zero" is ``NEG = -1e30``, not -inf, as in JAX: the
log-sum-exp ``m + log(exp(a - m) + exp(b - m))`` and its gradient stay
finite on unreachable states, where -inf would give NaN. So an
infeasible alignment (more labels than the input can emit) gives JAX's
finite value (about 1e30), not ``F.ctc_loss``'s inf; a label of length
0 is the all-blank path.
"""

from __future__ import annotations

import torch

from ..core.lod import sequence_mask

NEG = -1e30


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m))


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """The CTC negative log-likelihood of each sequence -> [B].

    log_probs: [B, T, V] log-softmax outputs; labels: [B, L] (padded
    with any value)."""
    B, T, V = log_probs.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev, dt = log_probs.device, log_probs.dtype
    labels = labels.to(device=dev, dtype=torch.long)
    label_lengths = label_lengths.to(dev)
    input_lengths = input_lengths.to(dev)
    neg = torch.full((), NEG, dtype=dt, device=dev)

    # extended sequence: blank, l1, blank, l2, ..., blank
    blanks = torch.full((B, L + 1), blank, dtype=torch.long, device=dev)
    ext = torch.cat([torch.stack([blanks[:, :L], labels], dim=-1)
                     .reshape(B, 2 * L), blanks[:, L:]], dim=1)
    s_idx = torch.arange(S, device=dev)[None, :]
    ext_valid = s_idx < (2 * label_lengths + 1)[:, None]
    # a skip from s-2 to s: only onto a label that differs from the one
    # two back
    ext_m2 = torch.cat([torch.full((B, 2), -1, dtype=torch.long,
                                   device=dev), ext[:, :-2]], dim=1)
    can_skip = (s_idx % 2 == 1) & (ext != ext_m2)

    emit = torch.gather(log_probs, 2, ext[:, None, :].expand(B, T, S))

    alpha = torch.cat([emit[:, 0, :1],
                       torch.where(label_lengths[:, None] > 0,
                                   emit[:, 0, 1:2], neg),
                       neg.expand(B, max(S - 2, 0))], dim=1)
    alpha = torch.where(ext_valid, alpha, neg)
    pad1 = neg.expand(B, 1)
    pad2 = neg.expand(B, 2)
    for t in range(1, T):
        a_m1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        a_m2 = torch.cat([pad2, alpha[:, :-2]], dim=1)
        merged = _lse(alpha, a_m1)
        merged = torch.where(can_skip, _lse(merged, a_m2), merged)
        new = torch.where(ext_valid, merged + emit[:, t], neg)
        # frozen once past the input's length
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)

    # the end: the last blank (2 * label_len) or the last label before it
    idx_last = (2 * label_lengths).to(torch.long)
    idx_prev = torch.clamp(idx_last - 1, min=0)
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, idx_prev[:, None])[:, 0]
    return -_lse(a_last, torch.where(label_lengths > 0, a_prev, neg))


def ctc_greedy_decode(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                      blank: int = 0):
    """Best-path decoding: the argmax of each step (the first maximum),
    repeats collapsed, blanks dropped. Returns (tokens [B, T] int64,
    padded with ``blank``; lengths [B]).

    Each kept token is written to its own slot (its rank among the kept
    ones); the dropped ones all write ``blank`` into one spare slot past
    the end, which the result leaves out: the writes that meet carry the
    same value, so their order does not matter. JAX parks the dropped
    tokens at slot T-1 and resets the slots past the length to blank
    afterwards; the result is the same."""
    B, T, V = log_probs.shape
    path = torch.argmax(log_probs, dim=-1)                    # [B, T]
    valid = sequence_mask(input_lengths.to(path.device), T, torch.bool)
    prev = torch.cat([torch.full((B, 1), -1, dtype=path.dtype,
                                 device=path.device), path[:, :-1]], dim=1)
    keep = valid & (path != blank) & (path != prev)
    order = torch.cumsum(keep.to(torch.long), dim=1) - 1
    # the dropped tokens write blank into the spare slot T
    slot = torch.where(keep, order, torch.full_like(order, T))
    out = torch.full((B, T + 1), blank, dtype=path.dtype, device=path.device)
    out = out.scatter(1, slot, torch.where(keep, path,
                                           torch.full_like(path, blank)))
    return out[:, :T], torch.sum(keep.to(torch.int32), dim=1)
