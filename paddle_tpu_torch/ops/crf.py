"""Linear-chain CRF — the counterpart of ``paddle_tpu/ops/crf.py``: the
log-partition, a path's score, the negative log-likelihood and Viterbi
decoding.

The transitions are (start [N], end [N], trans [N, N]) with trans[i, j]
the weight of tag i followed by tag j, as in JAX. JAX's ``lax.scan``s
over time are Python loops over T here: every step is tensor work with
no host read, so a whole loss or decode is captured in one CUDA graph,
and the gradient is autograd's through the loop, as JAX's is the
scan's. On a masked step (t >= length) the carry is the blend
``m * new + (1 - m) * alpha``, as in JAX, and Viterbi's backpointer is
the identity, so the backtrace passes through the padding. Ties in
Viterbi go to the lower tag (``argmax`` takes the first maximum, as
``jnp.argmax`` does).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.lod import sequence_mask


def _mask(emissions: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    return sequence_mask(lengths.to(emissions.device), emissions.shape[1],
                         emissions.dtype)


def crf_log_norm(emissions: torch.Tensor, lengths: torch.Tensor,
                 start: torch.Tensor, end: torch.Tensor, trans: torch.Tensor
                 ) -> torch.Tensor:
    """log Z of each sequence. emissions: [B, T, N] -> [B]."""
    T = emissions.shape[1]
    mask = _mask(emissions, lengths)
    alpha = start[None, :] + emissions[:, 0, :]
    for t in range(1, T):
        # [B, N_prev, 1] + [N_prev, N_next] + [B, 1, N_next], summed out
        # over prev
        scores = (alpha[:, :, None] + trans[None, :, :]
                  + emissions[:, t, None, :])
        new = torch.logsumexp(scores, dim=1)
        m = mask[:, t, None]
        alpha = m * new + (1.0 - m) * alpha
    return torch.logsumexp(alpha + end[None, :], dim=-1)


def crf_score(emissions: torch.Tensor, tags: torch.Tensor,
              lengths: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
              trans: torch.Tensor) -> torch.Tensor:
    """The score of the tag path ``tags`` [B, T] of each sequence -> [B]."""
    mask = _mask(emissions, lengths)
    tags = tags.to(device=emissions.device, dtype=torch.long)
    e = torch.gather(emissions, -1, tags[..., None])[..., 0]     # [B, T]
    emit = torch.sum(e * mask, dim=1)
    pair = torch.sum(trans[tags[:, :-1], tags[:, 1:]] * mask[:, 1:], dim=1)
    last_idx = torch.clamp(lengths.to(emissions.device) - 1, min=0)
    last_tag = torch.gather(tags, 1, last_idx.to(torch.long)[:, None])[:, 0]
    return start[tags[:, 0]] + emit + pair + end[last_tag]


def crf_loss(emissions, tags, lengths, start, end, trans) -> torch.Tensor:
    """Negative log-likelihood of ``tags`` per sequence -> [B]."""
    return (crf_log_norm(emissions, lengths, start, end, trans)
            - crf_score(emissions, tags, lengths, start, end, trans))


def crf_decode(emissions: torch.Tensor, lengths: torch.Tensor,
               start: torch.Tensor, end: torch.Tensor, trans: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi decoding -> (best tags [B, T] int64, zero past each length;
    best score [B])."""
    B, T, N = emissions.shape
    mask = _mask(emissions, lengths)
    ident = torch.arange(N, device=emissions.device).expand(B, N)
    delta = start[None, :] + emissions[:, 0, :]
    bps = []
    for t in range(1, T):
        scores = (delta[:, :, None] + trans[None, :, :]
                  + emissions[:, t, None, :])
        best_prev = torch.argmax(scores, dim=1)                # [B, N]
        new = torch.amax(scores, dim=1)
        m = mask[:, t, None]
        delta = m * new + (1.0 - m) * delta
        bps.append(torch.where(m > 0, best_prev, ident))
    final = delta + end[None, :]
    tag = torch.argmax(final, dim=-1)                          # [B]
    best_score = torch.amax(final, dim=-1)
    # bps[t - 1] maps tag_t to tag_{t-1}: walk back from the last step
    tags = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        tags.append(tag)
    tags = torch.stack(tags[::-1], dim=1)                     # [B, T]
    return tags * mask.to(tags.dtype), best_score
