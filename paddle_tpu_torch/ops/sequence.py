"""Sequence ops over padded LoD batches — the counterpart of
``paddle_tpu/ops/sequence.py``: ``sequence_pool`` (average, sum, sqrt,
max, min, last, first), ``sequence_expand``, ``sequence_reverse``,
``sequence_slice``, ``sequence_concat``, ``context_projection`` (with
trainable boundary rows) and ``sequence_conv``; over a
``NestedSeqBatch`` the nested pools, ``sub_seq_expand`` and
``nested_rnn``; ``kmax_seq_score`` and ``sub_nested_seq``.

All take (x [B, T, ...], lengths [B]) in place of LoD offsets, and
every one is a gather or a ``where`` over masks: no length is read back
to the host, so they run inside a CUDA graph. ``kmax_seq_score`` picks
the lower position first among equal scores, as ``lax.top_k`` does (a
stable descending sort; ``torch.topk`` promises no order among ties on
the card).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.lod import NestedSeqBatch, SeqBatch, sequence_mask


def _tail(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """x [B, T] shaped to broadcast over like's trailing dims."""
    return x.reshape(tuple(x.shape) + (1,) * (like.dim() - x.dim()))


def _fill(x: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _masked(x: torch.Tensor, lengths: torch.Tensor, fill: float):
    m = sequence_mask(lengths, x.shape[1], torch.bool)
    return torch.where(_tail(m, x), x, _fill(x, fill))


def _take_steps(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, ...] at steps idx [B, K] -> [B, K, ...]
    (``take_along_axis`` on axis 1)."""
    idx = _tail(idx.to(torch.long), x)
    return torch.gather(x, 1, idx.expand((-1, -1) + tuple(x.shape[2:])))


def sequence_pool(x: torch.Tensor, lengths: torch.Tensor,
                  pool_type: str = "average") -> torch.Tensor:
    """[B, T, D] -> [B, D] over each sample's first ``length`` steps.
    ``pool_type``: average | sum | sqrt (the sum over sqrt(length)) |
    max | min | last | first. A length-0 sample averages to 0 (its count
    is clamped to 1) and max- or min-pools to 0."""
    lengths = lengths.to(x.device)
    tail = (1,) * (x.dim() - 2)
    n = torch.clamp(lengths.to(x.dtype), min=1).reshape((-1,) + tail)
    if pool_type in ("average", "avg"):
        return torch.sum(_masked(x, lengths, 0.0), dim=1) / n
    if pool_type == "sum":
        return torch.sum(_masked(x, lengths, 0.0), dim=1)
    if pool_type == "sqrt":
        return torch.sum(_masked(x, lengths, 0.0), dim=1) / torch.sqrt(n)
    empty = (lengths == 0).reshape((-1,) + tail)
    if pool_type == "max":
        return torch.where(empty, _fill(x, 0.0),
                           torch.amax(_masked(x, lengths, -torch.inf), dim=1))
    if pool_type == "min":
        return torch.where(empty, _fill(x, 0.0),
                           torch.amin(_masked(x, lengths, torch.inf), dim=1))
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


def sequence_expand(x: torch.Tensor, ref_lengths: torch.Tensor,
                    max_len: int) -> torch.Tensor:
    """One vector per sequence [B, D] broadcast over its steps
    -> [B, max_len, D], zero past ``ref_lengths``."""
    m = sequence_mask(ref_lengths.to(x.device), max_len, x.dtype)
    return x[:, None, :] * m[..., None]


def sequence_reverse(x: torch.Tensor, lengths: torch.Tensor
                     ) -> torch.Tensor:
    """Each sequence's valid prefix reversed in place; the padding stays
    where it is."""
    T = x.shape[1]
    lengths = lengths.to(x.device)[:, None]
    pos = torch.arange(T, device=x.device)[None, :]
    idx = torch.where(pos < lengths, torch.clamp(lengths - 1 - pos, min=0),
                      pos)
    return _take_steps(x, idx)


def sequence_slice(x: torch.Tensor, lengths: torch.Tensor,
                   offset: torch.Tensor, length: torch.Tensor,
                   max_out: int) -> torch.Tensor:
    """Per-sequence sub-sequences: steps offset .. offset + length of each
    sample, padded with 0 to ``max_out`` (source steps clamped to the
    batch's T)."""
    T = x.shape[1]
    pos = torch.arange(max_out, device=x.device)[None, :]
    src = torch.clamp(offset.to(x.device)[:, None] + pos, 0, T - 1)
    m = pos < length.to(x.device)[:, None]
    return torch.where(_tail(m, x), _take_steps(x, src), _fill(x, 0.0))


def sequence_concat(a: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                    lb: torch.Tensor, max_out: Optional[int] = None):
    """Sequences joined pairwise in time: (data [B, max_out, D] (default
    Ta + Tb steps), lengths la + lb)."""
    Ta, Tb = a.shape[1], b.shape[1]
    T = max_out if max_out is not None else Ta + Tb
    la, lb = la.to(a.device), lb.to(a.device)
    lengths = la + lb
    pos = torch.arange(T, device=a.device)[None, :]
    in_a = pos < la[:, None]
    ga = _take_steps(a, torch.clamp(pos, 0, Ta - 1).expand(a.shape[0], -1))
    gb = _take_steps(b, torch.clamp(pos - la[:, None], 0, Tb - 1))
    out = torch.where(_tail(in_a, a), ga, gb)
    valid = pos < lengths[:, None]
    return torch.where(_tail(valid, a), out, _fill(a, 0.0)), lengths


def context_projection(x: torch.Tensor, lengths: torch.Tensor,
                       context_start: int, context_length: int,
                       w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sliding context-window concat [B, T, D] -> [B, T, context_length*D]
    (the core of ``sequence_conv``). Steps outside a sequence are 0, or,
    with the trainable boundary rows ``w`` [pad_rows, D], the row of the
    padding block they fall in: rows 0 .. -context_start - 1 before the
    start, the rows from -context_start on past the end. Padded
    destination steps stay 0."""
    B, T, D = x.shape
    lengths = lengths.to(x.device)
    valid0 = sequence_mask(lengths, T, x.dtype)[..., None]
    pos = torch.arange(T, device=x.device)[None, :]
    cols = []
    for c in range(context_start, context_start + context_length):
        if c == 0:
            cols.append(x * valid0)
            continue
        shifted = torch.roll(x, -c, dims=1)
        valid = (pos + c >= 0) & (pos + c < lengths[:, None])
        shifted = torch.where(valid[..., None], shifted, _fill(x, 0.0))
        if w is not None:
            if c < 0:
                pad_row = torch.clamp(pos + c - context_start, 0,
                                      w.shape[0] - 1).expand(B, -1)
                use_pad = (pos + c < 0).expand(B, -1)
            else:
                over = pos + c - lengths[:, None]
                pad_row = torch.clamp(over - context_start, 0,
                                      w.shape[0] - 1)
                use_pad = (pos + c >= lengths[:, None]) & (
                    pos < lengths[:, None])
            shifted = torch.where(use_pad[..., None], w[pad_row], shifted)
        cols.append(shifted * valid0)
    return torch.cat(cols, dim=-1)


def sequence_conv(x: torch.Tensor, lengths: torch.Tensor,
                  filt: torch.Tensor, context_start: int = -1,
                  context_length: int = 3,
                  b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequence convolution: the context projection times ``filt``
    [context_length*D, H] (+ b), zero past each length."""
    ctx = context_projection(x, lengths, context_start, context_length)
    B, T, _ = ctx.shape
    out = torch.matmul(ctx.reshape(B * T, -1), filt).reshape(B, T, -1)
    if b is not None:
        out = out + b
    return out * sequence_mask(lengths.to(x.device), T, out.dtype)[..., None]


# -- nested sequences (2-level LoD): the single-level op over
# ``inner_flat()``, lifted back by ``outer()``

def nested_seq_pool(nb: NestedSeqBatch, pool_type: str = "average"
                    ) -> SeqBatch:
    """Each sub-sequence pooled -> a ``SeqBatch`` [B, S, ...] over the
    sub-sequences."""
    flat = nb.inner_flat()
    return nb.outer(sequence_pool(flat.data, flat.lengths, pool_type))


def nested_last_step(nb: NestedSeqBatch) -> SeqBatch:
    return nested_seq_pool(nb, "last")


def nested_first_step(nb: NestedSeqBatch) -> SeqBatch:
    return nested_seq_pool(nb, "first")


def sub_seq_expand(outer_vals: torch.Tensor, nb: NestedSeqBatch
                   ) -> torch.Tensor:
    """One value a sub-sequence [B, S, D] broadcast to its steps
    [B, S, T, D], zero on invalid steps."""
    tiled = outer_vals[:, :, None].expand(
        tuple(outer_vals.shape[:2]) + (nb.max_sublen,)
        + tuple(outer_vals.shape[2:]))
    return tiled * _tail(nb.inner_mask(tiled.dtype), tiled)


def nested_rnn(rnn_fn: Callable, nb: NestedSeqBatch, *args, **kwargs):
    """A single-level masked RNN (``ops.rnn.lstm``, ``gru``,
    ``simple_rnn``) run over every sub-sequence on its own: no state flows
    across a sub-sequence boundary. Returns (outputs [B, S, T, H], the
    last states as a ``SeqBatch`` [B, S, H])."""
    flat = nb.inner_flat()
    out, last = rnn_fn(flat.data, flat.lengths, *args, **kwargs)
    out_n = out.reshape((nb.batch_size, nb.max_subseqs)
                        + tuple(out.shape[1:]))
    return out_n, nb.outer(last.h if hasattr(last, "h") else last)


def kmax_seq_score(scores: torch.Tensor, lengths: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """The positions of the k highest scores of each sequence [B, T] (or
    [B, T, 1]) -> int32 [B, k], best first, the lower position first
    among equal scores. Padding scores -inf, so it is never picked ahead
    of a valid step; a sequence shorter than k fills its tail with padded
    positions in order."""
    if scores.dim() == 3:
        scores = scores[..., 0]
    mask = sequence_mask(lengths.to(scores.device), scores.shape[1],
                         torch.bool)
    masked = torch.where(mask, scores, _fill(scores, -torch.inf))
    _, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[:, :k].to(torch.int32)


def sub_nested_seq(x: torch.Tensor, sub_lengths: torch.Tensor,
                   indices: torch.Tensor):
    """The sub-sequences of x [B, S, T, ...] at ``indices`` [B, K]
    (clamped to [0, S-1]) -> (x_out [B, K, T, ...], sub_lengths_out
    [B, K])."""
    S = x.shape[1]
    idx = torch.clamp(indices.to(device=x.device, dtype=torch.long), 0,
                      S - 1)
    return (_take_steps(x, idx),
            torch.gather(sub_lengths.to(x.device), 1, idx))
