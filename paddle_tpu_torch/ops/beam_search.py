"""Beam search and greedy search over a decoder step — the counterpart of
``paddle_tpu/ops/beam_search.py``.

The beam is a fixed-capacity masked top-k loop: all candidates live in
[B, K] tensors, finished beams are frozen (only EOS, at no cost), and a
``constraint_fn`` hook masks the step's log-probabilities. JAX runs the
loop as one ``lax.scan``; here it is a Python loop of decoder steps that
reads nothing back to the host, so a caller can capture the whole search
in one CUDA graph (``AttentionSeq2Seq.generate`` does).

The decoder cell is any nest of tensors (a NamedTuple such as the
seq2seq ``DecoderState``, tuples, lists, dicts) whose leaves are
[B, ...]. The top-k of a step keeps ``lax.top_k``'s order, the larger
value first and the lower index first among equal values (a stable
descending sort), and the final best-first sort is stable like
``jnp.argsort``, so ties resolve as in JAX.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import torch

#: Named constraint hooks, so a program can refer to a registered masking
#: function by name.
CONSTRAINTS: dict = {}


def register_constraint(name: str, fn: Optional[Callable] = None):
    """Register ``fn(logits [B, K, V], step) -> logits`` under ``name``.
    Usable as a decorator: ``@register_constraint("no_digits")``."""
    if fn is None:
        def deco(f):
            CONSTRAINTS[name] = f
            return f
        return deco
    CONSTRAINTS[name] = fn
    return fn


def tree_map(fn: Callable, tree):
    """``fn`` at every tensor leaf of a nest of NamedTuples, tuples, lists
    and dicts (``None`` stays ``None``), keeping the containers' types."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    raise TypeError(f"not a tensor nest: {type(tree).__name__}")


def _gather_beams(tree, idx: torch.Tensor):
    """Reindex the beam axis (1) of every leaf by idx [B, K_new]."""
    idx = idx.long()

    def g(x):
        i = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, i.expand(idx.shape + x.shape[2:]))
    return tree_map(g, tree)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: descending, lower index first
    among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_search(init_cell, step_fn: Callable, *, batch_size: int,
                beam_size: int, max_len: int, vocab_size: int, bos_id: int,
                eos_id: int, length_penalty: float = 0.0,
                constraint_fn: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generic seq2seq beam decode.

    step_fn(cell, tokens [B*K]) -> (log_probs [B*K, V], new_cell) — one
    decoder step; init_cell leaves are [B, ...] and are tiled across the
    beams. constraint_fn(logits [B, K, V], step) -> logits masks a step.
    Finished beams only continue with EOS, at log-probability 0. With
    ``length_penalty`` > 0 the final scores are divided by the GNMT
    penalty ((5 + emitted) / 6) ** length_penalty.

    Returns (tokens [B, K, max_len] int32, scores [B, K]) sorted
    best-first."""
    B, K, V = batch_size, beam_size, vocab_size
    neg_inf = -1e9
    leaf = next(iter(_leaves(init_cell)))
    dev = leaf.device

    cell = tree_map(lambda x: x[:, None].expand((B, K) + x.shape[1:]),
                    init_cell)
    tokens = torch.full((B, K, max_len), eos_id, dtype=torch.int32,
                        device=dev)
    cur = torch.full((B, K), bos_id, dtype=torch.int32, device=dev)
    # only beam 0 alive at first, so identical initial beams don't repeat
    log_probs = torch.cat(
        [torch.zeros((B, 1), device=dev),
         torch.full((B, K - 1), neg_inf, device=dev)], dim=1)
    finished = torch.zeros((B, K), dtype=torch.bool, device=dev)
    # log-probability 0 at EOS, -inf elsewhere (made on the card, with no
    # host-to-card copy, so that the search can be captured in a graph)
    eos_only = torch.where(torch.arange(V, device=dev) == eos_id, 0.0,
                           neg_inf)

    for t in range(max_len):
        flat_cell = tree_map(lambda x: x.reshape((B * K,) + x.shape[2:]),
                             cell)
        logp, new_flat_cell = step_fn(flat_cell, cur.reshape(B * K))
        logp = logp.reshape(B, K, V)
        new_cell = tree_map(lambda x: x.reshape((B, K) + x.shape[1:]),
                            new_flat_cell)
        if constraint_fn is not None:
            logp = constraint_fn(logp, t)
        # finished beams: only EOS, with probability 1 (score frozen)
        logp = torch.where(finished[..., None], eos_only, logp)
        cand = log_probs[..., None] + logp                  # [B, K, V]
        top_scores, top_idx = _top_k(cand.reshape(B, K * V), K)
        beam_idx = top_idx // V
        tok_idx = (top_idx % V).to(torch.int32)

        tokens = _gather_beams(tokens, beam_idx)
        tokens[:, :, t] = tok_idx
        cell = _gather_beams(new_cell, beam_idx)
        finished = (torch.gather(finished, 1, beam_idx)
                    | (tok_idx == eos_id))
        cur, log_probs = tok_idx, top_scores

    if length_penalty > 0.0:
        lens = (tokens != eos_id).to(torch.float32).sum(-1) + 1.0
        scored = log_probs / torch.pow((5.0 + lens) / 6.0, length_penalty)
    else:
        scored = log_probs
    order = torch.argsort(-scored, dim=1, stable=True)
    return _gather_beams(tokens, order), torch.gather(scored, 1, order)


def greedy_search(init_cell, step_fn: Callable, *, batch_size: int,
                  max_len: int, bos_id: int, eos_id: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-way (greedy) generation: the argmax token each step, EOS
    repeated after a sample's first EOS, whose score stops there. Returns
    (tokens [B, max_len] int32, scores [B] f32)."""
    B = batch_size
    dev = next(iter(_leaves(init_cell))).device
    cur = torch.full((B,), bos_id, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    score = torch.zeros((B,), dtype=torch.float32, device=dev)
    cell, toks = init_cell, []
    for _ in range(max_len):
        logp, cell = step_fn(cell, cur)
        step_score, nxt = torch.max(logp, dim=-1)
        nxt = torch.where(done, eos_id, nxt.to(torch.int32))
        score = score + torch.where(done, 0.0, step_score)
        done = done | (nxt == eos_id)
        toks.append(nxt)
        cur = nxt
    return torch.stack(toks, dim=1), score


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out
