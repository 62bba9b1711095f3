"""Sequence/context parallelism: ring attention over a ``seq`` mesh axis —
the counterpart of ``paddle_tpu/parallel/ring_attention.py``.

Sequences shard over a mesh axis and attention is computed exactly by a
ring of steps with online-softmax accumulation: each rank holds 1/n of
the keys and values, and the KV blocks travel rank to rank (a batched
send and receive, ``collectives.permute_ring``'s transport).

Each ring step runs the flash forward kernel (#1,
``cuda_kernels.flash_attention_fwd``, which returns the row logsumexp)
on the local Q block against the KV block held, and merges the partial
exactly by the two logsumexps. The backward is written out, as JAX's
``_ring_bwd``: flash block gradients factor over key blocks given the
*global* lse and delta = rowsum(dO·O), so delta is computed once and each
step's (dq, dk, dv) comes from the backward kernels (#2, #3,
``cuda_kernels.flash_attention_bwd(..., delta=)``) with the global lse;
the dk/dv accumulators travel with their KV block, and after n steps each
is home with every rank's contribution. On the CPU every step takes the
kernels' plain versions, as every wrapper of the port does.

Causal layouts. Contiguous: rank d holds positions [d·T/n, (d+1)·T/n);
its own block is the causal diagonal, blocks from earlier ranks attend
whole, blocks from later ranks attend nothing. JAX computes each such
future block and then sets its lse to -1e30; the port skips that launch
(and the backward's), which gives the same bits: merging a partial of
weight exp(-1e30 - lse) = 0 leaves o and lse as they were. So a
contiguous causal ring launches #1 (and #2, #3) (my + 1) times on rank
my, not n. Zigzag (the default for causal): the sequence is cut into 2n
chunks and rank d holds chunks (d, 2n-1-d); every step does about half a
block of useful work: the diagonal is one causal call, a block from the
past one call of all local queries against its first chunk, a block from
the future one call of the local second chunk against the whole block.

Layout: q/k/v are [batch, time_local, heads, head_dim] inside
``shard_map`` over the ``seq`` axis; time_local = T_global / n.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Optional

import torch

from ..ops import cuda_kernels as ck
from . import collectives as cc
from .compat import shard_map
from .mesh import Mesh, axis_mesh
from .sharding import P

_NEG = -1e30


def _online_update(o, l, m, scores, v):
    """One flash-attention accumulation step.

    o [B,T,H,D] running numerator; l [B,H,T] running denominator; m [B,H,T]
    running max; scores [B,H,T,S]; v [B,S,H,D].
    """
    m_new = torch.maximum(m, scores.amax(dim=-1))
    p = torch.exp(scores - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bhts,bshd->bthd", p, v)
    o = o * corr.transpose(1, 2)[..., None] + pv
    return o, l, m_new


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 512, causal: bool = False,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Single-device memory-efficient attention: a loop over KV blocks of
    plain PyTorch (JAX's is plain ``jnp``; no kernel here). Never holds
    the [T, S] score matrix beyond one [T, block] tile.
    q,k,v: [B, T, H, D] -> [B, T, H, D]."""
    B, T, H, D = q.shape
    S = k.shape[1]
    scale = scale if scale is not None else D ** -0.5
    nblk = -(-S // block_size)
    pad = nblk * block_size - S
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = torch.arange(T, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, T), _NEG, dtype=torch.float32, device=q.device)
    for i in range(nblk):
        kblk = k[:, i * block_size:(i + 1) * block_size]
        vblk = v[:, i * block_size:(i + 1) * block_size]
        scores = torch.einsum("bthd,bshd->bhts", q, kblk) * scale
        k_pos = i * block_size + torch.arange(block_size, device=q.device)
        mask = (k_pos < S)[None, :]
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        scores = torch.where(mask[None, None], scores, _NEG)
        o, l, m = _online_update(o, l, m, scores, vblk)
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def _merge_partials(o1, lse1, o2, lse2):
    """Exactly combine two attention partials over disjoint key sets.

    o_i are softmax-normalised within their key set, lse_i the corresponding
    logsumexp [B,T,H]. Returns the merged (o, lse).
    """
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    safe = torch.where(denom == 0.0, 1.0, denom)
    o = (o1 * w1[..., None] + o2 * w2[..., None]) / safe[..., None]
    return o, m + torch.log(safe)


# ---------------------------------------------------------------------------
# zigzag (load-balanced causal) layout
# ---------------------------------------------------------------------------

def zigzag_order(T: int, n: int) -> torch.Tensor:
    """Global position order such that contiguous equal shards of the
    REORDERED sequence give rank d chunks (d, 2n-1-d) of the original."""
    if T % (2 * n):
        raise ValueError(f"T={T} must divide into 2*{n} zigzag chunks")
    c = T // (2 * n)
    idx = []
    for d in range(n):
        idx.extend(range(d * c, (d + 1) * c))
        idx.extend(range((2 * n - 1 - d) * c, (2 * n - d) * c))
    return torch.tensor(idx, dtype=torch.int64)


def zigzag_inverse(T: int, n: int) -> torch.Tensor:
    order = zigzag_order(T, n)
    inv = torch.empty(T, dtype=torch.int64)
    inv[order] = torch.arange(T, dtype=torch.int64)
    return inv


def _zigzag_step_pairs(c: int):
    """(diagonal, off-diagonal) attended (q, key) pair counts per ring step
    per rank — the layout's work model. Diagonal: the 2c-causal triangle
    (= 2c^2 + c pairs); every off-diagonal step: exactly half the 2c x 2c
    block (2c^2), whichever direction the held block came from."""
    diag = 2 * c * (2 * c + 1) // 2
    off = 2 * c * c
    return diag, off


def _step_case(src: int, my: int, causal: bool, zigzag: bool) -> str:
    """What a step does with the block of rank ``src``: "full" (every
    local query against every key), "diag" (causal), "past" (zigzag: all
    queries, the block's first chunk), "future" (zigzag: the second
    query chunk, the whole block) or "skip" (contiguous causal: a block
    from the future)."""
    if not causal:
        return "full"
    if src == my:
        return "diag"
    if zigzag:
        return "past" if src < my else "future"
    return "full" if src < my else "skip"


def _fwd_step(case, q, k, v, scale, route):
    """(rows, o [rows] f32, lse [rows]) of one step; rows a slice of T."""
    c = q.shape[1] // 2
    if case == "past":
        q_, k_, v_, rows = q, k[:, :c], v[:, :c], slice(None)
    elif case == "future":
        q_, k_, v_, rows = q[:, c:], k, v, slice(c, None)
    else:
        q_, k_, v_, rows = q, k, v, slice(None)
    o, lse = ck.flash_attention_fwd(q_, k_, v_, causal=case == "diag",
                                    scale=scale, route=route)
    return rows, o.float(), lse


def _ring_forward(q, k, v, ax, causal, scale, route, zigzag):
    n, my = ax.n, ax.index
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3], _NEG, dtype=torch.float32,
                     device=q.device)
    for i in range(n):
        src = (my - i) % n                   # whose KV block we hold now
        case = _step_case(src, my, causal, zigzag)
        if case != "skip":
            rows, o_i, lse_i = _fwd_step(case, q, k, v, scale, route)
            o[:, rows], lse[:, rows] = _merge_partials(
                o[:, rows], lse[:, rows], o_i, lse_i)
        if i + 1 < n:
            k, v = cc._shift(k, ax, 1), cc._shift(v, ax, 1)
    return o.to(q.dtype), lse


def _ring_backward(q, k, v, o, lse, g, ax, causal, scale, route, zigzag):
    n, my = ax.n, ax.index
    c = q.shape[1] // 2
    # loop-invariant across ring steps: compute once, pass into each block
    delta = torch.sum(g.float() * o.float(), dim=-1)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i in range(n):
        src = (my - i) % n
        case = _step_case(src, my, causal, zigzag)
        if case == "past":
            dq_i, dk_i, dv_i = ck.flash_attention_bwd(
                q, k[:, :c], v[:, :c], o, lse, g, causal=False, scale=scale,
                delta=delta, route=route)
            dq += dq_i.float()
            dk[:, :c] += dk_i.float()
            dv[:, :c] += dv_i.float()
        elif case == "future":
            dq_i, dk_i, dv_i = ck.flash_attention_bwd(
                q[:, c:], k, v, o[:, c:], lse[:, c:], g[:, c:], causal=False,
                scale=scale, delta=delta[:, c:], route=route)
            dq[:, c:] += dq_i.float()
            dk += dk_i.float()
            dv += dv_i.float()
        elif case != "skip":
            dq_i, dk_i, dv_i = ck.flash_attention_bwd(
                q, k, v, o, lse, g, causal=case == "diag", scale=scale,
                delta=delta, route=route)
            dq += dq_i.float()
            dk += dk_i.float()
            dv += dv_i.float()
        # dk/dv accumulators travel WITH their KV block; after n hops each
        # is back at its home rank with every rank's contribution
        if i + 1 < n:
            k, v = cc._shift(k, ax, 1), cc._shift(v, ax, 1)
        dk, dv = cc._shift(dk, ax, 1), cc._shift(dv, ax, 1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """The custom VJP of JAX's ``ring_attention``: the forward's (o, lse)
    and q, k, v saved; the backward written out (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, axis_name, causal, scale, route, zigzag):
        ax = cc._Axis(axis_name)
        o, lse = _ring_forward(q, k, v, ax, causal, scale, route, zigzag)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.meta = (ax, causal, scale, route, zigzag)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        ax, causal, scale, route, zigzag = ctx.meta
        dq, dk, dv = _ring_backward(q, k, v, o, lse, g.contiguous(), ax,
                                    causal, scale, route, zigzag)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str, causal: bool = False,
                   scale: Optional[float] = None, route: Optional[str] = None,
                   zigzag: bool = False) -> torch.Tensor:
    """Exact attention with KV rotating around the ``axis_name`` ring.

    Call inside ``shard_map`` with q/k/v time-sharded: [B, T_local, H, D].
    Each of the n ring steps runs the flash kernel on the local Q block
    against the held KV block, then passes KV to the next rank; partials
    merge exactly by their logsumexps. Differentiable (the backward
    kernels, module docstring). ``route="plain"``: the kernels' plain
    versions on the card too (JAX: ``interpret``).

    ``zigzag`` (causal only): the local block must hold chunks
    (d, 2n-1-d) of the zigzag-reordered sequence (:func:`zigzag_order`;
    :func:`ring_self_attention` reorders)."""
    if zigzag and not causal:
        raise ValueError("zigzag layout only applies to causal attention")
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    axis_mesh(axis_name)
    return _RingAttention.apply(q, k, v, axis_name, causal, scale, route,
                                zigzag)


def ring_self_attention(mesh: Mesh, q, k, v, seq_axis: str = "seq",
                        causal: bool = False, layout: Optional[str] = None,
                        route: Optional[str] = None):
    """Host-level wrapper: ``shard_map`` of :func:`ring_attention` over the
    mesh's seq axis.

    q/k/v: [B, T_global, H, D] in ORIGINAL sequence order, the same on
    every rank. ``layout``: "zigzag" (default for causal: load-balanced)
    or "contiguous". The zigzag permutation and its inverse are applied
    here, so callers always see original-order tensors."""
    if layout is None:
        layout = "zigzag" if causal else "contiguous"
    zigzag = layout == "zigzag" and causal
    spec = P(None, seq_axis, None, None)
    n = mesh.shape[seq_axis]
    T = q.shape[1]
    if zigzag and T % (2 * n):
        # the contiguous causal layout leaves (n-1)/2n of the ring's blocks
        # idle on the early ranks, so it takes ~2x the balanced zigzag's
        # time — never take it silently
        warnings.warn(
            f"ring_self_attention: T={T} is not divisible by 2*n_shards"
            f"={2 * n}; falling back to the CONTIGUOUS causal layout, which "
            "wastes ~half the attention FLOPs vs zigzag. Pad the sequence "
            f"to a multiple of {2 * n} to keep the load-balanced layout.",
            stacklevel=2)
        zigzag = False
    if zigzag:
        order = zigzag_order(T, n).to(q.device)
        q, k, v = (x.index_select(1, order) for x in (q, k, v))
    fn = shard_map(
        partial(ring_attention, axis_name=seq_axis, causal=causal,
                zigzag=zigzag, route=route),
        mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec)
    o = fn(q, k, v)
    if zigzag:
        o = o.index_select(1, zigzag_inverse(T, n).to(o.device))
    return o


def ulysses_attention(mesh: Mesh, q, k, v, seq_axis: str = "seq",
                      causal: bool = False, route: Optional[str] = None):
    """DeepSpeed-Ulysses-style sequence parallelism: an all-to-all
    re-shards time-sharded q/k/v to head-sharded, the flash kernels run
    locally over the whole sequence, and an all-to-all brings the output
    back. Two all-to-alls instead of n ring steps, when heads >= shards."""
    spec = P(None, seq_axis, None, None)

    def local(q, k, v):
        # [B, T/n, H, D] -> all-to-all -> [B, T, H/n, D]
        q = cc.all_to_all(q, seq_axis, split_axis=2, concat_axis=1)
        k = cc.all_to_all(k, seq_axis, split_axis=2, concat_axis=1)
        v = cc.all_to_all(v, seq_axis, split_axis=2, concat_axis=1)
        o = ck.flash_attention(q, k, v, causal=causal, route=route)
        return cc.all_to_all(o, seq_axis, split_axis=1, concat_axis=2)

    fn = shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                   out_specs=spec)
    return fn(q, k, v)
