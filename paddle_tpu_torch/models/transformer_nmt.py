"""Transformer encoder-decoder NMT — the counterpart of
``paddle_tpu/models/transformer_nmt.py``.

A pre-LN encoder-decoder whose every attention goes through
:func:`ops.cuda_kernels.flash_attention`, so through kernels #1-#3 on the
card: bidirectional encoder self-attention and decoder-to-encoder
cross-attention with the source lengths as ``kv_lens``, causal decoder
self-attention without. (The JAX entry routes sequences shorter than 256
to a dense einsum on the TPU; the port always takes the kernels.)
Teacher-forced training is one parallel pass; the head is tied to the
target embedding.

Parameter names and layouts are the JAX tree's (``src_embed``,
``trg_embed``, ``src_pos``, ``trg_pos``, ``enc_blocks_{i}``,
``dec_blocks_{i}``, ``ln_enc``, ``ln_f``), so ``convert.params_from_numpy``
loads a JAX tree. ``route`` goes to the attention kernels ("plain": their
plain versions on any device).
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..core.lod import SeqBatch
from ..nn import Embedding, LayerNorm, Linear, Module
from ..nn.initializer import normal
from ..ops import cuda_kernels as ck
from .transformer import TransformerBlock, token_cross_entropy


class CrossAttentionBlock(nn.Module):
    """Decoder block: causal self-attention, cross-attention over the
    encoder memory, FFN — all pre-LN."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 init_std: float = 0.02):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.n_heads, self.d_head = n_heads, d_model // n_heads
        w = normal(0.0, init_std)
        self.ln1 = LayerNorm(d_model)
        self.qkv = Linear(d_model, 3 * d_model, w_init=w)
        self.self_proj = Linear(d_model, d_model, w_init=w)
        self.ln_x = LayerNorm(d_model)
        self.q_x = Linear(d_model, d_model, w_init=w)
        self.kv_x = Linear(d_model, 2 * d_model, w_init=w)
        self.x_proj = Linear(d_model, d_model, w_init=w)
        self.ln2 = LayerNorm(d_model)
        self.mlp_in = Linear(d_model, d_ff, act="gelu", w_init=w)
        self.mlp_out = Linear(d_ff, d_model, w_init=w)

    def _split(self, t: torch.Tensor, n: int) -> List[torch.Tensor]:
        """``n`` [B, T, H, Dh] views of a fused projection (no copy)."""
        return [p.unflatten(-1, (self.n_heads, self.d_head))
                for p in t.chunk(n, dim=-1)]

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                src_lens: Optional[torch.Tensor] = None, *,
                route: Optional[str] = None) -> torch.Tensor:
        B, T, D = x.shape
        # causal self-attention (keys past a sample's own length only meet
        # queries past it, which the loss masks: no kv_lens)
        q, k, v = self._split(self.qkv(self.ln1(x)), 3)
        o = ck.flash_attention(q, k, v, causal=True, route=route)
        x = x + self.self_proj(o.reshape(B, T, D).to(x.dtype))
        # cross-attention over the memory, source padding masked
        qx, = self._split(self.q_x(self.ln_x(x)), 1)
        kx, vx = self._split(self.kv_x(memory), 2)
        ox = ck.flash_attention(qx, kx, vx, causal=False, kv_lens=src_lens,
                                route=route)
        x = x + self.x_proj(ox.reshape(B, T, D).to(x.dtype))
        return x + self.mlp_out(self.mlp_in(self.ln2(x)))


class TransformerSeq2Seq(Module):
    """Encoder-decoder NMT, every attention on the flash kernels. Built
    with its parameters on the ``meta`` device, as ``TransformerLM``."""

    def __init__(self, src_vocab: int, trg_vocab: int, d_model: int = 512,
                 n_heads: int = 8, n_enc: int = 6, n_dec: int = 6,
                 d_ff: Optional[int] = None, max_len: int = 512):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.max_len = max_len
        self.src_embed = Embedding(src_vocab, d_model,
                                   w_init=normal(0.0, 0.02))
        self.trg_embed = Embedding(trg_vocab, d_model,
                                   w_init=normal(0.0, 0.02))
        self.param("src_pos", (max_len, d_model), normal(0.0, 0.01))
        self.param("trg_pos", (max_len, d_model), normal(0.0, 0.01))
        self.enc_blocks = nn.ModuleList(
            TransformerBlock(d_model, n_heads, d_ff, causal=False)
            for _ in range(n_enc))
        self.dec_blocks = nn.ModuleList(
            CrossAttentionBlock(d_model, n_heads, d_ff) for _ in range(n_dec))
        self.ln_enc = LayerNorm(d_model)
        self.ln_f = LayerNorm(d_model)

    def encode(self, src: SeqBatch, *,
               route: Optional[str] = None) -> torch.Tensor:
        S = src.data.shape[1]
        x = self.src_embed(src.data)
        x = x + self.src_pos[:S].to(x.dtype)
        for blk in self.enc_blocks:
            x = blk(x, kv_lens=src.lengths, route=route)
        return self.ln_enc(x)

    def _decode(self, ids: torch.Tensor, memory: torch.Tensor,
                src_lens: torch.Tensor, route: Optional[str]) -> torch.Tensor:
        """Final-LN decoder states of target ids [B, T]."""
        T = ids.shape[1]
        x = self.trg_embed(ids)
        x = x + self.trg_pos[:T].to(x.dtype)
        for blk in self.dec_blocks:
            x = blk(x, memory, src_lens, route=route)
        return self.ln_f(x)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.trg_embed.w.t().to(x.dtype)

    def forward(self, src: SeqBatch, trg_in: SeqBatch, *,
                route: Optional[str] = None) -> torch.Tensor:
        """Teacher-forced logits [B, T, V] in one parallel pass."""
        memory = self.encode(src, route=route)
        return self._logits(self._decode(trg_in.data, memory, src.lengths,
                                         route))

    def loss(self, src: SeqBatch, trg_in: SeqBatch, trg_out: SeqBatch, *,
             route: Optional[str] = None) -> torch.Tensor:
        """Mean token CE over the target positions below each length."""
        return token_cross_entropy(self(src, trg_in, route=route),
                                   trg_out.data, trg_out.mask())

    @torch.no_grad()
    def greedy_generate(self, src: SeqBatch, *, max_len: int = 32,
                        bos_id: int = 0, eos_id: int = 1,
                        route: Optional[str] = None) -> torch.Tensor:
        """Greedy decode by re-forwarding the growing target prefix (the
        correctness path, no KV cache): [B, max_len] int32 tokens, eos
        repeated after a sample's first eos."""
        memory = self.encode(src, route=route)
        B = src.batch_size
        dev = memory.device
        ids = torch.full((B, 1), bos_id, dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for _ in range(max_len):
            x = self._decode(ids, memory, src.lengths, route)
            nxt = torch.argmax(self._logits(x[:, -1]), dim=-1).to(torch.int32)
            nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
            done = done | (nxt == eos_id)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
        return ids[:, 1:]
