"""Decoder-only Transformer LM — the counterpart of
``paddle_tpu/models/transformer.py`` for the serving path.

Pre-LN blocks, one fused qkv matmul per block, attention as [B, T, H, Dh]
through :func:`ops.cuda_kernels.flash_attention` (causal), learned
position embeddings, and a head tied to the token embedding. The model
carries its own parameters (JAX passes a parameter tree beside it); they
keep the JAX names and layouts so a JAX tree loads through
``paddle_tpu_torch.convert.params_from_numpy``.

The q/k/v, MLP and head matmuls stay ``torch.matmul``, as the JAX package
leaves them to XLA; only attention goes through the port's kernels.
Every attention entry takes ``route`` (None: the kernel for CUDA tensors,
the plain version for CPU ones; "plain": the plain version anywhere).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Embedding, LayerNorm, Linear, Module
from ..nn.initializer import normal
from ..ops import cuda_kernels as ck

Cell = Dict[str, torch.Tensor]


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_ff: int,
                 init_std: float = 0.02, causal: bool = True):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not a multiple of "
                             f"n_heads {n_heads}")
        self.n_heads = n_heads
        self.d_head = d_model // n_heads
        self.causal = causal
        self.ln1 = LayerNorm(d_model)
        self.qkv = Linear(d_model, 3 * d_model, w_init=normal(0.0, init_std))
        self.proj = Linear(d_model, d_model, w_init=normal(0.0, init_std))
        self.ln2 = LayerNorm(d_model)
        self.mlp_in = Linear(d_model, d_ff, act="gelu",
                             w_init=normal(0.0, init_std))
        self.mlp_out = Linear(d_ff, d_model, w_init=normal(0.0, init_std))

    def attend(self, q, k, v, *, route: Optional[str] = None):
        return ck.flash_attention(q, k, v, causal=self.causal, route=route)

    def heads(self, x: torch.Tensor):
        """q, k, v as [B, T, H, Dh] views of one fused qkv matmul (no copy:
        the attention kernels read them through their strides)."""
        qkv = self.qkv(self.ln1(x))
        q, k, v = qkv.chunk(3, dim=-1)
        shape = (self.n_heads, self.d_head)
        return q.unflatten(-1, shape), k.unflatten(-1, shape), \
            v.unflatten(-1, shape)

    def finish(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Residual + projection + MLP after attention output ``o``."""
        B, T, D = x.shape
        x = x + self.proj(o.reshape(B, T, D).to(x.dtype))
        return x + self.mlp_out(self.mlp_in(self.ln2(x)))

    def forward(self, x, *, route: Optional[str] = None):
        q, k, v = self.heads(x)
        return self.finish(x, self.attend(q, k, v, route=route))


class TransformerLM(Module):
    """GPT-style LM: token + learned position embeddings, N pre-LN blocks,
    final LN, head tied to the token embedding.

    Built with its parameters on the ``meta`` device: :meth:`init` (random
    weights from a seed) or ``convert.params_from_numpy`` (weights from the
    JAX package) puts them on a device."""

    def __init__(self, vocab: int, d_model: int = 512, n_heads: int = 8,
                 n_layers: int = 6, d_ff: Optional[int] = None,
                 max_len: int = 1024):
        super().__init__()
        d_ff = d_ff or 4 * d_model
        self.vocab, self.max_len = vocab, max_len
        self.embed = Embedding(vocab, d_model, w_init=normal(0.0, 0.02))
        self.param("pos_embed", (max_len, d_model), normal(0.0, 0.01))
        self.blocks = nn.ModuleList(TransformerBlock(d_model, n_heads, d_ff)
                                    for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model)

    @property
    def device(self) -> torch.device:
        return self.embed.w.device

    @property
    def dtype(self) -> torch.dtype:
        """Compute dtype: the embedding table's, which activations and the
        KV cache inherit."""
        return self.embed.w.dtype

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head tied to the token embedding."""
        return x @ self.embed.w.t().to(x.dtype)

    @torch.no_grad()
    def forward(self, ids: torch.Tensor, *,
                route: Optional[str] = None) -> torch.Tensor:
        """ids [B, T] -> logits [B, T, V]."""
        T = ids.shape[1]
        x = self.embed(ids)
        x = x + self.pos_embed[:T].to(x.dtype)
        for blk in self.blocks:
            x = blk(x, route=route)
        return self._logits(self.ln_f(x))

    @torch.no_grad()
    def generate_greedy(self, prompt: torch.Tensor, steps: int, *,
                        route: Optional[str] = None) -> torch.Tensor:
        """Greedy continuation by full re-forward per step: prompt
        [B, T0] -> [B, T0+steps]. The correctness reference, not the
        serving path."""
        ids = prompt
        for _ in range(steps):
            logits = self(ids[:, -self.max_len:], route=route)
            nxt = torch.argmax(logits[:, -1], dim=-1)
            ids = torch.cat([ids, nxt[:, None].to(ids.dtype)], dim=1)
        return ids

    # -- incremental decoding (the serving path) ---------------------------
    @torch.no_grad()
    def prefill(self, prompt: torch.Tensor,
                lengths: Optional[torch.Tensor] = None, *,
                pad_to: Optional[int] = None,
                route: Optional[str] = None) -> Tuple[Cell, torch.Tensor]:
        """Run the prompt once; return (cell, last logits [B, V]). The cell
        holds per-layer caches ``k{i}``/``v{i}`` [B, pad, H, Dh] padded to
        ``pad_to`` (default max_len) and the write position ``pos`` [B].

        ``lengths`` [B] makes the batch ragged: prompts are right-padded,
        attention stays causal with no kv_lens (a padded tail row is never
        read by a live query), and each sample's logits are taken at
        ``lengths - 1``."""
        B, T0 = prompt.shape
        limit = self.max_len if pad_to is None else min(pad_to, self.max_len)
        if limit < T0:
            raise ValueError(f"prefill cache limit {limit} (pad_to/max_len) "
                             f"is narrower than the prompt ({T0})")
        x = self.embed(prompt)
        x = x + self.pos_embed[:T0].to(x.dtype)
        if lengths is None:
            pos = torch.full((B,), T0, dtype=torch.int32, device=x.device)
        else:
            pos = lengths.to(device=x.device, dtype=torch.int32)
        cell: Cell = {"pos": pos}
        pad = (0, 0, 0, 0, 0, limit - T0)          # dim 1 of [B, T, H, Dh]
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.heads(x)
            x = blk.finish(x, blk.attend(q, k, v, route=route))
            cell[f"k{i}"] = F.pad(k, pad)
            cell[f"v{i}"] = F.pad(v, pad)
        x = self.ln_f(x)
        # only the rows whose logits are returned go through the head
        if lengths is None:
            last = x[:, -1]
        else:
            last = x[torch.arange(B, device=x.device), pos.long() - 1]
        return cell, self._logits(last)

    @torch.no_grad()
    def decode_step_paged(self, cell: Cell, tokens: torch.Tensor,
                          tables: torch.Tensor, *,
                          route: Optional[str] = None
                          ) -> Tuple[torch.Tensor, Cell]:
        """One step against a paged cache: tokens [B] -> (logits [B, V],
        new cell). The cell holds per-layer page pools ``k{i}``/``v{i}``
        [P, bs, H, Dh] shared by every request and ``pos`` [B]; ``tables``
        [B, NB] int32 names the page of each request's positions
        ``j*bs .. (j+1)*bs-1`` (sliced by the caller to the read bound).

        The step's k/v row is written at page ``tables[b, pos//bs]``, row
        ``pos % bs``. Where JAX returns new pools, the port writes into the
        pools IN PLACE (the returned cell holds the same tensors): no copy
        of the pool per step. Drained slots' tables point at the null page
        0, which absorbs their writes. Positions past the table or past
        max_len (a finished request's discarded overshoot) are clamped as
        JAX clamps its gathers."""
        pos = cell["pos"]
        bs = cell["k0"].shape[1]
        NB = tables.shape[1]
        blk_idx = torch.clamp(pos.long() // bs, max=NB - 1)
        page = tables.long().gather(1, blk_idx[:, None])[:, 0]
        row = pos.long() % bs
        x = self.embed(tokens[:, None])                     # [B, 1, D]
        pe = self.pos_embed[torch.clamp(pos.long(), max=self.max_len - 1)]
        x = x + pe[:, None, :].to(x.dtype)
        for i, blk in enumerate(self.blocks):
            q, k, v = blk.heads(x)                          # [B, 1, H, Dh]
            kp, vp = cell[f"k{i}"], cell[f"v{i}"]
            kp[page, row] = k[:, 0].to(kp.dtype)
            vp[page, row] = v[:, 0].to(vp.dtype)
            o = ck.paged_decode_attention(q[:, 0], kp, vp, tables, pos,
                                          scale=blk.d_head ** -0.5,
                                          route=route)
            x = blk.finish(x, o[:, None])
        logits = self._logits(self.ln_f(x))
        new_cell = dict(cell)
        new_cell["pos"] = pos + 1
        return logits[:, 0], new_cell
