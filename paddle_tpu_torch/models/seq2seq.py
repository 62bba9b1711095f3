"""Attention seq2seq NMT — the counterpart of
``paddle_tpu/models/seq2seq.py``, the repo's machine-translation flagship.

A bidirectional GRU encoder (``ops/rnn.py`` ``gru``, both directions
through the GRU kernels #11-#12 on the card; the reverse one on the
within-length flipped input), a decoder boot ``init_fc`` from the reverse
direction's final state, additive attention (score = v . tanh(We e +
Wd d)) and a GRU decoder cell whose input is [target embedding | context].
Training is teacher-forced: the embedding half of the decoder's input
projection for all steps is one product before the loop, the output
projection one product after it; only the [B, H] state runs step by step
(a Python loop, where JAX runs a ``lax.scan``; on the card it falls
inside the trainer's step graph). Generation is the beam search or the
greedy search of ``ops/beam_search.py`` over
:meth:`AttentionSeq2Seq.decode_step`, the encoder and the search one CUDA
graph a call on the card. The decoder cell and the attention
are plain PyTorch, as they are plain math outside any Pallas kernel in
JAX.

Parameter names and layouts are the JAX tree's (``src_embed/w``,
``trg_embed/w``, ``enc_{w,u,b}_{f,b}``, ``init_fc/{w,b}``, ``att_enc/w``,
``att_dec/w``, ``att_v``, ``dec_w``, ``dec_u``, ``dec_b``, ``out/{w,b}``),
so ``convert.params_from_numpy`` loads a JAX tree as it is. ``route``
goes to the GRU kernels ("plain": their plain versions on any device).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.lod import SeqBatch, sequence_mask
from ..nn import Embedding, Linear, Module
from ..nn.initializer import uniform, zeros
from ..ops import beam_search as BS
from ..ops import rnn as R


class DecoderState(NamedTuple):
    h: torch.Tensor          # [B, H] decoder GRU state
    enc: torch.Tensor        # [B, S, 2H] encoder states
    enc_proj: torch.Tensor   # [B, S, H] att_enc(enc), computed once
    enc_mask: torch.Tensor   # [B, S]


class AttentionSeq2Seq(Module):
    def __init__(self, src_vocab: int, trg_vocab: int, embed_dim: int = 128,
                 hidden: int = 128):
        super().__init__()
        H = hidden
        self.hidden, self.embed_dim = H, embed_dim
        self.src_embed = Embedding(src_vocab, embed_dim)
        self.trg_embed = Embedding(trg_vocab, embed_dim)
        for d in ("f", "b"):              # bidirectional GRU encoder
            self.param(f"enc_w_{d}", (embed_dim, 3 * H), uniform(-0.08, 0.08))
            self.param(f"enc_u_{d}", (H, 3 * H), uniform(-0.08, 0.08))
            self.param(f"enc_b_{d}", (3 * H,), zeros)
        # the decoder boots from the reverse direction's final state
        self.init_fc = Linear(H, H, act="tanh")
        self.att_enc = Linear(2 * H, H, bias=False)
        self.att_dec = Linear(H, H, bias=False)
        self.param("att_v", (H,), uniform(-0.08, 0.08))
        # decoder GRU: input [embedding | context 2H]
        self.param("dec_w", (embed_dim + 2 * H, 3 * H), uniform(-0.08, 0.08))
        self.param("dec_u", (H, 3 * H), uniform(-0.08, 0.08))
        self.param("dec_b", (3 * H,), zeros)
        self.out = Linear(H, trg_vocab)

    # -- encoder -----------------------------------------------------------
    def encode(self, src: SeqBatch, *,
               route: Optional[str] = None) -> DecoderState:
        x = self.src_embed(src.data)
        hf, _ = R.gru(x, src.lengths, self.enc_w_f, self.enc_u_f,
                      self.enc_b_f, route=route)
        hb, last_b = R.gru(x, src.lengths, self.enc_w_b, self.enc_u_b,
                           self.enc_b_b, reverse=True, route=route)
        enc = torch.cat([hf, hb], dim=-1)                     # [B, S, 2H]
        mask = sequence_mask(src.lengths, src.max_len)
        return DecoderState(self.init_fc(last_b), enc, self.att_enc(enc),
                            mask)

    # -- one decoder step (shared by training and the searches) -------------
    def attend(self, h, enc, enc_proj, enc_mask) -> torch.Tensor:
        """Additive attention: the context [B, 2H] of state h [B, H]."""
        score = torch.einsum(
            "bsh,h->bs", torch.tanh(enc_proj + self.att_dec(h)[:, None, :]),
            self.att_v)
        score = torch.where(enc_mask > 0, score,
                            torch.full((), -1e30, dtype=score.dtype,
                                       device=score.device))
        alpha = torch.softmax(score, dim=-1)
        return torch.einsum("bs,bsh->bh", alpha, enc)

    def cell_step(self, state: DecoderState, token_embed,
                  embed_proj=None) -> DecoderState:
        """Advance the decoder GRU one token (no output projection).
        dec_w splits into its embedding and context rows, so teacher
        forcing feeds a step's slice of the whole-sequence embedding
        projection (``embed_proj``)."""
        ctx = self.attend(state.h, state.enc, state.enc_proj, state.enc_mask)
        e_dim = self.embed_dim
        if embed_proj is None:
            embed_proj = token_embed @ self.dec_w[:e_dim]
        xw = embed_proj + ctx @ self.dec_w[e_dim:]
        h = R.gru_cell(xw, state.h, self.dec_u, self.dec_b)
        return DecoderState(h, state.enc, state.enc_proj, state.enc_mask)

    def decode_step(self, state: DecoderState, token_embed):
        new_state = self.cell_step(state, token_embed)
        return self.out(new_state.h), new_state

    # -- training ----------------------------------------------------------
    def forward(self, src: SeqBatch, trg_in: SeqBatch, *,
                route: Optional[str] = None) -> torch.Tensor:
        """Teacher-forced logits [B, T, V]."""
        state = self.encode(src, route=route)
        emb = self.trg_embed(trg_in.data)                     # [B, T, E]
        embw = emb @ self.dec_w[:emb.shape[-1]]               # [B, T, 3H]
        h, hs = state.h, []
        for t in range(embw.shape[1]):
            h = self.cell_step(state._replace(h=h), None,
                               embed_proj=embw[:, t]).h
            hs.append(h)
        return self.out(torch.stack(hs, dim=1))

    def loss(self, src: SeqBatch, trg_in: SeqBatch, trg_out: SeqBatch, *,
             route: Optional[str] = None) -> torch.Tensor:
        """Mean token cross-entropy over the target positions below each
        length. ``log_softmax`` runs in the logits' dtype (bf16 under a
        bf16 recipe), as the JAX loss takes it; the masked mean then
        promotes to the mask's f32."""
        logp = torch.log_softmax(self(src, trg_in, route=route), dim=-1)
        nll = -torch.gather(logp, -1, trg_out.data.long()[..., None])[..., 0]
        mask = trg_out.mask()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

    # -- inference ---------------------------------------------------------
    def _step_fn(self):
        def step_fn(cell, tokens):
            logits, new_cell = self.decode_step(cell, self.trg_embed(tokens))
            return torch.log_softmax(logits, dim=-1), new_cell
        return step_fn

    @torch.no_grad()
    def generate(self, src: SeqBatch, *, beam_size: int = 4,
                 max_len: int = 32, bos_id: int = 0, eos_id: int = 1,
                 length_penalty: float = 0.0, route: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Beam-search decode: (tokens [B, K, max_len], scores [B, K])
        sorted best-first. The encoder and the whole search (JAX's
        ``lax.scan``) are one CUDA graph per (B, S, K, max_len) on the
        card (:meth:`_beam_body`)."""
        return self.graph_cache().run(
            "beam", self._beam_body,
            {"data": src.data, "lengths": src.lengths},
            static=dict(beam_size=beam_size, max_len=max_len, bos_id=bos_id,
                        eos_id=eos_id, length_penalty=length_penalty,
                        route=route))

    @torch.no_grad()
    def _beam_body(self, data, lengths, *, beam_size, max_len, bos_id,
                   eos_id, length_penalty, route):
        return BS.beam_search(
            self.encode(SeqBatch(data, lengths), route=route),
            self._step_fn(), batch_size=data.shape[0], beam_size=beam_size,
            max_len=max_len, vocab_size=self.out.w.shape[1], bos_id=bos_id,
            eos_id=eos_id, length_penalty=length_penalty)

    @torch.no_grad()
    def greedy_generate(self, src: SeqBatch, *, max_len: int = 32,
                        bos_id: int = 0, eos_id: int = 1,
                        route: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy decode: (tokens [B, max_len], scores [B]); the encoder
        and the search are one CUDA graph per (B, S, max_len) on the card
        (:meth:`_greedy_body`)."""
        return self.graph_cache().run(
            "greedy", self._greedy_body,
            {"data": src.data, "lengths": src.lengths},
            static=dict(max_len=max_len, bos_id=bos_id, eos_id=eos_id,
                        route=route))

    @torch.no_grad()
    def _greedy_body(self, data, lengths, *, max_len, bos_id, eos_id,
                     route):
        return BS.greedy_search(
            self.encode(SeqBatch(data, lengths), route=route),
            self._step_fn(), batch_size=data.shape[0], max_len=max_len,
            bos_id=bos_id, eos_id=eos_id)
