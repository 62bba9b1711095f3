"""Sequence tagging — the counterpart of ``paddle_tpu/models/tagger.py``:
``LinearCRFTagger`` (embedding -> linear -> CRF) and ``BiLSTMCRFTagger``
(embedding -> forward and reverse LSTM -> linear -> CRF).

The CRF is ``ops/crf.py``: its forward algorithm and Viterbi are loops
over T with no host read. The BiLSTM's two directions are two
``ops.rnn.lstm`` calls (the second ``reverse=True``), both with
``forget_bias=1.0``, so on the card a training step runs the LSTM's
training forward (#9) and backward (#10) kernels twice, and ``decode``
its inference kernel (#8) twice. ``decode`` is one CUDA graph per batch
signature on the card (emissions and Viterbi, :meth:`_decode_body`).

Parameter names and layouts are the JAX tree's: ``embed/w``,
``w_{f,b}`` [E, 4H], ``u_{f,b}`` [H, 4H], ``bias_{f,b}`` [4H], ``fc``
and ``crf/{start, end, trans}`` (trans[i, j]: tag i followed by j), so
``convert.params_from_numpy`` loads a JAX tree as it is. ``loss`` takes
the tags as a ``SeqBatch`` (JAX's) or their [B, T] tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core.lod import SeqBatch
from ..nn import Embedding, Linear, Module
from ..nn.initializer import uniform, zeros
from ..ops import crf as CRF
from ..ops import rnn as R


class _CRFHead(Module):
    def __init__(self, num_tags: int):
        super().__init__()
        self.num_tags = num_tags
        self.param("start", (num_tags,), uniform(-0.05, 0.05))
        self.param("end", (num_tags,), uniform(-0.05, 0.05))
        self.param("trans", (num_tags, num_tags), uniform(-0.05, 0.05))

    def loss(self, emissions, tags, lengths):
        return torch.mean(CRF.crf_loss(emissions, tags, lengths, self.start,
                                       self.end, self.trans))

    def decode(self, emissions, lengths):
        return CRF.crf_decode(emissions, lengths, self.start, self.end,
                              self.trans)


Tags = Union[SeqBatch, torch.Tensor]


class _Tagger(Module):
    """``loss`` and ``decode`` over a model's ``emissions``."""

    def forward(self, batch: SeqBatch, *, route: Optional[str] = None
                ) -> torch.Tensor:
        """Emissions [B, T, num_tags]."""
        return self.emissions(batch, route=route)

    def loss(self, batch: SeqBatch, tags: Tags, *,
             route: Optional[str] = None) -> torch.Tensor:
        """The mean CRF negative log-likelihood of ``tags``."""
        tags = tags.data if isinstance(tags, SeqBatch) else tags
        return self.crf.loss(self.emissions(batch, route=route), tags,
                             batch.lengths)

    def decode(self, batch: SeqBatch, *, route: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Viterbi tags [B, T] (0 past each length) and their scores [B]."""
        return self.graph_cache().run(
            "decode", self._decode_body,
            {"data": batch.data, "lengths": batch.lengths},
            static=dict(route=route))

    @torch.no_grad()
    def _decode_body(self, data, lengths, *, route):
        batch = SeqBatch(data, lengths)
        return self.crf.decode(self.emissions(batch, route=route), lengths)


class LinearCRFTagger(_Tagger):
    """embedding -> linear -> CRF (linear_crf.py)."""

    def __init__(self, vocab_size: int, num_tags: int, embed_dim: int = 64):
        super().__init__()
        self.embed = Embedding(vocab_size, embed_dim)
        self.fc = Linear(embed_dim, num_tags)
        self.crf = _CRFHead(num_tags)

    def emissions(self, batch: SeqBatch, *, route: Optional[str] = None):
        return self.fc(self.embed(batch.data))


class BiLSTMCRFTagger(_Tagger):
    """embedding -> BiLSTM -> linear -> CRF (rnn_crf.py)."""

    def __init__(self, vocab_size: int, num_tags: int, embed_dim: int = 64,
                 hidden: int = 64):
        super().__init__()
        self.embed = Embedding(vocab_size, embed_dim)
        for d in ("f", "b"):
            self.param(f"w_{d}", (embed_dim, 4 * hidden),
                       uniform(-0.08, 0.08))
            self.param(f"u_{d}", (hidden, 4 * hidden), uniform(-0.08, 0.08))
            self.param(f"bias_{d}", (4 * hidden,), zeros)
        self.fc = Linear(2 * hidden, num_tags)
        self.crf = _CRFHead(num_tags)

    def emissions(self, batch: SeqBatch, *, route: Optional[str] = None):
        x = self.embed(batch.data)
        hf, _ = R.lstm(x, batch.lengths, self.w_f, self.u_f, self.bias_f,
                       forget_bias=1.0, route=route)
        hb, _ = R.lstm(x, batch.lengths, self.w_b, self.u_b, self.bias_b,
                       reverse=True, forget_bias=1.0, route=route)
        return self.fc(torch.cat([hf, hb], dim=-1))
