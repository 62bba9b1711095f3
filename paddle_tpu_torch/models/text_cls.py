"""Text classification models — the counterpart of
``paddle_tpu/models/text_cls.py`` (``LSTMTextCls``, ``BiLSTMTextCls``).

embedding -> masked LSTM over a ``SeqBatch`` (``ops/rnn.py``, through the
port's LSTM kernels) -> pooling over time -> linear -> logits, with
``forget_bias=1.0`` as in JAX. ``LSTMTextCls(pool="last")`` is the
last-step variant of ``benchmarks/lstm_textcls.py`` (the reference's
``benchmark/paddle/rnn/rnn.py``, which pools with last_seq); ``"max"`` is
the JAX model's default.

Parameter names and layouts are the JAX tree's (``embed/w``, ``w{i}``
[D, 4H], ``u{i}`` [H, 4H], ``b{i}`` [4H], ``fc/w`` [H, classes],
``fc/b``), so ``convert.params_from_numpy`` loads a JAX tree as it is.

``model(batch)`` gives logits, ``model(batch, labels)`` the mean softmax
cross-entropy; ``model.call(params, batch, labels)`` the same with the
leaves of a parameter tree (what ``Trainer`` differentiates). ``route``
goes to the LSTM kernels ("plain": their plain versions on any device).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.lod import SeqBatch
from ..nn import Embedding, Linear, Module
from ..nn.initializer import uniform, zeros
from ..ops import rnn as R
from ..ops import sequence as S
from ..ops.loss import softmax_with_cross_entropy


def _head(logits: torch.Tensor, labels: Optional[torch.Tensor]):
    if labels is None:
        return logits
    return torch.mean(softmax_with_cross_entropy(logits, labels))


class LSTMTextCls(Module):
    """embedding -> (stacked) LSTM -> pool over time ("max" or "last")
    -> logits."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 hidden: int = 128, classes: int = 2, num_layers: int = 1,
                 pool: str = "max"):
        super().__init__()
        if pool not in ("max", "last"):
            raise ValueError(f"pool {pool!r} is not 'max' or 'last'")
        self.embed = Embedding(vocab_size, embed_dim)
        self.num_layers, self.pool = num_layers, pool
        dims = [embed_dim] + [hidden] * num_layers
        for i in range(num_layers):
            self.param(f"w{i}", (dims[i], 4 * hidden), uniform(-0.08, 0.08))
            self.param(f"u{i}", (hidden, 4 * hidden), uniform(-0.08, 0.08))
            self.param(f"b{i}", (4 * hidden,), zeros)
        self.fc = Linear(hidden, classes)

    def forward(self, batch: SeqBatch, labels: Optional[torch.Tensor] = None,
                *, route: Optional[str] = None) -> torch.Tensor:
        h = self.embed(batch.data)                          # [B, T, E]
        for i in range(self.num_layers):
            h, _ = R.lstm(h, batch.lengths, getattr(self, f"w{i}"),
                          getattr(self, f"u{i}"), getattr(self, f"b{i}"),
                          forget_bias=1.0, route=route)
        return _head(self.fc(S.sequence_pool(h, batch.lengths, self.pool)),
                     labels)


class BiLSTMTextCls(Module):
    """Forward and reverse LSTM, the forward's last step and the reverse's
    first step concatenated -> logits (networks.py bidirectional_lstm).
    The reverse direction runs the forward kernels on the within-length
    flipped sequence (``ops/rnn.py`` ``_reverse_within_length``)."""

    def __init__(self, vocab_size: int, embed_dim: int = 128,
                 hidden: int = 128, classes: int = 2):
        super().__init__()
        self.embed = Embedding(vocab_size, embed_dim)
        for d in ("f", "b"):
            self.param(f"w_{d}", (embed_dim, 4 * hidden), uniform(-0.08, 0.08))
            self.param(f"u_{d}", (hidden, 4 * hidden), uniform(-0.08, 0.08))
            self.param(f"bias_{d}", (4 * hidden,), zeros)
        self.fc = Linear(2 * hidden, classes)

    def forward(self, batch: SeqBatch, labels: Optional[torch.Tensor] = None,
                *, route: Optional[str] = None) -> torch.Tensor:
        x = self.embed(batch.data)
        hf, _ = R.lstm(x, batch.lengths, self.w_f, self.u_f, self.bias_f,
                       forget_bias=1.0, route=route)
        hb, _ = R.lstm(x, batch.lengths, self.w_b, self.u_b, self.bias_b,
                       reverse=True, forget_bias=1.0, route=route)
        h = torch.cat([S.sequence_last_step(hf, batch.lengths),
                       S.sequence_first_step(hb, batch.lengths)], dim=-1)
        return _head(self.fc(h), labels)
