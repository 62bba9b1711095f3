"""MNIST MLP — the counterpart of ``paddle_tpu/models/mlp.py``: two
128-unit relu layers and a 10-way linear (``fc1``, ``fc2``, ``out``)."""

from __future__ import annotations

import torch

from ..nn import Linear, Module
from ..ops.loss import softmax_with_cross_entropy


class MnistMLP(Module):
    def __init__(self, in_dim: int = 784, hidden: int = 128,
                 classes: int = 10):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden, act="relu")
        self.fc2 = Linear(hidden, hidden, act="relu")
        self.out = Linear(hidden, classes)

    def forward(self, x, **kw):
        return self.out(self.fc2(self.fc1(x)))

    def loss(self, x, labels, **kw):
        return torch.mean(softmax_with_cross_entropy(self(x), labels))

    def accuracy(self, x, labels):
        return torch.mean((torch.argmax(self(x), -1) == labels.long())
                          .to(torch.float32))
