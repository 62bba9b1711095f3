"""The embedding-heavy book models — the counterpart of
``paddle_tpu/models/embeddings.py``: ``Word2Vec`` (an n-gram neural LM
over shared embeddings), ``Recommender`` (the movielens two-tower
regressor) and ``DeepFM`` (factorization machine + deep tower over
hashed sparse fields, the Criteo CTR shape).

Each model's ``forward`` is JAX's ``__call__`` (logits or predictions)
and ``loss`` JAX's ``loss``; ``model.call(params, ..., method="loss")``
is what ``Trainer`` differentiates. Parameter names and layouts are the
JAX tree's (``DeepFM``'s tower is ``deep_{i}``, as JAX names a list of
children), so ``convert.params_from_numpy`` loads a JAX tree as it is.
The lookups are ``Embedding``'s gathers, whose backward on the card is
PyTorch's indexing backward (ROADMAP, "Measured leads").
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..nn import Embedding, Linear, Module
from ..ops import loss as L


class Word2Vec(Module):
    """N-gram neural LM: the context's embeddings concatenated -> hidden
    (ReLU) -> logits over the vocabulary."""

    def __init__(self, vocab_size: int, embed_dim: int = 32,
                 context: int = 4, hidden: int = 128):
        super().__init__()
        self.context = context
        self.embed = Embedding(vocab_size, embed_dim)
        self.fc1 = Linear(context * embed_dim, hidden, act="relu")
        self.out = Linear(hidden, vocab_size)

    def forward(self, context_ids: torch.Tensor, **kw) -> torch.Tensor:
        """context_ids [B, context] -> logits [B, V]."""
        e = self.embed(context_ids)                        # [B, C, E]
        return self.out(self.fc1(e.reshape(e.shape[0], -1)))

    def loss(self, context_ids, target_ids) -> torch.Tensor:
        return torch.mean(L.softmax_with_cross_entropy(self(context_ids),
                                                       target_ids))


class Recommender(Module):
    """Two-tower movielens regressor: the user tower (id, gender, age and
    job embeddings) and the movie tower (id embedding and the mean of its
    category embeddings) -> a linear head -> the rating."""

    def __init__(self, n_users: int, n_movies: int, n_categories: int,
                 n_jobs: int, n_ages: int, dim: int = 32):
        super().__init__()
        half = dim // 2
        self.uid = Embedding(n_users, dim)
        self.gender = Embedding(2, half)
        self.age = Embedding(n_ages, half)
        self.job = Embedding(n_jobs, half)
        self.user_fc = Linear(dim + 3 * half, dim, act="tanh")
        self.mid = Embedding(n_movies, dim)
        self.cat = Embedding(n_categories, half)
        self.movie_fc = Linear(dim + half, dim, act="tanh")
        self.head = Linear(2 * dim, 1)

    def forward(self, uid, gender, age, job, mid, cat_ids, cat_vals, **kw
                ) -> torch.Tensor:
        """cat_ids/cat_vals: the padded sparse category slot [B, K]
        (cat_vals 0 on padding) -> predicted ratings [B]."""
        u = self.user_fc(torch.cat([self.uid(uid), self.gender(gender),
                                    self.age(age), self.job(job)], dim=-1))
        denom = torch.clamp(cat_vals.sum(-1, keepdim=True), min=1.0)
        cat_pooled = (self.cat(cat_ids) * cat_vals[..., None]).sum(1) / denom
        m = self.movie_fc(torch.cat([self.mid(mid), cat_pooled], dim=-1))
        return self.head(torch.cat([u, m], dim=-1))[..., 0]

    def loss(self, uid, gender, age, job, mid, cat_ids, cat_vals, rating
             ) -> torch.Tensor:
        pred = self(uid, gender, age, job, mid, cat_ids, cat_vals)
        return torch.mean((pred - rating) ** 2)


class DeepFM(Module):
    """Factorization machine + deep tower over hashed sparse fields.

    First order: the fields' weights summed plus a linear map of the
    dense features; second order: the FM pairwise term through the
    (sum^2 - sum of squares) / 2 identity; the deep tower: the fields'
    factors and the dense features through ReLU layers. One gather of
    the factors feeds both the FM and the tower."""

    def __init__(self, hash_size: int, num_fields: int, dense_dim: int,
                 factor: int = 8, hidden: Sequence[int] = (64, 32)):
        super().__init__()
        self.w1 = Embedding(hash_size, 1)
        self.v = Embedding(hash_size, factor)
        self.dense_w = Linear(dense_dim, 1, bias=False)
        dims = [num_fields * factor + dense_dim] + list(hidden)
        self.n_deep = len(hidden)
        for i in range(self.n_deep):
            setattr(self, f"deep_{i}", Linear(dims[i], dims[i + 1],
                                              act="relu"))
        self.deep_out = Linear(dims[-1], 1)

    def forward(self, dense: torch.Tensor, field_ids: torch.Tensor, **kw
                ) -> torch.Tensor:
        """dense [B, dense_dim]; field_ids [B, num_fields] hashed ids ->
        the click logit [B]."""
        lin = self.w1(field_ids)[..., 0].sum(-1, keepdim=True)
        lin = lin + self.dense_w(dense)
        vi = self.v(field_ids)                             # [B, F, k]
        fm = 0.5 * (torch.square(vi.sum(1))
                    - torch.square(vi).sum(1)).sum(-1, keepdim=True)
        h = torch.cat([vi.reshape(vi.shape[0], -1), dense], dim=-1)
        for i in range(self.n_deep):
            h = getattr(self, f"deep_{i}")(h)
        return (lin + fm + self.deep_out(h))[..., 0]

    def loss(self, dense, field_ids, labels) -> torch.Tensor:
        return torch.mean(L.sigmoid_cross_entropy_with_logits(
            self(dense, field_ids), labels.to(torch.float32)))

    def predict_proba(self, dense, field_ids) -> torch.Tensor:
        return torch.sigmoid(self(dense, field_ids))
