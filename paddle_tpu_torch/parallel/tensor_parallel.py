"""Tensor (model) parallel layers — the counterpart of
``paddle_tpu/parallel/tensor_parallel.py`` (the ParallelNeuralNetwork
replacement): megatron-style sharding *within* a layer over the
``model`` axis.

* ColumnParallelLinear: W [in, out] sharded on out — each rank computes
  its block of the output features; no communication.
* RowParallelLinear: W [in, out] sharded on in — it takes its block of
  the input features (a column-parallel layer's output), and the partial
  products are summed over the axis (one all-reduce).
* ShardedEmbedding: the table sharded over the vocab rows; each rank
  looks up the ids in its slice (zeros for the others) and the results
  are summed over the axis.

In JAX these layers run on full arrays inside a jit on a mesh, and XLA
partitions them from their sharding constraints. Here a rank computes
on its block explicitly, when a mesh with the layer's axis is in scope
(``shard_map``, ``use_mesh``, ``with mesh:``): a parameter that is a
DTensor placed by :func:`collect_tp_rules`' specs gives its block, a
full tensor is cut. With no such mesh in scope each layer is the dense
math. So a column-parallel layer's output under a mesh is this rank's
block of the features, which the row-parallel layer after it takes: the
column -> row pair is an MLP with exactly one all-reduce, the classic
recipe, and its output is the dense one. Parameters keep JAX's names
and layouts (``w`` [in, out], ``b``, ``table``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..nn import initializer as I
from ..nn.layers import _act, _apply
from ..nn.module import Module
from . import collectives as cc
from .mesh import find_axis_mesh
from .sharding import P, cut


def _block(t: torch.Tensor, axis: str, spec: P) -> torch.Tensor:
    """This rank's block of a parameter under ``spec`` (a DTensor's local
    block, or a cut of the full tensor)."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.to_local()
    return cut(t, find_axis_mesh(axis), spec)


class ColumnParallelLinear(Module):
    """y = act(x @ W + b); W sharded [None, axis] -> y sharded on features."""

    def __init__(self, in_dim: int, out_dim: int, act=None,
                 init: Optional[I.Initializer] = None, bias: bool = True,
                 axis: str = "model"):
        super().__init__()
        self.axis = axis
        self.act = _act(act)
        self.param("w", (in_dim, out_dim), init or I.gen1_default())
        self.has_bias = bias
        if bias:
            self.param("b", (out_dim,), I.zeros)

    def partition_specs(self):
        specs = {"w": P(None, self.axis)}
        if self.has_bias:
            specs["b"] = P(self.axis)
        return specs

    def forward(self, x, **kw):
        specs = self.partition_specs()
        sharded = find_axis_mesh(self.axis) is not None
        w = _block(self.w, self.axis, specs["w"]) if sharded else self.w
        y = x @ w
        if self.has_bias:
            y = y + (_block(self.b, self.axis, specs["b"]) if sharded
                     else self.b)
        return _apply(self.act, y)


class RowParallelLinear(Module):
    """y = x @ W + b; W sharded [axis, None]; the partial products are
    summed over the axis."""

    def __init__(self, in_dim: int, out_dim: int, act=None,
                 init: Optional[I.Initializer] = None, bias: bool = True,
                 axis: str = "model"):
        super().__init__()
        self.axis = axis
        self.act = _act(act)
        self.param("w", (in_dim, out_dim), init or I.gen1_default())
        self.has_bias = bias
        if bias:
            self.param("b", (out_dim,), I.zeros)

    def partition_specs(self):
        specs = {"w": P(self.axis, None)}
        if self.has_bias:
            specs["b"] = P()
        return specs

    def forward(self, x, **kw):
        if find_axis_mesh(self.axis) is not None:
            # x is this rank's block of the input features
            w = _block(self.w, self.axis, P(self.axis, None))
            y = cc.all_reduce(x @ w, self.axis)
        else:
            y = x @ self.w
        if self.has_bias:
            b = self.b
            y = y + (b.to_local() if hasattr(b, "to_local") else b)
        return _apply(self.act, y)


class ShardedEmbedding(Module):
    """Embedding with the table sharded over the axis on the vocab dim
    (the sparse-row pserver tables' analog, math/SparseRowMatrix.h):
    lookups are a masked local gather and a sum over the axis; the plain
    gather when no mesh with the axis is in scope."""

    def __init__(self, vocab_size: int, dim: int,
                 init: Optional[I.Initializer] = None, axis: str = "model"):
        super().__init__()
        self.vocab_size = vocab_size
        self.dim = dim
        self.axis = axis
        self.param("table", (vocab_size, dim), init or I.gen1_default())

    def partition_specs(self):
        return {"table": P(self.axis, None)}

    def forward(self, ids, **kw):
        ids = ids.long()
        mesh = find_axis_mesh(self.axis)
        if mesh is None:
            return self.table[ids]
        table = _block(self.table, self.axis, P(self.axis, None))
        lo = mesh.coordinate(self.axis) * table.shape[0]
        mine = (ids >= lo) & (ids < lo + table.shape[0])
        rows = table[torch.where(mine, ids - lo, 0)]
        rows = rows * mine[..., None].to(rows.dtype)
        return cc.all_reduce(rows, self.axis)


def collect_tp_rules(module: Module, prefix: str = ""):
    """Walk a module tree collecting (path-regex, spec) rules from every
    layer that defines ``partition_specs()`` — feed to ShardingRules."""
    rules = []
    for name, m in module.named_modules():
        if hasattr(m, "partition_specs"):
            path = "/".join(p for p in (prefix, name.replace(".", "/")) if p)
            for pname, spec in m.partition_specs().items():
                pat = f"{path}/{pname}" if path else pname
                rules.append((pat + "$", spec))
    return rules
