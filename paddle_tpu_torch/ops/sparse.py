"""Sparse-row gradients (SelectedRows) and sparse matrices — the
counterpart of ``paddle_tpu/ops/sparse.py``.

A ``SelectedRows`` gradient is (rows, values) pairs touching few rows of
a big table; the updates apply row-gathered steps, and
:mod:`paddle_tpu_torch.runtime.host_embedding` keeps a table larger than
the card in host memory and streams each batch's touched rows. The
general sparse matrices are ``torch.sparse_coo_tensor`` in place of
JAX's BCOO (uncoalesced, as BCOO: a duplicate entry stays and sums in
``to_dense`` and in the products).

Repeated rows: JAX leaves the order of a scatter-add's duplicates to
the backend (its CPU adds them one after the other from the row's value,
in the order they appear; a GPU's atomics land in any order). The port's
rule is the CPU's order, on the card too (where ``index_add_`` over
repeated indices adds in whatever order its atomics land): the rows are
sorted stably and each row's segment, led by the row's value, is summed
from 0 in order by ``torch.segment_reduce``. The sums are then the same
bits as JAX's on the CPU, on any device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


def scatter_add_ordered(out: torch.Tensor, rows: torch.Tensor,
                        values: torch.Tensor) -> torch.Tensor:
    """``out.at[rows].add(values)`` as a new tensor, each repeated row's
    values added one at a time in their order in ``rows``, from the row's
    value (module docstring): the rows sorted stably, each segment led by
    the row's value, and ``torch.segment_reduce`` (a sequential sum a
    segment from 0, on the CPU and the card alike)."""
    rows = rows.reshape(-1).long()
    out = out.clone()
    K = rows.numel()
    if K == 0:
        return out
    values = values.reshape((K,) + tuple(out.shape[1:])).to(out.dtype)
    srt, order = torch.sort(rows, stable=True)
    uniq, counts = torch.unique_consecutive(srt, return_counts=True)
    lead = torch.arange(uniq.numel(), device=rows.device)
    first = torch.cumsum(counts, 0) - counts            # in the sorted rows
    seg = torch.repeat_interleave(lead, counts)
    data = out.new_empty((K + uniq.numel(),) + tuple(out.shape[1:]))
    data[first + lead] = out[uniq]
    data[torch.arange(K, device=rows.device) + seg + 1] = values[order]
    out[uniq] = torch.segment_reduce(data, "sum", lengths=counts + 1,
                                     axis=0, unsafe=True)
    return out


@dataclass
class SelectedRows:
    """Sparse gradient: values [K, D] at row indices rows [K] of a
    [height, D] table (a repeated row stands for the sum of its values)."""

    rows: torch.Tensor
    values: torch.Tensor
    height: int

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros((self.height, self.values.shape[-1]),
                          dtype=self.values.dtype, device=self.values.device)
        return scatter_add_ordered(out, self.rows, self.values)


def embedding_grad_rows(ids: torch.Tensor, out_grad: torch.Tensor,
                        height: int) -> SelectedRows:
    """The SelectedRows gradient of an embedding lookup: one row a lookup,
    repeated ids kept (they sum wherever the gradient is applied)."""
    return SelectedRows(ids.reshape(-1),
                        out_grad.reshape(-1, out_grad.shape[-1]), height)


def sgd_sparse_update(table: torch.Tensor, grad: SelectedRows,
                      lr) -> torch.Tensor:
    """Row-sparse SGD: ``table.at[rows].add(-lr * values)`` (a repeated
    row takes its steps one after the other)."""
    return scatter_add_ordered(table, grad.rows, -lr * grad.values)


def _merged(grad: SelectedRows) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the distinct rows, ascending; each one's summed gradient), the
    sums in the order of ``grad.rows`` from 0 (what JAX's ``to_dense``
    holds at those rows, without the dense [height, D] buffer)."""
    rows = grad.rows.reshape(-1).long()
    uniq, inv = torch.unique(rows, return_inverse=True)
    acc = torch.zeros((uniq.numel(), grad.values.shape[-1]),
                      dtype=grad.values.dtype, device=grad.values.device)
    return uniq, scatter_add_ordered(acc, inv, grad.values)


def adagrad_sparse_update(table: torch.Tensor, moment: torch.Tensor,
                          grad: SelectedRows, lr, eps: float = 1e-6
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-sparse Adagrad: repeated rows merged first, then each touched
    row updated once with its merged gradient g: m += g**2, table -= lr g
    / (sqrt(m) + eps). Returns (table, moment), new tensors."""
    rows, g = _merged(grad)
    new_m = moment[rows] + torch.square(g)
    step = -lr * g / (torch.sqrt(new_m) + eps)
    moment = moment.clone()
    moment[rows] = new_m
    table = table.clone()
    table[rows] = table[rows] + step
    return table, moment


def lookup_table(table: torch.Tensor, ids: torch.Tensor,
                 padding_idx: Optional[int] = None) -> torch.Tensor:
    """Embedding lookup; rows of ``padding_idx`` read as 0."""
    out = table[ids.long()]
    if padding_idx is not None:
        out = torch.where((ids == padding_idx)[..., None],
                          torch.zeros((), dtype=out.dtype,
                                      device=out.device), out)
    return out


# ---------------------------------------------------------------------------
# general sparse matrices (CSR / CSC / COO constructors over COO tensors)
# ---------------------------------------------------------------------------

def _coo(values, rows, cols, shape) -> torch.Tensor:
    values = torch.as_tensor(values)
    idx = torch.stack([torch.as_tensor(np.asarray(rows), dtype=torch.long),
                       torch.as_tensor(np.asarray(cols), dtype=torch.long)])
    return torch.sparse_coo_tensor(idx.to(values.device), values,
                                   tuple(shape), check_invariants=True)


def csr_matrix(values, col_ids, row_ptr, shape) -> torch.Tensor:
    """A sparse matrix from CSR arrays (non-value format: values of all
    ones)."""
    row_ptr = np.asarray(row_ptr)
    rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    return _coo(values, rows, col_ids, shape)


def csc_matrix(values, row_ids, col_ptr, shape) -> torch.Tensor:
    """A sparse matrix from CSC arrays."""
    col_ptr = np.asarray(col_ptr)
    cols = np.repeat(np.arange(len(col_ptr) - 1), np.diff(col_ptr))
    return _coo(values, row_ids, cols, shape)


def coo_matrix(values, rows, cols, shape) -> torch.Tensor:
    return _coo(values, rows, cols, shape)


def sparse_dense_matmul(sp: torch.Tensor, dense: torch.Tensor
                        ) -> torch.Tensor:
    """sp @ dense, differentiable in both operands."""
    return torch.sparse.mm(sp, dense)


def dense_sparse_matmul(dense: torch.Tensor, sp: torch.Tensor
                        ) -> torch.Tensor:
    """dense @ sp, as (spᵀ @ denseᵀ)ᵀ."""
    return torch.sparse.mm(sp.t(), dense.t()).t()


def sparse_to_dense(sp: torch.Tensor) -> torch.Tensor:
    return sp.to_dense()


def dense_to_bcoo(x: torch.Tensor, nse: Optional[int] = None
                  ) -> torch.Tensor:
    """Sparsify a dense matrix: its nonzeros in row-major order, as
    ``BCOO.fromdense``. ``nse`` past the nonzeros pads with zero entries
    at (0, 0) (BCOO pads past the matrix, which a COO tensor does not
    take; the matrix is the same)."""
    idx = torch.nonzero(x).t()
    vals = x[tuple(idx)]
    if nse is not None:
        if nse < vals.numel():
            raise ValueError(f"nse {nse} < the {vals.numel()} nonzeros")
        extra = nse - vals.numel()
        idx = torch.cat([idx, idx.new_zeros((x.dim(), extra))], dim=1)
        vals = torch.cat([vals, vals.new_zeros(extra)])
    return torch.sparse_coo_tensor(idx, vals, tuple(x.shape),
                                   check_invariants=True)
