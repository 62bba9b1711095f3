"""Host-offloaded embedding tables: tables larger than the card streamed
by touched rows — the counterpart of ``paddle_tpu/runtime/host_embedding.py``.

The master table lives in host memory inside a
:class:`~paddle_tpu_torch.runtime.optimizer.HostOptimizer` (the host
library's f32 storage with sparse row updates, native/optimizer.cc), and
each step:

1. **prefetch** — ``np.unique(ids)`` -> ``pto_get_rows`` gathers the C
   touched rows -> one [capacity, D] tensor on the device (padded to a
   fixed capacity, so a graphed step keeps one signature), in
   ``compute_dtype``;
2. **device step** — the lookup is ``F.embedding(inverse, rows)``, which
   autograd differentiates: the gradient of ``rows`` is the merged
   SelectedRows gradient (repeated ids summed). ``np.unique`` sorts, so
   ``inverse`` keeps the ids' order and the sums run as over the table;
3. **apply** — ``pto_update_rows`` updates only the touched rows on the
   host.

:class:`HostEmbedPrefetcher` overlaps step 1 for batch i+1 with the
device work of batch i without staleness: after batch i's update lands,
the rows of the pending prefetch that the update touched are gathered
again and patched, so every step reads the post-update table (bit-equal
to a table on the card, ``tests/test_torch_host_embedding.py``).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.place import DeviceLike, require_device
from .optimizer import HostOptimizer


@dataclass
class HostEmbedBatch:
    """One batch's streamed slice of the table."""

    rows: torch.Tensor       # [capacity, D] on the device, compute_dtype
    inverse: torch.Tensor    # ids.shape, int64: indices into rows
    unique: np.ndarray       # [capacity] host ids (padded with 0)
    count: int               # the real unique ids (<= capacity)


class HostEmbeddingTable:
    """A vocab x dim table in host memory, streamed by touched rows.

    ``capacity`` is the fixed unique-row budget of a batch (the pad
    target): the device holds ``capacity * dim`` rows whatever the
    vocabulary. ``compute_dtype`` is the streamed copy's dtype (bf16
    halves the bytes; the host master and its updates stay f32);
    ``device`` where the rows go (default: the card)."""

    def __init__(self, vocab_size: int, dim: int, *, optimizer: str = "sgd",
                 lr: float = 0.01, capacity: int = 4096,
                 compute_dtype: Optional[torch.dtype] = None,
                 init: Optional[np.ndarray] = None, seed: int = 0,
                 device: DeviceLike = None, **opt_kw):
        self.device = require_device(device)
        self.vocab_size, self.dim, self.capacity = vocab_size, dim, capacity
        if init is None:
            rs = np.random.RandomState(seed)
            init = (rs.standard_normal((vocab_size, dim)) * 0.01).astype(
                np.float32)
        elif isinstance(init, str) and init == "zeros":
            init = (vocab_size, dim)         # zero-filled by the library
        self.opt = HostOptimizer(optimizer, init, lr=lr, **opt_kw)
        self.compute_dtype = compute_dtype or torch.float32

    # -- step protocol ------------------------------------------------------
    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows).to(self.device).to(self.compute_dtype)

    def prefetch(self, ids: np.ndarray) -> HostEmbedBatch:
        """Gather the batch's touched rows to the device (padded)."""
        ids = np.asarray(ids)
        unique, inverse = np.unique(ids, return_inverse=True)
        if unique.size > self.capacity:
            raise ValueError(
                f"batch touches {unique.size} unique rows > capacity "
                f"{self.capacity}; raise capacity (the device holds "
                "capacity*dim)")
        padded = np.zeros(self.capacity, np.int32)
        padded[:unique.size] = unique
        rows = self.opt.get_rows(padded, self.dim)
        inv = torch.from_numpy(inverse.reshape(ids.shape).astype(np.int64))
        return HostEmbedBatch(rows=self._to_device(rows),
                              inverse=inv.to(self.device),
                              unique=padded, count=int(unique.size))

    @staticmethod
    def lookup(rows: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
        """The device-side lookup; the gradient of ``rows`` is the merged
        SelectedRows gradient."""
        return F.embedding(inverse, rows)

    def apply_grad(self, batch: HostEmbedBatch,
                   grad_rows: torch.Tensor) -> None:
        """Apply the [capacity, D] gradient to the host master rows. The
        padded tail rows (no lookup reads them: their gradient is 0) are
        cut off, so an Adagrad accumulator never takes a step for a row no
        batch touched."""
        g = grad_rows.detach().to("cpu", torch.float32).numpy()
        self.opt.update_rows(batch.unique[:batch.count], g[:batch.count])

    # -- inspection / checkpoint -------------------------------------------
    def rows_host(self, ids: np.ndarray) -> np.ndarray:
        return self.opt.get_rows(np.asarray(ids, np.int32), self.dim)

    def serialize(self) -> bytes:
        return self.opt.serialize()

    def deserialize(self, blob: bytes) -> None:
        self.opt.deserialize(blob)


class HostEmbedPrefetcher:
    """Overlap of the host gather and the copy to the device with the
    device work, exact::

        pf = HostEmbedPrefetcher(table, ids_iterator)
        while (batch := pf.next()) is not None:
            grad_rows = device_step(batch.rows, batch.inverse, ...)
            pf.commit(batch, grad_rows)     # update + patch next prefetch

    ``next()`` starts the gather of the following batch on a worker
    thread. ``commit`` waits for that gather, applies the sparse update,
    then gathers again the rows of the pending batch the update touched
    and writes them over its rows: the pending batch holds the
    post-update table."""

    def __init__(self, table: HostEmbeddingTable, ids_iter: Iterator):
        self.table = table
        self._ids_iter = iter(ids_iter)
        self._pending: Optional[Tuple[list, threading.Event]] = None
        self._kick()

    def _kick(self):
        try:
            ids = next(self._ids_iter)
        except StopIteration:
            self._pending = None
            return
        done = threading.Event()
        holder = [None, None]                     # batch, exception

        def work():
            try:
                holder[0] = self.table.prefetch(ids)
            except BaseException as e:            # surfaced in next()
                holder[1] = e
            done.set()

        threading.Thread(target=work, daemon=True).start()
        self._pending = (holder, done)

    def next(self) -> Optional[HostEmbedBatch]:
        if self._pending is None:
            return None
        holder, done = self._pending
        done.wait()
        if holder[1] is not None:
            raise holder[1]
        batch = holder[0]
        self._kick()                              # overlap the next gather
        return batch

    def commit(self, batch: HostEmbedBatch, grad_rows: torch.Tensor) -> None:
        pend = self._pending
        if pend is not None:
            # the gather must finish before the update writes the table:
            # both release the GIL, so they would race on shared rows
            pend[1].wait()
        self.table.apply_grad(batch, grad_rows)
        if pend is None:
            return
        holder, _ = pend
        if holder[1] is not None:                 # next() raises it
            return
        nxt: HostEmbedBatch = holder[0]
        touched = np.intersect1d(batch.unique[:batch.count],
                                 nxt.unique[:nxt.count])
        if touched.size:
            pos = np.searchsorted(nxt.unique[:nxt.count], touched)
            fresh = self.table.opt.get_rows(touched, self.table.dim)
            nxt.rows[torch.from_numpy(pos).to(nxt.rows.device)] = \
                self.table._to_device(fresh)
