"""DataFeeder: row tuples -> tensors on the card under the slot-type
taxonomy — the counterpart of ``paddle_tpu/data/feeder.py`` (the
reference's DataProviderConverter and v2 DataFeeder).

* ``DenseSlot``  -> float [B, dim]
* ``IndexSlot``  -> int32 [B]
* ``SeqSlot``    -> ``SeqBatch`` (padded [B, T (bucketed), ...] + lengths,
  through ``core.lod.pack_sequences``, bucketed as in JAX);
  ``SeqSlot(nested=True)`` -> ``NestedSeqBatch`` ([B, S, T] + sub- and
  sequence lengths, through ``core.lod.pack_nested_sequences``)
* ``SparseSlot`` -> padded COO a row: (ids [B, K], vals [B, K]) with K the
  bucketed largest count of ids

``DataFeeder(slots, device=None)`` puts its tensors on the card by
default. **Streams.** The feeder converts on the host and copies each
tensor with ``torch.as_tensor(array, device=...)`` on the calling
thread's current stream — the legacy default stream in the
``DoubleBuffer`` worker thread — as a synchronous copy from pageable
memory: the tensors are on the card when the feeder returns, so the
step that reads them needs no event, and the trainer's copy into its
graph's static buffers runs after it in stream order. The graphs capture
on a stream of their own that does not synchronize with the legacy
stream (``torch.cuda.Stream`` is non-blocking) under
``capture_error_mode="thread_local"``, so a copy the worker makes while
the main thread captures a new bucket's graph neither joins nor breaks
the capture.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.lod import (SeqBatch, bucket_length, pack_nested_sequences,
                        pack_sequences)
from ..core.place import DeviceLike, require_device


# -- shape bucketing -----------------------------------------------------------

def next_bucket(n: int, buckets: Sequence[int] = ()) -> int:
    """Smallest listed bucket >= n (``buckets`` ascending); beyond the
    largest (or with no list), the next power of two."""
    return bucket_length(n, tuple(buckets), overflow="pow2")


def pad_to_bucket(arr, axis: int, buckets: Sequence[int] = ()):
    """Zero-pad ``arr`` along ``axis`` up to :func:`next_bucket`; returns
    ``(padded, true_len)``. numpy arrays pad on the host, tensors where
    they are."""
    if not hasattr(arr, "shape"):
        arr = np.asarray(arr)
    n = int(arr.shape[axis])
    b = next_bucket(n, buckets)
    if b == n:
        return arr, n
    if isinstance(arr, np.ndarray):
        widths = [(0, 0)] * arr.ndim
        widths[axis] = (0, b - n)
        return np.pad(arr, widths), n
    shape = list(arr.shape)
    shape[axis] = b - n
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis), n


class BucketSpec:
    """Per-feed shape-bucketing policy: ``spec`` maps a feed name to its
    bucket boundaries (``{"words": (32, 64, 128)}``, or ``{"words":
    {"axis": 2, "buckets": (8, 16)}}``). ``"tuned"`` takes the measured
    ``bucket_grid`` winner (``tune.bucket_grid("prompt")``, validated by
    the consult), else the serving default grid (32, 64, 128, 256,
    512)."""

    def __init__(self, spec: Dict[str, Any]):
        self.spec: Dict[str, Tuple[Optional[int], Tuple[int, ...]]] = {}
        for name, v in dict(spec).items():
            axis: Optional[int] = None
            if isinstance(v, dict):
                axis = v.get("axis")
                buckets = v.get("buckets", ())
            else:
                buckets = v
            if buckets == "tuned":
                from .. import tune
                buckets = (tune.bucket_grid("prompt")
                           or (32, 64, 128, 256, 512))
            self.spec[name] = (axis, tuple(sorted(int(b) for b in buckets)))

    def names(self):
        return self.spec.keys()

    def pinned_axis(self, name: str) -> Optional[int]:
        """The axis the spec pins for ``name`` (None = caller infers)."""
        return self.spec[name][0]

    def pad(self, name: str, arr, default_axis: Optional[int] = None):
        """(padded, true_len) for one feed; see :func:`pad_to_bucket`."""
        axis, buckets = self.spec[name]
        if axis is None:
            axis = (default_axis if default_axis is not None
                    else (1 if getattr(arr, "ndim", 1) >= 2 else 0))
        return pad_to_bucket(arr, axis, buckets)


@dataclass
class DenseSlot:
    dim: int
    dtype: Any = np.float32


@dataclass
class IndexSlot:
    dtype: Any = np.int32


@dataclass
class SeqSlot:
    """A variable-length sequence of scalars (ids) or vectors: elem_dim
    None -> id sequence (int32), else vector sequence [len, elem_dim].
    nested=True takes a list of lists of elements and packs a
    ``NestedSeqBatch`` ([B, S, T] + sub- and sequence lengths)."""
    elem_dim: Optional[int] = None
    nested: bool = False
    dtype: Any = None

    @property
    def np_dtype(self):
        if self.dtype is not None:
            return self.dtype
        return np.int32 if self.elem_dim is None else np.float32


@dataclass
class SparseSlot:
    """Sparse row features: sample = list of ids or list of (id, value)."""
    dim: int
    with_values: bool = False


class DataFeeder:
    """feed(rows) -> tuple of tensors on ``device`` (default: the card;
    with no card the constructor raises), one per slot; ``rows`` is a
    list of sample tuples, sample[i] belonging to slots[i]."""

    def __init__(self, slots: Sequence[Any], device: DeviceLike = None):
        self.slots = list(slots)
        self.device = require_device(device)

    def __call__(self, rows: Sequence[Tuple]) -> Tuple:
        return self.feed(rows)

    def feed(self, rows: Sequence[Tuple]) -> Tuple:
        cols = list(zip(*rows))
        if len(cols) != len(self.slots):
            raise ValueError(f"sample width {len(cols)} != #slots "
                             f"{len(self.slots)}")
        return tuple(self._convert(slot, col)
                     for slot, col in zip(self.slots, cols))

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, device=self.device)

    def _convert(self, slot, col):
        if isinstance(slot, DenseSlot):
            return self._put(np.asarray(col, dtype=slot.dtype).reshape(
                len(col), slot.dim))
        if isinstance(slot, IndexSlot):
            return self._put(np.asarray(col, dtype=slot.dtype).reshape(
                len(col)))
        if isinstance(slot, SeqSlot):
            return self._convert_seq(slot, col)
        if isinstance(slot, SparseSlot):
            return self._convert_sparse(slot, col)
        raise TypeError(f"unknown slot {slot!r}")

    def _convert_seq(self, slot: SeqSlot, col):
        if slot.nested:
            nested = [[np.asarray(sub, dtype=slot.np_dtype) for sub in sample]
                      for sample in col]
            return pack_nested_sequences(nested, device=self.device)
        return pack_sequences([np.asarray(s, dtype=slot.np_dtype)
                               for s in col], device=self.device)

    def _convert_sparse(self, slot: SparseSlot, col):
        if slot.with_values:
            ids_list = [[int(i) for i, _ in s] for s in col]
            val_list = [[float(v) for _, v in s] for s in col]
        else:
            ids_list = [[int(i) for i in s] for s in col]
            val_list = [[1.0] * len(s) for s in col]
        k = bucket_length(max(1, max((len(s) for s in ids_list), default=1)),
                          buckets=(4, 8, 16, 32, 64, 128, 256))
        B = len(col)
        ids = np.zeros((B, k), np.int32)
        vals = np.zeros((B, k), np.float32)
        for r, (ii, vv) in enumerate(zip(ids_list, val_list)):
            n = min(len(ii), k)
            ids[r, :n] = ii[:n]
            vals[r, :n] = vv[:n]
        return self._put(ids), self._put(vals)


def to_lod_batch(seqs, max_len: Optional[int] = None,
                 device: DeviceLike = None) -> SeqBatch:
    """A list of sequences -> a ``SeqBatch`` on ``device`` (bucketed
    padding)."""
    return pack_sequences([np.asarray(s) for s in seqs], max_len=max_len,
                          device=require_device(device))
