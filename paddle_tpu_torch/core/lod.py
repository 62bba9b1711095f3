"""Variable-length (LoD) sequence batches — the counterpart of
``paddle_tpu/core/lod.py``.

A ragged minibatch is padded-dense plus lengths: ``data`` [B, T, ...]
padded along time and ``lengths`` [B] int. Every recurrent step is masked
(``sequence_mask``), so padding costs work but never changes a result.
``bucket_length`` bounds the set of padded shapes (serving pads prompts
to a bucket; ``pack_sequences`` pads a batch to one).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .place import DeviceLike, resolve_device


@dataclass
class SeqBatch:
    """A padded ragged batch: data [B, T, ...] + lengths [B]."""

    data: torch.Tensor
    lengths: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    def mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, T] 1 where a timestep is valid."""
        return sequence_mask(self.lengths, self.max_len, dtype)


def sequence_mask(lengths: torch.Tensor, max_len: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, T] validity mask from lengths: position t of sample b is valid
    when t < lengths[b]."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def bucket_length(n: int,
                  buckets: Sequence[int] = (8, 16, 32, 64, 128, 256, 512,
                                            1024)) -> int:
    """Round a max sequence length up to the first bucket that holds it
    (``buckets`` ascending); past the largest bucket, ``n`` itself."""
    for b in buckets:
        if n <= b:
            return int(b)
    return int(n)


def pack_sequences(seqs: Sequence[np.ndarray], max_len: Optional[int] = None,
                   pad_value=0, bucket: bool = True,
                   device: DeviceLike = None) -> SeqBatch:
    """A list of per-example [len, ...] arrays -> a padded ``SeqBatch`` on
    ``device`` (default: the card). Without ``max_len`` the batch pads to
    ``bucket_length`` of its longest sequence (``bucket=False``: to the
    longest itself); a sequence longer than ``max_len`` is cut and its
    length says so."""
    if not seqs:
        raise ValueError("pack_sequences: empty sequence list")
    seqs = [np.asarray(s) for s in seqs]
    lengths = np.array([s.shape[0] for s in seqs], dtype=np.int32)
    tmax = int(max_len if max_len is not None
               else max(1, lengths.max(initial=1)))
    if bucket and max_len is None:
        tmax = bucket_length(tmax)
    out = np.full((len(seqs), tmax) + seqs[0].shape[1:], pad_value,
                  dtype=seqs[0].dtype)
    for i, s in enumerate(seqs):
        n = min(s.shape[0], tmax)
        out[i, :n] = s[:n]
        lengths[i] = n
    dev = resolve_device(device)
    return SeqBatch(torch.as_tensor(out, device=dev),
                    torch.as_tensor(lengths, device=dev))
