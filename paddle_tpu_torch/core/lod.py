"""Variable-length (LoD) sequence batches — the counterpart of
``paddle_tpu/core/lod.py``.

A ragged minibatch is padded-dense plus lengths: ``data`` [B, T, ...]
padded along time and ``lengths`` [B] int. Every recurrent step is masked
(``sequence_mask``), so padding costs work but never changes a result.
``bucket_length`` bounds the set of padded shapes (serving pads prompts
to a bucket; ``pack_sequences`` pads a batch to one).

Nesting takes one more padded axis a level: ``NestedSeqBatch`` holds
sequences of sub-sequences ([B, S, T, ...] + sub-sequence and sequence
lengths) and ``LoDBatch`` any depth, with lossless conversion to and
from the reference's offset-vector LoD. Every packer pads on the host in
numpy and copies each array once to ``device`` (default: the card).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .place import DeviceLike, require_device, resolve_device


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
                                            1024),
                  overflow: str = "exact") -> int:
    """Round a max sequence length up to the first bucket that holds it
    (``buckets`` ascending). Past the largest bucket, ``overflow="exact"``
    gives ``n`` itself and ``"pow2"`` the next power of two (the feeder's
    ``next_bucket``)."""
    for b in buckets:
        if n <= b:
            return int(b)
    if overflow == "pow2":
        p = 1
        while p < n:
            p <<= 1
        return p
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


def lod_from_lengths(lengths: Sequence[int]) -> Tuple[int, ...]:
    """Offsets vector from lengths — same shape as LoD level offsets
    (framework/lod_tensor.h:57)."""
    off = [0]
    for n in lengths:
        off.append(off[-1] + int(n))
    return tuple(off)


def lengths_from_lod(offsets: Sequence[int]) -> Tuple[int, ...]:
    return tuple(int(offsets[i + 1] - offsets[i])
                 for i in range(len(offsets) - 1))


# -- nested sequences (2-level LoD) -------------------------------------------

@dataclass
class NestedSeqBatch:
    """A padded batch of sequences of sub-sequences.

    * ``data``:        [B, S, T, ...] — S = max sub-sequences per example,
                       T = max sub-sequence length
    * ``sub_lengths``: [B, S] int32 — valid length of each sub-sequence
                       (0 for padding sub-sequences)
    * ``seq_lengths``: [B] int32 — number of valid sub-sequences per example

    After a per-sub-sequence reduction (pool, last step, inner RNN over
    ``inner_flat()``), ``outer`` lifts the [B*S, ...] result to a
    ``SeqBatch`` over the sub-sequence axis.
    """

    data: torch.Tensor
    sub_lengths: torch.Tensor
    seq_lengths: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def max_subseqs(self) -> int:
        return self.data.shape[1]

    @property
    def max_sublen(self) -> int:
        return self.data.shape[2]

    def inner_mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, S, T] validity of each timestep."""
        pos = torch.arange(self.max_sublen, device=self.sub_lengths.device)
        return (pos < self.sub_lengths[:, :, None]).to(dtype)

    def outer_mask(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """[B, S] validity of each sub-sequence."""
        return sequence_mask(self.seq_lengths, self.max_subseqs, dtype)

    def inner_flat(self) -> SeqBatch:
        """Sub-sequences as a flat batch [B*S, T, ...]: the input of any
        single-level sequence op. Padding sub-sequences ride along with
        length 0."""
        d = self.data.reshape((self.batch_size * self.max_subseqs,)
                              + tuple(self.data.shape[2:]))
        return SeqBatch(d, self.sub_lengths.reshape(-1))

    def outer(self, per_subseq: torch.Tensor) -> SeqBatch:
        """Per-sub-sequence values [B*S, ...] (from an op over
        ``inner_flat()``) as the outer sequence [B, S, ...] +
        seq_lengths."""
        return SeqBatch(
            per_subseq.reshape((self.batch_size, self.max_subseqs)
                               + tuple(per_subseq.shape[1:])),
            self.seq_lengths)


def pack_nested_sequences(nested, max_subseqs: Optional[int] = None,
                          max_sublen: Optional[int] = None, pad_value=0,
                          bucket: bool = True,
                          device: DeviceLike = None) -> NestedSeqBatch:
    """A list (batch) of lists (sub-sequences) of [len, ...] arrays -> a
    ``NestedSeqBatch`` on ``device`` (default: the card). Without
    ``max_subseqs``/``max_sublen`` the sub-sequence axis pads to a bucket
    of (2, 4, ..., 64) and time to ``bucket_length`` (``bucket=False``: to
    the largest themselves)."""
    if not nested:
        raise ValueError("pack_nested_sequences: empty batch")
    nested = [[np.asarray(s) for s in sample] for sample in nested]
    B = len(nested)
    S = max(1, max(len(sample) for sample in nested))
    T = max(1, max((s.shape[0] for sample in nested for s in sample),
                   default=1))
    if max_subseqs is not None:
        S = max_subseqs
    elif bucket:
        S = bucket_length(S, buckets=(2, 4, 8, 16, 32, 64))
    if max_sublen is not None:
        T = max_sublen
    elif bucket:
        T = bucket_length(T)
    # feature shape and dtype from the first non-empty sub-sequence
    first = next((s for sample in nested for s in sample if s.shape[0] > 0),
                 None)
    if first is None:
        first = next((s for sample in nested for s in sample), None)
    if first is None:
        raise ValueError("pack_nested_sequences: no sub-sequences in batch")
    data = np.full((B, S, T) + first.shape[1:], pad_value, dtype=first.dtype)
    sub_lengths = np.zeros((B, S), np.int32)
    seq_lengths = np.zeros((B,), np.int32)
    for b, sample in enumerate(nested):
        seq_lengths[b] = min(len(sample), S)
        for s, sub in enumerate(sample[:S]):
            n = min(sub.shape[0], T)
            if n > 0:
                data[b, s, :n] = sub[:n]
            sub_lengths[b, s] = n
    dev = require_device(device)
    return NestedSeqBatch(torch.as_tensor(data, device=dev),
                          torch.as_tensor(sub_lengths, device=dev),
                          torch.as_tensor(seq_lengths, device=dev))


# -- N-level LoD --------------------------------------------------------------

@dataclass
class LoDBatch:
    """An N-level ragged batch, padded dense — the general form of the
    reference's LoDTensor (framework/lod_tensor.h:57,82).

    * ``data``: [B, S1, S2, ..., S_{L-1}, T, *feat] — one axis per nesting
      level; the innermost ragged axis is time.
    * ``level_lengths``: tuple of L int32 tensors; ``level_lengths[i]`` has
      shape ``data.shape[:i+1]`` and counts the valid entries along axis
      ``i+1`` (sub-sequences for i < L-1, timesteps for i = L-1). Padding
      entries carry length 0.

    Level 0 is the outermost, as in the reference's LoD.
    """

    data: torch.Tensor
    level_lengths: Tuple[torch.Tensor, ...]

    @property
    def nlevels(self) -> int:
        return len(self.level_lengths)

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    def mask(self, level: int = -1,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Validity of entries along ragged axis ``level``: shape
        ``data.shape[:level+2]``."""
        level = range(self.nlevels)[level]
        lens = self.level_lengths[level]
        pos = torch.arange(self.data.shape[level + 1], device=lens.device)
        return (pos < lens[..., None]).to(dtype)

    def innermost_flat(self) -> SeqBatch:
        """Every outer ragged axis collapsed: [prod(B..S_{L-1}), T, *feat]
        + the innermost lengths, the input of any single-level sequence
        op. Padding sequences ride along with length 0."""
        lead = int(np.prod(self.data.shape[:self.nlevels]))
        d = self.data.reshape((lead,) + tuple(self.data.shape[self.nlevels:]))
        return SeqBatch(d, self.level_lengths[-1].reshape(-1))

    def lift(self, per_seq: torch.Tensor) -> "LoDBatch":
        """Per-innermost-sequence values [prod(...), *feat] (from an op over
        ``innermost_flat()``) one level up: an (L-1)-level LoDBatch whose
        time axis is the old sub-sequence axis."""
        if self.nlevels < 2:
            raise ValueError("lift() needs >= 2 levels; innermost_flat() of "
                             "a 1-level batch is already a SeqBatch")
        shape = tuple(self.data.shape[:self.nlevels]) \
            + tuple(per_seq.shape[1:])
        return LoDBatch(per_seq.reshape(shape), self.level_lengths[:-1])

    def as_seq_batch(self) -> SeqBatch:
        if self.nlevels != 1:
            raise ValueError(f"{self.nlevels}-level batch is not a SeqBatch")
        return SeqBatch(self.data, self.level_lengths[0])

    def as_nested(self) -> NestedSeqBatch:
        if self.nlevels != 2:
            raise ValueError(f"{self.nlevels}-level batch is not a "
                             "NestedSeqBatch")
        return NestedSeqBatch(self.data, self.level_lengths[1],
                              self.level_lengths[0])


def pack_lod(nested, levels: int, pad_value=0,
             device: DeviceLike = None) -> LoDBatch:
    """Depth-``levels`` nested python lists of [len, *feat] arrays -> a
    ``LoDBatch`` on ``device`` (default: the card). ``levels=1`` expects
    ``[arr, ...]``, ``levels=2`` ``[[arr, ...], ...]`` etc."""
    if levels < 1:
        raise ValueError("levels must be >= 1")
    if not nested:
        raise ValueError("pack_lod: empty batch")

    def _leaves(node, depth):
        if depth == levels:
            yield np.asarray(node)
        else:
            for child in node:
                yield from _leaves(child, depth + 1)

    leaves = [a for sample in nested for a in _leaves(sample, 1)]
    first = next((a for a in leaves if a.shape[0] > 0),
                 leaves[0] if leaves else None)
    if first is None:
        raise ValueError("pack_lod: no sequences in batch")

    # axis sizes: max fan-out per depth (axis 0 = batch, axis L = time)
    sizes = [len(nested)] + [1] * levels

    def _measure(node, depth):
        if depth == levels:
            sizes[levels] = max(sizes[levels], int(np.asarray(node).shape[0]))
        else:
            sizes[depth] = max(sizes[depth], len(node))
            for child in node:
                _measure(child, depth + 1)

    for sample in nested:
        _measure(sample, 1)

    data = np.full(tuple(sizes) + first.shape[1:], pad_value,
                   dtype=first.dtype)
    lens = [np.zeros(tuple(sizes[:i + 1]), np.int32) for i in range(levels)]

    def _fill(node, depth, idx):
        if depth == levels:
            arr = np.asarray(node)
            n = int(arr.shape[0])
            lens[levels - 1][idx] = n
            if n:
                data[idx + (slice(0, n),)] = arr
        else:
            lens[depth - 1][idx] = len(node)
            for j, child in enumerate(node):
                _fill(child, depth + 1, idx + (j,))

    for b, sample in enumerate(nested):
        _fill(sample, 1, (b,))
    dev = require_device(device)
    return LoDBatch(torch.as_tensor(data, device=dev),
                    tuple(torch.as_tensor(l, device=dev) for l in lens))


def unpack_lod(batch: LoDBatch):
    """Inverse of :func:`pack_lod`: a ``LoDBatch`` -> nested python lists of
    numpy [len, *feat] arrays on the host, padding stripped. Round-trip
    exact."""
    data = batch.data.cpu().numpy()
    lens = [l.cpu().numpy() for l in batch.level_lengths]
    L = batch.nlevels

    def _build(depth, idx):
        if depth == L:
            return data[idx][: int(lens[L - 1][idx])]
        return [_build(depth + 1, idx + (j,))
                for j in range(int(lens[depth - 1][idx]))]

    return [_build(1, (b,)) for b in range(batch.batch_size)]


def lod_batch_from_offsets(flat: np.ndarray, lod,
                           device: DeviceLike = None) -> LoDBatch:
    """The reference's LoDTensor form -> a ``LoDBatch`` on ``device``:
    ``flat`` is the row-major concatenation of innermost sequences and
    ``lod`` the offset levels (level k's offsets index level k+1's
    entries; the last level's offsets index rows of ``flat``)."""
    flat = np.asarray(flat)
    lod = [list(map(int, level)) for level in lod]
    L = len(lod)
    if L == 0:
        raise ValueError("lod_batch_from_offsets: need >= 1 LoD level")
    # the offset chain must hold before building: level k's last offset
    # covers exactly level k+1's entries (rows of ``flat`` for the last
    # level), or numpy slicing would clamp
    for k, level in enumerate(lod):
        if not level or level[0] != 0:
            raise ValueError(f"lod_batch_from_offsets: level {k} offsets "
                             f"must start at 0, got {level[:1]}")
        if any(level[j] > level[j + 1] for j in range(len(level) - 1)):
            raise ValueError(f"lod_batch_from_offsets: level {k} offsets "
                             "must be non-decreasing")
        extent = (flat.shape[0] if k == L - 1 else len(lod[k + 1]) - 1)
        if level[-1] != extent:
            what = "rows of flat" if k == L - 1 else f"level {k + 1} entries"
            raise ValueError(
                f"lod_batch_from_offsets: level {k} covers {level[-1]} "
                f"entries but there are {extent} {what}")

    def _build(level, j):
        lo, hi = lod[level][j], lod[level][j + 1]
        if level == L - 1:
            return flat[lo:hi]
        return [_build(level + 1, t) for t in range(lo, hi)]

    nested = [_build(0, i) for i in range(len(lod[0]) - 1)]
    return pack_lod(nested, L, device=device)


def lod_batch_to_offsets(batch: LoDBatch):
    """A ``LoDBatch`` -> (flat rows, offset levels) on the host: the
    reference's LoDTensor representation (lod_tensor.h:82)."""
    nested = unpack_lod(batch)
    L = batch.nlevels
    lod = [[0] for _ in range(L)]
    rows = []

    def _walk(node, depth):
        if depth == L:
            rows.append(np.asarray(node))
            lod[L - 1].append(lod[L - 1][-1] + node.shape[0])
        else:
            lod[depth - 1].append(lod[depth - 1][-1] + len(node))
            for child in node:
                _walk(child, depth + 1)

    for sample in nested:
        _walk(sample, 1)
    feat = tuple(batch.data.shape[batch.nlevels + 1:])
    flat = (np.concatenate(rows, axis=0) if rows
            else np.zeros((0,) + feat, batch.data.cpu().numpy().dtype))
    return flat, [tuple(level) for level in lod]
