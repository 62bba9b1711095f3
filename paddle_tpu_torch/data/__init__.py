"""Data layer: readers, decorators, datasets, feeder, prefetch — the
counterpart of ``paddle_tpu/data`` (the reader protocol and decorators,
``batch``, the synthetic dataset zoo, ``DataFeeder`` and the
``DoubleBuffer`` prefetch thread). ``format``, ``parsers``, ``provider``,
``image`` and ``chunks`` wait for ROADMAP A.3b."""

from . import dataset
from .feeder import (BucketSpec, DataFeeder, DenseSlot, IndexSlot, SeqSlot,
                     SparseSlot, next_bucket, pad_to_bucket, to_lod_batch)
from .prefetch import DoubleBuffer
from .reader import (batch, buffered, cache, chain, compose, firstn,
                     map_readers, mix, shuffle, xmap_readers)

__all__ = ["BucketSpec", "DataFeeder", "DenseSlot", "DoubleBuffer",
           "IndexSlot", "SeqSlot", "SparseSlot", "batch", "buffered",
           "cache", "chain", "compose", "dataset", "firstn", "map_readers",
           "mix", "next_bucket", "pad_to_bucket", "shuffle", "to_lod_batch",
           "xmap_readers"]
