"""Data layer: readers, decorators, datasets, feeder, prefetch, files — the
counterpart of ``paddle_tpu/data``: the reader protocol and decorators,
``batch``, the synthetic dataset zoo, ``DataFeeder`` and the
``DoubleBuffer`` prefetch thread; the binary DataFormat stream
(``format``), the real-format parsers (``parsers``), PyDataProvider2's
``@provider`` (``provider``), the numpy image transforms (``image``) and
the recordio chunk files with the fault-tolerant ``cloud_reader``
(``chunks``)."""

from . import dataset, format, parsers
from .feeder import (BucketSpec, DataFeeder, DenseSlot, IndexSlot, SeqSlot,
                     SparseSlot, next_bucket, pad_to_bucket, to_lod_batch)
from .prefetch import DoubleBuffer
from .provider import CacheType, provider
from .reader import (batch, buffered, cache, chain, compose, firstn,
                     map_readers, mix, shuffle, xmap_readers)

__all__ = ["BucketSpec", "CacheType", "DataFeeder", "DenseSlot",
           "DoubleBuffer", "IndexSlot", "SeqSlot", "SparseSlot", "batch",
           "buffered", "cache", "chain", "compose", "dataset", "firstn",
           "format", "map_readers", "mix", "next_bucket", "pad_to_bucket",
           "parsers", "provider", "shuffle", "to_lod_batch",
           "xmap_readers"]
