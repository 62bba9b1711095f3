from .lod import SeqBatch, bucket_length, pack_sequences, sequence_mask
from .place import default_device, resolve_device

__all__ = ["SeqBatch", "bucket_length", "default_device", "pack_sequences",
           "resolve_device", "sequence_mask"]
