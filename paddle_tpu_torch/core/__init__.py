from .lod import (LoDBatch, NestedSeqBatch, SeqBatch, bucket_length,
                  lengths_from_lod, lod_batch_from_offsets,
                  lod_batch_to_offsets, lod_from_lengths, pack_lod,
                  pack_nested_sequences, pack_sequences, sequence_mask,
                  unpack_lod)
from .place import (CPUPlace, CUDAPlace, DeviceContext, Place,
                    default_device, default_place, resolve_device)

__all__ = ["LoDBatch", "NestedSeqBatch", "SeqBatch", "bucket_length",
           "default_device", "lengths_from_lod", "lod_batch_from_offsets",
           "lod_batch_to_offsets", "lod_from_lengths", "pack_lod",
           "pack_nested_sequences", "pack_sequences", "resolve_device",
           "sequence_mask", "unpack_lod",
           "Place", "CUDAPlace", "CPUPlace", "DeviceContext",
           "default_place"]
