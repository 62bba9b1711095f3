"""Input-type declarations (paddle.v2.data_type analog).

Maps the reference's canonical feature taxonomy (SURVEY.md §8.2:
dense_vector / integer_value / sparse_binary_vector / sparse_float_vector,
each optionally *_sequence) onto feeder slots (data/feeder.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..data.feeder import DenseSlot, IndexSlot, SeqSlot, SparseSlot


@dataclass
class InputType:
    slot: object
    is_seq: bool = False
    vocab: int = 0       # value range for integer types (embedding table size)


def dense_vector(dim: int) -> InputType:
    return InputType(DenseSlot(dim))


def integer_value(value_range: int) -> InputType:
    return InputType(IndexSlot(), vocab=value_range)


def integer_value_sequence(value_range: int) -> InputType:
    return InputType(SeqSlot(), is_seq=True, vocab=value_range)


def dense_vector_sequence(dim: int) -> InputType:
    return InputType(SeqSlot(elem_dim=dim), is_seq=True)


def sparse_binary_vector(dim: int) -> InputType:
    return InputType(SparseSlot(dim))


def sparse_float_vector(dim: int) -> InputType:
    return InputType(SparseSlot(dim, with_values=True))


def integer_value_sub_sequence(value_range: int) -> InputType:
    """2-level LoD id input (the reference's *_sub_sequence types feeding
    nested recurrent groups) -> NestedSeqBatch."""
    return InputType(SeqSlot(nested=True), is_seq=True, vocab=value_range)


def dense_vector_sub_sequence(dim: int) -> InputType:
    return InputType(SeqSlot(elem_dim=dim, nested=True), is_seq=True)
