"""Binary sample format — the proto DataProvider's DataFormat re-provision;
a copy of ``paddle_tpu/data/format.py`` (the same bytes).

Reference (SURVEY §8.2, proto/DataFormat.proto): a stream of
``DataHeader{repeated SlotDef}`` then ``DataSample``s, where
``SlotDef.SlotType`` ∈ {VECTOR_DENSE, VECTOR_SPARSE_NON_VALUE,
VECTOR_SPARSE_VALUE, INDEX, VAR_MDIM_DENSE, VAR_MDIM_INDEX, STRING}, with
sequence starts flagged per sample and nested sequences via SubseqSlot.
That slot taxonomy is the framework's canonical feature-type system (it
reappears in PyDataProvider2 input_types and LayerGradUtil's InputType) and
maps 1:1 onto :mod:`paddle_tpu_torch.data.feeder`'s slot classes
(``SUB_SEQ`` onto ``SeqSlot(nested=True)``).

This implementation keeps the header+samples stream shape with a compact
struct-based encoding (no protobuf dependency): little-endian, length-
prefixed. Files round-trip through :class:`DataWriter`/:class:`DataReader`;
``reader_creator`` adapts a file straight into the reader-decorator
pipeline (batch/shuffle/map) and DataFeeder.

Layout::

    magic  b"PTDF1\\n"
    header: u32 n_slots, then per slot: u8 type, u8 seq_flag, u32 dim
    samples: u32 record_len, then per slot the type-specific payload
    (samples for seq slots carry a u32 count prefix; nested slots a
     u32 sub-seq count then per-sub-seq u32 count + payloads)

Slot types (u8): 0 dense, 1 sparse-non-value, 2 sparse-value, 3 index,
4 string. seq_flag (u8): 0 none, 1 sequence, 2 nested (sub-sequences).
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, List, Sequence, Tuple

import numpy as np

MAGIC = b"PTDF1\n"

DENSE, SPARSE_NON_VALUE, SPARSE_VALUE, INDEX, STRING = range(5)
NO_SEQ, SEQ, SUB_SEQ = range(3)


class SlotDef:
    """One slot's schema (DataFormat.proto SlotDef)."""

    def __init__(self, slot_type: int, dim: int = 0, seq: int = NO_SEQ):
        self.type = slot_type
        self.dim = dim
        self.seq = seq

    def __eq__(self, other):
        if not isinstance(other, SlotDef):
            return NotImplemented
        return (self.type, self.dim, self.seq) == \
            (other.type, other.dim, other.seq)

    def __hash__(self):
        return hash((self.type, self.dim, self.seq))

    def __repr__(self):
        return f"SlotDef(type={self.type}, dim={self.dim}, seq={self.seq})"


def _pack_elem(slot: SlotDef, value, out: List[bytes]):
    if slot.type == DENSE:
        arr = np.asarray(value, np.float32).reshape(-1)
        if slot.dim and arr.size != slot.dim:
            raise ValueError(f"dense slot dim {slot.dim} got {arr.size}")
        out.append(struct.pack("<I", arr.size))
        out.append(arr.tobytes())
    elif slot.type == SPARSE_NON_VALUE:
        ids = np.asarray(value, np.int32).reshape(-1)
        if slot.dim and ids.size and int(ids.max()) >= slot.dim:
            raise ValueError(f"sparse id {int(ids.max())} >= dim {slot.dim}")
        out.append(struct.pack("<I", ids.size))
        out.append(ids.tobytes())
    elif slot.type == SPARSE_VALUE:
        ids = np.asarray([i for i, _ in value], np.int32)
        vals = np.asarray([v for _, v in value], np.float32)
        if slot.dim and ids.size and int(ids.max()) >= slot.dim:
            raise ValueError(f"sparse id {int(ids.max())} >= dim {slot.dim}")
        out.append(struct.pack("<I", ids.size))
        out.append(ids.tobytes())
        out.append(vals.tobytes())
    elif slot.type == INDEX:
        out.append(struct.pack("<i", int(value)))
    elif slot.type == STRING:
        raw = value.encode() if isinstance(value, str) else bytes(value)
        out.append(struct.pack("<I", len(raw)))
        out.append(raw)
    else:
        raise ValueError(f"unknown slot type {slot.type}")


def _need(buf, off, nbytes):
    """Bounds check: a corrupt count must fail loudly, not truncate."""
    if off + nbytes > len(buf):
        raise IOError("corrupt record (count exceeds record length)")


def _unpack_elem(slot: SlotDef, buf: memoryview, off: int) -> Tuple[Any, int]:
    if slot.type == DENSE:
        _need(buf, off, 4)
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        _need(buf, off, 4 * n)
        arr = np.frombuffer(buf, np.float32, n, off).copy()
        return arr, off + 4 * n
    if slot.type == SPARSE_NON_VALUE:
        _need(buf, off, 4)
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        _need(buf, off, 4 * n)
        ids = np.frombuffer(buf, np.int32, n, off).copy()
        return list(ids), off + 4 * n
    if slot.type == SPARSE_VALUE:
        _need(buf, off, 4)
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        _need(buf, off, 8 * n)
        ids = np.frombuffer(buf, np.int32, n, off)
        off += 4 * n
        vals = np.frombuffer(buf, np.float32, n, off)
        return list(zip((int(i) for i in ids), (float(v) for v in vals))), \
            off + 4 * n
    if slot.type == INDEX:
        _need(buf, off, 4)
        (v,) = struct.unpack_from("<i", buf, off)
        return int(v), off + 4
    if slot.type == STRING:
        _need(buf, off, 4)
        (n,) = struct.unpack_from("<I", buf, off)
        off += 4
        _need(buf, off, n)
        return bytes(buf[off:off + n]).decode(), off + n
    raise ValueError(f"unknown slot type {slot.type}")


class DataWriter:
    """Write a header + sample stream (ProtoDataProvider writer analog)."""

    def __init__(self, f: BinaryIO, slots: Sequence[SlotDef]):
        self.f = f
        self.slots = list(slots)
        f.write(MAGIC)
        f.write(struct.pack("<I", len(self.slots)))
        for s in self.slots:
            f.write(struct.pack("<BBI", s.type, s.seq, s.dim))

    def write(self, sample: Sequence[Any]):
        """One sample: a value per slot. Non-seq slots take a bare element;
        seq slots a list of elements; nested slots a list of lists."""
        if len(sample) != len(self.slots):
            raise ValueError(f"sample has {len(sample)} values for "
                             f"{len(self.slots)} slots")
        parts: List[bytes] = []
        for slot, value in zip(self.slots, sample):
            if slot.seq == NO_SEQ:
                _pack_elem(slot, value, parts)
            elif slot.seq == SEQ:
                parts.append(struct.pack("<I", len(value)))
                for el in value:
                    _pack_elem(slot, el, parts)
            else:
                parts.append(struct.pack("<I", len(value)))
                for sub in value:
                    parts.append(struct.pack("<I", len(sub)))
                    for el in sub:
                        _pack_elem(slot, el, parts)
        payload = b"".join(parts)
        self.f.write(struct.pack("<I", len(payload)))
        self.f.write(payload)


class DataReader:
    """Iterate samples from a header + stream file."""

    def __init__(self, f: BinaryIO):
        self.f = f
        if f.read(len(MAGIC)) != MAGIC:
            raise IOError("not a PTDF file (bad magic)")
        hdr = f.read(4)
        if len(hdr) < 4:
            raise IOError("truncated header")
        (n,) = struct.unpack("<I", hdr)
        self.slots = []
        for _ in range(n):
            raw = f.read(6)
            if len(raw) < 6:
                raise IOError("truncated header")
            t, seq, dim = struct.unpack("<BBI", raw)
            self.slots.append(SlotDef(t, dim, seq))

    def __iter__(self):
        while True:
            hdr = self.f.read(4)
            if len(hdr) < 4:
                return
            (rec_len,) = struct.unpack("<I", hdr)
            payload = self.f.read(rec_len)
            if len(payload) < rec_len:
                raise IOError("truncated record")
            yield self._decode(memoryview(payload))

    @staticmethod
    def _read_count(buf: memoryview, off: int) -> int:
        """Bounds-checked SEQ/SUB_SEQ count prefix: corruption surfaces as
        the documented IOError, and an absurd count (larger than the record
        could possibly hold at 1 byte/element) fails before looping."""
        _need(buf, off, 4)
        (n,) = struct.unpack_from("<I", buf, off)
        if n > len(buf):
            raise IOError("corrupt record (count exceeds record length)")
        return n

    def _decode(self, buf: memoryview):
        off = 0
        sample = []
        for slot in self.slots:
            if slot.seq == NO_SEQ:
                v, off = _unpack_elem(slot, buf, off)
            elif slot.seq == SEQ:
                n = self._read_count(buf, off)
                off += 4
                v = []
                for _ in range(n):
                    el, off = _unpack_elem(slot, buf, off)
                    v.append(el)
            else:
                ns = self._read_count(buf, off)
                off += 4
                v = []
                for _ in range(ns):
                    n = self._read_count(buf, off)
                    off += 4
                    sub = []
                    for _ in range(n):
                        el, off = _unpack_elem(slot, buf, off)
                        sub.append(el)
                    v.append(sub)
            sample.append(v)
        return tuple(sample)


def reader_creator(path: str):
    """A reader() over a PTDF file — plugs into batch/shuffle/DataFeeder
    like any decorator-pipeline reader (ProtoDataProvider's role)."""
    def reader():
        with open(path, "rb") as f:
            yield from DataReader(f)
    return reader
