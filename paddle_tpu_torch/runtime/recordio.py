"""CRC-checked record chunk files (native/recordio.cc) — the counterpart
of ``paddle_tpu/runtime/recordio.py``, the same files. The reader hands
out each record by copying its own bytes, where JAX's copies the whole
read buffer a record (ROADMAP C.3)."""

from __future__ import annotations

import ctypes
from typing import Iterator

from .lib import load_library


class RecordWriter:
    def __init__(self, path: str):
        self._lib = load_library()
        self._h = self._lib.ptr_writer_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")

    def write(self, payload: bytes):
        rc = self._lib.ptr_writer_write(self._h, payload, len(payload))
        if rc != 0:
            raise IOError("write failed")

    def close(self) -> int:
        if self._h:
            n = self._lib.ptr_writer_close(self._h)
            self._h = None
            return int(n)
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class RecordReader:
    def __init__(self, path: str, max_record: int = 1 << 20):
        self._lib = load_library()
        self._h = self._lib.ptr_reader_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path} (missing or bad magic)")
        self._buf = ctypes.create_string_buffer(max_record)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            n = self._lib.ptr_reader_next(self._h, self._buf, len(self._buf))
            if n == -1:
                return
            if n == -2:
                raise IOError("corrupt record (CRC mismatch or truncation)")
            if n > len(self._buf):
                self._buf = ctypes.create_string_buffer(n)
                continue
            # the record's n bytes only: ``self._buf.raw[:n]`` (JAX's
            # copy) reads the whole buffer, 1 MiB, for every record
            yield ctypes.string_at(self._buf, n)

    def close(self):
        if self._h:
            self._lib.ptr_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
