"""Host buddy-allocator arena — a copy of ``paddle_tpu/runtime/arena.py``
over the port's own build of ``native/buddy_allocator.cc`` (the host
library :mod:`.lib` compiles)."""

from __future__ import annotations

import ctypes
from typing import Tuple

from .lib import load_library

OOM = (1 << 64) - 1


class HostArena:
    """Power-of-two buddy allocator over a host staging arena; returns offsets
    into ``self.buffer`` (a bytearray the feeder writes batches into)."""

    def __init__(self, total: int = 1 << 24, min_block: int = 256):
        lib = load_library()
        self._lib = lib
        self._h = lib.pta_create(total, min_block)
        if not self._h:
            raise ValueError("total/min_block must be powers of two")
        self.buffer = bytearray(total)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pta_destroy(self._h)
            self._h = None

    def alloc(self, size: int) -> int:
        off = self._lib.pta_alloc(self._h, size)
        if off == OOM:
            raise MemoryError(f"arena OOM for {size} bytes")
        return int(off)

    def free(self, offset: int):
        if self._lib.pta_free(self._h, offset) != 0:
            raise ValueError(f"offset {offset} was not allocated")

    def stats(self) -> Tuple[int, int, int]:
        vals = [ctypes.c_uint64() for _ in range(3)]
        self._lib.pta_stats(self._h, *[ctypes.byref(v) for v in vals])
        return tuple(int(v.value) for v in vals)  # total, in_use, largest_free
