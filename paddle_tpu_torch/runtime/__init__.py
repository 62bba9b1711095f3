"""Host runtime bindings — the counterpart of ``paddle_tpu/runtime``:
ctypes over the host library that :mod:`.lib` builds from ``native/``'s
sources into ``paddle_tpu_torch/_build/``.

* :mod:`master`   — ``TaskMaster``, the task-queue data master
* :mod:`recordio` — ``RecordWriter``/``RecordReader``, CRC-checked record
  chunk files

The arena, the host optimizer, leases, the coordination and membership
services and the master RPC service wait for ROADMAP A.5 and A.8.
"""

from .lib import load_library, native_available
from .master import TaskMaster
from .recordio import RecordReader, RecordWriter

__all__ = ["load_library", "native_available", "TaskMaster",
           "RecordReader", "RecordWriter"]
