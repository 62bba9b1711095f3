"""Host runtime bindings — the counterpart of ``paddle_tpu/runtime``:
ctypes over the host library that :mod:`.lib` builds from ``native/``'s
sources into ``paddle_tpu_torch/_build/``.

* :mod:`master`   — ``TaskMaster``, the task-queue data master
* :mod:`recordio` — ``RecordWriter``/``RecordReader``, CRC-checked record
  chunk files
* :mod:`optimizer` — ``HostOptimizer``, the host library's optimizer with
  sparse row updates and serializable state
* :mod:`host_embedding` — ``HostEmbeddingTable``/``HostEmbedPrefetcher``,
  tables in host memory streamed to the device by touched rows

The arena, leases, the coordination and membership services and the
master RPC service wait for ROADMAP A.5 and A.8.
"""

from .host_embedding import (HostEmbedBatch, HostEmbeddingTable,
                             HostEmbedPrefetcher)
from .lib import load_library, native_available
from .master import TaskMaster
from .optimizer import HostOptimizer
from .recordio import RecordReader, RecordWriter

__all__ = ["load_library", "native_available", "TaskMaster",
           "RecordReader", "RecordWriter", "HostOptimizer",
           "HostEmbedBatch", "HostEmbeddingTable", "HostEmbedPrefetcher"]
