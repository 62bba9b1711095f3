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
* :mod:`master_service` — ``MasterServer`` and its clients over the
  native RPC plane (JAX's frames)
* :mod:`membership` — ``MembershipService``, ``MembershipClient`` and
  ``HeartbeatKeeper``: heartbeat-leased, epoch-numbered membership

The arena, leases and the coordination service wait for ROADMAP A.8.
"""

from .host_embedding import (HostEmbedBatch, HostEmbeddingTable,
                             HostEmbedPrefetcher)
from .lib import load_library, native_available
from .master import TaskMaster
from .master_service import MasterClient, MasterServer, StaleMemberError
from .membership import (HeartbeatKeeper, MembershipClient,
                         MembershipService)
from .optimizer import HostOptimizer
from .recordio import RecordReader, RecordWriter

__all__ = ["load_library", "native_available", "TaskMaster",
           "RecordReader", "RecordWriter", "HostOptimizer",
           "HostEmbedBatch", "HostEmbeddingTable", "HostEmbedPrefetcher",
           "MasterServer", "MasterClient", "StaleMemberError",
           "MembershipService", "MembershipClient", "HeartbeatKeeper"]
