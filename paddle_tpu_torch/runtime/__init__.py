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
* :mod:`lease` — ``FileLease``/``LeaseKeeper``: master election over
  shared storage with fencing tokens; ``FencedFile`` snapshots
* :mod:`coord` — ``CoordServer``, ``NetworkLease``,
  ``NetworkFencedStore``: the same over TCP (``python -m
  paddle_tpu_torch.runtime.coord``)
* :mod:`arena` — ``HostArena``, the host buddy allocator
* :mod:`capi_host` — the Python side of the C inference API
  (``lib.load_capi()`` builds the library)
"""

from .arena import HostArena
from .coord import CoordServer, NetworkFencedStore, NetworkLease
from .host_embedding import (HostEmbedBatch, HostEmbeddingTable,
                             HostEmbedPrefetcher)
from .lease import FileLease, LeaseKeeper
from .lib import load_library, native_available
from .master import TaskMaster
from .master_service import MasterClient, MasterServer, StaleMemberError
from .membership import (HeartbeatKeeper, MembershipClient,
                         MembershipService, autoscale_recommendation)
from .optimizer import HostOptimizer
from .recordio import RecordReader, RecordWriter

__all__ = ["load_library", "native_available", "TaskMaster",
           "FileLease", "LeaseKeeper",
           "CoordServer", "NetworkLease", "NetworkFencedStore",
           "MembershipService", "MembershipClient", "HeartbeatKeeper",
           "StaleMemberError", "autoscale_recommendation",
           "HostEmbeddingTable", "HostEmbedBatch", "HostEmbedPrefetcher",
           "RecordReader", "RecordWriter", "HostArena", "HostOptimizer",
           "MasterServer", "MasterClient"]
