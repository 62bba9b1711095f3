"""Joining the job — the counterpart of ``paddle_tpu/parallel/multihost.py``.

Every process runs the same SPMD program; :func:`initialize` joins the
``torch.distributed`` world from the launcher's environment
(``PADDLE_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}``, as JAX's reads
it): the coordinator's ``host:port`` becomes the TCP store of
``init_process_group``. One process is one rank with one device, so
JAX's process and device counts are both the world size here.
"""

from __future__ import annotations

import os
import signal
import sys
from typing import Callable, List, Optional

import numpy as np
import torch

from .mesh import Mesh, make_mesh
from .sharding import NamedSharding, P, device_put, from_local, tree_map

# Exit code a worker uses for clean job teardown (peer failure): distinct
# from crash codes so the launcher can tell "I was torn down" from "I
# failed" (doc/design/cluster_train/README.md: workers hold no durable
# state, so teardown is checkpoint-then-exit and recovery a fresh launch).
TEARDOWN_EXIT_CODE = 17

_teardown_hooks: List[Callable[[], None]] = []


def on_job_teardown(fn: Callable[[], None]) -> None:
    """Register a callback run when the launcher tears the job down after a
    peer failure (SIGTERM): write a final checkpoint marker, say."""
    _teardown_hooks.append(fn)


def _teardown_handler(signum, frame):  # noqa: ARG001 - signal signature
    print("paddle_tpu_torch.multihost: job teardown (peer failure or "
          "operator stop) — running teardown hooks, then exiting. Restart "
          "from the latest checkpoint.", file=sys.stderr)
    for fn in _teardown_hooks:
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - teardown must not cascade
            print(f"paddle_tpu_torch.multihost: teardown hook failed: {e}",
                  file=sys.stderr)
    sys.stderr.flush()
    # _exit, not SystemExit: the main thread may be inside a blocked
    # collective; raising would be swallowed or deadlock in native code.
    os._exit(TEARDOWN_EXIT_CODE)


def _dist():
    import torch.distributed as dist
    return dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> dict:
    """Join the job's world (``init_process_group`` over a TCP store at
    the coordinator, ``host:port``). The arguments fall back to
    ``PADDLE_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}``; with none of
    them (and no world yet) it is a no-op, one process alone. Installs
    the SIGTERM teardown. ``backend``: ``"nccl"`` when every rank has a
    card of its own, else ``"gloo"`` (the default without a card).
    Returns JAX's summary keys."""
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "PADDLE_TPU_COORDINATOR")
    if num_processes is None and "PADDLE_TPU_NUM_PROCESSES" in env:
        num_processes = int(env["PADDLE_TPU_NUM_PROCESSES"])
    if process_id is None and "PADDLE_TPU_PROCESS_ID" in env:
        process_id = int(env["PADDLE_TPU_PROCESS_ID"])
    dist = _dist()
    if coordinator_address and not dist.is_initialized():
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator needs num_processes "
                             "and process_id (PADDLE_TPU_NUM_PROCESSES, "
                             "PADDLE_TPU_PROCESS_ID)")
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
        # the launcher tears a failed job down with SIGTERM-then-SIGKILL;
        # give every worker the clean-exit path
        signal.signal(signal.SIGTERM, _teardown_handler)
    n = process_count()
    return {"process_index": process_index(), "process_count": n,
            "local_devices": 1, "global_devices": n}


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(**axes: int) -> Mesh:
    """Mesh over every rank of the job (every process builds the same)."""
    return make_mesh(**axes)


def process_batch_slice(global_batch_size: int) -> slice:
    """This process's row range of the global batch."""
    n = process_count()
    per = global_batch_size // n
    i = process_index()
    return slice(i * per, (i + 1) * per)


def make_global_array(local_rows, mesh: Mesh, axis: str = "data"):
    """A DTensor sharded ``P(axis)`` from each process's own rows: the
    rows are this rank's block of dim 0, the global batch their
    concatenation over ``axis`` (ranks that share an ``axis`` coordinate
    pass the same rows)."""
    rows = torch.as_tensor(np.asarray(local_rows)).to(mesh.device)
    n = mesh.shape.get(axis, 1)
    spec = P(axis, *([None] * (rows.dim() - 1))) if axis in mesh.shape \
        else P()
    return from_local(rows, mesh, spec,
                      (rows.shape[0] * n,) + tuple(rows.shape[1:]))


def make_global_batch(mesh: Mesh, batch, axis: str = "data"):
    """Each process's rows of the global batch (``process_batch_slice``)
    as DTensors sharded ``P(axis)`` — the multi-process counterpart of
    ``DataParallel.shard_batch``."""
    return tree_map(lambda x: make_global_array(x, mesh, axis), batch)


def replicate_from_host(mesh: Mesh, tree):
    """Place identical host data (initial params, say) replicated over the
    mesh — every process passes the same values (SPMD)."""
    return tree_map(lambda x: device_put(np.asarray(x),
                                         NamedSharding(mesh, P())), tree)
