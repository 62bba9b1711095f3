"""save/load persistables and the inference bundle — the counterpart of
``paddle_tpu/fluid/io.py``. The files are JAX's byte for byte: the
persistables go through the port's ``trainer/checkpoint.py`` tar (the
CRC-checked format JAX's ``to_tar`` writes) and the bundle's program is
JAX's ``model.json``, so a bundle either package writes loads in the
other. On a mesh executor the persistables are gathered to their global
values before they are written (the file is the one a single device
writes, written by the mesh's first rank), and a restore re-places them
onto the executor's *current* mesh by its layout."""

from __future__ import annotations

import json
import os
from typing import Optional

from ..trainer.checkpoint import from_tar, to_tar
from .executor import Executor
from .framework import Program, default_main_program


def _persistable_names(program: Program):
    return [name for name, v in program.global_block().vars.items()
            if v.persistable]


def _global(v):
    """A scope value as a plain tensor: a DTensor's global value."""
    from ..parallel.sharding import to_global
    return to_global(v)


def save_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None):
    program = main_program or default_main_program()
    scope = executor.scope
    os.makedirs(dirname, exist_ok=True)
    tree = {n: _global(scope.get(n)) for n in _persistable_names(program)
            if scope.has(n)}
    mesh = executor.mesh
    if mesh is None or mesh.rank == int(mesh.devices.flat[0]):
        with open(os.path.join(dirname, "persistables.tar"), "wb") as f:
            to_tar(f, tree)
    if mesh is not None:
        # every rank leaves once the mesh's first rank has written the
        # file (a load on any rank reads it)
        import torch
        from ..parallel import collectives
        with mesh:
            collectives.all_reduce(torch.zeros((), device=mesh.device),
                                   mesh.axis_names)


def _restore(executor: Executor, tree, program: Optional[Program] = None
             ) -> None:
    """Place loaded arrays into the scope, on the executor's device —
    sharded per the executor's layout when it has a mesh (a restore
    re-places onto the CURRENT mesh: specs re-resolve against it, so a
    file saved on one mesh shape loads onto another)."""
    block = program.global_block() if program is not None else None
    for name, arr in tree.items():
        if executor.mesh is not None and block is not None \
                and name in block.vars:
            from ..parallel.sharding import device_put
            executor.scope.set(name, device_put(
                arr, executor._persist_sharding(block, name, arr)))
        else:
            executor.scope.set(name, arr)


def load_persistables(executor: Executor, dirname: str,
                      main_program: Optional[Program] = None):
    with open(os.path.join(dirname, "persistables.tar"), "rb") as f:
        _restore(executor, from_tar(f, device=executor.device),
                 main_program or default_main_program())


# -- merged inference model ----------------------------------------------------

def export_inference_model(dirname: str, feed_names, fetch_vars,
                           executor: Executor,
                           main_program: Optional[Program] = None):
    """Save a deployable model: the program pruned to the fetch targets
    (training and backward ops dropped) as JSON + the persistables tar."""
    program = main_program or default_main_program()
    fetch_names = [v.name if hasattr(v, "name") else str(v)
                   for v in fetch_vars]
    pruned = program.prune(fetch_names)
    os.makedirs(dirname, exist_ok=True)
    # recurrent ops keep their fused attr (unset: the whole-sequence
    # kernels on the card)
    meta = {"program": pruned.to_dict(),
            "feed_names": list(feed_names),
            "fetch_names": fetch_names}
    with open(os.path.join(dirname, "model.json"), "w") as f:
        json.dump(meta, f)
    scope = executor.scope
    tree = {n: _global(scope.get(n))
            for n, v in pruned.global_block().vars.items()
            if v.persistable and scope.has(n)}
    with open(os.path.join(dirname, "params.tar"), "wb") as f:
        to_tar(f, tree)


def load_inference_model(dirname: str, executor: Executor):
    """-> (program, feed_names, fetch_names); scope populated with params."""
    with open(os.path.join(dirname, "model.json")) as f:
        meta = json.load(f)
    program = Program.from_dict(meta["program"])
    with open(os.path.join(dirname, "params.tar"), "rb") as f:
        _restore(executor, from_tar(f, device=executor.device))
    return program, meta["feed_names"], meta["fetch_names"]
