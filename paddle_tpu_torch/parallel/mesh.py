"""Device-mesh construction — the counterpart of
``paddle_tpu/parallel/mesh.py``.

JAX is single-controller: one process holds every device of a
``jax.sharding.Mesh``. The port runs SPMD, one process per rank over
``torch.distributed``, and a mesh device is a rank: each rank computes
on one device (``cuda:<local rank>``, or the CPU when the caller asks,
as the tests do), and the world size plays the part of
``len(jax.devices())``. ``make_mesh`` resolves a :class:`MeshSpec`
exactly as JAX does and builds a ``torch.distributed.device_mesh.
DeviceMesh`` whose ``mesh_dim_names`` are the axis names; a collective
names an axis and gets that dimension's process group
(:meth:`Mesh.get_group`).

Every rank of the world calls ``make_mesh`` with the same arguments
(creating the axes' process groups is collective). A sub-mesh
(``make_mesh(data=2)`` on a world of 4) takes the first ranks, as JAX
takes ``devices[:n]``; a rank outside it gets a :class:`Mesh` with
``member == False``, on which a collective or a ``shard_map`` raises
(ROADMAP C.11).

Canonical axis names: ``data`` (DP), ``fsdp`` (parameter sharding),
``expert`` (EP), ``seq`` (sequence parallel), ``model``/``tp`` (tensor
parallel), ``pipe`` (pipeline stages).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.place import DeviceLike, require_device

# Axis ordering: innermost (fastest-varying over ranks) LAST, so that the
# most communication-heavy axis (model/tp/seq) joins neighbouring ranks
CANONICAL_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "model", "tp")


@dataclass
class MeshSpec:
    """Declarative mesh request: axis name -> size. Size -1 means 'the rest'."""

    axes: Dict[str, int] = field(default_factory=dict)

    def resolve(self, n_devices: int) -> Dict[str, int]:
        axes = {k: v for k, v in self.axes.items() if v != 1 or k == "data"}
        if not axes:
            axes = {"data": -1}
        wild = [k for k, v in axes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one -1 axis, got {wild}")
        known = int(np.prod([v for v in axes.values() if v != -1]))
        if wild:
            if n_devices % known:
                raise ValueError(f"{n_devices} devices not divisible by {known}")
            axes[wild[0]] = n_devices // known
        total = int(np.prod(list(axes.values())))
        if total > n_devices or n_devices % total:
            raise ValueError(f"mesh {axes} needs {total} devices, have {n_devices}")
        return axes


def _dist():
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the mesh needs a torch.distributed world: call "
            "parallel.multihost.initialize() (or init_process_group) on "
            "every rank first")
    return dist


def rank_device(device: DeviceLike = None) -> torch.device:
    """This rank's device: ``device`` when given, else
    ``cuda:<LOCAL_RANK>`` (``rank % device_count`` without it); with no
    card that raises, as every entry point of the port does."""
    if device is not None:
        return require_device(device)
    dev = require_device("cuda")
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else \
        _dist().get_rank() % torch.cuda.device_count()
    return torch.device("cuda", idx)


class Mesh:
    """A named mesh of ranks on one rank of the world.

    ``shape`` maps axis name -> size (in axis order), ``axis_names`` the
    names, ``devices`` the ranks as an array of that shape (JAX: the
    devices), ``device`` this rank's torch device, ``device_mesh`` the
    ``DeviceMesh`` (None on a rank outside a sub-mesh), ``backend`` the
    world's (``"gloo"`` or ``"nccl"``). ``with mesh:`` resolves the
    collectives' axis names in it for the scope, as JAX's mesh context."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 device: torch.device):
        from torch.distributed.device_mesh import DeviceMesh
        dist = _dist()
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = {a: int(n) for a, n in zip(axis_names, devices.shape)}
        self.device = device
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend()).lower()
        self.member = self.rank in devices.flat
        self._tokens = []
        # collective on the world: every rank builds every axis' groups
        self.device_mesh = DeviceMesh(device.type,
                                      torch.as_tensor(devices),
                                      mesh_dim_names=self.axis_names)
        if not self.member:
            self.device_mesh = None
        self._coord = (None if not self.member else
                       tuple(int(c) for c in np.argwhere(
                           devices == self.rank)[0]))

    def _require_member(self) -> None:
        if not self.member:
            raise RuntimeError(
                f"rank {self.rank} is outside this sub-mesh of ranks "
                f"{self.devices.flat[0]}..{self.devices.flat[-1]}: it takes "
                "no part in the mesh's collectives")

    def coordinate(self, axis: str) -> int:
        """This rank's index on ``axis`` (0 for an axis the mesh lacks)."""
        self._require_member()
        if axis not in self.shape:
            return 0
        return self._coord[self.axis_names.index(axis)]

    def get_group(self, axis: str):
        """The process group of this rank's slice along ``axis``."""
        self._require_member()
        if axis not in self.shape:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        return self.device_mesh.get_group(axis)

    def group_ranks(self, axis: str) -> Tuple[int, ...]:
        """The global ranks of this rank's slice along ``axis``, in axis
        order."""
        self._require_member()
        idx = list(self._coord)
        idx[self.axis_names.index(axis)] = slice(None)
        return tuple(int(r) for r in self.devices[tuple(idx)])

    def __enter__(self):
        self._tokens.append(_AXIS_MESH.set(_AXIS_MESH.get() + (self,)))
        return self

    def __exit__(self, *exc):
        _AXIS_MESH.reset(self._tokens.pop())

    def __repr__(self):
        return (f"Mesh({self.shape}, ranks={self.devices.flatten().tolist()}"
                f", device={self.device}, backend={self.backend})")


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[int]] = None, *,
              device: DeviceLike = None, **axes: int) -> Mesh:
    """Build a Mesh from a spec or kwargs: ``make_mesh(data=4, model=2)``.

    Axes are laid out in CANONICAL_ORDER so the model axis joins
    neighbouring ranks and pipe is the outermost dimension. ``devices``:
    the ranks to take (JAX: the devices; default every rank of the
    world); a sub-mesh takes the first ones. ``device``: this rank's
    device (:func:`rank_device`)."""
    dist = _dist()
    if spec is None:
        spec = MeshSpec(dict(axes))
    if devices is None:
        devices = range(dist.get_world_size())
    devices = [int(d) for d in devices]
    resolved = spec.resolve(len(devices))
    names = tuple(sorted(resolved, key=lambda a: CANONICAL_ORDER.index(a)
                         if a in CANONICAL_ORDER else len(CANONICAL_ORDER)))
    shape = tuple(resolved[a] for a in names)
    n = int(np.prod(shape))
    arr = np.array(devices[:n]).reshape(shape)   # a sub-mesh is allowed
    return Mesh(arr, names, rank_device(device))


def local_mesh(device: DeviceLike = None, **axes: int) -> Mesh:
    """Mesh over this host's ranks (single-host path: the world)."""
    return make_mesh(device=device, **axes)


def mesh_axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape.get(axis, 1)


# -- the ambient mesh ----------------------------------------------------------
# A ContextVar (not a module-global list) keeps the scope per thread/task,
# as JAX's: a prefetch or RPC thread must not inherit (or corrupt) another
# thread's ambient mesh.

_MESH_STACK: "contextvars.ContextVar[Tuple[Mesh, ...]]" = \
    contextvars.ContextVar("paddle_tpu_torch_mesh_stack", default=())
# the meshes the collectives resolve axis names in (use_mesh, ``with
# mesh:``, a shard_map body), innermost last
_AXIS_MESH: "contextvars.ContextVar[Tuple[Mesh, ...]]" = \
    contextvars.ContextVar("paddle_tpu_torch_axis_mesh", default=())


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the ambient mesh (``current_mesh``) for the scope;
    the collectives resolve axis names in it too::

        with pp.use_mesh(pp.make_mesh(data=2, fsdp=2)):
            trainer = Trainer(loss, opt, layout=pp.SpecLayout())
    """
    token = _MESH_STACK.set(_MESH_STACK.get() + (mesh,))
    try:
        with mesh:
            yield mesh
    finally:
        _MESH_STACK.reset(token)


def current_mesh() -> Optional[Mesh]:
    """The innermost :func:`use_mesh` mesh of this thread/task, or None."""
    stack = _MESH_STACK.get()
    return stack[-1] if stack else None


def find_axis_mesh(axis: str) -> Optional[Mesh]:
    """The innermost mesh in scope that has ``axis``, or None."""
    for mesh in reversed(_AXIS_MESH.get()):
        if axis in mesh.shape:
            return mesh
    return None


def axis_mesh(axis: str) -> Mesh:
    """The innermost mesh in scope that has ``axis`` (the collectives'
    name resolution); raises when none has."""
    mesh = find_axis_mesh(axis)
    if mesh is not None:
        return mesh
    raise NameError(f"unbound axis name {axis!r}: call collectives inside "
                    "shard_map, use_mesh(mesh) or `with mesh:`")
