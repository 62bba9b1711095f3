"""Sharding rules: map parameter paths and batch tensors to placements —
the counterpart of ``paddle_tpu/parallel/sharding.py``.

Placement is a pure function from a parameter's *path* to a
:class:`PartitionSpec` (``P``), the port's own class with JAX's
meaning: one entry a tensor dim, each ``None`` (replicated), a mesh axis
name, or a tuple of names (the dim split over both, the first the major
order). A placed value is a ``DTensor``: :func:`device_put` cuts this
rank's block of a global tensor (every rank passes the same one) and
wraps it with one placement a mesh dimension (``Shard(d)`` or
``Replicate()``; ``("fsdp", "tp")`` on one dim is two ``Shard(d)``).
No DTensor reaches a kernel: code that computes takes :func:`to_global`
(an all-gather through ``collectives``) or the local block.

The rules match paths in JAX's spelling: the port's block lists
(``blocks/0``) read as JAX's ``blocks_0``, so a rule table written for
the JAX package places the port's parameters the same way.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.pytree import flatten_path_tree as _flatten_with_paths
from ..core.pytree import tree_spec
from ..core.pytree import unflatten_path_tree as _unflatten_paths
from .mesh import Mesh


class PartitionSpec(tuple):
    """One entry a tensor dim: None, a mesh axis name, or a tuple of them
    (the port's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self):
        return "P(" + ", ".join(map(repr, self)) + ")"


P = PartitionSpec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _dims(mesh: Mesh, spec: P, ndim: int):
    """Per tensor dim: (axes, shard count, this rank's block index)."""
    entries = list(spec)[:ndim] + [None] * max(0, ndim - len(spec))
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the {ndim}-d "
                         "value")
    out = []
    for entry in entries:
        axes = _entry_axes(entry)
        count, idx = 1, 0
        for a in axes:
            if a not in mesh.shape:
                raise ValueError(f"spec {spec}: mesh {mesh.shape} has no "
                                 f"axis {a!r}")
            count *= mesh.shape[a]
            idx = idx * mesh.shape[a] + mesh.coordinate(a)
        out.append((axes, count, idx))
    return out


def cut(x: torch.Tensor, mesh: Mesh, spec: P) -> torch.Tensor:
    """This rank's block of the global ``x`` under ``spec`` (a view)."""
    for d, (_, count, idx) in enumerate(_dims(mesh, spec, x.dim())):
        if count > 1:
            if x.shape[d] % count:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split into {count} shards ({spec})")
            w = x.shape[d] // count
            x = x.narrow(d, idx * w, w)
    return x


def gather(local: torch.Tensor, mesh: Mesh, spec: P) -> torch.Tensor:
    """The global tensor from every rank's block under ``spec``
    (differentiable: ``collectives.all_gather``)."""
    from . import collectives as cc
    with mesh:
        for d, (axes, count, _) in enumerate(_dims(mesh, spec, local.dim())):
            if count > 1:
                local = cc.all_gather(local, axes, axis=d)
    return local


class NamedSharding:
    """A mesh and a spec (JAX's ``NamedSharding``); ``placements`` are
    the DTensor placements, one a mesh dimension."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard
        out = [Replicate() for _ in self.mesh.axis_names]
        for d, entry in enumerate(self.spec):
            axes = _entry_axes(entry)
            dims = [self.mesh.axis_names.index(a) for a in axes]
            if dims != sorted(dims):
                raise ValueError(
                    f"spec {self.spec}: axes {axes} on one dim must follow "
                    f"the mesh's order {self.mesh.axis_names} (a DTensor "
                    "shards one dim over mesh dims left to right)")
            for i in dims:
                out[i] = Shard(d)
        return out

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec})"


def spec_of(x) -> Optional[P]:
    """The spec of a DTensor built here (None for any other value)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return None
    names = x.device_mesh.mesh_dim_names
    entries: List[list] = [[] for _ in range(x.dim())]
    for name, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    out = [None if not e else (e[0] if len(e) == 1 else tuple(e))
           for e in entries]
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def from_local(block: torch.Tensor, mesh: Mesh, spec: P, shape):
    """The DTensor of global ``shape`` whose block on this rank under
    ``spec`` is ``block`` (no communication)."""
    from torch.distributed.tensor import DTensor
    mesh._require_member()
    mesh.device_mesh._pt_mesh = mesh
    shape = torch.Size(shape)
    return DTensor.from_local(block.contiguous(), mesh.device_mesh,
                              NamedSharding(mesh, spec).placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def device_put(x, sharding: NamedSharding):
    """Place the global ``x`` (a tensor or a numpy array, the same on every
    rank) as a DTensor: this rank keeps its block, on the mesh's device."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    if isinstance(x, DTensor):
        x = to_global(x)
    x = torch.as_tensor(x).to(mesh.device)
    return from_local(cut(x, mesh, sharding.spec), mesh, sharding.spec,
                      x.shape)


def to_global(x):
    """The global value of a DTensor placed here (an all-gather over its
    sharded axes); any other value as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return gather(x.to_local(), _mesh_of(x), spec_of(x))


def local(x):
    """This rank's block of a DTensor; any other value as it is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _mesh_of(x) -> Mesh:
    return x.device_mesh._pt_mesh


def tree_map(fn, tree):
    """``fn`` over the leaves of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard(mesh: Mesh, *axes: Optional[str]) -> NamedSharding:
    """NamedSharding with one mesh axis (or None) per tensor dim."""
    return NamedSharding(mesh, P(*axes))


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """Place a global batch on the mesh: dim 0 of every tensor leaf split
    over ``axis`` (each rank keeps its rows), replicated when the mesh
    has no such axis; other leaves as they are."""
    def put(x):
        if not isinstance(x, (torch.Tensor, np.ndarray)):
            return x
        nd = x.ndim
        spec = P(axis, *([None] * (nd - 1))) \
            if nd >= 1 and axis in mesh.shape else P()
        return device_put(x, NamedSharding(mesh, spec))

    return tree_map(put, batch)


def _first_match(rules, path: str) -> Optional[P]:
    """First spec whose compiled pattern matches ``path`` (prefix match,
    the ParamAttr-era regex contract) — the ONE implementation of rule
    lookup, shared by ShardingRules and SpecLayout."""
    for pat, spec in rules:
        if pat.match(path):
            return spec
    return None


_LIST_ITEM = re.compile(r"(^|/)(blocks|enc_blocks|dec_blocks)/(\d+)(?=/|$)")


def jax_path(path: str) -> str:
    """A port tree path in JAX's spelling (``blocks/0/qkv/w`` ->
    ``blocks_0/qkv/w``)."""
    return _LIST_ITEM.sub(r"\1\2_\3", path)


def _shape(x) -> Tuple[int, ...]:
    return tuple(getattr(x, "shape", ()))


class ShardingRules:
    """Ordered (path-regex -> PartitionSpec) table for parameter trees.

    Example (megatron-style 2D for a transformer block)::

        rules = ShardingRules([
            (r".*/attn/.*proj_qkv/w$", P(None, "model")),   # column parallel
            (r".*/attn/.*proj_out/w$", P("model", None)),   # row parallel
            (r".*", P()),                                   # the rest
        ])
        params = rules.apply(mesh, params)
    """

    def __init__(self, rules: Sequence[Tuple[str, P]]):
        self.rules: List[Tuple[re.Pattern, P]] = [(re.compile(pat), spec)
                                                  for pat, spec in rules]

    def spec_for(self, path: str) -> P:
        spec = _first_match(self.rules, jax_path(path))
        return spec if spec is not None else P()

    def resolve(self, mesh: Mesh, path: str, shape: Sequence[int]
                ) -> NamedSharding:
        return NamedSharding(mesh, self.spec_for(path))

    def apply(self, mesh: Mesh, params):
        """device_put every leaf per its matched spec."""
        return _apply(self, mesh, params)

    def shardings(self, mesh: Mesh, params):
        """A tree of NamedShardings matching ``params``."""
        flat = _flatten_with_paths(params)
        return _unflatten_paths({p: self.resolve(mesh, p, _shape(l))
                                 for p, l in flat}, tree_spec(params))


def _apply(rules, mesh: Mesh, tree):
    flat = _flatten_with_paths(tree)
    return _unflatten_paths({p: device_put(l, rules.resolve(mesh, p,
                                                           _shape(l)))
                             for p, l in flat}, tree_spec(tree))


class SpecLayout:
    """Resolve parameters/persistables to PartitionSpecs on a named mesh.

    The layout-resolution contract (docs/design/spmd.md), highest wins:

    1. an explicit per-variable ``sharding`` annotation (the
       ``annotation`` argument),
    2. the first matching user rule — an ordered (path-regex ->
       PartitionSpec) table, :class:`ShardingRules` style,
    3. built-in role rules (``roles=True``): embedding tables shard their
       vocab dim over ``(fsdp, tp)``; other 2-D weights shard
       ``(fsdp, tp)``; >=3-D kernels shard the output-channel (last) dim
       over ``tp``; 1-D vectors and scalars replicate,
    4. replicated.

    Every resolved spec is then *fitted* to the actual mesh and value
    shape: axes the mesh does not carry drop out of the spec, and a dim
    whose extent is not divisible by its axes' total size falls back to
    replicated on that dim.
    """

    def __init__(self, rules: Optional[Sequence[Tuple[str, P]]] = None, *,
                 data_axis: str = "data", fsdp_axis: str = "fsdp",
                 tp_axis: str = "tp", roles: bool = True):
        self.data_axis = data_axis
        self.fsdp_axis = fsdp_axis
        self.tp_axis = tp_axis
        self.roles = roles
        self.rules = ShardingRules(rules) if rules else None

    # -- resolution --------------------------------------------------------
    def spec_for(self, path: str, shape: Sequence[int] = (),
                 annotation: Optional[Sequence] = None) -> P:
        """The un-fitted spec for one value (contract order above)."""
        if annotation is not None:
            return P(*annotation)
        path = jax_path(path)
        if self.rules is not None:
            spec = _first_match(self.rules.rules, path)
            if spec is not None:
                return spec
        if not self.roles:
            return P()
        ndim = len(shape)
        if ndim >= 2 and "embed" in path.lower():
            return P((self.fsdp_axis, self.tp_axis),
                     *([None] * (ndim - 1)))
        if ndim == 2:
            return P(self.fsdp_axis, self.tp_axis)
        if ndim >= 3:
            return P(*([None] * (ndim - 1)), self.tp_axis)
        return P()

    @staticmethod
    def fit(mesh, spec: P, shape: Sequence[int]) -> P:
        """Trim ``spec`` to what ``mesh`` (anything with a ``shape`` dict of
        axis sizes) and ``shape`` support."""
        entries = list(spec)[:len(shape)]
        entries += [None] * (len(shape) - len(entries))
        out = []
        for dim, entry in zip(shape, entries):
            axes = tuple(a for a in _entry_axes(entry) if a in mesh.shape)
            total = 1
            for a in axes:
                total *= mesh.shape[a]
            if not axes or total <= 1 or dim % total:
                out.append(None)
            elif len(axes) == 1:
                out.append(axes[0])
            else:
                out.append(axes)
        while out and out[-1] is None:      # canonical short form
            out.pop()
        return P(*out)

    def resolve(self, mesh: Mesh, path: str, shape: Sequence[int],
                annotation: Optional[Sequence] = None) -> NamedSharding:
        spec = self.spec_for(path, shape, annotation)
        return NamedSharding(mesh, self.fit(mesh, spec, shape))

    def batch_spec(self, ndim: int) -> P:
        """Activations/feeds: leading (batch) dim over ``data``."""
        if ndim < 1:
            return P()
        return P(self.data_axis, *([None] * (ndim - 1)))

    # -- ShardingRules-compatible tree interface ---------------------------
    def apply(self, mesh: Mesh, params):
        """device_put every leaf per its resolved sharding."""
        return _apply(self, mesh, params)

    def shardings(self, mesh: Mesh, params):
        """A tree of NamedShardings matching ``params``."""
        flat = _flatten_with_paths(params)
        return _unflatten_paths({p: self.resolve(mesh, p, _shape(l))
                                 for p, l in flat}, tree_spec(params))


def shard_params(params, mesh: Mesh, rules=None):
    """Place a params tree on the mesh (replicated unless rules say
    otherwise); ``rules`` is a :class:`ShardingRules` or :class:`SpecLayout`."""
    if rules is None:
        rules = ShardingRules([])
    return rules.apply(mesh, params)


def with_sharding_constraint(x, mesh: Mesh, *axes: Optional[str]):
    """Re-place ``x`` (a DTensor or a global tensor) under ``P(*axes)``:
    the layer-boundary layout conversion, a redistribute."""
    return device_put(to_global(x), NamedSharding(mesh, P(*axes)))


def tree_to_global(tree) -> Any:
    """Every DTensor leaf of a tree as its global value."""
    return tree_map(to_global, tree)
