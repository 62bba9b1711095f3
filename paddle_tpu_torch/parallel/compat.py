"""``shard_map`` and ``pcast`` — the counterpart of
``paddle_tpu/parallel/compat.py``.

``shard_map(f, mesh=, in_specs=, out_specs=)`` keeps JAX's call shape
over the port's SPMD ranks: every rank passes the same global tensors;
each rank cuts out its block by each ``in_spec``, runs ``f`` with the
mesh in scope (the collectives resolve its axis names), and assembles
the global output by each ``out_spec``: an all-gather over the sharded
axes, or the rank's own value where the spec is replicated (the body
must then compute the same value on every rank, as JAX assumes under
``check_vma=False``). A spec is a prefix of its argument's tree (one
``P`` places every leaf below it), as in JAX. A DTensor argument whose
placement is the spec's passes its local block.

Differentiable: the gradient with respect to an input is the gradient of
the global function, the same on every rank. An input's cut sums the
cotangents of every rank's block over the whole mesh (zero-padded into
the global shape), so a replicated input (``P()``, the parameters) gets
the sum of every rank's contribution; an output's gather keeps this
rank's block of the (replicated) cotangent.

``pcast`` is the identity, as JAX's fallback is: it adjusts only the
replication-tracking type of a value, which the port does not track.
"""

from __future__ import annotations

import torch

from .mesh import Mesh
from .sharding import P, cut, gather, local, spec_of, to_global, tree_map

__all__ = ["shard_map", "pcast"]


class _Cut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.meta = (mesh, spec, x.shape)
        return cut(x, mesh, spec).contiguous()

    @staticmethod
    def backward(ctx, g):
        from . import collectives as cc
        mesh, spec, shape = ctx.meta
        full = g.new_zeros(shape)
        cut(full, mesh, spec).copy_(g)
        with mesh:
            full = cc.all_reduce(full, mesh.axis_names)
        return full, None, None


def _cut_input(x, spec: P, mesh: Mesh):
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        if spec_of(x) == P(*_trim(spec)) and x.device_mesh is \
                mesh.device_mesh:
            return local(x)
        x = to_global(x)
    if not isinstance(x, torch.Tensor):
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _Cut.apply(x, mesh, spec)
    return cut(x, mesh, spec)


def _trim(spec):
    out = list(spec)
    while out and out[-1] is None:
        out.pop()
    return out


def _gather_output(x, spec: P, mesh: Mesh):
    return gather(x, mesh, spec) if isinstance(x, torch.Tensor) else x


def _map_specs(fn, tree, specs, mesh):
    """``fn(leaf, spec, mesh)`` at every leaf, ``specs`` a prefix tree."""
    if isinstance(specs, P) or specs is None:
        spec = P() if specs is None else specs
        return tree_map(lambda leaf: fn(leaf, spec, mesh), tree)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, tree[k], specs[k], mesh) for k in tree}
    if isinstance(specs, (list, tuple)):
        if len(specs) != len(tree):
            raise ValueError(f"specs {specs} do not match a tree of "
                             f"{len(tree)} entries")
        return type(tree)(_map_specs(fn, t, s, mesh)
                          for t, s in zip(tree, specs))
    raise TypeError(f"not a spec tree: {specs!r}")


def shard_map(f, *, mesh: Mesh, in_specs, out_specs, check_vma=None,
              **kw):
    """``f`` run per rank on its blocks of global arguments (module
    docstring). ``check_vma`` and JAX's other keywords are accepted and
    change nothing."""
    del check_vma, kw

    def run(*args):
        mesh._require_member()
        specs = in_specs if not isinstance(in_specs, P) else \
            (in_specs,) * len(args)
        local_args = _map_specs(_cut_input, tuple(args), tuple(specs), mesh)
        with mesh:
            out = f(*local_args)
        return _map_specs(_gather_output, out, out_specs, mesh)

    return run


def pcast(x, axis_name, *, to="varying"):
    """Identity (module docstring)."""
    del axis_name, to
    return x
