"""The module system — the counterpart of ``paddle_tpu/nn/module.py``.

A JAX ``Module`` declares parameters (``param(name, shape, init)``) and
children, and ``init(rng)`` builds the nested parameter dict. Here a
module is a ``torch.nn.Module`` that holds its parameters itself, under
the same names: ``tree()`` gives them as the JAX package's nested dict
(``{"embed": {"w": ...}, "w0": ..., "fc": {"w": ..., "b": ...}}``), and
``call(params, ...)`` runs the forward (``method="loss"``: another
method) with the leaves of such a tree in place of the module's own
parameters, so a functional trainer can
differentiate with respect to a tree as ``jax.value_and_grad`` does.

A module is built with its parameters on the ``meta`` device; ``init``
(random weights from a seed) or ``convert.params_from_numpy`` (weights
from the JAX package) puts them on a device.

Running state (batch norm's moving stats) is declared with ``stat``: it
lives in a child module named ``stats``, so the tree holds it under a
``"stats"`` key as JAX's ``init`` does (``{"bn": {"gamma", "beta",
"stats": {"moving_mean", "moving_var"}}}``) and the optimizers skip it.
A training-mode forward records its new values in the ``mutable`` dict
it is given, keyed by the module's path (``layer0_0/a/bn``), and
``apply_stat_updates`` merges them back into a tree (``apply_stat_updates_``
in place, as the trainer's step does).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional

import torch
from torch import nn

from ..core.graphs import GraphCache
from ..core.place import DeviceLike, require_device
from ..core.pytree import tree_from_items, tree_get, tree_items
from . import initializer as I


class Module(nn.Module):
    """A module whose parameters each carry an initializer."""

    def __init__(self):
        super().__init__()
        self._inits: Dict[str, I.Initializer] = {}
        self._graphs: Optional[GraphCache] = None
        self._path = ""

    def __setattr__(self, name: str, value) -> None:
        super().__setattr__(name, value)
        if isinstance(value, nn.Module):
            self._assign_paths()

    def _assign_paths(self) -> None:
        """Every module below this one learns its path from here (JAX's
        ``_assign_paths``); a parent that is attached later walks again."""
        for sub, mod in self.named_modules():
            if mod is not self and isinstance(mod, Module):
                names = ([self._path] if self._path else []) + sub.split(".")
                object.__setattr__(mod, "_path", "/".join(names))

    def param(self, name: str, shape, init: I.Initializer) -> None:
        self.register_parameter(name, nn.Parameter(
            torch.empty(tuple(shape), device="meta"), requires_grad=False))
        self._inits[name] = init

    def stat(self, name: str, shape, init: I.Initializer) -> None:
        """Declare non-trainable running state, kept in the child module
        ``stats`` (the tree's ``"stats"`` key)."""
        if "stats" not in self._modules:
            self.stats = Stats()
        self.stats.param(name, shape, init)

    def record_stats(self, mutable: Optional[Dict], updates: Dict[str, Any]
                     ) -> None:
        """Record training-mode stat updates under this module's path in
        the caller's collector (nothing when it is None)."""
        if mutable is not None:
            mutable[self._path] = updates

    def init(self, seed: int = 0, device: DeviceLike = None):
        """Random weights drawn from ``torch.Generator().manual_seed(seed)``
        with the distributions of the JAX model, on ``device`` (default:
        the card; no card -> this raises)."""
        self.to_empty(device=require_device(device))
        run_initializers(self, torch.Generator().manual_seed(seed))
        return self

    def tree(self) -> Dict[str, Any]:
        """The parameters as the JAX package's nested dict (the module's
        own tensors, not copies)."""
        return tree_from_items((tuple(name.split(".")), p)
                               for name, p in self.named_parameters())

    def graph_cache(self) -> GraphCache:
        """The model's CUDA graphs (``core/graphs.py``) on the device of its
        weights, which the graphs read in place: a cache made anew when the
        weights moved, whose graphs and buffers are dropped when one was
        reallocated (``model.to(torch.bfloat16)``)."""
        dev = next(self.parameters()).device
        if self._graphs is None or self._graphs.device != dev:
            self._graphs = GraphCache(type(self).__name__, dev)
        self._graphs.watch(self.parameters())
        return self._graphs

    def call(self, params: Mapping, *args, method: str = "forward",
             **kwargs):
        """``self.<method>(*args, **kwargs)`` (``forward`` by default) with
        the leaves of the tree ``params`` in place of the module's
        parameters (autograd flows to those leaves)."""
        flat = {"module." + ".".join(path): leaf
                for path, leaf in tree_items(params)}
        return torch.func.functional_call(_Method(self, method), flat, args,
                                          kwargs)


class _Method(nn.Module):
    """``module.<name>`` as the forward of a wrapper: ``functional_call``
    runs only ``forward``, and a model's loss is another method."""

    def __init__(self, module: nn.Module, name: str):
        super().__init__()
        self.module, self.name = module, name

    def forward(self, *args, **kwargs):
        return getattr(self.module, self.name)(*args, **kwargs)


class Stats(Module):
    """The running state of a module (``Module.stat``)."""


class Sequential(Module):
    """Modules applied in order; the keywords go to each. Its children are
    ``mods_{i}``, JAX's names."""

    def __init__(self, *mods: nn.Module):
        super().__init__()
        self.n_mods = len(mods)
        for i, m in enumerate(mods):
            setattr(self, f"mods_{i}", m)

    def forward(self, x, **kw):
        for i in range(self.n_mods):
            x = getattr(self, f"mods_{i}")(x, **kw)
        return x


class Lambda(Module):
    """A function of the input as a module (no parameters)."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x, **kw):
        return self.fn(x)


def param_count(params: Mapping) -> int:
    """The number of elements in a tree's leaves."""
    return sum(leaf.numel() for _, leaf in tree_items(params))


def apply_stat_updates(params: Mapping, mutable: Mapping) -> Dict[str, Any]:
    """A new tree: ``params`` with the recorded stat updates (path ->
    {name: value}) merged into the ``stats`` of each path, the other
    leaves shared (JAX's ``apply_stat_updates``)."""
    out = {path: leaf for path, leaf in tree_items(params)}
    for path, updates in mutable.items():
        keys = tuple(k for k in path.split("/") if k)
        for name, value in updates.items():
            out[keys + ("stats", name)] = value
    return tree_from_items(out.items())


@torch.no_grad()
def apply_stat_updates_(params: Mapping, mutable: Mapping,
                        ok: Optional[torch.Tensor] = None) -> None:
    """:func:`apply_stat_updates` written into ``params`` in place, each
    value cast to the dtype of the stat it replaces (the bf16 recipe's
    updates into the f32 masters); with ``ok`` (a 0-d bool tensor) each
    write is ``where(ok, new, old)`` (the trainer's non-finite guard)."""
    for path, updates in mutable.items():
        stats = tree_get(params, tuple(k for k in path.split("/") if k)
                         + ("stats",))
        for name, value in updates.items():
            old = stats[name]
            old.copy_(value if ok is None else
                      torch.where(ok, value.to(old.dtype), old))


def run_initializers(root: nn.Module, gen: torch.Generator) -> None:
    """Run every module's initializers below ``root`` in module order."""
    for mod in root.modules():
        for name, init in getattr(mod, "_inits", {}).items():
            init(getattr(mod, name), gen)
