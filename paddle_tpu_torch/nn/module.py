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
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn

from ..core.graphs import GraphCache
from ..core.place import DeviceLike, require_device
from ..core.pytree import tree_from_items, tree_items
from . import initializer as I


class Module(nn.Module):
    """A module whose parameters each carry an initializer."""

    def __init__(self):
        super().__init__()
        self._inits: Dict[str, I.Initializer] = {}
        self._graphs: Optional[GraphCache] = None

    def param(self, name: str, shape, init: I.Initializer) -> None:
        self.register_parameter(name, nn.Parameter(
            torch.empty(tuple(shape), device="meta"), requires_grad=False))
        self._inits[name] = init

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


def run_initializers(root: nn.Module, gen: torch.Generator) -> None:
    """Run every module's initializers below ``root`` in module order."""
    for mod in root.modules():
        for name, init in getattr(mod, "_inits", {}).items():
            init(getattr(mod, name), gen)
