"""Carry the JAX package's weights and optimizer state into the port.

A JAX model keeps its parameters as a nested dict whose key paths are
those of ``paddle_tpu/nn/module.py`` ``Module.init``; for
``TransformerLM``::

    embed/w, pos_embed, blocks_{i}/{ln1,ln2}/{gamma,beta},
    blocks_{i}/{qkv,proj,mlp_in,mlp_out}/{w,b}, ln_f/{gamma,beta}

and for ``LSTMTextCls``: ``embed/w``, ``w{i}``, ``u{i}``, ``b{i}``,
``fc/w``, ``fc/b``. On the JAX side, ``jax.tree_util.tree_map(np.asarray,
params)`` turns it into numpy arrays. The port stores ``Linear`` weights
as [in, out], as JAX does, so nothing is transposed: the one layout
change is the transformer's block list, ``blocks_{i}`` -> ``blocks.{i}``.

An optimizer state (``{"step", "slots": {<param path>: {"m", "v"}}}`` for
Adam) has the same layout in both packages; ``tree_from_numpy`` carries
it, or any nested dict of arrays, across as it is.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.place import DeviceLike, resolve_device
from .core.pytree import tree_map

_BLOCK = re.compile(r"^blocks_(\d+)$")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        m = _BLOCK.match(key) if not prefix else None
        name = f"blocks.{m.group(1)}" if m else key
        path = f"{prefix}{name}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = np.asarray(val)
    return out


def params_from_numpy(tree: Mapping, model: torch.nn.Module,
                      device: DeviceLike = None) -> torch.nn.Module:
    """Load the JAX parameter tree ``tree`` (numpy leaves) into ``model``
    on ``device`` (default: the card) and return the model. Raises
    ``KeyError`` on a missing or extra key and ``ValueError`` on a shape
    that differs from the model's."""
    dev = resolve_device(device)
    flat = _flatten(tree)
    want = dict(model.named_parameters())
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"parameter tree does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    state = {}
    for name, arr in flat.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} != the "
                             f"model's {tuple(want[name].shape)}")
        state[name] = torch.tensor(arr, device=dev)     # a copy
    model.load_state_dict(state, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def tree_from_numpy(tree: Mapping, device: DeviceLike = None
                    ) -> Dict[str, Any]:
    """A nested dict of numpy arrays (a JAX optimizer state or parameter
    tree) as the same nested dict of tensors on ``device`` (default: the
    card), dtypes kept (Adam's ``step`` stays an int32 scalar)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)
