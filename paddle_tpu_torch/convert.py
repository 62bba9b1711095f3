"""Carry the JAX package's weights and optimizer state into the port.

A JAX model keeps its parameters as a nested dict whose key paths are
those of ``paddle_tpu/nn/module.py`` ``Module.init``; for
``TransformerLM``::

    embed/w, pos_embed, blocks_{i}/{ln1,ln2}/{gamma,beta},
    blocks_{i}/{qkv,proj,mlp_in,mlp_out}/{w,b}, ln_f/{gamma,beta}

for ``LSTMTextCls``: ``embed/w``, ``w{i}``, ``u{i}``, ``b{i}``,
``fc/w``, ``fc/b``; and for ``AttentionSeq2Seq``: ``src_embed/w``,
``trg_embed/w``, ``enc_{w,u,b}_{f,b}``, ``init_fc/{w,b}``, ``att_enc/w``,
``att_dec/w``, ``att_v``, ``dec_w``, ``dec_u``, ``dec_b``, ``out/{w,b}``
(no block list: it loads with no renaming). The image models
(``models/image.py``) keep JAX's attribute names and load with no
renaming either: ``ResNet`` has ``stem/{conv/w, bn}``,
``layer{li}_{bi}/{a,b,c,proj}/{conv/w, bn}`` (``c`` only in the
bottleneck; ``proj`` where the shape changes) and ``head/{w,b}``, each
``bn`` being ``{gamma, beta, stats: {moving_mean, moving_var}}``; ``VGG``
``b{i}_{j}/{conv,bn}``, ``fc1``, ``fc2``, ``out``; ``GoogleNet``
``stem1..3``, ``i3a``..``i5b`` (each ``b1, b3r, b3, b5r, b5, bp``),
``aux1``/``aux2`` (``conv, fc, out``), ``head``; ``AlexNet``,
``LeNet``, ``SmallNet`` ``c{i}``, ``fc{i}``(, ``out``); a
``Sequential``'s children ``mods_{i}``. The zoo of ``models/tagger.py``,
``embeddings.py`` and ``generative.py`` keeps JAX's names too: the
taggers' ``embed``, ``w_{f,b}``/``u_{f,b}``/``bias_{f,b}``, ``fc`` and
``crf/{start,end,trans}``; ``DeepFM``'s ``w1``, ``v``, ``dense_w``,
``deep_{i}`` (attributes of those names, as JAX names a list of
children) and ``deep_out``; ``ConvTextCls``'s ``conv_w``/``conv_b``; a
``TransformerLM(tie_head=False)``'s ``head/w``. The parallel plane's
trees load with no renaming too: ``ColumnParallelLinear`` and
``RowParallelLinear`` hold ``w`` [in, out] and ``b``,
``ShardedEmbedding`` ``table``, a ``PipelineStage`` its stage's leaves
stacked on a leading [n_stages] axis (``{"w": [S, in, out], "b": [S,
out]}`` for a ``Linear`` stage), and an MoE layer's dict (``gate_w``,
``w1``, ``w2``; no module: ``tree_from_numpy``). Conv weights are HWIO, as in
JAX. On the JAX side, ``jax.tree_util.tree_map(np.asarray,
params)`` turns it into numpy arrays. The port stores ``Linear`` weights
as [in, out], as JAX does, so nothing is transposed: the one layout
change is a block list, which JAX names ``blocks_{i}`` (``enc_blocks_{i}``,
``dec_blocks_{i}`` in the NMT model) and the port keeps in a
``ModuleList`` (``blocks.{i}``; ``Module.tree()`` gives ``blocks/{i}``).

An optimizer state (``{"step", "slots": {<param path>: {"m", "v"}}}`` for
Adam, ``{"velocity"}`` a leaf for Momentum, the stats' leaves included)
has the params' layout under ``slots``; ``tree_from_numpy`` carries
it, or any nested dict of arrays, across with the same renaming, so a
JAX Adam state of a transformer matches the port's
``Adam.init(model.tree())``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.place import DeviceLike, resolve_device
from .core.pytree import tree_items, tree_map

# the JAX name of item i of a block list of the port's models
_LIST_ITEM = re.compile(r"^(blocks|enc_blocks|dec_blocks)_(\d+)$")


def port_tree(tree: Mapping) -> Dict[str, Any]:
    """A JAX nested dict in the port's layout: at any depth, the block-list
    items ``blocks_{i}`` become ``blocks/{i}`` (the leaves are kept)."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            val = port_tree(val)
        m = _LIST_ITEM.match(key)
        if m:
            out.setdefault(m.group(1), {})[m.group(2)] = val
        else:
            out[key] = val
    return out


def params_from_numpy(tree: Mapping, model: torch.nn.Module,
                      device: DeviceLike = None) -> torch.nn.Module:
    """Load the JAX parameter tree ``tree`` (numpy leaves) into ``model``
    on ``device`` (default: the card) and return the model. Raises
    ``KeyError`` on a missing or extra key and ``ValueError`` on a shape
    that differs from the model's."""
    dev = resolve_device(device)
    flat = {".".join(path): np.asarray(leaf)
            for path, leaf in tree_items(port_tree(tree))}
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
    tree) as a nested dict of tensors on ``device`` (default: the card) in
    the port's layout (:func:`port_tree`), dtypes kept (Adam's ``step``
    stays an int32 scalar)."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev),
                    port_tree(tree))


def scope_from_numpy(vars: Mapping, device: DeviceLike = None):
    """A fluid scope's variables by name (a JAX ``Scope.vars`` read as
    numpy: ``{n: np.asarray(v) for n, v in scope.vars.items()}``) as a
    port ``fluid.Scope`` of tensors on ``device`` (default: the card),
    dtypes kept, so that both packages' executors start from the same
    weights and optimizer state."""
    from .fluid.executor import Scope
    dev = resolve_device(device)
    scope = Scope()
    for name, arr in vars.items():
        scope.set(name, torch.tensor(np.asarray(arr), device=dev))
    return scope
