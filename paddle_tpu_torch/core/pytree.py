"""Parameter trees: nested dicts of tensors, as the JAX package's pytrees
of parameters and optimizer state are nested dicts of arrays.

A map over the leaves, the (path, leaf) pairs and their inverse, for the
optimizer and the trainer: a path is a tuple of dict keys;
``"/".join(path)`` is the JAX tree's name (``embed/w``) and
``".".join(path)`` the module's parameter name (``embed.w``).

And the string-path codec of ``paddle_tpu/core/pytree.py``, which the
checkpoint format and the optimizer hooks' path match share with JAX:
``{"a/b/w": leaf}`` with lists and tuples as ``@i`` segments, and the
container kinds by path (``tree_spec``) so that empty containers and
tuples survive a round trip.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterable, List, Mapping, Tuple

Path = Tuple[str, ...]


def tree_items(tree: Mapping, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """(path, leaf) for every leaf, in the dict's order."""
    out: List[Tuple[Path, Any]] = []
    for key, val in tree.items():
        path = prefix + (key,)
        if isinstance(val, Mapping):
            out.extend(tree_items(val, path))
        else:
            out.append((path, val))
    return out


def tree_from_items(items: Iterable[Tuple[Path, Any]]) -> Dict[str, Any]:
    """The nested dict that ``tree_items`` flattened."""
    root: Dict[str, Any] = {}
    for path, leaf in items:
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return root


def tree_get(tree: Mapping, path: Path) -> Any:
    for key in path:
        tree = tree[key]
    return tree


def tree_map(fn: Callable, tree: Mapping, *rest: Mapping) -> Dict[str, Any]:
    """``fn(leaf, *others)`` at every leaf of ``tree``; each of ``rest`` is
    read at the same path. A subtree of ``rest`` where ``tree`` has a leaf
    is handed over whole (the optimizer's slot dict per parameter)."""
    return tree_from_items(
        (path, fn(leaf, *(tree_get(r, path) for r in rest)))
        for path, leaf in tree_items(tree))


# -- the string-path codec (paddle_tpu/core/pytree.py) ------------------------

_IDX = re.compile(r"@\d+")


def _walk(tree, prefix: str = ""):
    """(path, kind, node) of every node: dict keys joined with '/', list
    and tuple indices as '@i'; kind is 'dict', 'list', 'tuple' or
    'leaf'. The walkers below derive from this one grammar."""
    if isinstance(tree, dict):
        yield prefix, "dict", tree
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        yield prefix, "tuple" if isinstance(tree, tuple) else "list", tree
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/@{i}" if prefix else f"@{i}")
    else:
        yield prefix, "leaf", tree


def flatten_path_tree(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    return [(p, node) for p, kind, node in _walk(tree, prefix)
            if kind == "leaf"]


def tree_spec(tree, prefix: str = "") -> Dict[str, str]:
    """Container kinds by path, empty dicts, lists and tuples included
    (an SGD state's slots are ``{}`` a parameter)."""
    return {p: kind for p, kind, _ in _walk(tree, prefix) if kind != "leaf"}


def _holds(container: str, path: str) -> bool:
    return container == "" or path.startswith(container + "/")


def _walk_order(containers: List[str], leaves: List[str]):
    """The walk order of a tree, (path, is_leaf), from its containers'
    paths and its leaves' paths, each in walk order. The next container
    comes before the next leaf when it holds the leaf, when the leaf's
    parent is still to come, or when its own parent does not hold the
    leaf (that parent's nodes all come before the leaf); else after it.
    The format does not record where an empty container stood among
    leaves of the same dict: it goes after them."""
    done = set()
    i = j = 0
    while i < len(containers) or j < len(leaves):
        if i < len(containers) and (j == len(leaves) or any((
                _holds(containers[i], leaves[j]),
                leaves[j].rpartition("/")[0] not in done,
                not _holds(containers[i].rpartition("/")[0], leaves[j])))):
            done.add(containers[i])
            yield containers[i], False
            i += 1
        else:
            yield leaves[j], True
            j += 1


def unflatten_path_tree(flat: Dict[str, Any], spec: Dict[str, str] = None):
    """The nested tree of ``{path: leaf}``. With a ``spec`` from
    :func:`tree_spec` empty containers come back and lists stay apart
    from tuples; without one, a node whose keys are all ``@i`` is a
    list. Each dict lists its keys in the order of the tree that was
    flattened (``flat`` and ``spec`` in walk order, as the flatteners
    give them), so flattening the result again gives the same paths in
    the same order."""
    root: Dict[str, Any] = {}

    def ensure(path):
        node = root
        if path:
            for k in path.split("/"):
                node = node.setdefault(k, {})
        return node

    for path, is_leaf in _walk_order(list(spec or ()), list(flat)):
        if is_leaf:
            keys = path.split("/")
            ensure("/".join(keys[:-1]))[keys[-1]] = flat[path]
        else:
            ensure(path)

    def fix(node, p):
        if isinstance(node, dict):
            kind = spec.get(p) if spec else None
            if kind is None:
                kind = ("list" if node and all(_IDX.fullmatch(k)
                                               for k in node) else "dict")
            if kind in ("list", "tuple"):
                items = [fix(node[f"@{i}"], f"{p}/@{i}" if p else f"@{i}")
                         for i in range(len(node))]
                return tuple(items) if kind == "tuple" else items
            return {k: fix(v, f"{p}/{k}" if p else k)
                    for k, v in node.items()}
        return node

    return fix(root, "")
