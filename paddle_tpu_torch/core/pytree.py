"""Parameter trees: nested dicts of tensors, as the JAX package's pytrees
of parameters and optimizer state are nested dicts of arrays.

Only what the optimizer and the trainer need: a map over the leaves, the
(path, leaf) pairs and their inverse. A path is a tuple of dict keys;
``"/".join(path)`` is the JAX tree's name (``embed/w``) and
``".".join(path)`` the module's parameter name (``embed.w``).
"""

from __future__ import annotations

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
