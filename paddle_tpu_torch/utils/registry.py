"""Class/function registry.

The port's copy of ``paddle_tpu/utils/registry.py``: the analog of the reference's ``ClassRegistrar`` (paddle/utils/ClassRegistrar.h)
and the op/layer registration macros (``REGISTER_LAYER`` at gserver/layers/Layer.h:31,
``REGISTER_OP*`` at framework/op_registry.h:129-233). One generic registry class is
enough here: layers, ops, activations, evaluators, datasets and readers each hold an
instance.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    """Name -> callable registry with decorator-style registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: Optional[str] = None, obj: Any = None):
        """Register ``obj`` under ``name``.

        Usable as ``@registry.register()``, ``@registry.register("name")`` or
        directly ``registry.register("name", obj)``.
        """
        if obj is not None:
            self._register(name or getattr(obj, "__name__"), obj)
            return obj

        def deco(fn):
            self._register(name or fn.__name__, fn)
            return fn

        return deco

    def _register(self, name: str, obj: Any):
        if name in self._entries:
            raise KeyError(f"{self.kind} '{name}' registered twice")
        self._entries[name] = obj

    def get(self, name: str) -> Any:
        try:
            return self._entries[name]
        except KeyError:
            known = ", ".join(sorted(self._entries))
            raise KeyError(f"unknown {self.kind} '{name}'; known: {known}") from None

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterable[str]:
        return iter(self._entries)

    def keys(self):
        return self._entries.keys()

    def items(self):
        return self._entries.items()
