"""Parameters facade (python/paddle/v2/parameters.py analog): numpy get/set
over the executor scope + tar serialization (:296-358 to_tar/from_tar) —
the counterpart of ``paddle_tpu/v2/parameters.py``. Values live in the
scope as tensors on the executor's device; tars are JAX's files byte for
byte (``trainer/checkpoint.py``)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..core.place import require_device
from ..fluid.executor import Scope
from ..fluid.framework import Program
from ..trainer.checkpoint import from_tar, to_tar


class Parameters:
    def __init__(self, scope: Scope, program: Program, *, device=None):
        self._scope = scope
        self._program = program
        self.device = require_device(device)

    def names(self) -> List[str]:
        b = self._program.global_block()
        return [n for n, v in b.vars.items()
                if v.persistable and self._scope.has(n)]

    def get(self, name: str) -> np.ndarray:
        v = self._scope.get(name)
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def set(self, name: str, value):
        """Put ``value`` into the scope as a tensor on the device, in the
        parameter's dtype: the scope's tensor's, else the declared one
        (the value's own for a name the program does not declare)."""
        var = self._program.global_block().vars.get(name)
        cur = self._scope.get(name) if self._scope.has(name) else None
        if isinstance(cur, torch.Tensor):
            dtype = cur.dtype
        else:
            dtype = getattr(torch, var.dtype) if var is not None else None
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.array(value))
        self._scope.set(name, value.to(self.device, dtype))

    def __getitem__(self, name):
        return self.get(name)

    def __setitem__(self, name, value):
        self.set(name, value)

    def to_tar(self, f):
        to_tar(f, {n: self.get(n) for n in self.names()})

    def from_tar(self, f):
        for name, arr in from_tar(f, self.device).items():
            self.set(name, arr)
