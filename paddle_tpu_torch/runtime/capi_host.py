"""Python side of the C inference API — the counterpart of
``paddle_tpu/runtime/capi_host.py``.

The C ABI (``csrc/capi_inference.cc``, built by ``runtime/lib.py``
:func:`~paddle_tpu_torch.runtime.lib.load_capi`) embeds CPython and
drives this class: it loads an exported inference bundle (``fluid/io.py``
``export_inference_model``: program JSON + params tar, JAX's files byte
for byte) onto the card through the port's :class:`~paddle_tpu_torch.
fluid.Executor` and runs it forward, one CUDA graph per feed signature.

The C ABI names only the bundle's directory, so the device comes from
``$PADDLE_TPU_TORCH_CAPI_DEVICE`` when the caller passes none (default:
the card; ``cpu`` runs the plain versions), as JAX's host honours
``$JAX_PLATFORMS``.
"""

from __future__ import annotations

import os
import threading
from typing import List, Tuple

import numpy as np

#: the environment variable the C ABI's device comes from
DEVICE_ENV = "PADDLE_TPU_TORCH_CAPI_DEVICE"

_DTYPES = {0: np.float32, 1: np.int32}


class InferenceHost:
    def __init__(self, model_dir: str, device=None):
        from ..fluid.executor import Executor, Scope
        from ..fluid.io import load_inference_model

        if device is None:
            device = os.environ.get(DEVICE_ENV) or None
        self.exe = Executor(scope=Scope(), device=device)
        self.program, self.feed_names, self.fetch_names = \
            load_inference_model(model_dir, self.exe)
        # concurrent C callers share one executor (its caches and graphs):
        # their runs take turns
        self._lock = threading.Lock()

    def run(self, arrays: List[np.ndarray], fetch_index: int = 0) -> np.ndarray:
        feed = dict(zip(self.feed_names, arrays))
        with self._lock:
            outs = self.exe.run(self.program, feed=feed,
                                fetch_list=[self.fetch_names[fetch_index]])
        return np.asarray(outs[0])

    def run_raw(self, raw: List[Tuple[bytes, Tuple[int, ...], int]],
                fetch_index: int = 0) -> Tuple[bytes, Tuple[int, ...]]:
        """C-ABI entry: [(buffer, dims, dtype_code)] -> (f32 buffer, dims)."""
        arrays = [np.frombuffer(buf, _DTYPES[code]).reshape(dims)
                  for buf, dims, code in raw]
        out = self.run(arrays, fetch_index).astype(np.float32)
        return out.tobytes(), tuple(int(d) for d in out.shape)
