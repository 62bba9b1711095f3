"""Host-side optimizer with serializable state (native/optimizer.cc) —
the counterpart of ``paddle_tpu/runtime/optimizer.py`` (copied: it holds
no JAX).

The paddle/optimizer C-ABI library the Go pserver embedded
(go/pserver/optimizer.go), built into the port's host library by
:mod:`.lib`. Backs host-offloaded giant embedding tables (SGD / Adagrad
take sparse row updates) and state checkpointing independent of the
device runtime. The update is the C library's: ``p -= (float)(lr * g)``
with lr a double (Adagrad: ``a += g * g`` in f32, then ``p -= (float)(lr
* g / (sqrt((double)a) + eps))``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from .lib import load_library

_TYPES = {"sgd": 0, "momentum": 1, "adagrad": 2, "adadelta": 3, "adam": 4}
_LR = {"const": 0, "linear": 1}


def _configure(lib):
    c = ctypes
    if getattr(lib, "_pto_configured", False):
        return
    lib.pto_create.restype = c.c_void_p
    lib.pto_create.argtypes = [c.c_int, c.POINTER(c.c_float), c.c_uint64,
                               c.c_double, c.c_int] + [c.c_double] * 7
    lib.pto_destroy.argtypes = [c.c_void_p]
    lib.pto_update.restype = c.c_int
    lib.pto_update.argtypes = [c.c_void_p, c.POINTER(c.c_float), c.c_uint64]
    lib.pto_update_rows.restype = c.c_int
    lib.pto_update_rows.argtypes = [c.c_void_p, c.POINTER(c.c_int),
                                    c.POINTER(c.c_float), c.c_uint64, c.c_uint64]
    lib.pto_get_param.restype = c.POINTER(c.c_float)
    lib.pto_get_param.argtypes = [c.c_void_p, c.POINTER(c.c_uint64)]
    lib.pto_get_rows.restype = c.c_int
    lib.pto_get_rows.argtypes = [c.c_void_p, c.POINTER(c.c_int),
                                 c.POINTER(c.c_float), c.c_uint64, c.c_uint64]
    lib.pto_state_size.restype = c.c_uint64
    lib.pto_state_size.argtypes = [c.c_void_p]
    lib.pto_serialize.restype = c.c_int
    lib.pto_serialize.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.pto_deserialize.restype = c.c_int
    lib.pto_deserialize.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib._pto_configured = True


class HostOptimizer:
    def __init__(self, opt_type: str, param, lr: float = 0.01,
                 lr_policy: str = "const", decay_a: float = 0.0,
                 decay_b: float = 0.0, mu: float = 0.9, rho: float = 0.95,
                 eps: float = 1e-6, beta1: float = 0.9, beta2: float = 0.999):
        """``param`` may be a shape tuple instead of an array: the native
        side then zero-fills in place — no host-side source buffer, no
        copy. The fast path for >HBM embedding tables (a 20 GB table
        starts as ONE allocation instead of numpy-zeros + memcpy)."""
        lib = load_library()
        _configure(lib)
        self._lib = lib
        if isinstance(param, tuple):
            self.shape = param
            self.n = int(np.prod(param))
            src = None
        else:
            param = np.asarray(param)
            self.shape = param.shape
            flat = np.ascontiguousarray(param, np.float32).reshape(-1)
            self.n = flat.size
            src = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self.opt_type = opt_type
        self._h = lib.pto_create(
            _TYPES[opt_type], src,
            self.n, lr, _LR[lr_policy], decay_a, decay_b, mu, rho, eps,
            beta1, beta2)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pto_destroy(self._h)
            self._h = None

    def update(self, grad: np.ndarray):
        g = np.ascontiguousarray(grad, np.float32).reshape(-1)
        if g.size != self.n:
            raise ValueError("gradient size mismatch")
        rc = self._lib.pto_update(
            self._h, g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), self.n)
        if rc != 0:
            raise RuntimeError(f"update failed ({rc})")

    def update_rows(self, rows: np.ndarray, grad: np.ndarray):
        """Sparse rows update: param viewed as [num_rows, width]."""
        rows = np.ascontiguousarray(rows, np.int32)
        g = np.ascontiguousarray(grad, np.float32)
        width = g.shape[-1]
        rc = self._lib.pto_update_rows(
            self._h, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows.size, width)
        if rc != 0:
            raise RuntimeError(f"sparse update failed ({rc}): "
                               f"{self.opt_type} may not support row updates")

    def get_rows(self, rows: np.ndarray, width: int) -> np.ndarray:
        """Gather rows of the param viewed as [num_rows, width] — the
        touched-row prefetch read (pserver getParameterSparse role)."""
        rows = np.ascontiguousarray(rows, np.int32)
        out = np.empty((rows.size, width), np.float32)
        rc = self._lib.pto_get_rows(
            self._h, rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows.size, width)
        if rc != 0:
            raise IndexError("row gather out of range")
        return out

    @property
    def param(self) -> np.ndarray:
        n = ctypes.c_uint64()
        ptr = self._lib.pto_get_param(self._h, ctypes.byref(n))
        return np.ctypeslib.as_array(ptr, (n.value,)).reshape(self.shape).copy()

    def serialize(self) -> bytes:
        size = self._lib.pto_state_size(self._h)
        buf = ctypes.create_string_buffer(size)
        if self._lib.pto_serialize(self._h, buf, size) != 0:
            raise RuntimeError("serialize failed")
        return buf.raw

    def deserialize(self, blob: bytes):
        rc = self._lib.pto_deserialize(self._h, blob, len(blob))
        if rc != 0:
            raise RuntimeError(f"deserialize failed ({rc})")
