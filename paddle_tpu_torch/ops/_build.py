"""Build and load the port's CUDA kernels (``paddle_tpu_torch/csrc``).

``nvcc`` compiles each ``.cu`` to an object for ``sm_90a`` — one process
per source, all started together — and links them into one shared
library with a plain C interface, loaded through ``ctypes``. No PyTorch
header is compiled, so a build takes seconds. The link names no
``libcuda``: the tensor maps of the TMA loads are encoded through
``cuTensorMapEncodeTiled``, looked up at run time with
``cudaGetDriverEntryPointByVersion`` (``csrc/hopper.cuh``).

The library lands in ``paddle_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags: the first call
after a change builds, later calls load. The build runs at first use,
never at import, so the package imports where there is no ``nvcc``. The
first load's seconds go to an open goodput ledger's ``compile`` bucket.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
from pathlib import Path
from typing import List, Optional

# absolute, so that this file also loads on its own (chip_smoke.py's
# load_parent builds another checkout's kernels through it)
from paddle_tpu_torch.utils import native_build
from paddle_tpu_torch.utils.native_build import Build

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libpaddle_tpu_torch_kernels.so"

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_i64, _i32, _f32, _p = (ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                        ctypes.c_void_p)
# argtypes of every C entry point: pointers and the stream as c_void_p,
# so ctypes never truncates a 64-bit address to an int
SIGNATURES = {
    "paddle_flash_attention_fwd": [_p, _p, _p, _p, _p, _p,
                                   _i32, _i32, _i32, _i32, _i32,
                                   _i64, _i64, _i64, _i64, _i64, _i64,
                                   _i64, _i64, _i64,
                                   _f32, _i32, _i32, _p],
    "paddle_flash_attention_bwd_dq": [_p] * 9 + [_i32] * 5 + [_i64] * 9
                                     + [_f32, _i32, _i32, _i32, _p],
    "paddle_flash_attention_bwd_dkv": [_p] * 9 + [_i32] * 5 + [_i64] * 9
                                      + [_f32, _i32, _i32, _p],
    "paddle_paged_decode_attention": [_p] * 8 + [_i32] * 8 + [_i64] * 2
                                     + [_f32, _i32, _p],
    "paddle_paged_decode_attention_q": [_p] * 10 + [_i32] * 8 + [_i64] * 2
                                       + [_f32, _i32, _p],
    "paddle_decode_attention": [_p] * 7 + [_i32] * 6 + [_i64] * 5
                               + [_f32, _i32, _p],
    "paddle_decode_attention_q": [_p] * 9 + [_i32] * 6 + [_i64] * 8
                                 + [_f32, _i32, _p],
    "paddle_lstm_seq": [_p] * 10 + [_i32, _i32, _i32, _f32] + [_i32] * 4
                       + [_p],
    "paddle_lstm_seq_train": [_p] * 11 + [_i32, _i32, _i32, _f32]
                             + [_i32] * 4 + [_p],
    "paddle_lstm_seq_bwd": [_p] * 18 + [_i32, _i32, _i32, _f32, _i32, _p],
    "paddle_lstm_batch_tile": [],
    "paddle_card_limits": [_p, _p],
    "paddle_gru_seq": [_p] * 8 + [_i32] * 7 + [_p],
    "paddle_gru_seq_bwd": [_p] * 14 + [_i32, _i32, _i32, _i32, _p],
}


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


_lock = threading.Lock()
_loaded: Optional[Build] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    return native_build.source_hash(CFLAGS, sources())


def find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                     "the CUDA kernels are built on the machine with the card")


def _compile(out_dir: Path) -> str:
    return native_build.compile_library(
        find_nvcc(), [*CFLAGS, "-I", str(CSRC)], sorted(CSRC.glob("*.cu")),
        out_dir, LIB_NAME, ARCH_FLAGS, BuildError)


def load() -> Build:
    """Build (if this source hash has no library yet) and load the kernels."""
    global _loaded
    with _lock:
        if _loaded is None:
            import time
            t0 = time.perf_counter()
            build = native_build.build_and_load(
                BUILD_ROOT / source_hash(), LIB_NAME, _compile)
            # a first-use build is compile time to an open goodput ledger
            from paddle_tpu_torch.obs import goodput
            goodput.note_compile(time.perf_counter() - t0)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(build.lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded = build
        return _loaded
