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
never at import, so the package imports where there is no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

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


class Build:
    """One built library: its handle, where it lives, what nvcc said."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str,
                 seconds: float, built: bool):
        self.lib, self.path, self.log = lib, path, log
        self.seconds, self.built = seconds, built

    def resource_lines(self) -> List[str]:
        """ptxas' register / shared-memory / spill lines per kernel."""
        keep = ("Compiling entry function", "Used ", "spill stores",
                "bytes stack frame")
        return [ln.strip() for ln in self.log.splitlines()
                if any(k in ln for k in keep)]


_lock = threading.Lock()
_loaded: Optional[Build] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


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
    nvcc = find_nvcc()
    cu = sorted(CSRC.glob("*.cu"))
    procs = []
    for src in cu:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *CFLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    log = "\n".join(logs)
    if failed:
        raise BuildError(f"nvcc failed on {failed}:\n{log}")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_dir / LIB_NAME),
            *[str(obj) for _, obj, _ in procs]]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise BuildError(f"nvcc link failed:\n{res.stdout}")
    return log


def load() -> Build:
    """Build (if this source hash has no library yet) and load the kernels."""
    global _loaded
    with _lock:
        if _loaded is not None:
            return _loaded
        t0 = time.perf_counter()
        final = BUILD_ROOT / source_hash()
        built = False
        if not (final / LIB_NAME).is_file():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
            try:
                log = _compile(tmp)
                (tmp / "nvcc.log").write_text(log)
                try:
                    os.replace(tmp, final)     # atomic publish
                except OSError:                # another process won the race
                    pass
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            built = True
        lib = ctypes.CDLL(str(final / LIB_NAME))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        log_path = final / "nvcc.log"
        log = log_path.read_text() if log_path.is_file() else ""
        _loaded = Build(lib, final, log, time.perf_counter() - t0, built)
        return _loaded
