"""Build a shared library from sources and load it through ``ctypes``: the
one build-and-publish routine of the port's two native libraries
(``ops/_build.py``, the CUDA kernels; ``runtime/lib.py``, the host
runtime).

Each source compiles in a process of its own, all started together, then
one link. A library lives in a directory named by a hash of its sources
and flags, so a change to either builds anew and an unchanged tree loads
what it built before. The build goes into a temporary directory beside
that one, which is then renamed into place: processes that race (test
workers) publish one complete library, and a loser loads the winner's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Sequence, Type

LOG_NAME = "build.log"


class Build:
    """One loaded library: its handle, where it lives, what the compiler
    said, and whether this call built it (``built``) and in how many
    seconds."""

    def __init__(self, lib: ctypes.CDLL, path: Path, log: str,
                 seconds: float, built: bool):
        self.lib, self.path, self.log = lib, path, log
        self.seconds, self.built = seconds, built

    def resource_lines(self) -> List[str]:
        """ptxas' register / shared-memory / spill lines per kernel (an
        ``nvcc -Xptxas -v`` build's; none for another compiler)."""
        keep = ("Compiling entry function", "Used ", "spill stores",
                "bytes stack frame")
        return [ln.strip() for ln in self.log.splitlines()
                if any(k in ln for k in keep)]


def source_hash(flags: Sequence[str], sources: Sequence[Path]) -> str:
    """16 hex digits of the flags and each source's name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def compile_library(compiler: str, flags: Sequence[str],
                    sources: Sequence[Path], out_dir: Path, lib_name: str,
                    link_flags: Sequence[str],
                    error: Type[Exception]) -> str:
    """Compile each source to an object in ``out_dir`` (all at once) and
    link them ``-shared`` into ``out_dir/lib_name``. Returns the
    compilers' log; raises ``error`` with it if a compile or the link
    fails."""
    tool = Path(compiler).name
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        cmd = [compiler, *flags, "-c", str(src), "-o", str(obj)]
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
        raise error(f"{tool} failed on {failed}:\n{log}")
    link = [compiler, *link_flags, "-shared", "-o", str(out_dir / lib_name),
            *[str(obj) for _, obj, _ in procs]]
    res = subprocess.run(link, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise error(f"{tool} link failed:\n{res.stdout}")
    return log


def build_and_load(final: Path, lib_name: str,
                   compile: Callable[[Path], str]) -> Build:
    """Load ``final/lib_name``, first building it with ``compile(dir)``
    (which writes the library into ``dir`` and returns the log) if it is
    not there yet."""
    t0 = time.perf_counter()
    built = False
    if not (final / lib_name).is_file():
        final.parent.mkdir(parents=True, exist_ok=True)
        tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=final.parent))
        try:
            (tmp / LOG_NAME).write_text(compile(tmp))
            try:
                os.replace(tmp, final)     # atomic publish
            except OSError:                # another process won the race
                pass
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        built = True
    lib = ctypes.CDLL(str(final / lib_name))
    log_path = final / LOG_NAME
    log = log_path.read_text() if log_path.is_file() else ""
    return Build(lib, final, log, time.perf_counter() - t0, built)
