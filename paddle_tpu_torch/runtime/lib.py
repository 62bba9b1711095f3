"""Build and load the host runtime library — the counterpart of
``paddle_tpu/runtime/lib.py``.

The library is JAX's own C++ host runtime (task master, master RPC
server, recordio, buddy allocator, host optimizer), compiled from the
five sources ``native/Makefile`` links into ``libpaddle_tpu_host.so``,
with the Makefile's flags, by ``utils/native_build.py``: ``g++`` once per
source, all started together, then linked ``-shared``. The library lands
in ``paddle_tpu_torch/_build/host-<hash>/`` (listed in ``.gitignore``),
keyed by a hash of the sources and flags, so a change to a source builds
anew and an unchanged tree loads what it built before.

The build runs at first use, never at import. It compiles into a
temporary directory that is then renamed into place, so processes that
race (test workers) publish one complete library. Nothing is written
under ``native/``, and ``native/``'s own library is never loaded: the
JAX package builds that file with ``make`` at the same time as the
port's tests run, and the machine with the card has no JAX to build it.
A failed build raises :class:`HostCompileError` with the compiler's log.

:func:`load_capi` builds the C inference API the same way: the port's
copy of ``native/capi_inference.cc`` (``csrc/capi_inference.cc``, which
drives ``paddle_tpu_torch.runtime.capi_host``) compiled with ``g++``
against the running Python's headers, linked to its ``libpython`` where
there is one, into ``_build/capi-<hash>/libpaddle_tpu_torch_capi.so``.
"""

from __future__ import annotations

import ctypes
import shutil
import sysconfig
import threading
from pathlib import Path
from typing import Optional

from ..utils import native_build
from ..utils.native_build import Build

_PKG = Path(__file__).resolve().parent.parent
NATIVE = _PKG.parent / "native"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libpaddle_tpu_host.so"
#: the sources of ``native/Makefile``'s ``SRCS`` and its ``CXXFLAGS``
SOURCES = ("task_master.cc", "master_server.cc", "recordio.cc",
           "buddy_allocator.cc", "optimizer.cc")
CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall"]

#: signature of the unknown-op fallback (master_server.cc ptms_set_fallback):
#: (request bytes, length, opaque reply handle) -> None; the callback
#: answers via ptms_reply(handle, data, len) before returning. Callers must
#: keep the CFUNCTYPE instance alive while the server runs.
PTMS_FALLBACK_FN = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_char),
                                    ctypes.c_int, ctypes.c_void_p)


class HostCompileError(RuntimeError):
    """g++ is missing or refused a source."""


_lock = threading.Lock()
_loaded: Optional[Build] = None
_capi: Optional[Build] = None

#: the C inference API's source and library
CAPI_SOURCE = _PKG / "csrc" / "capi_inference.cc"
CAPI_LIB_NAME = "libpaddle_tpu_torch_capi.so"


def _python_flags():
    """(compile flags, link flags) of the running Python: its headers, and
    its shared ``libpython`` where the installation has one (a C program
    that embeds the API links it; a process that already runs Python
    provides its symbols)."""
    include = sysconfig.get_paths()["include"]
    cflags = [*CXXFLAGS, f"-I{include}"]
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ldlib = sysconfig.get_config_var("LDLIBRARY") or ""
    link = []
    if ldlib.endswith(".so") and (Path(libdir) / ldlib).is_file():
        name = ldlib[len("lib"):-len(".so")]
        # the link names its flags before the objects: --no-as-needed
        # keeps libpython, which nothing before it references yet
        link = [f"-L{libdir}", "-Wl,--no-as-needed", f"-l{name}",
                f"-Wl,-rpath,{libdir}"]
    return cflags, link


def load_capi() -> Build:
    """Build (once per source hash) and load the C inference API library;
    its entry points get their ctypes signatures. ``pti_create`` imports
    ``paddle_tpu_torch.runtime.capi_host`` in the embedded interpreter."""
    global _capi
    with _lock:
        if _capi is None:
            cflags, link = _python_flags()
            tag = native_build.source_hash(cflags + link, [CAPI_SOURCE])

            def compile_(out_dir: Path) -> str:
                cxx = shutil.which("g++")
                if cxx is None:
                    raise HostCompileError("g++ not found: the C inference "
                                           "API is built with g++")
                return native_build.compile_library(
                    cxx, cflags, [CAPI_SOURCE], out_dir, CAPI_LIB_NAME,
                    link, HostCompileError)

            build = native_build.build_and_load(
                BUILD_ROOT / f"capi-{tag}", CAPI_LIB_NAME, compile_)
            _configure_capi(build.lib)
            _capi = build
        return _capi


def _configure_capi(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.pti_create.restype = c.c_void_p
    lib.pti_create.argtypes = [c.c_char_p]
    lib.pti_forward.restype = c.c_int
    lib.pti_forward.argtypes = [
        c.c_void_p, c.POINTER(c.c_void_p), c.POINTER(c.c_longlong),
        c.POINTER(c.c_int), c.POINTER(c.c_int), c.c_int, c.c_int,
        c.POINTER(c.c_float), c.c_longlong, c.POINTER(c.c_longlong),
        c.POINTER(c.c_int)]
    lib.pti_destroy.argtypes = [c.c_void_p]
    lib.pti_last_error.restype = c.c_char_p


def source_hash() -> str:
    return native_build.source_hash(CXXFLAGS,
                                    [NATIVE / name for name in SOURCES])


def _compile(out_dir: Path) -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise HostCompileError("g++ not found: the host runtime library is "
                               "built from native/'s sources with g++")
    return native_build.compile_library(
        cxx, CXXFLAGS, [NATIVE / name for name in SOURCES], out_dir,
        LIB_NAME, [], HostCompileError)


def load() -> Build:
    """Build (if this source hash has no library yet) and load the host
    runtime library; its C entry points get their ctypes signatures."""
    global _loaded
    with _lock:
        if _loaded is None:
            build = native_build.build_and_load(
                BUILD_ROOT / f"host-{source_hash()}", LIB_NAME, _compile)
            _configure(build.lib)
            _loaded = build
        return _loaded


def load_library() -> ctypes.CDLL:
    """The host runtime library (built at the first call)."""
    return load().lib


def native_available() -> bool:
    """Whether the host runtime library builds and loads here."""
    try:
        load()
    except (HostCompileError, OSError):
        return False
    return True


def _configure(lib: ctypes.CDLL):
    c = ctypes
    # task master
    lib.ptm_create.restype = c.c_void_p
    lib.ptm_create.argtypes = [c.c_double, c.c_int]
    lib.ptm_destroy.argtypes = [c.c_void_p]
    lib.ptm_set_dataset.argtypes = [c.c_void_p, c.POINTER(c.c_char_p), c.c_int]
    lib.ptm_get_task.restype = c.c_int
    lib.ptm_get_task.argtypes = [c.c_void_p, c.c_double, c.c_char_p, c.c_int,
                                 c.POINTER(c.c_int)]
    lib.ptm_task_finished.argtypes = [c.c_void_p, c.c_int]
    lib.ptm_new_pass.restype = c.c_int
    lib.ptm_new_pass.argtypes = [c.c_void_p]
    lib.ptm_task_failed.argtypes = [c.c_void_p, c.c_int]
    lib.ptm_tick.restype = c.c_int
    lib.ptm_tick.argtypes = [c.c_void_p, c.c_double]
    lib.ptm_stats.argtypes = [c.c_void_p] + [c.POINTER(c.c_int)] * 5
    lib.ptm_snapshot.restype = c.c_int
    lib.ptm_snapshot.argtypes = [c.c_void_p, c.c_char_p]
    lib.ptm_restore.restype = c.c_int
    lib.ptm_restore.argtypes = [c.c_void_p, c.c_char_p]
    # master RPC server (master_server.cc — ProtoServer-analog data plane)
    lib.ptms_start.restype = c.c_void_p
    lib.ptms_start.argtypes = [c.c_void_p, c.c_char_p, c.c_int,
                               c.POINTER(c.c_int)]
    lib.ptms_port.restype = c.c_int
    lib.ptms_port.argtypes = [c.c_void_p]
    lib.ptms_active_conns.restype = c.c_int
    lib.ptms_active_conns.argtypes = [c.c_void_p]
    lib.ptms_set_fenced.argtypes = [c.c_void_p, c.c_int]
    lib.ptms_set_fallback.argtypes = [c.c_void_p, PTMS_FALLBACK_FN]
    lib.ptms_reply.argtypes = [c.c_void_p, c.POINTER(c.c_char), c.c_int]
    lib.ptms_stop.argtypes = [c.c_void_p]
    # recordio
    lib.ptr_writer_open.restype = c.c_void_p
    lib.ptr_writer_open.argtypes = [c.c_char_p]
    lib.ptr_writer_write.restype = c.c_int
    lib.ptr_writer_write.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.ptr_writer_close.restype = c.c_int64
    lib.ptr_writer_close.argtypes = [c.c_void_p]
    lib.ptr_reader_open.restype = c.c_void_p
    lib.ptr_reader_open.argtypes = [c.c_char_p]
    lib.ptr_reader_next.restype = c.c_int
    lib.ptr_reader_next.argtypes = [c.c_void_p, c.c_char_p, c.c_int]
    lib.ptr_reader_close.argtypes = [c.c_void_p]
    # arena
    lib.pta_create.restype = c.c_void_p
    lib.pta_create.argtypes = [c.c_uint64, c.c_uint64]
    lib.pta_destroy.argtypes = [c.c_void_p]
    lib.pta_alloc.restype = c.c_uint64
    lib.pta_alloc.argtypes = [c.c_void_p, c.c_uint64]
    lib.pta_free.restype = c.c_int
    lib.pta_free.argtypes = [c.c_void_p, c.c_uint64]
    lib.pta_stats.argtypes = [c.c_void_p] + [c.POINTER(c.c_uint64)] * 3
