"""The port's C inference API (``paddle_tpu_torch/csrc/capi_inference.cc``
built by ``runtime/lib.py`` ``load_capi()``, driving
``paddle_tpu_torch.runtime.capi_host``) and its host arena
(``runtime/arena.py`` over the port's build of
``native/buddy_allocator.cc``) against the JAX package's — the 8 cases
of tests/test_capi_inference.py and tests/test_runtime.py's arena cases.

Every bundle is exported by JAX (``fluid.io.export_inference_model``:
JAX's files), then loaded by the port through the C ABI, in this process
(ctypes) and in real C programs (``native/examples/*.c`` linked against
the port's library, each its own embedded interpreter). The C ABI names
only the bundle, so the device comes from
``$PADDLE_TPU_TORCH_CAPI_DEVICE`` (``cpu`` here). Forwards are held to
JAX's ``InferenceHost`` on the same inputs to 1e-5 (absolute and
relative; f32 on both sides, XLA's and torch's CPU matmuls summing in
their own orders). The arena is exact: the same sequence of allocations
and frees gives the same offsets and stats as JAX's.
"""

import ctypes
import os
import shutil
import site
import subprocess
import threading

import numpy as np
import pytest

import paddle_tpu.fluid as fluid
from paddle_tpu.runtime import HostArena as JArena
from paddle_tpu.runtime.capi_host import InferenceHost as JHost
from paddle_tpu_torch.runtime import HostArena
from paddle_tpu_torch.runtime.capi_host import DEVICE_ENV, InferenceHost
from paddle_tpu_torch.runtime.lib import CAPI_LIB_NAME, load_capi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def fresh_programs(monkeypatch):
    monkeypatch.setenv(DEVICE_ENV, "cpu")
    fluid.reset_default_programs()
    yield


def _lib():
    return load_capi().lib


def _export_model(tmp_path):
    x = fluid.layers.data("x", shape=(4,))
    h = fluid.layers.fc(x, 8, act="tanh")
    out = fluid.layers.fc(h, 2)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "model")
    fluid.io.export_inference_model(d, ["x"], [out], exe)
    xs = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    ref = np.asarray(exe.run(fluid.default_main_program(), feed={"x": xs},
                             fetch_list=[out])[0])
    return d, xs, ref


def _forward(lib, h, xs, out_elems=64):
    buf = np.ascontiguousarray(xs)
    inputs = (ctypes.c_void_p * 1)(buf.ctypes.data)
    shapes = (ctypes.c_longlong * 2)(*buf.shape)
    ndims = (ctypes.c_int * 1)(2)
    dtypes = (ctypes.c_int * 1)(0)
    out = np.zeros(out_elems, np.float32)
    out_shape = (ctypes.c_longlong * 8)()
    out_ndim = ctypes.c_int(0)
    rc = lib.pti_forward(
        h, inputs, shapes, ndims, dtypes, 1, 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_elems, out_shape, ctypes.byref(out_ndim))
    assert rc >= 0, lib.pti_last_error().decode()
    shape = tuple(out_shape[i] for i in range(out_ndim.value))
    return out[:rc].reshape(shape)


def test_capi_create_forward_destroy(tmp_path):
    lib = _lib()
    d, xs, ref = _export_model(tmp_path)
    h = lib.pti_create(d.encode())
    assert h, lib.pti_last_error().decode()
    got = _forward(lib, h, xs)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, JHost(d).run([xs]), **TOL)
    # the embedded host is the port's: on the CPU, as the variable says
    host = InferenceHost(d)
    assert host.exe.device.type == "cpu"
    np.testing.assert_array_equal(host.run([xs]), got)
    lib.pti_destroy(h)


def test_capi_create_bad_dir_reports_error():
    lib = _lib()
    h = lib.pti_create(b"/nonexistent/model/dir")
    assert not h
    assert lib.pti_last_error()


def test_capi_multi_thread(tmp_path):
    lib = _lib()
    d, xs, ref = _export_model(tmp_path)
    h = lib.pti_create(d.encode())
    assert h, lib.pti_last_error().decode()
    errs = []

    def worker():
        try:
            for _ in range(5):
                np.testing.assert_allclose(_forward(lib, h, xs), ref, **TOL)
        except Exception as e:   # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    lib.pti_destroy(h)


def test_capi_small_buffer_reports_size(tmp_path):
    lib = _lib()
    d, xs, _ = _export_model(tmp_path)
    h = lib.pti_create(d.encode())
    buf = np.ascontiguousarray(xs)
    inputs = (ctypes.c_void_p * 1)(buf.ctypes.data)
    shapes = (ctypes.c_longlong * 2)(*buf.shape)
    ndims = (ctypes.c_int * 1)(2)
    dtypes = (ctypes.c_int * 1)(0)
    out = np.zeros(1, np.float32)
    out_shape = (ctypes.c_longlong * 8)()
    out_ndim = ctypes.c_int(0)
    rc = lib.pti_forward(
        h, inputs, shapes, ndims, dtypes, 1, 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), 1,
        out_shape, ctypes.byref(out_ndim))
    assert rc == -2
    assert tuple(out_shape[i] for i in range(out_ndim.value)) == (3, 2)
    lib.pti_destroy(h)


def _build_and_run_c_example(tmp_path, name, argv, extra_cc=()):
    """Compile native/examples/<name>.c against the port's library and run
    it as its own process (its own embedded interpreter, on the CPU)."""
    if shutil.which("gcc") is None:
        pytest.skip("no C toolchain")
    build = load_capi()
    src = os.path.join(REPO, "native", "examples", name + ".c")
    exe = str(tmp_path / name)
    lib_dir = str(build.path)
    libname = CAPI_LIB_NAME[len("lib"):-len(".so")]
    cc = subprocess.run(
        ["gcc", src, "-o", exe, *extra_cc, "-L" + lib_dir, "-l" + libname,
         "-Wl,-rpath," + lib_dir], capture_output=True, text=True,
        timeout=120)
    assert cc.returncode == 0, cc.stderr
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, *site.getsitepackages(), env.get("PYTHONPATH", "")])
    env[DEVICE_ENV] = "cpu"
    return subprocess.run([exe, *argv], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)


def _rows(out):
    assert out.returncode == 0, out.stdout + out.stderr
    return [list(map(float, line.split()))
            for line in out.stdout.strip().splitlines()]


def test_c_example_program_standalone(tmp_path):
    d, _, _ = _export_model(tmp_path)
    n, dim = 3, 4
    rows = _rows(_build_and_run_c_example(tmp_path, "infer_dense",
                                          [d, str(n), str(dim)]))
    assert len(rows) == n and len(rows[0]) == 2
    x = (np.arange(n * dim) % 7).astype(np.float32) * 0.1 - 0.3
    ref = JHost(d).run([x.reshape(n, dim)])
    # the C program prints 6 significant digits
    np.testing.assert_allclose(np.asarray(rows), ref, rtol=1e-5, atol=1e-5)


def _export_sequence_model(tmp_path, vocab=40, emb=8, max_len=6):
    ids = fluid.layers.data("ids", shape=(max_len,), dtype="int32")
    lens = fluid.layers.data("lens", shape=(), dtype="int32")
    emb_out = fluid.layers.embedding(ids, size=(vocab, emb))
    pooled = fluid.layers.sequence_pool(emb_out, lens, pool_type="average")
    out = fluid.layers.fc(pooled, 3)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "seq_model")
    fluid.io.export_inference_model(d, ["ids", "lens"], [out], exe)
    return d


def test_c_example_sequence(tmp_path):
    batch, max_len, vocab = 3, 6, 40
    d = _export_sequence_model(tmp_path, vocab=vocab, max_len=max_len)
    rows = _rows(_build_and_run_c_example(
        tmp_path, "infer_sequence", [d, str(batch), str(max_len),
                                     str(vocab)]))
    assert len(rows) == batch and len(rows[0]) == 3
    ids = np.zeros((batch, max_len), np.int32)
    lens = np.zeros((batch,), np.int32)
    for b in range(batch):
        n = max(1, max_len - b)
        lens[b] = n
        for t in range(n):
            ids[b, t] = (b * 31 + t * 7) % vocab
    ref = JHost(d).run([ids, lens])
    np.testing.assert_allclose(np.asarray(rows), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(InferenceHost(d).run([ids, lens]), ref,
                               **TOL)


def _export_sparse_binary_model(tmp_path, dim=50, emb=6, max_nnz=5):
    ids = fluid.layers.data("ids", shape=(max_nnz,), dtype="int32")
    counts = fluid.layers.data("counts", shape=(), dtype="int32")
    emb_out = fluid.layers.embedding(ids, size=(dim, emb))
    summed = fluid.layers.sequence_pool(emb_out, counts, pool_type="sum")
    out = fluid.layers.fc(summed, 2)
    exe = fluid.Executor()
    exe.run(fluid.default_startup_program())
    d = str(tmp_path / "sb_model")
    fluid.io.export_inference_model(d, ["ids", "counts"], [out], exe)
    return d


def test_c_example_sparse_binary(tmp_path):
    batch, max_nnz, dim = 4, 5, 50
    d = _export_sparse_binary_model(tmp_path, dim=dim, max_nnz=max_nnz)
    rows = _rows(_build_and_run_c_example(
        tmp_path, "infer_sparse_binary",
        [d, str(batch), str(max_nnz), str(dim)]))
    assert len(rows) == batch and len(rows[0]) == 2
    ids = np.zeros((batch, max_nnz), np.int32)
    counts = np.zeros((batch,), np.int32)
    for b in range(batch):
        nnz = max_nnz - (b % max_nnz)
        counts[b] = nnz
        for j in range(nnz):
            ids[b, j] = (b * 13 + j * 5) % dim
    ref = JHost(d).run([ids, counts])
    np.testing.assert_allclose(np.asarray(rows), ref, rtol=1e-5, atol=1e-5)


def test_c_example_multi_thread(tmp_path):
    d, _, _ = _export_model(tmp_path)
    out = _build_and_run_c_example(
        tmp_path, "infer_multi_thread", [d, "4", "5", "3", "4"],
        extra_cc=("-pthread",))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "OK 4x5"


# -- the host arena -----------------------------------------------------------------

def _arena_trace(cls):
    """One allocation/free sequence: every offset, stats and refusal."""
    a = cls(total=1 << 12, min_block=256)
    out = []
    offs = [a.alloc(n) for n in (256, 256, 1024, 512, 300)]
    out += [offs, a.stats()]
    for o in (offs[1], offs[3]):
        a.free(o)
    out.append(a.stats())
    out.append([a.alloc(n) for n in (200, 512)])
    for o in offs[:1] + offs[2:3] + offs[4:] + out[-1]:
        a.free(o)
    out.append(a.stats())
    big = a.alloc(1 << 12)
    try:
        a.alloc(256)
    except MemoryError as e:
        out.append(str(e))
    a.free(big)
    try:
        a.free(12345)
    except ValueError as e:
        out.append(str(e))
    try:
        cls(total=3000, min_block=256)
    except ValueError as e:
        out.append(str(e))
    return out


def test_arena_alloc_free_equals_jax():
    got = _arena_trace(HostArena)
    assert got == _arena_trace(JArena)
    total, in_use, largest = got[4]
    assert in_use == 0 and largest == total == 1 << 12
    assert len(got[0]) == len(set(got[0]))
    assert len(got) == 8           # the three refusals were raised
    a = HostArena(total=1 << 12, min_block=256)
    assert len(a.buffer) == 1 << 12
