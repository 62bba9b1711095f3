"""The port's host runtime and chunk files (paddle_tpu_torch/runtime: the
host library's loader, ``TaskMaster``, ``RecordWriter``/``RecordReader``;
paddle_tpu_torch/data/chunks.py: ``dump_to_chunks``, ``chunk_reader``,
``cloud_reader``) against the JAX package's, on the CPU.

The port builds its own copy of the host library from ``native/``'s
sources into ``paddle_tpu_torch/_build/host-<hash>/``; the JAX package
loads ``native/``'s. Both copies live in this process side by side
(``ctypes.CDLL`` loads each with ``RTLD_LOCAL``): a chunk file written by
either reads in the other, and a ``TaskMaster`` of one never sees the
other's tasks. The master cases mirror tests/test_runtime.py:16-108,200,
the chunk cases tests/test_chunks.py (over the in-process ``TaskMaster``
and a scripted master: the RPC ``MasterServer`` is not ported) and
tests/test_faults.py:660-725. Everything here is exact: files are
compared byte for byte, rows with ``==``.
"""

import os
import pickle
import threading

import numpy as np
import pytest

import paddle_tpu.data.chunks as JC
import paddle_tpu.data.dataset as JDS
import paddle_tpu.faults as JF
import paddle_tpu.runtime as JR
import paddle_tpu_torch.data.chunks as PC
import paddle_tpu_torch.data.dataset as PDS
import paddle_tpu_torch.runtime as PR
from paddle_tpu_torch import faults
from paddle_tpu_torch.runtime import lib as plib
from paddle_tpu_torch.utils.retry import RetryPolicy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOTH = [pytest.param(JR, id="jax"), pytest.param(PR, id="port")]


# -- the host library ---------------------------------------------------------

def _native_sources():
    """mtime of each tracked file of native/ (the JAX package's ``make``
    may write its objects and library there meanwhile)."""
    d = os.path.join(ROOT, "native")
    return {n: os.path.getmtime(os.path.join(d, n)) for n in os.listdir(d)
            if n.endswith(".cc") or n == "Makefile"}


def test_the_port_builds_its_own_library_from_native_sources():
    before = _native_sources()
    build = plib.load()
    assert build.path.parent == plib.BUILD_ROOT
    assert build.path.name == f"host-{plib.source_hash()}"
    assert os.path.samefile(build.lib._name,
                            build.path / "libpaddle_tpu_host.so")
    assert plib.native_available()
    # native/'s sources untouched, and its .so is not what loaded
    assert _native_sources() == before
    assert not build.lib._name.startswith(os.path.join(ROOT, "native"))
    # the Makefile's sources and flags
    mk = open(os.path.join(ROOT, "native", "Makefile")).read()
    assert " ".join(plib.SOURCES) in mk
    assert "CXXFLAGS ?= " + " ".join(plib.CXXFLAGS) in mk


def test_racing_builds_publish_one_library(tmp_path):
    """Three processes that build into an empty build root at once (as
    test workers do) all load a library, and one directory is published,
    with no temporary directory left behind."""
    import subprocess
    import sys
    code = ("import sys; from pathlib import Path; "
            "from paddle_tpu_torch.runtime import lib; "
            "lib.BUILD_ROOT = Path(sys.argv[1]); b = lib.load(); "
            "assert b.lib.ptr_writer_open; print(b.path.name)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    names = {o.strip() for o, _ in outs}
    assert names == {f"host-{plib.source_hash()}"}
    assert sorted(os.listdir(tmp_path)) == sorted(names)


def test_the_hash_tracks_sources_and_flags(monkeypatch):
    h = plib.source_hash()
    assert len(h) == 16 and h == plib.source_hash()
    monkeypatch.setattr(plib, "CXXFLAGS", plib.CXXFLAGS + ["-DX"])
    assert plib.source_hash() != h


def test_a_failed_build_raises_with_the_compilers_log(tmp_path,
                                                      monkeypatch):
    src = tmp_path / "native"
    src.mkdir()
    for name in plib.SOURCES:
        (src / name).write_text("int ok_%s() { return 0; }\n"
                                % name.split(".")[0])
    (src / "recordio.cc").write_text("int broken( { return 0; }\n")
    monkeypatch.setattr(plib, "NATIVE", src)
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(plib.HostCompileError, match="recordio.cc") as ei:
        plib._compile(out)
    assert "error" in str(ei.value)
    monkeypatch.setattr(plib.shutil, "which", lambda name: None)
    with pytest.raises(plib.HostCompileError, match="g\\+\\+ not found"):
        plib._compile(out)


# -- TaskMaster, both packages ------------------------------------------------

@pytest.mark.parametrize("R", BOTH)
def test_master_dispatch_cycle(R):
    m = R.TaskMaster(timeout_s=60, failure_max=3)
    m.set_dataset([f"chunk-{i}" for i in range(4)])
    seen = []
    while True:
        t = m.get_task(now=0.0)
        if t is None:
            break
        seen.append(t[1])
        m.task_finished(t[0])
    assert sorted(seen) == [f"chunk-{i}" for i in range(4)]
    assert m.pass_finished()
    assert m.new_pass()
    assert m.stats() == (4, 0, 0, 0, 1)


@pytest.mark.parametrize("R", BOTH)
def test_master_timeout_requeue_and_discard(R):
    m = R.TaskMaster(timeout_s=10, failure_max=2)
    m.set_dataset(["a"])
    tid, payload = m.get_task(now=0.0)
    assert payload == "a"
    assert m.tick(now=5.0) == 0
    assert m.tick(now=11.0) == 1
    m.get_task(now=12.0)
    assert m.tick(now=30.0) == 1
    assert m.stats() == (0, 0, 0, 1, 0)


@pytest.mark.parametrize("R", BOTH)
def test_master_explicit_failure(R):
    m = R.TaskMaster(timeout_s=60, failure_max=3)
    m.set_dataset(["x"])
    tid, _ = m.get_task(now=0.0)
    assert m.task_failed(tid) is False
    tid, _ = m.get_task(now=1.0)
    assert m.task_failed(tid) is False
    tid, _ = m.get_task(now=2.0)
    assert m.task_failed(tid) is True


def _snapshot(R, path):
    m = R.TaskMaster(timeout_s=60, failure_max=3)
    m.set_dataset([f"c{i}" for i in range(6)])
    t1 = m.get_task(now=0.0)
    t2 = m.get_task(now=0.0)
    m.task_finished(t1[0])
    m.snapshot(path)
    return t2


def test_master_snapshot_restore_across_packages(tmp_path):
    """Each package's snapshot is the same bytes and restores in the
    other: the pending task is re-queued, the finished one kept."""
    t2 = _snapshot(PR, str(tmp_path / "port.snap"))
    assert _snapshot(JR, str(tmp_path / "jax.snap")) == t2
    assert open(tmp_path / "port.snap", "rb").read() == \
        open(tmp_path / "jax.snap", "rb").read()
    for R, snap in ((JR, "port.snap"), (PR, "jax.snap")):
        m2 = R.TaskMaster(timeout_s=60, failure_max=3)
        m2.restore(str(tmp_path / snap))
        assert m2.stats() == (5, 0, 1, 0, 0)
        payloads = []
        while True:
            t = m2.get_task(now=0.0)
            if t is None:
                break
            payloads.append(t[1])
            m2.task_finished(t[0])
        assert t2[1] in payloads and len(payloads) == 5
    with pytest.raises(IOError, match="restore"):
        PR.TaskMaster().restore(str(tmp_path / "missing.snap"))


def test_master_threaded_consumers():
    m = PR.TaskMaster(timeout_s=60, failure_max=3)
    m.set_dataset([f"c{i}" for i in range(64)])
    got = []
    lock = threading.Lock()

    def worker():
        while True:
            t = m.get_task(now=0.0)
            if t is None:
                return
            with lock:
                got.append(t[1])
            m.task_finished(t[0])

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(got) == sorted(f"c{i}" for i in range(64))


def test_master_large_payload_not_truncated():
    m = PR.TaskMaster(timeout_s=60, failure_max=3)
    big = "p" * 20000
    m.set_dataset([big])
    tid, payload = m.get_task(now=0.0)
    assert payload == big
    m.task_finished(tid)
    assert m.pass_finished()


def test_masters_of_the_two_packages_are_separate():
    """Two copies of the C library in one process keep their own state: a
    task set in one package's master is never handed out by the
    other's."""
    jm, pm = JR.TaskMaster(), PR.TaskMaster()
    assert JR.load_library()._name != PR.load_library()._name
    jm.set_dataset(["jax-0", "jax-1"])
    assert pm.get_task(now=0.0) is None
    assert pm.stats() == (0, 0, 0, 0, 0)
    pm.set_dataset(["port-0"])
    assert pm.get_task(now=0.0)[1] == "port-0"
    assert sorted(jm.get_task(now=0.0)[1] for _ in range(2)) == \
        ["jax-0", "jax-1"]
    assert jm.stats() == (0, 2, 0, 0, 0) and pm.stats() == (0, 1, 0, 0, 0)


# -- recordio -----------------------------------------------------------------

def test_recordio_roundtrip_corruption_and_cross_read(tmp_path):
    payloads = [b"hello", b"", b"x" * 10000, bytes(range(256)),
                b"y" * (1 << 21)]                      # past the 1 MiB buffer
    paths = {}
    for name, R in (("jax", JR), ("port", PR)):
        paths[name] = str(tmp_path / f"{name}.ptr")
        with R.RecordWriter(paths[name]) as w:
            for p in payloads:
                w.write(p)
    assert open(paths["jax"], "rb").read() == open(paths["port"], "rb").read()
    for src, R in (("jax", PR), ("port", JR)):
        with R.RecordReader(paths[src]) as r:
            assert list(r) == payloads
    raw = bytearray(open(paths["port"], "rb").read())
    raw[4 + 8 + 2] ^= 0xFF
    open(paths["port"], "wb").write(bytes(raw))
    with PR.RecordReader(paths["port"]) as r:
        with pytest.raises(IOError, match="corrupt record"):
            list(r)
    with pytest.raises(IOError, match="cannot open"):
        PR.RecordReader(str(tmp_path / "missing.ptr"))


# -- chunk files --------------------------------------------------------------

def _rows(seed=0, n=70):
    """Rows like the flagship's: (ids list, label, [scale])."""
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, 30000, int(rs.randint(30, 101))).tolist(),
             int(rs.randint(0, 2)), [1.0]) for _ in range(n)]


@pytest.mark.parametrize("per_chunk", [16, 70, 128])
def test_chunk_files_are_byte_identical_and_cross_read(tmp_path, per_chunk):
    rows = _rows()
    got = PC.dump_to_chunks(lambda: iter(rows), str(tmp_path / "port"),
                            samples_per_chunk=per_chunk)
    want = JC.dump_to_chunks(lambda: iter(rows), str(tmp_path / "jax"),
                             samples_per_chunk=per_chunk)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    assert len(got) == -(-len(rows) // per_chunk)
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    assert list(PC.chunk_reader(want)()) == rows
    assert list(JC.chunk_reader(got)()) == rows
    assert list(PC.chunk_reader(got)()) == rows


def test_dump_and_chunk_reader_roundtrip_over_the_datasets(tmp_path):
    """tests/test_chunks.py's mnist round trip, each package's synthetic
    mnist through its own chunks: the same files."""
    got = PC.dump_to_chunks(PDS.mnist.train(100), str(tmp_path / "p"),
                            samples_per_chunk=32)
    want = JC.dump_to_chunks(JDS.mnist.train(100), str(tmp_path / "j"),
                             samples_per_chunk=32)
    assert len(got) == 4                            # 32 + 32 + 32 + 4
    for a, b in zip(got, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    back = list(PC.chunk_reader(got)())
    orig = list(PDS.mnist.train(100)())
    assert len(back) == 100
    for (x, y), (xo, yo) in zip(back, orig):
        np.testing.assert_array_equal(x, xo)
        assert y == yo
    assert pickle.loads(pickle.dumps(back[0], protocol=4))[1] == orig[0][1]


# -- cloud_reader -------------------------------------------------------------

class FakeMaster:
    """Scripted in-process master (tests/test_faults.py:660)."""

    def __init__(self, tasks):
        self.todo = dict(tasks)
        self.pending = {}
        self.failed = []
        self.finished = []

    def get_task(self):
        if not self.todo:
            return None
        tid, payload = next(iter(self.todo.items()))
        self.pending[tid] = self.todo.pop(tid)
        return tid, payload

    def stats(self):
        return len(self.todo), len(self.pending), len(self.finished), 0, 0

    def task_failed(self, tid):
        self.todo[tid] = self.pending.pop(tid)
        self.failed.append(tid)
        return False

    def task_finished(self, tid):
        self.finished.append(self.pending.pop(tid))

    def new_pass(self):
        return False


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cloud_reader_task_failure_redispatches(tmp_path, pkg):
    C, F = (JC, JF) if pkg == "jax" else (PC, faults)
    paths = C.dump_to_chunks(lambda: iter(range(10)), str(tmp_path / "c"),
                             samples_per_chunk=5)
    assert len(paths) == 2
    master = FakeMaster({i: p for i, p in enumerate(paths)})
    plan = F.FaultPlan()
    plan.add("reader.next", "raise", nth=1, exc=OSError("injected"))
    with plan.installed():
        got = sorted(C.cloud_reader(master)())
    assert got == list(range(10))
    assert master.failed == [0]
    assert len(master.finished) == 2


def test_cloud_reader_over_the_task_master(tmp_path):
    """The chunks through the port's ``TaskMaster``: a failure injected at
    the first task re-queues it; every row arrives exactly once (as a
    multiset: the re-dispatch changes the order), the pass ends with
    every task done, and ``new_pass_at_end`` starts the next pass."""
    rows = _rows(n=64)
    paths = PC.dump_to_chunks(lambda: iter(rows), str(tmp_path / "c"),
                              samples_per_chunk=16)
    m = PR.TaskMaster(timeout_s=600, failure_max=3)
    m.set_dataset(paths)
    plan = faults.FaultPlan()
    plan.add("reader.next", "raise", nth=1, exc=OSError("injected"))
    with plan.installed():
        got = list(PC.cloud_reader(m, new_pass_at_end=True)())
    assert sorted(map(repr, got)) == sorted(map(repr, rows))
    assert got != rows                          # the first task came last
    assert got[:48] == rows[16:] and got[48:] == rows[:16]
    assert plan.fired == [("reader.next", 1, "raise")]
    assert plan.hits == {"reader.next": 5}       # 4 tasks + the re-dispatch
    assert m.stats() == (4, 0, 0, 0, 1)          # the next pass is queued
    assert list(PC.chunk_reader(paths)()) == rows


def test_cloud_reader_discards_a_corrupt_chunk(tmp_path):
    rows = _rows(n=48)
    paths = PC.dump_to_chunks(lambda: iter(rows), str(tmp_path / "c"),
                              samples_per_chunk=16)
    raw = bytearray(open(paths[1], "rb").read())
    raw[20] ^= 0xFF
    open(paths[1], "wb").write(bytes(raw))
    m = PR.TaskMaster(timeout_s=600, failure_max=2)
    m.set_dataset(paths)
    got = list(PC.cloud_reader(m)())
    # the corrupt chunk is retried, then discarded; a row read before the
    # damage may arrive more than once, none of the others is lost
    assert all(r in got for r in rows[:16] + rows[32:])
    assert m.stats()[3] == 1


def _fake_time():
    t = [0.0]

    def sleep(s):
        t[0] += s

    return sleep, (lambda: t[0]), t


def test_cloud_reader_starvation_deadline_no_real_sleep():
    sleep, clock, t = _fake_time()

    class Starver:
        def get_task(self):
            return None

        def stats(self):
            return (0, 1, 0, 0, 0)          # pending forever, never done

    # the caller's policy need not name the reader's private marker
    policy = RetryPolicy(max_attempts=None, base_delay=0.1, multiplier=1.5,
                         max_delay=1.0, deadline=30.0, jitter=0.0,
                         sleep=sleep, clock=clock)
    with pytest.raises(TimeoutError, match="starved"):
        list(PC.cloud_reader(Starver(), poll_policy=policy)())
    assert 0.0 < t[0] <= 30.0
    assert policy.observer is None


def test_cloud_reader_polls_while_another_consumer_holds_tasks(tmp_path):
    """Idle polls back off on the fake clock until the other consumer's
    task is finished, then the pass ends."""
    sleep, clock, t = _fake_time()
    paths = PC.dump_to_chunks(lambda: iter(range(4)), str(tmp_path / "c"),
                              samples_per_chunk=2)
    m = PR.TaskMaster(timeout_s=600)
    m.set_dataset(paths)
    held = m.get_task()
    polls = []

    def sleep_and_release(s):
        sleep(s)
        polls.append(s)
        if len(polls) == 3:
            m.task_finished(held[0])

    policy = RetryPolicy(max_attempts=None, base_delay=0.1, deadline=60.0,
                         jitter=0.0, sleep=sleep_and_release, clock=clock)
    got = list(PC.cloud_reader(m, poll_policy=policy)())
    assert len(got) == 2 and len(polls) == 3
    assert m.pass_finished()
