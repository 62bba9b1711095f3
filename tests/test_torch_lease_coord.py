"""The port's master election and fencing plane (paddle_tpu_torch/runtime:
``lease.py``, ``coord.py`` and ``MasterServer(lease=, snapshot_path=,
snapshot_store=)``) — the cases of tests/test_coord.py and the lease,
snapshot and failover cases of tests/test_master_service.py (:119, :150,
:206, :268, :295), over the port's own build of the host library.

Cross-package checks beside them: the lease file, the snapshot file and
the coordination frames are JAX's, so a JAX lease blocks the port's
contender, a snapshot either package's master wrote restores in the
other's, and a port ``NetworkLease`` is served by JAX's ``CoordServer``.
The coordination service of the subprocess cases is the port's own
(``python -m paddle_tpu_torch.runtime.coord``). Everything is exact.
"""

from __future__ import annotations

import os
import socket as _socket
import subprocess
import sys
import time

import pytest

import paddle_tpu.runtime as JR
from paddle_tpu_torch.runtime import (CoordServer, FileLease,
                                      NetworkFencedStore, NetworkLease,
                                      TaskMaster)
from paddle_tpu_torch.runtime.master_service import MasterClient, MasterServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def coord_proc():
    """The port's CoordServer in its own process (a real network
    boundary); the subprocess imports no JAX."""
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.runtime.coord"],
        stdout=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        line = p.stdout.readline().split()
        assert line and line[0] == "LISTENING"
        yield line[1], int(line[2])
    finally:
        p.terminate()
        p.wait(timeout=20)


def free_port():
    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_coord_module_entry_imports_no_jax():
    """The coordination service's module serves, importing nothing of
    JAX."""
    env = dict(os.environ, PYTHONPATH=REPO)
    p = subprocess.Popen(
        [sys.executable, "-c",
         "import sys; import paddle_tpu_torch.runtime.coord as c; "
         "assert not any(m == 'jax' or m.startswith(('jax.', 'paddle_tpu.'))"
         " for m in sys.modules); c.main()"],
        stdout=subprocess.PIPE, text=True, cwd=REPO, env=env)
    try:
        line = p.stdout.readline().split()
        assert line[0] == "LISTENING"
        lease = NetworkLease(line[1], int(line[2]), owner="probe", ttl=5.0)
        assert lease.try_acquire() and lease.token >= 1
        lease.close()
    finally:
        p.terminate()
        p.wait(timeout=20)


# -- tests/test_coord.py -------------------------------------------------------

def test_network_lease_tokens_monotonic_and_ttl(coord_proc):
    host, port = coord_proc
    a = NetworkLease(host, port, owner="a", ttl=5.0)
    assert a.try_acquire()
    t1 = a.token
    assert t1 is not None and t1 >= 1
    assert a.held_by_me()
    assert a.current_token() == t1
    b = NetworkLease(host, port, owner="b", ttl=5.0)
    assert not b.try_acquire()
    a.release()
    assert a.token is None
    assert b.try_acquire()
    assert b.token > t1
    c = NetworkLease(host, port, owner="c", ttl=0.3)
    b.release()
    assert c.try_acquire()
    time.sleep(0.5)
    d = NetworkLease(host, port, owner="d", ttl=5.0)
    assert d.try_acquire()
    assert d.token > c.token
    for lease in (a, b, c, d):
        lease.close()


def test_master_failover_network_lease_no_shared_fs(coord_proc):
    host, port = coord_proc
    pa, pb = free_port(), free_port()
    lease_a = NetworkLease(host, port, owner="master-a", ttl=0.6)
    a = MasterServer(port=pa, snapshot_store=NetworkFencedStore(host, port),
                     tick_interval=0.05, lease=lease_a).start()
    client = MasterClient(endpoints=[("127.0.0.1", pa), ("127.0.0.1", pb)])
    try:
        client.set_dataset(["chunk-0", "chunk-1", "chunk-2"])
        assert client.get_task() is not None
        time.sleep(0.2)
        a.stop(release_lease=False)
        lease_b = NetworkLease(host, port, owner="master-b", ttl=0.6)
        assert not lease_b.try_acquire()
        assert lease_b.wait_acquire(poll=0.1, timeout=10)
        b = MasterServer(port=pb, snapshot_store=NetworkFencedStore(host,
                                                                    port),
                         tick_interval=0.05, lease=lease_b).start()
        try:
            assert b.fence_token > a.fence_token
            seen = set()
            for _ in range(6):
                t = client.get_task()
                if t is None:
                    break
                seen.add(t[1])
                client.task_finished(t[0])
            assert seen == {"chunk-0", "chunk-1", "chunk-2"}
        finally:
            b.stop()
    finally:
        client.close()


def test_deposed_master_network_writes_are_fenced(coord_proc):
    host, port = coord_proc
    pa, pb = free_port(), free_port()
    lease_a = NetworkLease(host, port, owner="master-a", ttl=0.5)
    a = MasterServer(port=pa, snapshot_store=NetworkFencedStore(host, port),
                     tick_interval=60.0, lease=lease_a).start()
    ca = MasterClient("127.0.0.1", pa)
    try:
        ca.set_dataset(["chunk-0", "chunk-1"])
        assert a.try_snapshot()
        a._keeper.stop(release=False)
        a._keeper = None
        lease_b = NetworkLease(host, port, owner="master-b", ttl=5.0)
        deadline = time.time() + 10
        while not lease_b.try_acquire():
            assert time.time() < deadline
            time.sleep(0.1)
        store_b = NetworkFencedStore(host, port)
        b = MasterServer(port=pb, snapshot_store=store_b,
                         tick_interval=60.0, lease=lease_b).start()
        try:
            assert b.fence_token > a.fence_token
            assert b.try_snapshot()
            assert not a.try_snapshot()
            assert store_b._recorded() == b.fence_token
            r = a._dispatch({"op": "set_dataset", "payloads": ["rogue"]})
            assert r["ok"] is False and "fenced" in r["error"]
            r = a._dispatch({"op": "task_finished", "task_id": 0})
            assert r["ok"] is False
            assert a._dispatch({"op": "stats"})["ok"] is True
        finally:
            b.stop()
    finally:
        ca.close()
        a.stop(release_lease=False)


def test_blob_store_roundtrip_and_fencing(tmp_path):
    srv = CoordServer().start()
    try:
        host, port = srv.address
        st = NetworkFencedStore(host, port, key="k")
        assert st.fetch_to(os.devnull) is False
        assert st.write(3, lambda p: open(p, "w").write("gen3"))
        assert not st.write(2, lambda p: open(p, "w").write("stale"))
        out = str(tmp_path / "blob")
        assert st.fetch_to(out)
        assert open(out).read() == "gen3"
        st.close()
    finally:
        srv.stop()


def test_coord_server_survives_hostile_frames():
    import json
    import socket
    import struct

    from paddle_tpu_torch.runtime.master_service import _recv_exact
    srv = CoordServer().start()
    try:
        addr = srv.address

        def raw(payload: bytes, half_close: bool = False):
            s = socket.create_connection(addr, timeout=10.0)
            try:
                s.sendall(payload)
                if half_close:
                    s.shutdown(socket.SHUT_WR)
                hdr = _recv_exact(s, 4)
                if hdr is None:
                    return None
                (n,) = struct.unpack("<I", hdr)
                return _recv_exact(s, n)
            finally:
                s.close()

        def frame(obj) -> bytes:
            body = json.dumps(obj).encode()
            return struct.pack("<I", len(body)) + body

        r = json.loads(raw(frame({"op": "no_such_op"})))
        assert r["ok"] is False and "unknown op" in r["error"]
        raw(struct.pack("<I", 12) + b"not-json-at!")
        raw(struct.pack("<I", 100) + b"short", half_close=True)
        assert raw(struct.pack("<I", 1 << 30), half_close=True) is None
        lease = NetworkLease(addr[0], addr[1], "jobs/master", owner="m-a",
                             ttl=5.0)
        try:
            assert lease.try_acquire()
            assert lease.holder()[0] == "m-a"
            lease.release()
        finally:
            lease.close()
    finally:
        srv.stop()


# -- tests/test_master_service.py ---------------------------------------------------

def test_snapshot_written_and_recovered(tmp_path):
    snap = str(tmp_path / "m.snap")
    srv = MasterServer(timeout_s=1.0, failure_max=3, snapshot_path=snap,
                       tick_interval=0.2).start()
    try:
        c = MasterClient(*srv.address)
        c.set_dataset(["a", "b", "c"])
        t = c.get_task()
        c.task_finished(t[0])
        time.sleep(0.5)
        c.close()
    finally:
        srv.stop()
    srv2 = MasterServer(timeout_s=1.0, snapshot_path=snap,
                        tick_interval=0.2).start()
    try:
        c2 = MasterClient(*srv2.address)
        todo, pending, done, disc, epoch = c2.stats()
        assert done == 1 and todo == 2 and pending == 0
        c2.close()
    finally:
        srv2.stop()
    # the snapshot is JAX's file: JAX's master restores it
    jsrv = JR.master_service.MasterServer(timeout_s=1.0,
                                          snapshot_path=snap,
                                          tick_interval=0.2).start()
    try:
        assert jsrv.master.stats()[:3] == (2, 0, 1)
    finally:
        jsrv.stop()


def test_master_failover_lease_election(tmp_path):
    pa, pb = free_port(), free_port()
    lease_path = str(tmp_path / "master.lease")
    snap = str(tmp_path / "master.snap")
    lease_a = FileLease(lease_path, owner="master-a", ttl=0.6)
    a = MasterServer(port=pa, snapshot_path=snap, tick_interval=0.05,
                     lease=lease_a).start()
    client = MasterClient(endpoints=[("127.0.0.1", pa), ("127.0.0.1", pb)])
    try:
        client.set_dataset(["chunk-0", "chunk-1", "chunk-2"])
        assert client.get_task() is not None
        time.sleep(0.2)
        a.stop(release_lease=False)
        lease_b = FileLease(lease_path, owner="master-b", ttl=0.6)
        assert not lease_b.try_acquire()
        assert lease_b.wait_acquire(poll=0.1, timeout=10)
        b = MasterServer(port=pb, snapshot_path=snap, tick_interval=0.05,
                         lease=lease_b).start()
        try:
            seen = set()
            for _ in range(6):
                t = client.get_task()
                if t is None:
                    break
                seen.add(t[1])
                client.task_finished(t[0])
            assert seen == {"chunk-0", "chunk-1", "chunk-2"}
        finally:
            b.stop()
    finally:
        client.close()


def test_snapshot_crc_detects_corruption(tmp_path):
    snap = str(tmp_path / "m.snap")
    m = TaskMaster()
    m.set_dataset(["alpha", "beta"])
    m.snapshot(snap)
    m2 = TaskMaster()
    m2.restore(snap)
    assert m2.stats()[0] == 2
    raw = bytearray(open(snap, "rb").read())
    raw[-3] ^= 0xFF
    open(snap, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        TaskMaster().restore(snap)
    with pytest.raises(IOError):
        JR.TaskMaster().restore(snap)


def test_lease_fencing_token_monotonic(tmp_path):
    path = str(tmp_path / "l.lease")
    a = FileLease(path, owner="a", ttl=5.0)
    assert a.try_acquire()
    t1 = a.token
    assert t1 is not None and t1 >= 1
    a.release()
    assert a.token is None
    b = FileLease(path, owner="b", ttl=5.0)
    assert b.try_acquire()
    assert b.token > t1
    assert b.current_token() == b.token
    b2 = FileLease(path, owner="b2", ttl=5.0)
    assert not b2.try_acquire()
    c = FileLease(path, owner="c", ttl=5.0)
    assert c.try_acquire(now=time.time() + 10.0)
    assert c.token > b.token


def test_deposed_master_writes_are_fenced(tmp_path):
    pa, pb = free_port(), free_port()
    lease_path = str(tmp_path / "master.lease")
    snap = str(tmp_path / "master.snap")
    lease_a = FileLease(lease_path, owner="master-a", ttl=0.5)
    a = MasterServer(port=pa, snapshot_path=snap, tick_interval=60.0,
                     lease=lease_a).start()
    ca = MasterClient("127.0.0.1", pa)
    try:
        ca.set_dataset(["chunk-0", "chunk-1"])
        assert a.try_snapshot()
        a._keeper.stop(release=False)
        a._keeper = None
        deadline = time.time() + 10
        lease_b = FileLease(lease_path, owner="master-b", ttl=5.0)
        while not lease_b.try_acquire():
            assert time.time() < deadline
            time.sleep(0.1)
        b = MasterServer(port=pb, snapshot_path=snap, tick_interval=60.0,
                         lease=lease_b).start()
        try:
            assert b.fence_token > a.fence_token
            assert b.try_snapshot()
            gen_b = open(snap, "rb").read()
            assert not a.try_snapshot()
            assert open(snap, "rb").read() == gen_b
            r = a._dispatch({"op": "set_dataset", "payloads": ["rogue"]})
            assert r["ok"] is False and "fenced" in r["error"]
            r = a._dispatch({"op": "task_finished", "task_id": 0})
            assert r["ok"] is False
            assert a._dispatch({"op": "stats"})["ok"] is True
        finally:
            b.stop()
    finally:
        ca.close()
        a.stop(release_lease=False)


# -- across the packages ------------------------------------------------------------

def test_leases_and_snapshots_interoperate_with_jax(tmp_path):
    """The lease and epoch files are JAX's: a JAX holder blocks the port's
    contender and the port's next token continues JAX's counter; a port
    master's snapshot, fenced with the port's token, restores in a JAX
    master, and a JAX coordination service serves the port's lease."""
    path = str(tmp_path / "shared.lease")
    j = JR.FileLease(path, owner="jax-master", ttl=5.0)
    assert j.try_acquire()
    t = FileLease(path, owner="port-master", ttl=5.0)
    assert not t.try_acquire()
    assert t.holder()[0] == "jax-master"
    j.release()
    assert t.try_acquire() and t.token > j.current_token() - 1
    t.release()
    jsrv = JR.CoordServer().start()
    try:
        lease = NetworkLease(*jsrv.address, owner="port", ttl=5.0)
        assert lease.try_acquire() and lease.token >= 1
        jl = JR.NetworkLease(*jsrv.address, owner="jax", ttl=5.0)
        assert not jl.try_acquire()
        lease.release()
        assert jl.try_acquire() and jl.token > 1
        jl.close()
        lease.close()
    finally:
        jsrv.stop()
