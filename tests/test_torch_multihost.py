"""``parallel.multihost`` of the port: ``initialize`` joins the world from
the launcher's ``PADDLE_TPU_{COORDINATOR,NUM_PROCESSES,PROCESS_ID}`` (as
JAX's reads them) in separate processes, returns JAX's summary keys,
and installs the SIGTERM teardown (exit code 17 after the hooks); the
per-process batch helpers assemble the global batch.

Each process is a fresh ``python`` (torch only) on the CPU over gloo;
every wait has a time limit and no process outlives its test."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 90

SCRIPT = r"""
import json, os, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
from paddle_tpu_torch.parallel import multihost as mh
from paddle_tpu_torch.parallel.sharding import to_global
summary = mh.initialize(backend="gloo")
mesh = mh.global_mesh(data=-1, device="cpu")
sl = mh.process_batch_slice(8)
rows = np.arange(24, dtype=np.float32).reshape(8, 3)[sl]
(batch,) = mh.make_global_batch(mesh, (rows,))
rep = mh.replicate_from_host(mesh, {"w": np.ones(3, np.float32)})
print(json.dumps({"summary": summary, "slice": [sl.start, sl.stop],
                  "local": batch.to_local().tolist(),
                  "global": to_global(batch).tolist(),
                  "rep": to_global(rep["w"]).tolist(),
                  "jax": "jax" in sys.modules}), flush=True)
if os.environ.get("TEARDOWN_TEST"):
    mh.on_job_teardown(lambda: print("HOOK RAN", flush=True))
    print("READY", flush=True)
    signal.pause()
import torch.distributed as dist
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(n, extra_env=None):
    port = _free_port()
    procs = []
    for i in range(n):
        env = dict(os.environ, PADDLE_TPU_COORDINATOR=f"127.0.0.1:{port}",
                   PADDLE_TPU_NUM_PROCESSES=str(n),
                   PADDLE_TPU_PROCESS_ID=str(i), PYTHONPATH=ROOT,
                   OMP_NUM_THREADS="1", **(extra_env or {}))
        env.pop("JAX_PLATFORMS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", SCRIPT], env=env, cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10)


def test_initialize_from_the_environment_joins_a_world_of_four():
    """Four processes join one world from PADDLE_TPU_*: each reports JAX's
    summary keys with its index, builds the data=4 mesh, and assembles
    the global batch from its rows (process_batch_slice)."""
    procs = _launch(4)
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        _kill(procs)
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    for i, (out, _) in enumerate(outs):
        res = json.loads(out.strip().splitlines()[-1])
        assert res["summary"] == {"process_index": i, "process_count": 4,
                                  "local_devices": 1, "global_devices": 4}
        assert res["slice"] == [2 * i, 2 * i + 2]
        np.testing.assert_array_equal(res["local"], full[2 * i:2 * i + 2])
        np.testing.assert_array_equal(res["global"], full)
        assert res["rep"] == [1.0, 1.0, 1.0]
        assert not res["jax"]


def test_summary_keys_are_jaxs_and_alone_it_is_a_no_op():
    """With nothing configured initialize() joins nothing and returns
    JAX's keys for one process alone."""
    from paddle_tpu.parallel import multihost as jmh

    from paddle_tpu_torch.parallel import multihost as mh
    for key in ("PADDLE_TPU_COORDINATOR", "PADDLE_TPU_NUM_PROCESSES",
                "PADDLE_TPU_PROCESS_ID"):
        assert key not in os.environ
    got = mh.initialize()
    assert set(got) == set(jmh.initialize())
    assert got == {"process_index": 0, "process_count": 1,
                   "local_devices": 1, "global_devices": 1}
    assert mh.TEARDOWN_EXIT_CODE == jmh.TEARDOWN_EXIT_CODE == 17


def test_sigterm_runs_the_teardown_hooks_and_exits_17():
    """SIGTERM to a joined worker runs its teardown hooks and exits with
    TEARDOWN_EXIT_CODE."""
    procs = _launch(1, {"TEARDOWN_TEST": "1"})
    p = procs[0]
    try:
        deadline = time.monotonic() + TIMEOUT_S
        lines = []
        while time.monotonic() < deadline:
            line = p.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("READY"):
                break
        assert lines and lines[-1].startswith("READY"), \
            (lines, p.stderr.read() if p.poll() is not None else "")
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=TIMEOUT_S)
    finally:
        _kill(procs)
    assert p.returncode == 17, err
    assert "HOOK RAN" in out
    assert "teardown" in err
