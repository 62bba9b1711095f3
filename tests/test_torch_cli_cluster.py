"""The port's ``cluster_train``, ``cluster autoscale`` and ``train
--elastic`` subcommands on the CPU — the counterparts of
tests/test_cluster_launcher.py, test_cli_and_export.py's --hosts warning
case, test_fleet_actor.py's CLI cases and test_elastic.py's CLI smoke.

The workers are torch-only scripts (tests/torch_cluster_{train,restart,
death}_script.py) joining one gloo world on the CPU through
``multihost.initialize`` and PADDLE_TPU_*. A worker of the port is one
rank of one device, so ``--num_workers 4`` stands in for JAX's two
workers of ``--devices_per_worker 2``, and a value above 1 is refused.
The ``--hosts`` dry-run lines are held string for string to JAX's."""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu.cli import main as jax_main
from paddle_tpu_torch.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
SCRIPT = os.path.join(TESTS, "torch_cluster_train_script.py")


@pytest.fixture(autouse=True)
def _importable(monkeypatch):
    """Worker processes find the package from any working directory."""
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))


def test_cluster_train_four_workers():
    rc = cli_main(["cluster_train", SCRIPT, "--num_workers", "4",
                   "--timeout", "120"])
    assert rc == 0


def test_cluster_train_refuses_devices_per_worker_above_one(capsys):
    rc = cli_main(["cluster_train", SCRIPT, "--num_workers", "2",
                   "--devices_per_worker", "2"])
    assert rc == 2
    assert "one rank with one device" in capsys.readouterr().err


def test_cluster_train_propagates_failure(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import sys; sys.exit(3)\n")
    rc = cli_main(["cluster_train", str(bad), "--num_workers", "2",
                   "--devices_per_worker", "1", "--timeout", "60"])
    assert rc != 0


def test_cluster_restart_on_failure_resumes_and_matches(tmp_path,
                                                        monkeypatch):
    """Rank 1 SIGKILLs itself mid-job on attempt 0; with
    --restart-on-failure the launcher relaunches the whole job on a fresh
    coordinator, the workers resume from the latest pass checkpoint,
    training completes (rc 0), and the final parameters equal an
    uninterrupted run's (JAX's tolerance: the 2-rank reduction order
    against one rank's)."""
    script = os.path.join(TESTS, "torch_cluster_restart_script.py")
    kill_dir = tmp_path / "killed"
    kill_dir.mkdir()
    monkeypatch.setenv("RESTART_TEST_DIR", str(kill_dir))
    rc = cli_main(["cluster_train", script, "--num_workers", "2",
                   "--timeout", "120", "--grace", "20",
                   "--restart-on-failure", "2"])
    assert rc == 0
    assert (kill_dir / "final.npz").exists()

    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    env = dict(os.environ, RESTART_TEST_DIR=str(ref_dir),
               PADDLE_TPU_RESTART_COUNT="1")   # never self-kill
    for k in ("PADDLE_TPU_COORDINATOR", "PADDLE_TPU_NUM_PROCESSES",
              "PADDLE_TPU_PROCESS_ID"):
        env.pop(k, None)
    subprocess.run([sys.executable, script], env=env, check=True,
                   timeout=120)
    got = np.load(kill_dir / "final.npz")
    ref = np.load(ref_dir / "final.npz")
    np.testing.assert_allclose(got["w"], ref["w"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["b"], ref["b"], rtol=1e-5, atol=1e-7)


def test_cluster_worker_death_reaps_job_cleanly(tmp_path, monkeypatch):
    """SIGKILL one worker mid-run: the launcher reaps the job promptly
    with a nonzero rc, and the survivor exits through its teardown hook
    (marker written), not SIGKILLed; the dead worker never reaches its
    hook."""
    script = os.path.join(TESTS, "torch_cluster_death_script.py")
    monkeypatch.setenv("DEATH_TEST_DIR", str(tmp_path))
    t0 = time.time()
    rc = cli_main(["cluster_train", script, "--num_workers", "2",
                   "--timeout", "120", "--grace", "20"])
    elapsed = time.time() - t0
    assert rc != 0
    assert elapsed < 60, elapsed
    assert (tmp_path / "clean-exit-0").exists()
    assert not (tmp_path / "clean-exit-1").exists()


# -- multi-host mode: the rendered commands are JAX's ------------------------

@pytest.mark.parametrize("argv", [
    ["/job/train.py", "lr=0.1", "--hosts", "tpu-a,tpu-b,tpu-c",
     "--coordinator-port", "7164"],
    ["train.py", "--hosts", "ubuntu@tpu-a,ubuntu@tpu-b"],
], ids=["three-hosts", "user-at-host"])
def test_cluster_train_hosts_dry_run_renders_jax_commands(argv, capsys):
    rc = cli_main(["cluster_train", *argv, "--dry-run"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert jax_main(["cluster_train", *argv, "--dry-run"]) == 0
    assert lines == capsys.readouterr().out.strip().splitlines()
    hosts = argv[argv.index("--hosts") + 1].split(",")
    assert len(lines) == len(hosts)
    for i, (line, host) in enumerate(zip(lines, hosts)):
        assert line.startswith(f"ssh {host} ")
        # node 0's host (no ssh login prefix) carries the coordinator
        assert "PADDLE_TPU_COORDINATOR=tpu-a:7164" in line
        assert f"PADDLE_TPU_NUM_PROCESSES={len(hosts)}" in line
        assert f"PADDLE_TPU_PROCESS_ID={i}" in line
        assert "PADDLE_TPU_JOB_ID=" in line and "trap" in line
    if "lr=0.1" in argv:
        assert "python3 /job/train.py lr=0.1" in lines[0]


def test_cluster_train_hostfile_and_template(tmp_path, capsys):
    hf = tmp_path / "hosts"
    hf.write_text("# training pool\nnode-1\nnode-2   # rack 7\n\n")
    argv = ["cluster_train", "train.py", "--hostfile", str(hf),
            "--ssh-template", "ssh -p 2222 -i /keys/id {host} {cmd}",
            "--remote-python", "/opt/py/bin/python", "--dry-run"]
    rc = cli_main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    assert jax_main(argv) == 0
    assert lines == capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2              # comments and blank lines dropped
    assert lines[0].startswith("ssh -p 2222 -i /keys/id node-1 ")
    assert lines[1].startswith("ssh -p 2222 -i /keys/id node-2 ")
    assert "PADDLE_TPU_COORDINATOR=node-1:7164" in lines[0]
    assert "/opt/py/bin/python train.py" in lines[0]


def test_cluster_train_reaper_pattern_is_jax(monkeypatch):
    """The remote reaper sends JAX's pkill command, string for string."""
    import argparse

    import paddle_tpu.cli as jcli
    import paddle_tpu_torch.cli as tcli
    sent = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        calls = []
        monkeypatch.setattr(subprocess, "run",
                            lambda cmd, **kw: calls.append(cmd))
        mod._reap_remote_job(argparse.Namespace(ssh_template=None),
                             ["h1", "u@h2"], "1a2bx0")
        sent[name] = calls
    assert sent["port"] == sent["jax"] and len(sent["port"]) == 2
    assert "PADDLE_TPU_JOB_ID=[1]a2bx0" in sent["port"][0]


def test_cluster_train_hosts_executes_rendered_commands(tmp_path,
                                                        monkeypatch):
    """Through the multi-host path without ssh: a ``bash -c`` template
    runs each rendered command here; the script records its membership
    variables."""
    out = tmp_path / "seen"
    out.mkdir()
    script = tmp_path / "record_env.py"
    script.write_text(
        "import os, pathlib\n"
        "d = os.environ['RECORD_DIR']\n"
        "i = os.environ['PADDLE_TPU_PROCESS_ID']\n"
        "pathlib.Path(d, f'node-{i}').write_text(\n"
        "    os.environ['PADDLE_TPU_COORDINATOR'] + ' ' +\n"
        "    os.environ['PADDLE_TPU_NUM_PROCESSES'])\n")
    monkeypatch.setenv("RECORD_DIR", str(out))
    rc = cli_main(["cluster_train", str(script),
                   "--hosts", "localhost,localhost",
                   "--ssh-template", "bash -c {cmd}",
                   "--remote-python", sys.executable,
                   "--timeout", "60"])
    assert rc == 0
    assert sorted(p.name for p in out.iterdir()) == ["node-0", "node-1"]
    for p in out.iterdir():
        assert p.read_text() == "localhost:7164 2"


@pytest.mark.parametrize("extra,warned", [
    (["--num_workers", "2"], "ignoring --num_workers 2"),
    (["--num_workers", "5"], "ignoring --num_workers 5"),
    ([], None),
], ids=["default-value", "other-value", "not-passed"])
def test_cluster_train_num_workers_warning_sentinel(extra, warned, capsys):
    """--hosts mode warns on any explicitly passed --num_workers, the old
    default 2 included; not passed, no warning."""
    rc = cli_main(["cluster_train", "s.py", "--hosts", "h1,h2", "--dry-run",
                   *extra])
    r = capsys.readouterr()
    assert rc == 0
    if warned:
        assert warned in r.err
    else:
        assert "ignoring --num_workers" not in r.err
        assert len([ln for ln in r.out.splitlines() if ln.strip()]) == 2


# -- cluster autoscale ---------------------------------------------------------

def test_cluster_autoscale_cli_validation():
    # no populations configured
    assert cli_main(["cluster", "autoscale", "--once"]) == 2
    # malformed endpoint
    assert cli_main(["cluster", "autoscale", "--router", "nohostport",
                     "--decode-cmd", "echo {worker}", "--once"]) == 2
    # launch template without the {worker} placeholder
    assert cli_main(["cluster", "autoscale", "--router", "127.0.0.1:1",
                     "--decode-cmd", "echo hi", "--once"]) == 2


def test_cluster_autoscale_cli_once_survives_down_plane():
    """--once against a dead control plane: the probe fails, the actor
    skips the population and the command exits cleanly."""
    assert cli_main(["cluster", "autoscale", "--router", "127.0.0.1:1",
                     "--decode-cmd", "echo {worker}", "--once"]) == 0


# -- train --elastic -----------------------------------------------------------

ELASTIC_CFG = """
import sys
import numpy as np
sys.path.insert(0, {tests_dir!r})
from torch_elastic_net import build

def params0():
    rs = np.random.RandomState(0)
    return {{"fc1": {{"w": (0.3 * rs.randn(8, 16)).astype(np.float32),
                      "b": np.zeros(16, np.float32)}},
             "fc2": {{"w": (0.3 * rs.randn(16, 2)).astype(np.float32),
                      "b": np.zeros(2, np.float32)}}}}

def elastic_workload():
    loss_fn, mk_opt, batches = build(steps=4)
    return {{"loss_fn": loss_fn, "params": params0(),
             "optimizer": mk_opt(), "batches": batches}}
"""


def test_train_elastic_cli_smoke(tmp_path, capsys, monkeypatch, request):
    """``train --elastic master`` in process and a ``--elastic worker``
    subprocess complete one pass over the wire and both exit 0; the
    master's final loss is the sequential reference's."""
    import runpy

    import torch

    from torch_elastic_net import sequential_reference
    threads = torch.get_num_threads()
    torch.set_num_threads(1)             # bit-stable sums on both sides
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    cfg = tmp_path / "elastic_cfg.py"
    cfg.write_text(ELASTIC_CFG.format(tests_dir=TESTS))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    worker = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch", "train", "--config",
         str(cfg), "--elastic", "worker", "--master_addr",
         f"127.0.0.1:{port}", "--worker_id", "cli-w0", "--device", "cpu"],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        rc = cli_main(["train", "--config", str(cfg), "--elastic", "master",
                       "--master_addr", f"127.0.0.1:{port}",
                       "--min_workers", "1", "--num_passes", "1",
                       "--device", "cpu"])
        assert rc == 0
        out, _ = worker.communicate(timeout=60)
        assert worker.returncode == 0, out.decode(errors="replace")
        assert b"job done: True" in out
    finally:
        if worker.poll() is None:
            worker.kill()
            worker.wait(timeout=10)
    printed = capsys.readouterr().out
    assert printed.startswith(f"ELASTIC MASTER 127.0.0.1 {port}\n")
    wl = runpy.run_path(str(cfg))
    loss_fn, mk_opt, batches = wl["build"](steps=4)
    _, loss = sequential_reference(loss_fn, wl["params0"](), mk_opt,
                                   batches, shards=4)
    assert f"final loss {loss:.6f}" in printed


def test_train_elastic_needs_a_workload_and_an_address(tmp_path, capsys):
    cfg = tmp_path / "no_workload.py"
    cfg.write_text("x = 1\n")
    assert cli_main(["train", "--config", str(cfg), "--elastic", "master",
                     "--device", "cpu"]) == 2
    assert "elastic_workload()" in capsys.readouterr().err
    cfg2 = tmp_path / "elastic_cfg.py"
    cfg2.write_text(ELASTIC_CFG.format(tests_dir=TESTS))
    assert cli_main(["train", "--config", str(cfg2), "--elastic", "worker",
                     "--device", "cpu"]) == 2
    assert "needs --master_addr" in capsys.readouterr().err
    assert cli_main(["train", "--config", str(cfg2), "--elastic", "master",
                     "--master_addr", "host:notaport",
                     "--device", "cpu"]) == 2
