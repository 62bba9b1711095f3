"""The port's ``train``, ``test``, ``time``, ``dump_config``,
``merge_model``, ``make_diagram``, ``checkgrad`` and ``profile --config``
on the CPU (``--device cpu``) — the counterparts of
tests/test_cli_and_export.py's train/test/time/dump and local-master
cases and of tests/test_examples.py, held to JAX's CLI on the same
configs: the port's config is JAX's file with its ``paddle_tpu`` imports
rewritten (tests/torch_configs.py).

Held: the same output lines and files; ``dump_config`` and
``make_diagram`` give JAX's text; ``test`` on a tar JAX's ``train`` wrote
gives JAX's cost; ``merge_model`` of that tar writes JAX's bundle files
byte for byte; a pass directory the port wrote loads in JAX's checkpoint
reader; ``--compile_cache`` and a config importing ``paddle_tpu`` exit 2.
Every command runs in this process but ``time``, which runs once as
``python -m paddle_tpu_torch`` (the module entry point).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.cli as jcli
from paddle_tpu_torch import cli
from torch_configs import ROOT, rewrite

FIT = "examples/fit_a_line.py"
QUICK = "examples/quick_start_sentiment.py"

CONFIG = """\
import paddle_tpu.v2 as paddle
from paddle_tpu.data.dataset import uci_housing

x = paddle.layer.data("x", paddle.data_type.dense_vector(13))
y = paddle.layer.data("y", paddle.data_type.dense_vector(1))
pred = paddle.layer.fc(x, 1)
cost = paddle.layer.square_error_cost(pred, y)
optimizer = paddle.optimizer.SGD(0.05)
train_reader = paddle.batch(uci_housing.train(128), 32)
test_reader = paddle.batch(uci_housing.test(64), 32)
feeding = [x, y]
outputs = [pred]
"""


@pytest.fixture
def config_file(tmp_path):
    """(JAX's config, the port's) of test_cli_and_export.py's CONFIG."""
    jax_cfg = tmp_path / "jax" / "cfg.py"
    jax_cfg.parent.mkdir()
    jax_cfg.write_text(CONFIG)
    return str(jax_cfg), rewrite(str(jax_cfg), tmp_path / "port")


def _run(capsys, *argv):
    rc = cli.main(list(argv))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return out.out


def _jax(capsys, *argv):
    rc = jcli.main(list(argv))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return out.out


def test_cli_train_test_time_dump(config_file, tmp_path, capsys):
    _, cfg = config_file
    save = str(tmp_path / "out")
    out = _run(capsys, "train", "--config", cfg, "--num_passes", "2",
               "--save_dir", save, "--log_period", "2", "--device", "cpu")
    assert "pass 1 done" in out
    assert re.search(r"^pass 1 batch 1 cost [\d.]+$", out, re.M), out
    for name in ("params.tar", "state.json", "_COMPLETE"):
        assert os.path.exists(os.path.join(save, "pass-00001", name))
    assert os.path.exists(os.path.join(save, "inference", "model.json"))

    out = _run(capsys, "test", "--config", cfg, "--init_model_path",
               os.path.join(save, "pass-00001", "params.tar"),
               "--device", "cpu")
    assert json.loads(out.strip().splitlines()[-1])["cost"] >= 0

    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch", "time", "--config", cfg,
         "--iters", "4", "--device", "cpu"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["ms_per_batch"] > 0

    d = json.loads(_run(capsys, "dump_config", "--config", cfg))
    assert d["blocks"][0]["ops"]


def test_cli_train_refuses_compile_cache(config_file, tmp_path, capsys):
    """JAX's --compile_cache persists XLA executables; the port compiles
    none, so the flag exits 2 before the config runs."""
    _, cfg = config_file
    rc = cli.main(["train", "--config", cfg, "--compile_cache",
                   str(tmp_path / "cc"), "--device", "cpu"])
    assert rc == 2
    assert "compiles no XLA programs" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "cc")


@pytest.mark.parametrize("argv", [
    ["train"], ["test"], ["time"], ["dump_config"], ["make_diagram"],
    ["checkgrad"], ["profile"],
    ["merge_model", "--model_path", "x.tar", "--output_dir", "out"],
], ids=lambda a: a[0])
def test_config_importing_the_jax_package_is_refused(argv, capsys):
    """A config of the JAX package itself exits 2 with the rule, before
    anything of it runs."""
    extra = [] if argv[0] in ("dump_config", "make_diagram") \
        else ["--device", "cpu"]
    rc = cli.main([argv[0], "--config", os.path.join(ROOT, FIT),
                   *argv[1:], *extra])
    err = capsys.readouterr().err
    assert rc == 2
    assert "runs configs written against paddle_tpu_torch" in err
    assert "line(s) 6, 7" in err


def test_cli_train_local_master(config_file, tmp_path, capsys):
    """``train --local_master`` hosts the task-master RPC plane in this
    process and trains from it over two passes, with the artifacts of a
    plain train; ``--obs_out`` arms a flight recorder, pushes snapshots to
    the in-process master and leaves a dump the obs CLI reads back."""
    from paddle_tpu_torch import obs
    _, cfg = config_file
    save = str(tmp_path / "out")
    obs_out = str(tmp_path / "run.jsonl")
    out = _run(capsys, "train", "--config", cfg, "--num_passes", "2",
               "--save_dir", save, "--local_master",
               "--samples_per_chunk", "2", "--obs_out", obs_out,
               "--device", "cpu")
    assert "local master:" in out
    assert "pass 1 done" in out
    assert os.path.exists(os.path.join(save, "pass-00001", "params.tar"))
    assert "observability dump written" in out
    dump = obs.read_jsonl(obs_out)
    assert not dump["meta"].get("flight")   # the full dump, not the ring
    names = {m["name"] for m in dump["metrics"]}
    for name in ("fluid.runs_total", "rpc.calls_total", "obs.pushes_total",
                 "master.requests_total"):
        assert name in names, name
    out = _run(capsys, "obs", "summary", "--input", obs_out)
    assert "fluid.runs_total" in out
    out = _run(capsys, "obs", "export", "--input", obs_out, "--format",
               "prom")
    assert "paddle_tpu_fluid_runs_total" in out


@pytest.mark.parametrize("config,passes", [(FIT, "4"), (QUICK, "2")],
                         ids=["fit_a_line", "quick_start"])
def test_example_trains_and_cost_falls(config, passes, tmp_path, capsys):
    cfg = rewrite(config, tmp_path)
    out = _run(capsys, "train", "--config", cfg, "--num_passes", passes,
               "--log_period", "1", "--device", "cpu")
    costs = [float(m) for m in re.findall(r"cost ([-\d.]+)", out)]
    assert len(costs) >= 2, out
    assert costs[-1] < costs[0], out


def test_checkgrad_job(tmp_path, capsys):
    """``checkgrad`` on fit_a_line: JAX's sampled entries (RandomState(0)),
    eps and rtol through the pruned cost and gradient programs."""
    cfg = rewrite(FIT, tmp_path)
    out = _run(capsys, "checkgrad", "--config", cfg, "--device", "cpu")
    assert "checkgrad PASS (2 params" in out, out


def test_make_diagram_job(tmp_path, capsys):
    cfg = rewrite(FIT, tmp_path)
    out = str(tmp_path / "model.dot")
    txt = _run(capsys, "make_diagram", "--config", cfg, "--output", out)
    assert "wrote" in txt
    dot = open(out).read()
    assert dot.startswith("digraph G {") and "shape=box" in dot
    assert "square_error" in dot or "mul" in dot


@pytest.mark.parametrize("config", [FIT, QUICK],
                         ids=["fit_a_line", "quick_start"])
def test_dump_config_and_make_diagram_equal_jax(config, tmp_path, capsys):
    cfg = rewrite(config, tmp_path / "port")
    jax_cfg = os.path.join(ROOT, config)
    assert _run(capsys, "dump_config", "--config", cfg) == _jax(
        capsys, "dump_config", "--config", jax_cfg)
    ours, theirs = str(tmp_path / "port.dot"), str(tmp_path / "jax.dot")
    line = _run(capsys, "make_diagram", "--config", cfg, "--output", ours)
    jline = _jax(capsys, "make_diagram", "--config", jax_cfg,
                 "--output", theirs)
    assert line.replace(ours, theirs) == jline
    assert open(ours).read() == open(theirs).read()


@pytest.fixture(scope="module")
def jax_pass(tmp_path_factory):
    """A pass directory JAX's ``train`` wrote from fit_a_line."""
    d = str(tmp_path_factory.mktemp("jax_train") / "out")
    assert jcli.main(["train", "--config", os.path.join(ROOT, FIT),
                      "--num_passes", "1", "--save_dir", d]) == 0
    return d


def test_test_on_jax_tar_gives_jax_cost(jax_pass, tmp_path, capsys):
    tar = os.path.join(jax_pass, "pass-00000", "params.tar")
    cfg = rewrite(FIT, tmp_path)
    ours = json.loads(_run(capsys, "test", "--config", cfg,
                           "--init_model_path", tar, "--device", "cpu")
                      .strip().splitlines()[-1])["cost"]
    theirs = json.loads(_jax(capsys, "test", "--config",
                             os.path.join(ROOT, FIT), "--init_model_path",
                             tar).strip().splitlines()[-1])["cost"]
    np.testing.assert_allclose(ours, theirs, rtol=1e-5)


def test_merge_model_writes_jax_bundle_bytes(jax_pass, tmp_path, capsys):
    tar = os.path.join(jax_pass, "pass-00000", "params.tar")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _run(capsys, "merge_model", "--config",
                rewrite(FIT, tmp_path / "cfg"), "--model_path", tar,
                "--output_dir", ours, "--device", "cpu") == \
        f"merged model written to {ours}\n"
    _jax(capsys, "merge_model", "--config", os.path.join(ROOT, FIT),
         "--model_path", tar, "--output_dir", theirs)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == [
        "model.json", "params.tar"]
    for name in ("model.json", "params.tar"):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


def test_port_pass_dir_loads_in_jax(tmp_path, capsys):
    """A pass directory the port's ``train`` published (params.tar,
    state.json, the CRC manifest) is read by JAX's checkpoint reader, and
    its parameters are the port's."""
    from paddle_tpu.trainer.checkpoint import latest_pass, load_checkpoint
    from paddle_tpu_torch.trainer.checkpoint import from_tar
    cfg = rewrite(FIT, tmp_path)
    save = str(tmp_path / "out")
    _run(capsys, "train", "--config", cfg, "--num_passes", "1",
         "--save_dir", save, "--device", "cpu")
    assert latest_pass(save, verify=True) == 0
    params, opt_state, state = load_checkpoint(save, 0)
    assert state["pass_id"] == 0 and state["pass_complete"]
    assert opt_state is None
    with open(os.path.join(save, "pass-00000", "params.tar"), "rb") as f:
        ours = from_tar(f, "cpu")
    assert sorted(params) == sorted(ours)
    for name, v in ours.items():
        np.testing.assert_array_equal(np.asarray(params[name]), v.numpy())


def test_profile_config_reports_the_lstm_site(tmp_path, capsys):
    """``profile --config`` traces the config's steps on the eager route
    and attributes the ops to their Program sites; on the CPU the host
    ops carry the lstm op's site."""
    cfg = rewrite(QUICK, tmp_path)
    trace = str(tmp_path / "trace")
    # every row printed: on the CPU the ranking of host ops follows load
    out = _run(capsys, "profile", "--config", cfg, "--steps", "2",
               "--warmup", "1", "--trace-dir", trace, "--topk", "10000",
               "--device", "cpu")
    assert "block 0, op #1 (lstm)" in out
    assert "traced the eager route" in out
    assert f"trace: {trace}/trace.json" in out
    assert "merge: python -m paddle_tpu_torch obs export" in out
    assert os.path.exists(os.path.join(trace, "trace.json"))
