"""The port's ``tune`` on the CPU (``--device cpu``: the sweep times the
kernels' plain versions) — the counterparts of tests/test_autotune.py's
``tune --check`` smoke and tests/test_fusion.py's ``--from-ledger
--check`` smoke; ``--from-ledger`` over a trace the port's ``profile
--config`` wrote, ``--markdown``, ``--json`` and ``--check --dry-run``;
and ``serve`` with no ``--page_block``, which consults the tune plane as
JAX's does (the tuned size with a cache, 64 without)."""

import json
import os

import pytest

from paddle_tpu_torch import cli, obs, tune
from torch_configs import rewrite


@pytest.fixture(autouse=True)
def _fresh_tune(tmp_path, monkeypatch):
    """No cache of the user's is read or written, before or after."""
    monkeypatch.setenv(tune.CACHE_ENV, str(tmp_path / "default.json"))
    tune.reset()
    yield
    tune.reset()


def _counter(reg, name):
    return sum(v for _, v in reg.counter(name).samples())


def test_tune_check_cli_smoke(tmp_path, capsys):
    """``tune --check``: a seconds-long smoke sweep, persisted, reloaded
    and consulted through the port's entry points (``route_for``'s row
    tile, ``decode_splits``' counts, ``page_block``, ``bucket_grid``, the
    fusion plan, ``plan_source``); ``lint --autotune-cache`` clean over
    the file it wrote; the markdown table renders."""
    path = str(tmp_path / "autotune.json")
    rc = cli.main(["tune", "--check", "--cache", path, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "--check OK" in out
    assert "profile=smoke" in out
    cache = tune.load_cache(path)
    assert len(cache.entries) >= 3
    spaces = {e["space"] for e in cache.entries.values()}
    assert {"fused_rnn", "decode_route", "page_block"} <= spaces
    for e in cache.entries.values():
        assert e["methodology"] == "measured"
        assert e["space_hash"] == tune.space_hash(e["space"])
    assert cli.main(["lint", "--autotune-cache", path,
                     "--fail-on", "warning"]) == 0
    capsys.readouterr()
    rc = cli.main(["tune", "--profile", "smoke", "--dry-run", "--markdown",
                   "--spaces", "page_block", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "| space | kernel |" in out
    assert "page_block" in out


def test_tune_check_catches_a_consult_that_misses(tmp_path, capsys,
                                                  monkeypatch):
    """--check fails (exit 1) when a consult misses the tuned entry: here
    the decode crossover's consult is made to miss."""
    monkeypatch.setattr(tune, "decode_kernel_min_len", lambda: tune.MISS)
    rc = cli.main(["tune", "--check", "--cache",
                   str(tmp_path / "autotune.json"), "--spaces",
                   "decode_route", "--device", "cpu"])
    err = capsys.readouterr().err
    assert rc == 1
    assert "--check FAILED: decode_route: consult missed" in err


def test_tune_from_ledger_check_smoke(tmp_path, capsys):
    """``tune --from-ledger --check``: synthetic profile sites seed the
    sweep (only the implicated spaces run), the seeded families count on
    the obs plane, and the loop still closes."""
    sites = [{"op": "b0_op5_fused_elementwise_chain", "self_ns": 900000},
             {"op": "b0_op9_paged_decode_attention", "self_ns": 400000},
             {"op": "b0_op2_layer_norm", "self_ns": 10}]
    ledger = tmp_path / "sites.json"
    ledger.write_text(json.dumps(sites))
    path = str(tmp_path / "autotune.json")
    reg = obs.MetricsRegistry()
    with obs.ObsSession(registry=reg).installed():
        rc = cli.main(["tune", "--check", "--cache", path,
                       "--from-ledger", str(ledger), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "--check OK" in out
    assert "implicate spaces ['fusion', 'page_block']" in out
    cache = tune.load_cache(path)
    assert {e["space"] for e in cache.entries.values()} == {"fusion",
                                                             "page_block"}
    assert _counter(reg, "tune.ledger_seeded_families_total") > 0
    for e in cache.entries.values():
        if e["space"] == "fusion":
            assert isinstance(e["certificate"], dict)
            assert e["program_signature"]
            assert isinstance(e["plan"]["fuse"], bool)


def test_tune_from_ledger_reads_a_profile_trace(tmp_path, capsys):
    """The trace ``profile --config`` writes seeds a sweep: its sites
    implicate ``fused_rnn`` (the lstm op's), which is swept. On the CPU
    the ranking of host ops by self time follows the host's load, so the
    whole trace seeds here (``--ledger-topk`` past its op count); the
    card's phase 25 (e) keeps the default top 8, where the kernels
    lead."""
    cfg = rewrite("examples/quick_start_sentiment.py", tmp_path)
    trace = tmp_path / "trace"
    assert cli.main(["profile", "--config", cfg, "--steps", "2",
                     "--warmup", "1", "--trace-dir", str(trace),
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    rc = cli.main(["tune", "--from-ledger", str(trace / "trace.json"),
                   "--ledger-topk", "10000", "--dry-run", "--profile",
                   "smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    head = out.splitlines()[0]
    assert head.startswith(
        f"tune: ledger {trace / 'trace.json'}: top-10000")
    assert "fused_rnn" in head.split("implicate spaces")[1]
    assert "tune: fused_rnn/lstm_seq_train" in out
    assert "(dry run, nothing written)" in out


def test_tune_json_report_and_check_dry_run_refused(tmp_path, capsys):
    rc = cli.main(["tune", "--profile", "smoke", "--spaces",
                   "page_block,bucket_grid", "--json", "--device", "cpu",
                   "--cache", str(tmp_path / "c.json")])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["profile"] == "smoke" and report["backend"] == "plain"
    assert report["cache_path"] == str(tmp_path / "c.json")
    assert {r["space"] for r in report["results"]} == {"page_block",
                                                        "bucket_grid"}
    assert cli.main(["tune", "--check", "--dry-run", "--device",
                     "cpu"]) == 2
    assert "drop --dry-run" in capsys.readouterr().err
    assert cli.main(["tune", "--spaces", "warp_drive", "--dry-run",
                     "--device", "cpu"]) == 2
    assert "unknown plan space" in capsys.readouterr().err


@pytest.mark.parametrize("tuned,want", [(128, 128), (None, 64)],
                         ids=["tuned-128", "no-cache"])
def test_serve_page_block_consults_the_tune_plane(tuned, want, tmp_path,
                                                  monkeypatch, capsys):
    """``serve`` with no ``--page_block`` builds its pool at the tuned
    page size when the cache holds one for the grid (JAX's rule), else at
    64."""
    if tuned is not None:
        c = tune.AutotuneCache()
        c.put("page_block", "paged_decode_attention", "cpu", "default",
              {"page_block": tuned}, tune.space_hash("page_block"))
        monkeypatch.setenv(tune.CACHE_ENV,
                           c.save(str(tmp_path / "tuned.json")))
        tune.reset()
    monkeypatch.setattr(cli, "_wait_for_signal", lambda: None)
    rc = cli.main(["serve", "--vocab", "67", "--d_model", "16",
                   "--n_heads", "2", "--n_layers", "1", "--max_len", "256",
                   "--slots", "1", "--segment", "4", "--cache_bucket",
                   "128", "--drain", "0", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert f" page_block={want} " in out
    assert os.environ[tune.CACHE_ENV]
