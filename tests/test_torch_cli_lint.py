"""The port's ``lint`` on the CPU — the counterparts of the CLI cases of
tests/test_analysis.py (the example configs lint clean, V001, --fail-on,
--json, the usage error, the legacy JSON's fields), tests/test_dataflow.py
(the example tree clean, the --format=json schema and its sites, the
exit-code contract), test_cli_and_export.py's --bench-rows and
test_fusion.py's standalone --autotune-cache.

Each config is run through both packages' CLIs (the port's copy of a
config rewrites its ``paddle_tpu`` imports, tests/torch_configs.py): the
exit codes, and the findings' codes, severities and sites, equal JAX's.
The autotune lint (L008) reads each package's own default cache, pinned
here to a missing file on both sides."""

import json
import os

import pytest

import paddle_tpu.cli as jcli
from paddle_tpu_torch import cli
from torch_configs import ROOT, rewrite

CONFIG_EXAMPLES = [
    "examples/fit_a_line.py",
    "examples/mnist_lenet.py",
    "examples/quick_start_sentiment.py",
    "examples/sequence_tagging.py",
    "examples/traffic_prediction.py",
]

#: JAX's waivers of the example tree (tests/test_dataflow.py)
EXAMPLE_WAIVERS = {"gan_vae_mnist.py", "machine_translation.py",
                   "model_zoo_features.py", "serving_llm.py", "README.md"}

DEAD_CFG = ("import paddle_tpu.fluid as fluid\n"
            "from paddle_tpu.fluid import layers\n"
            "x = layers.data('x', shape=(4,))\n"
            "dead = layers.fc(x, 8)\n"
            "cost = layers.mean(layers.elementwise_mul(x, x))\n")


@pytest.fixture(autouse=True)
def _no_caches(tmp_path, monkeypatch):
    """Both packages' L008 read a missing cache file: clean."""
    monkeypatch.setenv("PADDLE_TPU_AUTOTUNE_CACHE",
                       str(tmp_path / "no-jax-cache.json"))
    monkeypatch.setenv("PADDLE_TPU_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "no-port-cache.json"))


def _both(capsys, argv, jax_cfg, port_cfg):
    """(port rc, stdout, stderr), (JAX rc, stdout, stderr) of one lint
    command line; ``{cfg}`` in ``argv`` names each side's config."""
    rc = cli.main([a.replace("{cfg}", port_cfg) for a in argv])
    mine = capsys.readouterr()
    jrc = jcli.main([a.replace("{cfg}", jax_cfg) for a in argv])
    theirs = capsys.readouterr()
    return (rc, mine.out, mine.err), (jrc, theirs.out, theirs.err)


def _write(tmp_path, name, text):
    """A config as JAX's file and the port's rewrite of it."""
    jax_cfg = tmp_path / "jax" / name
    jax_cfg.parent.mkdir(exist_ok=True)
    jax_cfg.write_text(text)
    return str(jax_cfg), rewrite(str(jax_cfg), tmp_path / "port")


def _sites(payload):
    return [(f["code"], f["severity"], f["site"]) for f in
            payload["findings"]]


def _examples():
    return [n for n in sorted(os.listdir(os.path.join(ROOT, "examples")))
            if n not in EXAMPLE_WAIVERS]


@pytest.mark.parametrize("name", _examples())
def test_example_config_lints_clean_as_jax(name, tmp_path, capsys):
    """Every example of the tree but JAX's waivers (a superset of
    test_analysis.py's CONFIG_EXAMPLES) lints clean, and its findings in
    --format=json are JAX's."""
    assert all(os.path.basename(c) in _examples() for c in CONFIG_EXAMPLES)
    jax_cfg = os.path.join(ROOT, "examples", name)
    cfg = rewrite(jax_cfg, tmp_path)
    rc = cli.main(["lint", "--config", cfg])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 error(s)" in out
    (rc, out, _), (jrc, jout, _) = _both(
        capsys, ["lint", "--config", "{cfg}", "--format=json"], jax_cfg, cfg)
    assert rc == jrc == 0
    assert _sites(json.loads(out)) == _sites(json.loads(jout))


def test_cli_lint_rejects_bad_config(tmp_path, capsys):
    jax_cfg, cfg = _write(
        tmp_path, "bad_cfg.py",
        "import paddle_tpu.fluid as fluid\n"
        "from paddle_tpu.fluid import layers\n"
        "x = layers.data('x', shape=(4,))\n"
        "g = fluid.default_main_program().global_block()\n"
        "o = g.create_var(shape=(-1, 4))\n"
        "g.append_op('elementwise_add', {'X': [x.name], 'Y': ['ghost']},"
        " {'Out': [o.name]})\n")
    (rc, out, _), (jrc, jout, _) = _both(
        capsys, ["lint", "--config", "{cfg}"], jax_cfg, cfg)
    assert rc == jrc == 1 and "V001" in out
    (_, out, _), (_, jout, _) = _both(
        capsys, ["lint", "--config", "{cfg}", "--format=json"], jax_cfg, cfg)
    assert _sites(json.loads(out)) == _sites(json.loads(jout))


def test_cli_lint_fail_on_warning_promotes_dead_op(tmp_path, capsys):
    jax_cfg, cfg = _write(tmp_path, "dead_cfg.py", DEAD_CFG)
    assert cli.main(["lint", "--config", cfg]) == 0   # a warning only
    capsys.readouterr()
    (rc, out, _), (jrc, _, _) = _both(
        capsys, ["lint", "--config", "{cfg}", "--fail-on", "warning"],
        jax_cfg, cfg)
    assert rc == jrc == 1 and "L001" in out


def test_cli_lint_json_output(tmp_path, capsys):
    jax_cfg, cfg = _write(tmp_path, "cfg.py",
                          "from paddle_tpu.fluid import layers\n"
                          "x = layers.data('x', shape=(4,))\n"
                          "cost = layers.mean(layers.fc(x, 2))\n")
    (rc, out, err), (jrc, jout, _) = _both(
        capsys, ["lint", "--config", "{cfg}", "--json"], jax_cfg, cfg)
    assert rc == jrc == 0
    payload = json.loads(out)          # stdout is pure JSON
    assert isinstance(payload, list)
    assert "lint:" in err
    assert all(d["program"] in ("main", "startup") for d in payload)
    keys = lambda p: [(d["code"], d["program"], d["block"], d["op_idx"],  # noqa: E731
                       d["var"]) for d in p]
    assert keys(payload) == keys(json.loads(jout))


def test_cli_lint_missing_config_is_usage_error(tmp_path, capsys):
    """Exit 2 (usage), apart from exit 1 (findings); so is a config of
    the JAX package itself."""
    rc = cli.main(["lint", "--config", str(tmp_path / "nope.py")])
    assert rc == 2
    assert "cannot load config" in capsys.readouterr().err
    rc = cli.main(["lint", "--config",
                   os.path.join(ROOT, "examples", "fit_a_line.py")])
    assert rc == 2
    assert "written against paddle_tpu_torch" in capsys.readouterr().err


def test_legacy_json_carries_new_fields_backward_compatibly(tmp_path,
                                                            capsys):
    jax_cfg, cfg = _write(tmp_path, "ok.py",
                          "import paddle_tpu.fluid as fluid\n"
                          "from paddle_tpu.fluid import layers\n"
                          "x = layers.data('x', shape=(4,))\n"
                          "unused = layers.data('unused', shape=(4,))\n"
                          "cost = layers.mean(x)\n")
    (rc, out, _), (jrc, jout, _) = _both(
        capsys, ["lint", "--config", "{cfg}", "--json"], jax_cfg, cfg)
    payload = json.loads(out)
    assert rc == jrc == 0
    assert isinstance(payload, list) and payload
    for d in payload:
        assert "block_path" in d and "explain" in d
        assert d["program"] in ("main", "startup")
    assert sorted(payload[0]) == sorted(json.loads(jout)[0])


def test_lint_format_json_schema_roundtrip(tmp_path, capsys):
    cfg = rewrite("examples/fit_a_line.py", tmp_path)
    rc = cli.main(["lint", "--config", cfg, "--format=json", "--explain"])
    payload = json.loads(capsys.readouterr().out)   # stdout is pure JSON
    assert rc == 0
    assert payload["version"] == 1
    assert set(payload) == {"version", "findings", "summary"}
    assert set(payload["summary"]) == {"errors", "warnings", "info",
                                       "total"}
    assert payload["summary"]["errors"] == 0
    for f in payload["findings"]:
        assert set(f) == {"code", "severity", "message", "hint",
                          "explain", "site"}
        assert set(f["site"]) == {"program", "block", "block_path", "op",
                                  "op_type", "var"}
    assert json.loads(json.dumps(payload, sort_keys=True)) == payload


def test_lint_format_json_findings_sites(tmp_path, capsys):
    """A config with real findings: the sites and the explained chains
    are JAX's."""
    jax_cfg, cfg = _write(tmp_path, "dead_cfg.py",
                          "import paddle_tpu.fluid as fluid\n"
                          "from paddle_tpu.fluid import layers\n"
                          "x = layers.data('x', shape=(4,))\n"
                          "unused = layers.data('unused', shape=(4,))\n"
                          "dead = layers.relu(x)\n"
                          "cost = layers.mean(x)\n")
    (rc, out, _), (jrc, jout, _) = _both(
        capsys, ["lint", "--config", "{cfg}", "--format=json", "--explain",
                 "--fail-on", "warning"], jax_cfg, cfg)
    payload, jpayload = json.loads(out), json.loads(jout)
    assert rc == jrc == 1
    findings = payload["findings"]
    assert findings and payload["summary"]["total"] == len(findings)
    flagged = [f for f in findings if f["site"]["var"]]
    assert flagged and any(f["explain"] for f in flagged)
    assert _sites(payload) == _sites(jpayload)
    assert payload["summary"] == jpayload["summary"]
    assert [f["explain"] for f in findings] == \
        [f["explain"] for f in jpayload["findings"]]


def test_lint_exit_code_contract(tmp_path, capsys):
    rc = cli.main(["lint", "--config", str(tmp_path / "missing.py")])
    capsys.readouterr()
    assert rc == 2
    rc = cli.main(["lint", "--config",
                   rewrite("examples/fit_a_line.py", tmp_path)])
    capsys.readouterr()
    assert rc == 0
    assert cli.main(["lint"]) == 2            # nothing to lint
    assert "--config is required" in capsys.readouterr().err


def _rows(tmp_path):
    good = tmp_path / "good.jsonl"
    good.write_text(
        json.dumps({"metric": "x_train_ms_per_batch", "value": 1.0,
                    "unit": "ms", "vs_baseline": None, "mfu": 0.2,
                    "methodology": "measured",
                    "plan_source": "heuristic"}) + "\n"
        + json.dumps({"metric": "z_serve_daemon_tokens_per_sec",
                      "value": 9.0, "unit": "tok/s", "vs_baseline": None,
                      "ttft_p50_ms": 12.0, "tpot_p50_ms": 3.0,
                      "methodology": "measured"}) + "\n"
        + json.dumps({"metric": "r_route_disagg_tokens_per_sec",
                      "value": 7.0, "unit": "tok/s", "vs_baseline": None,
                      "ttft_p50_ms": 20.0, "tpot_p50_ms": 4.0,
                      "n_decode_workers": 2,
                      "ttft_breakdown": {"queued": 1.0, "prefill": 12.0,
                                         "ship": 4.0, "adopt": 2.0}})
        + "\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_text(
        json.dumps({"metric": "y_decode_tokens_per_sec", "value": 5.0,
                    "unit": "tok/s", "vs_baseline": None}) + "\n"
        + json.dumps({"metric": "z_serve_daemon_tokens_per_sec",
                      "value": 9.0, "unit": "tok/s",
                      "vs_baseline": None}) + "\n"
        + json.dumps({"metric": "w_train_ms_per_batch", "value": 1.0,
                      "unit": "ms", "vs_baseline": None, "mfu": 0.2,
                      "methodology": "guessed",
                      "plan_source": "vibes"}) + "\n"
        + json.dumps({"metric": "r_route_disagg_tokens_per_sec",
                      "value": 7.0, "unit": "tok/s", "vs_baseline": None,
                      "ttft_p50_ms": 20.0, "tpot_p50_ms": 4.0}) + "\n")
    return str(good), str(bad)


def test_lint_bench_rows_schema(tmp_path, capsys):
    """``lint --bench-rows`` with no config: good rows pass; a row missing
    its family's columns or a required key fails with B001 findings, the
    lines JAX prints."""
    good, bad = _rows(tmp_path)
    (rc, out, _), (jrc, jout, _) = _both(
        capsys, ["lint", "--bench-rows", good], "", "")
    assert rc == jrc == 0 and "0 problem(s)" in out and out == jout
    (rc, out, _), (jrc, jout, _) = _both(
        capsys, ["lint", "--bench-rows", bad], "", "")
    assert rc == jrc == 1
    assert out == jout
    for word in ("B001", "hbm_bw_util", "ttft_p50_ms", "tpot_p50_ms",
                 "methodology", "guessed", "plan_source", "vibes",
                 "n_decode_workers", "ttft_breakdown"):
        assert word in out, word
    (rc, out, err), (jrc, jout, _) = _both(
        capsys, ["lint", "--bench-rows", bad, "--json"], "", "")
    assert rc == jrc == 1
    assert json.loads(out) == json.loads(jout) and "bench rows" in err
    assert cli.main(["lint", "--bench-rows",
                     str(tmp_path / "nope.jsonl")]) == 2


def test_lint_autotune_cache_standalone(tmp_path, capsys):
    """``lint --autotune-cache FILE`` alone over the port's cache: a
    missing certificate, a bad fusion plan and a bad grid are three L008
    findings and exit 1 at --fail-on warning; a clean cache exits 0."""
    from paddle_tpu_torch import tune
    c3 = tune.AutotuneCache()
    c3.put("fusion", "elementwise_chain", "cpu", "a:b:c",
           {"fuse": True}, tune.space_hash("fusion"))
    c3.put("fusion", "elementwise_chain", "cpu", "a:b:d",
           {"fuse": "yes"}, tune.space_hash("fusion"),
           certificate={"kind": "elementwise_chain"})
    c3.put("bucket_grid", "prefill_dispatch", "cpu", "prompt",
           {"buckets": [64, 32]}, tune.space_hash("bucket_grid"))
    path = c3.save(str(tmp_path / "bad.json"))
    assert cli.main(["lint", "--autotune-cache", path,
                     "--fail-on", "warning"]) == 1
    out = capsys.readouterr().out
    assert "3 finding(s)" in out
    assert "no dependence certificate" in out
    assert "ascending unique positive ints" in out
    good = tune.AutotuneCache()
    good.put("page_block", "paged_decode_attention", "cpu", "default",
             {"page_block": 32}, tune.space_hash("page_block"))
    assert cli.main(["lint", "--autotune-cache",
                     good.save(str(tmp_path / "good.json")),
                     "--fail-on", "warning"]) == 0
