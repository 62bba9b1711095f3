"""Device timelines of the port's obs plane (``obs/xplane.py``,
``utils/profiler.py``) against the JAX package's: the XSpace codec and its
consumers equal JAX's on JAX's fixture and on encoded planes, and the
torch.profiler reader attributes a fluid program's ops to their
``block B, op #I (type)`` sites on the CPU, as JAX's executor stamps
them for its device planes; the merged Chrome trace holds host spans and
the trace's lanes; ``profile --decode`` runs on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu.obs import xplane as jxp
from paddle_tpu_torch import obs as tobs
from paddle_tpu_torch.obs import xplane as txp

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "tiny.xplane.pb")

PLANES = [
    [{"name": "/device:TPU:1",
      "lines": [{"name": "XLA Ops", "timestamp_ns": 123,
                 "events": [{"name": "dot.1", "offset_ps": 5000,
                             "duration_ps": 2000}]}]}],
    [{"name": "/device:GPU:0",
      "lines": [{"name": "Kernels", "timestamp_ns": 10 ** 18,
                 "events": [{"name": "b0_op2_lstm", "offset_ps": 0,
                             "duration_ps": 9_000_000},
                            {"name": "copy", "offset_ps": 9_000_000,
                             "duration_ps": 1000}]}]},
     {"name": "/host:CPU",
      "lines": [{"name": "thread 1", "timestamp_ns": 5,
                 "events": [{"name": "b0_op1_mul", "offset_ps": 1,
                             "duration_ps": 7}]}]}],
]


@pytest.mark.parametrize("i", range(len(PLANES)))
def test_encode_xspace_bytes_equal_jax(i):
    assert txp.encode_xspace(PLANES[i]) == jxp.encode_xspace(PLANES[i])
    raw = txp.encode_xspace(PLANES[i])
    assert txp.read_xspace(raw) == jxp.read_xspace(raw)


def test_read_xspace_of_jax_fixture_equals_jax():
    assert txp.read_xspace(FIXTURE) == jxp.read_xspace(FIXTURE)


@pytest.mark.parametrize("consumer", ["op_totals", "top_ops_report",
                                      "xplane_dump", "device_planes"])
def test_consumers_equal_jax_on_the_fixture(consumer):
    space = jxp.read_xspace(FIXTURE)
    kw = {"anchor_unix": 5.0} if consumer == "xplane_dump" else {}
    assert getattr(txp, consumer)(space, **kw) == \
        getattr(jxp, consumer)(space, **kw)


def test_site_of_and_plane_events_equal_jax():
    space = jxp.read_xspace(FIXTURE)
    for plane in space["planes"]:
        j, t = jxp.plane_events(plane), txp.plane_events(plane)
        assert t == j
        assert [txp.site_of(e) for e in t] == [jxp.site_of(e) for e in j]
    assert txp.hlo_stats_rows(FIXTURE) is None


def _fluid_program():
    import paddle_tpu_torch.fluid as fluid
    fluid.reset_default_programs()
    L = fluid.layers
    words = L.data("words", shape=(-1,), dtype="int32")
    lens = L.data("lens", shape=(), dtype="int32")
    emb = L.embedding(words, (20, 8))
    last = L.sequence_last_step(L.dynamic_lstm(emb, lens, 8), lens)
    out = L.fc(last, 3)
    exe = fluid.Executor(scope=fluid.Scope(), device="cpu")
    exe.run(fluid.default_startup_program())
    feed = {"words": np.ones((4, 5), np.int32),
            "lens": np.full((4,), 5, np.int32)}
    return fluid, exe, feed, out


def _site_ops(program):
    from paddle_tpu_torch.analysis.diagnostics import op_site
    return {op_site(0, i, op.type) for i, op in
            enumerate(program.global_block().ops)}


def test_torch_profiler_reader_attributes_fluid_ops_to_sites(tmp_path):
    """A CPU torch.profiler run of a fluid program: the executor's
    record_function stamps put every op's aten work under its
    ``block 0, op #I (type)`` site, and the lstm op's site holds work."""
    fluid, exe, feed, out = _fluid_program()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            exe.run(feed=feed, fetch_list=[out])
    space = txp.read_torch_trace(prof)
    assert [p["name"] for p in space["planes"]] == ["/host:CPU"]
    rows = txp.op_totals(space)
    sites = {r["site"] for r in rows if r["site"]}
    want = _site_ops(fluid.default_main_program())
    assert sites <= want and len(sites) >= 3
    lstm = next(s for s in want if "(lstm)" in s)
    assert lstm in sites
    report = txp.top_ops_report(space, topk=40, steps=2)
    assert lstm in report and "self ms/step" in report
    # no profiler: the executor opens no range (nothing recorded)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof2:
        pass
    assert txp.op_totals(txp.read_torch_trace(prof2)) == []


def test_read_torch_trace_maps_kernels_to_the_launching_range():
    """A synthetic Chrome trace of the shape torch.profiler writes on the
    card: each kernel joins its launch by correlation id and takes the
    site of the range open on the launching thread."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "b0_op3_lstm",
         "pid": 1, "tid": 7, "ts": 100.0, "dur": 50.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 110.0, "dur": 2.0,
         "args": {"correlation": 42}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 7, "ts": 170.0, "dur": 2.0,
         "args": {"correlation": 43}},
        {"ph": "X", "cat": "kernel", "name": "lstm_seq_train_kernel",
         "pid": 0, "tid": 7, "ts": 120.0, "dur": 30.0,
         "args": {"correlation": 42, "device": 0}},
        {"ph": "X", "cat": "kernel", "name": "other_kernel",
         "pid": 0, "tid": 7, "ts": 175.0, "dur": 5.0,
         "args": {"correlation": 43, "device": 0}},
    ]}
    space = txp.read_torch_trace(trace)
    assert [p["name"] for p in space["planes"]] == ["/device:GPU:0",
                                                    "/host:CPU"]
    rows = {r["op"]: r for r in txp.op_totals(space)}
    assert set(rows) == {"lstm_seq_train_kernel", "other_kernel"}
    assert rows["lstm_seq_train_kernel"]["site"] == "block 0, op #3 (lstm)"
    assert rows["lstm_seq_train_kernel"]["self_ns"] == 30_000
    assert rows["other_kernel"]["site"] is None
    dump = txp.xplane_dump(space)
    assert dump["meta"]["processes"][str(txp.DEVICE_PID_BASE)] == \
        "/device:GPU:0"


def test_profiler_trace_merges_with_host_spans_through_the_cli(tmp_path):
    """utils.profiler writes a trace under its log dir; obs export
    --xplane merges its lanes beside a session's host spans."""
    from paddle_tpu_torch import cli
    from paddle_tpu_torch.utils import GLOBAL_STATS, profiler
    fluid, exe, feed, out = _fluid_program()
    s = tobs.ObsSession(registry=tobs.MetricsRegistry())
    with s.installed():
        with profiler.profile(str(tmp_path / "prof")):
            assert profiler.is_active()
            with GLOBAL_STATS.timer("TrainBatch"):
                exe.run(feed=feed, fetch_list=[out])
        host = str(tmp_path / "host.jsonl")
        s.save(host)
    assert not profiler.is_active()
    (trace,) = profiler.trace_files(str(tmp_path / "prof"))
    names = {e["name"] for e in tobs.read_jsonl(host)["events"]}
    assert {"TrainBatch", "fluid.run"} <= names
    merged = str(tmp_path / "merged.json")
    assert cli.main(["obs", "export", "--format", "chrome", "--input", host,
                     "--xplane", trace, "--output", merged]) == 0
    evs = json.load(open(merged))["traceEvents"]
    lanes = {e["args"]["name"] for e in evs
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert "/host:CPU" in lanes
    assert any(e.get("name") == "fluid.run" for e in evs)
    assert any((e.get("args") or {}).get("site", "").endswith("(lstm)")
               for e in evs)
    assert profiler.device_memory_stats() == {}


def test_profile_decode_runs_on_the_cpu(tmp_path, capsys):
    from paddle_tpu_torch import cli
    assert cli.main(["profile", "--decode", "2,8,4", "--device", "cpu",
                     "--steps", "1", "--warmup", "1", "--max_len", "64",
                     "--trace-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "self ms/step" in out and "trace:" in out
    assert os.path.exists(tmp_path / "trace.json")
    # no workload is a usage error; a config of the JAX package is refused
    assert cli.main(["profile", "--device", "cpu"]) == 2
    assert cli.main(["profile", "--config",
                     os.path.join(os.path.dirname(os.path.dirname(
                         os.path.abspath(__file__))), "examples",
                         "fit_a_line.py"), "--device", "cpu"]) == 2
