"""``python -m paddle_tpu_torch`` — the port's command line, the
counterpart of ``paddle_tpu/cli.py`` (the ``paddle`` CLI of
``paddle/scripts/submit_local.sh.in`` and ``TrainerMain.cpp``'s job
types), with its subcommands:

* ``train``: the config's v2 trainer over ``--num_passes``, each pass
  published under ``--save_dir`` (``pass-%05d/{params.tar,state.json}``)
  and the config's ``outputs`` exported to ``<save_dir>/inference``;
  ``--local_master`` serves the reader's chunks from an in-process master
  and trains from them, ``--obs_out`` writes an observability dump (a
  flight recorder armed meanwhile), ``--elastic master|worker`` runs the
  elastic data-parallel plane over the config's ``elastic_workload()``;
* ``test``, ``time`` (``{"ms_per_batch": ...}``), ``dump_config`` (the
  main program as JSON), ``merge_model`` (the inference bundle from a
  params tar), ``make_diagram`` (a graphviz ``.dot``), ``checkgrad``
  (autodiff against central differences on sampled entries);
* ``lint``: static verification and the lint catalogue over the config's
  programs, bench rows (``--bench-rows``) and the autotune cache
  (``--autotune-cache``, also standalone);
* ``tune``: the measured autotuning sweep into the port's cache
  (``--check``, ``--from-ledger``, ``--markdown``, ``--json``);
* ``cluster_train``: N worker processes joined by ``PADDLE_TPU_*``
  (``parallel/multihost.initialize``), or one a host over ssh
  (``--hosts``/``--hostfile``); ``cluster autoscale``: the fleet actor;
* ``serve``: the serving daemon (``serving/daemon.py``) over a paged
  KV-cache continuous-batching ``ServingEngine`` — or, with
  ``--role prefill``, a pool-only ``PrefillDaemon`` that ships pages to
  the router-chosen decode worker;
* ``route``: the model-free ``ServingRouter`` over joined workers;
* ``obs``: ``summary``, ``export`` (``--format chrome|prom|jsonl``;
  ``--xplane`` merges a device trace — a ``torch.profiler`` Chrome trace
  or a ``.xplane.pb`` — as extra lanes), ``serve`` (the read-only HTTP
  view), ``trace`` (one request's stitched timeline) and ``top``, over
  the JSONL dumps an ``ObsSession`` writes;
* ``profile``: ``--config`` config training steps, or ``--decode
  B,PROMPT,NEW`` fused-decode calls, under ``torch.profiler`` and the
  top-k per-kernel report;
* ``version``.

Flags, defaults, output lines and exit codes are JAX's: ``SERVING <host>
<port>``, ``ROUTER <host> <port>``, ``JOINED <router> epoch <n>`` and
``ELASTIC MASTER <host> <port>`` print first and flushed; SIGTERM (or
SIGINT) drains and stops, and ``serve``/``route`` run under an installed
``ObsSession`` whose dump ``--obs_out`` writes on the way out (with a
flight recorder armed there meanwhile). One flag is the port's own:
``--device`` (default ``cuda``: with no card the command raises; the
tests pass ``--device cpu``) on the commands that run a program.

Config scripts (``--config``) are JAX's, written against
``paddle_tpu_torch``: a script of the JAX package with ``paddle_tpu``
replaced by ``paddle_tpu_torch`` in its imports. It builds a model through
the v2 or fluid front end and exposes module-level names: ``cost``,
``optimizer``, ``train_reader()``/``test_reader()``, ``feeding`` (the v2
data layers in row order) and optionally ``outputs``; ``elastic_workload()``
for ``train --elastic``. A config that imports ``paddle_tpu`` is refused
with exit 2. Where the port differs on purpose (``--compile_cache`` and
``--devices_per_worker`` above 1 refused, ``profile --config`` traced on
the eager route, the ``tune --check`` consults) ROADMAP C.14 says why.

``serve``'s model comes from ``--config`` (a Python script exposing
module-level ``model`` — a port ``TransformerLM`` — and ``params``: None
when the model already holds its weights, or a JAX parameter tree as
numpy, which ``convert.params_from_numpy`` loads, so both packages can
serve the same weights) or, without one, a ``TransformerLM`` built from
the flags with weights drawn from ``--seed``. Those draws are
``torch.Generator``'s, so they are not the weights JAX draws from the
same seed (ROADMAP C).
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import signal
import sys
import threading
import time
from typing import Any, Dict, List


class ConfigRefused(ValueError):
    """A config the port does not run: one that imports the JAX package."""


def _jax_imports(path: str) -> List[int]:
    """The lines of ``path`` that import the JAX package ``paddle_tpu``
    (``paddle_tpu_torch`` is not it)."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    lines = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module or ""]
        else:
            continue
        if any(n == "paddle_tpu" or n.startswith("paddle_tpu.")
               for n in names):
            lines.append(node.lineno)
    return lines


def _run_config(path: str) -> Dict[str, Any]:
    """Run a config script; one that imports ``paddle_tpu`` is refused."""
    lines = _jax_imports(path)
    if lines:
        raise ConfigRefused(
            f"{path} imports the JAX package paddle_tpu (line(s) "
            f"{', '.join(map(str, lines))}); the port runs configs written "
            "against paddle_tpu_torch: replace paddle_tpu by "
            "paddle_tpu_torch in its imports")
    return runpy.run_path(path)


def _load_config(path: str) -> Dict[str, Any]:
    from . import fluid
    fluid.reset_default_programs()
    return _run_config(path)


def _make_trainer(cfg, device):
    from . import v2
    cost = cfg["cost"]
    opt = cfg.get("optimizer") or v2.optimizer.SGD(0.01)
    if not hasattr(opt, "fluid_opt"):
        opt = type("O", (), {"fluid_opt": opt})()
    return v2.SGD(cost, opt, device=device)


def _cmd_train_elastic(args):
    """``train --elastic master|worker`` — the elastic data-parallel mode
    over ``trainer/elastic.py``. The config defines ``elastic_workload()``
    returning ``{"loss_fn", "params", "optimizer", "batches"}`` (a port
    loss; params and batches as host arrays or tensors; workers only need
    loss_fn)."""
    from .trainer.elastic import ElasticMaster, ElasticWorker
    cfg = _run_config(args.config)
    wl_fn = cfg.get("elastic_workload")
    if not callable(wl_fn):
        print(f"error: --elastic needs the config to define "
              f"elastic_workload(); {args.config} does not", file=sys.stderr)
        return 2
    wl = wl_fn()
    try:
        host, port = _parse_hostport(args.master_addr or "127.0.0.1:0")
    except ValueError:
        print(f"error: --master_addr must be host:port, got "
              f"{args.master_addr!r}", file=sys.stderr)
        return 2
    if args.elastic == "worker":
        if not args.master_addr or not port:
            print("error: --elastic worker needs --master_addr HOST:PORT",
                  file=sys.stderr)
            return 2
        worker = ElasticWorker(wl["loss_fn"], (host, port),
                               worker=args.worker_id, device=args.device)
        # drain at the barrier: the fleet actor's subprocess backend
        # drains with SIGTERM — finish the shard in flight, push its
        # gradient, leave membership, then exit
        stop = threading.Event()
        try:
            signal.signal(signal.SIGTERM, lambda *_: stop.set())
            signal.signal(signal.SIGINT, lambda *_: stop.set())
        except ValueError:
            pass     # not the main thread (embedded runs): no handler
        summary = worker.run(stop=stop)
        print(f"elastic worker {summary['worker']} served "
              f"{summary['shards']} shard(s); job done: {summary['done']}")
        return 0 if summary["done"] else 2
    em = ElasticMaster(wl["loss_fn"], wl["optimizer"], host=host, port=port,
                       shards_per_step=args.shards_per_step,
                       min_workers=args.min_workers, ttl=args.heartbeat_ttl,
                       snapshot_dir=args.save_dir or None,
                       device=args.device)
    em.start()
    completed = False
    try:
        print(f"ELASTIC MASTER {em.address[0]} {em.address[1]}", flush=True)
        params, _, loss = em.fit(wl["batches"], wl.get("params"),
                                 num_passes=args.num_passes)
        completed = True
        print(f"elastic training done: {args.num_passes} pass(es), "
              f"final loss {loss:.6f}, membership epoch "
              f"{em.membership.epoch}")
        if args.save_dir:
            print(f"state checkpoints under {args.save_dir}")
    finally:
        # drain only after a completed run: workers leave once they see
        # the done signal, which a failed fit never sets
        em.stop(drain_s=10.0 if completed else 0.0)
    return 0


def cmd_train(args):
    from .trainer import event
    if args.compile_cache:
        print("train: --compile_cache: the port compiles no XLA programs; "
              "its kernels build into paddle_tpu_torch/_build/ at first use "
              "(ROADMAP C.14)", file=sys.stderr)
        return 2
    if args.elastic:
        return _cmd_train_elastic(args)
    cfg = _load_config(args.config)
    trainer = _make_trainer(cfg, args.device)
    costs = []

    def handler(e):
        if isinstance(e, event.EndIteration):
            costs.append(e.cost)
            if args.log_period and (e.batch_id + 1) % args.log_period == 0:
                print(f"pass {e.pass_id} batch {e.batch_id} cost {e.cost:.6f}")
        elif isinstance(e, event.EndPass):
            print(f"pass {e.pass_id} done; last cost "
                  f"{costs[-1] if costs else float('nan'):.6f}")
            if args.save_dir:
                import io

                from .trainer.checkpoint import (FORMAT_VERSION,
                                                 publish_members)
                # save_checkpoint's protocol (tmp dir, CRC manifest,
                # atomic rename), with state.json beside the tar so that
                # load_checkpoint reads the directory
                buf = io.BytesIO()
                trainer.parameters.to_tar(buf)
                state = json.dumps({"pass_id": e.pass_id,
                                    "version": FORMAT_VERSION,
                                    "pass_complete": True}).encode()
                publish_members(args.save_dir, e.pass_id,
                                [("params.tar", buf.getvalue()),
                                 ("state.json", state)])

    train_reader = cfg["train_reader"]
    srv = None
    obs_session = None
    flight = None
    pusher = None
    if args.obs_out:
        from . import obs as _obs
        obs_session = _obs.ObsSession().install()
        # until the clean save below, any death leaves the span ring and
        # counter deltas at --obs_out
        flight = _obs.FlightRecorder(obs_session, args.obs_out).arm()
    if args.local_master:
        # the whole data-dispatch cluster in this process: the task
        # master and its TCP service on a background thread, the trainer
        # its first consumer (chunk dump, get_task RPC, timeout
        # re-dispatch, as a multi-host job runs them)
        import tempfile

        from .data.chunks import cloud_reader, dump_to_chunks
        from .runtime.master_service import MasterClient, MasterServer

        chunk_dir = (os.path.join(args.save_dir, "chunks") if args.save_dir
                     else tempfile.mkdtemp(prefix="paddle_tpu_chunks_"))
        os.makedirs(chunk_dir, exist_ok=True)
        paths = dump_to_chunks(train_reader, chunk_dir,
                               samples_per_chunk=args.samples_per_chunk)
        srv = MasterServer().start()
        client = MasterClient(*srv.address)
        client.set_dataset(paths)
        print(f"local master: {len(paths)} chunks on "
              f"{srv.address[0]}:{srv.address[1]}")
        train_reader = cloud_reader(client, new_pass_at_end=True)
        if obs_session is not None:
            # the cluster-telemetry path in the one-process mode, on a
            # client of its own so that a slow push never stalls the
            # trainer's get_task
            from .obs.aggregate import ObsPusher, telemetry_client
            pusher = ObsPusher(telemetry_client(*srv.address),
                               worker=f"local-{os.getpid()}",
                               interval=2.0).start()
    try:
        trainer.train(train_reader, num_passes=args.num_passes,
                      event_handler=handler, feeding=cfg.get("feeding"))
    finally:
        # dump first: a failed run is the one whose telemetry is wanted,
        # and a teardown error must not discard it
        if pusher is not None:
            pusher.stop()
            pusher.client.close()
        if obs_session is not None:
            if flight is not None:
                flight.disarm()
            obs_session.uninstall()
            try:
                obs_session.save(args.obs_out)
            except Exception as e:
                print(f"warning: could not write obs dump {args.obs_out}: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
            else:
                print(f"observability dump written to {args.obs_out} "
                      f"(inspect: python -m paddle_tpu_torch obs summary "
                      f"--input {args.obs_out})")
        if srv is not None:
            srv.stop()
    if args.save_dir and "outputs" in cfg:
        from . import fluid
        fluid.io.export_inference_model(
            args.save_dir + "/inference",
            [dl.var.name for dl in cfg.get("feeding", [])],
            [o.var for o in cfg["outputs"]], trainer.exe)
    return 0


def cmd_test(args):
    cfg = _load_config(args.config)
    trainer = _make_trainer(cfg, args.device)
    if args.init_model_path:
        with open(args.init_model_path, "rb") as f:
            trainer.parameters.from_tar(f)
    res = trainer.test(cfg.get("test_reader", cfg["train_reader"]),
                       feeding=cfg.get("feeding"))
    print(json.dumps({"cost": res.cost}))
    return 0


def _config_workload(config_path, n_batches, device):
    """The config training step ``time`` and ``profile`` drive: load the
    config, build its trainer, take up to ``n_batches`` reader batches and
    close over feeder and fetch list. Returns ``(one, batches)``, where
    ``one(i)`` runs step *i* (batches recycle)."""
    cfg = _load_config(config_path)
    trainer = _make_trainer(cfg, device)
    batches = list(cfg["train_reader"]())[: max(n_batches, 1)]
    from .v2.trainer import _V2Feeder
    feeder = (_V2Feeder(cfg["feeding"], trainer.exe.device)
              if cfg.get("feeding") else None)
    fetch = [cfg["cost"].var]

    def one(i):
        rows = batches[i % len(batches)]
        trainer.exe.run(feed=feeder(rows) if feeder else rows,
                        fetch_list=fetch)
    return one, batches


def cmd_time(args):
    """``--job=time`` (TrainerBenchmark.cpp): steady-state ms a batch.

    Each step's fetch comes back as numpy, a host read that waits for the
    card: the clock stops only once the step has run. A fetch kept on the
    card (``return_numpy=False``) would need a ``torch.cuda.synchronize``
    before the clock is read."""
    one, _ = _config_workload(args.config, args.iters + args.warmup,
                              args.device)
    i = 0
    for _ in range(args.warmup):
        one(i)
        i += 1
    t0 = time.perf_counter()
    for _ in range(args.iters):
        one(i)
        i += 1
    ms = (time.perf_counter() - t0) / args.iters * 1e3
    print(json.dumps({"ms_per_batch": round(ms, 3)}))
    return 0


def cmd_dump_config(args):
    """Print the built Program IR as JSON (dump_config / make_diagram
    data)."""
    _load_config(args.config)
    from . import fluid
    print(json.dumps(fluid.default_main_program().to_dict(), indent=2,
                     default=str))
    return 0


def _threshold(analysis, fail_on: str):
    return {"error": analysis.Severity.ERROR,
            "warning": analysis.Severity.WARNING,
            "info": analysis.Severity.INFO}[fail_on]


def cmd_lint(args):
    """Static verification and lint of a config's Program IR: rejects
    malformed programs (undefined vars, unregistered ops, duplicate
    writes, broken sub-block scoping, shape mismatches) before anything
    runs, and reports the advisory lint catalogue (dead ops, unused vars,
    trace safety, sharding consistency), the metric catalogue (L005,
    L007), the autotune cache (L008) and the alert rules (L009).

    Exit codes (stable): 0 clean, no finding at or above ``--fail-on``;
    1 findings at or above it (or invalid bench rows); 2 usage error
    (missing or broken config, unreadable inputs).

    ``--format=json`` prints the stable machine schema on a pure-JSON
    stdout: ``{"version": 1, "findings": [{code, severity, message, hint,
    explain, site: {program, block, block_path, op, op_type, var}}],
    "summary": {errors, warnings, info, total}}`` (the human summary goes
    to stderr). The legacy ``--json`` flat list of Diagnostic dicts is
    kept. ``--explain`` annotates each finding's variable with its def-use
    chain from the dataflow plane.

    ``--bench-rows FILE...`` also (or, without --config, only) validates
    saved bench rows against ``analysis/bench_schema.py``."""
    from . import analysis, fluid
    if args.bench_rows and args.config is None:
        rc = _lint_bench_rows(args.bench_rows,
                              as_json=args.json or args.format == "json")
        if args.autotune_cache:
            rc = max(rc, _lint_autotune_only(args))
        return rc
    if args.config is None and args.autotune_cache:
        # the cache lints standalone: CI checks the file with no config
        return _lint_autotune_only(args)
    if args.config is None:
        print("lint: --config is required (or pass --bench-rows and/or "
              "--autotune-cache alone)", file=sys.stderr)
        return 2
    try:
        cfg = _load_config(args.config)
    except Exception as e:
        print(f"lint: cannot load config {args.config!r}: "
              f"{type(e).__name__}: {e}", file=sys.stderr)
        return 2
    # liveness roots: what a trainer or exporter would fetch
    fetch = []
    if "cost" in cfg:
        v = cfg["cost"]
        fetch.append(v.var.name if hasattr(v, "var") else v.name)
    for o in cfg.get("outputs") or []:
        fetch.append(o.var.name if hasattr(o, "var") else o.name)
    threshold = _threshold(analysis, args.fail_on)
    mesh_axes = args.mesh_axes.split(",") if args.mesh_axes else None
    all_diags = []
    for label, prog in (("main", fluid.default_main_program()),
                        ("startup", fluid.default_startup_program())):
        prog_fetch = fetch if label == "main" else []
        diags = analysis.analyze_program(prog, fetch=prog_fetch,
                                         mesh_axes=mesh_axes)
        for d in diags:
            d.program = label
        if args.explain and any(d.var for d in diags):
            # the dataflow plane may fail on a program with structural
            # errors: the findings stand alone then
            try:
                df = analysis.analyze_dataflow(prog, fetch=prog_fetch)
                for d in diags:
                    if d.var:
                        d.explain = analysis.explain_var(df, d.var)
            except Exception:
                pass
        all_diags.extend(diags)
    from . import obs as _obs
    for d in analysis.lint_metric_names(_obs.CATALOGUE):        # L005
        d.program = "obs"
        all_diags.append(d)
    for d in analysis.lint_catalogue_drift():                   # L007
        d.program = "obs"
        all_diags.append(d)
    for d in analysis.lint_autotune_cache(args.autotune_cache):  # L008
        d.program = "autotune"
        all_diags.append(d)
    for d in analysis.lint_alert_rules():                       # L009
        d.program = "obs"
        all_diags.append(d)
    n_err = len(analysis.errors(all_diags))
    n_warn = sum(1 for d in all_diags
                 if d.severity == analysis.Severity.WARNING)
    summary = (f"lint: {n_err} error(s), {n_warn} warning(s), "
               f"{len(all_diags) - n_err - n_warn} info over "
               f"{sum(len(b.ops) for b in fluid.default_main_program().blocks)} "
               "main-program op(s)")
    as_json = args.json or args.format == "json"
    if args.format == "json":
        # the stable schema; stdout stays pure JSON (`| jq` works)
        print(json.dumps(_lint_json_payload(all_diags, n_err, n_warn),
                         indent=1, sort_keys=True))
        print(summary, file=sys.stderr)
    elif args.json:
        print(json.dumps([d.to_dict() for d in all_diags], indent=1))
        print(summary, file=sys.stderr)
    else:
        if all_diags:
            print(analysis.format_diagnostics(all_diags))
        print(summary)
    failed = any(d.severity >= threshold for d in all_diags)
    if args.bench_rows:
        # in either JSON mode the bench-row findings go to stderr
        rc = _lint_bench_rows(args.bench_rows,
                              stream=sys.stderr if as_json else sys.stdout)
        failed = failed or rc != 0
    return 1 if failed else 0


def _lint_json_payload(diags, n_err: int, n_warn: int) -> dict:
    """The ``lint --format=json`` schema. Stable: additions only, and a
    shape change bumps ``version``. Every finding has every key (null when
    absent)."""
    return {
        "version": 1,
        "findings": [{
            "code": d.code,
            "severity": str(d.severity),
            "message": d.message,
            "hint": d.hint,
            "explain": d.explain,
            "site": {
                "program": d.program,
                "block": d.block_idx,
                "block_path": d.block_path,
                "op": d.op_idx,
                "op_type": d.op_type,
                "var": d.var,
            },
        } for d in diags],
        "summary": {"errors": n_err, "warnings": n_warn,
                    "info": len(diags) - n_err - n_warn,
                    "total": len(diags)},
    }


def _lint_autotune_only(args) -> int:
    """``lint --autotune-cache FILE`` with no config: the L008 findings
    only. 0 clean, 1 findings at or above --fail-on."""
    from . import analysis
    diags = analysis.lint_autotune_cache(args.autotune_cache)
    threshold = _threshold(analysis, args.fail_on)
    if args.json:
        print(json.dumps([d.to_dict() for d in diags], indent=1))
    elif diags:
        print(analysis.format_diagnostics(diags))
    print(f"lint: autotune cache — {len(diags)} finding(s)",
          file=sys.stderr if args.json else sys.stdout)
    return 1 if any(d.severity >= threshold for d in diags) else 0


def _lint_bench_rows(paths, as_json: bool = False, stream=None) -> int:
    """Validate bench-row files (JSON array/object or JSONL) against the
    bench-row schema; 0 clean, 1 findings, 2 unreadable input. ``as_json``
    prints the findings as a JSON array on stdout instead of text
    lines."""
    from .analysis.bench_schema import validate_row
    stream = stream if stream is not None else sys.stdout
    findings = []

    def emit(path, ln, name, problem):
        findings.append({"code": "B001", "path": path, "line": ln,
                         "metric": name, "message": problem})
        if not as_json:
            print(f"{path}:{ln}: B001 bench-row-schema: {name}: {problem}",
                  file=stream)

    n_rows = n_bad = 0
    for path in paths:
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            print(f"lint: cannot read bench rows {path!r}: {e}",
                  file=sys.stderr)
            return 2
        rows = []
        try:
            data = json.loads(text)
            if isinstance(data, dict) and "metric" not in data \
                    and isinstance(data.get("tail"), str):
                # a bench record (BENCH_r0x.json): the rows are JSONL in
                # its "tail"
                text = data["tail"]
                raise ValueError("bench record: parse tail as JSONL")
            rows = data if isinstance(data, list) else [data]
        except ValueError:
            for ln, line in enumerate(text.splitlines(), 1):
                line = line.strip()
                if not line.startswith("{"):
                    continue      # log noise, truncated tail heads
                try:
                    rows.append((ln, json.loads(line)))
                except ValueError as e:
                    emit(path, ln, "<no metric>", f"not valid JSON: {e}")
                    n_bad += 1
        rows = [r if isinstance(r, tuple) else (i + 1, r)
                for i, r in enumerate(rows)]
        for ln, row in rows:
            n_rows += 1
            for problem in validate_row(row):
                name = (row.get("metric", "<no metric>")
                        if isinstance(row, dict) else "<not a dict>")
                emit(path, ln, name, problem)
                n_bad += 1
    if as_json:
        print(json.dumps(findings, indent=1))
        print(f"lint: bench rows — {n_bad} problem(s) over {n_rows} "
              "row(s)", file=sys.stderr)
    else:
        print(f"lint: bench rows — {n_bad} problem(s) over {n_rows} "
              "row(s)", file=stream)
    return 1 if n_bad else 0


def _check_fused_rnn(tune, report, r, device):
    """The tuned row tile of one fused_rnn row through ``ops.rnn_kernels``'
    consult (``route_for``, planned for the limits the sweep took): the
    route it returns must be the route of the tuned plan. None when it
    is, else the problem."""
    import torch

    from .ops import rnn_kernels as rk
    from .tune import driver as _driver
    fam = next(f for f in tune.PROFILES[report["profile"]]["fused_families"]
               if tune.fused_family(gates=f["gates"], T=f["T"], H=f["H"],
                                    batch=f["batch"]) == r["family"])
    lim = _driver._limits(device)
    xw = torch.empty((fam["batch"], fam["T"], fam["gates"] * fam["H"]),
                     device="meta")
    with rk.forced_limits(*lim):
        got = rk.route_for(r["kernel"], xw, fam["H"])
    want = tune.spaces.route_of(r["plan"], kernel=r["kernel"], H=fam["H"],
                                batch=fam["batch"], limits=lim)
    if want is None or got != want:
        return (f"fused_rnn/{r['kernel']}/{r['family']}: consult returned "
                f"{got and (got.kind, got.tiles)}, tuned {r['plan']}")
    return None


def _check_decode_route(tune, r):
    """The tuned split counts through ``cuda_kernels.decode_splits`` and
    the crossover through ``decode_kernel_min_len``."""
    from .ops import cuda_kernels as ck
    problems = []
    if tune.decode_kernel_min_len() is tune.MISS:
        problems.append("decode_route: consult missed the tuned entry")
    for fam, n in sorted(r["plan"]["splits"].items()):
        bh, L = map(int, fam.split("x"))
        got = ck.decode_splits(bh, L)[0]
        if got != n:
            problems.append(f"decode_route/{fam}: decode_splits returned "
                            f"{got}, tuned {n}")
    return problems


def cmd_tune(args):
    """Measured autotuning: enumerate the candidate plans of each (kernel,
    shape family, device kind), time each on ``--device`` (warm-up outside
    the window, best of the reps, methodology "measured") and merge the
    winners into the port's autotune cache, which the routing entries
    consult (``ops/rnn_kernels.route_for``' row tiles,
    ``ops/cuda_kernels.decode_splits``' split counts, the paged cache's
    ``page_block``, the serving bucket grids, the fluid executor's
    fusion). On the CPU the sweep times the kernels' plain versions at
    proxy dims; on the card, the kernels.

    ``--check`` is the CI smoke: a seconds-long sweep into --cache (or a
    temporary file), then proof that the loop closes — the written entries
    reload and the consults resolve them. Exit 0 healthy, 1 broken."""
    import tempfile

    from . import tune
    spaces = (tuple(s for s in args.spaces.split(",") if s)
              if args.spaces else None)
    profile = args.profile
    cache_path = args.cache
    if args.check:
        if args.dry_run:
            # --check proves that the written cache reloads and consults;
            # with nothing written there is nothing to check
            print("tune: --check writes a cache to verify the loop; drop "
                  "--dry-run (or point --cache at a scratch file)",
                  file=sys.stderr)
            return 2
        profile = profile or "smoke"
        if cache_path is None:
            cache_path = os.path.join(tempfile.mkdtemp(prefix="pt_tune_"),
                                      "autotune.json")
    try:
        report = tune.run_tune(spaces=spaces, profile=profile,
                               cache_path=cache_path, reps=args.reps,
                               save=not args.dry_run,
                               from_ledger=args.from_ledger,
                               ledger_topk=args.ledger_topk,
                               device=args.device)
    except (OSError, ValueError, KeyError) as e:
        print(f"tune: {e}", file=sys.stderr)
        return 2
    if not args.json and report.get("ledger"):
        led = report["ledger"]
        names = [s["op"] for s in led["sites"] if s.get("space")]
        print(f"tune: ledger {led['path']}: top-{led['topk']} sites "
              f"implicate spaces {led['seeded_spaces'] or 'none'} "
              f"(hot ops: {names[:4] or 'no matches'}); sweeping "
              f"{led['swept_spaces']}")
    if args.json:
        print(json.dumps(report, indent=1))
    elif args.markdown:
        print(tune.results_markdown(report))
    else:
        for r in report["results"]:
            if r.get("plan") is None and "skipped" in r:
                print(f"tune: {r['space']}/{r['kernel']} {r['family']}: "
                      f"{r['skipped']}")
                continue
            extra = ""
            if r.get("speedup") is not None:
                extra = (f"  ({r['tuned_ms']} ms vs heuristic "
                         f"{r['heuristic_ms']} ms, {r['speedup']}x)")
            print(f"tune: {r['space']}/{r['kernel']} {r['family']}: "
                  f"plan {r['plan']}{extra}")
        print(f"tune: device_kind={report['device_kind']} "
              f"backend={report['backend']} profile={report['profile']}"
              + (f" -> {report['cache_path']}" if report["cache_path"]
                 else " (dry run, nothing written)"))
    if not args.check:
        return 0
    # --check: reload the file, then consult it through the entry points
    # the routes use
    problems = []
    path = report["cache_path"]
    try:
        cache = tune.load_cache(path)
    except (OSError, ValueError) as e:
        print(f"tune: --check FAILED: written cache does not reload: {e}",
              file=sys.stderr)
        return 1
    prev_env = os.environ.get(tune.CACHE_ENV)
    os.environ[tune.CACHE_ENV] = path
    tune.reset()
    try:
        for r in report["results"]:
            if r.get("plan") is None and "skipped" in r:
                continue
            if cache.get(r["space"], r["kernel"], report["device_kind"],
                         r["family"]) is None:
                problems.append(f"{r['space']}/{r['family']}: entry "
                                "missing after reload")
            if r["space"] == "fused_rnn":
                p = _check_fused_rnn(tune, report, r, args.device)
                if p:
                    problems.append(p)
            elif r["space"] == "decode_route":
                problems.extend(_check_decode_route(tune, r))
            elif r["space"] == "page_block":
                bs = r["plan"]["page_block"]
                if tune.page_block(bs * 8, bs * 4) != bs:
                    problems.append("page_block: consult missed the "
                                    "tuned entry")
            elif r["space"] == "bucket_grid":
                got = tune.bucket_grid(r["family"])
                if got != tuple(r["plan"]["buckets"]):
                    problems.append(f"bucket_grid/{r['family']}: consult "
                                    f"returned {got}, tuned "
                                    f"{r['plan']['buckets']}")
        # fusion: rebuild the proxy program the sweep measured; every
        # persisted family must resolve through the whole consult chain
        # (certificate re-validation included): a winner activates, a
        # measured loser refuses with measured_slower
        fusion_rows = [r for r in report["results"]
                       if r["space"] == "fusion" and r.get("plan")]
        if fusion_rows:
            from .tune import fusion as _fusion
            fcfg = tune.PROFILES[report["profile"]]["fusion"]
            main, _startup, feed, fetch = _fusion.build_proxy_program(
                batch=fcfg["batch"], width=fcfg["width"],
                depth=fcfg["depth"])
            plan = _fusion.plan_for(
                main, {k: v.shape for k, v in feed.items()},
                fetch=fetch, feed=list(feed))
            refused = dict(plan.rejected)
            for r in fusion_rows:
                fam = r["family"]
                if r["plan"]["fuse"]:
                    if fam not in plan.families:
                        problems.append(
                            f"fusion/{fam}: measured winner did not "
                            f"activate (rejected: "
                            f"{refused.get(fam, 'missing')})")
                elif refused.get(fam) != "measured_slower":
                    problems.append(
                        f"fusion/{fam}: measured loser should refuse "
                        f"with measured_slower, got "
                        f"{refused.get(fam, 'activated')}")
        if tune.plan_source() != "tuned":
            problems.append("plan_source() != 'tuned' with a fresh cache")
    finally:
        if prev_env is None:
            os.environ.pop(tune.CACHE_ENV, None)
        else:
            os.environ[tune.CACHE_ENV] = prev_env
        tune.reset()
    if problems:
        for p in problems:
            print(f"tune: --check FAILED: {p}", file=sys.stderr)
        return 1
    print(f"tune: --check OK ({len(report['results'])} plan-space "
          f"sweeps measured, persisted, reloaded, and consulted)")
    return 0


def cmd_merge_model(args):
    """Merge a params tar and the config into one inference bundle
    (trainer/MergeModel.cpp): ``model.json`` and ``params.tar``, JAX's
    files byte for byte."""
    cfg = _load_config(args.config)
    trainer = _make_trainer(cfg, args.device)
    with open(args.model_path, "rb") as f:
        trainer.parameters.from_tar(f)
    from . import fluid
    outs = cfg.get("outputs") or [cfg["cost"]]
    fluid.io.export_inference_model(
        args.output_dir, [dl.var.name for dl in cfg.get("feeding", [])],
        [o.var for o in outs], trainer.exe)
    print(f"merged model written to {args.output_dir}")
    return 0


def cmd_checkgrad(args):
    """``--job=checkgrad`` (TrainerMain.cpp, Trainer::checkGradient): the
    program's autodiff gradients against central differences on sampled
    parameter entries, through the executor. The perturbed parameter goes
    into the scope as a new tensor on the executor's device; a graphed run
    copies it into its static buffer, so no run reads a stale value."""
    import numpy as np
    import torch

    from . import fluid
    cfg = _load_config(args.config)
    trainer = _make_trainer(cfg, args.device)
    feeder = None
    if cfg.get("feeding"):
        from .v2.trainer import _V2Feeder
        feeder = _V2Feeder(cfg["feeding"], trainer.exe.device)
    rows = next(iter(cfg["train_reader"]()))
    feed = feeder(rows) if feeder else rows
    exe = trainer.exe
    prog = fluid.default_main_program()
    cost_name = cfg["cost"].var.name
    params = [v.name for v in prog.global_block().all_parameters()]
    # pruned programs: the whole program would run the optimizer's update
    # ops between evaluations. Random ops key off the implicit __step__
    # feed: pinned, every evaluation draws the same masks and samples
    feed = dict(feed)
    feed["__step__"] = 0
    cost_prog = prog.prune([cost_name])
    grad_names = [p + "@GRAD" for p in params]
    grad_prog = prog.prune(grad_names)
    all_grads = exe.run(grad_prog, feed=feed, fetch_list=grad_names)
    rs = np.random.RandomState(0)
    eps = args.eps
    worst = 0.0
    ok = True

    def put(name, arr):
        exe.scope.set(name, torch.tensor(arr, device=exe.device))

    for pname, grad in zip(params, all_grads):
        grad = np.asarray(grad)
        base = exe.scope.get(pname).detach().cpu().numpy().copy()
        flat = base.reshape(-1)
        for idx in rs.choice(flat.size,
                             size=min(args.checks_per_param, flat.size),
                             replace=False):
            orig = flat[idx]
            vals = {}
            for sign in (+1, -1):
                flat[idx] = orig + sign * eps
                put(pname, base)
                vals[sign], = exe.run(cost_prog, feed=feed,
                                      fetch_list=[cost_name])
            flat[idx] = orig
            put(pname, base)
            numeric = (float(vals[+1]) - float(vals[-1])) / (2 * eps)
            analytic = float(grad.reshape(-1)[idx])
            denom = max(abs(numeric), abs(analytic), 1e-6)
            rel = abs(numeric - analytic) / denom
            worst = max(worst, rel)
            if rel > args.rtol:
                print(f"MISMATCH {pname}[{idx}]: numeric {numeric:.6g} "
                      f"analytic {analytic:.6g} rel {rel:.3g}")
                ok = False
    print(f"checkgrad {'PASS' if ok else 'FAIL'} "
          f"({len(params)} params, worst rel err {worst:.3g})")
    return 0 if ok else 1


def _poll_job(procs, timeout: float, grace: float) -> int:
    """The failure-detection loop: the moment any worker fails (or the
    deadline passes), SIGTERM the survivors with a teardown grace, then
    SIGKILL stragglers. Returns the job's rc."""
    rc = 0
    deadline = time.time() + timeout
    try:
        pending = list(procs)
        while pending:
            for p in list(pending):
                code = p.poll()
                if code is not None:
                    pending.remove(p)
                    if code and not rc:
                        rc = code
                        print(f"cluster_train: worker {procs.index(p)} "
                              f"exited rc={code}; tearing the job down "
                              f"(survivors get SIGTERM, {grace:.0f}s "
                              f"grace).", file=sys.stderr)
            if not rc and time.time() > deadline:
                rc = 124
                print(f"cluster_train: --timeout {timeout:.0f}s "
                      f"exceeded; tearing the job down.", file=sys.stderr)
            if rc:     # a peer failed or the deadline passed
                for p in pending:
                    if p.poll() is None:
                        p.terminate()   # survivors run their teardown hook
                grace_end = time.time() + grace
                while (any(p.poll() is None for p in pending)
                       and time.time() < grace_end):
                    time.sleep(0.1)
                break
            time.sleep(0.2)
    finally:
        for p in procs:           # a dead or hung peer strands no one
            if p.poll() is None:
                p.kill()
    return rc


def _cluster_attempt(args, attempt: int) -> int:
    """One local launch: every worker on a fresh coordinator port, then
    the failure-detection loop. A worker is one rank of one device."""
    import socket
    import subprocess

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()

    procs = []
    for i in range(args.num_workers):
        env = dict(os.environ)
        env["PADDLE_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        env["PADDLE_TPU_NUM_PROCESSES"] = str(args.num_workers)
        env["PADDLE_TPU_PROCESS_ID"] = str(i)
        env["PADDLE_TPU_RESTART_COUNT"] = str(attempt)
        procs.append(subprocess.Popen(
            [sys.executable, args.script] + (args.script_args or []),
            env=env))
    return _poll_job(procs, args.timeout, args.grace)


def _cluster_hosts(args):
    """Host list from --hosts (comma-separated) or --hostfile (one host a
    line, '#' comments): the reference launcher's conf.py HOSTS."""
    hosts = []
    if args.hosts:
        hosts += [h.strip() for h in args.hosts.split(",") if h.strip()]
    if args.hostfile:
        with open(args.hostfile) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if line:
                    hosts.append(line)
    return hosts


def _render_host_commands(args, hosts, attempt: int = 0,
                          job_id: str = "dryrun"):
    """The launch command line of each host of a multi-host job (the
    reference's fabric/ssh launcher, scripts/cluster_train/paddle.py):
    node 0's host serves the coordinator, every node gets its process id
    and the world size through PADDLE_TPU_* (read by
    ``parallel/multihost.initialize``).

    ``--ssh-template`` wraps each node's command; placeholders ``{host}``
    and ``{cmd}`` (shell-quoted). Default: ssh <host> '<cmd>'.

    Each node runs inside a small bash supervisor whose command line
    carries ``PADDLE_TPU_JOB_ID=<id>`` and which forwards SIGTERM to the
    python child: that makes the job reapable remotely (``pkill -f
    PADDLE_TPU_JOB_ID=<id>``, :func:`_reap_remote_job`), since signalling
    an ssh client does not signal the remote process.

    The coordinator address strips an ssh ``user@`` prefix from node 0's
    host, and its port is offset by the attempt number, so that a restart
    never meets a stale coordinator socket of the previous attempt."""
    import shlex

    coord_host = hosts[0].rsplit("@", 1)[-1]   # user@host is ssh login only
    coordinator = f"{coord_host}:{args.coordinator_port + attempt}"
    template = args.ssh_template or "ssh {host} {cmd}"
    lines = []
    for i, host in enumerate(hosts):
        inner = " ".join(
            [f"PADDLE_TPU_JOB_ID={job_id}",
             f"PADDLE_TPU_COORDINATOR={coordinator}",
             f"PADDLE_TPU_NUM_PROCESSES={len(hosts)}",
             f"PADDLE_TPU_PROCESS_ID={i}",
             f"PADDLE_TPU_RESTART_COUNT={attempt}",
             args.remote_python, shlex.quote(args.script)]
            + [shlex.quote(a) for a in (args.script_args or [])])
        # the supervisor's /proc cmdline holds the job id (the exec'd
        # python's does not); TERM and INT go on to the child
        wrapped = ("bash -c " + shlex.quote(
            'trap "kill -TERM $c 2>/dev/null" TERM INT; '
            + inner + " & c=$!; wait $c"))
        lines.append(template.format(host=shlex.quote(host),
                                     cmd=shlex.quote(wrapped)))
    return lines


def _reap_remote_job(args, hosts, job_id: str):
    """Best-effort remote teardown: a targeted pkill over ssh to every
    host, so that a crashed job's survivors do not keep the cards (the
    reference's paddle.py kill_process). TERM first, then KILL."""
    import shlex
    import subprocess

    template = args.ssh_template or "ssh {host} {cmd}"
    # the first id character bracketed: the pattern still matches the job
    # id in the supervisors' command lines, but not the reaping shell's
    # own (which holds "...=[x]yz"), so pkill never TERMs that shell
    pat = f"PADDLE_TPU_JOB_ID=[{job_id[0]}]{job_id[1:]}"
    kill = (f"pkill -TERM -f {shlex.quote(pat)}; sleep 2; "
            f"pkill -KILL -f {shlex.quote(pat)}; true")
    for host in hosts:
        cmd = template.format(host=shlex.quote(host), cmd=shlex.quote(kill))
        try:
            subprocess.run(cmd, shell=True, timeout=30,
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
        except Exception:
            pass                       # a dead host cannot be reaped anyway


def _multihost_attempt(args, hosts, attempt: int) -> int:
    """One multi-host launch: run every rendered host command (ssh by
    default) under the local path's any-failure-tears-all-down contract,
    reaping the remote workers too, not only the local ssh clients."""
    import subprocess

    # dot-free: the id doubles as a pkill -f pattern in the reaper
    job_id = f"{os.getpid():x}x{attempt}"
    cmds = _render_host_commands(args, hosts, attempt, job_id)
    procs = [subprocess.Popen(c, shell=True) for c in cmds]
    rc = _poll_job(procs, args.timeout, args.grace)
    if rc:
        _reap_remote_job(args, hosts, job_id)
    return rc


def cmd_cluster_train(args):
    """The local cluster launcher (scripts/cluster_train/paddle.py and
    cluster_train_v2's fabric/openmpi, process-model edition).

    Spawns ``--num_workers`` worker processes that join one
    ``torch.distributed`` world (coordinator on localhost; PADDLE_TPU_*
    carries the membership) and each run SCRIPT, which calls
    ``paddle_tpu_torch.parallel.multihost.initialize()`` to join. A
    failing worker tears the job down (its rc propagated). A worker is one
    rank of one device: ``--devices_per_worker`` above 1 is refused.

    ``--restart-on-failure N``: a synchronous job cannot go on without
    one of its ranks, so recovery is job-grained: tear down, then relaunch
    every worker on a fresh coordinator, up to N times. Scripts resume
    from their latest pass checkpoint; ``PADDLE_TPU_RESTART_COUNT`` tells
    the script its attempt. Timeouts are per attempt.

    With ``--hosts``/``--hostfile`` the same job runs on real machines:
    each host's launch command is rendered (``--ssh-template``) around
    the membership variables — node 0's host carries the coordinator at
    ``--coordinator-port`` — and run (ssh by default), or printed with
    ``--dry-run``."""
    if args.devices_per_worker > 1:
        print(f"cluster_train: --devices_per_worker "
              f"{args.devices_per_worker}: a worker of the port is one "
              "rank with one device (ROADMAP C.11, C.14); launch "
              "more workers with --num_workers instead", file=sys.stderr)
        return 2
    hosts = _cluster_hosts(args)
    if hosts:
        # the world is the host list in this mode: say so rather than
        # dropping an explicitly passed local option
        if args.num_workers is not None:
            print(f"cluster_train: --hosts mode runs one node per host "
                  f"({len(hosts)}); ignoring --num_workers "
                  f"{args.num_workers}.", file=sys.stderr)
        if args.devices_per_worker:
            print("cluster_train: --devices_per_worker is a local-mode "
                  "option; ignored with --hosts.", file=sys.stderr)
    if args.dry_run:
        if not hosts:
            print("cluster_train: --dry-run needs --hosts/--hostfile",
                  file=sys.stderr)
            return 2
        for line in _render_host_commands(args, hosts):
            print(line)
        return 0
    if args.num_workers is None:
        args.num_workers = 2             # local mode's default world size
    restarts = max(0, args.restart_on_failure or 0)
    for attempt in range(restarts + 1):
        rc = (_multihost_attempt(args, hosts, attempt) if hosts
              else _cluster_attempt(args, attempt))
        if rc == 0:
            return 0
        if attempt < restarts:
            print(f"cluster_train: attempt {attempt} failed rc={rc}; "
                  f"relaunching from the latest checkpoint "
                  f"({restarts - attempt} restart(s) left).", file=sys.stderr)
        else:
            print("cluster_train: restart budget exhausted."
                  if restarts else
                  "cluster_train: failed (pass --restart-on-failure N for "
                  "elastic recovery).", file=sys.stderr)
    return rc


def cmd_make_diagram(args):
    """Model visualization (submit_local.sh.in make_diagram): a graphviz
    .dot of the config's Program — ops as boxes, data flow as edges,
    parameters dashed."""
    from . import fluid
    _load_config(args.config)
    prog = fluid.default_main_program()
    lines = ["digraph G {", "  rankdir=TB;",
             '  node [fontsize=10, fontname="Helvetica"];']
    params = {v.name for v in prog.global_block().all_parameters()}
    var_nodes = set()
    for bi, block in enumerate(prog.blocks):
        for oi, op in enumerate(block.ops):
            op_id = f"op_{bi}_{oi}"
            lines.append(f'  {op_id} [shape=box, style=filled, '
                         f'fillcolor="#DDEEFF", label="{op.type}"];')
            for names in op.inputs.values():
                for n in names:
                    var_nodes.add(n)
                    lines.append(f'  "{n}" -> {op_id};')
            for names in op.outputs.values():
                for n in names:
                    var_nodes.add(n)
                    lines.append(f'  {op_id} -> "{n}";')
    for n in sorted(var_nodes):          # one declaration a variable
        style = ", style=dashed" if n in params else ""
        lines.append(f'  "{n}" [shape=ellipse{style}];')
    lines.append("}")
    out = args.output or (os.path.splitext(args.config)[0] + ".dot")
    with open(out, "w") as f:
        f.write("\n".join(lines))
    n_ops = sum(len(b.ops) for b in prog.blocks)
    print(f"wrote {out} ({n_ops} ops, {len(params)} parameters)")
    return 0


def cmd_cluster_autoscale(args):
    """``cluster autoscale`` — the fleet actor: watch the membership and
    health planes and drive the fleet to them — spawn workers on a
    sustained join recommendation or an SLO burn, drain them on leave or
    scale-in, yield training capacity to serving under a shared
    ``--total-workers`` budget.

    Populations come from the flags: ``--train-master HOST:PORT`` with
    ``--train-cmd`` (a launch template with ``{worker}``, and optionally
    ``{python}``) drives an elastic training pool; ``--router HOST:PORT``
    with ``--decode-cmd`` a decode serving pool toward
    ``--decode-target``. At least one population is required. A spawned
    process must join the matching membership plane under the worker name
    the actor passed: that, not its exit status, is the success test."""
    from . import obs as _obs
    from .cluster import (ActorReporter, FleetActor, MasterProbe,
                          Population, RouterProbe, SubprocessSpawnBackend)

    populations, closers = [], []
    for flag, cmd_flag, name, probe_cls, target in (
            ("train_master", "train_cmd", "train", MasterProbe, None),
            ("router", "decode_cmd", "serve", RouterProbe,
             args.decode_target)):
        addr = getattr(args, flag)
        if not addr:
            continue
        try:
            parsed = _parse_hostport(addr)
        except ValueError:
            parsed = None
        if parsed is None or not parsed[1]:
            print(f"cluster autoscale: --{flag.replace('_', '-')} must be "
                  f"host:port, got {addr!r}", file=sys.stderr)
            return 2
        template = getattr(args, cmd_flag)
        if not template or "{worker}" not in template:
            print(f"cluster autoscale: --{cmd_flag.replace('_', '-')} must "
                  f"be a launch template containing {{worker}}",
                  file=sys.stderr)
            return 2
        host, port = parsed
        probe = probe_cls(host, port)
        reporter = ActorReporter(host, port, args.actor)
        closers.extend((probe, reporter))
        populations.append(Population(
            name=name, backend=SubprocessSpawnBackend(template),
            probe=probe, reporter=reporter,
            min_workers=getattr(args, f"{name}_min"),
            max_workers=getattr(args, f"{name}_max"),
            target=target))
    if not populations:
        print("cluster autoscale: pass --train-master/--train-cmd and/or "
              "--router/--decode-cmd", file=sys.stderr)
        return 2

    session = _obs.ObsSession().install()
    actor = FleetActor(populations, total_workers=args.total_workers,
                       interval_s=args.interval, cooldown_s=args.cooldown,
                       max_churn=args.max_churn,
                       spawn_grace_s=args.spawn_grace,
                       drain_grace_s=args.drain_grace, name=args.actor)
    pops = ", ".join(f"{q.name}[{q.min_workers}..{q.max_workers}"
                     + (f"->{q.target}]" if q.target is not None else "]")
                     for q in populations)
    print(f"AUTOSCALE ACTOR {args.actor}", flush=True)
    print(f"  populations: {pops}  interval={args.interval:g} "
          f"cooldown={args.cooldown:g} max_churn={args.max_churn}"
          + (f" total={args.total_workers}" if args.total_workers else ""),
          flush=True)
    stop = threading.Event()

    def _on_term(signum, frame):
        stop.set()

    try:
        signal.signal(signal.SIGTERM, _on_term)
        signal.signal(signal.SIGINT, _on_term)
    except ValueError:
        pass
    try:
        if args.once:
            for entry in actor.step():
                print(f"  {entry['action']} {entry['population']}/"
                      f"{entry['worker']}: {entry['reason']}", flush=True)
        else:
            actor.run(stop=stop)
            if actor.deposed:
                print("cluster autoscale: deposed by a newer actor "
                      "registration; exiting", file=sys.stderr)
                return 2
    finally:
        for c in closers:
            try:
                c.close()
            except Exception:
                pass
        session.uninstall()
    return 0


# -- serving ---------------------------------------------------------------------

def _parse_hostport(s: str):
    host, _, port = str(s).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"expected HOST:PORT, got {s!r}")
    return host, int(port)


def _model(args):
    """The served model on ``--device``: the config's, or one built from
    the flags with weights drawn from ``--seed``."""
    from .core.place import require_device
    device = require_device(args.device)
    if args.config:
        cfg = runpy.run_path(args.config)
        if "model" not in cfg or "params" not in cfg:
            raise ValueError("--config must expose module-level `model` and "
                             "`params`")
        model, params = cfg["model"], cfg["params"]
        if params is not None:
            from .convert import params_from_numpy
            return params_from_numpy(params, model, device)
        return model
    from .models import TransformerLM
    return TransformerLM(args.vocab, d_model=args.d_model,
                         n_heads=args.n_heads, n_layers=args.n_layers,
                         max_len=args.max_len).init(seed=args.seed,
                                                    device=device)


def _obs_session(args):
    """(session, flight recorder or None): the obs session ``serve`` and
    ``route`` run under, and with ``--obs_out`` a flight recorder armed at
    that path for a post-mortem of a death."""
    from . import obs
    session = obs.ObsSession().install()
    flight = None
    if args.obs_out:
        flight = obs.FlightRecorder(session, args.obs_out).arm()
    return session, flight


def _obs_close(session, flight, out=None) -> None:
    """Disarm the recorder, write the dump to ``out`` (before the
    uninstall: the dump holds the request ledger only while the plane is
    installed) and uninstall the session."""
    if flight is not None:
        flight.disarm()
    if out:
        try:
            session.save(out)
            print(f"observability dump written to {out}", flush=True)
        except Exception as e:
            print(f"warning: could not write obs dump: {e}",
                  file=sys.stderr)
    session.uninstall()


def _role_name_session(session, role, worker=None):
    """Rename an installed ObsSession after its serving role (``router``,
    ``prefill:<worker>``, ``decode:<worker>``) — the lane name the Chrome
    exporter ranks and the worker id merged request timelines stitch
    under. An explicit PADDLE_TPU_OBS_PROCESS wins."""
    if os.environ.get("PADDLE_TPU_OBS_PROCESS"):
        return
    session.process = f"{role}:{worker}" if worker else role


def _wait_for_signal() -> None:
    """Block until SIGTERM or SIGINT."""
    stop = threading.Event()

    def _on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _on_term)
    signal.signal(signal.SIGINT, _on_term)
    while not stop.wait(0.5):
        pass


def cmd_serve(args):
    """``serve``: the serving daemon; see the module docstring."""
    from .serving import ServingDaemon, ServingEngine
    if args.role == "prefill" and not args.router:
        print("serve: --role prefill requires --router HOST:PORT "
              "(a prefill worker only receives work via the router)",
              file=sys.stderr)
        return 2
    try:
        model = _model(args)
    except ValueError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    session, flight = _obs_session(args)
    if args.role == "prefill":
        return _serve_prefill(args, model, session, flight)
    try:
        engine = ServingEngine(
            model, slots=args.slots, segment=args.segment,
            page_block=args.page_block, pages=args.pages,
            cache_bucket=args.cache_bucket, kv_dtype=args.kv_dtype,
            queue_cap=args.queue_cap,
            default_timeout_s=args.request_timeout,
            prefix_cache=not args.no_prefix_cache,
            class_weights={"interactive": args.interactive_weight,
                           "batch": args.batch_weight},
            max_tenants=args.max_tenants, device=model.device)
    except ValueError as e:
        _obs_close(session, flight)
        print(f"serve: {e}", file=sys.stderr)
        return 2
    try:
        daemon = ServingDaemon(engine, args.host, args.port).start()
    except OSError as e:
        engine.stop()
        _obs_close(session, flight)
        print(f"serve: cannot bind {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 2
    host, port = daemon.address
    _role_name_session(session, "decode", args.worker or f"serve-{port}")
    print(f"SERVING {host} {port}", flush=True)
    if args.router:
        try:
            epoch = daemon.join_router(
                _parse_hostport(args.router),
                args.worker or f"serve-{port}", role="decode")
        except Exception as e:
            daemon.stop()
            _obs_close(session, flight)
            print(f"serve: cannot join router {args.router}: {e}",
                  file=sys.stderr)
            return 2
        print(f"JOINED {args.router} epoch {epoch}", flush=True)
    print(f"  slots={args.slots} segment={args.segment} "
          f"page_block={engine.pool.bs} "
          f"pages={engine.pool.pages} queue_cap={args.queue_cap} "
          f"prefix_cache={'off' if args.no_prefix_cache else 'on'} "
          f"weights=interactive:{args.interactive_weight:g}/"
          f"batch:{args.batch_weight:g} device={model.device}"
          + (f" kv_dtype={args.kv_dtype}" if args.kv_dtype else ""),
          flush=True)
    try:
        _wait_for_signal()
    finally:
        daemon.stop(drain_s=args.drain)
        _obs_close(session, flight, args.obs_out)
    return 0


def _serve_prefill(args, model, session, flight):
    """``serve --role prefill``: a pool-only worker that admits and exports
    KV pages and ships them to the router-chosen decode worker."""
    from .serving import PagePool, PrefillDaemon
    try:
        pool = PagePool(model, slots=args.slots, segment=args.segment,
                        page_block=args.page_block, pages=args.pages,
                        cache_bucket=args.cache_bucket,
                        kv_dtype=args.kv_dtype,
                        prefix_cache=not args.no_prefix_cache,
                        device=model.device)
    except ValueError as e:
        _obs_close(session, flight)
        print(f"serve: {e}", file=sys.stderr)
        return 2
    try:
        daemon = PrefillDaemon(pool, args.host, args.port).start()
    except OSError as e:
        _obs_close(session, flight)
        print(f"serve: cannot bind {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 2
    host, port = daemon.address
    _role_name_session(session, "prefill", args.worker or f"prefill-{port}")
    print(f"SERVING {host} {port}", flush=True)
    try:
        epoch = daemon.join_router(_parse_hostport(args.router),
                                   args.worker or f"prefill-{port}",
                                   role="prefill")
    except Exception as e:
        daemon.stop()
        _obs_close(session, flight)
        print(f"serve: cannot join router {args.router}: {e}",
              file=sys.stderr)
        return 2
    print(f"JOINED {args.router} epoch {epoch}", flush=True)
    print(f"  role=prefill slots={args.slots} page_block={pool.bs} "
          f"pages={pool.pages} "
          f"prefix_cache={'off' if args.no_prefix_cache else 'on'} "
          f"device={model.device}"
          + (f" kv_dtype={args.kv_dtype}" if args.kv_dtype else ""),
          flush=True)
    try:
        _wait_for_signal()
    finally:
        daemon.stop()
        _obs_close(session, flight, args.obs_out)
    return 0


def cmd_route(args):
    """``route``: the serving router daemon. Workers join with ``serve
    --router HOST:PORT --role decode|prefill``; clients point
    ``serving.RouterClient`` here."""
    from .serving import ServingRouter
    session, flight = _obs_session(args)
    _role_name_session(session, "router")
    try:
        router = ServingRouter(args.host, args.port, ttl=args.ttl,
                               scrape_interval_s=args.scrape_interval
                               ).start()
    except OSError as e:
        _obs_close(session, flight)
        print(f"route: cannot bind {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 2
    host, port = router.address
    print(f"ROUTER {host} {port}", flush=True)
    print(f"  ttl={args.ttl:g} scrape_interval={args.scrape_interval:g}",
          flush=True)
    try:
        _wait_for_signal()
    finally:
        router.stop()
        _obs_close(session, flight, args.obs_out)
    return 0


# -- obs: dumps, device traces, the HTTP view ---------------------------------

def _read_obs_inputs(inputs):
    """Load one or more JSONL dumps as a list (the caller merges —
    cmd_obs appends trace-derived dumps first). Errors name the failing
    file."""
    from . import obs
    dumps = []
    for p in inputs:
        try:
            dumps.append(obs.read_jsonl(p))
        except (OSError, ValueError) as e:
            raise OSError(f"{p}: {e}") from e
    return dumps


def _master_addr(cmd: str, master):
    """``--master`` as (host, port); None (after a message) when
    malformed."""
    try:
        return _parse_hostport(master)
    except ValueError:
        print(f"obs {cmd}: --master must be host:port, got {master!r}",
              file=sys.stderr)
        return None


def cmd_obs(args):
    """``obs summary`` / ``obs export`` — inspect and convert
    observability dumps (the JSONL an ``ObsSession`` saves, ``--obs_out``
    files, flight recorder rings). ``--input`` may repeat: several dumps
    merge into one cluster view. ``export --xplane`` merges a device trace
    (a ``torch.profiler`` Chrome trace, or a ``.xplane.pb``) as extra
    process lanes beside the host spans."""
    from . import obs
    inputs = list(args.input or ())
    xplanes = list(getattr(args, "xplane", None) or ())
    if not inputs and not xplanes:
        print("obs: pass --input dump.jsonl (repeatable) and/or "
              "--xplane trace.json", file=sys.stderr)
        return 2
    try:
        dumps = _read_obs_inputs(inputs)
        if xplanes:
            # device timelines: each trace becomes one dump whose lanes
            # merge beside the host spans, anchored at the earliest host
            # dump's clock origin (coarse; the lanes always render)
            from .obs import xplane as _xp
            origins = [(d.get("meta") or {}).get("clock_origin_unix")
                       for d in dumps]
            origins = [o for o in origins if o is not None]
            anchor = min(origins) if origins else None
            for path in xplanes:
                try:
                    space = _xp.read_trace(path)
                except (OSError, ValueError) as e:
                    raise OSError(f"{path}: {e}") from e
                dumps.append(_xp.xplane_dump(space, anchor_unix=anchor))
        dump = dumps[0] if len(dumps) == 1 else obs.merge_dumps(dumps)
    except (OSError, ValueError) as e:
        print(f"obs: cannot read dump: {e}", file=sys.stderr)
        return 2
    if args.obs_cmd == "summary":
        print(obs.summary(dump))
        return 0
    if args.format == "chrome":
        out = json.dumps(obs.chrome_trace(dump), indent=1)
    elif args.format == "prom":
        out = obs.prometheus_text(dump)
    else:                                  # jsonl: normalized re-emit
        if args.output:
            obs.write_jsonl(args.output, dump)
            print(f"wrote {args.output}")
            return 0
        from .obs.export import jsonl_lines
        out = "\n".join(jsonl_lines(dump)) + "\n"
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        print(f"wrote {args.output}")
    else:
        print(out, end="" if out.endswith("\n") else "\n")
    return 0


def _master_dump(addr):
    """A live master's merged fleet view as one dump."""
    from .obs.aggregate import telemetry_client
    client = telemetry_client(*addr)
    try:
        workers, samples = client.obs_stats()
        h = client.obs_health()
        return {"meta": {"process": "master", "obs_workers": workers},
                "metrics": samples, "events": h["events"],
                "alerts": h["active"], "health": h["health"],
                "actions": h.get("actions", []),
                "requests": h.get("requests", []),
                "exemplars": h.get("exemplars", [])}
    finally:
        client.close()


def cmd_obs_serve(args):
    """``obs serve`` — read-only HTTP view over dumps and/or a live
    master's merged fleet metrics: ``/metrics`` (Prometheus text),
    ``/trace`` (Chrome JSON), ``/requests`` (stitched timelines),
    ``/alerts`` and ``/summary``. Sources are re-read per request."""
    from . import obs
    from .obs.aggregate import ObsHttpServer
    inputs = list(args.input or ())
    master_addr = None
    if not inputs and not args.master:
        print("obs serve: pass --input dump.jsonl (repeatable) and/or "
              "--master host:port", file=sys.stderr)
        return 2
    if args.master:
        master_addr = _master_addr("serve", args.master)
        if master_addr is None:
            return 2

    def provider():
        dumps = [obs.read_jsonl(p) for p in inputs]
        if master_addr is not None:
            try:
                dumps.append(_master_dump(master_addr))
            except (OSError, ConnectionError) as e:
                if not dumps:
                    raise
                print(f"obs serve: master {args.master} unreachable: {e}",
                      file=sys.stderr)
        if len(dumps) == 1:
            return dumps[0]
        merged = obs.merge_dumps(dumps)
        # the health-plane extras carry through for /alerts and /summary
        for d in dumps:
            for k in ("alerts", "actions", "exemplars"):
                if d.get(k):
                    merged.setdefault(k, []).extend(d[k])
            if d.get("health"):
                merged.setdefault("health", {}).update(d["health"])
        return merged

    srv = ObsHttpServer(provider, host=args.host, port=args.port).start()
    # machine-parseable address line first (port 0 binds an ephemeral one)
    print(f"SERVING {srv.address[0]} {srv.address[1]}", flush=True)
    for path, what in (("metrics", "prometheus"), ("trace", "chrome json"),
                       ("requests", "request timelines"),
                       ("summary", "summary")):
        print(f"  http://{srv.address[0]}:{srv.address[1]}/{path}  "
              f"({what})", flush=True)
    try:
        _wait_for_signal()
    finally:
        srv.stop()
    return 0


def cmd_obs_top(args):
    """``obs top`` — the fleet table: one row per worker (goodput ratio,
    mfu, queue depth, straggler score, heartbeat jitter, alerts) over
    ``--input`` dumps and/or a live ``--master``; ``--once`` prints one
    table and exits."""
    from . import obs
    from .obs.health import fold_alert_stream, health_table
    inputs = list(args.input or ())
    if not inputs and not args.master:
        print("obs top: pass --input dump.jsonl (repeatable) and/or "
              "--master host:port", file=sys.stderr)
        return 2
    master_addr = None
    if args.master:
        master_addr = _master_addr("top", args.master)
        if master_addr is None:
            return 2

    def render():
        samples, alerts, health, actions = [], [], {}, []
        try:
            if inputs:
                merged = obs.merge_dumps(_read_obs_inputs(inputs))
                samples.extend(merged.get("metrics", ()))
                alerts.extend(e for e in merged.get("events", ())
                              if e.get("name") == "alert")
            if master_addr is not None:
                d = _master_dump(master_addr)
                samples.extend(d["metrics"])
                health, actions = d["health"], d["actions"]
                alerts.extend(d["events"])
                alerts.extend(d["alerts"])
        except (OSError, ConnectionError) as e:
            return None, f"obs top: source unavailable: {e}"
        table = health_table(samples, alerts=alerts, health=health,
                             actions=actions)
        head = (f"fleet: {len(health) if health else '-'} worker(s) in "
                f"health view, {len(fold_alert_stream(alerts))} alert(s) "
                "firing")
        return table, head

    while True:
        table, head = render()
        if table is None:
            print(head, file=sys.stderr)
            if args.once:
                return 2
        else:
            if not args.once:
                print("\x1b[2J\x1b[H", end="")   # clear + home
            print(head)
            print(table if table else "(no per-worker series yet)")
        if args.once:
            return 0
        time.sleep(args.interval)


def cmd_obs_trace(args):
    """``obs trace <submit_key>`` — one request's stitched cross-worker
    timeline (admitted -> queued/prefill/ship/adopt -> first_token ->
    decode -> done, re-route legs merged onto one clock) from ``--input``
    dumps and/or a live ``--master``'s request store."""
    from .obs.requests import base_key, format_timeline, group_legs, stitch
    inputs = list(args.input or ())
    if not inputs and not args.master:
        print("obs trace: pass --input dump.jsonl (repeatable) and/or "
              "--master host:port", file=sys.stderr)
        return 2
    timelines = []
    try:
        for d in _read_obs_inputs(inputs):
            timelines.extend(d.get("requests") or ())
    except (OSError, ValueError) as e:
        print(f"obs trace: cannot read dump: {e}", file=sys.stderr)
        return 2
    if args.master:
        addr = _master_addr("trace", args.master)
        if addr is None:
            return 2
        try:
            timelines.extend(_master_dump(addr).get("requests") or ())
        except (OSError, ConnectionError) as e:
            print(f"obs trace: master {args.master} unreachable: {e}",
                  file=sys.stderr)
            if not timelines:
                return 2
    groups = group_legs(timelines)
    legs = groups.get(base_key(args.key))
    if not legs:
        print(f"obs trace: no timeline for {args.key!r} "
              f"({len(groups)} request(s) in the sources)", file=sys.stderr)
        for k in sorted(groups)[:16]:
            print(f"  known: {k}", file=sys.stderr)
        return 1
    print(format_timeline(stitch(legs)))
    return 0



def cmd_profile(args):
    """``profile`` — ``--steps`` profiled steps of a workload under
    ``torch.profiler``, after ``--warmup`` unprofiled ones (kernel builds
    and graph captures stay out), then the top-k per-kernel report
    (obs/xplane.py), each kernel attributed to its Program site.

    Workloads: ``--config cfg.py`` profiles the config's training step
    (the ``time`` command's loop) on the eager route
    (``core.graphs.disabled()``): a graph replay runs no
    ``record_function`` range, so only eagerly run ops carry their
    ``block B, op #I (type)`` site; ``time`` gives the graphed ms.
    ``--decode B,PROMPT,NEW`` profiles ``TransformerLM.generate_fused``
    on a model built from the flags with weights drawn from ``--seed``.
    The trace (a Chrome trace JSON) is kept under ``--trace-dir``; ``obs
    export --xplane`` merges it beside host spans, and ``tune
    --from-ledger`` seeds a sweep from it."""
    import contextlib
    import tempfile

    import torch
    if not args.config and not args.decode:
        print("profile: pass --config cfg.py or --decode B,PROMPT,NEW",
              file=sys.stderr)
        return 2
    from .core.place import require_device
    from .obs import xplane as _xp
    device = require_device(args.device)
    if args.config:
        from .core import graphs
        one, batches = _config_workload(args.config,
                                        args.steps + args.warmup, device)
        if not batches:
            print(f"profile: {args.config!r} train_reader yielded no "
                  "batches — nothing to profile", file=sys.stderr)
            return 2
        route = graphs.disabled()
    else:
        try:
            b, prompt_len, new = (int(x) for x in args.decode.split(","))
        except ValueError:
            print(f"profile: --decode must be B,PROMPT,NEW integers, got "
                  f"{args.decode!r}", file=sys.stderr)
            return 2
        from .models import TransformerLM
        model = TransformerLM(args.vocab, d_model=args.d_model,
                              n_heads=args.n_heads, n_layers=args.n_layers,
                              max_len=args.max_len).init(seed=args.seed,
                                                         device=device)
        gen = torch.Generator(device="cpu").manual_seed(args.seed + 1)
        prompt = torch.randint(0, args.vocab, (b, prompt_len), generator=gen,
                               dtype=torch.int32).to(device)

        def one(i):
            model.generate_fused(prompt, new, kv_dtype=args.kv_dtype)
        route = contextlib.nullcontext()

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = args.trace_dir or tempfile.mkdtemp(prefix="paddle_profile_")
    os.makedirs(out_dir, exist_ok=True)
    with route:
        for i in range(args.warmup):
            one(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        with torch.profiler.profile(activities=acts) as prof:
            for j in range(args.steps):
                one(args.warmup + j)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    space = _xp.read_torch_trace(path)
    print(_xp.top_ops_report(space, topk=args.topk, steps=args.steps))
    if args.config:
        print("profile: traced the eager route (core.graphs.disabled(): "
              "each kernel under its op site); `time` gives the graphed "
              "ms a batch")
    print(f"\ntrace: {path}")
    print("merge: python -m paddle_tpu_torch obs export --format=chrome "
          f"--xplane {path} [--input obs.jsonl] --output trace.json")
    return 0


def cmd_version(args):
    import torch
    print(f"paddle_tpu_torch (torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, card "
          f"{'yes' if torch.cuda.is_available() else 'none'})")
    return 0


_OBS_OUT_HELP = ("write the observability dump (metrics, spans, request "
                 "timelines) here on shutdown; a flight recorder is armed "
                 "at the same path meanwhile")


def _device_flag(sp, what: str = "the program runs") -> None:
    sp.add_argument("--device", default="cuda",
                    help=f"where {what} (default: the card; raises "
                    "without one; the CPU with 'cpu')")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = p.add_subparsers(dest="job", required=True)

    def common(sp):
        sp.add_argument("--config", required=True,
                        help="a config script written against "
                        "paddle_tpu_torch")

    t = sub.add_parser("train")
    common(t)
    t.add_argument("--num_passes", type=int, default=1)
    t.add_argument("--save_dir", default=None)
    t.add_argument("--log_period", type=int, default=0)
    t.add_argument("--local_master", action="store_true",
                   help="self-host the task-master data plane in-process "
                        "(TrainerMain --start_pserver analog): dump the "
                        "reader to chunks, serve them over the real RPC "
                        "plane, train as its first consumer")
    t.add_argument("--samples_per_chunk", type=int, default=64,
                   help="reader items per dispatched chunk (--local_master)")
    t.add_argument("--obs_out", default=None,
                   help="install an observability session for the run and "
                        "write its JSONL dump here (inspect with "
                        "'python -m paddle_tpu_torch obs summary/export')")
    t.add_argument("--compile_cache", default=None,
                   help="(JAX's persistent XLA compilation cache: refused; "
                        "the port compiles no XLA programs and its kernels "
                        "build into paddle_tpu_torch/_build/ at first use)")
    t.add_argument("--elastic", choices=["master", "worker"], default=None,
                   help="elastic data-parallel mode: 'master' serves "
                        "membership + shard dispatch and applies the "
                        "updates; 'worker' joins a master under a "
                        "heartbeat lease and computes shard gradients. "
                        "The config must define elastic_workload() -> "
                        "{loss_fn, params, optimizer, batches}")
    t.add_argument("--master_addr", default=None,
                   help="--elastic worker: HOST:PORT of the elastic master "
                        "to join; --elastic master: bind address "
                        "(default 127.0.0.1:0 — the chosen port is printed "
                        "as 'ELASTIC MASTER host port')")
    t.add_argument("--min_workers", type=int, default=1,
                   help="--elastic master: members required before the "
                        "first step dispatches")
    t.add_argument("--shards_per_step", type=int, default=4,
                   help="--elastic master: fixed shard tasks per global "
                        "batch (the elasticity quantum; membership-"
                        "independent so the reduce stays byte-stable)")
    t.add_argument("--heartbeat_ttl", type=float, default=5.0,
                   help="--elastic master: seconds without a heartbeat "
                        "before a worker is evicted and its in-flight "
                        "shards re-bucket")
    t.add_argument("--worker_id", default=None,
                   help="--elastic worker: stable membership name (a "
                        "re-join under the same name fences the old "
                        "incarnation)")
    _device_flag(t)
    t.set_defaults(fn=cmd_train)

    te = sub.add_parser("test")
    common(te)
    te.add_argument("--init_model_path", default=None)
    _device_flag(te)
    te.set_defaults(fn=cmd_test)

    tm = sub.add_parser("time")
    common(tm)
    tm.add_argument("--warmup", type=int, default=2)
    tm.add_argument("--iters", type=int, default=10)
    _device_flag(tm)
    tm.set_defaults(fn=cmd_time)

    dc = sub.add_parser("dump_config")
    common(dc)
    dc.set_defaults(fn=cmd_dump_config)

    lt = sub.add_parser("lint", help="statically verify + lint the config's "
                                     "Program IR (nothing runs)")
    lt.add_argument("--config", required=False, default=None,
                    help="config to verify (optional when --bench-rows "
                         "is given alone)")
    lt.add_argument("--bench-rows", nargs="+", default=None,
                    dest="bench_rows", metavar="FILE",
                    help="also validate saved bench rows (BENCH_*.json / "
                         "bench JSONL) against the bench-row schema")
    lt.add_argument("--fail-on", choices=["error", "warning", "info"],
                    default="error", dest="fail_on",
                    help="lowest severity that makes the exit code nonzero")
    lt.add_argument("--json", action="store_true",
                    help="emit diagnostics as a flat JSON list (legacy; "
                         "prefer --format=json)")
    lt.add_argument("--format", choices=["text", "json"], default="text",
                    help="output format; json emits the stable schema "
                         "{version, findings[], summary} on pure stdout "
                         "(exit codes: 0 clean, 1 findings at/above "
                         "--fail-on, 2 usage error)")
    lt.add_argument("--explain", action="store_true",
                    help="annotate each finding's variable with its "
                         "def-use chain (defined / redefined / last "
                         "read sites) from the dataflow plane")
    lt.add_argument("--mesh-axes", default=None, dest="mesh_axes",
                    help="comma-separated valid sharding axis names "
                         "(default: parallel.mesh.CANONICAL_ORDER, with "
                         "unknown axes reported as warnings)")
    lt.add_argument("--autotune-cache", default=None, dest="autotune_cache",
                    metavar="FILE",
                    help="autotune cache to check for staleness (L008; "
                         "default: $PADDLE_TPU_TORCH_AUTOTUNE_CACHE / "
                         "~/.paddle_tpu_torch/autotune.json — a missing "
                         "file is clean). Works standalone without "
                         "--config.")
    lt.set_defaults(fn=cmd_lint)

    tu = sub.add_parser("tune", help="measure candidate kernel plans "
                                     "(recurrent row tiles, decode split "
                                     "counts, paged block size, graph "
                                     "fusion, serving bucket grids) and "
                                     "persist winners in the autotune "
                                     "cache the routes consult")
    tu.add_argument("--spaces", default=None,
                    help="comma-separated plan spaces (default: all of "
                         "bucket_grid,decode_route,fused_rnn,fusion,"
                         "page_block)")
    tu.add_argument("--from-ledger", default=None, dest="from_ledger",
                    metavar="FILE",
                    help="seed the sweep from a profile (the trace.json "
                         "that profile writes, an .xplane.pb, or JSON op "
                         "rows): the hottest op sites pick which plan "
                         "spaces get swept (an explicit --spaces list "
                         "overrides the seeding)")
    tu.add_argument("--ledger-topk", type=int, default=8,
                    dest="ledger_topk", metavar="N",
                    help="how many top self-time op sites seed the "
                         "sweep (default 8)")
    tu.add_argument("--profile", choices=["smoke", "cpu", "bench"],
                    default=None,
                    help="measurement profile (default: bench on a card, "
                         "cpu elsewhere; --check defaults to smoke)")
    tu.add_argument("--cache", default=None, metavar="FILE",
                    help="cache file to merge winners into (default: "
                         "$PADDLE_TPU_TORCH_AUTOTUNE_CACHE / "
                         "~/.paddle_tpu_torch/autotune.json)")
    tu.add_argument("--reps", type=int, default=None,
                    help="timing repetitions per candidate (default: "
                         "the profile's)")
    tu.add_argument("--check", action="store_true",
                    help="CI smoke: tiny sweep, then verify the written "
                         "cache reloads and the routing consults resolve "
                         "it (exit 1 on any break)")
    tu.add_argument("--dry-run", action="store_true", dest="dry_run",
                    help="measure and report, write nothing")
    tu.add_argument("--markdown", action="store_true",
                    help="print the winners as a markdown table")
    tu.add_argument("--json", action="store_true",
                    help="print the full report (sweeps included) as "
                         "JSON")
    _device_flag(tu, "the candidates are timed")
    tu.set_defaults(fn=cmd_tune)

    mm = sub.add_parser("merge_model")
    common(mm)
    mm.add_argument("--model_path", required=True)
    mm.add_argument("--output_dir", required=True)
    _device_flag(mm)
    mm.set_defaults(fn=cmd_merge_model)

    md = sub.add_parser("make_diagram")
    common(md)
    md.add_argument("--output", default=None)
    md.set_defaults(fn=cmd_make_diagram)

    pf = sub.add_parser("profile", help="run N profiled steps and print a "
                        "top-k per-kernel device report with Program-site "
                        "attribution (obs/xplane.py)")
    pf.add_argument("--config", default=None,
                    help="profile this config's training step (on the "
                    "eager route)")
    pf.add_argument("--decode", default=None, metavar="B,PROMPT,NEW",
                    help="profile a fused-decode serve workload instead: "
                    "batch, prompt length, new tokens (a TransformerLM "
                    "from the model flags + --seed)")
    pf.add_argument("--steps", type=int, default=3,
                    help="profiled steps (the report amortizes over them)")
    pf.add_argument("--warmup", type=int, default=2,
                    help="unprofiled steps first, so builds and captures "
                    "stay out")
    pf.add_argument("--topk", type=int, default=15)
    pf.add_argument("--trace-dir", default=None, dest="trace_dir",
                    help="keep the trace here (default: a fresh temp dir; "
                    "its path prints)")
    pf.add_argument("--vocab", type=int, default=256)
    pf.add_argument("--d_model", type=int, default=128)
    pf.add_argument("--n_heads", type=int, default=4)
    pf.add_argument("--n_layers", type=int, default=2)
    pf.add_argument("--max_len", type=int, default=512)
    pf.add_argument("--kv_dtype", choices=["int8"], default=None)
    pf.add_argument("--seed", type=int, default=0)
    _device_flag(pf, "the workload runs")
    pf.set_defaults(fn=cmd_profile)

    cg = sub.add_parser("checkgrad")
    common(cg)
    cg.add_argument("--eps", type=float, default=5e-3)
    cg.add_argument("--rtol", type=float, default=5e-2)
    cg.add_argument("--checks_per_param", type=int, default=3)
    _device_flag(cg)
    cg.set_defaults(fn=cmd_checkgrad)

    ct = sub.add_parser("cluster_train")
    ct.add_argument("script", help="training script run by every worker")
    ct.add_argument("script_args", nargs="*",
                    help="args passed through to the script (put them after "
                         "a -- separator if they start with a dash)")
    # None = not passed: --hosts mode warns on any explicit value; local
    # mode resolves it to 2
    ct.add_argument("--num_workers", type=int, default=None)
    ct.add_argument("--devices_per_worker", type=int, default=0,
                    help="JAX's virtual devices per worker: a worker of the "
                         "port is one rank of one device, so a value above "
                         "1 is refused (0 or 1 set nothing)")
    ct.add_argument("--timeout", type=float, default=600.0)
    ct.add_argument("--grace", type=float, default=10.0,
                    help="seconds survivors get to run their teardown hook "
                         "(SIGTERM) before SIGKILL when a peer fails")
    ct.add_argument("--restart-on-failure", type=int, default=0,
                    metavar="N", dest="restart_on_failure",
                    help="elastic recovery: relaunch the whole job (fresh "
                         "coordinator, scripts resume from their latest "
                         "checkpoint) up to N times after a worker failure")
    ct.add_argument("--hosts", default=None,
                    help="comma-separated host list: launch one node per "
                         "host over ssh (multi-host mode)")
    ct.add_argument("--hostfile", default=None,
                    help="file with one host per line ('#' comments) — the "
                         "reference launcher's conf.py HOSTS")
    ct.add_argument("--ssh-template", default=None, dest="ssh_template",
                    help="per-host command template with {host} and {cmd} "
                         "placeholders (default: \"ssh {host} {cmd}\"); "
                         "e.g. \"ssh -p 2222 -i key {host} {cmd}\" or "
                         "\"bash -c {cmd}\" for local testing")
    ct.add_argument("--coordinator-port", type=int, default=7164,
                    dest="coordinator_port",
                    help="coordinator port on node 0's host (the "
                         "reference's PADDLE_PORT)")
    ct.add_argument("--remote-python", default="python3",
                    dest="remote_python",
                    help="python interpreter to invoke on each host")
    ct.add_argument("--dry-run", action="store_true", dest="dry_run",
                    help="print the rendered per-host commands and exit "
                         "(for inspection or external schedulers)")
    ct.set_defaults(fn=cmd_cluster_train)

    ob = sub.add_parser("obs", help="inspect/convert/serve observability "
                        "dumps (JSONL from ObsSession.save / --obs_out / "
                        "the flight recorder)")
    obsub = ob.add_subparsers(dest="obs_cmd", required=True)
    os_ = obsub.add_parser("summary", help="human metric/span table")
    os_.add_argument("--input", required=True, action="append",
                     help="JSONL dump to summarize (repeat to merge)")
    os_.set_defaults(fn=cmd_obs)
    oe = obsub.add_parser("export", help="convert the dump(s) for other "
                          "tools")
    oe.add_argument("--input", action="append",
                    help="JSONL dump to convert (repeat to merge: one "
                    "Chrome lane per process + client->server flow "
                    "arrows)")
    oe.add_argument("--xplane", action="append", metavar="TRACE",
                    help="merge a device trace (a torch.profiler Chrome "
                    "trace .json, or a .xplane.pb) as extra process lanes "
                    "beside the host spans (profile writes one)")
    oe.add_argument("--format", choices=["chrome", "prom", "jsonl"],
                    default="chrome",
                    help="chrome: trace_event JSON for Perfetto; prom: "
                    "Prometheus text; jsonl: normalized stream")
    oe.add_argument("--output", default=None,
                    help="output path (default: stdout)")
    oe.set_defaults(fn=cmd_obs)
    osv = obsub.add_parser("serve", help="read-only HTTP endpoint: "
                           "/metrics, /trace, /requests, /alerts, /summary")
    osv.add_argument("--input", action="append",
                     help="JSONL dump(s) to serve (re-read per request)")
    osv.add_argument("--master", default=None,
                     help="host:port of a live master server — serve its "
                     "merged obs_push fleet view")
    osv.add_argument("--host", default="127.0.0.1")
    osv.add_argument("--port", type=int, default=0,
                     help="0 binds an ephemeral port (printed on start)")
    osv.set_defaults(fn=cmd_obs_serve)
    otr = obsub.add_parser("trace", help="print one request's stitched "
                           "cross-worker timeline")
    otr.add_argument("key", help="submit_key to trace (a re-route leg key "
                     "like KEY#r1 resolves to its base request)")
    otr.add_argument("--input", action="append",
                     help="JSONL dump(s) holding request timelines")
    otr.add_argument("--master", default=None,
                     help="host:port of a live master server")
    otr.set_defaults(fn=cmd_obs_trace)
    ot = obsub.add_parser("top", help="per-worker fleet table")
    ot.add_argument("--input", action="append",
                    help="JSONL dump(s) to read (re-read per refresh)")
    ot.add_argument("--master", default=None,
                    help="host:port of a live master server")
    ot.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds")
    ot.add_argument("--once", action="store_true",
                    help="print one table and exit")
    ot.set_defaults(fn=cmd_obs_top)


    sv = sub.add_parser("serve", help="serving daemon: paged KV-cache "
                        "continuous batching behind the RPC plane "
                        "(srv_submit/srv_poll/srv_cancel)")
    sv.add_argument("--config", default=None,
                    help="Python script exposing `model` (a port "
                    "TransformerLM) and `params` (None, or a JAX parameter "
                    "tree as numpy); omitted = a TransformerLM from the "
                    "flags with weights drawn from --seed")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=0)
    sv.add_argument("--vocab", type=int, default=50257)
    sv.add_argument("--d_model", type=int, default=768)
    sv.add_argument("--n_heads", type=int, default=12)
    sv.add_argument("--n_layers", type=int, default=12)
    sv.add_argument("--max_len", type=int, default=1024)
    sv.add_argument("--seed", type=int, default=0)
    sv.add_argument("--slots", type=int, default=8)
    sv.add_argument("--segment", type=int, default=32)
    sv.add_argument("--page_block", type=int, default=None,
                    help="KV page size; default consults the autotune "
                    "cache (python -m paddle_tpu_torch tune) and falls "
                    "back to 64")
    sv.add_argument("--pages", type=int, default=None,
                    help="pool pages incl. the null page (default: worst "
                    "case slots*max_len/page_block + 1)")
    sv.add_argument("--cache_bucket", type=int, default=256)
    sv.add_argument("--kv_dtype", choices=["int8"], default=None)
    sv.add_argument("--queue_cap", type=int, default=64)
    sv.add_argument("--no_prefix_cache", action="store_true",
                    help="disable the copy-on-write prefix index (default "
                    "on for the daemon)")
    sv.add_argument("--interactive_weight", type=float, default=4.0,
                    help="weighted-fair service share of slo=interactive "
                    "requests vs slo=batch")
    sv.add_argument("--batch_weight", type=float, default=1.0)
    sv.add_argument("--max_tenants", type=int, default=32,
                    help="distinct tenant labels this daemon admits")
    sv.add_argument("--request_timeout", type=float, default=None,
                    help="default per-request deadline (seconds)")
    sv.add_argument("--drain", type=float, default=10.0,
                    help="seconds to let in-flight requests finish (and "
                    "clients collect them) on SIGTERM; 0 = stop at once")
    sv.add_argument("--obs_out", default=None, help=_OBS_OUT_HELP)
    sv.add_argument("--router", default=None, metavar="HOST:PORT",
                    help="join this serving router's membership table")
    sv.add_argument("--role", choices=["decode", "prefill"],
                    default="decode",
                    help="decode (default): the full engine; prefill: a "
                    "pool-only worker that ships KV pages to the "
                    "router-chosen decode worker (requires --router)")
    sv.add_argument("--worker", default=None,
                    help="membership worker name (default: serve-<port> / "
                    "prefill-<port>)")
    sv.add_argument("--device", default="cuda",
                    help="where the model and the KV pool live (default: "
                    "the card; raises without one)")
    sv.set_defaults(fn=cmd_serve)

    rt = sub.add_parser("route", help="serving router: model-free "
                        "placement over joined prefill/decode workers")
    rt.add_argument("--host", default="127.0.0.1")
    rt.add_argument("--port", type=int, default=0)
    rt.add_argument("--ttl", type=float, default=3.0,
                    help="membership lease TTL (seconds)")
    rt.add_argument("--scrape_interval", type=float, default=0.25,
                    help="seconds between srv_stats health scrapes")
    rt.add_argument("--obs_out", default=None, help=_OBS_OUT_HELP)
    rt.set_defaults(fn=cmd_route)

    cl = sub.add_parser("cluster", help="fleet lifecycle: the actor that "
                        "closes the autoscale loop")
    clsub = cl.add_subparsers(dest="cluster_cmd", required=True)
    ca = clsub.add_parser("autoscale", help="watch the membership + "
                          "health planes and spawn/drain workers to the "
                          "hysteresis-stable recommendation and SLO "
                          "burn-rate alerts")
    ca.add_argument("--actor", default="autoscale-actor",
                    help="actor name for act_register (single-writer: a "
                    "newer registration deposes this one)")
    ca.add_argument("--train-master", dest="train_master", default=None,
                    metavar="HOST:PORT",
                    help="elastic master whose membership/recommendation "
                    "drives the training population")
    ca.add_argument("--train-cmd", dest="train_cmd", default=None,
                    help="training-worker launch template with a {worker} "
                    "placeholder ({python} expands to this interpreter), "
                    "e.g. '{python} -m paddle_tpu_torch train --config c.py "
                    "--elastic worker --master_addr H:P "
                    "--worker_id {worker}'")
    ca.add_argument("--train-min", dest="train_min", type=int, default=1)
    ca.add_argument("--train-max", dest="train_max", type=int, default=8)
    ca.add_argument("--router", default=None, metavar="HOST:PORT",
                    help="serving router whose decode pool the actor "
                    "keeps at --decode-target (scaling out on TTFT/TPOT "
                    "SLO burn)")
    ca.add_argument("--decode-cmd", dest="decode_cmd", default=None,
                    help="decode-worker launch template with a {worker} "
                    "placeholder, e.g. '{python} -m paddle_tpu_torch serve "
                    "--router H:P --worker {worker} ...'")
    ca.add_argument("--decode-target", dest="decode_target", type=int,
                    default=1, help="steady-state decode pool size")
    ca.add_argument("--serve-min", dest="serve_min", type=int, default=1)
    ca.add_argument("--serve-max", dest="serve_max", type=int, default=8)
    ca.add_argument("--interval", type=float, default=1.0,
                    help="seconds between actor ticks")
    ca.add_argument("--cooldown", type=float, default=5.0,
                    help="per-(population, action) cooldown: damping on "
                    "top of the recommendation's hysteresis")
    ca.add_argument("--max-churn", dest="max_churn", type=int, default=1,
                    help="max concurrent in-flight spawns+drains across "
                    "the whole fleet")
    ca.add_argument("--spawn-grace", dest="spawn_grace", type=float,
                    default=30.0, help="seconds a spawned worker gets to "
                    "appear in membership before the spawn counts failed")
    ca.add_argument("--drain-grace", dest="drain_grace", type=float,
                    default=30.0, help="seconds a draining worker gets to "
                    "leave membership before escalation to kill")
    ca.add_argument("--total-workers", dest="total_workers", type=int,
                    default=None,
                    help="shared fleet budget: when set, populations "
                    "compete through the weighted-fair deficit scheduler "
                    "and training yields to serving on SLO burn")
    ca.add_argument("--once", action="store_true",
                    help="run one control tick, print committed actions, "
                    "exit (scripts, tests)")
    ca.set_defaults(fn=cmd_cluster_autoscale)

    v = sub.add_parser("version")
    v.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except ConfigRefused as e:
        print(f"{args.job}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
