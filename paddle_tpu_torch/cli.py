"""``python -m paddle_tpu_torch`` — the port's command line, the
counterpart of ``paddle_tpu/cli.py`` for the subcommands the port runs:

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
* ``profile --decode B,PROMPT,NEW``: N profiled fused-decode calls under
  ``torch.profiler`` and the top-k per-kernel report;
* ``version``.

Flags, defaults and output lines are JAX's: ``SERVING <host> <port>``,
``ROUTER <host> <port>`` and ``JOINED <router> epoch <n>`` print first
and flushed; SIGTERM (or SIGINT) drains and stops, and ``serve``/``route``
run under an installed ``ObsSession`` whose dump ``--obs_out`` writes on
the way out (with a flight recorder armed there meanwhile). One flag is
the port's own: ``--device`` (default ``cuda``: with no card the command
raises; the tests pass ``--device cpu``).

The model comes from ``--config`` (a Python script exposing module-level
``model`` — a port ``TransformerLM`` — and ``params``: None when the model
already holds its weights, or a JAX parameter tree as numpy, which
``convert.params_from_numpy`` loads, so both packages can serve the same
weights) or, without one, a ``TransformerLM`` built from the flags with
weights drawn from ``--seed``. Those draws are ``torch.Generator``'s, so
they are not the weights JAX draws from the same seed (ROADMAP C).

The other subcommands of the JAX package (train, time, tune, lint,
cluster, ...) and ``profile --config`` wait for ROADMAP A.8.
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
    """``profile --decode B,PROMPT,NEW`` — ``--steps`` fused-decode calls
    (``TransformerLM.generate_fused`` on a model built from the flags with
    weights drawn from ``--seed``) under ``torch.profiler``, after
    ``--warmup`` unprofiled ones (graph captures and kernel builds stay
    out), then the top-k per-kernel report (obs/xplane.py). The trace
    (a Chrome trace JSON) is kept under ``--trace-dir``; ``obs export
    --xplane`` merges it beside host spans."""
    import tempfile

    import torch
    if args.config:
        print("profile: --config waits for the train/time commands "
              "(ROADMAP A.8); pass --decode B,PROMPT,NEW", file=sys.stderr)
        return 2
    if not args.decode:
        print("profile: pass --decode B,PROMPT,NEW", file=sys.stderr)
        return 2
    try:
        b, prompt_len, new = (int(x) for x in args.decode.split(","))
    except ValueError:
        print(f"profile: --decode must be B,PROMPT,NEW integers, got "
              f"{args.decode!r}", file=sys.stderr)
        return 2
    from .core.place import require_device
    from .models import TransformerLM
    from .obs import xplane as _xp
    device = require_device(args.device)
    model = TransformerLM(args.vocab, d_model=args.d_model,
                          n_heads=args.n_heads, n_layers=args.n_layers,
                          max_len=args.max_len).init(seed=args.seed,
                                                     device=device)
    if args.dtype == "bfloat16":
        model = model.to(torch.bfloat16)
    gen = torch.Generator(device="cpu").manual_seed(args.seed + 1)
    prompt = torch.randint(0, args.vocab, (b, prompt_len), generator=gen,
                           dtype=torch.int32).to(device)

    def one():
        model.generate_fused(prompt, new, kv_dtype=args.kv_dtype)

    for _ in range(args.warmup):
        one()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out_dir = args.trace_dir or tempfile.mkdtemp(prefix="paddle_profile_")
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            one()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    space = _xp.read_torch_trace(path)
    print(_xp.top_ops_report(space, topk=args.topk, steps=args.steps))
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="paddle_tpu_torch")
    sub = p.add_subparsers(dest="job", required=True)

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
    sv.add_argument("--page_block", type=int, default=64,
                    help="KV page size (JAX's default without an autotune "
                    "cache; the tune plane is ROADMAP A.8)")
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

    pf = sub.add_parser("profile", help="run N profiled fused-decode calls "
                        "and print a top-k per-kernel device report")
    pf.add_argument("--config", default=None,
                    help="(JAX's training-step profile; waits for the "
                    "train/time commands)")
    pf.add_argument("--decode", default=None, metavar="B,PROMPT,NEW",
                    help="batch, prompt length, new tokens (a "
                    "TransformerLM from the model flags + --seed)")
    pf.add_argument("--steps", type=int, default=3,
                    help="profiled calls (the report amortizes over them)")
    pf.add_argument("--warmup", type=int, default=2,
                    help="unprofiled calls first, so captures stay out")
    pf.add_argument("--topk", type=int, default=15)
    pf.add_argument("--trace-dir", default=None, dest="trace_dir",
                    help="keep the trace here (default: a fresh temp dir)")
    pf.add_argument("--vocab", type=int, default=256)
    pf.add_argument("--d_model", type=int, default=128)
    pf.add_argument("--n_heads", type=int, default=4)
    pf.add_argument("--n_layers", type=int, default=2)
    pf.add_argument("--max_len", type=int, default=512)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--kv_dtype", choices=["int8"], default=None)
    pf.add_argument("--dtype", choices=["float32", "bfloat16"],
                    default="float32")
    pf.add_argument("--device", default="cuda",
                    help="where the model lives (default: the card)")
    pf.set_defaults(fn=cmd_profile)

    v = sub.add_parser("version")
    v.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
