"""``python -m paddle_tpu_torch`` — the port's command line, the
counterpart of ``paddle_tpu/cli.py`` for the subcommands the port runs:

* ``serve``: the serving daemon (``serving/daemon.py``) over a paged
  KV-cache continuous-batching ``ServingEngine`` — or, with
  ``--role prefill``, a pool-only ``PrefillDaemon`` that ships pages to
  the router-chosen decode worker;
* ``route``: the model-free ``ServingRouter`` over joined workers;
* ``version``.

Flags, defaults and output lines are JAX's: ``SERVING <host> <port>``,
``ROUTER <host> <port>`` and ``JOINED <router> epoch <n>`` print first
and flushed; SIGTERM (or SIGINT) drains and stops. One flag is the
port's own: ``--device`` (default ``cuda``: with no card the command
raises; the tests pass ``--device cpu``).

The model comes from ``--config`` (a Python script exposing module-level
``model`` — a port ``TransformerLM`` — and ``params``: None when the model
already holds its weights, or a JAX parameter tree as numpy, which
``convert.params_from_numpy`` loads, so both packages can serve the same
weights) or, without one, a ``TransformerLM`` built from the flags with
weights drawn from ``--seed``. Those draws are ``torch.Generator``'s, so
they are not the weights JAX draws from the same seed (ROADMAP C).

The other subcommands of the JAX package (train, tune, obs, lint,
cluster, ...) wait for ROADMAP A.8.
"""

from __future__ import annotations

import argparse
import runpy
import signal
import sys
import threading


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
    if args.role == "prefill":
        return _serve_prefill(args, model)
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
        print(f"serve: {e}", file=sys.stderr)
        return 2
    try:
        daemon = ServingDaemon(engine, args.host, args.port).start()
    except OSError as e:
        engine.stop()
        print(f"serve: cannot bind {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 2
    host, port = daemon.address
    print(f"SERVING {host} {port}", flush=True)
    if args.router:
        try:
            epoch = daemon.join_router(
                _parse_hostport(args.router),
                args.worker or f"serve-{port}", role="decode")
        except Exception as e:
            daemon.stop()
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
    return 0


def _serve_prefill(args, model):
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
        print(f"serve: {e}", file=sys.stderr)
        return 2
    try:
        daemon = PrefillDaemon(pool, args.host, args.port).start()
    except OSError as e:
        print(f"serve: cannot bind {args.host}:{args.port}: {e}",
              file=sys.stderr)
        return 2
    host, port = daemon.address
    print(f"SERVING {host} {port}", flush=True)
    try:
        epoch = daemon.join_router(_parse_hostport(args.router),
                                   args.worker or f"prefill-{port}",
                                   role="prefill")
    except Exception as e:
        daemon.stop()
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
    return 0


def cmd_route(args):
    """``route``: the serving router daemon. Workers join with ``serve
    --router HOST:PORT --role decode|prefill``; clients point
    ``serving.RouterClient`` here."""
    from .serving import ServingRouter
    try:
        router = ServingRouter(args.host, args.port, ttl=args.ttl,
                               scrape_interval_s=args.scrape_interval
                               ).start()
    except OSError as e:
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
    return 0


def cmd_version(args):
    import torch
    print(f"paddle_tpu_torch (torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, card "
          f"{'yes' if torch.cuda.is_available() else 'none'})")
    return 0


_OBS_OUT_HELP = ("taken for the JAX package's command line; writes nothing "
                 "until the port's observability session plane (ROADMAP "
                 "A.8)")


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

    v = sub.add_parser("version")
    v.set_defaults(fn=cmd_version)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
