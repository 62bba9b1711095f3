"""Exporters: Chrome trace_event JSON, Prometheus text, JSONL, summary table.

All four read ONE shape — the ``dump`` dict produced by
:meth:`ObsSession.dump` and round-tripped through the JSONL sink::

    {"meta":    {...},
     "metrics":  [MetricsRegistry.collect() samples],
     "events":   [Tracer events (spans + instants)],
     "requests": [request timelines (obs/requests.py), when a ledger ran]}

so the in-process path (``session.export_chrome()``) and the offline path
(``python -m paddle_tpu_torch obs export --input run.jsonl``) are the same code.

* :func:`chrome_trace` — ``{"traceEvents": [...]}`` for Perfetto /
  chrome://tracing: spans as complete (``ph:"X"``) events in µs, instants
  as ``ph:"i"``, counters as ``ph:"C"`` counter tracks, thread metadata.
* :func:`prometheus_text` — the text exposition format (``# TYPE`` lines,
  ``_bucket{le=...}``/``_sum``/``_count`` for histograms); names mangled
  ``subsystem.noun`` -> ``paddle_tpu_subsystem_noun``.
* :func:`write_jsonl` / :func:`read_jsonl` — the durable event stream.
* :func:`summary` — the human table; subsumes ``StatSet.report()`` by
  accepting stat snapshots alongside typed metrics.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

JSONL_VERSION = 1


# -- JSONL sink -----------------------------------------------------------------

def jsonl_lines(dump: Dict[str, Any]):
    """The dump as kind-tagged JSON lines (meta, then metrics, then
    events) — the single serialization both :func:`write_jsonl` and the
    CLI's stdout path emit."""
    meta = {"kind": "meta", "version": JSONL_VERSION}
    meta.update(dump.get("meta") or {})
    yield json.dumps(meta)
    for s in dump.get("metrics", ()):
        yield json.dumps({"kind": "metric", **s})
    for e in dump.get("events", ()):
        yield json.dumps(e)
    for tl in dump.get("requests", ()):
        yield json.dumps({"kind": "request", **tl})


def write_jsonl(path: str, dump: Dict[str, Any]) -> str:
    """Persist a session dump as line-delimited JSON: one ``meta`` line,
    one line per metric sample, one per trace event. Append-friendly and
    greppable — the chaos/CI artifact format."""
    with open(path, "w") as f:
        for line in jsonl_lines(dump):
            f.write(line + "\n")
    return path


def read_jsonl(path: str) -> Dict[str, Any]:
    """Inverse of :func:`write_jsonl`; tolerant of missing meta AND of
    torn/corrupt lines — a process killed mid-``save`` leaves a partial
    final line, and the dump of exactly that crashed run must still
    export whatever landed (malformed lines are skipped)."""
    meta: Dict[str, Any] = {}
    metrics: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    requests: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue                 # torn tail / corrupt line
            if not isinstance(rec, dict):
                continue
            kind = rec.pop("kind", None)
            if kind == "meta":
                meta = rec
            elif kind == "metric":
                metrics.append(rec)
            elif kind in ("span", "instant"):
                events.append({"kind": kind, **rec})
            elif kind == "request":
                requests.append(rec)
    out = {"meta": meta, "metrics": metrics, "events": events}
    if requests:
        out["requests"] = requests
    return out


# -- multi-process merge --------------------------------------------------------

def merge_dumps(dumps: Iterable[Dict[str, Any]],
                workers: Optional[List[str]] = None) -> Dict[str, Any]:
    """Stitch per-process dumps into one cluster dump.

    * events concatenate unchanged — each already carries its pid, and
      cross-process edges ride the spans' ``remote`` fields;
    * metric samples get a ``worker=<id>`` label (the merged-registry
      label contract, the JAX package's observability design notes) so same-named series
      from different processes stay distinct series. A sample that already
      carries a ``worker`` label (e.g. the master re-exporting pushed
      snapshots) keeps it.
    * meta records the per-pid process names the Chrome exporter renders
      as ``process_name`` lanes.

    ``workers`` overrides the per-dump worker ids (default: the dump's
    ``meta.process``, falling back to ``proc<N>``).

    Known limitation: processes are keyed by OS pid (events and the wire
    context's ``remote`` edges both carry bare pids), so merging dumps
    from DIFFERENT HOSTS whose pids collide conflates those two lanes and
    can mis-resolve a remote edge. Single-host jobs (and any set of dumps
    with distinct pids) are unaffected; a cross-host deployment should
    launch workers with distinct pid namespaces or merge per host.
    """
    dumps = list(dumps)
    meta: Dict[str, Any] = {"merged": len(dumps), "processes": {}}
    metrics: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    requests: List[Dict[str, Any]] = []
    # per-process tracer clocks have private epochs; when EVERY dump maps
    # its epoch to the wall clock (meta.clock_origin_unix), shift events
    # onto one shared timeline so the stitched trace interleaves
    # correctly. If any dump lacks the field (an older artifact), no
    # dump is shifted — mixing shifted and raw-epoch timestamps would
    # interleave incomparable timebases — and the meta says so.
    origins = [(d.get("meta") or {}).get("clock_origin_unix") for d in dumps]
    if any(o is None for o in origins):
        base = None
        if len(dumps) > 1:
            meta["clocks_unaligned"] = True
    else:
        base = min(origins)
    for i, d in enumerate(dumps):
        m = d.get("meta") or {}
        shift = (origins[i] - base
                 if base is not None and origins[i] is not None else 0.0)
        wid = (workers[i] if workers is not None and i < len(workers)
               else None) or m.get("process") or f"proc{i}"
        wid = str(wid)
        # a dump that is ITSELF a merge carries a processes map — keep
        # those identities so re-merging a persisted merge (export
        # --format=jsonl) doesn't collapse its lanes to "proc<N>"
        inner = m.get("processes") or {}
        for k, v in inner.items():
            meta["processes"].setdefault(str(k), str(v))
        if m.get("pid") is not None:
            meta["processes"].setdefault(str(m["pid"]), wid)
        if m.get("trace_id") and "trace_id" not in meta:
            meta["trace_id"] = m["trace_id"]
        for s in d.get("metrics", ()):
            s = dict(s)
            labels = dict(s.get("labels") or {})
            labels.setdefault("worker", wid)
            s["labels"] = labels
            metrics.append(s)
        for e in d.get("events", ()):
            if shift:
                e = dict(e, ts=e.get("ts", 0.0) + shift)
            events.append(e)
            p = e.get("pid")
            if p is not None and str(p) not in meta["processes"]:
                meta["processes"][str(p)] = wid
        for tl in d.get("requests", ()):
            if isinstance(tl, dict):
                # stamp the recording process so stitch() can name which
                # worker ran each leg; a timeline a router aggregated on a
                # worker's behalf keeps the id the router stamped
                if not tl.get("worker"):
                    tl = dict(tl, worker=wid)
                requests.append(tl)
    events.sort(key=lambda e: e.get("ts", 0.0))
    out = {"meta": meta, "metrics": metrics, "events": events}
    if requests:
        out["requests"] = requests
    return out


# -- Chrome trace_event ---------------------------------------------------------

def chrome_trace(dump: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a dump to Chrome's trace_event JSON object format.

    Spans become ``ph:"X"`` complete events (ts/dur in µs); Perfetto nests
    same-tid events by containment, which matches the tracer's per-thread
    parent stacks. Counters ride as ``ph:"C"`` tracks stamped at the trace
    end so the final tally is visible on the timeline.

    Multi-process dumps (see :func:`merge_dumps`) get one ``process_name``
    metadata row per distinct pid (named from ``meta.processes`` /
    ``meta.process``) and a flow arrow (``ph:"s"``/``"f"``) for every span
    carrying a ``remote`` cross-process parent whose client span is also
    in the dump — the trainer→wire→master stitch in Perfetto.
    """
    events = dump.get("events", [])
    meta = dump.get("meta") or {}
    pid = None
    t_end = 0.0
    out: List[Dict[str, Any]] = []
    seen_pids: List[int] = []
    # (pid, span id) -> span event, for resolving remote parent edges
    by_id: Dict[Any, Dict[str, Any]] = {}
    flows: List[Dict[str, Any]] = []
    for e in events:
        pid = e.get("pid", pid)
        if e.get("pid") is not None and e["pid"] not in seen_pids:
            seen_pids.append(e["pid"])
        ts_us = e["ts"] * 1e6
        if e["kind"] == "span":
            dur_us = e.get("dur", 0.0) * 1e6
            t_end = max(t_end, ts_us + dur_us)
            args = dict(e.get("args") or {})
            if e.get("remote"):
                args["remote_parent"] = e["remote"]
                flows.append(e)
            if e.get("id") is not None:
                by_id[(e.get("pid", 0), e["id"])] = e
            out.append({"name": e["name"], "ph": "X", "ts": ts_us,
                        "dur": dur_us, "pid": e.get("pid", 0),
                        "tid": e.get("tid", 0),
                        "cat": e["name"].split(".", 1)[0],
                        "args": args})
        else:
            t_end = max(t_end, ts_us)
            out.append({"name": e["name"], "ph": "i", "ts": ts_us, "s": "t",
                        "pid": e.get("pid", 0), "tid": e.get("tid", 0),
                        "cat": e["name"].split(".", 1)[0],
                        "args": e.get("args") or {}})
    # flow arrows: client rpc.call slice -> server dispatch slice. Emitted
    # only when BOTH ends are present (a single-process dump has no arrow
    # to draw; the remote_parent arg above still names the edge).
    for e in flows:
        r = e["remote"]
        src = by_id.get((r.get("pid"), r.get("span")))
        if src is None:
            continue
        fid = f"{r.get('pid')}:{r.get('span')}:{e.get('pid', 0)}:{e['id']}"
        # bind the start step just inside the client slice so Chrome
        # attaches it to that slice, and the finish to the server slice.
        # Named serving hops (srv_ship, srv_adopt) keep their span name so
        # the prefill→decode handoff arrows read as what they are; generic
        # dispatch edges stay "rpc".
        fname = e["name"] if str(e["name"]).startswith("srv_") else "rpc"
        flow_common = {"name": fname, "cat": "rpc", "id": fid}
        flows_ts = src["ts"] * 1e6 + min(1.0, src.get("dur", 0.0) * 1e6 / 2)
        out.append({**flow_common, "ph": "s", "ts": flows_ts,
                    "pid": src.get("pid", 0), "tid": src.get("tid", 0)})
        out.append({**flow_common, "ph": "f", "bp": "e",
                    "ts": e["ts"] * 1e6 + min(1.0, e.get("dur", 0.0) * 1e6 / 2),
                    "pid": e.get("pid", 0), "tid": e.get("tid", 0)})
    pid = pid if pid is not None else meta.get("pid", 0)
    # merged dumps: land each worker's counter tracks in that worker's OWN
    # process lane (meta.processes maps pid -> worker name; invert it)
    worker_pid = {str(v): int(k)
                  for k, v in (meta.get("processes") or {}).items()
                  if str(k).isdigit()}
    for s in dump.get("metrics", ()):
        if s.get("type") != "counter":
            continue
        label = s["name"]
        if s.get("labels"):
            inner = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
            label += f"{{{inner}}}"
        c_pid = worker_pid.get(str((s.get("labels") or {}).get("worker")),
                               pid)
        out.append({"name": label, "ph": "C", "ts": t_end, "pid": c_pid,
                    "tid": 0, "args": {"value": s.get("value", 0)}})
    # one process_name lane per pid — the single-pid case keeps its row too
    names = {str(k): str(v)
             for k, v in (meta.get("processes") or {}).items()}
    if not seen_pids:
        seen_pids = [pid]
    for p in seen_pids:
        name = names.get(str(p)) or (
            meta.get("process") if len(seen_pids) == 1 else None) or \
            f"paddle_tpu pid {p}"
        out.append({"name": "process_name", "ph": "M", "pid": p, "tid": 0,
                    "args": {"name": name}})
        rank = _role_sort_index(name)
        if rank is not None:
            # serving-role lanes read top-to-bottom in request order:
            # router above the prefill tier above the decode tier
            out.append({"name": "process_sort_index", "ph": "M", "pid": p,
                        "tid": 0, "args": {"sort_index": rank}})
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": meta}


def _role_sort_index(process_name: str) -> Optional[int]:
    """Lane rank for serving-role process names (``router``,
    ``prefill:<id>``, ``decode:<id>``) — None for everything else so
    non-serving dumps keep Chrome's default (pid-ordered) layout."""
    role = str(process_name).split(":", 1)[0]
    return {"router": 0, "prefill": 1, "decode": 2}.get(role)


# -- Prometheus text format -----------------------------------------------------

def _prom_name(name: str) -> str:
    return "paddle_tpu_" + name.replace(".", "_")


def _prom_escape(value: Any) -> str:
    """Label-value escaping per the Prometheus exposition spec: backslash,
    double-quote and newline must be escaped or the line is unparseable
    (a label value holding a path with a quote silently corrupted the
    whole scrape before this)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels: Dict[str, Any], extra: Optional[str] = None) -> str:
    parts = [f'{k}="{_prom_escape(v)}"'
             for k, v in sorted((labels or {}).items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def prometheus_text(dump: Dict[str, Any]) -> str:
    """Text exposition format — what a ``/metrics`` endpoint (or a node
    textfile collector picking up the dump) serves."""
    lines: List[str] = []
    seen_type = set()
    for s in dump.get("metrics", ()):
        name = _prom_name(s["name"])
        if name not in seen_type:
            if s.get("help"):
                lines.append(f"# HELP {name} {s['help']}")
            lines.append(f"# TYPE {name} {s['type']}")
            seen_type.add(name)
        if s["type"] == "histogram":
            for le, cum in s.get("buckets", ()):
                le_s = "+Inf" if le == "+Inf" else repr(float(le))
                labels = _prom_labels(s.get("labels"), f'le="{le_s}"')
                lines.append(f"{name}_bucket{labels} {cum}")
            lines.append(f"{name}_sum{_prom_labels(s.get('labels'))} "
                         f"{s.get('sum', 0.0)}")
            lines.append(f"{name}_count{_prom_labels(s.get('labels'))} "
                         f"{s.get('count', 0)}")
        else:
            lines.append(f"{name}{_prom_labels(s.get('labels'))} "
                         f"{s.get('value', 0)}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- human summary --------------------------------------------------------------

def _fmt_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) + "}"


def _hist_quantile(snap: Dict[str, Any], q: float) -> float:
    """Upper-bound estimate of quantile ``q`` from cumulative buckets,
    clamped to the observed max — a 0.03ms sample in the le=0.5ms bucket
    must not report p50=0.5ms > max."""
    count = snap.get("count", 0)
    if not count:
        return 0.0
    mx = snap.get("max", 0.0)
    rank = q * count
    for le, cum in snap.get("buckets", ()):
        if cum >= rank:
            return mx if le == "+Inf" else min(float(le), mx)
    return mx


def summary(dump: Dict[str, Any],
            stats: Optional[Iterable] = None) -> str:
    """Render the dump as the operator-facing table. ``stats`` accepts
    :class:`paddle_tpu_torch.utils.stats.StatSnapshot` values (or any object
    with name/total/avg/max/count) so one call subsumes the legacy
    ``StatSet.report()`` output."""
    counters, gauges, hists = [], [], []
    for s in dump.get("metrics", ()):
        {"counter": counters, "gauge": gauges,
         "histogram": hists}.get(s["type"], []).append(s)
    lines: List[str] = []
    if counters:
        lines.append("== counters ==")
        for s in counters:
            v = s.get("value", 0)
            v = int(v) if float(v).is_integer() else v
            lines.append(f"{s['name'] + _fmt_labels(s.get('labels')):<52} "
                         f"{v:>12}")
    if gauges:
        lines.append("== gauges ==")
        for s in gauges:
            lines.append(f"{s['name'] + _fmt_labels(s.get('labels')):<52} "
                         f"{s.get('value', 0):>12g}  "
                         f"(peak {s.get('high_water', 0):g})")
    if hists:
        lines.append("== histograms ==")
        lines.append(f"{'name':<44} {'count':>7} {'mean':>10} "
                     f"{'p50':>10} {'p99':>10} {'max':>10}")
        for s in hists:
            n = s.get("count", 0)
            mean = (s.get("sum", 0.0) / n) if n else 0.0
            lines.append(
                f"{s['name'] + _fmt_labels(s.get('labels')):<44} {n:>7} "
                f"{mean * 1e3:>9.3f}ms {_hist_quantile(s, 0.5) * 1e3:>9.3f}ms "
                f"{_hist_quantile(s, 0.99) * 1e3:>9.3f}ms "
                f"{s.get('max', 0.0) * 1e3:>9.3f}ms")
    if stats:
        snaps = sorted(stats, key=lambda i: -i.total)
        if snaps:
            lines.append("== timers (StatSet) ==")
            for i in snaps:
                lines.append(
                    f"{i.name:<44} total={i.total * 1e3:10.2f}ms "
                    f"avg={i.avg * 1e3:8.3f}ms max={i.max * 1e3:8.3f}ms "
                    f"count={i.count}")
    spans = [e for e in dump.get("events", ()) if e.get("kind") == "span"]
    if spans:
        agg: Dict[str, List[float]] = {}
        for e in spans:
            agg.setdefault(e["name"], []).append(e.get("dur", 0.0))
        lines.append("== spans ==")
        for name in sorted(agg):
            durs = agg[name]
            lines.append(f"{name:<44} count={len(durs):>6} "
                         f"total={sum(durs) * 1e3:10.2f}ms "
                         f"max={max(durs) * 1e3:8.3f}ms")
    return "\n".join(lines) if lines else "(no observability data)"
