"""Device timelines in the obs trace model — the port's counterpart of
``paddle_tpu/obs/xplane.py``.

The consumers are JAX's, copied: the XSpace wire-format codec
(:func:`read_xspace`, :func:`encode_xspace`: pure Python, no generated
proto code), :func:`xplane_dump` (device planes into the standard obs dump
shape, so ``python -m paddle_tpu_torch obs export --format=chrome --xplane
...`` stitches device lanes into the host timeline), :func:`plane_events`,
:func:`site_of`, :func:`op_totals` and :func:`top_ops_report`.

The port's traces come from ``torch.profiler``, not from a ``jax.profiler``
``.xplane.pb``: :func:`read_torch_trace` builds the same ``space`` dict
from a profiler run (a ``torch.profiler.profile`` object, or the Chrome
trace JSON it exports): one device plane ``/device:GPU:<n>`` per CUDA
device with one line of kernels, and the host plane ``/host:CPU`` with a
line per host thread. So the consumers and ``obs export --xplane`` work
unchanged on either format.

Site attribution: JAX stamps each fluid op with
``jax.named_scope("b{B}_op{I}_{type}")``; the port's executor opens
``torch.profiler.record_function`` with the same string around each op
(when a profiler is recording). A kernel is attributed to the innermost
such range open on the host thread that launched it (the launch's
correlation id joins the two), and a host op to the range it ran in; the
stamp rides the event's ``stats`` (``scope``), where :func:`site_of`
finds it.

:func:`hlo_stats_rows` (xprof's per-HLO table) has no counterpart and
returns None, as JAX's does where xprof is missing.
"""

from __future__ import annotations

import re
import struct
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

# -- protobuf wire format (decode) ---------------------------------------------
# XSpace schema (tensorflow/core/profiler/protobuf/xplane.proto), fields
# we touch:
#   XSpace  { repeated XPlane planes = 1; }
#   XPlane  { int64 id=1; string name=2; repeated XLine lines=3;
#             map<int64, XEventMetadata> event_metadata=4;
#             map<int64, XStatMetadata> stat_metadata=5;
#             repeated XStat stats=6; }
#   XLine   { int64 id=1; string name=2; int64 timestamp_ns=3;
#             repeated XEvent events=4; int64 duration_ps=9;
#             int64 display_id=10; string display_name=11; }
#   XEvent  { int64 metadata_id=1; int64 offset_ps=2; int64 duration_ps=3;
#             repeated XStat stats=4; }
#   XEventMetadata { int64 id=1; string name=2; string display_name=4; }
#   XStatMetadata  { int64 id=1; string name=2; }
#   XStat   { int64 metadata_id=1; double double_value=2;
#             uint64 uint64_value=3; int64 int64_value=4;
#             string str_value=5; bytes bytes_value=6; uint64 ref_value=7; }


def _varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes) -> Iterable[Tuple[int, int, Any]]:
    """Yield (field_no, wire_type, raw value) over one message's bytes.
    Unknown wire types terminate the walk (torn tail tolerance — the
    profiler writes the file in one pass, but we never throw on bytes we
    merely don't understand)."""
    i, n = 0, len(buf)
    while i < n:
        try:
            key, i = _varint(buf, i)
        except IndexError:
            return
        field, wt = key >> 3, key & 7
        if wt == 0:                       # varint
            try:
                val, i = _varint(buf, i)
            except IndexError:
                return
        elif wt == 1:                     # 64-bit
            if i + 8 > n:
                return
            val = buf[i:i + 8]
            i += 8
        elif wt == 2:                     # length-delimited
            try:
                ln, i = _varint(buf, i)
            except IndexError:
                return
            if i + ln > n:
                return
            val = buf[i:i + ln]
            i += ln
        elif wt == 5:                     # 32-bit
            if i + 4 > n:
                return
            val = buf[i:i + 4]
            i += 4
        else:
            return
        yield field, wt, val


def _signed(v: int) -> int:
    """proto int64 rides the wire as two's-complement varint."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _decode_stat(buf: bytes) -> Tuple[int, Any]:
    mid, val = 0, None
    for field, wt, raw in _fields(buf):
        if field == 1 and wt == 0:
            mid = raw
        elif field == 2 and wt == 1:
            val = struct.unpack("<d", raw)[0]
        elif field == 3 and wt == 0:
            val = raw
        elif field == 4 and wt == 0:
            val = _signed(raw)
        elif field in (5, 6) and wt == 2:
            try:
                val = raw.decode("utf-8", "replace")
            except Exception:
                val = raw
        elif field == 7 and wt == 0:
            val = ("ref", raw)            # resolved via stat_metadata later
    return mid, val


def _decode_event(buf: bytes) -> Dict[str, Any]:
    ev = {"metadata_id": 0, "offset_ps": 0, "duration_ps": 0, "stats": []}
    for field, wt, raw in _fields(buf):
        if field == 1 and wt == 0:
            ev["metadata_id"] = raw
        elif field == 2 and wt == 0:
            ev["offset_ps"] = _signed(raw)
        elif field == 3 and wt == 0:
            ev["duration_ps"] = _signed(raw)
        elif field == 4 and wt == 2:
            ev["stats"].append(_decode_stat(raw))
    return ev


def _decode_line(buf: bytes) -> Dict[str, Any]:
    line = {"id": 0, "name": "", "display_name": "", "timestamp_ns": 0,
            "events": []}
    for field, wt, raw in _fields(buf):
        if field == 1 and wt == 0:
            line["id"] = raw
        elif field == 2 and wt == 2:
            line["name"] = raw.decode("utf-8", "replace")
        elif field == 11 and wt == 2:
            line["display_name"] = raw.decode("utf-8", "replace")
        elif field == 3 and wt == 0:
            line["timestamp_ns"] = _signed(raw)
        elif field == 4 and wt == 2:
            line["events"].append(_decode_event(raw))
    return line


def _decode_meta_entry(buf: bytes, name_field: int = 2,
                       display_field: Optional[int] = None
                       ) -> Tuple[int, Dict[str, str]]:
    """One map<int64, X*Metadata> entry: {key=1, value=2} wrapping the
    metadata message."""
    key, meta = 0, {"name": "", "display_name": ""}
    for field, wt, raw in _fields(buf):
        if field == 1 and wt == 0:
            key = raw
        elif field == 2 and wt == 2:
            for f2, wt2, raw2 in _fields(raw):
                if f2 == 1 and wt2 == 0 and not key:
                    key = raw2
                elif f2 == name_field and wt2 == 2:
                    meta["name"] = raw2.decode("utf-8", "replace")
                elif display_field and f2 == display_field and wt2 == 2:
                    meta["display_name"] = raw2.decode("utf-8", "replace")
    return key, meta


def _decode_plane(buf: bytes) -> Dict[str, Any]:
    plane = {"id": 0, "name": "", "lines": [], "event_meta": {},
             "stat_meta": {}}
    for field, wt, raw in _fields(buf):
        if field == 1 and wt == 0:
            plane["id"] = raw
        elif field == 2 and wt == 2:
            plane["name"] = raw.decode("utf-8", "replace")
        elif field == 3 and wt == 2:
            plane["lines"].append(_decode_line(raw))
        elif field == 4 and wt == 2:
            k, meta = _decode_meta_entry(raw, name_field=2, display_field=4)
            plane["event_meta"][k] = meta
        elif field == 5 and wt == 2:
            k, meta = _decode_meta_entry(raw, name_field=2)
            plane["stat_meta"][k] = meta["name"]
    return plane


def read_xspace(src) -> Dict[str, Any]:
    """Parse an XSpace: a ``.xplane.pb`` path or raw bytes ->
    ``{"planes": [...]}`` with names/stats resolved per plane."""
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    planes = []
    for field, wt, raw in _fields(data):
        if field == 1 and wt == 2:
            planes.append(_decode_plane(raw))
    # resolve event/stat names in place
    for p in planes:
        emeta, smeta = p["event_meta"], p["stat_meta"]
        for line in p["lines"]:
            for ev in line["events"]:
                m = emeta.get(ev["metadata_id"], {})
                ev["name"] = m.get("display_name") or m.get("name") or \
                    f"event#{ev['metadata_id']}"
                ev["long_name"] = m.get("name") or ""
                ev["stats"] = {smeta.get(mid, f"stat#{mid}"): val
                               for mid, val in ev["stats"]}
    return {"planes": planes}


# -- protobuf wire format (encode: fixtures + tests only) ----------------------

def _enc_varint(v: int) -> bytes:
    out = bytearray()
    v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_field(field: int, wt: int, payload: bytes) -> bytes:
    head = _enc_varint((field << 3) | wt)
    if wt == 2:
        return head + _enc_varint(len(payload)) + payload
    return head + payload


def _enc_str(field: int, s: str) -> bytes:
    return _enc_field(field, 2, s.encode())


def _enc_int(field: int, v: int) -> bytes:
    return _enc_field(field, 0, _enc_varint(v))


def encode_xspace(planes: List[Dict[str, Any]]) -> bytes:
    """Encode a tiny XSpace (JAX's fixture generator,
    tests/fixtures/make_xplane_fixture.py, writes
    tests/fixtures/tiny.xplane.pb through its copy). Input shape::

        [{"name": "/device:TPU:0",
          "lines": [{"name": "XLA Ops", "timestamp_ns": ...,
                     "events": [{"name": "fusion.1", "offset_ps": ...,
                                 "duration_ps": ...}, ...]}]}]
    """
    out = b""
    for p in planes:
        names: Dict[str, int] = {}
        body = _enc_str(2, p["name"])
        for line in p.get("lines", ()):
            for ev in line.get("events", ()):
                names.setdefault(ev["name"], len(names) + 1)
        for name, mid in names.items():
            meta = _enc_int(1, mid) + _enc_str(2, name)
            entry = _enc_int(1, mid) + _enc_field(2, 2, meta)
            body += _enc_field(4, 2, entry)
        for li, line in enumerate(p.get("lines", ()), 1):
            lbody = _enc_int(1, li) + _enc_str(2, line["name"]) + \
                _enc_int(3, int(line.get("timestamp_ns", 0)))
            for ev in line.get("events", ()):
                ebody = (_enc_int(1, names[ev["name"]])
                         + _enc_int(2, int(ev.get("offset_ps", 0)))
                         + _enc_int(3, int(ev.get("duration_ps", 0))))
                lbody += _enc_field(4, 2, ebody)
            body += _enc_field(3, 2, lbody)
        out += _enc_field(1, 2, body)
    return out


# -- device extraction ---------------------------------------------------------

#: planes that are chip timelines (vs host threads / task environment)
DEVICE_PLANE_RE = re.compile(r"^/device:")


def device_planes(space: Dict[str, Any],
                  pattern: Optional[str] = None) -> List[Dict[str, Any]]:
    rx = re.compile(pattern) if pattern else DEVICE_PLANE_RE
    return [p for p in space.get("planes", ()) if rx.search(p["name"])]


def plane_events(plane: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Flat resolved events of one plane: absolute ns timestamps."""
    out = []
    for line in plane["lines"]:
        t0 = line.get("timestamp_ns", 0)
        lname = line.get("display_name") or line.get("name") or \
            f"line#{line.get('id', 0)}"
        for ev in line["events"]:
            # integer ns throughout: float ns at wall-clock epoch scale
            # (~1.7e18) quantizes to ~256 ns and mis-nests adjacent
            # events in the self-time computation
            out.append({"name": ev["name"], "long_name": ev.get("long_name",
                                                                ""),
                        "line": lname, "line_id": line.get("id", 0),
                        "ts_ns": t0 + ev["offset_ps"] // 1000,
                        "dur_ns": ev["duration_ps"] // 1000,
                        "stats": ev.get("stats", {})})
    out.sort(key=lambda e: e["ts_ns"])
    return out


# -- obs-dump conversion (the chrome-merge bridge) -----------------------------

#: pid block device lanes render under — far above real OS pids so a
#: merged trace can't collide a plane with a host process lane
DEVICE_PID_BASE = 900000


def xplane_dump(space: Dict[str, Any], *, device_only: bool = True,
                base_pid: int = DEVICE_PID_BASE,
                anchor_unix: Optional[float] = None) -> Dict[str, Any]:
    """Convert a parsed XSpace into the standard obs dump shape
    (meta/metrics/events) so ``obs.merge_dumps`` + ``obs.chrome_trace``
    stitch device lanes into the host timeline: one process lane per
    plane, one tid per line, spans named by the resolved op.

    Events are rebased to the trace's earliest timestamp. XLine clocks
    are backend-dependent (wall-clock on some, trace-relative on the CPU
    runtime), so alignment with obs host spans is explicit:
    ``anchor_unix`` sets the dump's ``clock_origin_unix`` — the CLI
    anchors device lanes at the earliest host dump's origin (coarse
    best-effort; the lanes always render, alignment is advisory). With
    no anchor the field is the trace's own epoch second."""
    planes = (device_planes(space) if device_only
              else list(space.get("planes", ())))
    if device_only and not planes:
        # host-only trace (CPU backend): fall back to every plane rather
        # than an empty dump — the lanes still show where time went
        planes = list(space.get("planes", ()))
    events: List[Dict[str, Any]] = []
    processes: Dict[str, str] = {}
    # one plane_events() pass per plane — flatten+sort is the dominant
    # cost on real traces, so compute it once and reuse for both the
    # global t0 scan and the emit loop
    per_plane = [list(plane_events(p)) for p in planes]
    t0_ns = min((ev["ts_ns"] for evs in per_plane for ev in evs),
                default=0.0)
    for pi, plane in enumerate(planes):
        pid = base_pid + pi
        processes[str(pid)] = plane["name"]
        for ev in per_plane[pi]:
            site = site_of(ev)
            args = {"line": ev["line"]}
            if site:
                args["site"] = site
            events.append({"kind": "span", "name": ev["name"],
                           "ts": (ev["ts_ns"] - t0_ns) / 1e9,
                           "dur": ev["dur_ns"] / 1e9,
                           "pid": pid, "tid": int(ev["line_id"]),
                           "args": args})
    origin = anchor_unix if anchor_unix is not None else t0_ns / 1e9
    return {"meta": {"process": "device", "pid": base_pid,
                     "processes": processes,
                     "clock_origin_unix": origin},
            "metrics": [], "events": events}


# -- per-op aggregation + site attribution -------------------------------------

#: the fluid Executor's site stamp (a record_function range here, a
#: jax.named_scope in JAX):
#: b<block>_op<idx>_<type> — embedded anywhere in the HLO op's name or
#: metadata once XLA has fused/renamed around it
_SITE_RE = re.compile(r"\bb(\d+)_op(\d+)_([A-Za-z0-9_]+?)(?:[./\s]|$)")


def site_of(event: Dict[str, Any]) -> Optional[str]:
    """Attribute one profiled op back to its Program site: invert the
    executor's named-scope stamp to the analysis plane's canonical
    ``block B, op #I (type)`` string (analysis.diagnostics.op_site)."""
    hay = " ".join([event.get("name", ""), event.get("long_name", "")]
                   + [str(v) for v in (event.get("stats") or {}).values()
                      if isinstance(v, str)])
    m = _SITE_RE.search(hay)
    if not m:
        return None
    from ..analysis.diagnostics import op_site
    # the stamp's op-type tail may carry fused suffixes; strip trailing
    # underscores the scope sanitizer introduced
    return op_site(int(m.group(1)), int(m.group(2)),
                   m.group(3).strip("_") or None)


#: the profiler's own session machinery as it appears in host python
#: lines ("$profiler.py:91 start_trace", "$profiler.py:226 trace", ...)
_PROFILER_FRAME_RE = re.compile(
    r"profiler\.py:\d+ \w*trace$|^\$?jax\.profiler")


def _drop_envelopes(evs: List[Dict[str, Any]],
                    frac: float = 0.98) -> List[Dict[str, Any]]:
    """Drop pure envelope events — ones spanning (almost) the whole line
    while containing other events. On the host-plane fallback the frame
    wrapping the trace session (contextmanager __enter__, the profiler
    context itself) inherits every idle second as "self time" and buries
    the report; its children carry the real work and still count."""
    if len(evs) < 2:
        return evs
    lo = min(e["ts_ns"] for e in evs)
    hi = max(e["ts_ns"] + e["dur_ns"] for e in evs)
    extent = hi - lo
    if extent <= 0:
        return evs

    def _is_envelope(e):
        if e["dur_ns"] < frac * extent:
            return False
        # spanning the line is not enough: a single dominant op that
        # contains nothing else is real work, not a session frame
        return any(o is not e
                   and o["ts_ns"] >= e["ts_ns"]
                   and o["ts_ns"] + o["dur_ns"] <= e["ts_ns"] + e["dur_ns"]
                   for o in evs)

    return [e for e in evs if not _is_envelope(e)]


def _self_times(events: List[Dict[str, Any]]) -> List[float]:
    """Self time (ns) per event of ONE line: total duration minus the
    duration of events nested inside it (containment by time range)."""
    order = sorted(range(len(events)),
                   key=lambda i: (events[i]["ts_ns"], -events[i]["dur_ns"]))
    self_ns = [0.0] * len(events)
    stack: List[int] = []
    for i in order:
        ev = events[i]
        while stack and (events[stack[-1]]["ts_ns"]
                         + events[stack[-1]]["dur_ns"]) <= ev["ts_ns"]:
            stack.pop()
        if stack:
            self_ns[stack[-1]] -= ev["dur_ns"]
        self_ns[i] += ev["dur_ns"]
        stack.append(i)
    return self_ns


def op_totals(space: Dict[str, Any], *, device_only: bool = True
              ) -> List[Dict[str, Any]]:
    """Aggregate per-op totals over the (device) planes: one row per op
    name with occurrences, total/self time, and the Program site when a
    named-scope stamp survives in the op's metadata. Sorted by self time
    descending — the ``profile`` top-k table's rows."""
    planes = (device_planes(space) if device_only
              else list(space.get("planes", ())))
    if device_only and not planes:
        planes = list(space.get("planes", ()))
    agg: Dict[str, Dict[str, Any]] = {}
    for plane in planes:
        lines = plane["lines"]
        # a device plane carries BOTH the op-level line and envelope
        # lines ("XLA Modules", "Steps") covering the same wall time —
        # aggregate the op-level detail only, or every op would count
        # twice inside its module's span
        op_lines = [l for l in lines
                    if (l.get("display_name") or l["name"]) == "XLA Ops"]
        if op_lines:
            lines = op_lines
        for line in lines:
            evs = [{"name": e["name"], "long_name": e.get("long_name", ""),
                    "stats": e.get("stats", {}),
                    # integer ns: see plane_events on float quantization
                    "ts_ns": line.get("timestamp_ns", 0)
                    + e["offset_ps"] // 1000,
                    "dur_ns": e["duration_ps"] // 1000}
                   for e in line["events"]
                   # the profiler's own session envelopes span the whole
                   # trace on the host-plane fallback; their "self time"
                   # is idle, not an op
                   if not _PROFILER_FRAME_RE.search(e["name"])]
            evs = _drop_envelopes(evs)
            selfs = _self_times(evs)
            for ev, sns in zip(evs, selfs):
                row = agg.get(ev["name"])
                if row is None:
                    row = agg[ev["name"]] = {
                        "op": ev["name"], "count": 0, "total_ns": 0.0,
                        "self_ns": 0.0, "site": site_of(ev)}
                elif row["site"] is None:
                    row["site"] = site_of(ev)
                row["count"] += 1
                row["total_ns"] += ev["dur_ns"]
                row["self_ns"] += sns
    return sorted(agg.values(), key=lambda r: -r["self_ns"])


def top_ops_report(space: Dict[str, Any], *, topk: int = 15,
                   steps: int = 1) -> str:
    """The human top-k table ``profile`` prints: per-op self
    time (amortized over ``steps`` profiled steps), share of device
    time, and the attributed ``block B, op #I (type)`` site."""
    rows = op_totals(space)
    total = sum(r["self_ns"] for r in rows) or 1.0
    lines = [f"{'#':>3} {'self ms/step':>12} {'%dev':>6} {'count':>7}  "
             f"{'op':<44} site",
             "-" * 100]
    for i, r in enumerate(rows[:topk], 1):
        name = r["op"] if len(r["op"]) <= 44 else r["op"][:41] + "..."
        lines.append(
            f"{i:>3} {r['self_ns'] / 1e6 / max(steps, 1):>12.3f} "
            f"{100 * r['self_ns'] / total:>5.1f}% {r['count']:>7}  "
            f"{name:<44} {r['site'] or '-'}")
    dev_ms = total / 1e6 / max(steps, 1)
    lines.append(f"device step: {dev_ms:.3f} ms over {len(rows)} distinct "
                 f"ops ({steps} profiled steps)")
    return "\n".join(lines)


# -- the site stamps a torch.profiler run records ------------------------------

_STAMP = threading.local()


class site_range:
    """``torch.profiler.record_function(tag)`` around the block while a
    profiler records, with ``tag`` as this thread's current stamp
    (:func:`current_stamp`); nothing otherwise. The fluid executor opens
    one per op (``b{B}_op{I}_{type}``); an autograd function whose
    forward ran inside one reopens it around its backward, which the
    autograd engine may run on another thread, so that the backward's
    kernels carry the op's site too."""

    __slots__ = ("tag", "_rf", "_prev")

    def __init__(self, tag: Optional[str]):
        self.tag = tag
        self._rf = None

    def __enter__(self):
        if self.tag is None:
            return self
        from torch.autograd import profiler as _prof
        if not _prof._is_profiler_enabled:
            return self
        import torch
        self._prev = getattr(_STAMP, "tag", None)
        _STAMP.tag = self.tag
        self._rf = torch.profiler.record_function(self.tag)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            _STAMP.tag = self._prev
            self._rf = None
        return False


def current_stamp() -> Optional[str]:
    """The innermost :class:`site_range` tag open on this thread while a
    profiler records, else None."""
    return getattr(_STAMP, "tag", None)


# -- the torch.profiler reader --------------------------------------------------

#: the Chrome-trace categories of a torch.profiler run that the reader
#: takes: host ranges and ops, the launches, the device's kernels
_HOST_CATS = ("user_annotation", "cpu_op", "python_function")


def _scope_of(ev: Dict[str, Any], ranges) -> Optional[str]:
    """The innermost site-stamped range of ``ranges`` (this thread's
    user annotations, sorted by start) open at ``ev``'s start."""
    best = None
    t = ev["ts"]
    for r in ranges:
        if r["ts"] > t:
            break
        if r["ts"] + r.get("dur", 0) >= t and (
                best is None or r["ts"] >= best["ts"]):
            best = r
    return best["name"] if best is not None else None


def read_torch_trace(src) -> Dict[str, Any]:
    """A ``torch.profiler`` run as the ``space`` dict :func:`read_xspace`
    gives: ``src`` is a ``torch.profiler.profile`` (after its run), the
    path of the Chrome trace it exported, or that trace's parsed JSON.

    Device plane ``/device:GPU:<n>`` per device, one line ``Kernels``
    holding every kernel; host plane ``/host:CPU``, one line per thread
    holding its ranges and ops. Each event's ``stats`` carry its
    ``scope``: the innermost ``b{B}_op{I}_{type}`` range open on the
    launching (kernels) or running (host ops) thread, which is what
    :func:`site_of` reads."""
    import json
    import os
    if hasattr(src, "export_chrome_trace"):
        import tempfile
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            src.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
    elif isinstance(src, dict):
        trace = src
    else:
        with open(src) as f:
            trace = json.load(f)
    evs = [e for e in trace.get("traceEvents", ())
           if e.get("ph") == "X" and "ts" in e]
    # site-stamped ranges per host thread, and each launch's thread/time
    ranges: Dict[Tuple, List[Dict[str, Any]]] = {}
    for e in evs:
        if e.get("cat") == "user_annotation" and _SITE_RE.search(
                e.get("name", "") + " "):
            ranges.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    for rs in ranges.values():
        rs.sort(key=lambda r: r["ts"])
    launch = {}
    for e in evs:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = e
    t0 = min((e["ts"] for e in evs), default=0.0)

    def event(e, scope):
        ev = {"name": e.get("name", ""), "long_name": e.get("name", ""),
              "offset_ps": int(round((e["ts"] - t0) * 1e6)),
              "duration_ps": int(round(float(e.get("dur", 0)) * 1e6)),
              "stats": {}}
        if scope:
            ev["stats"]["scope"] = scope
        return ev

    devices: Dict[int, List[Dict[str, Any]]] = {}
    threads: Dict[Tuple, List[Dict[str, Any]]] = {}
    for e in evs:
        cat = e.get("cat")
        if cat == "kernel":
            args = e.get("args") or {}
            src_ev = launch.get(args.get("correlation"))
            scope = None
            if src_ev is not None:
                scope = _scope_of(src_ev, ranges.get(
                    (src_ev.get("pid"), src_ev.get("tid")), ()))
            dev = int(args.get("device", 0) or 0)
            devices.setdefault(dev, []).append(event(e, scope))
        elif cat in _HOST_CATS:
            scope = _scope_of(e, ranges.get((e.get("pid"), e.get("tid")),
                                            ()))
            threads.setdefault((e.get("pid"), e.get("tid")), []).append(
                event(e, scope))
    base_ns = int(round(t0 * 1e3))
    planes = []
    for pi, (dev, kevs) in enumerate(sorted(devices.items())):
        kevs.sort(key=lambda v: v["offset_ps"])
        planes.append({"id": pi + 1, "name": f"/device:GPU:{dev}",
                       "lines": [{"id": 1, "name": "Kernels",
                                  "display_name": "",
                                  "timestamp_ns": base_ns,
                                  "events": kevs}],
                       "event_meta": {}, "stat_meta": {}})
    if threads:
        lines = []
        for li, (key, hevs) in enumerate(sorted(
                threads.items(), key=lambda kv: str(kv[0])), 1):
            hevs.sort(key=lambda v: v["offset_ps"])
            lines.append({"id": li, "name": f"thread {key[1]}",
                          "display_name": "", "timestamp_ns": base_ns,
                          "events": hevs})
        planes.append({"id": len(planes) + 1, "name": "/host:CPU",
                       "lines": lines, "event_meta": {}, "stat_meta": {}})
    return {"planes": planes}


def read_trace(path: str) -> Dict[str, Any]:
    """A trace file as a ``space``: a ``.xplane.pb`` through
    :func:`read_xspace`, a torch.profiler Chrome trace (``.json``, or
    ``.json.gz``) through :func:`read_torch_trace`."""
    if path.endswith(".gz"):
        import gzip
        import json
        with gzip.open(path, "rt") as f:
            return read_torch_trace(json.load(f))
    if path.endswith(".json"):
        return read_torch_trace(path)
    return read_xspace(path)


# -- the xprof path ----------------------------------------------------------------

def hlo_stats_rows(xplane_path: str) -> Optional[List[Dict[str, Any]]]:
    """xprof's ``hlo_stats`` rows have no counterpart for a torch.profiler
    trace: None, as JAX's answers where xprof is missing."""
    return None
