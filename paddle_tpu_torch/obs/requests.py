"""Per-request timeline ledger for the serving fabric.

Every request that crosses the router/prefill/decode fabric carries a
client-minted ``submit_key``; each process appends structured phase
records to its local :class:`RequestLedger` under that key (re-routed
legs under the derived ``{key}#r{n}``). Ledger exports flow to the
router/master :class:`RequestStore` (scrape pump + ``obs_health``),
where :func:`stitch` merges the legs into one timeline per base key —
the evidence layer behind ``serving.phase_seconds{phase}``, the
slowest-K exemplar ring attached to burn-rate alerts, ``python -m paddle_tpu_torch obs
trace`` and the ``/requests`` endpoint (the JAX package's observability design notes,
"Request timelines & SLO attribution").

Durations telescope: an event's ``dur`` is the gap since the previous
event for that key on the same ledger, so per-ledger duration sums are
exact by construction; recorders that measured a sub-interval
themselves (the prefill worker's compute/ship walls) pass ``dur``
explicitly. Cross-process gaps therefore surface as unattributed
remainder rather than being mis-billed to a phase.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

from . import count as _count
from . import observe as _observe

# canonical phase vocabulary (the JAX package's observability design notes)
PHASES = ("admitted", "queued", "scheduled", "prefill", "ship", "adopt",
          "first_token", "decode", "route", "reroute", "done", "cancel")
#: phases that close a timeline
TERMINAL = ("done", "cancel")
#: phases whose telescoped duration is attributed into the SLO
#: breakdown histogram serving.phase_seconds{phase} — a bounded enum,
#: never a request key (L005)
ATTRIBUTED = ("queued", "scheduled", "prefill", "ship", "adopt", "decode")
#: point events that repeat per segment and fold into one record
_FOLDABLE = ("decode",)

_MAX_EXTRA = 6
_MAX_EXTRA_STR = 80


def base_key(key: str) -> str:
    """Strip the re-route suffix: ``k#r2`` → ``k`` (router.py derives
    leg keys as ``f"{key}#r{n}"`` on every re-route)."""
    return str(key).split("#r", 1)[0]


def leg_of(key: str) -> int:
    """Leg ordinal encoded in the key: ``k`` → 0, ``k#r2`` → 2."""
    s = str(key)
    if "#r" not in s:
        return 0
    try:
        return int(s.rsplit("#r", 1)[1])
    except ValueError:
        return 0


def _clean_extra(extra: dict) -> dict:
    out = {}
    for k, v in extra.items():
        if len(out) >= _MAX_EXTRA:
            break
        if isinstance(v, bool) or isinstance(v, (int, float)):
            out[str(k)] = v
        elif isinstance(v, str):
            out[str(k)] = v[:_MAX_EXTRA_STR]
    return out


class RequestLedger:
    """Bounded per-process ring of request timelines.

    Thread-safe; install via :func:`paddle_tpu_torch.obs.ensure_request_ledger`
    so the ``obs.req_phase`` hook finds it. ``clock`` is injectable for
    deterministic tests; ``origin_unix`` maps ledger timestamps onto
    unix time so legs recorded by different processes stitch onto one
    axis (same contract as the session meta's ``clock_origin_unix``).
    """

    def __init__(self, *, cap: int = 1024, events_cap: int = 256,
                 clock=None, ident: Optional[str] = None):
        self._clock = clock if clock is not None else time.time
        self.origin_unix = time.time() - self._clock()
        self.cap = int(cap)
        self.events_cap = int(events_cap)
        self.ident = str(ident) if ident else f"pid{__import__('os').getpid()}"
        self._lock = threading.Lock()
        self._tl: "OrderedDict[str, dict]" = OrderedDict()
        self.dropped = 0  # timelines evicted by the ring cap

    def __len__(self) -> int:
        with self._lock:
            return len(self._tl)

    def install(self) -> "RequestLedger":
        from . import _set_requests
        _set_requests(self)
        return self

    def uninstall(self) -> None:
        from . import _REQUESTS, _set_requests
        if _REQUESTS is self:
            _set_requests(None)

    def phase(self, key: str, phase: str, dur: Optional[float] = None,
              **extra) -> None:
        """Append a phase record. ``dur`` defaults to the telescoped gap
        since this key's previous event (0.0 for the first)."""
        now = self._clock()
        key = str(key)
        with self._lock:
            tl = self._tl.get(key)
            if tl is None:
                if len(self._tl) >= self.cap:
                    self._tl.popitem(last=False)
                    self.dropped += 1
                tl = {"key": key, "recorder": self.ident,
                      "origin": self.origin_unix, "events": [],
                      "done": False, "updated": now}
                self._tl[key] = tl
            else:
                self._tl.move_to_end(key)
            evs = tl["events"]
            d = float(dur) if dur is not None else (
                max(0.0, now - evs[-1]["t"]) if evs else 0.0)
            last = evs[-1] if evs else None
            if (last is not None and phase in _FOLDABLE
                    and last["phase"] == phase):
                # fold the per-segment decode stream into one record so a
                # long generation stays O(1) in the event list
                last["t"] = now
                last["dur"] += d
                if "n" in extra:
                    last["n"] = int(last.get("n", 0)) + int(extra["n"])
                last["folds"] = int(last.get("folds", 0)) + 1
            elif len(evs) >= self.events_cap:
                tl["overflow"] = int(tl.get("overflow", 0)) + 1
            else:
                ev = {"phase": str(phase), "t": now, "dur": d}
                ev.update(_clean_extra(extra))
                evs.append(ev)
            if phase in TERMINAL:
                tl["done"] = True
            tl["updated"] = now
        if phase in ATTRIBUTED and d > 0.0:
            _observe("serving.phase_seconds", d, phase=phase)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            tl = self._tl.get(str(key))
            return _copy_tl(tl) if tl is not None else None

    def export(self, n: Optional[int] = None,
               keys: Optional[Iterable[str]] = None) -> List[dict]:
        """Wire-safe copies of the most recently updated ``n`` timelines
        (all when ``n`` is None), oldest-update first."""
        with self._lock:
            if keys is not None:
                picked = [self._tl[k] for k in keys if k in self._tl]
            else:
                picked = list(self._tl.values())
                if n is not None and len(picked) > n:
                    picked = picked[-int(n):]
            return [_copy_tl(tl) for tl in picked]

    def forget(self, key: str) -> bool:
        """Drop one timeline (membership reap / post-aggregation)."""
        with self._lock:
            return self._tl.pop(str(key), None) is not None


def _copy_tl(tl: dict) -> dict:
    out = dict(tl)
    out["events"] = [dict(ev) for ev in tl["events"]]
    return out


def group_legs(timelines) -> Dict[str, List[dict]]:
    """Group raw timelines by base key for :func:`stitch`, deduplicating
    legs recorded by the same ``(recorder, key)`` — a leg can reach a
    merged dump twice (scrape pump AND the recorder's own dump); the
    copy with more events wins."""
    best: Dict[Tuple[str, str], dict] = {}
    for tl in timelines or ():
        if not isinstance(tl, dict) or not tl.get("key"):
            continue
        lk = (str(tl.get("recorder") or tl.get("worker") or ""),
              str(tl["key"]))
        cur = best.get(lk)
        if cur is None or len(tl.get("events") or ()) >= \
                len(cur.get("events") or ()):
            best[lk] = tl
    out: Dict[str, List[dict]] = {}
    for (_, key), tl in best.items():
        out.setdefault(base_key(key), []).append(tl)
    return out


def stitch(timelines: Iterable[dict]) -> Optional[dict]:
    """Merge one request's legs (``k``, ``k#r1``, ...) across recorders
    into a single timeline on the unix-time axis.

    The stitching contract: events sort by ``origin + t``; the earliest
    ``first_token`` is canonical and later ones (a re-routed leg
    resuming the stream) are flagged ``resumed`` so TTFT is never
    double-counted; ``breakdown`` sums only ATTRIBUTED phase durations
    while ``total_s`` sums every duration, so per-ledger telescoping
    reconciles against observed TTFT + decode wall time.
    """
    tls = [tl for tl in timelines if isinstance(tl, dict)
           and tl.get("events")]
    if not tls:
        return None
    base = base_key(tls[0].get("key", ""))
    events: List[dict] = []
    legs = set()
    workers = set()
    for tl in tls:
        origin = float(tl.get("origin", 0.0))
        leg = leg_of(tl.get("key", ""))
        legs.add(leg)
        w = tl.get("worker")
        if w:
            workers.add(str(w))
        for seq, ev in enumerate(tl["events"]):
            try:
                t_unix = origin + float(ev["t"])
            except (KeyError, TypeError, ValueError):
                continue
            e = dict(ev)
            e["t_unix"] = t_unix
            e["leg"] = leg
            if w:
                e["worker"] = str(w)
            rec = tl.get("recorder")
            if rec:
                e["recorder"] = str(rec)
            events.append((t_unix, leg, seq, e))
    if not events:
        return None
    events.sort(key=lambda it: (it[0], it[1], it[2]))
    evs = [e for (_, _, _, e) in events]
    t0 = evs[0]["t_unix"]
    t_ft = None
    for e in evs:
        if e["phase"] == "first_token":
            if t_ft is None:
                t_ft = e["t_unix"]
            else:
                e["resumed"] = True
    t_end = evs[-1]["t_unix"]
    done = any(e["phase"] in TERMINAL for e in evs)
    breakdown: Dict[str, float] = {}
    total = 0.0
    for e in evs:
        d = float(e.get("dur", 0.0))
        total += d
        if e["phase"] in ATTRIBUTED:
            breakdown[e["phase"]] = breakdown.get(e["phase"], 0.0) + d
    dominant = max(breakdown, key=breakdown.get) if breakdown else None
    return {
        "key": base,
        "legs": sorted(legs),
        "workers": sorted(workers),
        "reroutes": max(legs) if legs else 0,
        "done": done,
        "t0_unix": t0,
        "ttft_s": (t_ft - t0) if t_ft is not None else None,
        "wall_s": t_end - t0,
        "total_s": total,
        "breakdown": breakdown,
        "dominant": dominant,
        "events": evs,
    }


def format_timeline(st: dict) -> str:
    """Human-readable rendering of a stitched timeline for the
    ``python -m paddle_tpu_torch obs trace`` CLI."""
    lines = []
    ttft = st.get("ttft_s")
    head = (f"request {st['key']}  "
            f"{'done' if st.get('done') else 'in-flight'}  "
            f"legs={len(st.get('legs') or [0])}")
    if ttft is not None:
        head += f"  ttft={ttft * 1e3:.1f}ms"
    head += f"  wall={st.get('wall_s', 0.0) * 1e3:.1f}ms"
    if st.get("dominant"):
        head += f"  dominant={st['dominant']}"
    lines.append(head)
    bd = st.get("breakdown") or {}
    if bd:
        parts = [f"{p}={bd[p] * 1e3:.1f}ms" for p in ATTRIBUTED if p in bd]
        lines.append("  breakdown: " + "  ".join(parts))
    t0 = st.get("t0_unix", 0.0)
    for e in st.get("events", []):
        rel = e.get("t_unix", t0) - t0
        who = e.get("worker") or e.get("recorder") or "?"
        row = (f"  +{rel * 1e3:9.2f}ms  leg{e.get('leg', 0)} "
               f"{who:<16} {e['phase']:<12}")
        d = float(e.get("dur", 0.0))
        if d > 0.0:
            row += f" dur={d * 1e3:.2f}ms"
        for k in ("n", "why", "reason", "to", "tenant", "folds"):
            if k in e:
                row += f" {k}={e[k]}"
        if e.get("resumed"):
            row += " resumed"
        lines.append(row)
    return "\n".join(lines)


class RequestStore:
    """Router/master-side aggregation of ledger exports.

    Legs key on ``(recorder, key)`` so a timeline pushed twice (scrape
    pump AND loopback push) replaces rather than duplicates. Memory is
    a ring over base keys plus the slowest-K exemplar window; membership
    ``forget_worker`` reaps a departed worker's legs for *completed*
    requests immediately while in-flight legs survive until their base
    stitches done — exactly what re-route stitching after kill -9
    needs (tests/test_serving_router.py).
    """

    def __init__(self, *, cap: int = 1024, exemplar_k: int = 8,
                 window_s: float = 600.0, clock=None):
        self._clock = clock if clock is not None else time.monotonic
        self.cap = int(cap)
        self.exemplar_k = int(exemplar_k)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        # base key -> {"legs": {(recorder, key): tl}, "noted": bool}
        self._reqs: "OrderedDict[str, dict]" = OrderedDict()
        self._exemplars: List[dict] = []  # slowest-first within window
        self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._reqs)

    def push(self, worker: str, timelines) -> int:
        """Absorb one worker's ledger export; returns accepted count.
        Wire-tolerant: malformed entries are skipped, never raised."""
        if not isinstance(timelines, (list, tuple)):
            return 0
        accepted = 0
        touched = []
        with self._lock:
            for tl in timelines:
                if not isinstance(tl, dict):
                    continue
                key = tl.get("key")
                if not isinstance(key, str) or not key:
                    continue
                evs = tl.get("events")
                if not isinstance(evs, list):
                    continue
                clean = _copy_tl({**tl, "events": [
                    e for e in evs if isinstance(e, dict)
                    and isinstance(e.get("phase"), str)
                    and isinstance(e.get("t"), (int, float))]})
                clean["worker"] = str(worker)
                base = base_key(key)
                req = self._reqs.get(base)
                if req is None:
                    if len(self._reqs) >= self.cap:
                        self._reqs.popitem(last=False)
                        self.dropped += 1
                    req = {"legs": {}, "noted": False}
                    self._reqs[base] = req
                else:
                    self._reqs.move_to_end(base)
                rec = str(clean.get("recorder") or worker)
                req["legs"][(rec, key)] = clean
                accepted += 1
                touched.append(base)
            stitched = []
            for base in dict.fromkeys(touched):
                req = self._reqs.get(base)
                if req is None or req["noted"]:
                    continue
                st = stitch(req["legs"].values())
                if st is not None and st["done"]:
                    req["noted"] = True
                    stitched.append(st)
        for st in stitched:
            self._note_exemplar(st)
        return accepted

    def _note_exemplar(self, st: dict) -> None:
        # rank by TTFT when the request produced a first token, else by
        # wall time (a cancelled request can still be the slow exemplar)
        score = st["ttft_s"] if st.get("ttft_s") is not None \
            else st.get("wall_s", 0.0)
        entry = dict(st)
        entry["score"] = float(score)
        entry["noted_at"] = self._clock()
        with self._lock:
            self._exemplars.append(entry)
            self._exemplars.sort(key=lambda e: -e["score"])
            del self._exemplars[self.exemplar_k:]
        _count("serving.exemplars_total",
               phase=str(st.get("dominant") or "none"))

    def exemplars(self, k: Optional[int] = None,
                  full: bool = False) -> List[dict]:
        """Slowest-K stitched timelines inside the alert window,
        slowest first. ``full=False`` drops the event list — the compact
        form attached to burn-rate alert transitions."""
        now = self._clock()
        with self._lock:
            self._exemplars = [e for e in self._exemplars
                               if now - e["noted_at"] <= self.window_s]
            picked = self._exemplars[:k if k is not None else self.exemplar_k]
            out = []
            for e in picked:
                c = dict(e)
                c.pop("noted_at", None)
                if not full:
                    c.pop("events", None)
                out.append(c)
            return out

    def get(self, key: str) -> Optional[dict]:
        """Stitched timeline for a base (or leg) key."""
        with self._lock:
            req = self._reqs.get(base_key(key))
            legs = list(req["legs"].values()) if req else []
        return stitch(legs) if legs else None

    def recent(self, n: int = 64) -> List[dict]:
        """Stitched summaries (no event lists) of the n most recently
        updated requests, oldest first."""
        with self._lock:
            bases = list(self._reqs.keys())[-int(n):]
            legs_by_base = [(b, list(self._reqs[b]["legs"].values()))
                            for b in bases]
        out = []
        for b, legs in legs_by_base:
            st = stitch(legs)
            if st is not None:
                st.pop("events", None)
                out.append(st)
        return out

    def export_legs(self, n: int = 128) -> List[dict]:
        """Raw leg timelines of the n most recent bases — the wire form
        served by ``obs_health`` / ``/requests`` so every consumer runs
        the same :func:`stitch`."""
        with self._lock:
            bases = list(self._reqs.keys())[-int(n):]
            return [_copy_tl(tl) for b in bases
                    for tl in self._reqs[b]["legs"].values()]

    def forget(self, key: str) -> bool:
        with self._lock:
            return self._reqs.pop(base_key(key), None) is not None

    def forget_worker(self, worker: str) -> int:
        """Membership reap: drop the departed worker's legs for
        completed requests (in-flight legs stay stitchable)."""
        w = str(worker)
        dropped = 0
        with self._lock:
            for base in list(self._reqs.keys()):
                req = self._reqs[base]
                if not req["noted"]:
                    continue
                legs = req["legs"]
                for lk in [lk for lk, tl in legs.items()
                           if tl.get("worker") == w]:
                    del legs[lk]
                    dropped += 1
                if not legs:
                    del self._reqs[base]
        return dropped
