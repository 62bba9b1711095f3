"""The serving daemon + client over the native RPC plane — the
counterpart of ``paddle_tpu/serving/daemon.py``: the same ops, the same
JSON frames and the same structured refusals, so a client of either
package drives a daemon of the other.

Left out until the port has the obs session plane (ROADMAP A.8): the
telemetry push of the engine's registry into the master-side aggregator,
the engine's SLO alert rules, request timelines (``srv_requests``
answers an empty list, as JAX's does with the obs plane off), and the
obs counters and spans of JAX's copy.

The daemon is a :class:`~paddle_tpu_torch.runtime.master_service.MasterServer`
whose control plane grew three ops (``register_op`` — they ride the
``ptms_set_fallback`` unknown-op path, so the C++ data plane never learns
their payloads):

* ``srv_submit {prompt, max_new, eos_id?, timeout_s?}`` -> ``{rid}``, or a
  STRUCTURED refusal: ``code="overloaded"`` (+ ``retry_after_s``) when the
  admission queue is full — backpressure is a reply, never a dead
  connection — and ``code="invalid_argument"`` for requests the
  validation-hardening layer rejects at submit time;
* ``srv_poll {rid, cursor}`` -> ``{tokens, done, reason}`` — token
  STREAMING is cursor-based polling (tokens materialize at segment
  boundaries, so poll cadence ~ segment cadence loses nothing);
* ``srv_cancel {rid}`` -> frees the request's slot and pages at the next
  segment boundary.

``srv_stats`` rides along for load visibility.

Disaggregation (docs/design/serving.md "Disaggregation & routing") adds
two more ops plus a second daemon flavor:

* ``srv_ship_pages {xid, seq, total, data, crc}`` — receive one CRC'd
  chunk of a shipped KV-page payload (serving/ship.py wire contract);
* ``srv_adopt_pages {xid, manifest, max_new, ..., submit_key}`` — verify
  the reassembled shipment and adopt it as a live decode-only request
  (``engine.submit_prefilled``); damaged payloads refuse with
  ``code="data_loss"`` and are NEVER adopted;
* :class:`PrefillDaemon` — a pool-only worker (no decode scheduler) whose
  ``srv_prefill`` admits a prompt, exports the slot's pages, ships them to
  the named decode worker and answers with the DECODE worker's rid.

Both daemons can ``join_router`` a :class:`~.router.ServingRouter`'s
membership table; once joined, every srv_* reply is stamped with the
membership epoch (the ``_RpcClient`` records it, and the final
reconnect error reports how current the client's view was).
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import faults
from ..runtime.master_service import MasterServer, _RpcClient
from ..runtime.membership import HeartbeatKeeper, MembershipClient
from ..utils.retry import RetryPolicy
from . import ship as _ship
from .batcher import Request, prefix_resubmission_error
from .engine import Overloaded, ServingEngine

#: ship reassembly buffers a daemon holds at once — a prefill worker that
#: died mid-ship must not leak unbounded half-shipments
_SHIP_CAP = 16


class _RouterMember:
    """Mixin: membership-table residency for a serving-plane daemon.

    ``join_router`` registers the daemon with a router's
    :class:`~..runtime.membership.MembershipService` (caps carry the
    role + this daemon's own RPC address so the router can dial back),
    keeps the lease with a :class:`HeartbeatKeeper`, and tracks the
    latest membership epoch for reply stamping."""

    _epoch: Optional[int] = None
    _keeper: Optional[HeartbeatKeeper] = None
    _mbr_client: Optional[MembershipClient] = None
    _mbr_worker: Optional[str] = None

    def join_router(self, endpoints, worker: str, *,
                    role: str = "decode") -> int:
        """Join the router's membership table; returns the epoch joined
        at. ``endpoints`` is the router address (or failover list)."""
        host, port = self.address
        caps = {"role": role, "rpc_host": host, "rpc_port": int(port)}
        eps = list(endpoints)
        if eps and not isinstance(eps[0], (list, tuple)):
            eps = [tuple(endpoints)]        # a single (host, port) pair
        client = MembershipClient(
            endpoints=[(str(h), int(p)) for h, p in eps])
        token, epoch, reply = client.join(worker, caps)
        self._epoch = epoch
        self._mbr_client = client
        self._mbr_worker = worker
        self._keeper = HeartbeatKeeper(
            client, worker, token, ttl=float(reply.get("ttl", 10.0)),
            epoch=epoch, caps=caps, on_epoch=self._note_epoch).start()
        return epoch

    def _note_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def _leave_router(self) -> None:
        if self._keeper is not None:
            self._keeper.stop()
        if self._mbr_client is not None:
            try:
                if self._keeper is not None:
                    self._mbr_client.leave(self._mbr_worker,
                                           self._keeper.token)
            except Exception:
                pass    # best effort: the lease TTL evicts us anyway
            self._mbr_client.close()
        self._keeper = self._mbr_client = self._mbr_worker = None

    def _stamped(self, fn):
        """Wrap an op handler so its replies carry the membership epoch
        once the daemon joined a router (and never before — a solo
        daemon's replies stay byte-identical to the pre-router wire)."""
        def handler(req):
            resp = fn(req)
            if isinstance(resp, dict) and self._epoch is not None \
                    and "epoch" not in resp:
                resp = dict(resp, epoch=self._epoch)
            return resp
        return handler


class ServingDaemon(_RouterMember):
    """Long-lived serving process: engine + RPC surface + telemetry push.

    ``start()`` registers the srv_* ops, starts the native server and the
    engine's scheduler thread. ``stop(drain_s=N)`` gives in-flight and
    queued requests up to N seconds to finish (and connected clients to
    collect them — ``ptms_active_conns`` is the signal) before tearing
    the server down; the default ``drain_s=0`` stops immediately
    (in-process tests)."""

    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 0):
        self.engine = engine
        self.server = MasterServer(host, port)
        for op, fn in (("srv_submit", self._srv_submit),
                       ("srv_poll", self._srv_poll),
                       ("srv_cancel", self._srv_cancel),
                       ("srv_stats", self._srv_stats),
                       ("srv_requests", self._srv_requests),
                       ("srv_ship_pages", self._srv_ship_pages),
                       ("srv_adopt_pages", self._srv_adopt_pages)):
            self.server.register_op(op, self._stamped(fn))
        self._draining = threading.Event()
        # submit idempotency: srv_submit rides the transport's at-least-
        # once retry, so a lost REPLY must not duplicate the admission —
        # replays of a client's submit_key return the original rid
        self._submit_lock = threading.Lock()
        self._submit_seen: "OrderedDict[str, dict]" = OrderedDict()
        # in-flight shipment reassembly (disaggregation receive side)
        self._ship_lock = threading.Lock()
        self._ships: "OrderedDict[str, _ship.ChunkAssembler]" = OrderedDict()

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def start(self) -> "ServingDaemon":
        self.engine.start()
        self.server.start()
        return self

    def stop(self, drain_s: float = 0.0) -> None:
        self._draining.set()     # refuse new submissions from here on
        if self._keeper is not None:
            # graceful-drain-before-evict: a ROUTED daemon
            # leaves membership FIRST, so the router re-routes in-flight
            # streams and stops placing on us while we drain what's
            # already here — the second _leave_router below is a no-op
            self._leave_router()
        if drain_s > 0:
            # drain: let the scheduler finish live + queued work, then let
            # clients poll the finished results home, all inside one
            # deadline — only then sever connections. The second signal is
            # UNDELIVERED RESULTS, not raw connection count: an idle-but-
            # connected client must not make every shutdown burn the full
            # window (active_connections stays a telemetry signal)
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline:
                st = self.engine.stats()
                if st["slots_live"] == 0 and st["queue_depth"] == 0:
                    break
                time.sleep(0.05)
            while time.monotonic() < deadline \
                    and self.engine.pending_results() > 0:
                # early-out only on an AUTHORITATIVE zero: a stale .so
                # without ptms_active_conns also reads 0, and skipping the
                # collection wait there would sever mid-stream clients
                if self.server.conn_count_supported \
                        and self.server.active_connections() == 0:
                    break
                time.sleep(0.05)
        self._leave_router()
        self.server.stop()
        self.engine.stop()

    # -- op handlers (RPC fallback threads) --------------------------------
    def _srv_submit(self, req):
        key = req.get("submit_key")
        if key is None:
            if self._draining.is_set():
                return self._refuse_draining()
            return self._do_submit(req)
        # check + admit + record under ONE lock: a transport-retry replay
        # racing the slow original would otherwise find the cache empty
        # and double-admit. engine.submit is host-side bookkeeping (no
        # device work), so serializing submits here is cheap.
        with self._submit_lock:
            # replay lookup BEFORE the drain gate: a retry of an ALREADY-
            # admitted submit (lost reply) must learn its rid even during
            # shutdown — its result is exactly what the drain window is
            # waiting for the client to collect
            seen = self._submit_seen.get(str(key))
            if seen is not None:
                # replay-hardening (shared with the router): a forwarded
                # resubmission may not inflate its cached-prefix claim
                # past what the recorded original declared — that would
                # poison the radix index with request-unique tokens
                err = prefix_resubmission_error(req.get("prefix_len"),
                                                seen.get("_prefix_len"))
                if err is not None:
                    return {"ok": False, "error": err,
                            "code": "invalid_argument"}
                return {k: v for k, v in seen.items()
                        if not k.startswith("_")}   # replay: same rid
            if self._draining.is_set():
                return self._refuse_draining()
            resp = self._do_submit(req)
            if resp.get("ok"):
                # capacity refusals are NOT remembered: the retry that
                # matters there is the deliberate backoff one (must re-ask)
                cached = dict(resp)
                pfx = req.get("prefix_len")
                cached["_prefix_len"] = None if pfx is None else int(pfx)
                self._submit_seen[str(key)] = cached
                while len(self._submit_seen) > 4096:
                    self._submit_seen.popitem(last=False)
            return resp

    def _refuse_draining(self):
        # shutdown gate: new work is refused structured (clients back
        # off / fail over) so the drain window can actually drain
        return {"ok": False, "error": "overloaded: daemon is draining "
                "for shutdown", "code": "overloaded",
                "retry_after_s": 2.0}

    def _do_submit(self, req):
        try:
            prompt = np.asarray(req.get("prompt", ()), np.int32)
            max_new = int(req.get("max_new", 0))
            eos = req.get("eos_id")
            timeout = req.get("timeout_s")
            prefix = req.get("prefix_len")
            rid = self.engine.submit(
                prompt, max_new, eos_id=None if eos is None else int(eos),
                timeout_s=None if timeout is None else float(timeout),
                tenant=str(req.get("tenant", "default")),
                slo=str(req.get("slo", "interactive")),
                prefix_len=None if prefix is None else int(prefix))
        except Overloaded as e:
            return {"ok": False, "error": f"overloaded: {e}",
                    "code": "overloaded", "retry_after_s": e.retry_after_s}
        except (ValueError, TypeError, RuntimeError) as e:
            code = ("unavailable" if isinstance(e, RuntimeError)
                    else "invalid_argument")
            return {"ok": False, "error": str(e), "code": code}
        return {"ok": True, "rid": rid}

    def _srv_poll(self, req):
        try:
            rid = int(req["rid"])
            cursor = int(req.get("cursor", 0))
        except (KeyError, TypeError, ValueError):
            return {"ok": False, "error": "srv_poll needs an integer rid "
                    "(+ optional integer cursor)",
                    "code": "invalid_argument"}
        try:
            tokens, done, reason = self.engine.poll(rid, cursor)
        except KeyError:
            return {"ok": False, "error": f"unknown rid {rid}",
                    "code": "not_found"}
        return {"ok": True, "tokens": [int(t) for t in tokens],
                "done": bool(done), "reason": reason}

    def _srv_cancel(self, req):
        try:
            rid = int(req["rid"])
        except (KeyError, TypeError, ValueError):
            return {"ok": False, "error": "srv_cancel needs an integer rid",
                    "code": "invalid_argument"}
        return {"ok": True, "cancelled": self.engine.cancel(rid)}

    def _srv_stats(self, req):
        stats = self.engine.stats()
        stats["rpc_conns"] = self.server.active_connections()
        stats["role"] = "decode"
        return {"ok": True, **stats}

    def _srv_requests(self, req):
        # recent request timelines: none without the obs plane's request
        # ledger (ROADMAP A.8), as JAX's daemon answers with it off
        return {"ok": True, "requests": []}

    # -- disaggregation receive side (KV-page adoption) --------------------
    def _srv_ship_pages(self, req):
        try:
            xid = str(req["xid"])
            seq, total = int(req["seq"]), int(req["total"])
        except (KeyError, TypeError, ValueError):
            return {"ok": False, "code": "invalid_argument",
                    "error": "srv_ship_pages needs xid, seq, total, "
                    "data, crc"}
        try:
            with self._ship_lock:
                asm = self._ships.get(xid)
                if asm is None:
                    asm = _ship.ChunkAssembler(total)
                    self._ships[xid] = asm
                    while len(self._ships) > _SHIP_CAP:
                        # oldest half-shipment pays for the new one — its
                        # sender died mid-ship or will see data_loss on
                        # adopt and re-ship
                        self._ships.popitem(last=False)
            asm.add(seq, req.get("data", ""), req.get("crc", -1))
        except _ship.ShipError as e:
            # a damaged chunk poisons the whole shipment: drop the
            # reassembly so a retry starts clean instead of mixing eras
            with self._ship_lock:
                self._ships.pop(xid, None)
            return {"ok": False, "code": "data_loss", "error": str(e)}
        return {"ok": True}

    def _srv_adopt_pages(self, req):
        faults.fire("srv.adopt")   # chaos: the decode hop dying mid-adopt
        key = req.get("submit_key")
        xid = str(req.get("xid", ""))
        if key is None:
            if self._draining.is_set():
                return self._refuse_draining()
            return self._do_adopt(req, xid)
        with self._submit_lock:
            # same idempotency ladder as srv_submit: a replay (lost reply,
            # OR a second prefill worker re-shipping after the first died
            # between adopt and its own reply) answers the ORIGINAL rid —
            # the decode request is never admitted twice
            seen = self._submit_seen.get(str(key))
            if seen is not None:
                with self._ship_lock:
                    self._ships.pop(xid, None)   # replay: payload unused
                return {k: v for k, v in seen.items()
                        if not k.startswith("_")}
            if self._draining.is_set():
                return self._refuse_draining()
            resp = self._do_adopt(req, xid)
            if resp.get("ok"):
                self._submit_seen[str(key)] = dict(resp, _prefix_len=None)
                while len(self._submit_seen) > 4096:
                    self._submit_seen.popitem(last=False)
            return resp

    def _do_adopt(self, req, xid):
        with self._ship_lock:
            asm = self._ships.get(xid)
        if asm is None:
            return {"ok": False, "code": "data_loss",
                    "error": f"adopt {xid!r}: no shipped chunks held here "
                    "(lost, expired, or a different worker received them)"}
        manifest = req.get("manifest")
        pool = self.engine.pool
        try:
            payload = asm.payload()
            arrays = _ship.unpack(manifest, payload)
        except _ship.ShipError as e:
            with self._ship_lock:
                self._ships.pop(xid, None)
            return {"ok": False, "code": "data_loss", "error": str(e)}
        if int(manifest.get("page_block", -1)) != pool.bs or \
                str(manifest.get("kv_dtype") or "") != (pool.kv_dtype or ""):
            with self._ship_lock:
                self._ships.pop(xid, None)
            return {"ok": False, "code": "invalid_argument",
                    "error": f"shipment geometry (page_block="
                    f"{manifest.get('page_block')}, kv_dtype="
                    f"{manifest.get('kv_dtype') or None!r}) disagrees with "
                    f"this pool (page_block={pool.bs}, kv_dtype="
                    f"{pool.kv_dtype!r}) — prefill and decode pools must "
                    "be built alike"}
        eos = req.get("eos_id")
        timeout = req.get("timeout_s")
        try:
            rid = self.engine.submit_prefilled(
                int(manifest["plen"]), int(manifest["first"]), arrays,
                max_new=int(req.get("max_new", 0)),
                eos_id=None if eos is None else int(eos),
                timeout_s=None if timeout is None else float(timeout),
                tenant=str(req.get("tenant", "default")),
                slo=str(req.get("slo", "interactive")))
        except Overloaded as e:
            # keep the reassembled chunks: the sender's backoff retry
            # re-adopts without re-shipping the payload
            return {"ok": False, "error": f"overloaded: {e}",
                    "code": "overloaded", "retry_after_s": e.retry_after_s}
        except (ValueError, TypeError, RuntimeError) as e:
            with self._ship_lock:
                self._ships.pop(xid, None)
            code = ("unavailable" if isinstance(e, RuntimeError)
                    else "invalid_argument")
            return {"ok": False, "error": str(e), "code": code}
        with self._ship_lock:
            self._ships.pop(xid, None)
        return {"ok": True, "rid": rid, "plen": int(manifest["plen"])}


class PrefillDaemon(_RouterMember):
    """A PREFILL-ONLY serving worker: owns a :class:`~.paged.PagePool`
    (and through it the prefix radix index — re-routes re-prefill here
    near-free) but runs NO decode scheduler. ``srv_prefill`` admits the
    prompt into a scratch slot, exports the slot's KV pages
    (serving/ship.py), frees the slot, ships the chunks to the named
    decode worker and adopts them there — the reply carries the DECODE
    worker's rid, which the caller polls on the decode worker directly.

    Admission is synchronous inside the RPC handler under one pool lock:
    a prefill worker's unit of work IS one admission, so there is nothing
    to schedule between. Idempotent by ``submit_key`` exactly like
    srv_submit, and the same key rides into ``srv_adopt_pages`` — if this
    process dies after the decode worker adopted but before our reply, a
    router retry through ANY prefill worker lands on the decode worker's
    replay cache and learns the original rid (no double admission)."""

    def __init__(self, pool, host: str = "127.0.0.1", port: int = 0):
        self.pool = pool
        self.server = MasterServer(host, port)
        for op, fn in (("srv_prefill", self._srv_prefill),
                       ("srv_stats", self._srv_stats),
                       ("srv_requests", self._srv_requests)):
            self.server.register_op(op, self._stamped(fn))
        self._pool_lock = threading.Lock()
        self._busy: set = set()
        self._submit_lock = threading.Lock()
        self._submit_seen: "OrderedDict[str, dict]" = OrderedDict()
        self._clients_lock = threading.Lock()
        self._clients: Dict[Tuple[str, int], "ServingClient"] = {}

    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def start(self) -> "PrefillDaemon":
        self.server.start()
        return self

    def stop(self) -> None:
        self._leave_router()
        self.server.stop()
        with self._clients_lock:
            for c in self._clients.values():
                c.close()
            self._clients.clear()

    def _decode_client(self, host: str, port: int) -> "ServingClient":
        with self._clients_lock:
            c = self._clients.get((host, port))
            if c is None:
                c = ServingClient(host, port)
                self._clients[(host, port)] = c
            return c

    # -- op handlers -------------------------------------------------------
    def _srv_stats(self, req):
        with self._pool_lock:
            live = len(self._busy)
        return {"ok": True, "role": "prefill", "slots_live": live,
                "queue_depth": 0,
                "rpc_conns": self.server.active_connections()}

    def _srv_requests(self, req):
        return {"ok": True, "requests": []}

    def _srv_prefill(self, req):
        key = req.get("submit_key")
        if key is None:
            return self._do_prefill(req, None)
        with self._submit_lock:
            seen = self._submit_seen.get(str(key))
            if seen is not None:
                err = prefix_resubmission_error(req.get("prefix_len"),
                                                seen.get("_prefix_len"))
                if err is not None:
                    return {"ok": False, "error": err,
                            "code": "invalid_argument"}
                return {k: v for k, v in seen.items()
                        if not k.startswith("_")}
            resp = self._do_prefill(req, str(key))
            if resp.get("ok"):
                cached = dict(resp)
                pfx = req.get("prefix_len")
                cached["_prefix_len"] = None if pfx is None else int(pfx)
                self._submit_seen[str(key)] = cached
                while len(self._submit_seen) > 4096:
                    self._submit_seen.popitem(last=False)
            return resp

    def _do_prefill(self, req, key: Optional[str]):
        try:
            prompt = np.asarray(req.get("prompt", ()), np.int32).reshape(-1)
            max_new = int(req.get("max_new", 0))
            decode_host = str(req["decode_host"])
            decode_port = int(req["decode_port"])
        except (KeyError, TypeError, ValueError):
            return {"ok": False, "code": "invalid_argument",
                    "error": "srv_prefill needs prompt, max_new, "
                    "decode_host, decode_port"}
        eos = req.get("eos_id")
        prefix = req.get("prefix_len")
        r = Request(-1, prompt, max_new,
                    None if eos is None else int(eos),
                    str(req.get("tenant", "default")),
                    str(req.get("slo", "interactive")),
                    None if prefix is None else int(prefix))
        try:
            with self._pool_lock:
                self.pool.validate(r)
                left = self.pool.effective_budget(r.prompt.size, max_new)
                plan = self.pool.plan_admission(r.prompt, left,
                                                tenant=r.tenant,
                                                prefix_len=r.prefix_len)
                free = [s for s in range(self.pool.n_slots)
                        if s not in self._busy]
                if not free or not self.pool.evict_for(plan.need_pages, 0,
                                                       protect=[plan]):
                    return {"ok": False, "code": "overloaded",
                            "error": "overloaded: prefill pool cannot "
                            "hold the prompt right now",
                            "retry_after_s": 0.2}
                slot = free[0]
                self._busy.add(slot)
                try:
                    first = int(self.pool.admit([(slot, plan)])[slot])
                    manifest, payload = self.pool.export_slot(slot, first)
                finally:
                    # the slot was only scratch space for the prefill —
                    # its pages return (and the prefix index keeps what
                    # the declared shared span stored)
                    self.pool.free_slot(slot)
                    self._busy.discard(slot)
        except (ValueError, TypeError) as e:
            return {"ok": False, "error": str(e),
                    "code": "invalid_argument"}
        # ship + adopt OUTSIDE the pool lock: the wire hop must not
        # serialize other admissions
        client = self._decode_client(decode_host, decode_port)
        xid = uuid.uuid4().hex
        adopt_req = {"op": "srv_adopt_pages", "xid": xid,
                     "manifest": manifest, "max_new": max_new,
                     "tenant": r.tenant, "slo": r.slo}
        if r.eos_id is not None:
            adopt_req["eos_id"] = int(r.eos_id)
        if req.get("timeout_s") is not None:
            adopt_req["timeout_s"] = float(req["timeout_s"])
        if key is not None:
            adopt_req["submit_key"] = key
        try:
            for _seq, _total, frame in _ship.iter_chunks(payload):
                rc = client._call(dict(frame, op="srv_ship_pages", xid=xid))
                if not rc.get("ok"):
                    return {"ok": False,
                            "code": rc.get("code", "data_loss"),
                            "error": f"decode worker refused chunk "
                            f"{_seq}/{_total}: {rc.get('error')}"}
            ra = client._call(adopt_req)
        except ConnectionError as e:
            return {"ok": False, "code": "unavailable",
                    "error": f"decode worker {decode_host}:{decode_port} "
                    f"unreachable mid-ship: {e}"}
        if not ra.get("ok"):
            out = {"ok": False, "code": ra.get("code", "unavailable"),
                   "error": str(ra.get("error", "adopt failed"))}
            if ra.get("retry_after_s") is not None:
                out["retry_after_s"] = ra["retry_after_s"]
            return out
        return {"ok": True, "rid": int(ra["rid"]),
                "plen": int(prompt.size), "hit": bool(plan.offset > 0)}


class ServingClient(_RpcClient):
    """Client for the serving daemon. Reuses the runtime's reconnecting
    frame plumbing (per-call deadline, endpoint failover, RetryPolicy on
    transport errors); ADMISSION backpressure is handled one level up —
    ``submit`` surfaces the structured ``overloaded`` reply as
    :class:`Overloaded`, and :meth:`generate`/:meth:`stream` retry it
    through a client-side RetryPolicy honoring the server's
    ``retry_after_s`` hint."""

    _rpc_name = "serving rpc"

    # op names as class attrs so RouterClient (serving/router.py) reuses
    # every method over its route_* surface by overriding four strings
    _op_submit = "srv_submit"
    _op_poll = "srv_poll"
    _op_cancel = "srv_cancel"
    _op_stats = "srv_stats"

    def _conn_err(self, msg: str, attempts: int = 1) -> ConnectionError:
        """Build the connection-class error with the diagnosis an operator
        needs: how hard we tried and how current our membership view was
        when the server went away (``last_epoch`` is stamped from every
        srv_*/route_* reply of a router-joined daemon)."""
        seen = ("unknown" if self.last_epoch is None
                else str(self.last_epoch))
        return ConnectionError(
            f"{msg} (after {int(attempts)} attempt(s); last seen "
            f"membership epoch {seen})")

    def submit(self, prompt, max_new: int, *, eos_id: Optional[int] = None,
               timeout_s: Optional[float] = None, tenant: str = "default",
               slo: str = "interactive",
               prefix_len: Optional[int] = None,
               submit_key: Optional[str] = None) -> int:
        # submit_key makes the op idempotent across the transport's
        # at-least-once retry: a lost reply re-sends the SAME key and the
        # daemon answers with the original rid instead of admitting twice
        # (callers pass their own key to make RESUBMISSION idempotent too
        # — the router's re-route ladder). tenant/slo ride the wire into
        # the weighted-fair scheduler and the per-tenant SLO labels;
        # prefix_len declares the shared-prefix span worth caching
        # (docs/design/serving.md)
        req = {"op": self._op_submit,
               "prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
               "max_new": int(max_new),
               "submit_key": submit_key or uuid.uuid4().hex}
        if eos_id is not None:
            req["eos_id"] = int(eos_id)
        if timeout_s is not None:
            req["timeout_s"] = float(timeout_s)
        if tenant != "default":
            req["tenant"] = str(tenant)
        if slo != "interactive":
            req["slo"] = str(slo)
        if prefix_len is not None:
            req["prefix_len"] = int(prefix_len)
        r = self._call(req)
        if not r.get("ok"):
            if r.get("code") == "overloaded":
                raise Overloaded(str(r.get("error")),
                                 float(r.get("retry_after_s", 0.2)))
            if r.get("code") == "unavailable":
                # server fault (engine failed/stopped), not a malformed
                # request — surface as the connection-class error callers
                # failover on, never as ValueError
                raise self._conn_err(str(r.get("error", "unavailable")))
            raise ValueError(str(r.get("error", "submit failed")))
        return int(r["rid"])

    def poll(self, rid: int, cursor: int = 0) -> Tuple[List[int], bool, str]:
        r = self._call({"op": self._op_poll, "rid": int(rid),
                        "cursor": int(cursor)})
        if not r.get("ok"):
            raise KeyError(str(r.get("error", "poll failed")))
        return list(r.get("tokens", ())), bool(r.get("done")), \
            str(r.get("reason", ""))

    def cancel(self, rid: int) -> bool:
        r = self._call({"op": self._op_cancel, "rid": int(rid)})
        return bool(r.get("cancelled"))

    def serving_stats(self) -> dict:
        r = self._call({"op": self._op_stats})
        if not r.get("ok"):
            raise self._conn_err(
                str(r.get("error", f"{self._op_stats} failed")))
        return {k: v for k, v in r.items() if k != "ok"}

    def serving_requests(self, n: int = 128) -> list:
        """The worker's recent request timelines (srv_requests) — what
        the router's scrape pump aggregates for stitching."""
        r = self._call({"op": "srv_requests", "n": int(n)})
        if not r.get("ok"):
            raise self._conn_err(
                str(r.get("error", "srv_requests failed")))
        rq = r.get("requests")
        return rq if isinstance(rq, list) else []

    def submit_with_backoff(self, prompt, max_new: int, *,
                            eos_id: Optional[int] = None,
                            timeout_s: Optional[float] = None,
                            tenant: str = "default",
                            slo: str = "interactive",
                            prefix_len: Optional[int] = None,
                            policy: Optional[RetryPolicy] = None,
                            submit_key: Optional[str] = None) -> int:
        """Submit, retrying structured ``overloaded`` refusals — the client
        half of the backpressure contract. Each retry sleeps the LONGER of
        the policy's capped-exponential delay and the server's
        ``retry_after_s`` hint (the server knows its drain rate better
        than our schedule does); the policy supplies the attempt budget
        and the injectable sleep/clock."""
        policy = policy or RetryPolicy(
            max_attempts=16, base_delay=0.1, multiplier=1.5, max_delay=2.0,
            jitter=0.25, retryable=lambda e: isinstance(e, Overloaded))
        attempt = 0
        while True:
            try:
                return self.submit(prompt, max_new, eos_id=eos_id,
                                   timeout_s=timeout_s, tenant=tenant,
                                   slo=slo, prefix_len=prefix_len,
                                   submit_key=submit_key)
            except Overloaded as e:
                attempt += 1
                if policy.max_attempts is not None \
                        and attempt >= policy.max_attempts:
                    raise Overloaded(
                        f"server still overloaded after {attempt} submit "
                        f"attempt(s): {e}") from e
                policy.sleep(max(policy.delay_for(attempt - 1),
                                 e.retry_after_s))

    def stream(self, prompt, max_new: int, *, eos_id: Optional[int] = None,
               timeout_s: Optional[float] = None, tenant: str = "default",
               slo: str = "interactive", prefix_len: Optional[int] = None,
               poll_interval_s: float = 0.02,
               policy: Optional[RetryPolicy] = None):
        """Generator: submit (with backpressure backoff) then yield tokens
        as poll exposes them, until the request finishes. Tokens arrive in
        segment-sized bursts — the streaming granularity the decode loop
        actually has."""
        rid = self.submit_with_backoff(prompt, max_new, eos_id=eos_id,
                                       timeout_s=timeout_s, tenant=tenant,
                                       slo=slo, prefix_len=prefix_len,
                                       policy=policy)
        cursor = 0
        finished = False
        try:
            while True:
                tokens, done, reason = self.poll(rid, cursor)
                for t in tokens:
                    yield t
                cursor += len(tokens)
                if done:
                    finished = True
                    # length/eos are the normal completions; an interrupted
                    # request must surface, not read as a short generation
                    if reason == "timeout":
                        raise TimeoutError(
                            f"request {rid} timed out server-side")
                    if reason in ("cancelled", "error"):
                        raise RuntimeError(
                            f"request {rid} ended server-side with reason="
                            f"{reason} after {cursor} token(s)")
                    return
                time.sleep(poll_interval_s)
        finally:
            # an abandoned stream (break / GeneratorExit / error mid-yield)
            # must not keep decoding server-side: the slot and its reserved
            # pages would stay pinned for the full budget or timeout
            if not finished:
                try:
                    self.cancel(rid)
                except Exception:
                    pass    # best effort; the server timeout still bounds it

    def generate(self, prompt, max_new: int, *,
                 eos_id: Optional[int] = None,
                 timeout_s: Optional[float] = None,
                 tenant: str = "default", slo: str = "interactive",
                 prefix_len: Optional[int] = None,
                 poll_interval_s: float = 0.02) -> np.ndarray:
        """Blocking convenience: the full generated id array."""
        return np.asarray(list(self.stream(
            prompt, max_new, eos_id=eos_id, timeout_s=timeout_s,
            tenant=tenant, slo=slo, prefix_len=prefix_len,
            poll_interval_s=poll_interval_s)), np.int32)
