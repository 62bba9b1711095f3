"""Network service + client for the data master — a copy of
``paddle_tpu/runtime/master_service.py`` over the port's own build of the
host library (``runtime/lib.py``).

The frames are JAX's byte for byte (a 4-byte little-endian length, then
JSON), so a client of either package talks to a server of the other.
Left out until their modules are ported (ROADMAP A.8): master election
and fenced snapshots (JAX's ``lease=``, ``snapshot_path=`` and
``snapshot_store=``, over ``runtime/lease.py`` and ``runtime/coord.py``).
The obs calls are JAX's: the ``master.*`` and ``rpc.*`` counters, the
``master.dispatch`` span parented on the client's ``rpc.call`` span
through the wire trace context, and the retry observer. The server's
``ClusterAggregator`` is the port's (``obs/aggregate.py``).

Like JAX's, it re-provides the reference's distributed data-dispatch
plane:
* Go master RPC service (go/master/service.go GetTask/TaskFinished/TaskFailed
  RPCs) -> :class:`MasterServer`. The accept/dispatch loop itself is C++
  (native/master_server.cc serving the native TaskMaster,
  native/task_master.cc) over a length-prefixed JSON protocol — the framing
  discipline AND the native socket plane of ProtoServer
  (pserver/ProtoServer.h:36: length-framed messages over raw sockets).
  Python keeps the control plane.
* auto-reconnecting client (go/connection/conn.go) -> :class:`MasterClient`.
* periodic timeout tick + snapshot (service.go:198-200, :166-227) -> the
  server's housekeeping thread.

Trainers are stateless consumers: a consumer that dies mid-task simply lets
the lease expire; the task re-dispatches to a healthy one (elastic training,
SURVEY.md §5 'Failure detection').
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

from .. import faults, obs
from ..utils.retry import RetryBudgetExceeded, RetryPolicy
from .master import TaskMaster

_HDR = struct.Struct("<I")
# same guard as the C++ plane (master_server.cc kMaxFrame): a hostile
# 4-byte header must not make the daemon attempt a multi-GiB allocation
_MAX_FRAME = 64 << 20

#: structured error codes of the membership/epoch fencing contract
#: (runtime/membership.py + trainer/elastic.py). Defined ONCE here — the
#: client's fail-fast behavior keys on these exact strings, so emitters
#: import the constants instead of respelling them.
CODE_UNKNOWN_MEMBER = "unknown_member"
CODE_STALE_MEMBER = "stale_member"
CODE_STALE_EPOCH = "stale_epoch"
CODE_STALE_STEP = "stale_step"
#: AUTHORITATIVE refusals — the server is healthy and said no — so the
#: client fails fast with a typed error instead of burning its reconnect
#: budget the way it does (correctly) against a connection-refused master
#: that is restarting from snapshot.
FENCE_CODES = frozenset({CODE_UNKNOWN_MEMBER, CODE_STALE_MEMBER,
                         CODE_STALE_EPOCH, CODE_STALE_STEP})


class StaleMemberError(RuntimeError):
    """A structured membership/epoch fencing refusal (``code`` in
    :data:`FENCE_CODES`). Deliberately NOT a ConnectionError: the shared
    RetryPolicy's retryable set never re-sends a fenced request, and the
    caller gets the refusal on the FIRST attempt with the server's current
    epoch attached — resync-and-retry is the caller's decision."""

    def __init__(self, msg: str, *, code: str, epoch=None, attempts: int = 1):
        super().__init__(msg)
        self.code = code
        self.epoch = epoch
        self.attempts = attempts


def _send_msg(sock: socket.socket, obj, *, chaos: bool = False) -> None:
    payload = json.dumps(obj).encode()
    if len(payload) > _MAX_FRAME:
        raise ValueError(f"frame too large ({len(payload)} bytes)")
    # chaos plane (client edges only — ``chaos=True``; a server handler
    # sharing this framing must not double-count the site): rpc.send can
    # raise (dropped request), delay, or mangle the frame. The header is
    # packed BEFORE the hook so a truncate fault produces a genuinely torn
    # frame (header promises more bytes than arrive — the receiver blocks,
    # the sender's call timeout fires), and a corrupt fault turns into a
    # parse failure at the receiver
    hdr = _HDR.pack(len(payload))
    if chaos:
        payload = faults.filter_bytes("rpc.send", payload)
    sock.sendall(hdr + payload)


def _recv_msg(sock: socket.socket, *, chaos: bool = False):
    if chaos:
        faults.fire("rpc.recv")
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n > _MAX_FRAME:
        return None                     # drop the connection, not the heap
    body = _recv_exact(sock, n)
    if body is None:
        return None
    try:
        return json.loads(body.decode())
    except (UnicodeDecodeError, ValueError):
        # a frame that fails to parse means the stream is desynchronized or
        # corrupt: sever the connection (the retry layer reconnects) rather
        # than propagate garbage into the caller
        raise ConnectionError("corrupt frame from peer (json parse failed)")


def _recv_exact(sock, n) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class MasterServer:
    """Serve a TaskMaster over TCP with timeout housekeeping.

    The accept/dispatch loop is native (``native/master_server.cc``,
    compiled into the port's host library): it serves the task-queue ops
    itself and hands every other op to :meth:`_dispatch` through its
    unknown-op fallback, where the ops registered with
    :meth:`register_op` (the serving daemon's ``srv_*``, membership's
    ``mbr_*``) are served.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 timeout_s: float = 60.0, failure_max: int = 3,
                 tick_interval: float = 1.0):
        self.master = TaskMaster(timeout_s=timeout_s, failure_max=failure_max)
        self._tick_interval = tick_interval
        # no lease: this server is never fenced out (JAX's fencing token
        # stays None, so its fenced checks always pass)
        self.fence_token = None
        self._host, self._port = host, port
        self._srv_h = None        # native server handle (master_server.cc)
        self._lib = None          # set (before handle publication) in start()
        # guards every read/swap of _srv_h: the native handle must never be
        # ptms_stop'd twice
        self._srv_lock = threading.Lock()
        self.address: Tuple[str, int] = (host, port)
        self._threads: List[threading.Thread] = []
        self._stop = threading.Event()
        # cluster telemetry home: workers obs_push their registry
        # snapshots here; obs_stats serves the merged, worker-tagged view
        from ..obs.aggregate import ClusterAggregator
        self.aggregator = ClusterAggregator()
        self._fallback_cb = None  # keepalive for the ctypes callback
        # control-plane extension ops (the serving daemon's srv_submit /
        # srv_poll / srv_cancel ride here): served through the native
        # unknown-op fallback. Registered BEFORE start() so no request can
        # observe a half-wired op table.
        self._ext_ops = {}
        self._known_ops = set(self._KNOWN_OPS)

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        import ctypes

        from .lib import PTMS_FALLBACK_FN, load_library
        lib = load_library()
        out_port = ctypes.c_int(0)
        h = lib.ptms_start(self.master._h, self._host.encode(), self._port,
                           ctypes.byref(out_port))
        if not h:
            raise OSError(f"ptms_start failed to bind "
                          f"{self._host}:{self._port}")
        self._lib = lib
        with self._srv_lock:
            if self._stop.is_set():
                lib.ptms_stop(h)
                h = None
            else:
                self._srv_h = h
        if h is None:
            raise RuntimeError("master stopped during start-up (stop() "
                               "called before the server handle was "
                               "published)")
        self.address = (self._host, out_port.value)

        # ops the native dispatch does not know fall back into Python's
        # _dispatch: the C++ handler hands us the raw frame, we reply via
        # ptms_reply. The CFUNCTYPE object must outlive the server.
        def _fallback(buf, n, reply):
            try:
                req = json.loads(ctypes.string_at(buf, n).decode())
                resp = self._dispatch(req) if isinstance(req, dict) else \
                    {"ok": False, "error": "bad request"}
            except Exception as e:   # never let an exception cross into C++
                resp = {"ok": False,
                        "error": f"{type(e).__name__}: {e}"}
            try:
                data = json.dumps(resp).encode()
            except (TypeError, ValueError):
                data = b'{"ok": false, "error": "unserializable response"}'
            lib.ptms_reply(reply, data, len(data))

        self._fallback_cb = PTMS_FALLBACK_FN(_fallback)
        with self._srv_lock:
            if self._srv_h is not None:
                lib.ptms_set_fallback(self._srv_h, self._fallback_cb)
                lib.ptms_set_fenced(self._srv_h, 0)
        hk = threading.Thread(target=self._housekeeping, daemon=True)
        hk.start()
        self._threads = [hk]
        return self

    def stop(self):
        self._stop.set()
        # native stop severs the listener AND every live connection. The
        # handle swap happens under the lock, ptms_stop outside it: it
        # drains the handler threads, and a handler that takes _srv_lock
        # (active_connections via srv_stats) would otherwise deadlock the
        # shutdown
        with self._srv_lock:
            h, self._srv_h = self._srv_h, None
        if h:
            self._lib.ptms_stop(h)

    def _housekeeping(self):
        while not self._stop.wait(self._tick_interval):
            self.master.tick()

    def _fenced_out(self) -> bool:
        """Deposed-master check: never, without a lease (membership's op
        handlers ask it as JAX's do)."""
        return False

    _MUTATING_OPS = frozenset(
        {"set_dataset", "get_task", "task_finished", "task_failed",
         "new_pass"})
    _KNOWN_OPS = _MUTATING_OPS | frozenset({"stats", "obs_push",
                                            "obs_stats", "obs_health"})

    # -- dispatch ----------------------------------------------------------
    # The network path dispatches in C++ (master_server.cc) for the
    # task-queue ops; unknown ops fall back here via ptms_set_fallback.
    # This Python twin is also the in-process entry tests drive directly.
    def register_op(self, name: str, handler) -> None:
        """Register a control-plane op served via the native fallback path:
        ``handler(req dict) -> resp dict``. Raises if the name would shadow
        a built-in or an earlier registration."""
        if name in self._known_ops or name in self._ext_ops:
            raise ValueError(f"op {name!r} already registered")
        self._ext_ops[name] = handler
        self._known_ops.add(name)

    def active_connections(self) -> int:
        """Live client connections on the native server (0 when stopped) —
        the serving daemon's drain signal."""
        with self._srv_lock:
            if self._srv_h is None or self._lib is None:
                return 0
            return int(self._lib.ptms_active_conns(self._srv_h))

    @property
    def conn_count_supported(self) -> bool:
        """True while the server runs: the port's library always exports
        ``ptms_active_conns`` (it is built from this checkout's sources)."""
        with self._srv_lock:
            return self._srv_h is not None and self._lib is not None

    def _dispatch(self, req):
        op = str(req.get("op"))
        label = op if op in self._known_ops else "unknown"
        obs.count("master.requests_total", type=label)
        # server-side span parented on the client's rpc.call via the wire
        # context — the cross-process edge the merged Chrome trace stitches
        try:
            with obs.server_span("master.dispatch", req.get("trace"), op=op):
                resp = self._dispatch_op(req)
        except Exception:
            # a malformed request (missing field, bad type) is exactly
            # what the error counter exists to surface
            obs.count("master.request_errors_total", type=label)
            raise
        # key on the error field, not ok alone: new_pass answers
        # {"ok": false} with no error when the pass simply isn't finished
        if resp.get("error") is not None:
            obs.count("master.request_errors_total", type=label)
        return resp

    def _dispatch_op(self, req):
        op = req.get("op")
        ext = self._ext_ops.get(op)
        if ext is not None:
            return ext(req)
        if op == "obs_push":
            n = self.aggregator.push(str(req.get("worker", "?")),
                                     req.get("samples"))
            return {"ok": True, "accepted": n}
        if op == "obs_stats":
            return {"ok": True, "workers": self.aggregator.workers(),
                    "samples": self.aggregator.merged_samples()}
        if op == "obs_health":
            # the fleet health plane's read surface: derived per-worker
            # health, live alerts, and the bounded transition log
            # (obs/health.py, obs/alerts.py)
            agg = self.aggregator
            agg.maybe_evaluate()
            return {"ok": True, "health": agg.health_snapshot(),
                    "active": agg.alerts.active(),
                    "events": agg.alerts.recent_events(),
                    "actions": agg.recent_actions(),
                    # raw request-timeline legs + slow exemplars (obs/
                    # requests.py): obs trace / obs serve stitch them
                    "requests": agg.requests.export_legs(),
                    "exemplars": agg.requests.exemplars()}
        if op == "set_dataset":
            self.master.set_dataset(req["payloads"])
            return {"ok": True}
        if op == "get_task":
            t = self.master.get_task()
            if t is None:
                return {"ok": True, "task": None,
                        "pass_finished": self.master.pass_finished()}
            return {"ok": True, "task": {"id": t[0], "payload": t[1]}}
        if op == "task_finished":
            self.master.task_finished(req["task_id"])
            return {"ok": True}
        if op == "task_failed":
            return {"ok": True,
                    "discarded": self.master.task_failed(req["task_id"])}
        if op == "new_pass":
            return {"ok": self.master.new_pass()}
        if op == "stats":
            todo, pending, done, disc, epoch = self.master.stats()
            return {"ok": True, "todo": todo, "pending": pending,
                    "done": done, "discarded": disc, "epoch": epoch}
        return {"ok": False, "error": f"unknown op {op!r}"}


class _RpcClient:
    """Reconnecting JSON-frame RPC plumbing shared by every client in the
    runtime (master + coordinator): one socket under a lock, a per-call
    deadline, the shared :class:`RetryPolicy`, endpoint-failover rotation,
    and drop-the-socket-on-any-error discipline (a stream in an unknown
    state is never reused). Subclasses add their service API on top of
    :meth:`_call` and set ``_rpc_name`` for error messages.
    """

    _rpc_name = "rpc"

    def __init__(self, host=None, port: Optional[int] = None, *,
                 endpoints: Optional[List[Tuple[str, int]]] = None,
                 retries: int = 5, retry_delay: float = 0.2,
                 call_timeout: float = 10.0,
                 retry_policy: Optional[RetryPolicy] = None):
        if endpoints is None:
            if host is None or port is None:
                raise ValueError("pass (host, port) or endpoints=[...]")
            endpoints = [(host, port)]
        self.endpoints = list(endpoints)
        self._ep_idx = 0
        #: per-call socket deadline: a wedged master surfaces as a timeout
        #: (retried against the next endpoint), never an indefinite hang
        self.call_timeout = call_timeout
        # capped exponential backoff with jitter
        self.policy = retry_policy or RetryPolicy(
            max_attempts=retries, base_delay=retry_delay, multiplier=2.0,
            max_delay=2.0, jitter=0.25)
        if retry_policy is None:
            # retry telemetry (rpc.retries_total / giveups / backoff) — a
            # no-op callable until an ObsSession is installed; a caller's
            # policy is never mutated
            self.policy.observer = obs.retry_observer("rpc")
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        #: last membership epoch seen in ANY reply (None until one carries
        #: it) — stamped into the final reconnect error so an operator
        #: reading "unreachable after N attempts" also sees how current
        #: this client's view was when the master went away
        self.last_epoch = None

    @property
    def addr(self) -> Tuple[str, int]:
        return self.endpoints[self._ep_idx]

    def _connect(self):
        last = None
        for _ in range(len(self.endpoints)):
            try:
                s = socket.create_connection(self.addr,
                                             timeout=self.call_timeout)
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)  # LightNetwork
                self._sock = s
                return
            except OSError as e:
                last = e
                self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)
        raise ConnectionError(
            f"no {self._rpc_name} endpoint reachable: {last}")

    def _drop_sock(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _call_once(self, req):
        try:
            if self._sock is None:
                self._connect()
            self._sock.settimeout(self.call_timeout)
            _send_msg(self._sock, req, chaos=True)
            resp = _recv_msg(self._sock, chaos=True)
        except (OSError, ConnectionError):
            # the stream is in an unknown state: never reuse the socket
            self._drop_sock()
            raise
        if resp is None:
            self._drop_sock()
            raise ConnectionError("server closed connection")
        if isinstance(resp, dict) and resp.get("epoch") is not None and \
                str(req.get("op", "")).startswith(
                    ("mbr_", "ela_", "srv_", "route_")):
            # only membership-plane replies stamp the epoch (serving and
            # router replies carry the membership epoch of the cluster
            # they are joined to): the built-in "stats" op also answers
            # an "epoch" field, but that one is the TaskMaster's
            # pass/dataset generation — reporting it as a membership
            # epoch would mislead whoever correlates the final reconnect
            # error against cluster.epoch
            self.last_epoch = resp["epoch"]
        if not resp.get("ok"):
            if resp.get("code") in FENCE_CODES:
                # authoritative membership/epoch refusal: fail FAST (no
                # reconnect budget spent — retrying a fence cannot help)
                raise StaleMemberError(
                    f"{self._rpc_name} fenced: {resp.get('error')}",
                    code=resp["code"], epoch=resp.get("epoch"))
            if str(resp.get("error", "")).startswith("fenced"):
                # deposed server: rotate to the standby and retry
                self._ep_idx = (self._ep_idx + 1) % len(self.endpoints)
                self._drop_sock()
                raise ConnectionError(resp["error"])
        return resp

    def _call(self, req):
        # span + latency histogram cover the whole call incl. retries —
        # what the caller experienced, not one socket round trip
        with self._lock, \
                obs.span("rpc.call", metric="rpc.call_seconds",
                         metric_labels={"rpc": self._rpc_name},
                         rpc=self._rpc_name, op=req.get("op")) as sp:
            obs.count("rpc.calls_total", rpc=self._rpc_name,
                      op=str(req.get("op")))
            # distributed tracing: stamp this span's identity into the
            # envelope so the server parents its dispatch span on it. None
            # when no session is installed — the wire bytes then stay
            # identical to an un-instrumented client's (obs/context.py)
            ctx = obs.wire_context(sp)
            if ctx is not None:
                req = dict(req, trace=ctx)
            try:
                return self.policy.call(
                    self._call_once, req,
                    describe=f"{self._rpc_name} {req.get('op')!r}")
            except RetryBudgetExceeded as e:
                # connection-refused/timeout class: the reconnect budget
                # WAS the right response (a restarting master comes back
                # inside the snapshot/restore window) — report how hard we
                # tried and how current our membership view was
                seen = ("unknown" if self.last_epoch is None
                        else str(self.last_epoch))
                raise ConnectionError(
                    f"{self._rpc_name} server unreachable after "
                    f"{e.attempts} attempt(s) (last seen membership epoch "
                    f"{seen}): {e.last_error}") from e.last_error

    def close(self):
        with self._lock:
            self._drop_sock()


class MasterClient(_RpcClient):
    """Auto-reconnecting master client (go/connection/conn.go semantics).

    Accepts either one address or a failover list of candidate master
    endpoints (active + standbys); reconnection rotates through them, so a
    master failover is transparent to the trainer — the role etcd master
    discovery plays for go/master/client.go.
    """

    _rpc_name = "master rpc"

    def set_dataset(self, payloads: List[str]):
        self._call({"op": "set_dataset", "payloads": payloads})

    def get_task(self) -> Optional[Tuple[int, str]]:
        r = self._call({"op": "get_task"})
        if not r.get("ok") and r.get("error"):
            # a structured server error ("payload too large: ..." when the
            # escaped response would blow the frame limit) must surface as
            # an exception, not read as an innocent empty queue
            raise RuntimeError(f"get_task failed: {r['error']}")
        if r.get("task") is None:
            return None
        return r["task"]["id"], r["task"]["payload"]

    def task_finished(self, task_id: int):
        self._call({"op": "task_finished", "task_id": task_id})

    def task_failed(self, task_id: int) -> bool:
        return bool(self._call({"op": "task_failed",
                                "task_id": task_id}).get("discarded"))

    def new_pass(self) -> bool:
        return bool(self._call({"op": "new_pass"})["ok"])

    def stats(self):
        r = self._call({"op": "stats"})
        return (r["todo"], r["pending"], r["done"], r["discarded"], r["epoch"])

    # -- cluster telemetry (obs plane) -------------------------------------
    def obs_push(self, worker: str, samples) -> int:
        """Push this worker's metric snapshot (``MetricsRegistry.collect()``
        samples) to the master's aggregator; returns the accepted count.
        An ok=false answer (e.g. a server whose dispatch predates obs_push)
        raises, so ObsPusher counts it as a push failure, not a success."""
        from ..obs.aggregate import wire_safe_samples
        r = self._call({"op": "obs_push", "worker": str(worker),
                        "samples": wire_safe_samples(list(samples))})
        if not r.get("ok"):
            raise ConnectionError(
                f"obs_push rejected: {r.get('error', 'unknown error')}")
        return int(r.get("accepted", 0))

    def obs_stats(self):
        """The merged fleet view: ``(workers, samples)`` where every sample
        carries a ``worker=<id>`` label (the merged-registry contract)."""
        r = self._call({"op": "obs_stats"})
        if not r.get("ok"):
            raise ConnectionError(
                f"obs_stats rejected: {r.get('error', 'unknown error')}")
        return list(r.get("workers", ())), list(r.get("samples", ()))

    def obs_health(self):
        """The fleet health view: ``{"health": per-worker
        derived health, "active": firing alerts, "events": recent alert
        transitions, "actions": committed autoscale actions, "requests":
        raw request-timeline legs, "exemplars": the slowest-K stitched
        timelines}``."""
        r = self._call({"op": "obs_health"})
        if not r.get("ok"):
            raise ConnectionError(
                f"obs_health rejected: {r.get('error', 'unknown error')}")
        return {"health": r.get("health") or {},
                "active": list(r.get("active", ())),
                "events": list(r.get("events", ())),
                "actions": list(r.get("actions", ())),
                "requests": list(r.get("requests", ())),
                "exemplars": list(r.get("exemplars", ()))}
