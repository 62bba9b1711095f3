"""Network coordination service — the etcd analog, served over TCP; a copy
of ``paddle_tpu/runtime/coord.py`` (it imports no JAX), wired to the port's
``faults``, ``obs`` and ``runtime.master_service`` (the frames are JAX's,
so a client of either package talks to a server of the other).

The reference coordinates masters/pservers through etcd: TTL leases + locks
for election (go/master/etcd_client.go concurrency.NewSession under a TTL
lease), etcd revisions for fencing, and the master snapshots its task queues
*into* etcd so a successor on a different host recovers state
(go/master/service.go snapshot-to-etcd). :class:`~paddle_tpu_torch.runtime.
lease.FileLease` provides those semantics on shared storage; this module provides
them over the network, so multi-host failover needs no NFS:

* :class:`CoordServer` — one small TCP service (same length-prefixed JSON
  framing as the master RPC) holding, under one lock:
  - TTL leases per name, expiry judged by the SERVER clock (contender clock
    skew cannot extend a lease), fencing tokens minted from a per-name
    monotonic epoch counter;
  - fence-claim records per resource (etcd revision compare-and-claim);
  - a fenced small-blob store — the snapshot's network home. ``blob_put``
    is check-token-and-publish under the server lock, the same atomicity
    FencedFile gets from its flock.
* :class:`NetworkLease` — FileLease's exact interface (try_acquire / renew /
  release / holder / current_token / held_by_me / wait_acquire / ``token``)
  against a CoordServer, so :class:`~paddle_tpu_torch.runtime.lease.LeaseKeeper`
  and :class:`~paddle_tpu_torch.runtime.master_service.MasterServer` work
  unchanged.
* :class:`NetworkFencedStore` — FencedFile's interface (claim / write /
  _recorded) plus ``fetch_to`` for successor restore, backed by the blob
  store.

Deployment: run ``CoordServer`` where etcd would run (any host the workers
can reach, typically alongside the first master candidate); masters elect
through it and push fenced snapshots into it; a standby on a *different*
host restores from it. Single-host jobs keep FileLease and never need this.
"""

from __future__ import annotations

import base64
import socket
import socketserver
import threading
import time
from typing import Dict, Optional, Tuple

from .. import faults, obs
from .master_service import _recv_msg, _RpcClient, _send_msg


class CoordServer:
    """In-memory lease/fence/blob coordination service (etcd stand-in)."""

    #: requests_total `type` label values — arbitrary op strings off the
    #: wire clamp to "unknown" so a peer cannot mint unbounded series
    _KNOWN_OPS = frozenset({
        "lease_acquire", "lease_renew", "lease_release", "lease_holder",
        "fence_claim", "blob_put", "blob_get", "fence_recorded", "ping"})

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._lock = threading.Lock()
        # name -> (owner, expires_at_monotonic, token)
        self._leases: Dict[str, Tuple[str, float, int]] = {}
        self._epochs: Dict[str, int] = {}        # name -> token high-water
        self._fences: Dict[str, int] = {}        # resource -> claimed token
        self._blobs: Dict[str, bytes] = {}       # key -> payload
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    req = _recv_msg(self.request)
                    if req is None:
                        return
                    _send_msg(self.request, outer._dispatch(req))

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server((host, port), Handler)
        self.address: Tuple[str, int] = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    # -- ops (all under one lock: every read-check-write is atomic) ---------
    def _dispatch(self, req):
        op = str(req.get("op"))
        label = op if op in self._KNOWN_OPS else "unknown"
        obs.count("coord.requests_total", type=label)
        # server-side span parented on the client's rpc.call wire context —
        # the same cross-process edge MasterServer._dispatch records
        try:
            with obs.server_span("coord.dispatch", req.get("trace"), op=op):
                resp = self._dispatch_op(req)
        except Exception:
            # malformed requests (missing field, bad type) must land in
            # the error counter even though the exception severs the conn
            obs.count("coord.request_errors_total", type=label)
            raise
        # key on the error FIELD (the master-dispatch rule): an ok=true
        # answer with renewed/acquired/claimed=false is a normal outcome
        if resp.get("error") is not None:
            obs.count("coord.request_errors_total", type=label)
        return resp

    def _dispatch_op(self, req):
        op = req.get("op")
        with self._lock:
            if op == "lease_acquire":
                return self._acquire(req["name"], req["owner"],
                                     float(req["ttl"]))
            if op == "lease_renew":
                return self._renew(req["name"], req["owner"],
                                   float(req["ttl"]))
            if op == "lease_release":
                h = self._leases.get(req["name"])
                if h is not None and h[0] == req["owner"]:
                    del self._leases[req["name"]]
                return {"ok": True}
            if op == "lease_holder":
                h = self._leases.get(req["name"])
                now = time.monotonic()
                if h is None:
                    return {"ok": True, "holder": None, "token": None}
                # report remaining TTL, not the server-monotonic stamp: the
                # client turns it back into its own clock's terms
                return {"ok": True,
                        "holder": [h[0], max(0.0, h[1] - now)],
                        "token": h[2], "expired": h[1] <= now}
            if op == "fence_claim":
                return self._fence_claim(req["resource"], int(req["token"]))
            if op == "blob_put":
                r = self._fence_claim(req["key"], int(req["token"]))
                if r["claimed"]:
                    self._blobs[req["key"]] = base64.b64decode(req["data"])
                return r
            if op == "blob_get":
                data = self._blobs.get(req["key"])
                return {"ok": True,
                        "data": None if data is None
                        else base64.b64encode(data).decode()}
            if op == "fence_recorded":
                return {"ok": True,
                        "token": self._fences.get(req["resource"], 0)}
            if op == "ping":
                return {"ok": True}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _acquire(self, name: str, owner: str, ttl: float):
        now = time.monotonic()
        h = self._leases.get(name)
        if h is not None and h[0] != owner and h[1] > now:
            return {"ok": True, "acquired": False,
                    "holder": [h[0], h[1] - now], "token": h[2]}
        if h is not None and h[0] == owner and h[1] > now:
            token = h[2]                     # same-owner refresh keeps token
        else:
            # free or expired: mint a strictly larger token (etcd revision)
            cur = max(self._epochs.get(name, 0), h[2] if h else 0)
            token = cur + 1
            self._epochs[name] = token
        self._leases[name] = (owner, now + ttl, token)
        return {"ok": True, "acquired": True, "token": token}

    def _renew(self, name: str, owner: str, ttl: float):
        h = self._leases.get(name)
        if h is None or h[0] != owner:
            return {"ok": True, "renewed": False}
        self._leases[name] = (owner, time.monotonic() + ttl, h[2])
        return {"ok": True, "renewed": True, "token": h[2]}

    def _fence_claim(self, resource: str, token: int):
        recorded = self._fences.get(resource, 0)
        if token < recorded:
            return {"ok": True, "claimed": False, "recorded": recorded}
        self._fences[resource] = max(recorded, token)
        return {"ok": True, "claimed": True, "recorded": token}


class _CoordClient(_RpcClient):
    """Reconnecting client for CoordServer calls: the shared
    :class:`_RpcClient` plumbing (RetryPolicy backoff, per-call socket
    deadline, drop-socket-on-error) against one endpoint, exposing the raw
    request interface."""

    _rpc_name = "coord rpc"

    def call(self, req):
        return self._call(req)


class NetworkLease:
    """TTL lease on a CoordServer with FileLease's interface.

    Expiry is judged by the server's clock, so the ``now=`` overrides the
    FileLease tests use for time travel are accepted but ignored — a
    contender cannot argue a foreign lease expired when the server says
    otherwise (the whole point of central coordination).
    """

    def __init__(self, host: str, port: int, name: str = "master",
                 owner: Optional[str] = None, ttl: float = 10.0):
        import os
        import uuid
        self.path = f"coord://{host}:{port}/{name}"   # diagnostic parity
        self.name = name
        self.owner = owner or (f"{socket.gethostname()}-{os.getpid()}-"
                               f"{uuid.uuid4().hex[:8]}")
        self.ttl = ttl
        self.token: Optional[int] = None
        self._client = _CoordClient(host, port)

    # -- inspection ---------------------------------------------------------
    def holder(self) -> Optional[Tuple[str, float]]:
        r = self._client.call({"op": "lease_holder", "name": self.name})
        if r.get("holder") is None or r.get("expired"):
            return None
        owner, remaining = r["holder"]
        return owner, time.time() + remaining

    def current_token(self) -> Optional[int]:
        r = self._client.call({"op": "lease_holder", "name": self.name})
        return r.get("token")

    def held_by_me(self, now: Optional[float] = None) -> bool:
        h = self.holder()
        return h is not None and h[0] == self.owner

    # -- acquisition --------------------------------------------------------
    def try_acquire(self, now: Optional[float] = None) -> bool:
        r = self._client.call({"op": "lease_acquire", "name": self.name,
                               "owner": self.owner, "ttl": self.ttl})
        if r.get("acquired"):
            self.token = r["token"]
            return True
        return False

    def renew(self, now: Optional[float] = None) -> bool:
        obs.count("lease.renews_total")
        faults.fire("lease.renew")
        r = self._client.call({"op": "lease_renew", "name": self.name,
                               "owner": self.owner, "ttl": self.ttl})
        if r.get("renewed"):
            if self.token is None:
                self.token = r.get("token")   # recover after restart
            return True
        obs.count("lease.renew_failures_total")
        return False

    def release(self):
        self._client.call({"op": "lease_release", "name": self.name,
                           "owner": self.owner})
        self.token = None

    def wait_acquire(self, poll: float = 0.5,
                     timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if self.try_acquire():
                return True
            if deadline is not None and time.time() > deadline:
                return False
            time.sleep(poll)

    def close(self):
        self._client.close()


class NetworkFencedStore:
    """Fenced snapshot home on a CoordServer (FencedFile's interface).

    ``write`` runs the caller's path-writer locally, then pushes the bytes
    with its fencing token; the server's atomic check-and-publish refuses a
    deposed generation. A successor — on any host — ``fetch_to``\\ s the
    blob before restore. No filesystem is shared.
    """

    def __init__(self, host: str, port: int, key: str = "master.snap"):
        self.key = key
        self._client = _CoordClient(host, port)

    def _recorded(self) -> int:
        return int(self._client.call({"op": "fence_recorded",
                                      "resource": self.key}).get("token", 0))

    def claim(self, token: Optional[int]) -> bool:
        if token is None:
            return True
        return bool(self._client.call({"op": "fence_claim",
                                       "resource": self.key,
                                       "token": token}).get("claimed"))

    def write(self, token: Optional[int], writer) -> bool:
        import os
        import tempfile
        fd, tmp = tempfile.mkstemp(prefix="coordsnap.")
        os.close(fd)
        try:
            writer(tmp)
            with open(tmp, "rb") as f:
                data = f.read()
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        r = self._client.call({"op": "blob_put", "key": self.key,
                               "token": int(token) if token is not None else 0,
                               "data": base64.b64encode(data).decode()})
        return bool(r.get("claimed"))

    def fetch_to(self, path: str) -> bool:
        """Download the snapshot blob to ``path``; False if none stored."""
        r = self._client.call({"op": "blob_get", "key": self.key})
        if r.get("data") is None:
            return False
        with open(path, "wb") as f:
            f.write(base64.b64decode(r["data"]))
        return True

    def close(self):
        self._client.close()


def main(argv=None):
    """``python -m paddle_tpu_torch.runtime.coord [--host H] [--port P]`` — run the
    coordination service standalone (where the reference runs etcd)."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args(argv)
    srv = CoordServer(args.host, args.port)
    print(f"LISTENING {srv.address[0]} {srv.address[1]}", flush=True)
    srv.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
