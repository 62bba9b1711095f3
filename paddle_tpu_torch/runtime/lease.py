"""Lease/lock primitives for master election — the etcd analog; a copy of
``paddle_tpu/runtime/lease.py`` (it imports no JAX), wired to the port's
``faults`` and ``obs``.

The reference elects and registers its masters/pservers through etcd leases
and locks (go/master/etcd_client.go: concurrency.NewSession + lock under
a TTL lease; go/pserver/etcd_client.go slot registration). A cluster of
hosts has no etcd, but every host mounts shared storage; :class:`FileLease` provides the
same primitive there: a lock file holding ``owner expires_at token``,
acquirable when absent/expired and renewed by its holder. A standby master
blocks on the lease and takes over (restoring the CRC-checked snapshot) when
the active master dies — removing the single-point-of-failure the round-1
review flagged.

Contention protocol: every lease mutation (acquire / renew / release) is
serialized under an ``flock`` on a sidecar ``<path>.lock`` file, so
read-check-write sequences are atomic among contenders; readers see
consistent contents because the lease file itself is replaced via
write-temp-then-rename. flock is advisory but all participants go through
this class; it holds across NFSv4 (and NFSv3 with lockd), the shared-storage
deployments a cluster of hosts actually uses.

Fencing: every acquisition is stamped with a monotonically increasing
*fencing token* (persisted in a sidecar ``<path>.epoch`` counter, bumped
under the same kind of flock so it never goes backwards, even across
release/re-acquire cycles) — the role etcd revisions play in
go/master/etcd_client.go. Resources that must never accept writes from a
deposed master (the snapshot file) are guarded by :class:`FencedFile`: the
check-and-publish runs under an flock, so a writer that stalls mid-operation
(GC pause, NFS hiccup) either completes before the new generation's claim or
finds itself refused — there is no window where a stale write lands on top
of a newer generation's.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import socket
import threading
import time
import uuid
from typing import Optional, Tuple

from .. import faults, obs


@contextlib.contextmanager
def _flocked(lock_path: str):
    """Exclusive advisory lock scope on ``lock_path`` (created if absent)."""
    fd = os.open(lock_path, os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


class FileLease:
    """A TTL lease on shared storage (etcd lease/lock stand-in)."""

    def __init__(self, path: str, owner: Optional[str] = None,
                 ttl: float = 10.0):
        self.path = path
        self.owner = owner or f"{socket.gethostname()}-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        self.ttl = ttl
        self._lock_path = f"{path}.lock"
        #: fencing token of OUR current acquisition (None until we hold it)
        self.token: Optional[int] = None

    # -- inspection ---------------------------------------------------------
    def holder(self) -> Optional[Tuple[str, float]]:
        """(owner, expires_at) of the current lease file, None if absent/bad."""
        h = self._read(self.path)
        return None if h is None else (h[0], h[1])

    def current_token(self) -> Optional[int]:
        """Fencing token of the current lease file (whoever holds it)."""
        h = self._read(self.path)
        return None if h is None else h[2]

    def held_by_me(self, now: Optional[float] = None) -> bool:
        h = self.holder()
        now = time.time() if now is None else now
        return h is not None and h[0] == self.owner and h[1] > now

    # -- acquisition --------------------------------------------------------
    def try_acquire(self, now: Optional[float] = None) -> bool:
        """Take the lease if it is free, expired, or already ours.

        The whole read-check-write runs under the contender flock, so
        exactly one contender wins an expired/free lease and nobody can
        clobber a live holder's renewal.
        """
        now = time.time() if now is None else now
        with _flocked(self._lock_path):
            h = self._read(self.path)
            if h is not None and h[0] != self.owner and h[1] > now:
                return False                 # live foreign lease
            if h is not None and h[0] == self.owner:
                if self.token is None:
                    self.token = h[2]        # recover after restart
            else:
                self.token = self._next_token()
            self._write(now)
            # confirm-after-write: on mounts where advisory flock silently
            # no-ops (NFSv3 without lockd, some FUSE/SMB), a concurrent
            # writer's os.replace can land after ours — only believe we
            # hold the lease if the file still names us
            return self.held_by_me(now)

    def renew(self, now: Optional[float] = None) -> bool:
        """Extend our lease; False (lease LOST) if someone else took it."""
        obs.count("lease.renews_total")
        faults.fire("lease.renew")   # chaos: stall/FS-outage injection point
        now = time.time() if now is None else now
        with _flocked(self._lock_path):
            h = self._read(self.path)
            if h is None or h[0] != self.owner:
                obs.count("lease.renew_failures_total")
                return False
            if self.token is None:
                self.token = h[2]            # recover after restart
            self._write(now)
            return True

    def release(self):
        with _flocked(self._lock_path):
            h = self._read(self.path)
            if h is not None and h[0] == self.owner:
                try:
                    os.remove(self.path)
                except OSError:
                    pass
        self.token = None

    def wait_acquire(self, poll: float = 0.5,
                     timeout: Optional[float] = None) -> bool:
        """Block until the lease is ours (standby-master loop)."""
        deadline = None if timeout is None else time.time() + timeout
        while True:
            if self.try_acquire():
                return True
            if deadline is not None and time.time() > deadline:
                return False
            time.sleep(poll)

    def _read(self, path: str) -> Optional[Tuple[str, float, int]]:
        try:
            with open(path) as f:
                fields = f.read().split()
                owner, expires = fields[0], float(fields[1])
                token = int(fields[2]) if len(fields) > 2 else 0
                return owner, expires, token
        except (OSError, ValueError, IndexError):
            return None

    def _next_token(self) -> int:
        """Monotonic across every acquisition, including after release():
        the high-water mark lives in a sidecar counter file. The
        read-bump-write is serialized under its own flock so a contender
        that stalls mid-bump can never roll the counter backwards and mint
        a duplicate token."""
        epoch_path = f"{self.path}.epoch"
        fd = os.open(epoch_path, os.O_RDWR | os.O_CREAT, 0o644)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            raw = os.read(fd, 64)
            try:
                cur = int(raw) if raw else 0
            except ValueError:
                cur = 0
            h = self._read(self.path)
            if h is not None:
                cur = max(cur, h[2])
            nxt = cur + 1
            os.lseek(fd, 0, os.SEEK_SET)
            os.ftruncate(fd, 0)
            os.write(fd, str(nxt).encode())
            os.fsync(fd)
            return nxt
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def _write(self, now: float):
        # caller holds the contender flock; rename keeps readers consistent
        tmp = f"{self.path}.{self.owner}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{self.owner} {now + self.ttl} {self.token or 0}")
        os.replace(tmp, self.path)


class FencedFile:
    """Token-checked write guard for a resource shared across master
    generations (the snapshot file). A writer presents its fencing token;
    once any higher token has claimed the resource, lower tokens are
    refused — etcd-revision fencing (go/master/etcd_client.go) on a plain
    filesystem. Check-and-publish is atomic under an flock: a stale writer
    cannot land its file after a newer generation's claim."""

    def __init__(self, path: str):
        self.path = path
        self.fence_path = f"{path}.fence"
        self._lock_path = f"{path}.fencelock"

    def _recorded(self) -> int:
        try:
            with open(self.fence_path) as f:
                return int(f.read())
        except (OSError, ValueError):
            return 0

    def _claim_locked(self, token: int) -> bool:
        recorded = self._recorded()
        if token < recorded:
            return False
        if token > recorded:
            tmp = f"{self.fence_path}.{token}.tmp"
            with open(tmp, "w") as f:
                f.write(str(token))
            os.replace(tmp, self.fence_path)
        return True

    def claim(self, token: Optional[int]) -> bool:
        """Record `token` as the current generation; False if a higher
        token already claimed the resource (caller is deposed)."""
        if token is None:
            return True                      # fencing not in use
        with _flocked(self._lock_path):
            return self._claim_locked(token)

    def write(self, token: Optional[int], writer) -> bool:
        """Run ``writer(tmp)`` then publish the result iff `token` is still
        current. The (possibly slow) write happens outside the lock; the
        check + rename are one atomic critical section, so a deposed
        writer's file can never replace a newer generation's."""
        tmp = f"{self.path}.w{token if token is not None else 0}.tmp"
        writer(tmp)
        if token is None:
            os.replace(tmp, self.path)
            return True
        with _flocked(self._lock_path):
            if not self._claim_locked(token):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
                return False
            os.replace(tmp, self.path)
            return True


class LeaseKeeper:
    """Background renewal thread; fires ``on_lost`` if the lease slips away
    (the etcd session-expired event)."""

    def __init__(self, lease: FileLease, interval: Optional[float] = None,
                 on_lost=None):
        self.lease = lease
        self.interval = interval if interval is not None else lease.ttl / 3
        self.on_lost = on_lost
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        last_ok = time.time()
        while not self._stop.wait(self.interval):
            # stamp BEFORE the RPC: the server's expiry clock starts when it
            # handles the request, so measuring our grace window from the
            # request's issue time keeps the client strictly conservative
            # relative to server-side expiry (never "held" past the server)
            attempt_at = time.time()
            try:
                renewed = self.lease.renew()
            except (OSError, ConnectionError):
                # transient store outage (NFS blip, coord-server restart):
                # keep trying while our TTL could still be running; once the
                # lease must have expired server-side, it is LOST
                renewed = time.time() - last_ok < self.lease.ttl
            else:
                if renewed:
                    last_ok = attempt_at
            if not renewed:
                if self.on_lost is not None:
                    self.on_lost()
                return

    def stop(self, release: bool = True):
        self._stop.set()
        # on_lost callbacks run ON the keeper thread and may call stop();
        # joining ourselves would raise RuntimeError
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
        if release:
            self.lease.release()
