"""The injectable spawn seam: how the fleet actor creates and retires
worker PROCESSES — a copy of ``paddle_tpu/cluster/spawn.py``.

The actor (actor.py) never talks to an OS or an orchestrator directly —
it calls the four-method :class:`SpawnBackend` protocol and lets the
backend own process lifecycle. That makes a k8s/cloud backend a CONFIG
(hand :class:`HookSpawnBackend` four callables that wrap your API), not
a fork of the actor loop, and lets every chaos test drive the actor with
an in-memory backend under a fake clock.

Contract (docs/design/fleet.md):

* ``spawn(worker, population)`` starts a process that will JOIN the
  population's membership plane under exactly ``worker`` — the actor's
  success oracle is the name appearing in ``mbr_view``, never the
  backend's own opinion;
* ``drain(handle)`` requests a GRACEFUL stop (SIGTERM locally): the
  worker finishes in-flight work, leaves via membership, then exits.
  Must be non-blocking and idempotent;
* ``kill(handle)`` is the escalation after the drain grace expires
  (SIGKILL locally) — membership's TTL lease reaps the corpse;
* ``alive(handle)`` answers whether the process still exists; a dead
  handle whose worker never joined is a SPAWN FAILURE.

Both actor-side call sites fire the ``actor.spawn`` / ``actor.drain``
fault sites first, so spawn failures and hung drains are chaos-injectable
(faults.md) no matter which backend is plugged in.
"""
from __future__ import annotations

import shlex
import signal
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


@dataclass
class SpawnHandle:
    """What a backend returns from ``spawn``: the worker name the process
    must join membership under, plus backend-private state."""
    worker: str
    population: str
    payload: Any = None
    meta: Dict[str, Any] = field(default_factory=dict)


class SpawnBackend:
    """Abstract process-lifecycle seam (see module docstring)."""

    def spawn(self, worker: str, population: str) -> SpawnHandle:
        raise NotImplementedError

    def drain(self, handle: SpawnHandle) -> None:
        raise NotImplementedError

    def kill(self, handle: SpawnHandle) -> None:
        raise NotImplementedError

    def alive(self, handle: SpawnHandle) -> bool:
        raise NotImplementedError


class HookSpawnBackend(SpawnBackend):
    """The config-not-a-fork backend: four injected callables.

    ``spawn_fn(worker, population) -> payload`` (stored on the handle),
    ``drain_fn(handle)``, ``kill_fn(handle)``, ``alive_fn(handle) ->
    bool``. Unset hooks degrade safely: drain/kill become no-ops and
    alive answers True (membership remains the authority).
    """

    def __init__(self, spawn_fn: Callable[[str, str], Any],
                 drain_fn: Optional[Callable[[SpawnHandle], None]] = None,
                 kill_fn: Optional[Callable[[SpawnHandle], None]] = None,
                 alive_fn: Optional[Callable[[SpawnHandle], bool]] = None):
        self._spawn = spawn_fn
        self._drain = drain_fn
        self._kill = kill_fn
        self._alive = alive_fn

    def spawn(self, worker: str, population: str) -> SpawnHandle:
        payload = self._spawn(worker, population)
        return SpawnHandle(worker=worker, population=population,
                           payload=payload)

    def drain(self, handle: SpawnHandle) -> None:
        if self._drain is not None:
            self._drain(handle)

    def kill(self, handle: SpawnHandle) -> None:
        if self._kill is not None:
            self._kill(handle)

    def alive(self, handle: SpawnHandle) -> bool:
        return True if self._alive is None else bool(self._alive(handle))


class SubprocessSpawnBackend(SpawnBackend):
    """Local deployment: one OS process per worker.

    ``template`` is the launch command with a ``{worker}`` placeholder,
    e.g. ``"{python} -m paddle_tpu_torch serve --router H:P --worker {worker}
    ..."`` — ``{python}`` expands to the running interpreter. Drain is
    SIGTERM (both the elastic worker and the serving daemon translate it
    into finish-in-flight → membership leave → exit), kill is SIGKILL.
    """

    def __init__(self, template: str, *, popen=subprocess.Popen,
                 stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL):
        self.template = template
        self._popen = popen
        self._stdout = stdout
        self._stderr = stderr
        self.procs: List[subprocess.Popen] = []

    def argv(self, worker: str) -> List[str]:
        return shlex.split(self.template.format(
            worker=worker, python=sys.executable))

    def spawn(self, worker: str, population: str) -> SpawnHandle:
        proc = self._popen(self.argv(worker), stdout=self._stdout,
                           stderr=self._stderr)
        self.procs.append(proc)
        return SpawnHandle(worker=worker, population=population,
                           payload=proc)

    def drain(self, handle: SpawnHandle) -> None:
        proc = handle.payload
        if proc is not None and proc.poll() is None:
            try:
                proc.send_signal(signal.SIGTERM)
            except (OSError, ValueError):
                pass

    def kill(self, handle: SpawnHandle) -> None:
        proc = handle.payload
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass

    def alive(self, handle: SpawnHandle) -> bool:
        proc = handle.payload
        return proc is not None and proc.poll() is None

    def reap(self) -> None:
        """Wait out exited children (no zombies in long actor runs)."""
        for proc in self.procs:
            if proc.poll() is not None:
                try:
                    proc.wait(timeout=0)
                except Exception:
                    pass
        self.procs = [p for p in self.procs if p.poll() is None]
