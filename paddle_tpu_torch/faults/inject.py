"""Deterministic, seedable fault injection — a copy of
``paddle_tpu/faults/inject.py``.

A process-global :class:`FaultPlan` holds :class:`Fault` rules keyed by
*injection site*, a short dotted name marking one failure-prone
operation. The site names are JAX's, so a plan reads the same in both
packages, but the port's plan is its own: a ``paddle_tpu`` plan never
fires a site of this package, nor this package's plan one of JAX's. The
sites the port has:

========================  =====================================================
site                      where it fires in the port
========================  =====================================================
``ckpt.write``            per checkpoint member written (trainer/checkpoint.py)
``reader.next``           per chunk-task stream opened (data/chunks.py)
``step.grad``             per train-step loss read back (trainer/trainer.py)
``rpc.send``              per RPC frame a client sends (filters the payload;
                          runtime/master_service.py)
``rpc.recv``              per RPC reply a client reads
``mbr.heartbeat``         per membership heartbeat sent (runtime/membership.py)
``srv.ship``              per shipped KV-page chunk, after its CRC (filters the
                          raw chunk; serving/ship.py)
``srv.adopt``             per adopt request a decode daemon takes
                          (serving/daemon.py)
``route.submit``          per placement attempt of the router
                          (serving/router.py)
========================  =====================================================

:data:`SITES` holds these and no more: JAX's other sites
(``lease.renew``, ``actor.spawn``, ``actor.drain``) belong to modules the
port has not taken yet, and :meth:`FaultPlan.add` refuses a rule for
one, so that a plan never waits on a site that cannot fire.

``step.grad`` caveat: the hook filters the HOST-observed loss value after
the step ran — it drives the detection/raise/halt machinery, but it
cannot reach inside the step's CUDA graph, so the in-step non-finite
select (the ``skip``/``halt`` update-drop) only reacts to a *genuinely*
non-finite loss. To chaos-test skip-accounting byte-identity, poison the batch data
(see tests/test_torch_faults.py) rather than corrupting ``step.grad``.

Rules trigger on the Nth hit of their site (and optionally for ``count``
consecutive hits after that) and perform one action: ``raise`` an exception,
``delay`` (sleep), ``truncate`` a byte payload, or ``corrupt`` a value.
Determinism: hit counters are exact, and any randomness (corruption bytes)
comes from a ``random.Random(seed)`` owned by the plan — the same plan
replays the same failure sequence every run, which is what lets the chaos
tests assert byte-identical recovery.

Zero cost when disabled: every hook first checks a module-level ``_PLAN is
None`` — one attribute load and branch on the hot path, no locks, no dict
lookups. Production code never pays for the harness it ships with.

Usage::

    plan = FaultPlan(seed=7)
    plan.add("reader.next", action="raise", nth=1, count=2,
             exc=OSError("injected"))
    with plan.installed():
        ...   # the first two reader.next hits raise OSError
    assert plan.fired  # [('reader.next', 1, 'raise'), ...]
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .. import obs

SITES = ("ckpt.write", "reader.next", "step.grad", "rpc.send", "rpc.recv",
         "mbr.heartbeat", "srv.ship", "srv.adopt", "route.submit")

#: process-global active plan; None = harness disabled (the fast path)
_PLAN: Optional["FaultPlan"] = None


class FaultError(RuntimeError):
    """Default exception raised by a ``raise`` fault with no ``exc``."""


class Fault:
    """One injection rule: at hits ``nth .. nth+count-1`` of ``site``, do
    ``action``. Actions:

    * ``raise``    — raise ``exc`` (an exception instance or zero-arg factory)
    * ``delay``    — sleep ``delay_s`` seconds
    * ``truncate`` — cut a byte payload to ``truncate_to`` bytes (or by
      ``truncate_frac`` of its length)
    * ``corrupt``  — XOR one plan-seeded byte of a payload, or pass a value
      through ``mutate`` (default for non-bytes: float('nan'))
    """

    __slots__ = ("site", "action", "nth", "count", "exc", "delay_s",
                 "truncate_to", "truncate_frac", "mutate")

    def __init__(self, site: str, action: str = "raise", *, nth: int = 1,
                 count: int = 1, exc=None, delay_s: float = 0.05,
                 truncate_to: Optional[int] = None,
                 truncate_frac: float = 0.5,
                 mutate: Optional[Callable[[Any], Any]] = None):
        if site not in SITES:
            raise ValueError(f"unknown injection site {site!r}; "
                             f"known sites: {', '.join(SITES)}")
        if action not in ("raise", "delay", "truncate", "corrupt"):
            raise ValueError(f"unknown fault action {action!r}")
        if nth < 1 or count < 1:
            raise ValueError("nth and count are 1-based and positive")
        self.site = site
        self.action = action
        self.nth = nth
        self.count = count
        self.exc = exc
        self.delay_s = delay_s
        self.truncate_to = truncate_to
        self.truncate_frac = truncate_frac
        self.mutate = mutate

    def matches(self, hit: int) -> bool:
        return self.nth <= hit < self.nth + self.count


class FaultPlan:
    """A set of :class:`Fault` rules plus the hit/fire bookkeeping.

    Thread-safe: hit counters and the fired log are guarded by one lock
    (checkpoint writers and prefetch threads hit sites concurrently).
    Install with :meth:`install`/:meth:`uninstall` or the
    :meth:`installed` context manager; only one plan is active at a time.
    """

    def __init__(self, seed: int = 0,
                 sleep: Optional[Callable[[float], None]] = None):
        self.seed = seed
        self.rng = random.Random(seed)
        self.faults: List[Fault] = []
        self.hits: Dict[str, int] = {}
        #: chronological (site, hit_number, action) log of every fault fired
        self.fired: List[Tuple[str, int, str]] = []
        self._lock = threading.Lock()
        # injectable sleeper for `delay` actions: fake-clock tests advance
        # a counter instead of stalling the suite
        self._sleep = sleep or time.sleep

    # -- authoring ----------------------------------------------------------
    def add(self, site: str, action: str = "raise", **kw) -> "FaultPlan":
        self.faults.append(Fault(site, action, **kw))
        return self

    # -- lifecycle ----------------------------------------------------------
    def install(self) -> "FaultPlan":
        global _PLAN
        if _PLAN is not None and _PLAN is not self:
            raise RuntimeError("another FaultPlan is already installed")
        _PLAN = self
        return self

    def uninstall(self):
        global _PLAN
        if _PLAN is self:
            _PLAN = None

    @contextlib.contextmanager
    def installed(self):
        self.install()
        try:
            yield self
        finally:
            self.uninstall()

    def reset(self):
        """Clear counters and the fired log (rules stay)."""
        with self._lock:
            self.hits.clear()
            self.fired.clear()
            self.rng = random.Random(self.seed)

    # -- firing -------------------------------------------------------------
    def _hit(self, site: str) -> Tuple[int, List[Fault]]:
        with self._lock:
            n = self.hits.get(site, 0) + 1
            self.hits[site] = n
            due = [f for f in self.faults if f.site == site and f.matches(n)]
            for f in due:
                self.fired.append((site, n, f.action))
        # outside the plan lock (obs has its own): per-site injected-fault
        # counters make a chaos run self-describing
        for f in due:
            obs.count("faults.injected_total", site=site, action=f.action)
        return n, due

    def fire(self, site: str):
        """Side-effect-only hook: raise or delay. Truncation/corruption of
        payloads goes through :func:`filter_bytes` / :func:`filter_value`."""
        _, due = self._hit(site)
        for f in due:
            if f.action == "delay":
                self._sleep(f.delay_s)
            elif f.action == "raise":
                # flight recorder (obs/flight.py): persist the span ring
                # BEFORE the injected exception starts unwinding — even if
                # a retry layer later swallows it and the process is then
                # SIGKILLed, the chaos run's tail is already on disk
                obs.flight_dump(f"fault:{site}")
                raise self._make_exc(f, site)
        # truncate/corrupt rules at a fire-only site are authoring errors we
        # surface loudly instead of silently ignoring
        for f in due:
            if f.action in ("truncate", "corrupt"):
                raise FaultError(
                    f"fault at {site} wants action {f.action!r} but the site "
                    "only supports raise/delay (no payload flows through it)")

    def filter_bytes(self, site: str, data: bytes) -> bytes:
        """Payload hook: apply raise/delay plus truncate/corrupt to bytes."""
        _, due = self._hit(site)
        for f in due:
            if f.action == "delay":
                self._sleep(f.delay_s)
            elif f.action == "raise":
                obs.flight_dump(f"fault:{site}")
                raise self._make_exc(f, site)
            elif f.action == "truncate":
                cut = (f.truncate_to if f.truncate_to is not None
                       else int(len(data) * f.truncate_frac))
                data = data[:max(0, cut)]
            elif f.action == "corrupt":
                if data:
                    b = bytearray(data)
                    with self._lock:   # serialize rng draws across threads
                        i = self.rng.randrange(len(b))
                    b[i] ^= 0xFF
                    data = bytes(b)
        return data

    def filter_value(self, site: str, value):
        """Value hook: raise/delay plus ``corrupt`` (mutate or NaN)."""
        _, due = self._hit(site)
        for f in due:
            if f.action == "delay":
                self._sleep(f.delay_s)
            elif f.action == "raise":
                obs.flight_dump(f"fault:{site}")
                raise self._make_exc(f, site)
            elif f.action == "corrupt":
                value = (f.mutate(value) if f.mutate is not None
                         else float("nan"))
            elif f.action == "truncate":
                raise FaultError(
                    f"fault at {site} wants 'truncate' but the site carries "
                    "a value, not bytes — use 'corrupt' with mutate=")
        return value

    @staticmethod
    def _make_exc(f: Fault, site: str) -> BaseException:
        if f.exc is None:
            return FaultError(f"injected fault at {site}")
        if isinstance(f.exc, BaseException):
            return f.exc
        if isinstance(f.exc, type) and issubclass(f.exc, BaseException):
            return f.exc(f"injected fault at {site}")
        return f.exc()   # zero-arg factory


# -- module-level hooks (what instrumented code calls) --------------------------
# Each first checks `_PLAN is None`: one load + branch when the harness is off.

def is_active() -> bool:
    return _PLAN is not None


def fire(site: str) -> None:
    if _PLAN is None:
        return
    _PLAN.fire(site)


def filter_bytes(site: str, data: bytes) -> bytes:
    if _PLAN is None:
        return data
    return _PLAN.filter_bytes(site, data)


def filter_value(site: str, value):
    if _PLAN is None:
        return value
    return _PLAN.filter_value(site, value)
