"""CUDA graphs of the port's dispatches — the counterpart of ``jax.jit``'s
per-signature cache.

In the JAX package each step of a path is one compiled dispatch: the
decode step, the serving segment, the speculative round, the trainer
step, the beam scan. A :class:`GraphCache` gives the port the same: one
cache per owner (a model's decode loop, a page pool, a batcher, a
trainer), holding one CUDA graph per static signature — the input
tensors' shapes and dtypes, the structure of the input trees and the
static arguments, as ``jax.jit`` caches by them. A ``torch.Generator``
among the static arguments joins the key as a kind, not as an object,
as JAX passes its PRNG key as a traced input.

* **Static buffers.** The cache owns every buffer its graphs read their
  inputs from. A donated input (``donate=``) that the cache already owns
  — a static buffer of another of its graphs, or a
  :meth:`GraphCache.buffer` the owner made through it (a pool's pages, a
  decode cell) — becomes the new graph's static buffer as it is, so that
  a tree carried from step to step is shared by all the graphs that take
  it. Any other input is copied into a buffer of the cache's own: a
  caller's tensors are never adopted and never written.
* **First call of a key.** After the copy-in the body runs once eagerly
  on the cache's capture stream — the call's real work, and the warm-up
  that makes what a kernel keeps per stream (the split decode reads'
  tickets) exist before the capture — and is captured with
  ``torch.cuda.graph(g, stream=<that stream>, pool=<the owner's one
  pool>, capture_error_mode="thread_local")`` (``ServingEngine``
  dispatches from its scheduler thread). The capture draws from a
  generator of the cache's own, registered with the graph.
* **Later calls.** Each input is copied into its static buffer and the
  graph replays on the capture stream. An input that *is* its static
  buffer is not copied: that is donation, as ``donate_argnums`` gives it.
  The caller's generator state goes into the cache's generator before the
  replay and the advanced state back after it, so the draws are the ones
  the eager body makes from the caller's generator.
* **Outputs.** A donated static buffer comes back as itself (a donated
  tree comes back as the buffers the graph writes in place), to be passed
  back and written by the next call; any other output is the graph's own
  memory, which the next replay overwrites, so it comes back as a clone.
* **CPU and meta tensors** (a cache whose device is not a card), and any
  call inside :func:`disabled`, run the body directly, as the kernel
  wrappers take their plain versions for CPU tensors. Donation holds
  there too: a donated input the cache does not own is copied first, and
  the copy is the cache's. On the card a capture or replay that fails
  raises: there is no eager fallback.

The bodies read what they do not take as inputs (a model's weights) at
the address the capture saw: an owner calls :meth:`GraphCache.watch` with
those tensors, which drops the graphs and buffers when one of them was
reallocated.

Counts: :data:`DISPATCHES` holds the captures and replays per owner and
key (the counterpart of JAX's ``decode.dispatches_total``), beside
``ops.cuda_kernels.LAUNCHES``. The kernel wrappers count their launches
in Python when they are called, which a replay is not, so each graph
records the ``LAUNCHES`` (and the recurrences' ``ROUTES``) its capture
added (and takes them back out: a capture launches nothing) and every
replay adds them again. A graph keeps
its cudaGraph_t (``keep_graph=True``) so that a check can count its
kernel nodes against that record (:func:`captured`).

Threads: caches of one process may run on several threads at once (the
engines of a routed fleet, each on its scheduler thread, and a prefill
worker on its RPC threads). One capture runs at a time and no replay
runs during one (``_CAPTURE_LOCK``): ``torch.cuda.graph`` begins with a
device-wide synchronize, which would break a capture in flight on
another thread, and the capture's launch record must hold its own
launches only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import Any, Callable, Dict, Hashable, Iterable, List, Optional

import torch

from .place import resolve_device

#: captures and replays per owner and key:
#: ``DISPATCHES[owner][label] = {"captures": n, "replays": n}``
DISPATCHES: Dict[str, Dict[str, Dict[str, int]]] = {}

_disabled = 0

#: every live cache, for :func:`captured`
_CACHES: "weakref.WeakSet[GraphCache]" = weakref.WeakSet()

#: one capture at a time in the process, and no replay during one:
#: ``torch.cuda.graph`` begins with a device-wide synchronize, which breaks
#: a capture another thread has in flight (two engines of one process, a
#: prefill worker beside them, each capturing on its own scheduler or RPC
#: thread), and a capture sets LAUNCHES back to what it found, which would
#: drop the launches another thread's replays add meanwhile
_CAPTURE_LOCK = threading.RLock()


def reset_dispatch_counts() -> None:
    DISPATCHES.clear()


def captured():
    """(owner, label, the launches its capture recorded, the
    ``torch.cuda.CUDAGraph``) of every graph of every live cache: a check
    reads a graph's kernel nodes (``raw_cuda_graph()``) against the
    launches its replays add."""
    return [(c.owner, e.label, dict(e.launches), e.graph)
            for c in list(_CACHES) for e in c._graphs.values()]


@contextlib.contextmanager
def disabled():
    """Run every cache's bodies directly inside this block, as
    ``jax.disable_jit`` does for ``jax.jit``: the eager route that the
    card checks hold the graphs against. It holds for every thread (the
    engine's scheduler thread too)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


class _Leaf:
    """The place of a tensor in a flattened input or output tree."""

    def __repr__(self) -> str:
        return "T"


_LEAF = _Leaf()


def _flatten(tree, leaves: List[torch.Tensor]):
    """A hashable spec of ``tree`` (dicts, lists, tuples, NamedTuples and
    dataclasses such as a ``SeqBatch``, of tensors and constants),
    appending its tensors to ``leaves``."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree), tuple(
            _flatten(getattr(tree, f.name), leaves)
            for f in dataclasses.fields(tree)))
    return (None, tree)


def _unflatten(spec, leaves):
    """The tree of ``spec`` with the tensors taken in order from the
    iterator ``leaves``."""
    if spec is _LEAF:
        return next(leaves)
    kind, body = spec
    if kind is dict:
        return {k: _unflatten(v, leaves) for k, v in body}
    if kind is None:
        return body
    items = [_unflatten(v, leaves) for v in body]
    if hasattr(kind, "_fields") or dataclasses.is_dataclass(kind):
        return kind(*items)
    return kind(items)


def signature(name: str, inputs: Dict[str, Any],
              static: Dict[str, Hashable]):
    """(key, spec, tensors) of a call: the key holds the body's name, the
    structure and constants of the input trees, the static arguments (a
    generator as its kind) and every input tensor's shape and dtype."""
    leaves: List[torch.Tensor] = []
    spec = _flatten(inputs, leaves)
    key = (name, spec,
           tuple((k, torch.Generator if isinstance(v, torch.Generator)
                  else v) for k, v in static.items()),
           tuple((tuple(t.shape), t.dtype) for t in leaves))
    return key, spec, leaves


def label(name: str, inputs: Dict[str, Any],
          static: Dict[str, Hashable]) -> str:
    """A key's name in :data:`DISPATCHES`: the body's name with its static
    arguments and the shapes of the inputs that are not dicts (a batch,
    prompts, tables, tokens; not a parameter tree or a cache)."""
    parts = [f"{k}={v}" for k, v in static.items()
             if not isinstance(v, torch.Generator)]
    for v in inputs.values():
        if not isinstance(v, dict):
            leaves: List[torch.Tensor] = []
            _flatten(v, leaves)
            parts += ["x".join(map(str, t.shape)) or "scalar"
                      for t in leaves]
    return f"{name}({','.join(parts)})"


def _donated_ids(inputs: Dict[str, Any], donate: Iterable[str]) -> set:
    out = set()
    for k in donate:
        leaves: List[torch.Tensor] = []
        _flatten(inputs[k], leaves)
        out.update(id(t) for t in leaves)
    return out


class _Graph:
    __slots__ = ("graph", "statics", "out_spec", "outs", "launches", "routes",
                 "label", "generators")

    def outputs(self):
        """The output tree of a replay: donated static buffers as
        themselves, every other tensor as a clone."""
        return _unflatten(self.out_spec, iter(
            t if is_static else t.clone() for t, is_static in self.outs))


class GraphCache:
    """One owner's CUDA graphs, keyed by static signature, in one memory
    pool and on one capture stream (see the module docstring).

    ``owner`` names the counts in :data:`DISPATCHES` (instances of one
    kind share a name); ``device`` is where the owner's tensors live: a
    cache for anything but a card runs its bodies directly."""

    def __init__(self, owner: str, device):
        self.owner = owner
        self.device = resolve_device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._buffers: Dict[Hashable, Any] = {}
        self._owned = weakref.WeakValueDictionary()   # id -> tensor
        self._generators: Dict[str, torch.Generator] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self._watched: Optional[tuple] = None
        _CACHES.add(self)

    def clear(self) -> None:
        """Drop every graph and buffer (the pool goes with the last
        graph)."""
        self._graphs.clear()
        self._buffers.clear()
        self._pool = None

    def watch(self, tensors: Iterable[torch.Tensor]) -> None:
        """Drop the graphs and buffers when one of ``tensors`` (what the
        bodies read without taking it as an input: a model's weights) is
        not where an earlier call saw it."""
        if self.device.type != "cuda":
            return
        mark = tuple((t.data_ptr(), t.dtype, tuple(t.shape)) for t in tensors)
        if self._watched is not None and mark != self._watched:
            self.clear()
        self._watched = mark

    def buffer(self, key: Hashable, make: Callable[[], Any]):
        """The tree of tensors ``make()`` gives, made once per ``key`` and
        owned by the cache until :meth:`clear`: state the owner's graphs
        carry in place (a pool's pages, a decode cell), passed to them as
        a donated input."""
        tree = self._buffers.get(key)
        if tree is None:
            tree = self._buffers[key] = make()
            self._own(tree)
        return tree

    def _own(self, tree) -> None:
        leaves: List[torch.Tensor] = []
        _flatten(tree, leaves)
        for t in leaves:
            self._owned[id(t)] = t

    def _owns(self, t: torch.Tensor) -> bool:
        return self._owned.get(id(t)) is t

    @torch.no_grad()
    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(t.shape, dtype=t.dtype, device=self.device)
        buf.copy_(t)
        return buf

    @contextlib.contextmanager
    def ordered(self):
        """Work issued inside runs on the caller's stream after every
        replay issued so far, and every replay issued later runs after it:
        a read or write of a :meth:`buffer` from outside the graphs (the
        pool's export gather and adopt scatter of shipped pages) never
        races a replay, whichever stream the caller is on."""
        if self.device.type != "cuda" or self._stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        caller.wait_stream(self._stream)
        yield
        self._stream.wait_stream(caller)

    def run(self, name: str, body: Callable, inputs: Dict[str, Any], *,
            static: Optional[Dict[str, Hashable]] = None,
            donate: Iterable[str] = ()):
        """``body(**inputs, **static)`` through the graph of this signature.

        ``inputs`` are trees of tensors (and constants, which join the
        key); a tensor on another device (a host array's) is copied to the
        cache's. ``static`` holds hashable arguments that join the key
        (modes, bounds, a ``torch.Generator``); ``donate`` names the inputs
        the body may write in place (it writes into no other input)."""
        static = dict(static or {})
        key, spec, leaves = signature(name, inputs, static)
        donated = _donated_ids(inputs, donate)
        if self.device.type != "cuda" or _disabled:
            args = []
            for t in leaves:
                if id(t) in donated and not self._owns(t):
                    t = self._copy(t)
                    self._own(t)
                elif t.device != self.device:
                    t = t.to(self.device)
                args.append(t)
            return body(**_unflatten(spec, iter(args)), **static)
        entry = self._graphs.get(key)
        if entry is None:
            with _CAPTURE_LOCK:
                return self._capture(key, label(name, inputs, static), body,
                                     spec, leaves, static, donated)
        caller = torch.cuda.current_stream(self.device)
        with torch.no_grad():
            for x, s in zip(leaves, entry.statics):
                if x is not s:
                    s.copy_(x)
        for k in entry.generators:
            self._generators[k].set_state(static[k].get_state())
        stream = self._stream
        from ..ops.cuda_kernels import LAUNCHES, ROUTES
        with _CAPTURE_LOCK:
            stream.wait_stream(caller)
            with torch.cuda.stream(stream):
                entry.graph.replay()
            caller.wait_stream(stream)
            self._count(entry, "replays")
            for k, n in entry.launches.items():
                LAUNCHES[k] += n
            for k, n in entry.routes.items():
                ROUTES[k] = ROUTES.get(k, 0) + n
        for k in entry.generators:
            static[k].set_state(self._generators[k].get_state())
        return entry.outputs()

    def _count(self, entry: _Graph, what: str) -> None:
        counts = DISPATCHES.setdefault(self.owner, {}).setdefault(
            entry.label, {"captures": 0, "replays": 0})
        counts[what] += 1

    def _capture(self, key, name, body, spec, leaves, static, donated):
        from ..ops.cuda_kernels import LAUNCHES, ROUTES
        dev = self.device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        # the static buffers: a donated tensor the cache owns as it is,
        # every other input copied into a buffer of the cache's own
        statics, carried = [], set()
        for x in leaves:
            if id(x) in donated and self._owns(x):
                buf = x
            else:
                buf = self._copy(x)
                if id(x) in donated:
                    self._own(buf)
            if id(x) in donated:
                carried.add(id(buf))
            statics.append(buf)
        args = _unflatten(spec, iter(statics))
        caller = torch.cuda.current_stream(dev)
        stream = self._stream
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            # the call's own work, eagerly: also the warm-up
            out = body(**args, **static)
        caller.wait_stream(stream)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        drawn = dict(static)
        gens = [k for k, v in static.items()
                if isinstance(v, torch.Generator)]
        for k in gens:
            if k not in self._generators:
                self._generators[k] = torch.Generator(device=dev)
            drawn[k] = self._generators[k]
            graph.register_generator_state(drawn[k])
        before, routes_before = dict(LAUNCHES), dict(ROUTES)
        with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                              capture_error_mode="thread_local"):
            gout = body(**args, **drawn)
        graph.instantiate()
        delta = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                 if LAUNCHES[k] != before[k]}
        LAUNCHES.update(before)          # a capture launches nothing
        routes = {k: n - routes_before.get(k, 0) for k, n in ROUTES.items()
                  if n != routes_before.get(k, 0)}
        ROUTES.clear()
        ROUTES.update(routes_before)
        entry = _Graph()
        entry.graph, entry.statics, entry.launches = graph, statics, delta
        entry.routes = routes
        entry.label, entry.generators = name, gens
        glist: List[torch.Tensor] = []
        entry.out_spec = _flatten(gout, glist)
        entry.outs = [(t, id(t) in carried) for t in glist]
        self._graphs[key] = entry
        self._count(entry, "captures")
        # the eager outputs were made on the capture stream and are used on
        # the caller's: their memory waits for the caller's work
        olist: List[torch.Tensor] = []
        _flatten(out, olist)
        for t in olist:
            if id(t) not in carried:
                t.record_stream(caller)
        return out
