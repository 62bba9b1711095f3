"""The training loop — the counterpart of ``paddle_tpu/trainer/trainer.py``'s
``Trainer``: pass and batch loops over a reader (through a feeder and the
``DoubleBuffer`` prefetch thread), events to a callback, evaluators fed
from inside the step, per-pass checkpoints, resume, preemption, the
non-finite-loss policy, a test pass, ``check_gradient`` and
``benchmark``.

As in JAX the trainer is functional: ``loss_fn(params, *batch)`` returns
the scalar loss of a nested dict of parameters, one step is value and
gradient (``torch.autograd.grad`` with respect to the tree's leaves) and
the optimizer's update, and ``train`` returns the new (params,
opt_state). As JAX jits the step with the params and the optimizer state
donated (``donate_argnums=(0, 1)``), a step on the card is one CUDA graph
per batch signature (``core/graphs.py``): the loss (the bf16 recipe's
cast of the f32 masters included), ``outputs_fn`` on the pre-update
parameters, the backward through the port's kernels and the optimizer's
``apply_``, written in place into the trees the graph carries. Under
``on_nonfinite="skip"`` or ``"halt"`` every one of those writes is
``where(isfinite(loss), new, old)``, the step counter's too, as JAX
selects the pre-update trees inside its step: nothing is read back
inside the graph. The test pass is one graph per batch signature too.

Sharing the forward: JAX evaluates ``outputs_fn`` in the same jitted
step as the loss, where XLA computes a forward both use once. The port's
counterpart is :func:`shared_forward`: a function so wrapped and called
by both ``loss_fn`` and ``outputs_fn`` with the same argument objects
(the trainer hands both the same parameter tree and batch) runs once a
step. Unwrapped, both run their own forward and the results are the
same.

The cost read back from each step passes the ``step.grad`` fault hook
(``faults.filter_value``), as in JAX. The hook changes only the host's
copy of the loss: it drives the raise/skip/halt accounting, but the
guard inside the step's graph reacts only to a loss that really is
non-finite, so under ``skip`` a corrupted host cost counts a skip whose
update was applied — JAX's behaviour, kept.

On a mesh (``mesh=``, or ``layout=`` under ``parallel.use_mesh``) the
step is ``parallel.DataParallel``'s, as JAX's is: each rank takes its
rows of the batch, the gradient is the mean over ``data``, and a
``layout`` stores parameters and slots sharded. That step runs eagerly
(a step over gloo cannot be captured in a CUDA graph; ROADMAP C.11);
the non-finite guard reverts on the host to the trees before the step,
as JAX's mesh path does; checkpoints hold the gathered global tensors
(the same bytes as JAX's), written by the mesh's first rank, and a
resume re-places them onto the current mesh.

Obs, as in JAX: the typed counters live on the trainer's own
``MetricsRegistry`` and are mirrored into an installed session; a call
of ``train`` opens a goodput ledger (host_input / device / host_sync
buckets; the device bucket waits for the card) and the
``trainer.pass``, ``trainer.step``, ``trainer.device_step``,
``trainer.host_sync`` and ``trainer.checkpoint`` spans; the graphed
step's cost is counted once a signature on meta tensors and accounted
every step into the roofline ledger (``trainer.step``); a preemption
dumps the armed flight recorder first. ``summary()`` renders the
counters and the ``StatSet`` rows through ``obs.summary``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import signal
import threading
import time
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .. import faults, obs
from ..core.graphs import GraphCache
from ..core.place import DeviceLike, require_device
from ..core.pytree import tree_from_items, tree_items, tree_map
from ..data.prefetch import DoubleBuffer
from ..nn.module import apply_stat_updates_
from ..obs.goodput import maybe_bucket
from ..obs.metrics import MetricsRegistry
from ..utils.logging import get_logger
from ..utils.stats import StatSet
from . import event as EV
from .checkpoint import load_checkpoint, save_checkpoint
from .evaluator import EvaluatorGroup

log = get_logger(__name__)

_NONFINITE_POLICIES = ("raise", "skip", "halt", "off")

_shared = threading.local()


def _timed_input(batches, gp):
    """Yield from ``batches`` timing each pull into the goodput ledger's
    ``host_input`` bucket — the reader/feeder wait as the training loop
    experiences it (prefetch overlap shows up as near-zero pulls)."""
    it = iter(batches)
    while True:
        with gp.bucket("host_input"):
            try:
                batch = next(it)
            except StopIteration:
                return
        yield batch


@contextlib.contextmanager
def _sharing():
    """The scope of one step or test body: :func:`shared_forward` results
    are kept inside it and dropped at its end."""
    _shared.memo = {}
    try:
        yield
    finally:
        _shared.memo = None


def shared_forward(fn: Callable) -> Callable:
    """``fn`` whose result, inside one trainer step or test body, is
    computed once for the same argument objects: a later call with the
    very same objects (``is``, not equal values) returns the first
    result. Outside a trainer body it calls ``fn``. The port's stand-in
    for XLA computing the forward that a loss and ``outputs_fn`` share
    once (module docstring)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        memo = getattr(_shared, "memo", None)
        if memo is None:
            return fn(*args, **kwargs)
        key = (fn, tuple(map(id, args)),
               tuple((k, id(v)) for k, v in sorted(kwargs.items())))
        hit = memo.get(key)
        if hit is None:
            # the arguments are kept so that their ids stay theirs
            hit = memo[key] = (fn(*args, **kwargs), args, kwargs)
        return hit[0]
    return wrapped


def _split_generators(batch: tuple):
    """(the batch with None for each generator, {name: generator}): the
    generators go to the graph as static arguments."""
    gens = {f"generator{i}": b for i, b in enumerate(batch)
            if isinstance(b, torch.Generator)}
    rest = tuple(None if isinstance(b, torch.Generator) else b
                 for b in batch)
    return rest, gens


def _join_generators(batch: tuple, gens: Dict[str, torch.Generator]):
    return tuple(gens.get(f"generator{i}", b) for i, b in enumerate(batch))


def _loss_and_stats(out):
    """A loss's result as (loss, stat updates or None); raises TypeError
    on a tuple that is not (loss, {module path: {stat name: tensor}})."""
    if not isinstance(out, tuple):
        return out, None
    if not (len(out) == 2 and isinstance(out[1], Mapping)
            and all(isinstance(u, Mapping)
                    and all(isinstance(v, torch.Tensor) for v in u.values())
                    for u in out[1].values())):
        raise TypeError(
            "a loss returns a scalar tensor or (loss, stat updates), the "
            "updates a dict {module path: {stat name: tensor}} (the "
            f"mutable dict of a training-mode forward); got {out!r:.200}")
    return out


def _detached(tree):
    return {k: (v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def _host64(x):
    """A host copy of a batch or tree for ``check_gradient``: floating
    tensors as float64 CPU tensors, other tensors on the CPU, through
    dicts, lists, tuples and dataclasses (a ``SeqBatch``)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.to(torch.float64) if x.is_floating_point() else x.clone()
    if isinstance(x, dict):
        return {k: _host64(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host64(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(*(_host64(getattr(x, f.name))
                         for f in dataclasses.fields(x)))
    return x


class _TrainStatsView(Mapping):
    """Read-only view of the robustness counters under the legacy
    ``train_stats`` keys."""

    _KEYS = {"nonfinite_batches": "trainer.nonfinite_total",
             "skipped_batches": "trainer.skipped_total",
             "preemptions": "trainer.preemptions_total"}

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry

    def __getitem__(self, key: str) -> int:
        return int(self._registry.counter(self._KEYS[key]).get())

    def __iter__(self):
        return iter(self._KEYS)

    def __len__(self) -> int:
        return len(self._KEYS)

    def __repr__(self):
        return repr(dict(self))


class Trainer:
    """Drive (loss_fn, optimizer) over reader batches with events and
    evaluators.

    Args:
      loss_fn: (params, *batch) -> scalar loss tensor, or (loss, stat
        updates) for a model with running stats: the updates are the
        ``mutable`` dict a training-mode forward filled
        (``Module.record_stats``: {module path: {stat name: tensor}}),
        merged into the step's params in place after the optimizer's
        update (``nn.apply_stat_updates_``, each cast to its stat's
        dtype), as benchmarks/resnet50.py merges them after JAX's update.
        JAX's Trainer takes a scalar loss only; the pair is the port's.
        Any other tuple raises TypeError.
      optimizer: a ``paddle_tpu_torch.optimizer`` optimizer.
      device: where the batches go and the step runs (default: the card;
        with no card the constructor raises).
      outputs_fn: (params, *batch) -> dict of tensors handed to the
        evaluators (``{"logits": ..., "labels": ...}``), evaluated inside
        the step on the pre-update parameters (the reference's
        semantics); wrap the forward it shares with the loss in
        :func:`shared_forward` to run it once.
      evaluators: an ``EvaluatorGroup`` or a list of evaluators.
      output_dir: if set, ``pass-%05d`` checkpoints are written there.
      prefetch: the ``DoubleBuffer`` depth (batches kept ready).
      log_period, param_stats_period: log the cost / parameter magnitudes
        every so many batches (0: off; ``param_stats_period`` falls back
        to ``FLAGS.show_parameter_stats_period``).
      nan_guard: the legacy on/off switch of the non-finite check.
      on_nonfinite: "raise" (fail fast), "skip" (drop the batch's update,
        count it, warn), "halt" (drop the update, checkpoint the last
        finite state, then raise) or "off"; default "raise" when
        ``nan_guard`` else "off".
      prefetch_timeout: seconds the loop waits for a batch from the
        prefetch thread before it raises TimeoutError.
      metrics: the ``MetricsRegistry`` of the counters
        (``trainer.steps_total``, ``examples_total``, ``nonfinite_total``,
        ``skipped_total``, ``preemptions_total``); a fresh one by default.
      mesh: a ``parallel`` mesh -> the data-parallel step over its
        ``data`` axis (module docstring); the step runs on the mesh's
        device.
      layout: a ``parallel.SpecLayout`` (or ``ShardingRules``): params and
        optimizer slots stored sharded over the mesh (fsdp/tp); with no
        ``mesh`` the enclosing ``parallel.use_mesh`` mesh, else ValueError.
    """

    def __init__(self, loss_fn: Callable, optimizer, *,
                 device: DeviceLike = None, mesh=None, layout=None,
                 outputs_fn: Optional[Callable] = None,
                 evaluators=None, output_dir: Optional[str] = None,
                 prefetch: int = 2, log_period: int = 0,
                 param_stats_period: int = 0, nan_guard: bool = True,
                 on_nonfinite: Optional[str] = None,
                 prefetch_timeout: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if layout is not None and mesh is None:
            from ..parallel.mesh import current_mesh
            mesh = current_mesh()
            if mesh is None:
                raise ValueError("Trainer(layout=...) needs mesh=... or an "
                                 "enclosing parallel.use_mesh(...)")
        self.mesh, self.layout = mesh, layout
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.device = require_device(mesh.device if mesh is not None and
                                     device is None else device)
        self.graphs = GraphCache("Trainer", self.device)
        self.outputs_fn = outputs_fn
        if evaluators is None:
            self.evaluators = EvaluatorGroup()
        elif isinstance(evaluators, EvaluatorGroup):
            self.evaluators = evaluators
        else:
            self.evaluators = EvaluatorGroup(*evaluators)
        self.output_dir = output_dir
        self.prefetch = prefetch
        self.log_period = log_period
        if param_stats_period == 0:
            from ..utils.flags import FLAGS
            param_stats_period = FLAGS.show_parameter_stats_period
        self.param_stats_period = param_stats_period
        if on_nonfinite is None:
            on_nonfinite = "raise" if nan_guard else "off"
        if on_nonfinite not in _NONFINITE_POLICIES:
            raise ValueError(f"on_nonfinite must be one of "
                             f"{_NONFINITE_POLICIES}, got {on_nonfinite!r}")
        self.on_nonfinite = on_nonfinite
        self.nan_guard = on_nonfinite != "off"
        # skip and halt both drop a non-finite batch's update inside the
        # step: skip to go on from the last finite state, halt to
        # checkpoint it
        self._guard = on_nonfinite in ("skip", "halt")
        self._dp = None
        if mesh is not None:
            from ..parallel.data_parallel import DataParallel
            self._dp = DataParallel(loss_fn, optimizer, mesh=mesh,
                                    param_rules=layout, aux_fn=outputs_fn)
        self.prefetch_timeout = prefetch_timeout
        self.stats = StatSet()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.train_stats: Mapping = _TrainStatsView(self.metrics)
        self._c_steps = self.metrics.counter("trainer.steps_total")
        self._c_examples = self.metrics.counter("trainer.examples_total")
        self._preempt = threading.Event()
        self.preempted = False

    # ------------------------------------------------------------------ step
    def step(self, params: Mapping, opt_state: Dict[str, Any], *batch):
        """One step: loss and gradients of ``params``, then the update.
        Returns (new params, new opt_state, loss), and the outputs dict
        last with an ``outputs_fn``.

        ``params`` and ``opt_state`` are donated, as in JAX. The trees a
        step returns are the trainer's own, updated in place: passing them
        back to the next step copies nothing, and that step writes them
        again (take a copy to keep one). Trees the trainer does not own
        (a model's ``tree()``, a fresh ``opt.init``) are copied in first
        and never written.

        On a mesh the step is ``DataParallel.step`` (module docstring):
        ``params`` and ``opt_state`` are the placed trees ``DataParallel.
        init`` made, the batch the global one, and new trees come back."""
        if self._dp is not None:
            return self._dp.step(params, opt_state,
                                 *self._dp.shard_batch(batch))
        batch, gens = _split_generators(batch)
        return self.graphs.run(
            "step", self._step_body,
            {"params": params, "opt_state": opt_state, "batch": batch},
            static=gens, donate=("params", "opt_state"),
            cost="trainer.step")

    def _step_body(self, params, opt_state, batch, **gens):
        """The step program: value and gradient of the loss with respect to
        the leaves of ``params`` and ``outputs_fn`` on them, then the
        optimizer's ``apply_`` into ``params`` and ``opt_state`` and the
        stat updates into ``params``, each write guarded by the loss's
        finiteness under skip/halt. Returns (params, opt_state, loss[,
        outputs])."""
        items = [(path, leaf.detach().requires_grad_(True))
                 for path, leaf in tree_items(params)]
        leaves = tree_from_items(items)
        args = _join_generators(batch, gens)
        with _sharing():
            loss, stats = _loss_and_stats(self.loss_fn(leaves, *args))
            outs = None
            if self.outputs_fn is not None:
                with torch.no_grad():
                    outs = _detached(self.outputs_fn(leaves, *args))
            grads = torch.autograd.grad(loss, [leaf for _, leaf in items],
                                        materialize_grads=True)
        grads = tree_from_items((path, g.to(torch.float32))
                                for (path, _), g in zip(items, grads))
        ok = torch.isfinite(loss.detach()) if self._guard else None
        self.opt.apply_(grads, opt_state, params, ok=ok)
        if stats:
            apply_stat_updates_(params, stats, ok=ok)
        if outs is not None:
            return params, opt_state, loss.detach(), outs
        return params, opt_state, loss.detach()

    # ------------------------------------------------------------ host side
    def _log_param_stats(self, params):
        """Per-parameter magnitudes (--show_parameter_stats_period)."""
        for path, value in tree_items(params):
            a = value.detach().float().abs().cpu()
            log.info("param %-40s shape=%-16s absmax=%.4e absmean=%.4e",
                     "/".join(path), str(tuple(a.shape)),
                     float(a.max()) if a.numel() else 0.0,
                     float(a.mean()) if a.numel() else 0.0)

    def request_preemption(self):
        """Ask the train loop to checkpoint and exit after the current batch
        — what the SIGTERM/SIGINT handlers call; safe from any thread."""
        self._preempt.set()

    def _install_preemption_handlers(self):
        """SIGTERM/SIGINT -> checkpoint-then-exit; a second SIGINT raises
        KeyboardInterrupt (a step that hangs never reaches the check
        between batches). Returns the previous handlers; nothing off the
        main thread."""

        def handler(signum, frame):
            if signum == signal.SIGINT and self._preempt.is_set():
                raise KeyboardInterrupt
            self.request_preemption()

        prev = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev[sig] = signal.signal(sig, handler)
        except ValueError:
            pass
        return prev

    def _save(self, pass_id, params, opt_state, extra=None) -> None:
        """A checkpoint of the trees; on a mesh every rank gathers the
        global tensors and the mesh's first rank writes them."""
        if self._dp is None:
            save_checkpoint(self.output_dir, pass_id, params, opt_state,
                            extra=extra)
            return
        from ..parallel import collectives
        from ..parallel.sharding import tree_to_global
        params, opt_state = tree_to_global(params), tree_to_global(opt_state)
        if self.mesh.rank == int(self.mesh.devices.flat[0]):
            save_checkpoint(self.output_dir, pass_id, params, opt_state,
                            extra=extra)
        # every rank leaves once the checkpoint is published (a resume on
        # any rank reads it)
        with self.mesh:
            collectives.all_reduce(torch.zeros((), device=self.device),
                                   self.mesh.axis_names)

    def _mirror(self, name: str, n: float = 1) -> None:
        """Mirror a count into the installed obs session — unless the
        session shares this trainer's registry, where mirroring would
        double-count."""
        s = obs.session()
        if s is not None and s.registry is not self.metrics:
            s.registry.counter(name).inc(n)

    def _count(self, name: str, n: float = 1) -> None:
        """Robustness counter: the trainer's own registry is the always-on
        source of truth (train_stats view); the session gets a mirror so
        exports include it."""
        self.metrics.counter(name).inc(n)
        self._mirror(name, n)

    def _checkpoint_preempted(self, pass_id, batch_id, params, opt_state):
        # the flight ring first (no-op unless armed): if the checkpoint
        # write itself dies, the post-mortem still shows the final batches
        obs.flight_dump("preemption")
        if self.output_dir:
            with obs.span("trainer.checkpoint", pass_id=pass_id,
                          reason="preemption"):
                self._save(pass_id, params, opt_state,
                           extra={"pass_complete": False,
                                  "batch_id": batch_id})
            log.warning("preempted at pass %d batch %d: checkpoint saved; "
                        "resume re-runs this pass", pass_id, batch_id)
        else:
            log.warning("preempted at pass %d batch %d with no output_dir: "
                        "nothing durable to save", pass_id, batch_id)
        self._count("trainer.preemptions_total")
        self.preempted = True

    def _handle_nonfinite(self, cost_f, pass_id, batch_id, params,
                          opt_state):
        self._count("trainer.nonfinite_total")
        if self.on_nonfinite == "skip":
            # the step's guard already dropped the update
            self._count("trainer.skipped_total")
            log.warning("non-finite loss %s at pass %d batch %d: batch "
                        "skipped (%d skipped so far)", cost_f, pass_id,
                        batch_id, self.train_stats["skipped_batches"])
            return
        if self.on_nonfinite == "halt" and self.output_dir:
            # the trees hold the last finite state (the guard dropped the
            # update): durable first, then fail
            with obs.span("trainer.checkpoint", pass_id=pass_id,
                          reason="halt"):
                self._save(pass_id, params, opt_state,
                           extra={"pass_complete": False,
                                  "batch_id": batch_id, "halted": True})
            log.error("non-finite loss at pass %d batch %d: state "
                      "checkpointed before halting", pass_id, batch_id)
        raise FloatingPointError(
            f"non-finite loss {cost_f} at pass {pass_id} batch "
            f"{batch_id}; re-run with torch.autograd.set_detect_anomaly"
            f"(True) on the eager route (core.graphs.disabled()) to "
            f"locate the producing op")

    def train(self, reader: Callable[[], Iterable], params: Mapping, *,
              num_passes: int = 1, event_handler: Optional[Callable] = None,
              feeder: Optional[Callable] = None,
              test_reader: Optional[Callable] = None,
              resume: bool = False, checkpoint_every: int = 1,
              handle_signals: bool = True):
        """Run the pass/batch loop; returns (params, opt_state), copies of
        the trees the last step wrote, so that a later call writes neither
        them nor ``params``.

        ``reader`` yields raw row-batches; ``feeder`` converts one to the
        loss_fn's batch tensors (on its thread: the ``DoubleBuffer``
        worker), identity if None. ``resume=True`` restarts from the
        newest verifiable checkpoint; a pass checkpointed as incomplete
        (preemption, halt) resumes at its next batch by slicing the raw
        reader, so with a deterministic reader the continuation equals an
        uninterrupted run bit for bit. ``checkpoint_every=N`` saves every
        Nth pass (the last pass always saves; preemption ignores the
        cadence). ``handle_signals`` installs the SIGTERM/SIGINT
        checkpoint-then-exit handlers for the call (main thread only).
        ``EndIteration`` carries the batch's cost as a float (reading it
        waits for the step) and the evaluators' result."""
        event_handler = event_handler or (lambda e: None)
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        start_pass = 0
        skip_batches = 0
        opt_state = None
        self.preempted = False
        self._preempt.clear()
        if resume and self.output_dir:
            try:
                params, opt_state, st = load_checkpoint(
                    self.output_dir, device=self.device)
            except FileNotFoundError:
                st = None
                log.info("resume requested but no verifiable checkpoint "
                         "under %s; starting fresh", self.output_dir)
            if st is not None and st.get("pass_complete", True):
                start_pass = st["pass_id"] + 1
                log.info("resumed from completed pass %d", st["pass_id"])
            elif st is not None:
                # the checkpoint holds the state after batch_id
                start_pass = st["pass_id"]
                skip_batches = st.get("batch_id", -1) + 1
                log.info("resumed preempted pass %d at batch %d",
                         st["pass_id"], skip_batches)
        if self._dp is not None:
            params, opt_state = self._dp.init(params, opt_state)
        elif opt_state is None:
            opt_state = self.opt.init(params)

        prev_handlers = (self._install_preemption_handlers()
                         if handle_signals else {})
        # goodput ledger (None when the obs plane is off): splits this
        # call's wall time into compile / host_input / device / host_sync
        # / idle — goodput.*_seconds_total + the goodput.ratio gauge
        gp = obs.goodput.open_ledger("trainer")
        try:
            last_pass = start_pass + num_passes - 1
            for pass_id in range(start_pass, start_pass + num_passes):
              # pass-scoped trace span: reader pulls, checkpoint saves and
              # every step nest under it on this thread
              with obs.span("trainer.pass", pass_id=pass_id):
                event_handler(EV.BeginPass(pass_id))
                self.evaluators.start()
                first_batch = skip_batches if pass_id == start_pass else 0
                batches = self._batches(reader, feeder, skip=first_batch)
                if gp is not None:
                    batches = _timed_input(batches, gp)
                for batch_id, batch in enumerate(batches, start=first_batch):
                    event_handler(EV.BeginIteration(pass_id, batch_id))
                    # mesh path: the guard reverts on the host
                    prev = (params, opt_state)
                    with obs.span("trainer.step",
                                  metric="trainer.step_seconds"):
                        with self.stats.timer("TrainBatch"), \
                                obs.span("trainer.device_step"), \
                                maybe_bucket(gp, "device"):
                            res = self.step(params, opt_state, *batch)
                            if gp is not None and \
                                    self.device.type == "cuda":
                                # the step's device time surfaces at the
                                # first host wait: put that wait here,
                                # not in the loss read below
                                torch.cuda.synchronize(self.device)
                        if self.outputs_fn is not None:
                            params, opt_state, cost, outs = res
                        else:
                            params, opt_state, cost = res
                            outs = None
                        with obs.span("trainer.host_sync",
                                      metric="trainer.sync_seconds"), \
                                maybe_bucket(gp, "host_sync"):
                            cost_f = faults.filter_value("step.grad",
                                                         float(cost))
                    self._c_steps.inc()
                    self._mirror("trainer.steps_total")
                    lead = (getattr(batch[0], "shape", None)
                            if isinstance(batch, (tuple, list)) and batch
                            else None)
                    if lead:
                        self._c_examples.inc(lead[0])
                        self._mirror("trainer.examples_total", lead[0])
                    if self.nan_guard and not np.isfinite(cost_f):
                        if self._guard and self._dp is not None:
                            params, opt_state = prev
                        self._handle_nonfinite(cost_f, pass_id, batch_id,
                                               params, opt_state)
                        event_handler(EV.EndIteration(pass_id, batch_id,
                                                      cost_f, None))
                        if self._preempt.is_set():
                            self._checkpoint_preempted(pass_id, batch_id,
                                                       params, opt_state)
                            return self._copies(params, opt_state)
                        continue
                    ev_result = None
                    if outs is not None:
                        with self.stats.timer("Eval"):
                            self.evaluators.update(cost=cost_f, **outs)
                            ev_result = self.evaluators.result()
                    if (self.log_period
                            and (batch_id + 1) % self.log_period == 0):
                        log.info("pass %d batch %d cost %.6f", pass_id,
                                 batch_id, cost_f)
                    if (self.param_stats_period and
                            (batch_id + 1) % self.param_stats_period == 0):
                        self._log_param_stats(params)
                    event_handler(EV.EndIteration(pass_id, batch_id, cost_f,
                                                  ev_result))
                    if self._preempt.is_set():
                        self._checkpoint_preempted(pass_id, batch_id,
                                                   params, opt_state)
                        return self._copies(params, opt_state)
                pass_result = (self.evaluators.result()
                               if self.outputs_fn is not None else None)
                if test_reader is not None:
                    tr = self.test(test_reader, params, feeder=feeder)
                    event_handler(EV.TestResult(pass_id, tr["cost"],
                                                tr.get("evaluator_result")))
                if self.output_dir and (
                        (pass_id - start_pass + 1) % checkpoint_every == 0
                        or pass_id == last_pass):
                    with obs.span("trainer.checkpoint", pass_id=pass_id,
                                  reason="pass_end"):
                        self._save(pass_id, params, opt_state)
                event_handler(EV.EndPass(pass_id, pass_result))
        finally:
            if gp is not None:
                gp.close()
            for sig, handler in prev_handlers.items():
                try:
                    signal.signal(sig, handler)
                except (ValueError, TypeError):
                    pass
        return self._copies(params, opt_state)

    def _copies(self, params, opt_state):
        if self._dp is not None:        # the mesh step's trees are new
            return params, opt_state
        return tree_map(torch.clone, params), tree_map(torch.clone,
                                                       opt_state)

    def _batches(self, reader, feeder, skip: int = 0):
        if skip:
            # resume: slice the raw reader, before the feeder converts
            raw, reader = reader, (lambda: itertools.islice(raw(), skip,
                                                            None))
        if feeder is None and self.prefetch_timeout is None:
            return iter(reader())
        # a feeder runs on the prefetch thread; a prefetch_timeout needs
        # that thread to watch
        return iter(DoubleBuffer(reader, depth=self.prefetch,
                                 transform=feeder,
                                 timeout=self.prefetch_timeout))

    # ---------------------------------------------------------------- summary
    def summary(self) -> str:
        """Operator-facing report: the trainer's typed counters plus
        immutable :class:`~paddle_tpu_torch.utils.stats.StatSnapshot` rows
        — ``obs.summary`` subsumes the old ``StatSet.report()`` table."""
        return obs.summary({"metrics": self.metrics.collect()},
                           stats=self.stats.items().values())

    # ------------------------------------------------------------------- test
    def test(self, reader: Callable[[], Iterable], params: Mapping, *,
             feeder: Optional[Callable] = None) -> Dict[str, Any]:
        """Average cost over a test reader (and the evaluators' result
        with an ``outputs_fn``), with gradients off (so the LSTM runs its
        inference kernel); each batch is one graph per batch signature on
        the card."""
        total, n = 0.0, 0
        self.evaluators.start()
        if self._dp is not None:
            # every rank the whole batch on the gathered parameters
            from ..parallel.sharding import tree_to_global
            params = tree_to_global(params)
        for batch in self._batches(reader, feeder):
            batch, gens = _split_generators(tuple(batch))
            if self._dp is not None:
                res = self._loss_body(params, batch, **gens)
            else:
                res = self.graphs.run("loss", self._loss_body,
                                      {"params": params, "batch": batch},
                                      static=gens)
            cost, outs = res if self.outputs_fn is not None else (res, None)
            cost_f = float(cost)
            total += cost_f
            n += 1
            if outs is not None:
                self.evaluators.update(cost=cost_f, **outs)
        out: Dict[str, Any] = {"cost": total / max(n, 1)}
        if self.outputs_fn is not None:
            out["evaluator_result"] = self.evaluators.result()
        return out

    @torch.no_grad()
    def _loss_body(self, params, batch, **gens):
        """The test program: the loss (and ``outputs_fn``) of a batch."""
        args = _join_generators(batch, gens)
        with _sharing():
            loss = _loss_and_stats(self.loss_fn(params, *args))[0]
            if self.outputs_fn is None:
                return loss
            return loss, dict(self.outputs_fn(params, *args))

    # -------------------------------------------------------------- checkgrad
    def check_gradient(self, params: Mapping, batch: Tuple, *,
                       eps: float = 1e-3, rtol: float = 5e-2,
                       max_checks_per_param: int = 5, seed: int = 0) -> bool:
        """Central-difference gradient check (--job=checkgrad) in float64
        on host copies of ``params`` and ``batch``: the loss runs on the
        CPU, so through the kernels' plain versions (the kernels take f32
        and bf16 only). True when analytic and numeric agree."""
        if self._dp is not None:
            from ..parallel.sharding import tree_to_global
            params = tree_to_global(params)
        params64 = _host64(params)
        batch64 = _host64(tuple(batch))
        items = [(path, leaf.requires_grad_(True)) if
                 leaf.is_floating_point() else (path, leaf)
                 for path, leaf in tree_items(params64)]
        tree = tree_from_items(items)
        loss = _loss_and_stats(self.loss_fn(tree, *batch64))[0]
        diff = [leaf for _, leaf in items if leaf.requires_grad]
        grads = iter(torch.autograd.grad(loss, diff, allow_unused=True,
                                         materialize_grads=True))
        rs = np.random.RandomState(seed)
        ok = True
        with torch.no_grad():
            for li, (path, p) in enumerate(items):
                if not p.requires_grad:
                    continue
                g_flat = next(grads).reshape(-1).numpy()
                host = p.detach().clone()
                flat = host.reshape(-1)
                n_checks = min(max_checks_per_param, flat.numel())
                for idx in rs.choice(flat.numel(), size=n_checks,
                                     replace=False):
                    orig = float(flat[idx])
                    vals = {}
                    for sign in (+1, -1):
                        flat[idx] = orig + sign * eps
                        probe = tree_from_items(
                            (q, host if q == path else leaf.detach())
                            for q, leaf in items)
                        vals[sign] = float(_loss_and_stats(
                            self.loss_fn(probe, *batch64))[0])
                    flat[idx] = orig
                    numeric = (vals[+1] - vals[-1]) / (2 * eps)
                    analytic = float(g_flat[idx])
                    denom = max(abs(numeric), abs(analytic), 1e-6)
                    if abs(numeric - analytic) / denom > rtol:
                        log.warning("checkgrad mismatch leaf %d (%s) idx "
                                    "%d: numeric %.6g analytic %.6g", li,
                                    "/".join(path), idx, numeric, analytic)
                        ok = False
        return ok

    # ------------------------------------------------------------------- time
    def benchmark(self, reader: Callable[[], Iterable], params: Mapping, *,
                  feeder: Optional[Callable] = None, warmup: int = 3,
                  iters: int = 20,
                  profile_dir: Optional[str] = None) -> Dict[str, float]:
        """--job=time: steady-state ms a batch over ``iters`` steps after
        ``warmup``. ``profile_dir`` wraps the timed loop in
        ``torch.profiler`` and writes its Chrome trace there (where JAX
        writes an XLA trace)."""
        if self._dp is not None:
            params, opt_state = self._dp.init(params)
        else:
            opt_state = self.opt.init(params)
        batches = list(self._batches(reader, feeder))
        if not batches:
            raise ValueError("empty reader")

        def sync():
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        i = 0
        for _ in range(warmup):
            res = self.step(params, opt_state, *batches[i % len(batches)])
            params, opt_state = res[0], res[1]
            i += 1
        sync()
        prof = contextlib.nullcontext()
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.device.type == "cuda"
                else [])
            prof = profile(activities=acts)
        with prof as p:
            t0 = time.perf_counter()
            for _ in range(iters):
                with self.stats.timer("BenchBatch"):
                    res = self.step(params, opt_state,
                                    *batches[i % len(batches)])
                    params, opt_state = res[0], res[1]
                i += 1
            sync()
            ms = (time.perf_counter() - t0) / iters * 1e3
        if profile_dir:
            import os
            os.makedirs(profile_dir, exist_ok=True)
            p.export_chrome_trace(os.path.join(profile_dir,
                                               "trainer_benchmark.json"))
        return {"ms_per_batch": ms}
