"""Elastic data-parallel training — workers join, leave, and die mid-pass;
the counterpart of ``paddle_tpu/trainer/elastic.py``.

Elasticity comes from the data plane, as in JAX: the master splits every
global batch into ``shards_per_step`` fixed shard tasks served through
the native :class:`~paddle_tpu_torch.runtime.master.TaskMaster` queue;
workers under a membership heartbeat lease pull shard tasks
(``ela_task``), compute the shard's loss and gradients, and push them
back (``ela_grad``), fenced by member token and membership epoch; the
master reduces the shard gradients in shard-index order and applies one
optimizer update, so the parameter trajectory is byte-stable whatever
the membership: which workers computed which shards, joins, leaves and
``kill -9``s mid-pass. The wire is JAX's: packed trees (the checkpoint
tar, CRC'd ``.npy`` members) and packed arrays (``np.savez``), with the
op names ``ela_task``, ``ela_grad``, ``ela_state`` and ``ela_status``, so
a worker of either package can serve a master of the other.

On the card:

* the canonical parameters and the optimizer slots live on the master's
  ``device``; the one update (JAX's ``jax.jit`` of ``optimizer.update``)
  is one CUDA graph (``core/graphs.py``): the optimizer's ``apply_``
  written in place into the trees the graph carries;
* a worker's loss and gradients (JAX's ``jax.jit(jax.value_and_grad)``)
  are one CUDA graph per shard signature on the worker's ``device``, the
  backward through the port's kernels (the LSTM's #9 and #10);
* the shard-ordered reduce runs on the host in f32 numpy, the ops and the
  order of JAX's, then the sum goes to the device for the update.

Several workers and the master may share one card (threads on
``cuda:0``): their graph captures take ``core.graphs``' capture lock in
turn. Master restarts resume from the crash-safe snapshot
(``trainer/checkpoint.py``) at the snapshotted step.

Not here: JAX's ``mesh=``/``layout=`` (each worker's gradient on its own
local mesh). The port's mesh is a ``torch.distributed`` world, and an
elastic worker that is itself a multi-process world waits (ROADMAP
A.8b); both classes refuse the arguments.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import faults, obs
from ..core.graphs import GraphCache
from ..core.place import require_device
from ..core.pytree import tree_from_items, tree_items, tree_map
from ..runtime.master_service import (CODE_STALE_EPOCH, CODE_STALE_STEP,
                                      MasterServer, StaleMemberError)
from ..runtime.membership import (MembershipClient, MembershipService,
                                  HeartbeatKeeper, _err)
from ..utils.logging import get_logger
from .checkpoint import from_tar, latest_pass, load_checkpoint, \
    save_checkpoint, to_tar

log = get_logger(__name__)


class _Stopped(Exception):
    """Internal: the master was stop()ed while a step was collecting."""


# -- wire encoding ---------------------------------------------------------------

def _pack_tree(tree) -> str:
    """pytree -> base64 tar (CRC'd .npy members — the checkpoint format,
    so gather-on-save semantics and structure round-tripping are shared
    with trainer/checkpoint.py)."""
    buf = io.BytesIO()
    to_tar(buf, tree)
    return base64.b64encode(buf.getvalue()).decode()


def _unpack_tree(data: str, device="cpu"):
    return from_tar(io.BytesIO(base64.b64decode(data)), device=device)


def _pack_arrays(arrays: Sequence[np.ndarray]) -> str:
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": np.asarray(a) for i, a in enumerate(arrays)})
    return base64.b64encode(buf.getvalue()).decode()


def _unpack_arrays(data: str) -> List[np.ndarray]:
    z = np.load(io.BytesIO(base64.b64decode(data)), allow_pickle=False)
    return [z[f"a{i}"] for i in range(len(z.files))]


def _no_mesh(mesh, layout) -> None:
    if mesh is not None or layout is not None:
        raise NotImplementedError(
            "elastic mesh=/layout=: the port's mesh is a torch.distributed "
            "world, and an elastic worker or master that is itself such a "
            "world waits (ROADMAP A.8b); train on one device a process")


def _on_device(tree, device: torch.device):
    """A tree of tensors (or numpy arrays) as fresh tensors on ``device``."""
    def put(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(device, copy=True)
        return torch.tensor(np.asarray(x), device=device)
    return tree_map(put, tree)


def _host_f32(tree):
    """A tree of tensors as f32 numpy arrays (JAX's ``np.asarray(x,
    np.float32)`` of each leaf)."""
    return tree_map(lambda x: np.asarray(x.detach().cpu().numpy()
                                         if isinstance(x, torch.Tensor)
                                         else x, np.float32), tree)


def reduce_shards(grads: Sequence[Any], rows: Sequence[int], n_rows: int):
    """The master's reduce: ``sum_j grads[j] * rows[j] / n_rows`` over the
    shards in index order, each leaf in f32 numpy — the ops and the order
    of JAX's ``ElasticMaster._run_step``, so the sum depends on neither the
    completion order nor the fleet."""
    weights = [r / n_rows for r in rows]
    acc = None
    for j, g in enumerate(grads):
        g = _host_f32(g)
        acc = (tree_map(lambda x, w=weights[j]: x * w, g) if acc is None
               else tree_map(lambda a, x, w=weights[j]: a + x * w, acc, g))
    return acc


def loss_and_grads(loss_fn: Callable, params, *batch):
    """A worker's shard computation (JAX's ``value_and_grad``): the loss of
    ``params`` on ``batch`` and its gradient with respect to every leaf,
    in f32. The body of the worker's graph."""
    items = [(path, leaf.detach().requires_grad_(True))
             for path, leaf in tree_items(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_from_items(items), *batch)
        grads = torch.autograd.grad(loss, [leaf for _, leaf in items],
                                    materialize_grads=True)
    return loss.detach(), tree_from_items(
        (path, g.to(torch.float32)) for (path, _), g in zip(items, grads))


# -- master ----------------------------------------------------------------------

class ElasticMaster:
    """The elastic training master: membership + shard dispatch + the one
    optimizer update.

    Args:
      loss_fn: ``(params, *batch) -> scalar`` mean loss over ITS rows.
      optimizer: a :mod:`paddle_tpu_torch.optimizer` optimizer (Adam slots
        ride the canonical state here).
      shards_per_step: the fixed shard count every global batch splits
        into — the elasticity quantum. Deliberately NOT tied to the
        worker count: byte-stability of the reduce requires the shard
        partition to be membership-independent.
      ttl: membership heartbeat lease (workers heartbeat at ttl/3;
        eviction after ttl).
      task_timeout_s / failure_max: TaskMaster re-dispatch knobs. The
        elastic default failure_max is high — a shard requeued off dead
        workers must never be *discarded* (that would wedge the step).
      mesh/layout: JAX's local mesh placement; refused here (module
        docstring).
      snapshot_dir: crash-safe state home. When set, every
        ``snapshot_every_steps`` the (params, opt_state, pass, step,
        membership epoch) publish under the checkpoint CRC protocol and a
        restarted master resumes the same pass at the same step.
      on_step: ``fn(pass_id, step, loss)`` after each applied update
        (tests use it to inject chaos at exact step boundaries).
      device: where the canonical state lives and the update runs
        (default: the card).
    """

    def __init__(self, loss_fn: Callable, optimizer, *,
                 host: str = "127.0.0.1", port: int = 0,
                 shards_per_step: int = 4, min_workers: int = 1,
                 ttl: float = 5.0, task_timeout_s: float = 5.0,
                 failure_max: int = 100, tick_interval: float = 0.25,
                 mesh=None, layout=None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every_steps: int = 1,
                 on_step: Optional[Callable[[int, int, float], None]] = None,
                 device=None):
        _no_mesh(mesh, layout)
        self.device = require_device(device)
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.shards_per_step = int(shards_per_step)
        if self.shards_per_step < 1:
            raise ValueError("shards_per_step must be >= 1")
        self.min_workers = min_workers
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = max(int(snapshot_every_steps), 1)
        self.on_step = on_step
        self.server = MasterServer(host, port, timeout_s=task_timeout_s,
                                   failure_max=failure_max,
                                   tick_interval=tick_interval)
        self.membership = MembershipService(ttl=ttl)
        self.membership.attach(self.server)
        self.membership.subscribe(self._on_membership_change)
        self.server.register_op("ela_task", self._op_task)
        self.server.register_op("ela_grad", self._op_grad)
        self.server.register_op("ela_state", self._op_state)
        self.server.register_op("ela_status", self._op_status)
        # the one update, one CUDA graph: the optimizer's apply_ into the
        # canonical trees the graph carries (donated)
        self.graphs = GraphCache("trainer.ElasticMaster", self.device)
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._params = None
        self._opt_state = None
        self._pass = 0
        self._step = 0
        self._done = False
        self._stopped = threading.Event()
        # current step's collection state
        self._pending: Optional[Tuple[int, int]] = None   # (pass, step)
        self._shard_rows: List[int] = []
        self._grads: Dict[int, Any] = {}
        self._losses: Dict[int, float] = {}
        self._assigned: Dict[int, str] = {}               # task id -> worker
        self._state_blob: Optional[str] = None

    # -- lifecycle ---------------------------------------------------------
    @property
    def address(self) -> Tuple[str, int]:
        return self.server.address

    def start(self) -> "ElasticMaster":
        if self.snapshot_dir and latest_pass(self.snapshot_dir) is not None:
            params, opt_state, st = load_checkpoint(self.snapshot_dir,
                                                    device=self.device)
            self._params = self._place(params)
            self._opt_state = self._place_opt(opt_state)
            self._pass = int(st.get("pass_id", 0))
            self._step = int(st.get("elastic_step", -1)) + 1
            if st.get("pass_complete"):
                self._pass += 1
                self._step = 0
            self.membership.epoch = int(st.get("membership_epoch", 0))
            log.info("elastic master restored: resuming pass %d step %d "
                     "(membership epoch %d)", self._pass, self._step,
                     self.membership.epoch)
            self._publish_state()
        self.server.start()
        self.membership.start()
        return self

    def stop(self, drain_s: float = 0.0) -> None:
        """Tear the server down. ``drain_s`` > 0 first gives live members
        that window to observe the done signal and leave gracefully
        (``ela_task`` keeps answering ``done: True`` meanwhile) — without
        it a worker polling at the wrong moment sees a severed connection
        instead of completion and exits through its lost-membership path.
        Returns early as soon as the member table empties; a dead-but-not-
        yet-evicted member bounds the wait at min(ttl, drain_s)."""
        if drain_s > 0:
            deadline = time.monotonic() + drain_s
            while time.monotonic() < deadline and self.membership.members():
                self.membership.expire()
                time.sleep(0.05)
        self._stopped.set()
        with self._cv:
            self._cv.notify_all()
        self.membership.stop()
        self.server.stop()

    # -- placement ---------------------------------------------------------
    def _place(self, params):
        return _on_device(params, self.device)

    def _place_opt(self, opt_state):
        if opt_state is None:
            return None
        return _on_device(opt_state, self.device)

    def _update_body(self, grads, opt_state, params):
        self.opt.apply_(grads, opt_state, params)
        return params, opt_state

    # -- the training loop -------------------------------------------------
    def fit(self, batches: Sequence[Tuple], params=None, *,
            num_passes: int = 1, max_steps: Optional[int] = None,
            progress_timeout: float = 120.0) -> Tuple[Any, Any, float]:
        """Drive ``num_passes`` over ``batches`` (a list of global-batch
        tuples of host arrays); returns (params, opt_state, last_loss).

        ``max_steps`` bounds the number of applied updates THIS call (the
        rolling-restart tests stop a master mid-pass at an exact step
        boundary; the successor's ``fit`` resumes from the snapshot).
        ``progress_timeout`` bounds the wait for ANY shard gradient — a
        fleet that died entirely surfaces as a TimeoutError carrying the
        queue state, not a silent hang.
        """
        with self._mu:
            if self._params is None:
                if params is None:
                    raise ValueError("no restored state: fit() needs params")
                self._params = self._place(params)
                self._opt_state = self._place_opt(self.opt.init(self._params))
            self._done = False
            self._publish_state_locked()
        self._wait_workers(progress_timeout)
        last_loss = float("nan")
        applied = 0
        total_passes = self._pass + num_passes
        while self._pass < total_passes and not self._stopped.is_set():
            pass_id = self._pass
            for step in range(self._step, len(batches)):
                if max_steps is not None and applied >= max_steps:
                    return self._params, self._opt_state, last_loss
                if self._stopped.is_set():
                    return self._params, self._opt_state, last_loss
                try:
                    last_loss = self._run_step(pass_id, step, batches[step],
                                               progress_timeout)
                except _Stopped:
                    return self._params, self._opt_state, last_loss
                applied += 1
                if self.on_step is not None:
                    self.on_step(pass_id, step, last_loss)
            with self._mu:
                self._pass += 1
                self._step = 0
            if self.snapshot_dir:
                self._snapshot(pass_id, len(batches) - 1, complete=True)
            log.info("elastic pass %d complete (loss %.6f, epoch %d)",
                     pass_id, last_loss, self.membership.epoch)
        with self._cv:
            self._done = True
            self._cv.notify_all()
        return self._params, self._opt_state, last_loss

    def status(self) -> Dict[str, Any]:
        with self._mu:
            todo, pending, done, disc, _ = self.server.master.stats()
            return {"pass": self._pass, "step": self._step,
                    "epoch": self.membership.epoch, "done": self._done,
                    "members": len(self.membership.members()),
                    "todo": todo, "pending": pending, "discarded": disc}

    # -- internals ---------------------------------------------------------
    def _wait_workers(self, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while len(self.membership.members()) < self.min_workers:
            if self._stopped.is_set():
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{len(self.membership.members())} worker(s) joined "
                    f"within {timeout}s; min_workers={self.min_workers}")
            time.sleep(0.02)

    def _shard_bounds(self, n_rows: int) -> List[Tuple[int, int]]:
        """Fixed, membership-independent contiguous row partition."""
        S = min(self.shards_per_step, n_rows) or 1
        base, rem = divmod(n_rows, S)
        bounds, lo = [], 0
        for j in range(S):
            hi = lo + base + (1 if j < rem else 0)
            bounds.append((lo, hi))
            lo = hi
        return bounds

    def _run_step(self, pass_id: int, step: int, batch: Tuple,
                  progress_timeout: float) -> float:
        arrays = [np.asarray(a) for a in batch]
        n_rows = int(arrays[0].shape[0])
        bounds = self._shard_bounds(n_rows)
        payloads = []
        for j, (lo, hi) in enumerate(bounds):
            payloads.append(json.dumps({
                "pass": pass_id, "step": step, "shard": j,
                "n_shards": len(bounds), "rows": hi - lo,
                "global_rows": n_rows,
                "batch": _pack_arrays([a[lo:hi] for a in arrays])}))
        with self._cv:
            self._pending = (pass_id, step)
            self._shard_rows = [hi - lo for lo, hi in bounds]
            self._grads = {}
            self._losses = {}
            self._assigned.clear()
            self.server.master.set_dataset(payloads)
            last_n = 0
            deadline = time.monotonic() + progress_timeout
            while len(self._grads) < len(bounds):
                if self._stopped.is_set():
                    raise _Stopped()
                self._cv.wait(timeout=0.05)
                if len(self._grads) > last_n:
                    last_n = len(self._grads)
                    deadline = time.monotonic() + progress_timeout
                elif time.monotonic() > deadline:
                    st = self.server.master.stats()
                    raise TimeoutError(
                        f"no shard progress within {progress_timeout}s at "
                        f"pass {pass_id} step {step} "
                        f"({last_n}/{len(bounds)} shards, queue "
                        f"todo/pending/done/discarded={st[:4]}, "
                        f"{len(self.membership.members())} live member(s))")
            grads = dict(self._grads)
            losses = dict(self._losses)
            self._pending = None
        # reduce in shard-index order — THE byte-stability invariant: the
        # float sum must not depend on completion order or fleet shape
        weights = [r / n_rows for r in self._shard_rows]
        acc = reduce_shards([grads[j] for j in range(len(bounds))],
                            self._shard_rows, n_rows)
        acc = _on_device(acc, self.device)
        # the update writes the canonical trees in place: under the lock,
        # so an ela_state fetch never packs a half-written tree
        with self._mu:
            self._params, self._opt_state = self.graphs.run(
                "update", self._update_body,
                {"grads": acc, "opt_state": self._opt_state,
                 "params": self._params}, donate=("opt_state", "params"))
            self._step = step + 1
            self._publish_state_locked()
        if self.snapshot_dir and (step + 1) % self.snapshot_every == 0:
            self._snapshot(pass_id, step, complete=False)
        # step loss: shard-weighted mean of the workers' reported losses
        # (same fixed reduce order — byte-stable like the grads)
        return float(sum(w * losses.get(j, float("nan"))
                         for j, w in enumerate(weights)))

    def _publish_state(self) -> None:
        with self._mu:
            self._publish_state_locked()

    def _publish_state_locked(self) -> None:
        # INVALIDATE only: the base64 tar of the whole tree (host gather
        # + CRC + encode) is built lazily by the first ela_state fetch of
        # this (pass, step) and cached — a step nobody syncs against
        # (idle fleet, master warming up) costs nothing
        self._state_blob = None

    def _snapshot(self, pass_id: int, step: int, *, complete: bool) -> None:
        save_checkpoint(self.snapshot_dir, pass_id, self._params,
                        self._opt_state,
                        extra={"pass_complete": complete,
                               "elastic_step": step,
                               "membership_epoch": self.membership.epoch})

    def _on_membership_change(self, view, *, joined, left, reason) -> None:
        """Re-bucket: requeue the departed members' in-flight shard tasks
        NOW instead of waiting out the dispatch timeout, and wake the fit
        loop so its progress deadline resets against the new fleet."""
        if left:
            requeued = 0
            with self._mu:
                for tid, w in list(self._assigned.items()):
                    if w in left:
                        del self._assigned[tid]
                        # failures count toward failure_max; the elastic
                        # default (100) keeps requeues from ever discarding
                        self.server.master.task_failed(tid)
                        requeued += 1
            if requeued:
                obs.count("cluster.rebucket_tasks_total", requeued)
                log.warning("membership %s (%s): requeued %d in-flight "
                            "shard task(s) -> epoch %d", reason,
                            ",".join(left), requeued, view["epoch"])
        with self._cv:
            self._cv.notify_all()

    # -- op handlers (native fallback threads) ------------------------------
    def _op_task(self, req):
        # the same deposed-master guard the mbr_* ops carry: a fenced
        # master handing out shards or accepting grads is the split-brain
        # membership fencing exists to stop (latent until a lease is
        # attached to the underlying MasterServer, but the guard must not
        # wait for that deployment to exist)
        fenced = self.membership._fenced_master()
        if fenced is not None:
            return fenced
        err = self.membership.validate(str(req.get("worker", "")),
                                       req.get("member_token"))
        if err is not None:
            obs.count("cluster.stale_rpcs_total", code=err["code"])
            return err
        with self._mu:
            if self._done:
                return {"ok": True, "task": None, "done": True,
                        "epoch": self.membership.epoch}
            t = self.server.master.get_task()
            resp = {"ok": True, "done": False,
                    "epoch": self.membership.epoch,
                    "pass": self._pass, "step": self._step}
            if t is None:
                resp["task"] = None
            else:
                self._assigned[t[0]] = str(req["worker"])
                resp["task"] = {"id": t[0], "payload": t[1]}
            return resp

    def _requeue_refused(self, req) -> None:
        """A fence-refused submission must not strand its task until the
        dispatch timeout: the shard is provably still needed (or the step
        moved on and the id is already gone — task_failed on an unknown id
        is a no-op), so requeue it NOW for a current worker."""
        tid = req.get("task_id")
        if tid is None:
            return
        with self._mu:
            self._assigned.pop(int(tid), None)
            self.server.master.task_failed(int(tid))

    def _op_grad(self, req):
        fenced = self.membership._fenced_master()
        if fenced is not None:
            return fenced
        worker = str(req.get("worker", ""))
        err = (self.membership.validate(worker, req.get("member_token"))
               or self.membership.fence(req.get("epoch")))
        if err is not None:
            if err["code"] != CODE_STALE_EPOCH:   # fence() already counted
                obs.count("cluster.stale_rpcs_total", code=err["code"])
            self._requeue_refused(req)
            return err
        with self._cv:
            key = (int(req.get("pass", -1)), int(req.get("step", -1)))
            if self._pending is None or key != self._pending:
                obs.count("cluster.stale_rpcs_total", code=CODE_STALE_STEP)
                tid = req.get("task_id")
                if tid is not None:
                    # current-step ids were cleared by set_dataset; a
                    # stale one is unknown to the queue — harmless
                    self._assigned.pop(int(tid), None)
                    self.server.master.task_failed(int(tid))
                return _err(CODE_STALE_STEP,
                            f"shard for pass/step {key} but the master is "
                            f"at {self._pending or (self._pass, self._step)}",
                            epoch=self.membership.epoch)
            shard = int(req["shard"])
            tid = req.get("task_id")
            if tid is not None:
                self._assigned.pop(int(tid), None)
                self.server.master.task_finished(int(tid))
            if shard in self._grads:
                return {"ok": True, "duplicate": True,
                        "epoch": self.membership.epoch}
            self._grads[shard] = _unpack_tree(req["grad"])
            if req.get("loss") is not None:
                self._losses[shard] = float(req["loss"])
            self._cv.notify_all()
        # feed the fleet health plane OUTSIDE the step lock: the worker-
        # reported shard wall time is the straggler score's raw signal
        # (obs/health.py; duplicates were answered above and don't count)
        el = req.get("elapsed_s")
        if el is not None:
            try:
                el = float(el)
            except (TypeError, ValueError):
                el = None
        if el is not None and el >= 0:
            obs.observe("cluster.shard_seconds", el, worker=worker)
            agg = getattr(self.server, "aggregator", None)
            if agg is not None and getattr(agg, "health", None) is not None:
                agg.health.note_shard(worker, el)
        return {"ok": True, "duplicate": False,
                "epoch": self.membership.epoch}

    def _op_state(self, req):
        with self._mu:
            if self._params is None:
                return {"ok": False, "error": "no state published yet"}
            if self._state_blob is None:
                self._state_blob = _pack_tree(self._params)
            return {"ok": True, "pass": self._pass, "step": self._step,
                    "epoch": self.membership.epoch,
                    "params": self._state_blob}

    def _op_status(self, req):
        st = self.status()
        st["ok"] = True
        return st


# -- worker ----------------------------------------------------------------------

class ElasticWorker:
    """A stateless elastic consumer: join → (heartbeat ‖ pull shard →
    grad → push) → leave. Holds only a replica of the canonical params,
    re-fetched onto its ``device`` (default: the card) at every step or
    epoch barrier the master signals.

    ``loss_fn`` runs on the worker's thread. A loss that calls a port
    module (``Module.call``: ``torch.func.functional_call`` swaps the
    module's parameters for the call) needs a module of its own in each
    worker of one process.
    """

    def __init__(self, loss_fn: Callable, endpoints, *,
                 worker: Optional[str] = None, mesh=None, layout=None,
                 poll: float = 0.02, retries: int = 8, caps=None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        _no_mesh(mesh, layout)
        self.device = require_device(device)
        if isinstance(endpoints, tuple) and len(endpoints) == 2 and \
                isinstance(endpoints[1], int):
            endpoints = [endpoints]
        self.endpoints = list(endpoints)
        self.worker = worker or f"elastic-{uuid.uuid4().hex[:8]}"
        self.poll = poll
        self.caps = caps or {}
        self.retries = retries
        self.loss_fn = loss_fn
        # shard wall-time source (injectable: fake-clock chaos tests) —
        # the measured duration rides each ela_grad and feeds the
        # master-side straggler score (obs/health.py)
        self._shard_clock = clock
        # loss and gradients, one CUDA graph per shard signature
        self.graphs = GraphCache("trainer.ElasticWorker", self.device)
        self._params = None
        self._version: Optional[Tuple[int, int]] = None
        self._resync = threading.Event()
        self.steps_contributed = 0
        self.shards_contributed = 0
        self.last_epoch = 0

    # -- state sync --------------------------------------------------------
    def _fetch_state(self, client) -> bool:
        """Pull + re-place the canonical params; False when the master has
        no state published yet (joined before fit() — wait, don't die)."""
        r = client._call({"op": "ela_state"})
        if not r.get("ok"):
            return False
        # gather happened on the wire (host arrays); place onto OUR device
        self._params = _unpack_tree(r["params"], self.device)
        self._version = (int(r["pass"]), int(r["step"]))
        self.last_epoch = int(r["epoch"])
        obs.count("cluster.resyncs_total")
        return True

    def _timed_grad(self, payload: dict):
        """(loss, grads, elapsed_s) — the shard compute under the shard
        wall clock. The elapsed time rides the ela_grad push and feeds
        the master-side straggler score (obs/health.py), so the timing
        boundary and the chaos site live in ONE place."""
        t0 = self._shard_clock()
        loss, grads = self._grad_of(payload)
        return loss, grads, max(self._shard_clock() - t0, 0.0)

    def _grad_of(self, payload: dict):
        # the elastic shard twin of the trainer's step.grad chaos site: a
        # `delay` rule here makes THIS worker a straggler (its inflated
        # shard time rides the ela_grad push into the health plane); a
        # `raise` kills the shard like any injected worker failure
        faults.fire("step.grad")
        batch = tuple(torch.from_numpy(np.ascontiguousarray(a))
                      for a in _unpack_arrays(payload["batch"]))
        loss, grads = self.graphs.run(
            "grad", self._grad_body, {"params": self._params,
                                      "batch": batch})
        return float(loss), _host_f32(grads)

    def _grad_body(self, params, batch):
        return loss_and_grads(self.loss_fn, params, *batch)

    # -- the loop ----------------------------------------------------------
    def run(self, stop: Optional[threading.Event] = None,
            max_seconds: Optional[float] = None) -> Dict[str, Any]:
        """Serve until the master reports the job done (or ``stop`` is
        set / ``max_seconds`` elapse). Returns a contribution summary."""
        stop = stop or threading.Event()
        deadline = (time.monotonic() + max_seconds
                    if max_seconds is not None else None)
        client = MembershipClient(endpoints=self.endpoints,
                                  retries=self.retries)
        token, epoch, reply = client.join(self.worker, self.caps)
        self.last_epoch = epoch
        keeper = HeartbeatKeeper(
            client, self.worker, token,
            ttl=float(reply.get("ttl", 5.0)),
            epoch=epoch, caps=self.caps,
            on_epoch=lambda e: self._resync.set(),
            on_rejoin=lambda t, e: self._resync.set(),
            on_lost=stop.set).start()
        done = False
        try:
            while not stop.is_set() and not done:
                if deadline is not None and time.monotonic() > deadline:
                    break
                try:
                    done = self._serve_once(client, keeper)
                except ConnectionError:
                    # reconnect budget spent (master restarting longer
                    # than one window): keep polling — the heartbeat
                    # keeper owns the give-up decision (on_lost)
                    time.sleep(self.poll)
        finally:
            keeper.stop()
            try:
                client.leave(self.worker, keeper.token)
            except Exception:  # noqa: BLE001 - master may already be gone
                pass
            client.close()
        return {"worker": self.worker, "done": done,
                "steps": self.steps_contributed,
                "shards": self.shards_contributed,
                "epoch": self.last_epoch}

    def _serve_once(self, client, keeper) -> bool:
        """One poll cycle; returns True when the master says done."""
        try:
            r = client._call({"op": "ela_task", "worker": self.worker,
                              "member_token": keeper.token})
        except StaleMemberError:
            # evicted / superseded: the keeper's heartbeat will re-join
            # (or declare the membership lost); don't hot-spin meanwhile
            time.sleep(self.poll)
            return False
        if r.get("done"):
            return True
        epoch = int(r.get("epoch", self.last_epoch))
        if epoch != self.last_epoch or self._resync.is_set():
            # membership changed: barrier here (the step boundary) and
            # re-place the canonical state before taking more work
            self._resync.clear()
            self.last_epoch = epoch
            if not self._fetch_state(client):
                self._resync.set()        # nothing published yet: re-ask
                time.sleep(self.poll)
                return False
        task = r.get("task")
        if task is None:
            time.sleep(self.poll)
            return False
        payload = json.loads(task["payload"])
        version = (int(payload["pass"]), int(payload["step"]))
        if self._version != version:
            if not self._fetch_state(client) or self._version != version:
                # the master moved past this shard while we synced; let
                # the dispatch timeout requeue it for someone current
                time.sleep(self.poll)
                return False
        loss, grads, elapsed = self._timed_grad(payload)
        try:
            resp = client._call({
                "op": "ela_grad", "worker": self.worker,
                "member_token": keeper.token, "epoch": self.last_epoch,
                "pass": version[0], "step": version[1],
                "shard": int(payload["shard"]), "task_id": task["id"],
                "loss": loss, "grad": _pack_tree(grads),
                "elapsed_s": elapsed})
        except StaleMemberError as e:
            if e.code == CODE_STALE_EPOCH or e.code == CODE_STALE_STEP:
                self._resync.set()
                if e.epoch is not None:
                    self.last_epoch = int(e.epoch)
                return False
            time.sleep(self.poll)
            return False
        if resp.get("ok") and not resp.get("duplicate"):
            self.shards_contributed += 1
            if int(payload["shard"]) == 0:
                self.steps_contributed += 1
        return False
