"""Data-parallel training — the counterpart of
``paddle_tpu/parallel/data_parallel.py`` (the MultiGradientMachine
replacement).

Reference semantics kept: the batch split across ranks, the gradient the
mean over the global batch, the final parameters those of one device
trained on the whole batch.

:class:`DataParallel`: each rank holds the batch rows of its ``data``
shard, computes its loss and gradient on them, and the gradients are
averaged over ``data`` (one all-reduce of every gradient flattened into
one buffer). ``init`` places the parameters and the optimizer slots by
the rules (a :class:`~.sharding.SpecLayout` or
:class:`~.sharding.ShardingRules`): under an fsdp/tp layout each
parameter and slot is *stored* sharded; a step gathers the parameters
for its compute, splits the batch rows over ``fsdp`` too (FSDP's data
parallelism, where the rows divide), averages the gradients over the
batch axes, keeps its block of each gradient, and updates the blocks.
XLA would partition the tp matmuls themselves; here the ranks of a tp
group compute the same rows (ROADMAP C.11: the numbers are the same,
the compute split is not). The step runs eagerly: a step over gloo
cannot be captured in a CUDA graph.

:class:`Zero1DataParallel`: true ZeRO-1. One flat f32 master vector of
the trainable parameters split over ``data``, the optimizer slots on the
same split; each step all-gathers the vector, computes the local loss,
reduce-scatters the flat gradient (mean over ``data``) and updates the
rank's shard. Non-trainable ``stats`` leaves stay replicated.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..core.pytree import tree_from_items, tree_items
from . import collectives as cc
from .mesh import Mesh, make_mesh
from .sharding import (NamedSharding, P, cut, device_put, from_local,
                       gather, local, shard_batch, shard_params, spec_of,
                       to_global, tree_map)


def _norm_clip(optimizer) -> bool:
    clip = getattr(optimizer, "grad_clip", None)
    return clip is not None and clip[0] in ("norm", "global_norm")


def _local_batch(batch, mesh: Mesh, axis: str, fsdp: str = None):
    """Each leaf as this rank computes on it: a DTensor's block, a global
    tensor's rows of this rank's ``axis`` shard (all of it when the mesh
    has no such axis); then, with an ``fsdp`` axis, this rank's part of
    those rows when they split evenly over it (the fsdp ranks of a data
    shard take the same rows otherwise)."""
    from torch.distributed.tensor import DTensor

    def one(x):
        if isinstance(x, DTensor):
            x = x.to_local()
        elif isinstance(x, torch.Tensor) and x.dim() and axis in mesh.shape:
            x = cut(x.to(mesh.device), mesh, P(axis))
        if fsdp is not None and isinstance(x, torch.Tensor) and x.dim() \
                and x.shape[0] % mesh.shape[fsdp] == 0:
            x = cut(x, mesh, P(fsdp))
        return x
    return tree_map(one, batch)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _local_rows(x, mesh: Mesh, axis: str) -> int:
    """The rows of batch leaf ``x`` on this rank's ``axis`` shard."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return x.to_local().shape[0]
    return x.shape[0] // mesh.shape.get(axis, 1)


def _relayout(x: torch.Tensor, mesh: Mesh, src: P, dst: P):
    """A block under ``src`` as this rank's block under ``dst``."""
    if tuple(src) == tuple(dst):
        return x
    return cut(gather(x, mesh, src), mesh, dst)


def _map_path(fn, tree, prefix=()):
    """``fn(path, leaf)`` over a nested dict, empty dicts kept."""
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _param_path(slot_path, specs):
    """The parameter a slot belongs to: the longest prefix of the slot's
    path that is a parameter's."""
    for n in range(len(slot_path), 0, -1):
        if slot_path[:n] in specs:
            return slot_path[:n]
    raise KeyError(f"optimizer slot {'/'.join(slot_path)} has no parameter")


def _on_device(x, dev):
    return torch.as_tensor(to_global(x)).to(dev)


def _gather_rows(x, mesh: Mesh, axes):
    """An output of ``aux_fn`` on this rank's rows as the global value:
    tensors with a batch dim gathered over the batch ``axes`` (the rows'
    order), scalars averaged."""
    if not isinstance(x, torch.Tensor) or not axes:
        return x
    with mesh:
        if x.dim() == 0:
            return cc.all_reduce(x.float(), axes, "mean").to(x.dtype)
        return cc.all_gather(x, axes)


def _mean_grads(grads, mesh: Mesh, axes):
    """Every gradient averaged over the batch ``axes``: one all-reduce of
    them all, flattened into one f32 buffer."""
    if not axes:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    with mesh:
        flat = cc.all_reduce(flat, axes, "mean")
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out


def _value_and_grad(loss_fn, params, batch, aux_fn):
    """(loss, aux, [(path, f32 grad)]) of ``loss_fn`` at the full
    parameter tree ``params``."""
    from ..trainer.trainer import _sharing
    items = [(path, leaf.detach().requires_grad_(leaf.is_floating_point()))
             for path, leaf in tree_items(params)]
    tree = tree_from_items(items)
    with _sharing():
        loss = loss_fn(tree, *batch)
        if isinstance(loss, tuple):
            raise TypeError("a data-parallel loss_fn returns a scalar loss "
                            "(a loss with stat updates is the single-rank "
                            "Trainer's)")
        aux = None
        if aux_fn is not None:
            with torch.no_grad():
                aux = aux_fn(tree, *batch)
        diff = [leaf for _, leaf in items if leaf.requires_grad]
        grads = iter(torch.autograd.grad(loss, diff, allow_unused=True,
                                         materialize_grads=True))
    out = [(path, next(grads).float() if leaf.requires_grad else
            torch.zeros_like(leaf, dtype=torch.float32))
           for path, leaf in items]
    return loss.detach(), aux, out


class DataParallel:
    """Wrap (loss_fn, optimizer) into a data-parallel step over the mesh.

    loss_fn(params, *batch) -> scalar loss (mean over ITS batch rows)."""

    def __init__(self, loss_fn: Callable, optimizer, mesh: Optional[Mesh] = None,
                 axis: str = "data", param_rules=None, donate: bool = True,
                 aux_fn: Optional[Callable] = None):
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.mesh = mesh if mesh is not None else make_mesh(data=-1)
        self.axis = axis
        self.rules = param_rules
        self.aux_fn = aux_fn
        # JAX's signature: its step donates the trees unless asked not to;
        # this one always makes new trees (the optimizer's ``update``), so
        # the inputs stay valid and a caller may revert to them
        del donate

    # -- placement ---------------------------------------------------------
    def init(self, params, opt_state=None):
        """Place params (+ optimizer state) on the mesh. Called again on a
        checkpoint restore, this re-places host tensors onto the CURRENT
        mesh: the rules are a pure function of path + shape."""
        dev = self.mesh.device
        params = tree_map(lambda x: _on_device(x, dev), params)
        if opt_state is None:
            opt_state = self.opt.init(params)
        placed = shard_params(params, self.mesh, self.rules)
        if _norm_clip(self.opt) and any(
                spec_of(leaf) != P() for _, leaf in tree_items(placed)):
            raise ValueError(
                "norm-based grad clip on sharded parameters would clip by "
                "each shard's norm: replicate the parameters or use "
                "grad_clip=('value', ...)")
        opt_state = tree_map(lambda x: _on_device(x, dev), opt_state)
        if hasattr(self.rules, "fit"):
            # SpecLayout: slot paths embed their parameter's path, so the
            # same resolution shards optimizer moments like their params
            opt_state = self.rules.apply(self.mesh, opt_state)
        else:
            opt_state = shard_params(opt_state, self.mesh)
        return placed, opt_state

    def shard_batch(self, batch):
        return shard_batch(batch, self.mesh, self.axis)

    # -- the hot loop ------------------------------------------------------
    def step(self, params, opt_state, *batch):
        """One global-batch step -> (params, opt_state, loss[, aux]): the
        loss is the mean over the global batch, the same on every rank;
        ``aux`` the global outputs of ``aux_fn`` on the pre-update
        parameters."""
        mesh = self.mesh
        fsdp = getattr(self.rules, "fsdp_axis", "fsdp")
        fsdp = fsdp if fsdp in mesh.shape else None
        rows = next((x for x in _leaves(batch) if isinstance(x, torch.Tensor)
                     and x.dim()), None)
        split = fsdp is not None and rows is not None and \
            _local_rows(rows, mesh, self.axis) % mesh.shape[fsdp] == 0
        # the axes the batch rows are split over: data, and fsdp (FSDP's
        # data parallelism) where the rows divide
        axes = tuple(a for a in (self.axis, fsdp if split else None)
                     if a is not None and a in mesh.shape)
        full = tree_from_items((path, gather(local(leaf), mesh,
                                             spec_of(leaf) or P()))
                               for path, leaf in tree_items(params))
        loss, aux, grads = _value_and_grad(
            self.loss_fn, full,
            _local_batch(batch, mesh, self.axis, fsdp if split else None),
            self.aux_fn)
        gs = _mean_grads([g for _, g in grads], mesh, axes)
        specs = {path: spec_of(leaf) or P() for path, leaf in
                 tree_items(params)}
        g_local = tree_from_items((path, cut(g, mesh, specs[path]))
                                  for (path, _), g in zip(grads, gs))
        p_local = tree_map(local, params)
        slots = opt_state["slots"]

        def pspec(path):
            return specs[_param_path(path, specs)]

        # slots to their parameter's layout for the update, and back
        state = dict(opt_state, step=local(opt_state["step"]),
                     slots=_map_path(lambda path, leaf: _relayout(
                         local(leaf), mesh, spec_of(leaf) or P(),
                         pspec(path)), slots))
        if "hooks" in opt_state:
            state["hooks"] = tree_map(local, opt_state["hooks"])
        new_p, new_s = self.opt.update(g_local, state, p_local)
        out_p = _map_path(lambda path, x: from_local(
            x, mesh, specs[path], _get(params, path).shape), new_p)

        def slot_back(path, x):
            old = _get(slots, path)
            sspec = spec_of(old) or P()
            return from_local(_relayout(x, mesh, pspec(path), sspec), mesh,
                               sspec, old.shape)
        out_s = dict(new_s, step=from_local(new_s["step"], mesh, P(), ()),
                     slots=_map_path(slot_back, new_s["slots"]))
        if "hooks" in opt_state:
            out_s["hooks"] = opt_state["hooks"]
        if axes:
            with mesh:
                loss = cc.all_reduce(loss.float(), axes, "mean")
        if self.aux_fn is not None:
            return out_p, out_s, loss, tree_map(
                lambda x: _gather_rows(x, mesh, axes), aux)
        return out_p, out_s, loss


class Zero1State(NamedTuple):
    """ZeRO-1 training state: the f32 master copy of all trainable parameters
    as ONE flat vector sharded over the data axis; optimizer slots share
    that sharding; non-trainable ``stats`` leaves stay replicated."""
    flat: Any                # [N_padded] f32 DTensor, P(axis)
    opt_state: Any           # {"step": scalar, "slots": {"flat": ...}}
    stats: Tuple[Any, ...]   # replicated non-trainable leaves, tree order


class Zero1DataParallel:
    """TRUE ZeRO-1 data parallelism (partitioned optimizer states): each
    rank owns 1/n of one flat f32 master vector and the optimizer slots
    of that shard only (the pserver's ParameterServer2.h:383
    doOperation, where each server updates its block of every
    parameter); a step all-gathers the vector, runs the local forward and
    backward, reduce-scatters the flat gradient and updates its shard.

    loss_fn(params, *batch) -> scalar loss (mean over ITS batch rows)."""

    def __init__(self, loss_fn: Callable, optimizer, mesh: Optional[Mesh] = None,
                 axis: str = "data"):
        if _norm_clip(optimizer):
            raise ValueError(
                "norm-based grad clip inside the shard-local optimizer would "
                "clip by the LOCAL shard's norm (not per-leaf / global); "
                "clip in loss_fn or use grad_clip=('value', ...)")
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.mesh = mesh if mesh is not None else make_mesh(data=-1)
        self.axis = axis
        self.n = self.mesh.shape[axis]

    # -- flat <-> tree ------------------------------------------------------
    def _build_template(self, params):
        items = tree_items(params)
        self._paths = [path for path, _ in items]
        self._is_stat = ["stats" in path for path in self._paths]
        train = [leaf for (_, leaf), st in zip(items, self._is_stat)
                 if not st]
        self._shapes = [tuple(l.shape) for l in train]
        self._dtypes = [l.dtype for l in train]
        self._sizes = [l.numel() for l in train]
        total = sum(self._sizes)
        self._padded = -(-total // self.n) * self.n
        self._offsets = [0]
        for s in self._sizes:
            self._offsets.append(self._offsets[-1] + s)

    def _flatten(self, leaves):
        """Trainable leaves -> [N_padded] f32."""
        parts = [l.reshape(-1).float() for l in leaves]
        flat = torch.cat(parts) if parts else torch.zeros(
            (0,), device=self.mesh.device)
        pad = self._padded - flat.shape[0]
        return torch.nn.functional.pad(flat, (0, pad)) if pad else flat

    def _unflatten(self, flat, stats):
        """[N_padded] f32 + replicated stat leaves -> params tree."""
        train = iter([flat[o:o + s].reshape(shape).to(dt)
                      for o, s, shape, dt in zip(self._offsets, self._sizes,
                                                 self._shapes, self._dtypes)])
        st = iter(stats)
        return tree_from_items(
            (path, next(st) if is_stat else next(train))
            for path, is_stat in zip(self._paths, self._is_stat))

    def _train_leaves(self, tree):
        return [l for (_, l), st in zip(tree_items(tree), self._is_stat)
                if not st]

    def _stat_leaves(self, tree):
        return tuple(l for (_, l), st in zip(tree_items(tree), self._is_stat)
                     if st)

    # -- placement ----------------------------------------------------------
    def init(self, params) -> Zero1State:
        dev = self.mesh.device
        params = tree_map(lambda x: torch.as_tensor(x).to(dev), params)
        self._build_template(params)
        flat = self._flatten(self._train_leaves(params))
        opt_state = self.opt.init({"flat": flat})   # slots like the vector
        shard = NamedSharding(self.mesh, P(self.axis))
        rep = NamedSharding(self.mesh, P())
        opt_state = tree_map(lambda x: device_put(
            x, shard if x.dim() >= 1 else rep), opt_state)
        stats = tuple(device_put(s, rep) for s in self._stat_leaves(params))
        return Zero1State(device_put(flat, shard), opt_state, stats)

    def params(self, state: Zero1State):
        """Materialise the full parameter tree (for eval / checkpointing)."""
        full = gather(local(state.flat), self.mesh, P(self.axis))
        return self._unflatten(full, tuple(local(s) for s in state.stats))

    def shard_batch(self, batch):
        return shard_batch(batch, self.mesh, self.axis)

    # -- the hot loop --------------------------------------------------------
    def step(self, state: Zero1State, *batch):
        """One global-batch ZeRO-1 step -> (new_state, loss)."""
        mesh, axis, n = self.mesh, self.axis, self.n
        flat_shard = local(state.flat)
        stats = tuple(local(s) for s in state.stats)
        with mesh:
            full = cc.all_gather(flat_shard, axis)
        params = self._unflatten(full, stats)
        loss, _, grads = _value_and_grad(
            self.loss_fn, params, _local_batch(batch, mesh, axis), None)
        gflat = self._flatten([g for (path, g), st in
                               zip(grads, self._is_stat) if not st])
        # mean over the data axis, scattered so each rank keeps (and
        # updates) only its 1/n shard
        with mesh:
            g_shard = cc.reduce_scatter(gflat, axis) / n
            loss = cc.all_reduce(loss.float(), axis, "mean")
        opt_local = tree_map(local, state.opt_state)
        new_p, new_state = self.opt.update({"flat": g_shard}, opt_local,
                                            {"flat": flat_shard})
        shard_shape = (self._padded,)
        new_state = tree_map(
            lambda x: from_local(x, mesh, P(axis) if x.dim() >= 1 else P(),
                                  shard_shape if x.dim() >= 1 else ()),
            new_state)
        flat = from_local(new_p["flat"], mesh, P(axis), shard_shape)
        return Zero1State(flat, new_state, state.stats), loss
