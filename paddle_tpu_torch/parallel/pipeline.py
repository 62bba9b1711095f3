"""Pipeline parallelism over a ``pipe`` mesh axis — the counterpart of
``paddle_tpu/parallel/pipeline.py``.

Every stage runs the same program: stage parameters are stacked on a
leading [n_stages] axis sharded over ``pipe`` (rank s holds stage s),
microbatch activations hop stage to stage as sends and receives to the
neighbouring rank (``collectives.permute_ring``), and the schedule is a
static timetable of ticks. As in JAX every stage shares one activation
shape (an equal-width trunk).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.pytree import tree_from_items, tree_items
from ..core.pytree import tree_map as _tree_map2
from ..nn.module import Module
from . import collectives as cc
from .compat import shard_map
from .mesh import Mesh
from .sharding import P, tree_map


def _stacked(init, n: int):
    """``init`` run on each stage's slice of a stacked parameter."""
    def run(p: torch.Tensor, gen: torch.Generator) -> None:
        for s in range(n):
            init(p[s], gen)
    return run


class PipelineStage(Module):
    """Repeats one stage Module across pipeline stages with stacked params.

    The parameters are the stage's, under its names, each with a leading
    [n_stages] axis (JAX's ``init`` stacks the stages' trees the same
    way, so a JAX tree loads through ``convert.params_from_numpy``);
    ``init`` draws each stage's slice with the stage's initializer. Shard
    that axis over ``pipe`` and run via :func:`pipeline_spmd`."""

    def __init__(self, make_stage: Callable[[], Module], n_stages: int):
        super().__init__()
        self.n_stages = n_stages
        # the template the forward calls with each stage's slice; kept
        # out of the module tree, whose parameters are the stacked ones
        object.__setattr__(self, "stage", make_stage())
        for sub_name, sub in self.stage.named_modules():
            owner = self
            for part in filter(None, sub_name.split(".")):
                if part not in owner._modules:
                    setattr(owner, part, Module())
                owner = owner._modules[part]
            for name, init in getattr(sub, "_inits", {}).items():
                shape = (n_stages,) + tuple(getattr(sub, name).shape)
                owner.param(name, shape, _stacked(init, n_stages))

    def forward(self, x, **kw):
        """Reference (non-pipelined) execution: fold over stages."""
        leaves = dict(self.named_parameters())
        for s in range(self.n_stages):
            x = torch.func.functional_call(
                self.stage, {k: v[s] for k, v in leaves.items()}, (x,), kw)
        return x


def pipeline_spmd(stage_fn: Callable, mesh: Mesh, n_microbatches: int,
                  axis: str = "pipe"):
    """Build fn(stacked_params, x) running stage_fn through the pipe ring
    (GPipe): stage_fn(stage_params, mb) -> mb', same shape. ``x`` is
    [B, ...], split into ``n_microbatches`` along dim 0. Returns the full
    output batch, replicated over the pipe axis. Differentiable."""
    n_stages = mesh.shape[axis]

    def local(params, x):
        params = tree_map(lambda p: p[0], params)    # this stage's slice
        stage_id = mesh.coordinate(axis)
        M, S = n_microbatches, n_stages
        mb = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        # every rank builds the same graph (selects, not branches), so the
        # backward's ring transfers pair up rank to rank
        first = torch.tensor(stage_id == 0, device=x.device)
        state = torch.zeros_like(mb[0])
        outs = [None] * M
        for t in range(M + S - 1):
            # stage 0 injects microbatch t (garbage after the last one;
            # those ticks' results are never collected)
            inp = torch.where(first, mb[min(t, M - 1)], state)
            out = stage_fn(params, inp)
            if t >= S - 1:           # the last stage finishes microbatch
                outs[t - (S - 1)] = out
            state = cc.permute_ring(out, axis, 1)
        # replicate the collected outputs (held by the last stage)
        buf = torch.stack(outs) * float(stage_id == S - 1)
        buf = cc.all_reduce(buf, axis)
        return buf.reshape(x.shape[0], *buf.shape[2:])

    return shard_map(local, mesh=mesh, in_specs=(P(axis), P()),
                     out_specs=P())


def _vjp(fn, params, x, cot=None):
    """(value, d params, d x) of ``fn(params, x)``, seeded by ``cot``
    (a scalar output: 1)."""
    with torch.enable_grad():
        items = [(path, t.detach().requires_grad_(True))
                 for path, t in tree_items(params)]
        xx = x.detach().requires_grad_(True)
        out = fn(tree_from_items(items), xx)
        grads = torch.autograd.grad(out, [t for _, t in items] + [xx],
                                    grad_outputs=cot, allow_unused=True,
                                    materialize_grads=True)
    dp = tree_from_items((path, g) for (path, _), g in zip(items, grads))
    return out.detach(), dp, grads[-1]


def pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, mesh: Mesh,
                  n_microbatches: int, axis: str = "pipe"):
    """1F1B (PipeDream-flush) training schedule over the ``pipe`` axis.

    Builds ``step(stacked_params, x, y) -> (loss, stacked_grads)``.
    Stage s's timetable: forwards at ticks ``s + 2m``, backwards at
    ``2S - s - 1 + 2m`` (the parities never collide), so at most ``S - s``
    microbatches are in flight a stage and the input stash is a circular
    buffer of S slots. The backward recomputes the stage forward from the
    stashed INPUT (rematerialization). Every tick each rank sends its
    forward message to the next stage and its backward message to the
    previous one. stage_fn(stage_params, mb) -> mb' (same shape);
    loss_fn(out_mb, y_mb) -> scalar mean loss of the microbatch. The loss
    and grads are averaged over microbatches; grads keep the stacked
    [n_stages, ...] leading axis."""
    n_stages = mesh.shape[axis]

    def local(params, x, y):
        params = tree_map(lambda p: p[0], params)
        S, M = n_stages, n_microbatches
        s = mesh.coordinate(axis)
        mbx = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        mby = y.reshape(M, y.shape[0] // M, *y.shape[1:])
        zero = torch.zeros_like(mbx[0])
        fwd_msg, bwd_msg = zero, zero
        stash = [zero] * S
        dparams = tree_map(torch.zeros_like, params)
        loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
        for t in range(2 * (M + S - 1)):
            tf = t - s
            do_fwd = tf >= 0 and tf % 2 == 0 and tf // 2 < M
            m_f = min(max(tf // 2, 0), M - 1)
            tb = t - (2 * S - s - 1)
            do_bwd = tb >= 0 and tb % 2 == 0 and tb // 2 < M
            m_b = min(max(tb // 2, 0), M - 1)
            inp = mbx[m_f] if s == 0 else fwd_msg
            send_f, send_b = zero, zero
            if do_bwd:
                saved = stash[m_b % S]
                if s == S - 1:
                    lv, dp, dx = _vjp(lambda p, xx: loss_fn(stage_fn(p, xx),
                                                            mby[m_b]),
                                      params, saved)
                    loss_acc = loss_acc + lv.float()
                else:
                    _, dp, dx = _vjp(stage_fn, params, saved, bwd_msg)
                dparams = _tree_map2(torch.add, dparams, dp)
                send_b = dx
            elif do_fwd:
                with torch.no_grad():
                    send_f = stage_fn(params, inp)
            if do_fwd:
                stash[m_f % S] = inp
            fwd_msg = cc.permute_ring(send_f.to(zero.dtype), axis, 1)
            bwd_msg = cc.permute_ring(send_b.to(zero.dtype), axis, -1)
        loss = cc.all_reduce(loss_acc, axis) / M
        return loss, tree_map(lambda g: (g / M)[None], dparams)

    return shard_map(local, mesh=mesh, in_specs=(P(axis), P(), P()),
                     out_specs=(P(), P(axis)))
