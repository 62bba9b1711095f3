"""The training loop — the core of ``paddle_tpu/trainer/trainer.py``'s
``Trainer``: pass and batch loops over a reader, events to a callback,
and a test pass.

As in JAX the trainer is functional: ``loss_fn(params, *batch)`` returns
the scalar loss of a nested dict of parameters, one step is value and
gradient (``torch.autograd.grad`` with respect to the tree's leaves) and
the optimizer's update, and ``train`` returns the new (params,
opt_state). As JAX jits the step with the params and the optimizer state
donated (``donate_argnums=(0, 1)``), a step on the card is one CUDA graph
per batch signature (``core/graphs.py``): the loss (the bf16 recipe's
cast of the f32 masters included), the backward through the port's
kernels and the optimizer's ``apply_``, written in place into the trees
the graph carries. The test loss is one graph per batch signature too.

The JAX trainer's mesh/layout, evaluators, checkpoints, preemption, the
non-finite-loss guard, obs metrics, prefetch, ``check_gradient`` and
``benchmark`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

from ..core.graphs import GraphCache
from ..core.place import DeviceLike, require_device
from ..core.pytree import tree_from_items, tree_items, tree_map
from ..nn.module import apply_stat_updates_
from . import event as EV


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


class Trainer:
    """Drive (loss_fn, optimizer) over reader batches with events.

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
    """

    def __init__(self, loss_fn: Callable, optimizer, *,
                 device: DeviceLike = None):
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.device = require_device(device)
        self.graphs = GraphCache("Trainer", self.device)

    def step(self, params: Mapping, opt_state: Dict[str, Any], *batch
             ) -> Tuple[Dict[str, Any], Dict[str, Any], torch.Tensor]:
        """One step: loss and gradients of ``params``, then the update.
        Returns (new params, new opt_state, loss).

        ``params`` and ``opt_state`` are donated, as in JAX. The trees a
        step returns are the trainer's own, updated in place: passing them
        back to the next step copies nothing, and that step writes them
        again (take a copy to keep one). Trees the trainer does not own
        (a model's ``tree()``, a fresh ``opt.init``) are copied in first
        and never written."""
        batch, gens = _split_generators(batch)
        return self.graphs.run(
            "step", self._step_body,
            {"params": params, "opt_state": opt_state, "batch": batch},
            static=gens, donate=("params", "opt_state"))

    def _step_body(self, params, opt_state, batch, **gens):
        """The step program: value and gradient of the loss with respect to
        the leaves of ``params``, then the optimizer's ``apply_`` into
        ``params`` and ``opt_state`` and the stat updates into ``params``.
        Returns (params, opt_state, loss)."""
        items = [(path, leaf.detach().requires_grad_(True))
                 for path, leaf in tree_items(params)]
        leaves = tree_from_items(items)
        loss, stats = _loss_and_stats(
            self.loss_fn(leaves, *_join_generators(batch, gens)))
        grads = torch.autograd.grad(loss, [leaf for _, leaf in items],
                                    materialize_grads=True)
        grads = tree_from_items((path, g.to(torch.float32))
                                for (path, _), g in zip(items, grads))
        self.opt.apply_(grads, opt_state, params)
        if stats:
            apply_stat_updates_(params, stats)
        return params, opt_state, loss.detach()

    def train(self, reader: Callable[[], Iterable], params: Mapping, *,
              num_passes: int = 1,
              event_handler: Optional[Callable] = None):
        """Run ``num_passes`` passes over ``reader()`` (each item is one
        batch: a tuple of the loss_fn's batch arguments) from a fresh
        optimizer state; returns (params, opt_state), copies of the
        trees the last step wrote, so that a later call writes neither
        them nor ``params``. ``EndIteration`` carries the batch's cost as
        a float (reading it waits for the step to finish)."""
        event_handler = event_handler or (lambda e: None)
        opt_state = self.opt.init(params)
        for pass_id in range(num_passes):
            event_handler(EV.BeginPass(pass_id))
            for batch_id, batch in enumerate(reader()):
                event_handler(EV.BeginIteration(pass_id, batch_id))
                params, opt_state, loss = self.step(params, opt_state,
                                                    *batch)
                event_handler(EV.EndIteration(pass_id, batch_id,
                                              float(loss)))
            event_handler(EV.EndPass(pass_id))
        return tree_map(torch.clone, params), tree_map(torch.clone, opt_state)

    @torch.no_grad()
    def test(self, reader: Callable[[], Iterable], params: Mapping
             ) -> Dict[str, float]:
        """Average cost over a test reader, with gradients off (so the
        LSTM runs its inference kernel); each batch's loss is one graph
        per batch signature on the card."""
        total, n = 0.0, 0
        for batch in reader():
            batch, gens = _split_generators(tuple(batch))
            total += float(self.graphs.run(
                "loss", self._loss_body,
                {"params": params, "batch": batch}, static=gens))
            n += 1
        return {"cost": total / max(n, 1)}

    @torch.no_grad()
    def _loss_body(self, params, batch, **gens):
        return _loss_and_stats(
            self.loss_fn(params, *_join_generators(batch, gens)))[0]
