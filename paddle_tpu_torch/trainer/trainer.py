"""The training loop — the core of ``paddle_tpu/trainer/trainer.py``'s
``Trainer``: pass and batch loops over a reader, events to a callback,
and a test pass.

As in JAX the trainer is functional: ``loss_fn(params, *batch)`` returns
the scalar loss of a nested dict of parameters, one step is value and
gradient (``torch.autograd.grad`` with respect to the tree's leaves) and
the optimizer's ``update``, and ``train`` returns the new (params,
opt_state). PyTorch runs eagerly, so a step is not one compiled
function; the kernels on its path are the port's CUDA kernels.

The JAX trainer's mesh/layout, evaluators, checkpoints, preemption, the
non-finite-loss guard, obs metrics, prefetch, ``check_gradient`` and
``benchmark`` are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

from ..core.place import DeviceLike, require_device
from ..core.pytree import tree_from_items, tree_items
from . import event as EV


def _to(batch, device: torch.device):
    return tuple(t.to(device) if isinstance(t, torch.Tensor) else t
                 for t in batch)


class Trainer:
    """Drive (loss_fn, optimizer) over reader batches with events.

    Args:
      loss_fn: (params, *batch) -> scalar loss tensor.
      optimizer: a ``paddle_tpu_torch.optimizer`` optimizer.
      device: where the batches go and the step runs (default: the card;
        with no card the constructor raises).
    """

    def __init__(self, loss_fn: Callable, optimizer, *,
                 device: DeviceLike = None):
        self.loss_fn = loss_fn
        self.opt = optimizer
        self.device = require_device(device)

    def step(self, params: Mapping, opt_state: Dict[str, Any], *batch
             ) -> Tuple[Dict[str, Any], Dict[str, Any], torch.Tensor]:
        """One step: loss and gradients of ``params``, then the update.
        Returns (new params, new opt_state, loss)."""
        items = [(path, leaf.detach().requires_grad_(True))
                 for path, leaf in tree_items(params)]
        leaves = tree_from_items(items)
        loss = self.loss_fn(leaves, *_to(batch, self.device))
        grads = torch.autograd.grad(loss, [leaf for _, leaf in items])
        grads = tree_from_items((path, g.to(torch.float32))
                                for (path, _), g in zip(items, grads))
        new_params, new_state = self.opt.update(grads, opt_state, params)
        return new_params, new_state, loss.detach()

    def train(self, reader: Callable[[], Iterable], params: Mapping, *,
              num_passes: int = 1,
              event_handler: Optional[Callable] = None):
        """Run ``num_passes`` passes over ``reader()`` (each item is one
        batch: a tuple of the loss_fn's batch arguments) from a fresh
        optimizer state; returns (params, opt_state). ``EndIteration``
        carries the batch's cost as a float (reading it waits for the step
        to finish)."""
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
        return params, opt_state

    @torch.no_grad()
    def test(self, reader: Callable[[], Iterable], params: Mapping
             ) -> Dict[str, float]:
        """Average cost over a test reader, with gradients off (so the
        LSTM runs its inference kernel)."""
        total, n = 0.0, 0
        for batch in reader():
            total += float(self.loss_fn(params, *_to(batch, self.device)))
            n += 1
        return {"cost": total / max(n, 1)}
