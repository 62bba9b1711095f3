"""First-order optimizers — the counterpart of
``paddle_tpu/optimizer/optimizers.py`` for ``SGD`` and ``Adam``.

Functional, as in JAX: ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)`` over nested
dicts of tensors (``core/pytree.py``). The state is
``{"step": int32 scalar, "slots": <the params tree with a slot dict at
each leaf>}``, the JAX layout, so JAX state carries across through
``convert.tree_from_numpy``. The update runs without autograd and makes
new tensors; nothing is updated in place. Leaves under a ``"stats"`` key
(non-trainable running state) pass through untouched.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple, Union

import torch

from ..core.pytree import tree_from_items, tree_get, tree_items, tree_map

Params = Dict[str, Any]
State = Dict[str, Any]
Schedule = Callable[[torch.Tensor], torch.Tensor]


def _sched(lr: Union[float, Schedule]) -> Schedule:
    """A learning-rate schedule of the f32 step (a constant if ``lr`` is a
    number)."""
    if callable(lr):
        return lr
    return lambda step: torch.full_like(step, float(lr))


class Optimizer:
    """Base: the lr schedule, L2 weight decay and the update loop."""

    def __init__(self, learning_rate: Union[float, Schedule] = 0.01,
                 weight_decay: float = 0.0):
        self.lr = _sched(learning_rate)
        self.weight_decay = weight_decay

    def init_slot(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def apply_one(self, p, g, slot, lr, step
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def init(self, params: Mapping) -> State:
        leaves = tree_items(params)
        device = leaves[0][1].device if leaves else None
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "slots": tree_map(self.init_slot, params)}

    @torch.no_grad()
    def update(self, grads: Mapping, state: State, params: Mapping
               ) -> Tuple[Params, State]:
        step = state["step"] + 1
        lr = self.lr(step.to(torch.float32))
        new_p, new_s = [], []
        for path, p in tree_items(params):
            slot = tree_get(state["slots"], path)
            if "stats" in path:
                new_p.append((path, p))
                new_s.append((path, slot))
                continue
            g = tree_get(grads, path)
            if self.weight_decay:
                g = g + self.weight_decay * p
            np_, ns_ = self.apply_one(p, g, slot, lr, step)
            new_p.append((path, np_))
            new_s.append((path, ns_))
        return tree_from_items(new_p), {"step": step,
                                        "slots": tree_from_items(new_s)}


class SGD(Optimizer):
    """Plain SGD: p - lr * g."""

    def apply_one(self, p, g, slot, lr, step):
        return p - lr * g, slot


class Adam(Optimizer):
    """Adam with the JAX package's bias correction: m/(1 - b1^t) and
    v/(1 - b2^t), t the f32 step, and eps outside the square root."""

    def __init__(self, learning_rate: Union[float, Schedule] = 0.001,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def init_slot(self, p):
        return {"m": torch.zeros_like(p), "v": torch.zeros_like(p)}

    def apply_one(self, p, g, slot, lr, step):
        t = step.to(torch.float32)
        m = self.b1 * slot["m"] + (1.0 - self.b1) * g
        v = self.b2 * slot["v"] + (1.0 - self.b2) * torch.square(g)
        mhat = m / (1.0 - torch.pow(self.b1, t))
        vhat = v / (1.0 - torch.pow(self.b2, t))
        return p - lr * mhat / (torch.sqrt(vhat) + self.eps), {"m": m, "v": v}
