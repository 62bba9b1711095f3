"""First-order optimizers — the counterpart of
``paddle_tpu/optimizer/optimizers.py`` for ``SGD``, ``Momentum`` and
``Adam``.

Functional, as in JAX: ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)`` over nested
dicts of tensors (``core/pytree.py``). The state is
``{"step": int32 scalar, "slots": <the params tree with a slot dict at
each leaf>}``, the JAX layout, so JAX state carries across through
``convert.tree_from_numpy``. ``update`` runs without autograd and makes
new tensors; ``apply_`` runs the same ops and writes their results into
the params and the state in place (the trainer's step graph on the card,
where JAX donates both to one fused computation). Leaves under a
``"stats"`` key (non-trainable running state) pass through untouched.
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

    def _steps(self, grads: Mapping, state: State, params: Mapping):
        """The new step and, for every trainable leaf, (path, p, slot, new
        p, new slot): ``apply_one`` on the weight-decayed gradient."""
        step = state["step"] + 1
        lr = self.lr(step.to(torch.float32))
        out = []
        for path, p in tree_items(params):
            if "stats" in path:
                continue
            slot = tree_get(state["slots"], path)
            g = tree_get(grads, path)
            if self.weight_decay:
                g = g + self.weight_decay * p
            out.append((path, p, slot) + self.apply_one(p, g, slot, lr,
                                                        step))
        return step, out

    @torch.no_grad()
    def update(self, grads: Mapping, state: State, params: Mapping
               ) -> Tuple[Params, State]:
        step, leaves = self._steps(grads, state, params)
        new_p = dict((path, p) for path, p in tree_items(params))
        new_s = {path: tree_get(state["slots"], path) for path in new_p}
        for path, _, _, np_, ns_ in leaves:
            new_p[path], new_s[path] = np_, ns_
        return tree_from_items(new_p.items()), {
            "step": step, "slots": tree_from_items(new_s.items())}

    @torch.no_grad()
    def apply_(self, grads: Mapping, state: State, params: Mapping) -> None:
        """:meth:`update` written into ``params`` and ``state`` in place:
        the same ops, each result then copied over the tensor it
        replaces."""
        step, leaves = self._steps(grads, state, params)
        for _, p, slot, np_, ns_ in leaves:
            for k, v in ns_.items():
                slot[k].copy_(v)
            p.copy_(np_)
        state["step"].copy_(step)


class SGD(Optimizer):
    """Plain SGD: p - lr * g."""

    def apply_one(self, p, g, slot, lr, step):
        return p - lr * g, slot


class Momentum(Optimizer):
    """Momentum, or Nesterov's: v = mu * v + g, then p - lr * v (Nesterov:
    p - lr * (g + mu * v)). Every leaf has a ``velocity`` slot, the stats'
    too, as in JAX; the stats' is never used."""

    def __init__(self, learning_rate: Union[float, Schedule] = 0.01,
                 momentum: float = 0.9, use_nesterov: bool = False, **kw):
        super().__init__(learning_rate, **kw)
        self.mu, self.nesterov = momentum, use_nesterov

    def init_slot(self, p):
        return {"velocity": torch.zeros_like(p)}

    def apply_one(self, p, g, slot, lr, step):
        v = self.mu * slot["velocity"] + g
        step_dir = g + self.mu * v if self.nesterov else v
        return p - lr * step_dir, {"velocity": v}


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
