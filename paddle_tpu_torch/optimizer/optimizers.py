"""First-order optimizers — the counterpart of
``paddle_tpu/optimizer/optimizers.py``: ``SGD``, ``Momentum``,
``Adagrad``, ``DecayedAdagrad``, ``Adadelta``, ``RMSProp``, ``Adam``,
``Adamax``, ``ProximalGD``, ``Ftrl`` and ``ParameterAverager``.

Functional, as in JAX: ``init(params) -> state`` and
``update(grads, state, params) -> (new_params, new_state)`` over nested
dicts of tensors (``core/pytree.py``). The state is
``{"step": int32 scalar, "slots": <the params tree with a slot dict at
each leaf>}`` and, with hooks, ``"hooks"`` (a hook state a leaf), the
JAX layout, so JAX state carries across through
``convert.tree_from_numpy``. Before the update the gradients get, in
JAX's order, L2 weight decay, L1 decay and clipping (``grad_clip``:
``("value" | "norm" | "global_norm", bound)``); after it each matched
hook transforms the new parameter. ``update`` runs without autograd and
makes new tensors; ``apply_`` runs the same ops and writes their results
into the params and the state in place (the trainer's step graph on the
card, where JAX donates both to one fused computation), each write
selected by ``ok`` when one is given (the trainer's non-finite-loss
guard: ``where(ok, new, old)``, the step counter too). Leaves under a
``"stats"`` key (non-trainable running state) pass through untouched.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from ..core.pytree import tree_from_items, tree_get, tree_items, tree_map
from . import clip as clip_mod

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
    """Base: the lr schedule, L2 and L1 decay, clipping, hooks and the
    update loop."""

    def __init__(self, learning_rate: Union[float, Schedule] = 0.01,
                 weight_decay: float = 0.0, l1_decay: float = 0.0,
                 grad_clip: Optional[Tuple[str, float]] = None,
                 hooks=None):
        self.lr = _sched(learning_rate)
        self.weight_decay = weight_decay
        self.l1_decay = l1_decay
        self.grad_clip = grad_clip
        self.hooks = hooks          # optimizer.hooks.HookSet or None

    def init_slot(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def apply_one(self, p, g, slot, lr, step
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    @torch.no_grad()
    def init(self, params: Mapping) -> State:
        leaves = tree_items(params)
        device = leaves[0][1].device if leaves else None
        state = {"step": torch.zeros((), dtype=torch.int32, device=device),
                 "slots": tree_map(self.init_slot, params)}
        if self.hooks is not None:
            states = []
            for path, p in leaves:
                h = self.hooks.match(path)
                states.append((path, h.init_state(p) if h is not None
                               else {}))
            state["hooks"] = tree_from_items(states)
        return state

    def _preprocess(self, grads: Mapping, params: Mapping):
        if self.weight_decay:
            grads = tree_map(lambda g, p: g + self.weight_decay * p, grads,
                             params)
        if self.l1_decay:
            grads = tree_map(lambda g, p: g + self.l1_decay * torch.sign(p),
                             grads, params)
        if self.grad_clip is not None:
            kind, val = self.grad_clip
            if kind == "value":
                grads = clip_mod.clip_by_value(grads, -val, val)
            elif kind == "norm":
                grads = clip_mod.clip_by_norm(grads, val)
            elif kind == "global_norm":
                grads = clip_mod.clip_by_global_norm(grads, val)
            else:
                raise ValueError(f"unknown clip kind {kind}")
        return grads

    def _steps(self, grads: Mapping, state: State, params: Mapping):
        """The new step and, for every trainable leaf, (path, p, slot, new
        p, new slot): ``apply_one`` on the preprocessed gradient, then the
        leaf's hook."""
        step = state["step"] + 1
        lr = self.lr(step.to(torch.float32))
        grads = self._preprocess(grads, params)
        hooks = state.get("hooks") if self.hooks is not None else None
        out = []
        for path, p in tree_items(params):
            if "stats" in path:
                continue
            slot = tree_get(state["slots"], path)
            new_p, new_s = self.apply_one(p, tree_get(grads, path), slot, lr,
                                          step)
            h = self.hooks.match(path) if hooks is not None else None
            if h is not None:
                new_p = h.apply(new_p, p, tree_get(hooks, path))
            out.append((path, p, slot, new_p, new_s))
        return step, out

    @torch.no_grad()
    def update(self, grads: Mapping, state: State, params: Mapping
               ) -> Tuple[Params, State]:
        step, leaves = self._steps(grads, state, params)
        new_p = dict((path, p) for path, p in tree_items(params))
        new_s = {path: tree_get(state["slots"], path) for path in new_p}
        for path, _, _, np_, ns_ in leaves:
            new_p[path], new_s[path] = np_, ns_
        out = {"step": step, "slots": tree_from_items(new_s.items())}
        if "hooks" in state:
            out["hooks"] = state["hooks"]
        return tree_from_items(new_p.items()), out

    @torch.no_grad()
    def apply_(self, grads: Mapping, state: State, params: Mapping,
               ok: Optional[torch.Tensor] = None) -> None:
        """:meth:`update` written into ``params`` and ``state`` in place:
        the same ops, each result then copied over the tensor it
        replaces; with ``ok`` (a 0-d bool tensor) each write is
        ``where(ok, new, old)``, so a false ``ok`` leaves every tensor,
        the step included, as it was, with nothing read back."""
        step, leaves = self._steps(grads, state, params)
        if ok is None:
            def sel(new, old):
                return new
        else:
            def sel(new, old):
                return torch.where(ok, new, old)
        for _, p, slot, np_, ns_ in leaves:
            for k, v in ns_.items():
                slot[k].copy_(sel(v, slot[k]))
            p.copy_(sel(np_, p))
        state["step"].copy_(sel(step, state["step"]))


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


class Adagrad(Optimizer):
    """m += g², then p - lr * g / (sqrt(m) + eps)."""

    def __init__(self, learning_rate=0.01, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.eps = epsilon

    def init_slot(self, p):
        return {"moment": torch.zeros_like(p)}

    def apply_one(self, p, g, slot, lr, step):
        m = slot["moment"] + torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.eps), {"moment": m}


class DecayedAdagrad(Optimizer):
    """m = decay * m + (1 - decay) * g², then Adagrad's step."""

    def __init__(self, learning_rate=0.01, decay=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.decay, self.eps = decay, epsilon

    def init_slot(self, p):
        return {"moment": torch.zeros_like(p)}

    def apply_one(self, p, g, slot, lr, step):
        m = self.decay * slot["moment"] + (1.0 - self.decay) * torch.square(g)
        return p - lr * g / (torch.sqrt(m) + self.eps), {"moment": m}


class Adadelta(Optimizer):
    """Adadelta with running averages of g² and of the update²."""

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1e-6, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.eps = rho, epsilon

    def init_slot(self, p):
        return {"avg_sq_grad": torch.zeros_like(p),
                "avg_sq_update": torch.zeros_like(p)}

    def apply_one(self, p, g, slot, lr, step):
        asg = (self.rho * slot["avg_sq_grad"]
               + (1.0 - self.rho) * torch.square(g))
        upd = (torch.sqrt(slot["avg_sq_update"] + self.eps)
               / torch.sqrt(asg + self.eps) * g)
        asu = (self.rho * slot["avg_sq_update"]
               + (1.0 - self.rho) * torch.square(upd))
        return p - lr * upd, {"avg_sq_grad": asg, "avg_sq_update": asu}


class RMSProp(Optimizer):
    """RMSProp with a momentum slot: ms = rho * ms + (1 - rho) * g²,
    mom = mu * mom + lr * g / sqrt(ms + eps), p - mom."""

    def __init__(self, learning_rate=0.01, rho=0.95, epsilon=1e-6,
                 momentum=0.0, **kw):
        super().__init__(learning_rate, **kw)
        self.rho, self.eps, self.mu = rho, epsilon, momentum

    def init_slot(self, p):
        return {"mean_square": torch.zeros_like(p),
                "moment": torch.zeros_like(p)}

    def apply_one(self, p, g, slot, lr, step):
        ms = (self.rho * slot["mean_square"]
              + (1.0 - self.rho) * torch.square(g))
        mom = self.mu * slot["moment"] + lr * g / torch.sqrt(ms + self.eps)
        return p - mom, {"mean_square": ms, "moment": mom}


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


class Adamax(Optimizer):
    """Adam's first moment over an infinity-norm second: u = max(b2 * u,
    |g|), p - lr / (1 - b1^t) * m / (u + eps)."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kw):
        super().__init__(learning_rate, **kw)
        self.b1, self.b2, self.eps = beta1, beta2, epsilon

    def init_slot(self, p):
        return {"m": torch.zeros_like(p), "u": torch.zeros_like(p)}

    def apply_one(self, p, g, slot, lr, step):
        t = step.to(torch.float32)
        m = self.b1 * slot["m"] + (1.0 - self.b1) * g
        u = torch.maximum(self.b2 * slot["u"], torch.abs(g))
        p = p - lr / (1.0 - torch.pow(self.b1, t)) * m / (u + self.eps)
        return p, {"m": m, "u": u}


class ProximalGD(Optimizer):
    """The L1/L2 proximal step: soft-threshold p - lr * g by lr * l1, then
    divide by 1 + lr * l2."""

    def __init__(self, learning_rate=0.01, l1: float = 0.0, l2: float = 0.0,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2 = l1, l2

    def apply_one(self, p, g, slot, lr, step):
        prox = p - lr * g
        if self.l1 > 0:
            prox = torch.sign(prox) * torch.clamp(
                torch.abs(prox) - lr * self.l1, min=0.0)
        return prox / (1.0 + lr * self.l2), slot


class Ftrl(Optimizer):
    """FTRL-proximal with squared and linear accumulators."""

    def __init__(self, learning_rate=0.01, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kw):
        super().__init__(learning_rate, **kw)
        self.l1, self.l2, self.lr_power = l1, l2, lr_power

    def init_slot(self, p):
        return {"squared": torch.zeros_like(p),
                "linear": torch.zeros_like(p)}

    def apply_one(self, p, g, slot, lr, step):
        n, z = slot["squared"], slot["linear"]
        n_new = n + torch.square(g)
        sigma = (torch.pow(n_new, -self.lr_power)
                 - torch.pow(torch.clamp(n, min=1e-38), -self.lr_power)) / lr
        z_new = z + g - sigma * p
        denom = torch.pow(n_new, -self.lr_power) / lr + 2.0 * self.l2
        p_new = torch.where(
            torch.abs(z_new) > self.l1,
            -(z_new - torch.sign(z_new) * self.l1) / denom,
            torch.zeros_like(z_new))
        return p_new, {"squared": n_new, "linear": z_new}


class ParameterAverager:
    """Parameter averaging for evaluation (the reference's
    AverageOptimizer). ``average_window`` in (0, 1) is an exponential
    moving average with that decay (bias-corrected as Adam's m-hat), 0 a
    plain mean over every accumulated step; ``average`` gives the raw
    params until ``min_count`` accumulations."""

    def __init__(self, average_window: float = 0.0, min_count: int = 0):
        self.window = average_window
        self.min_count = min_count

    @torch.no_grad()
    def init(self, params: Mapping) -> State:
        leaves = tree_items(params)
        device = leaves[0][1].device if leaves else None
        return {"sum": tree_map(torch.zeros_like, params),
                "count": torch.zeros((), dtype=torch.float32,
                                     device=device)}

    @torch.no_grad()
    def accumulate(self, state: State, params: Mapping) -> State:
        if self.window > 0.0:
            w = self.window
            total = tree_map(lambda s, p: w * s + (1.0 - w) * p,
                             state["sum"], params)
        else:
            total = tree_map(lambda s, p: s + p, state["sum"], params)
        return {"sum": total, "count": state["count"] + 1.0}

    @torch.no_grad()
    def average(self, state: State, params: Mapping) -> Params:
        c = torch.clamp(state["count"], min=1.0)
        if self.window > 0.0:
            avg = tree_map(lambda s: s / (1.0 - torch.pow(self.window, c)),
                           state["sum"])
        else:
            avg = tree_map(lambda s: s / c, state["sum"])
        use_avg = state["count"] >= self.min_count
        return tree_map(lambda a, p: torch.where(use_avg, a, p), avg, params)
