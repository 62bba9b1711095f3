"""Parameter-update hooks — the counterpart of
``paddle_tpu/optimizer/hooks.py`` (the reference's ParameterUpdaterHook):
``StaticHook`` discards a parameter's update (a frozen embedding),
``PruningHook`` zeroes a magnitude mask fixed at init after every update.
Hooks attach by a regex on the parameter's path (``embed/w``), the first
matching rule wins, and their state lives in ``opt_state["hooks"]``."""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import torch


def path_str(path) -> str:
    """A path (a tuple of keys, as ``core.pytree.tree_items`` gives it) as
    'l1/w', the string the rules match."""
    return "/".join(str(k) for k in path)


class ParameterHook:
    """Base hook: optional per-parameter state + post-update transform."""

    def init_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def apply(self, p_new: torch.Tensor, p_old: torch.Tensor,
              hook_state: Dict[str, torch.Tensor]) -> torch.Tensor:
        return p_new


class StaticHook(ParameterHook):
    """Frozen parameter: the update is discarded (the slots still
    advance)."""

    def apply(self, p_new, p_old, hook_state):
        return p_old


class PruningHook(ParameterHook):
    """A magnitude mask computed once from the initial values: the
    ``sparsity_ratio`` smallest entries (exactly that many, ties by
    index, as JAX's stable argsort) are forced to zero after every
    update."""

    def __init__(self, sparsity_ratio: float = 0.75):
        if not 0.0 <= sparsity_ratio < 1.0:
            raise ValueError("sparsity_ratio in [0, 1)")
        self.sparsity_ratio = sparsity_ratio

    def init_state(self, p):
        k = int(p.numel() * self.sparsity_ratio)
        mask = torch.ones(p.numel(), dtype=p.dtype, device=p.device)
        if k:
            order = torch.argsort(p.abs().reshape(-1), stable=True)
            mask[order[:k]] = 0
        return {"mask": mask.reshape(p.shape)}

    def apply(self, p_new, p_old, hook_state):
        return p_new * hook_state["mask"]


class HookSet:
    """(pattern, hook) rules; first match wins — attach with
    ``Optimizer(..., hooks=HookSet([(r"embed/w$", StaticHook())]))``."""

    def __init__(self, rules: List[Tuple[str, ParameterHook]]):
        self.rules = [(re.compile(pat), h) for pat, h in rules]

    def match(self, path) -> Optional[ParameterHook]:
        s = path_str(path)
        for pat, h in self.rules:
            if pat.search(s):
                return h
        return None
