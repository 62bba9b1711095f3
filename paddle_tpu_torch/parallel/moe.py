"""Expert parallelism: token-choice top-k mixture-of-experts FFN sharded
over the ``expert`` mesh axis — the counterpart of
``paddle_tpu/parallel/moe.py`` (GShard/Mesh-TF shape):

* tokens AND experts shard over one axis (``expert``): each rank holds
  ``T/n`` tokens and ``E/n`` experts' weights;
* each rank routes its tokens with top-k gating into a fixed-capacity
  dispatch tensor ``[E, C, D]`` (static shapes; over-capacity tokens
  drop, the GShard contract);
* one ``all_to_all`` turns rank-major dispatch into expert-major compute
  ``[E_local, n*C, D]``, the expert FFN runs as batched matmuls, and the
  reverse ``all_to_all`` brings results home, where the combine weights
  (gate probs) produce the output;
* the auxiliary load-balance loss is returned next to the output.

Capacity is per (source rank, expert). With capacity >= T_local no token
drops and the sharded output equals the dense reference. Plain matmuls,
as in JAX: no kernel runs here.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.place import DeviceLike, resolve_device
from . import collectives as cc
from .compat import shard_map
from .mesh import Mesh
from .sharding import NamedSharding, P, device_put


def init_moe_params(seed: Union[int, torch.Generator], d_model: int,
                    d_ff: int, n_experts: int, dtype=torch.float32,
                    device: DeviceLike = None) -> dict:
    """The gate and the experts' weights with JAX's distributions (normal,
    scaled by 1/sqrt(fan in)), drawn from a ``torch.Generator`` (a seed
    or one given); JAX's own weights cross over as numpy through
    ``convert.tree_from_numpy`` (keys ``gate_w``, ``w1``, ``w2``)."""
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator().manual_seed(int(seed))
    s_in = 1.0 / np.sqrt(d_model)
    s_ff = 1.0 / np.sqrt(d_ff)
    dev = resolve_device(device)

    def draw(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)

    return {"gate_w": draw((d_model, n_experts), s_in),
            "w1": draw((n_experts, d_model, d_ff), s_in),
            "w2": draw((n_experts, d_ff, d_model), s_ff)}


def _route(x, gate_w, n_experts: int, k: int, capacity: int):
    """Top-k routing for one rank's tokens.

    Returns (dispatch [T, E, C] 0/1, combine [T, E, C] prob-weighted,
    aux_loss scalar). GShard discipline: choices assign greedily per k
    (the 2nd choice only sees capacity left by the 1st), positions come
    from a cumsum over tokens, over-capacity tokens drop.
    """
    if k > n_experts:
        raise ValueError(f"top-{k} routing needs k <= n_experts "
                         f"({n_experts}): an exhausted gate row would "
                         "re-dispatch to expert 0")
    T = x.shape[0]
    logits = x @ gate_w                               # [T, E]
    probs = torch.softmax(logits, dim=-1)

    # aux load-balance loss (GShard eq.(4)): E * mean_e(gate frac * assign frac)
    top1 = torch.argmax(probs, dim=-1)
    assign_frac = F.one_hot(top1, n_experts).to(probs.dtype).mean(0)
    gate_frac = probs.mean(0)
    aux = n_experts * torch.sum(assign_frac * gate_frac)

    remaining = probs
    used = torch.zeros((n_experts,), dtype=torch.int64, device=x.device)
    dispatch = torch.zeros((T, n_experts, capacity), dtype=x.dtype,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)      # [T]
        prob = torch.gather(probs, 1, choice[:, None])[:, 0]
        onehot = F.one_hot(choice, n_experts)        # [T, E] int64
        # slot index within the chosen expert: earlier tokens first,
        # offset by the slots previous choices consumed
        pos = torch.cumsum(onehot, 0) - onehot + used[None, :]
        slot = torch.sum(pos * onehot, -1)            # [T]
        keep = slot < capacity
        oh_slot = F.one_hot(slot.clamp(max=capacity - 1),
                            capacity).to(x.dtype) * keep[:, None]
        d_k = onehot.to(x.dtype)[:, :, None] * oh_slot[:, None, :]
        dispatch = dispatch + d_k
        combine = combine + d_k * prob[:, None, None]
        used = used + torch.sum(onehot * keep[:, None], 0)
        remaining = remaining * (1.0 - onehot.to(probs.dtype))
    return dispatch, combine, aux


def _expert_ffn(tokens, w1, w2):
    """tokens [E, N, D] through each expert's 2-layer relu FFN."""
    h = torch.relu(torch.einsum("end,edf->enf", tokens, w1))
    return torch.einsum("enf,efd->end", h, w2)


def moe_ffn_dense(params, x, *, k: int = 1,
                  capacity: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device reference: x [T, D] -> (y [T, D], aux loss)."""
    E = params["gate_w"].shape[-1]
    T = x.shape[0]
    capacity = capacity if capacity is not None else T
    dispatch, combine, aux = _route(x, params["gate_w"], E, k, capacity)
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)     # [E, C, D]
    expert_out = _expert_ffn(expert_in, params["w1"], params["w2"])
    y = torch.einsum("tec,ecd->td", combine, expert_out)
    return y, aux


class ExpertParallelMoE:
    """Expert-sharded MoE FFN over mesh axis ``expert``.

    ``shard_params`` places w1/w2 expert-sharded and the gate replicated;
    ``__call__`` runs one ``shard_map`` step: tokens x [T, D] sharded
    over the axis by rows, the output returned whole (JAX's is sharded
    the same way; the port's shard_map gathers it)."""

    def __init__(self, mesh: Mesh, *, k: int = 1,
                 capacity: Optional[int] = None, axis: str = "expert"):
        self.mesh = mesh
        self.axis = axis
        self.n = mesh.shape[axis]
        self.k = k
        self.capacity = capacity

    def shard_params(self, params: dict) -> dict:
        es = NamedSharding(self.mesh, P(self.axis))
        rep = NamedSharding(self.mesh, P())
        return {"gate_w": device_put(params["gate_w"], rep),
                "w1": device_put(params["w1"], es),
                "w2": device_put(params["w2"], es)}

    def shard_tokens(self, x):
        return device_put(x, NamedSharding(self.mesh, P(self.axis, None)))

    def __call__(self, params, x) -> Tuple[torch.Tensor, torch.Tensor]:
        E = params["gate_w"].shape[-1]
        T_local = x.shape[0] // self.n
        capacity = self.capacity if self.capacity is not None else T_local
        n, axis, k = self.n, self.axis, self.k

        def local(gate_w, w1, w2, xs):
            dispatch, combine, aux = _route(xs, gate_w, E, k, capacity)
            ein = torch.einsum("tec,td->ecd", dispatch, xs)   # [E, C, D]
            # rank-major -> expert-major: [n, E_l, C, D] over the axis
            el = E // n
            ein = ein.reshape(n, el, capacity, -1)
            recv = cc.all_to_all(ein, axis, split_axis=0, concat_axis=0)
            # recv [n, E_l, C, D]: dim 0 = source rank; fold into tokens
            tokens = recv.transpose(0, 1).reshape(el, n * capacity, -1)
            out = _expert_ffn(tokens, w1, w2)               # [E_l, n*C, D]
            back = out.reshape(el, n, capacity, -1).transpose(0, 1)
            back = cc.all_to_all(back.contiguous(), axis, split_axis=0,
                                 concat_axis=0)
            # back [n, E_l, C, D] with dim 0 = the experts' home rank
            back = back.reshape(E, capacity, -1)
            y = torch.einsum("tec,ecd->td", combine, back)
            # aux is a per-rank mean over its tokens; average over ranks
            return y, cc.all_reduce(aux, axis, "mean")

        fn = shard_map(local, mesh=self.mesh,
                       in_specs=(P(), P(axis), P(axis), P(axis, None)),
                       out_specs=(P(axis, None), P()))
        return fn(params["gate_w"], params["w1"], params["w2"], x)
