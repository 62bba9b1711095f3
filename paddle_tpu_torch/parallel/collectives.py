"""Named collectives — the counterpart of ``paddle_tpu/parallel/collectives.py``.

Each collective takes a mesh axis name and resolves it, through the
mesh in scope (``shard_map``, ``use_mesh``, ``with mesh:``;
``mesh.axis_mesh``), to that dimension's process group. The semantics
are JAX's (``lax.psum``/``pmean``/``pmax``/``pmin``, ``all_gather``
tiled and untiled, ``psum_scatter`` tiled, ``all_to_all`` tiled,
``ppermute`` around the axis ring, ``axis_index``).

The transport is the world's backend. NCCL (a card per rank) runs every
collective on the card, its reductions included. Over gloo the port
moves data only: a reduction is a transport (an all-to-all of chunks,
then an all-gather) and a sum on the tensor's own device, in rank order,
so every rank gets the same bits and no collective computes on the CPU
for a CUDA tensor. gloo takes CUDA tensors for some transports (its
broadcast, all-gather and all-to-all copy through the host themselves:
``GLOO_CUDA_OPS``); for the others (send and receive) the port copies
the tensor through pinned host memory, counted in
``STAGED[(op, backend)]`` (bytes through the host and calls). That copy
is the one card machine's: it has one card, NCCL refuses two ranks on
one device, so its world is gloo ranks that all sit on ``cuda:0``. A
backend that is neither raises.

Differentiable (``torch.autograd``): the all-to-all and the ring
permutation pass cotangents back the way the data came; a reduce-scatter
all-gathers them; a sum or mean over an axis, an all-gather and a
broadcast treat their output as replicated (every rank holds the same
cotangent), so the sum's backward is the identity (the mean's divides
by the axis size), the gather's keeps this rank's block and the
broadcast's gives the root the cotangent. That is the convention of
Megatron's regions, and it is what a loss summed over a ``seq`` or
``model`` axis needs. ``max`` and ``min`` are not differentiable.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from .mesh import Mesh, axis_mesh

AxisName = Union[str, Sequence[str]]

#: transports gloo takes as CUDA tensors (it copies through the host
#: itself); every other transport of a CUDA tensor over gloo is staged
GLOO_CUDA_OPS = frozenset({"broadcast", "all_gather", "all_to_all"})

#: host staging of CUDA tensors over gloo, by (transport, backend):
#: {"bytes": bytes copied to and from pinned host memory, "calls": n}
STAGED: Dict[Tuple[str, str], Dict[str, int]] = {}


def reset_staged() -> None:
    STAGED.clear()


def _count(op: str, backend: str, nbytes: int) -> None:
    entry = STAGED.setdefault((op, backend), {"bytes": 0, "calls": 0})
    entry["bytes"] += int(nbytes)
    entry["calls"] += 1


def _dist():
    import torch.distributed as dist
    return dist


class _Axis:
    """One mesh axis as a collective sees it."""

    def __init__(self, name: str, mesh: Optional[Mesh] = None):
        self.mesh: Mesh = mesh if mesh is not None else axis_mesh(name)
        self.name = name
        self.n = self.mesh.shape[name]
        self.index = self.mesh.coordinate(name)
        self.ranks = self.mesh.group_ranks(name)
        self.group = self.mesh.get_group(name)
        self.backend = self.mesh.backend
        if self.backend not in ("gloo", "nccl"):
            raise RuntimeError(f"the {self.backend!r} backend runs no "
                               "collective of the port (gloo or nccl)")

    def check(self, op: str, x: torch.Tensor) -> bool:
        """Whether ``x`` goes through pinned host memory for ``op``;
        raises where the backend takes no such tensor."""
        if self.backend == "nccl":
            if not x.is_cuda:
                raise RuntimeError(f"{op} over nccl needs CUDA tensors, got "
                                   f"{x.device}")
            return False
        return x.is_cuda and op not in GLOO_CUDA_OPS


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


# ---------------------------------------------------------------------------
# transports (no arithmetic)
# ---------------------------------------------------------------------------

def _gather_parts(x: torch.Tensor, ax: _Axis):
    """Every rank's ``x`` along the axis, in axis order."""
    dist = _dist()
    x = x.contiguous()
    if ax.check("all_gather", x):
        h = _to_host(x)
        parts = [torch.empty_like(h) for _ in range(ax.n)]
        dist.all_gather(parts, h, group=ax.group)
        _count("all_gather", ax.backend, x.nbytes * (1 + ax.n))
        return [p.to(x.device) for p in parts]
    parts = [torch.empty_like(x) for _ in range(ax.n)]
    dist.all_gather(parts, x, group=ax.group)
    return parts


def _exchange(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """All-to-all over dim 0: chunk j of ``x`` goes to rank j of the
    axis; chunk j of the result came from rank j."""
    dist = _dist()
    x = x.contiguous()
    if ax.check("all_to_all", x):
        h = _to_host(x)
        out = torch.empty_like(h)
        dist.all_to_all_single(out, h, group=ax.group)
        _count("all_to_all", ax.backend, 2 * x.nbytes)
        return out.to(x.device)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=ax.group)
    return out


def _shift(x: torch.Tensor, ax: _Axis, shift: int) -> torch.Tensor:
    """Send ``x`` to rank (i + shift) of the axis ring; return what rank
    (i - shift) sent (``x`` itself where that is this rank)."""
    if ax.n == 1 or shift % ax.n == 0:
        return x
    dist = _dist()
    dst = ax.ranks[(ax.index + shift) % ax.n]
    src = ax.ranks[(ax.index - shift) % ax.n]
    x = x.contiguous()
    staged = ax.check("send_recv", x)
    send = _to_host(x) if staged else x
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dst, ax.group),
           dist.P2POp(dist.irecv, recv, src, ax.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        _count("send_recv", ax.backend, 2 * x.nbytes)
        return recv.to(x.device)
    return recv


def _broadcast(x: torch.Tensor, ax: _Axis, root: int) -> torch.Tensor:
    dist = _dist()
    buf = x.contiguous().clone()
    staged = ax.check("broadcast", buf)
    h = _to_host(buf) if staged else buf
    dist.broadcast(h, src=ax.ranks[root], group=ax.group)
    if staged:
        _count("broadcast", ax.backend, 2 * x.nbytes)
        return h.to(x.device)
    return h


# ---------------------------------------------------------------------------
# reductions: NCCL natively; over gloo a transport and a sum on the device
# ---------------------------------------------------------------------------

_REDUCE = {"sum": lambda t: t.sum(0), "max": lambda t: t.amax(0),
           "min": lambda t: t.amin(0)}
_NCCL_OP = {"sum": "SUM", "max": "MAX", "min": "MIN"}


def _reduce_chunks(x: torch.Tensor, ax: _Axis, op: str) -> torch.Tensor:
    """Reduce-scatter over dim 0 (its size a multiple of the axis size):
    this rank's chunk of the reduction over the axis."""
    n = ax.n
    if ax.backend == "nccl":
        ax.check("reduce_scatter", x)
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _dist().reduce_scatter_tensor(
            out, x.contiguous(), op=getattr(_dist().ReduceOp, _NCCL_OP[op]),
            group=ax.group)
        return out
    got = _exchange(x, ax)
    return _REDUCE[op](got.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])))


def _all_reduce(x: torch.Tensor, ax: _Axis, op: str) -> torch.Tensor:
    if ax.backend == "nccl":
        ax.check("all_reduce", x)
        out = x.contiguous().clone()
        _dist().all_reduce(out, op=getattr(_dist().ReduceOp, _NCCL_OP[op]),
                           group=ax.group)
        return out
    flat = x.reshape(-1)
    pad = (-flat.numel()) % ax.n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    part = _reduce_chunks(flat, ax, op)
    full = torch.cat(_gather_parts(part, ax))
    return full[:x.numel()].reshape(x.shape)


def _axes(axis_name: AxisName) -> Tuple[str, ...]:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, scale):
        out = x
        for name in _axes(axis_name):
            out = _all_reduce(out, _Axis(name), "sum")
        ctx.scale = scale
        return out * scale if scale != 1 else out

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.scale if ctx.scale != 1 else g), None, None


def all_reduce(x: torch.Tensor, axis_name: AxisName, op: str = "sum"):
    """Sum/mean/max/min over a mesh axis (or a tuple of axes)
    (ncclAllReduce analog, nccl_op.cc:66)."""
    if op in ("sum", "mean"):
        n = 1
        for name in _axes(axis_name):
            n *= axis_mesh(name).shape[name]
        return _AllReduce.apply(x, axis_name, 1.0 / n if op == "mean" else 1)
    if op in ("max", "min"):
        out = x.detach()
        for name in _axes(axis_name):
            out = _all_reduce(out, _Axis(name), op)
        return out
    raise ValueError(f"unknown reduction {op}")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, axis, tiled):
        ax = _Axis(axis_name)
        parts = _gather_parts(x, ax)
        ctx.meta = (ax.index, axis, tiled, x.shape[axis] if tiled else 1)
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    @staticmethod
    def backward(ctx, g):
        idx, axis, tiled, w = ctx.meta
        if tiled:
            return g.narrow(axis, idx * w, w), None, None, None
        return g.select(axis, idx), None, None, None


def all_gather(x: torch.Tensor, axis_name: AxisName, axis: int = 0,
               tiled: bool = True):
    """Concatenate shards from every rank along ``axis`` (``tiled``), or
    stack them at ``axis``. A tuple of axes gathers the last first, so the
    first is the major order, as JAX orders them."""
    axis = axis % (x.dim() + (0 if tiled else 1))
    names = _axes(axis_name)
    if len(names) > 1 and not tiled:
        raise ValueError("an untiled all_gather takes one axis")
    for name in reversed(names):
        x = _AllGather.apply(x, name, axis, tiled)
    return x


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, axis):
        ax = _Axis(axis_name)
        if x.shape[axis] % ax.n:
            raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)}"
                             f" does not split into {ax.n} shards")
        ctx.meta = (axis_name, axis, ax.mesh)
        out = _reduce_chunks(x.movedim(axis, 0), ax, "sum")
        return out.movedim(0, axis)

    @staticmethod
    def backward(ctx, g):
        axis_name, axis, mesh = ctx.meta
        parts = _gather_parts(g, _Axis(axis_name, mesh))
        return torch.cat(parts, axis), None, None


def reduce_scatter(x: torch.Tensor, axis_name: str, axis: int = 0):
    """Sum then scatter shards — the ZeRO grad-shard primitive."""
    return _ReduceScatter.apply(x, axis_name, axis % x.dim())


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, root):
        ax = _Axis(axis_name)
        ctx.is_root = ax.index == root
        return _broadcast(x, ax, root)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_root else torch.zeros_like(g)), None, None


def broadcast(x: torch.Tensor, axis_name: str, root: int = 0):
    """Every rank gets root's value (ncclBcast analog, nccl_op.cc:119)."""
    return _Broadcast.apply(x, axis_name, root)


def _all_to_all(x, ax, split_axis, concat_axis):
    n = ax.n
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not split into {n} shards")
    # chunk j of split_axis goes to rank j; received chunks stack by source
    parts = x.movedim(split_axis, 0)
    parts = parts.reshape((n, parts.shape[0] // n) + tuple(parts.shape[1:]))
    got = _exchange(parts, ax)
    got = got.movedim(1, split_axis + 1)        # [n, ...x with split/n...]
    return torch.cat(got.unbind(0), concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, split_axis, concat_axis):
        ax = _Axis(axis_name)
        ctx.meta = (ax, split_axis, concat_axis)
        return _all_to_all(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ax, split_axis, concat_axis = ctx.meta
        return _all_to_all(g, ax, concat_axis, split_axis), None, None, None


def all_to_all(x: torch.Tensor, axis_name: str, split_axis: int,
               concat_axis: int):
    """Transpose shard ownership — the Ulysses/sequence<->head exchange
    primitive (tiled: ``split_axis`` shrinks n-fold, ``concat_axis``
    grows n-fold, the received blocks in rank order)."""
    return _AllToAll.apply(x, axis_name, split_axis % x.dim(),
                           concat_axis % x.dim())


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis_name, shift):
        ax = _Axis(axis_name)
        ctx.meta = (ax, shift)
        return _shift(x, ax, shift)

    @staticmethod
    def backward(ctx, g):
        ax, shift = ctx.meta
        return _shift(g, ax, -shift), None, None


def permute_ring(x: torch.Tensor, axis_name: str, shift: int = 1):
    """Pass each shard to the next rank on the axis ring (JAX's
    ``ppermute`` over [(i, i + shift)]): a batched send and receive."""
    return _Permute.apply(x, axis_name, shift)


def axis_index(axis_name: str) -> torch.Tensor:
    """This rank's coordinate on a mesh axis (trainer_id analog), an int32
    scalar on the rank's device."""
    mesh = axis_mesh(axis_name)
    return torch.tensor(mesh.coordinate(axis_name), dtype=torch.int32,
                        device=mesh.device)
