"""The fluid executor on a mesh — the port's counterpart of the GSPMD path
of ``paddle_tpu/fluid/executor.py`` (``Executor(mesh=, layout=)``).

JAX compiles a block through ``jax.jit(..., in_shardings=...,
out_shardings=...)`` and GSPMD partitions it. The port runs SPMD over
``torch.distributed``, one rank a mesh device, following
``parallel.DataParallel``'s design:

* **Storage.** Each persistable is held sharded by the resolved layout
  (``SpecLayout.resolve`` with the executor's annotation rules): the
  scope keeps a DTensor whose block on this rank is the rank's shard, so
  the bytes a rank holds equal JAX's bytes a device.
* **A run** gathers the persistables (an all-gather over their sharded
  axes), splits the feed rows over the batch axes (a feed's dim 0 under
  its resolved spec, ``data`` unless annotated), runs the block's ops on
  this rank's rows, and keeps this rank's block of every updated
  persistable (written in place into the DTensor's block when the run
  donates it). It runs eagerly: gloo cannot be captured in a CUDA graph.
* **The gradient.** Every rank's optimizer ops must see the gradient of
  the *global* loss, as GSPMD gives it. Values derived from the split
  feed rows are tracked as row-sharded; every other value is replicated.
  A reduction over the batch rows (``mean``, and ``reduce_sum``/
  ``reduce_mean`` over dim 0 or all dims) sums across the batch axes in
  the forward (``collectives.all_reduce``, whose backward is the
  identity: its output is replicated). A replicated value that enters a
  row-sharded op receives from it only this rank's rows' part of its
  cotangent, so that part is summed across the batch axes: for a
  parameter, once after the backward (:class:`_Partial` keeps the part
  aside, :meth:`MeshRun.finish` sums it, one collective a parameter, and
  adds it to what the parameter's replicated uses gave); for any other
  replicated value (a batch statistic, a cast parameter) inside the
  backward, before it flows on (:class:`_ToRows`). So every parameter's
  gradient is the global loss's on every rank, whether it reaches the
  loss through the batch rows, around them (a parameter-only term such
  as ``reduce_sum(square(W))``) or both. No rank count is divided by: a
  ``reduce_sum`` loss gets the sum's gradient.
* **Ops that mix rows.** An op whose inputs hold row-sharded values is
  run only where it is known to act row by row (:data:`ROW_LOCAL` along
  an axis other than the batch axis, and ``mul``/``matmul`` with only X
  sharded), and its outputs must keep the rows. A training ``dropout``
  draws the global mask and keeps this rank's rows, as one device draws
  it. Any other such op (the batch statistics of a training
  ``batch_norm``, ``accuracy``'s counts, a ``reshape`` that may move the
  batch dim, ``softmax``/``l2_normalize``/``argmax`` along the batch
  axis, control flow) raises naming ROADMAP A.7b: it never returns a
  rank-local result quietly.
* **Fetches** come back as the global value: a row-sharded one gathered
  over the batch axes in rank order.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import torch

#: ops that act on each batch row on its own: a row-sharded input gives
#: row-sharded outputs
ROW_LOCAL = frozenset({
    "abs", "abs_act", "brelu", "cast", "clip", "elu", "exponential", "gelu",
    "hard_shrink", "hard_sigmoid", "leaky_relu", "log", "log_softmax",
    "pow", "power", "reciprocal", "relu", "scale", "sigmoid", "sign",
    "softmax", "softrelu", "softsign", "sqrt", "square", "stanh", "swish",
    "tanh", "thresholded_relu", "soft_shrink", "prelu", "layer_norm",
    "l2_normalize", "dropout", "assign", "fill_zeros_like", "sum",
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "equal", "not_equal", "greater_than",
    "greater_equal", "less_than", "less_equal", "logical_and",
    "logical_or", "logical_not", "cross_entropy",
    "softmax_with_cross_entropy", "sigmoid_cross_entropy_with_logits",
    "square_error", "squared_l2_distance", "huber_loss", "log_loss",
    "smooth_l1_loss", "hinge_loss", "modified_huber_loss", "rank_loss",
    "margin_rank_loss", "cos_sim", "lookup_table", "lstm", "gru",
    "simple_rnn", "sequence_last_step", "sequence_first_step",
    "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_conv", "row_conv", "context_projection", "argmax", "top_k",
    "conv2d", "depthwise_conv2d", "pool2d", "batch_norm_infer",
})

#: the row-local ops that act along an axis of one input: the input's
#: slot, and whether the op reads an ``axis`` attr (default -1) or acts
#: along the last axis. On a 1-d row-sharded input the last axis is the
#: batch axis.
AXIS_OF = {
    "softmax": ("X", True), "log_softmax": ("X", True),
    "l2_normalize": ("X", True), "argmax": ("X", True), "top_k": ("X", False),
    "cross_entropy": ("X", False), "softmax_with_cross_entropy":
    ("Logits", False), "layer_norm": ("X", False), "cos_sim": ("X", False),
    "squared_l2_distance": ("X", False),
}

#: reductions handled across the batch axes
BATCH_REDUCE = frozenset({"mean", "reduce_sum", "reduce_mean"})


def _a7b(site: str, what: str):
    return NotImplementedError(
        f"{site}: {what} on a mesh executor's row-sharded batch; the mesh "
        "executor runs row-local ops and the batch reductions mean, "
        "reduce_sum and reduce_mean (ROADMAP A.7b)")


class _ToRows(torch.autograd.Function):
    """A replicated value (not a parameter) entering a row-sharded op: the
    identity, whose backward sums the cotangent (this rank's rows' part)
    across the batch axes."""

    @staticmethod
    def forward(ctx, x, run):
        ctx.run = run
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.run.sum_wide(g), None


class _Partial(torch.autograd.Function):
    """A parameter entering a row-sharded op: the identity, whose backward
    keeps the cotangent (this rank's rows' part) aside for
    :meth:`MeshRun.finish` and gives the parameter nothing here."""

    @staticmethod
    def forward(ctx, x, run, name):
        ctx.run, ctx.name = run, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        part = ctx.run.partial
        part[ctx.name] = g if ctx.name not in part else part[ctx.name] + g
        return None, None, None


class MeshRun:
    """The state of one mesh run: the mesh, the batch axes the feed rows
    are split over, and the names of the row-sharded values."""

    def __init__(self, mesh, axes: Tuple[str, ...], sharded: Set[str]):
        self.mesh = mesh
        self.axes = axes
        self.sharded = set(sharded)
        #: the autodiff leaves (name -> tensor) and their kept parts
        self.leaves: Dict[str, torch.Tensor] = {}
        self.partial: Dict[str, torch.Tensor] = {}

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        from ..parallel import collectives as cc
        with self.mesh:
            return cc.all_reduce(x, self.axes, "sum")

    def sum_wide(self, g: torch.Tensor) -> torch.Tensor:
        """``g`` summed across the batch axes, in f32 for a half-precision
        one."""
        wide = g.float() if g.dtype in (torch.float16, torch.bfloat16) else g
        return self._sum(wide).to(g.dtype)

    def _rows(self, n: int, like: torch.Tensor) -> torch.Tensor:
        """The global count of ``n`` local rows (or elements)."""
        return self._sum(torch.tensor(float(n), dtype=torch.float32,
                                      device=like.device))

    def compute(self, op, site: str, compute, ins: Dict[str, List[Any]]):
        names = [n for vs in op.inputs.values() for n in vs]
        hit = [n for n in names if n in self.sharded]
        if not hit or not self.axes:
            return compute(ins, op.attrs), False
        t = op.type
        if t in BATCH_REDUCE:
            return self._reduce(op, site, compute, ins), False
        if t in ("mul", "matmul"):
            x_sharded = any(n in self.sharded for n in op.inputs.get("X", ()))
            y_sharded = any(n in self.sharded for n in op.inputs.get("Y", ()))
            if not x_sharded or y_sharded or op.attrs.get(
                    "transpose_X", False):
                raise _a7b(site, f"'{t}' with a row-sharded Y or a "
                           "transposed X")
        elif t not in ROW_LOCAL:
            raise _a7b(site, f"op '{t}' (not known to act row by row)")
        elif t in AXIS_OF:
            slot, takes_axis = AXIS_OF[t]
            x = ins[slot][0]
            axis = op.attrs.get("axis", -1) if takes_axis else -1
            if x.dim() < 2 or axis % x.dim() == 0:
                raise _a7b(site, f"'{t}' along the batch axis (axis {axis} "
                           f"of a {x.dim()}-d input)")
        rows = ins[next(k for k, vs in op.inputs.items()
                        if any(n in self.sharded for n in vs))][0].shape[0]
        ins = {k: [v if n in self.sharded else self._to_rows(n, v)
                   for n, v in zip(op.inputs[k], vs)]
               for k, vs in ins.items()}
        if t == "dropout" and not op.attrs.get("is_test", True):
            outs = self._global_draw(op, compute, ins)
        else:
            outs = compute(ins, op.attrs)
        for k, vs in outs.items():
            for v in vs:
                if not isinstance(v, torch.Tensor) or v.dim() < 1 \
                        or v.shape[0] != rows:
                    raise _a7b(site, f"'{t}' whose output '{k}' does not "
                               f"keep the {rows} rows of its input")
        return outs, True

    def _to_rows(self, name, v):
        if not (isinstance(v, torch.Tensor) and v.requires_grad
                and torch.is_grad_enabled()):
            return v
        if self.leaves.get(name) is v:
            return _Partial.apply(v, self, name)
        return _ToRows.apply(v, self)

    def finish(self, names: Sequence[str],
               grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The autodiff's gradients with each parameter's kept part summed
        across the batch axes and added: the global loss's gradient."""
        out = []
        for name, g in zip(names, grads):
            part = self.partial.pop(name, None)
            out.append(g if part is None else g + self.sum_wide(part))
        return out

    def _global_draw(self, op, compute, ins):
        """A training dropout's mask as one device draws it for the global
        batch, this rank's rows of it."""
        from ..parallel.sharding import P, cut
        full = compute(dict(ins, X=[self.gather_rows(ins["X"][0])]),
                       op.attrs)["Out"][0]
        return {"Out": [cut(full, self.mesh, P(self.axes))]}

    def _reduce(self, op, site, compute, ins):
        x = ins["X"][0]
        t = op.type
        if t == "mean":
            local = compute(ins, op.attrs)["Out"][0]
            total = self._sum(local * float(x.numel()))
            return {"Out": [total / self._rows(x.numel(), x)
                            .to(total.dtype)]}
        dim = op.attrs.get("dim")
        dims = (list(range(x.dim())) if dim is None else
                [d % max(x.dim(), 1) for d in
                 (dim if isinstance(dim, (list, tuple)) else [dim])])
        if 0 not in dims:
            raise _a7b(site, f"'{t}' that keeps the batch dim")
        if t == "reduce_sum":
            out = compute(ins, op.attrs)["Out"][0]
            return {"Out": [self._sum(out)]}
        # reduce_mean over the batch dim: the local mean weighted by the
        # local count of what it averaged, over the global count
        n = 1
        for d in dims:
            n *= x.shape[d]
        out = compute(ins, op.attrs)["Out"][0]
        total = self._sum(out * float(n))
        return {"Out": [total / self._rows(n, x).to(total.dtype)]}

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A row-sharded value's global value: its rows of every rank in
        rank order."""
        from ..parallel import collectives as cc
        with self.mesh:
            return cc.all_gather(x, self.axes, axis=0)


#: the mesh run in progress (the executor runs one block at a time)
CURRENT: Optional[MeshRun] = None


def batch_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a feed spec splits dim 0 over."""
    if not len(spec) or spec[0] is None:
        return ()
    e = spec[0]
    return (e,) if isinstance(e, str) else tuple(e)
