"""Abstract shape/dtype interpretation of a Program — no data, no launch.
The port's copy of ``paddle_tpu/analysis/shape_infer.py``.

Each op is evaluated over torch tensors on the ``meta`` device, which carry
a shape and a dtype and no storage.  Per-op infer rules live in
:class:`ShapeInferRegistry`, registered alongside the op registry via
:func:`register_shape_infer`; any op WITHOUT an explicit rule falls back to
running its registered compute on meta inputs (where JAX runs
``jax.eval_shape``) — the compute IS the infer rule, so the two can never
drift.  Rank/dtype mismatches (a matmul contraction that cannot work, a
concat of incompatible trailing dims) therefore surface as **S001** error
diagnostics before any kernel is launched. A compute must not read a value
back to the host where only a shape is needed: on meta that raises (and
is an S001). Random ops draw nothing on meta (``fluid/registry.py``
``_generator``).

Codes:

- **S001** op fails shape inference (the abstract evaluation raised).
- **S002** inferred shape disagrees with the var's declared desc shape
  (warning — declared shapes are layer bookkeeping, the computed value wins).
- **S003** a control-flow carried var changes shape/dtype across the loop
  body or between cond branches (loop carries must be invariant).

Dynamic (-1) dims in feed declarations are substituted with small concrete
placeholders (batch=2, other dynamic dims=3) unless the caller provides real
feed shapes; every other shape is *derived*, not read from the desc.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .diagnostics import Diagnostic, Severity

_DEFAULT_BATCH = 2
_DEFAULT_DYN = 3


class _Unknown:
    """Sentinel for values shape inference cannot determine; ops consuming
    an unknown input are skipped silently (no cascading diagnostics)."""

    def __repr__(self):
        return "<unknown shape>"


UNKNOWN = _Unknown()


class ShapeInferRegistry:
    """op type -> infer rule.  A rule has signature
    ``rule(op, ins, ctx) -> {slot: [meta tensor, ...]}`` where ``ins``
    maps input slots to struct lists and ``ctx`` is the :class:`InferContext`
    (program + env access for control-flow rules; ``ctx.site`` carries the
    op's location kwargs for Diagnostics)."""

    _rules: Dict[str, Callable] = {}

    @classmethod
    def register(cls, op_type: str):
        def deco(fn):
            cls._rules[op_type] = fn
            return fn
        return deco

    @classmethod
    def has(cls, op_type: str) -> bool:
        return op_type in cls._rules

    @classmethod
    def get(cls, op_type: str) -> Callable:
        return cls._rules[op_type]


def register_shape_infer(op_type: str):
    """Public decorator: register a shape-infer rule for a (possibly custom)
    op — see docs/design/analysis.md for the contract."""
    return ShapeInferRegistry.register(op_type)


class InferContext:
    def __init__(self, program, env: Dict[str, Any],
                 diags: List[Diagnostic], site: Optional[dict] = None):
        self.program = program
        self.env = env
        self.diags = diags
        self.site = site or {}


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a numpy dtype, its name, or a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return getattr(torch, name)


def dtype_name(dtype) -> str:
    """A dtype's name as numpy gives it ("float32", "int64", "bool")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return dtype if isinstance(dtype, str) else np.dtype(dtype).name


def _struct(shape, dtype):
    return torch.empty(tuple(int(s) for s in shape),
                       dtype=_torch_dtype(dtype), device="meta")


def _desc(v) -> str:
    return f"{tuple(v.shape)}:{dtype_name(v.dtype)}"


def _feed_struct(var, feed_shapes: Dict[str, Tuple]):
    """Concrete struct for a feed slot: real feed shape when given, else the
    declared shape with dynamic dims substituted."""
    if var.name in feed_shapes:
        shape, dtype = feed_shapes[var.name]
        return _struct(shape, dtype)
    shape = [(_DEFAULT_BATCH if i == 0 else _DEFAULT_DYN) if s < 0 else s
             for i, s in enumerate(var.shape)]
    return _struct(shape, var.dtype)


def _first_line(e: Exception) -> str:
    s = str(e).strip() or type(e).__name__
    return s.splitlines()[0]


# --------------------------------------------------------------------------
# explicit rules for ops the eval_shape fallback cannot handle (host-side
# callables, executor-lowered control flow, autodiff)
# --------------------------------------------------------------------------

@register_shape_infer("fill_init")
def _infer_fill_init(op, ins, ctx):
    a = op.attrs
    return {"Out": [_struct(a["shape"], a.get("dtype", "float32"))]}


@register_shape_infer("autodiff_grad")
def _infer_autodiff(op, ins, ctx):
    grads = []
    for p in op.attrs.get("params", []):
        v = ctx.env.get(p, UNKNOWN)
        grads.append(v if isinstance(v, _Unknown)
                     else _struct(v.shape, v.dtype))
    return {"Grads": grads}


def _check_carried(op, ctx, before: Dict[str, Any], after: Dict[str, Any],
                   what: str, site):
    for name, prev in before.items():
        new = after.get(name, prev)
        if isinstance(prev, _Unknown) or isinstance(new, _Unknown):
            continue
        if prev.shape != new.shape or prev.dtype != new.dtype:
            ctx.diags.append(Diagnostic(
                "S003", Severity.ERROR,
                f"{what} var '{name}' changes from "
                f"{_desc(prev)} to {_desc(new)} "
                "(loop/branch carries must keep shape and dtype)",
                var=name, **site))


def _infer_sub_block(op, ctx, sub_idx, bind: Dict[str, Any], site):
    """Infer a sub-block on a copy of env; returns the sub-env."""
    if not isinstance(sub_idx, int) or not 0 < sub_idx < len(ctx.program.blocks):
        return None
    sub_env = dict(ctx.env)
    sub_env.update(bind)
    infer_block(ctx.program, ctx.program.blocks[sub_idx], sub_env, ctx.diags)
    return sub_env


@register_shape_infer("while")
def _infer_while(op, ins, ctx):
    site = ctx.site
    sub_env = _infer_sub_block(op, ctx, op.attrs.get("sub_block_idx"), {}, site)
    if sub_env is not None:
        _check_carried(op, ctx, ctx.env, sub_env, "while loop-carried", site)
    return {}


@register_shape_infer("conditional_block")
def _infer_cond(op, ins, ctx):
    site = ctx.site
    for key in ("true_block_idx", "false_block_idx"):
        idx = op.attrs.get(key)
        if idx is None:
            continue
        sub_env = _infer_sub_block(op, ctx, idx, {}, site)
        if sub_env is not None:
            _check_carried(op, ctx, ctx.env, sub_env, "branch-carried", site)
    return {}


@register_shape_infer("static_rnn")
def _infer_static_rnn(op, ins, ctx):
    site = ctx.site
    a = op.attrs
    env = ctx.env
    bind: Dict[str, Any] = {}
    T = None
    for outer, step in zip(a.get("outer_inputs", []),
                           a.get("step_in_names", [])):
        v = env.get(outer, UNKNOWN)
        if isinstance(v, _Unknown) or len(v.shape) < 2:
            bind[step] = UNKNOWN
        else:
            T = v.shape[1]
            bind[step] = _struct((v.shape[0],) + v.shape[2:], v.dtype)
    for boot, mem in zip(a.get("boot_mems", []), a.get("mem_names", [])):
        bind[mem] = env.get(boot, UNKNOWN)
    sub_env = _infer_sub_block(op, ctx, a.get("sub_block_idx"), bind, site)
    outs: Dict[str, List[Any]] = {"Out": []}
    if sub_env is None:
        sub_env = {}
    # scan carry invariance: each memory's update must match its boot
    _check_carried(op, ctx,
                   {m: bind.get(m, UNKNOWN) for m in a.get("mem_names", [])},
                   {m: sub_env.get(u, UNKNOWN)
                    for m, u in zip(a.get("mem_names", []),
                                    a.get("mem_update_names", []))},
                   "scan memory", site)
    for name in a.get("step_out_names", []):
        v = sub_env.get(name, UNKNOWN)
        if isinstance(v, _Unknown) or T is None or not v.shape:
            outs["Out"].append(UNKNOWN)
        else:
            outs["Out"].append(_struct((v.shape[0], T) + v.shape[1:], v.dtype))
    # last_mem_outputs are attr-defined extra results (written straight
    # into env here; they are not part of op.outputs)
    for mem, last in zip(a.get("mem_names", []),
                         a.get("last_mem_outputs", [])):
        if last is not None:
            ctx.env[last] = bind.get(mem, UNKNOWN)
    return outs


@register_shape_infer("beam_search_gen")
def _infer_beam(op, ins, ctx):
    # the decode's output layout is owned by ops/beam_search.py; keep the
    # interpreter honest and mark it unknown rather than guessing
    return {"Tokens": [UNKNOWN], "Scores": [UNKNOWN]}


# --------------------------------------------------------------------------
# the interpreter
# --------------------------------------------------------------------------

def infer_block(program, block, env: Dict[str, Any],
                diags: List[Diagnostic]) -> Dict[str, Any]:
    """Infer one block's ops in order over ``env`` (name -> struct|UNKNOWN),
    mutating env with every output.  Recurses into sub-blocks via the
    registered control-flow rules."""
    from ..fluid.registry import OpRegistry, running_on

    for idx, op in enumerate(block.ops):
        site = dict(block_idx=block.idx, op_idx=idx, op_type=op.type)
        if not OpRegistry.has(op.type):
            continue  # verifier's V002; nothing to infer
        ins: Dict[str, List[Any]] = {}
        missing = False
        for slot, names in op.inputs.items():
            vals = [env.get(n, UNKNOWN) for n in names]
            if any(isinstance(v, _Unknown) for v in vals):
                missing = True
            ins[slot] = vals
        if missing:
            for n in op.output_vars():
                env[n] = UNKNOWN
            continue
        try:
            if ShapeInferRegistry.has(op.type):
                rule = ShapeInferRegistry.get(op.type)
                outs = rule(op, ins, InferContext(program, env, diags, site))
            else:
                with torch.no_grad(), running_on("meta"):
                    outs = OpRegistry.get(op.type)(ins, op.attrs)
        except Exception as e:  # abstract evaluation rejected the op
            diags.append(Diagnostic(
                "S001", Severity.ERROR,
                f"shape inference failed: {_first_line(e)}",
                hint="input shapes/dtypes are incompatible with this op's "
                     "contract; fix the producing layer before tracing",
                **site))
            for n in op.output_vars():
                env[n] = UNKNOWN
            continue
        for slot, names in op.outputs.items():
            vals = outs.get(slot) if isinstance(outs, dict) else None
            for i, n in enumerate(names):
                v = vals[i] if vals is not None and i < len(vals) else UNKNOWN
                env[n] = v
                _check_declared(block, n, v, diags, site)
    return env


def _check_declared(block, name, inferred, diags, site):
    """S002: declared desc shape disagrees with the inferred one (concrete
    dims only; -1 dims and rank growth from layers are bookkeeping)."""
    if isinstance(inferred, _Unknown):
        return
    var = block.vars.get(name)
    if var is None or not var.shape:
        return
    decl = tuple(var.shape)
    got = tuple(inferred.shape)
    if len(decl) != len(got):
        return  # layers frequently declare collapsed ranks; not a finding
    for d, g in zip(decl, got):
        if d >= 0 and d != g:
            diags.append(Diagnostic(
                "S002", Severity.WARNING,
                f"var '{name}' declared as {decl} but traces to {got}",
                var=name, **site))
            return


def infer_program_shapes(program, feed_shapes: Optional[Dict[str, Tuple]] = None,
                         diags: Optional[List[Diagnostic]] = None
                         ) -> Tuple[Dict[str, Any], List[Diagnostic]]:
    """Infer the whole program from its global block.

    ``feed_shapes`` — optional ``{name: (shape, dtype)}`` overrides from a
    real feed dict; unfed data vars use placeholder dims.  Returns
    ``(env, diagnostics)``.
    """
    diags = [] if diags is None else diags
    env: Dict[str, Any] = {}
    block = program.blocks[0]
    feed_shapes = feed_shapes or {}
    for name, v in block.vars.items():
        if v.is_data:
            env[name] = _feed_struct(v, feed_shapes)
        elif v.persistable:
            if any(s < 0 for s in v.shape):
                env[name] = UNKNOWN
            else:
                env[name] = _struct(v.shape, v.dtype)
    for name, (shape, dtype) in feed_shapes.items():
        if name not in env:
            env[name] = _struct(shape, dtype)
    infer_block(program, block, env, diags)
    return env, diags
