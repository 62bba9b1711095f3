"""Executor: run a Program's block over torch tensors, one CUDA graph per
signature — the counterpart of ``paddle_tpu/fluid/executor.py``.

JAX traces a block's ops into one function and jits it, cached by
(program version, feed signature, fetch). The port runs the same ops
through the registry's torch computes (fluid/registry.py) and replays
them as one CUDA graph per such key, through ``core/graphs.py``'s
``GraphCache``: the first run of a key runs the ops eagerly and captures
them, later runs copy the feeds into the graph's static buffers and
replay. The scope's persistables are the cache's static buffers: a
persistable the run writes is written in place (donation), so the scope
keeps the same tensors from run to run and no parameter is copied.

* **Feeds and fetches.** Feeds are numpy arrays, scalars or tensors
  (float64 arrives as float32 and int64 as int32, as JAX takes them);
  ``return_numpy=False`` returns tensors without a host read.
* **Donation.** ``donate=True`` writes every persistable the run updates
  in place, except one the same run fetches, which is kept (the fetch
  sees the new value, the scope gets a new tensor); ``donate=False``
  keeps every old tensor as it was. Every update is written after all of
  the block's ops have run, so no op reads a value another op already
  overwrote. That is why a ``verify=False`` run needs no L011 downgrade
  (JAX drops the donation of a var the dataflow plane proves hazardous,
  since XLA may reuse its buffer while a later op still reads it); with
  ``verify=True`` and ``donate=True`` the pre-flight still refuses such a
  program, as JAX's does.
* **Verification.** ``run(verify=True)`` runs ``analysis.check_or_raise``
  (the verifier, shape inference on meta tensors and the lints) once per
  (program, version, fetch, donate, feed signature) and raises
  ``ProgramVerificationError`` on an error diagnostic.
* **Bucketing** through ``BucketSpec`` (``<name>@LEN`` fed alongside), and
  the L006 churn warning, as in JAX.
* **The LRU** of ``cache_capacity`` keys: an eviction drops that key's
  CUDA graph (``GraphCache.drop``).
* **Autodiff.** A block's ``autodiff_grad`` op differentiates the ops
  before it with ``torch.autograd``: those ops run once, with the listed
  parameters as leaves, and the gradients come from that one forward (JAX
  replays the forward under ``jax.grad`` and XLA merges the two).
* **Control flow.** ``StaticRNN`` runs its step block once a time step and
  ``beam_search_gen`` through ``ops/beam_search.py``, both inside the
  graph. ``While`` and ``Cond`` read their predicate on the host, so a
  block holding one runs eagerly, with no graph, as do startup programs
  (host initializers) and blocks with random ops (registry
  ``RANDOM_OPS``); ``Executor.stats["eager_runs"]`` counts such runs.

* **Obs.** Under an installed obs session a run opens the ``fluid.run``
  span and counts runs, cache hits and misses (labelled ``bucketed``),
  evictions, the cache size and donated bytes, as JAX's does; the
  ``verify=True`` pre-flight opens ``fluid.verify``; each graphed key's
  cost is counted once on meta tensors and every run accounts it into
  the roofline ledger (``obs/roofline.py``). While a ``torch.profiler``
  run records, each op runs inside a ``record_function`` range named
  ``b{B}_op{I}_{type}`` (JAX's ``jax.named_scope`` stamp), which
  ``obs/xplane.py`` attributes the kernels to.
* **A mesh** (``mesh=``, or the ambient ``parallel.use_mesh``, with
  ``layout=`` a ``parallel.SpecLayout``): persistables are stored sharded
  by the resolved layout and every run is eager, over
  ``torch.distributed`` (``fluid/_mesh.py``); the mesh's signature and
  the resolved specs join the cache key, and the placement pass emits
  ``fluid.placed_bytes_total``, ``mesh.axis_size``,
  ``mesh.axis_utilization`` and ``fluid.param_bytes_per_device``.

* **Fusion** (``fuse=``, tune/fusion.py), as in JAX: ``None`` consults
  the autotune cache's ``fusion`` space and activates only measured
  winners (no entry for this device: unfused, at no analysis cost),
  ``False`` runs unfused, ``True`` fuses every schedulable certified
  group and a set of first-op indices exactly those groups. A fused
  region runs its member ops together at the first member's slot, in
  their order, under one ``record_function`` range
  ``b{B}_op{first}_fused_<kind>``, inside the block's CUDA graph: the
  same ops in the same order, so fused and unfused runs are bit-equal.
  The plan joins the cache key and is memoized per (program version,
  fetch, feed shapes, mode, cache), so ``fluid.fused_regions_total`` and
  ``fluid.fusion_rejected_total`` count plan decisions, not runs.
"""

from __future__ import annotations

import itertools
import re
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.graphs import GraphCache
from ..core.place import require_device
from . import _mesh
from ..data.feeder import BucketSpec
from ..obs.xplane import site_range
from .framework import Block, Program
from .registry import (NARROW_DTYPES, RANDOM_OPS, OpRegistry, kernel_route,
                       running_on)


class Scope:
    """Runtime variable store; persistables live here across run() calls.
    Child scopes see parent vars."""

    def __init__(self, parent: Optional["Scope"] = None):
        self.parent = parent
        self.vars: Dict[str, Any] = {}

    def set(self, name: str, value):
        self.vars[name] = value

    def get(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise KeyError(name)

    def has(self, name: str) -> bool:
        try:
            self.get(name)
            return True
        except KeyError:
            return False

    def new_child(self) -> "Scope":
        return Scope(self)


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


_SCOPE_SAFE = re.compile(r"[^A-Za-z0-9_]")


def _scope_tag(op, idx: int) -> str:
    """The profiler stamp of one op site (JAX's ``jax.named_scope`` tag):
    the machine-parseable twin of analysis.diagnostics.op_site ('block B,
    op #I (type)'), which obs/xplane.py's ``site_of`` inverts."""
    bidx = getattr(op.block, "idx", None)
    b = bidx if bidx is not None else 0
    return f"b{b}_op{idx}_{_SCOPE_SAFE.sub('_', op.type)}"


class _FusedRegion:
    """One activated fusion group, ready to run: the member ops in
    ascending (topological) order, the certificate's boundary vars and
    the one site tag the whole region runs under."""

    __slots__ = ("start", "ops", "inputs", "outputs", "tag")

    def __init__(self, group, block: Block):
        self.start = group.op_idxs[0]
        self.ops = [(i, block.ops[i]) for i in group.op_idxs]
        self.inputs = tuple(group.inputs)
        self.outputs = tuple(group.outputs)
        self.tag = (f"b{group.block_idx}_op{self.start}_fused_"
                    f"{_SCOPE_SAFE.sub('_', group.kind)}")


def _compute(op, idx: int, compute, ins):
    """One op's compute: directly, or through the mesh run's dispatch."""
    mr = _mesh.CURRENT
    if mr is None:
        return compute(ins, op.attrs)
    outs, rows = mr.compute(op, _site(op, idx), compute, ins)
    for names in op.outputs.values():
        (mr.sharded.update if rows else mr.sharded.difference_update)(names)
    return outs


def _run_fused_region(region: _FusedRegion, env: Dict[str, Any]) -> None:
    """Run one certified group as a single region: every member under one
    site range, intermediates in a region-local env (the single-consumer
    certificate guarantees nothing outside reads them), only the
    certificate's outputs exported."""
    sub: Dict[str, Any] = {n: env[n] for n in region.inputs if n in env}
    with site_range(region.tag):
        for idx, op in region.ops:
            compute = OpRegistry.get(op.type)
            ins = {k: [sub[n] if n in sub else env[n] for n in vs]
                   for k, vs in op.inputs.items()}
            outs = _compute(op, idx, compute, ins)
            for k, names in op.outputs.items():
                for n, v in zip(names, outs[k]):
                    sub[n] = v
    for n in region.outputs:
        if n in sub:
            env[n] = sub[n]


def _run_ops(ops, env: Dict[str, Any], program: Program,
             fused: Optional[Dict[int, _FusedRegion]] = None,
             first: int = 0):
    """Run an op list of ``program`` over env (name -> tensor), in place;
    ``first`` is the block index of ``ops[0]``.

    ``fused`` (global-block runs only) maps member op indices to their
    activated :class:`_FusedRegion`: the region runs at its first
    member's slot, the later members are skipped.

    A failing op re-raises with the op's site ("block B, op #I (type)",
    as analysis/diagnostics.py cites it), its io names and the chain of
    ops leading up to it."""
    for idx, op in enumerate(ops, first):
        try:
            if fused is not None and idx in fused:
                if idx == fused[idx].start:
                    _run_fused_region(fused[idx], env)
                continue
            if op.type == "autodiff_grad":
                _run_autodiff(op, ops, env)
                continue
            if _mesh.CURRENT is not None and op.type in (
                    "while", "conditional_block", "static_rnn",
                    "beam_search_gen"):
                raise _mesh._a7b(_site(op, idx), f"control flow ('{op.type}')")
            if op.type == "while":
                _run_while(op, env, program)
                continue
            if op.type == "conditional_block":
                _run_cond(op, env, program)
                continue
            if op.type == "static_rnn":
                _run_static_rnn(op, env, program)
                continue
            if op.type == "beam_search_gen":
                _run_beam_search_gen(op, env, program)
                continue
            compute = OpRegistry.get(op.type)
            ins = {k: [env[n] for n in vs] for k, vs in op.inputs.items()}
            with site_range(_scope_tag(op, idx)):
                outs = _compute(op, idx, compute, ins)
            for k, names in op.outputs.items():
                for n, v in zip(names, outs[k]):
                    env[n] = v
        except Exception as e:
            if getattr(e, "_op_ctx", False):
                raise          # the innermost op already carries its site
            at = idx - first
            chain = " -> ".join(o.type for o in ops[max(0, at - 4):at + 1])
            site = _site(op, idx)
            e.add_note(f"{site} failed while running the Program "
                       f"(inputs={op.inputs}, outputs={op.outputs})\n"
                       f"  op chain: ...{chain}")
            e._op_ctx = True
            raise
    return env


def _site(op, idx: int) -> str:
    """The op's site as analysis/diagnostics.py cites it."""
    from ..analysis.diagnostics import block_paths, op_site
    blk = getattr(op, "block", None)
    bidx = getattr(blk, "idx", None)
    path = None
    prog = getattr(blk, "program", None)
    if prog is not None and bidx is not None:
        path = block_paths(prog).get(bidx)
    return op_site(bidx, idx, op.type, block_path=path)


def _forward_with_autodiff(ops, env: Dict[str, Any], program: Program,
                           fused: Optional[Dict[int, _FusedRegion]] = None):
    """Run a block whose op list holds an ``autodiff_grad``: the ops before
    it under autograd with the op's parameters as leaves, then the op (the
    gradients of that one forward), then the rest without autograd."""
    n_fwd = next(i for i, o in enumerate(ops) if o.type == "autodiff_grad")
    params = list(ops[n_fwd].attrs["params"])
    given = {name: env[name] for name in params}
    leaves = {name: v.detach().requires_grad_(True)
              for name, v in given.items()}
    env.update(leaves)
    if _mesh.CURRENT is not None:
        _mesh.CURRENT.leaves = leaves
    with torch.enable_grad():
        _run_ops(ops[:n_fwd + 1], env, program, fused)
    for k, v in env.items():
        if isinstance(v, torch.Tensor) and v.requires_grad:
            env[k] = v.detach()
    for name, leaf in leaves.items():
        if env[name].data_ptr() == leaf.data_ptr():
            env[name] = given[name]      # not rewritten by the forward
    _run_ops(ops[n_fwd + 1:], env, program, fused, n_fwd + 1)


def _run_autodiff(op, ops, env):
    loss_name = op.attrs["loss"]
    param_names = list(op.attrs["params"])
    leaves = [env[n] for n in param_names]
    loss = env[loss_name]
    if not loss.requires_grad:
        raise ValueError(
            f"autodiff_grad: loss '{loss_name}' does not depend on the "
            "parameters through the ops before it")
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)]
    if _mesh.CURRENT is not None:
        grads = _mesh.CURRENT.finish(param_names, grads)
    for name, leaf, g in zip(param_names, leaves, grads):
        env[name + "@GRAD"] = torch.zeros_like(leaf) if g is None else g


def _sub_block_written(sub: Block, env) -> List[str]:
    """Outer vars a sub-block (transitively) writes — the loop-carried
    state."""
    written: List[str] = []
    prog = sub.program

    def collect(block: Block):
        for o in block.ops:
            for n in o.output_vars():
                written.append(n)
            for key in ("sub_block_idx", "true_block_idx", "false_block_idx"):
                if key in o.attrs and o.attrs[key] is not None:
                    collect(prog.blocks[o.attrs[key]])

    collect(sub)
    return list(dict.fromkeys(n for n in written if n in env))


def _truth(x) -> bool:
    return bool(torch.reshape(torch.as_tensor(x), ()).item())


def _run_while(op, env, program: Program):
    """while_op.cc semantics: re-run the sub-block until the condition var
    (updated inside the block) is false; the predicate is read on the
    host each trip."""
    sub = program.blocks[op.attrs["sub_block_idx"]]
    cond_name = op.inputs["Condition"][0]
    carried = _sub_block_written(sub, env)
    if cond_name not in carried:
        raise ValueError(
            f"while condition '{cond_name}' is never updated in the loop body "
            "(would loop forever); write it with less_than(..., cond=cond)")
    state = {n: env[n] for n in carried}
    while _truth(state[cond_name]):
        env2 = dict(env)
        env2.update(state)
        _run_ops(sub.ops, env2, program)
        state = {n: env2[n] for n in carried}
    env.update(state)


def _run_cond(op, env, program: Program):
    """conditional_block (+ optional else block): run the taken branch;
    vars either branch writes must pre-exist outside, and the untaken
    branch leaves them as they were."""
    true_b = program.blocks[op.attrs["true_block_idx"]]
    false_idx = op.attrs.get("false_block_idx")
    false_b = program.blocks[false_idx] if false_idx is not None else None
    carried = _sub_block_written(true_b, env)
    if false_b is not None:
        for n in _sub_block_written(false_b, env):
            if n not in carried:
                carried.append(n)
    blk = true_b if _truth(env[op.inputs["Condition"][0]]) else false_b
    env2 = dict(env)
    if blk is not None:
        _run_ops(blk.ops, env2, program)
    env.update({n: env2[n] for n in carried})


def _run_static_rnn(op, env, program: Program):
    """A static_rnn op: the step block once a time step of the outer
    [B, T, ...] inputs, the memories carried, the step outputs stacked
    back to [B, T, ...]."""
    a = op.attrs
    sub = program.blocks[a["sub_block_idx"]]
    xs = [env[n] for n in a["outer_inputs"]]
    carry = [env[n] for n in a["boot_mems"]]
    T = xs[0].shape[1]
    ys: List[List[torch.Tensor]] = [[] for _ in a["step_out_names"]]
    for t in range(T):
        env2 = dict(env)
        env2.update(zip(a["mem_names"], carry))
        env2.update(zip(a["step_in_names"], (x[:, t] for x in xs)))
        _run_ops(sub.ops, env2, program)
        carry = [env2[n] for n in a["mem_update_names"]]
        for y, n in zip(ys, a["step_out_names"]):
            y.append(env2[n])
    for name, y in zip(a["outer_outputs"], ys):
        env[name] = torch.stack(y, dim=1)
    for name, c in zip(a["last_mem_outputs"], carry):
        if name is not None:
            env[name] = c


def _run_beam_search_gen(op, env, program: Program):
    """A beam_search_gen op: the user's step sub-block becomes the step_fn
    of the on-device beam decode (ops/beam_search.py); memories ride the
    beam cell, the static (encoder) inputs are tiled to [B*K, ...] once."""
    from ..ops.beam_search import beam_search
    a = op.attrs
    sub = program.blocks[a["sub_block_idx"]]
    embed_w = env[a["embed_param"]]
    boots = tuple(env[n] for n in a["boot_mems"])
    statics = tuple(env[n] for n in a["static_outer"])
    B = boots[0].shape[0] if boots else statics[0].shape[0]
    K = a["beam_size"]
    V = embed_w.shape[0]
    tiled = tuple(s[:, None].expand((B, K) + tuple(s.shape[1:]))
                  .reshape((B * K,) + tuple(s.shape[1:])) for s in statics)

    def step_fn(mems, tokens):
        env2 = dict(env)
        env2.update(zip(a["mem_names"], mems))
        env2.update(zip(a["static_in_names"], tiled))
        env2[a["token_embed_name"]] = embed_w[tokens.long()]
        _run_ops(sub.ops, env2, program)
        logp = torch.log(torch.clamp(env2[a["prob_name"]], min=1e-9))
        return logp, tuple(env2[n] for n in a["mem_update_names"])

    constraint_fn = None
    if a.get("constraint"):
        from ..ops.beam_search import CONSTRAINTS
        try:
            constraint_fn = CONSTRAINTS[a["constraint"]]
        except KeyError:
            raise KeyError(
                f"beam-search constraint {a['constraint']!r} is not "
                "registered; call paddle_tpu_torch.ops.beam_search."
                "register_constraint(name, fn) before running the program")
    toks, scores = beam_search(
        boots, step_fn, batch_size=B, beam_size=K, max_len=a["max_length"],
        vocab_size=V, bos_id=a["bos_id"], eos_id=a["eos_id"],
        length_penalty=a.get("length_penalty", 0.0),
        constraint_fn=constraint_fn)
    env[op.outputs["Tokens"][0]] = toks
    env[op.outputs["Scores"][0]] = scores


#: op types that make a block run eagerly: startup initializers, host
#: predicates, host-seeded draws
_EAGER_OPS = frozenset({"fill_init", "while", "conditional_block"}) \
    | RANDOM_OPS


def _runs_eagerly(program: Program, block: Block) -> bool:
    """Whether a block runs with no CUDA graph: it holds an op of
    _EAGER_OPS (a training dropout only), in it or a sub-block, or no op
    at all (nothing to capture)."""
    if not block.ops:
        return True
    for op in block.ops:
        if op.type in _EAGER_OPS and not (
                op.type == "dropout" and op.attrs.get("is_test", True)):
            return True
        for key in ("sub_block_idx", "true_block_idx", "false_block_idx"):
            idx = op.attrs.get(key)
            if idx is not None and _runs_eagerly(program,
                                                 program.blocks[idx]):
                return True
    return False


class _Entry:
    """One key of the executor's LRU: the block's body over (feed, state,
    kept), the token its CUDA graph is keyed by, and its fused regions."""

    __slots__ = ("body", "token", "eager", "fused")

    def __init__(self, body, token: int, eager: bool, fused=None):
        self.body, self.token, self.eager = body, token, eager
        self.fused = fused


#: consecutive cache misses before the executor warns that the workload is
#: shape-churning with no bucket spec (L006)
_CHURN_STREAK = 4

#: default LRU capacity
DEFAULT_CACHE_CAPACITY = 512

_NP_CAST = {np.dtype(k): np.dtype(v) for k, v in NARROW_DTYPES.items()}


class Executor:
    """exe.run(program, feed=..., fetch_list=...) on the card (or on
    ``device="cpu"``, as the tests run it). A ``place`` (``CUDAPlace``,
    ``CPUPlace``) picks the device when ``device`` is not given."""

    def __init__(self, place=None, scope: Optional[Scope] = None, *,
                 donate: bool = True,
                 buckets: Optional[Any] = None,
                 mesh: Optional[Any] = None,
                 layout: Optional[Any] = None,
                 fuse: Optional[Any] = None,
                 cache_capacity: int = DEFAULT_CACHE_CAPACITY,
                 device=None):
        self.fuse = fuse
        self._fusion_memo: Dict[Tuple, Any] = {}
        if mesh is None:
            from ..parallel.mesh import current_mesh
            mesh = current_mesh()
        if layout is not None and mesh is None:
            raise ValueError(
                "Executor(layout=...) needs a mesh: pass mesh=... or "
                "construct inside parallel.use_mesh(...)")
        if mesh is not None and layout is None:
            from ..parallel.sharding import SpecLayout
            layout = SpecLayout()
        self.mesh = mesh
        self.layout = layout
        # the rank assignment joins the cache key, as JAX's device ids do
        self._mesh_sig = (tuple(mesh.shape.items()),
                          tuple(int(d) for d in mesh.devices.flat)) \
            if mesh is not None else None
        self._mesh_stats_emitted = False
        self._shard_memo: Dict[Tuple, Tuple] = {}
        if mesh is not None and device is None and place is None:
            device = mesh.device
        self.device = require_device(device if device is not None
                                     else place)
        self.scope = scope if scope is not None else global_scope()
        self.donate = donate
        if buckets is not None and not isinstance(buckets, BucketSpec):
            buckets = BucketSpec(buckets)
        self.buckets: Optional[BucketSpec] = buckets
        if cache_capacity < 1:
            raise ValueError("cache_capacity must be >= 1")
        self.cache_capacity = cache_capacity
        self._cache: "OrderedDict[Tuple, _Entry]" = OrderedDict()
        self.graphs = GraphCache("fluid.Executor", self.device)
        self._tokens = itertools.count()
        self._step = 0   # feeds the implicit '__step__' var (stochastic ops)
        self._miss_streaks: Dict[Tuple, int] = {}
        self._seen_keys: set = set()
        self._churn_warned = False
        self._verified: set = set()
        #: runs, cache hits/misses/evictions, and runs with no graph
        self.stats = dict.fromkeys(("runs", "cache_hits", "cache_misses",
                                    "cache_evictions", "eager_runs"), 0)

    # ------------------------------------------------------------------
    def _tensor(self, v) -> torch.Tensor:
        """A feed or scope value as a tensor on the executor's device."""
        if isinstance(v, torch.Tensor):
            return v if v.device == self.device else v.to(self.device)
        a = np.asarray(v)
        a = a.astype(_NP_CAST.get(a.dtype, a.dtype), copy=False)
        return torch.tensor(a, device=self.device)

    def _default_bucket_axis(self, block: Block, name: str,
                             ndim: int) -> Optional[int]:
        """Axis to bucket when the spec doesn't pin one: the feed
        Variable's declared ``bucket_axis``, else its first dynamic (-1)
        non-batch dim; a declared feed with no dynamic non-batch dim is an
        error."""
        v = block.vars.get(name)
        if v is not None:
            if getattr(v, "bucket_axis", None) is not None:
                return v.bucket_axis
            dyn = [i for i, s in enumerate(v.shape) if i > 0 and s == -1]
            if dyn and dyn[0] < ndim:
                return dyn[0]
            if ndim >= 2:
                raise ValueError(
                    f"cannot infer a bucket axis for feed '{name}': its "
                    f"declared shape {v.shape} has no dynamic (-1) non-batch "
                    "dim; pin one in the spec "
                    f"(buckets={{'{name}': {{'axis': A, 'buckets': (...)}}}}) "
                    "or declare layers.data(..., bucket_axis=A)")
        return None

    def _apply_buckets(self, feed: Dict[str, Any], block: Block) -> bool:
        """Pad spec'd feeds in place; True when any feed was bucketed."""
        applied = False
        for name in self.buckets.names():
            if name not in feed:
                continue
            arr = feed[name]
            if not hasattr(arr, "shape"):
                arr = np.asarray(arr)
            default_axis = None
            if self.buckets.pinned_axis(name) is None:
                default_axis = self._default_bucket_axis(block, name,
                                                         arr.ndim)
            padded, true_len = self.buckets.pad(name, arr, default_axis)
            feed[name] = padded
            feed[name + "@LEN"] = np.int32(true_len)
            applied = True
        return applied

    def _maybe_warn_churn(self, streak: int):
        """L006 shape-churn: a streak of never-seen cache keys for one
        (program, fetch) signature (warns once per executor)."""
        threshold = _CHURN_STREAK
        if self.buckets is not None:
            threshold += sum(len(b) + 1
                             for _, b in self.buckets.spec.values())
        if self._churn_warned or streak < threshold:
            return
        self._churn_warned = True
        fix = ("pass Executor(buckets={'<feed>': (32, 64, ...)})"
               if self.buckets is None else
               "extend the BucketSpec to cover the still-varying feed(s)")
        warnings.warn(
            f"L006 shape-churn: {streak} consecutive compiled-fn cache "
            "misses for the same program — each distinct feed shape pays a "
            f"fresh run and graph capture. If feeds vary in length, {fix} "
            "to pad onto a bounded shape family.",
            RuntimeWarning, stacklevel=4)

    @staticmethod
    def _written_vars(program: Program, block: Block) -> List[str]:
        out: List[str] = []
        for op in block.ops:
            out.extend(op.output_vars())
            for key in ("sub_block_idx", "true_block_idx", "false_block_idx"):
                idx = op.attrs.get(key)
                if idx is not None:
                    out.extend(Executor._written_vars(program,
                                                      program.blocks[idx]))
        return out

    # ------------------------------------------------------------------
    def run(self, program: Optional[Program] = None,
            feed: Optional[Dict[str, Any]] = None,
            fetch_list: Optional[Sequence] = None,
            use_cache: bool = True, verify: bool = False,
            return_numpy: bool = True,
            donate: Optional[bool] = None) -> List[Any]:
        with obs.span("fluid.run", metric="fluid.run_seconds"):
            return self._run(program, feed, fetch_list, use_cache, verify,
                             return_numpy, donate)

    # -------------------------------------------------- sharding plane ----
    def _annotation(self, block: Block, name: str):
        """The variable's ``sharding`` annotation; optimizer accumulators
        (``param@moment1``) inherit their base parameter's."""
        v = block.vars.get(name)
        ann = getattr(v, "sharding", None) if v is not None else None
        if ann is None and "@" in name:
            base = block.vars.get(name.split("@", 1)[0])
            ann = getattr(base, "sharding", None) if base is not None \
                else None
        return ann

    def _persist_sharding(self, block: Block, name: str, value):
        return self.layout.resolve(self.mesh, name, tuple(value.shape),
                                   self._annotation(block, name))

    def _feed_sharding(self, block: Block, name: str, value):
        """Feeds: annotation wins; a fed persistable resolves like a
        parameter; plain data shards its batch dim over ``data``."""
        from ..parallel.sharding import NamedSharding
        shape = tuple(value.shape)
        ann = self._annotation(block, name)
        v = block.vars.get(name)
        if ann is None and v is not None and v.persistable:
            return self._persist_sharding(block, name, value)
        if ann is not None:
            return self.layout.resolve(self.mesh, name, shape, ann)
        spec = type(self.layout).fit(self.mesh,
                                     self.layout.batch_spec(len(shape)),
                                     shape)
        return NamedSharding(self.mesh, spec)

    def _place_persistables(self, persist_in, spec_of) -> None:
        """Place scope values whose live sharding differs from the
        resolved layout (a startup program's or a restore's plain values,
        or values placed for another mesh) onto the mesh."""
        from ..parallel.sharding import device_put, spec_of as live_spec
        placed = 0
        for n in persist_in:
            cur = self.scope.get(n)
            target = spec_of[n]
            if live_spec(cur) == target.spec and \
                    cur.device_mesh is self.mesh.device_mesh:
                continue
            self.scope.set(n, device_put(cur, target))
            placed += cur.numel() * cur.element_size()
        if placed:
            obs.count("fluid.placed_bytes_total", placed)
            self._mesh_stats_emitted = False
        if not self._mesh_stats_emitted and obs.is_active():
            self._emit_mesh_stats(persist_in, spec_of)
            self._mesh_stats_emitted = True

    def _emit_mesh_stats(self, persist_in, spec_of) -> None:
        """Per-axis utilization through the obs plane: how much of the
        persistable footprint each mesh axis divides, and the bytes a
        rank holds under the layout."""
        total = per_device = 0
        by_axis: Dict[str, int] = {a: 0 for a in self.mesh.shape}
        for n in persist_in:
            v = self.scope.get(n)
            nbytes = v.numel() * v.element_size()
            total += nbytes
            ways = 1
            for entry in spec_of[n].spec:
                axes = ((entry,) if isinstance(entry, str)
                        else tuple(entry or ()))
                for a in axes:
                    by_axis[a] += nbytes
                    ways *= self.mesh.shape[a]
            per_device += nbytes // ways
        for a, size in self.mesh.shape.items():
            obs.gauge_set("mesh.axis_size", size, axis=a)
            obs.gauge_set("mesh.axis_utilization",
                          (by_axis[a] / total) if total else 0.0, axis=a)
        obs.gauge_set("fluid.param_bytes_per_device", per_device)
        obs.gauge_set("fluid.param_bytes_global", total)

    def _mesh_plan(self, program, block, feed, persist_in, written):
        """(feed specs, persistable specs, the cache key's mesh part),
        memoized per (program version, args signature)."""
        skey = (program._serial, program.version, block.idx,
                tuple(persist_in), tuple(written),
                tuple((k, tuple(v.shape), str(v.dtype))
                      for k, v in sorted(feed.items())))
        memo = self._shard_memo.get(skey)
        if memo is None:
            feed_sh = {k: self._feed_sharding(block, k, v)
                       for k, v in feed.items()}
            spec_of = {n: self._persist_sharding(block, n,
                                                 self.scope.get(n))
                       for n in persist_in}
            mesh_key = (self._mesh_sig,
                        tuple(sorted((k, str(s.spec))
                                     for k, s in feed_sh.items())),
                        tuple((n, str(spec_of[n].spec))
                              for n in persist_in))
            if len(self._shard_memo) > 1024:
                self._shard_memo.clear()
            memo = self._shard_memo[skey] = (feed_sh, spec_of, mesh_key)
        return memo

    def _run(self, program, feed, fetch_list, use_cache, verify,
             return_numpy=True, donate=None):
        from .framework import default_main_program
        program = program or default_main_program()
        block = program.global_block()
        feed = dict(feed or {})
        bucketed = self.buckets is not None and self._apply_buckets(feed,
                                                                    block)
        feed = {k: self._tensor(v) for k, v in feed.items()}
        fetch_names = [v if isinstance(v, str) else v.name
                       for v in (fetch_list or [])]
        if "__step__" in block.vars and "__step__" not in feed:
            feed["__step__"] = torch.full((), self._step, dtype=torch.int32,
                                          device=self.device)
            self._step += 1
        donate = self.donate if donate is None else donate
        if verify:
            # the static pre-flight, memoized per (program version, fetch,
            # donate, feed signature) so a training loop pays it once
            from .. import analysis
            vkey = (program._serial, program.version, tuple(fetch_names),
                    bool(donate),
                    tuple((k, tuple(v.shape), str(v.dtype))
                          for k, v in sorted(feed.items())))
            if vkey not in self._verified:
                with obs.span("fluid.verify", metric="fluid.verify_seconds"):
                    analysis.check_or_raise(program, feed=feed,
                                            fetch=fetch_names,
                                            donate=bool(donate))
                self._verified.add(vkey)

        persist_in = [name for name, v in block.vars.items()
                      if v.persistable and name not in feed
                      and self.scope.has(name)]
        top_written = {n for op in block.ops for n in op.output_vars()}
        written = list(dict.fromkeys(
            n for n in self._written_vars(program, block)
            if n in block.vars and block.vars[n].persistable))
        for n in written:
            if n not in top_written and n not in feed \
                    and not self.scope.has(n):
                raise ValueError(
                    f"persistable '{n}' is written inside a control-flow "
                    "sub-block but has no initial value; initialize it in the "
                    "scope (or a startup program) first")
        written_set, fetch_set = set(written), set(fetch_names)
        # the scope's persistables the run reads: held by the graph cache
        # as donated (state) unless the run writes them without donation
        # or fetches them after writing them (kept: a new tensor comes back)
        kept_in = [n for n in persist_in if n in written_set
                   and (not donate or n in fetch_set)]
        kept_set = set(kept_in)
        state_in = [n for n in persist_in if n not in kept_set]
        for n in persist_in:
            v = self.scope.get(n)
            if not isinstance(v, torch.Tensor) or v.device != self.device:
                self.scope.set(n, self._tensor(v))
        mesh_key = plan = None
        if self.mesh is not None:
            plan = self._mesh_plan(program, block, feed, persist_in, written)
            mesh_key = plan[2]
            self._place_persistables(persist_in, plan[1])

        fusion_plan = self._fusion_plan(program, block, feed, fetch_names)
        key = (program._serial, program.version, block.idx,
               tuple(fetch_names), tuple(state_in), tuple(kept_in),
               bool(donate), kernel_route(), mesh_key,
               fusion_plan.key() if fusion_plan is not None else None,
               tuple((k, tuple(v.shape), v.dtype)
                     for k, v in sorted(feed.items())))
        entry = self._cache.get(key) if use_cache else None
        self.stats["runs"] += 1
        obs.count("fluid.runs_total")
        bflag = "true" if bucketed else "false"
        churn_key = (program._serial, block.idx, tuple(fetch_names))
        if entry is None:
            self.stats["cache_misses"] += 1
            obs.count("fluid.cache_misses_total", bucketed=bflag)
            if use_cache and key not in self._seen_keys:
                if len(self._seen_keys) > 4096:
                    self._seen_keys.clear()
                self._seen_keys.add(key)
                if len(self._miss_streaks) > 64:
                    self._miss_streaks.clear()
                streak = self._miss_streaks.get(churn_key, 0) + 1
                self._miss_streaks[churn_key] = streak
                self._maybe_warn_churn(streak)
            entry = self._build(program, block, state_in, kept_in,
                                fetch_names, written, fusion_plan)
            if use_cache:
                self._cache[key] = entry
                while len(self._cache) > self.cache_capacity:
                    _, old = self._cache.popitem(last=False)
                    self._drop(old)
                    self.stats["cache_evictions"] += 1
                    obs.count("fluid.cache_evictions_total")
        else:
            self.stats["cache_hits"] += 1
            obs.count("fluid.cache_hits_total", bucketed=bflag)
            self._miss_streaks[churn_key] = 0
            self._cache.move_to_end(key)
        if use_cache:
            obs.gauge_set("fluid.cache_size", len(self._cache))

        feed = {k: feed[k] for k in sorted(feed)}
        state = {n: self.scope.get(n) for n in state_in}
        kept = {n: self.scope.get(n) for n in kept_in}
        if donate and obs.is_active():
            donated = [state[n] for n in state_in if n in written_set
                       and n not in fetch_set]
            if donated:
                obs.count("fluid.donated_bytes_total",
                          sum(v.numel() * v.element_size() for v in donated))
        if plan is not None:
            self.stats["eager_runs"] += 1
            return self._run_mesh(block, program, feed, state, kept,
                                  fetch_names, written, plan, donate,
                                  return_numpy, entry.fused)
        if entry.eager:
            self.stats["eager_runs"] += 1
            with running_on(self.device):
                fetches, state_out, new = entry.body(feed, state, kept)
        else:
            with running_on(self.device):
                fetches, state_out, new = self.graphs.run(
                    "fluid.run", entry.body,
                    {"feed": feed, "state": state, "kept": kept},
                    static={"key": entry.token}, donate=("state",),
                    cost="fluid.run")
        for n, v in state_out.items():
            self.scope.set(n, v)
        for n, v in new.items():
            self.scope.set(n, v)
        if not use_cache:
            self._drop(entry)
        if return_numpy:
            return [v.detach().cpu().numpy() for v in fetches]
        return list(fetches)

    def _run_mesh(self, block, program, feed, state, kept, fetch_names,
                  written, plan, donate, return_numpy, fused=None):
        """One run on the mesh (fluid/_mesh.py): the persistables gathered,
        this rank's feed rows, the ops with the batch reductions and the
        gradients summed across the batch axes, this rank's block of each
        update kept, the fetches gathered."""
        from ..parallel.sharding import (NamedSharding, P, cut, from_local,
                                         local, spec_of as live_spec,
                                         to_global)
        feed_sh, spec_of, _ = plan
        axes: Tuple[str, ...] = ()
        env: Dict[str, Any] = {}
        rows: set = set()
        for k, v in feed.items():
            ax = _mesh.batch_axes(feed_sh[k].spec)
            if ax:
                if axes and ax != axes:
                    raise NotImplementedError(
                        f"feeds split over different batch axes ({axes} "
                        f"and {ax} for '{k}'): the mesh executor takes one "
                        "batch split (ROADMAP A.7b)")
                axes = ax
                v = cut(v, self.mesh, P(feed_sh[k].spec[0]))
                rows.add(k)
            env[k] = v
        persist = dict(kept)
        persist.update(state)
        olds = {n: v for n, v in persist.items()}
        env.update({n: to_global(v) for n, v in persist.items()})
        prev = _mesh.CURRENT
        _mesh.CURRENT = run = _mesh.MeshRun(self.mesh, axes, rows)
        try:
            with running_on(self.device), torch.no_grad():
                ops = block.ops
                if any(op.type == "autodiff_grad" for op in ops):
                    _forward_with_autodiff(ops, env, program, fused)
                else:
                    _run_ops(ops, env, program, fused)
        finally:
            _mesh.CURRENT = prev
        fetches = [run.gather_rows(env[n]) if n in run.sharded else env[n]
                   for n in fetch_names]
        for n in written:
            if n not in env:
                continue
            new = env[n]
            if n in run.sharded:
                new = run.gather_rows(new)
            old = olds.get(n)
            sh = spec_of.get(n)
            if sh is None:
                self.scope.set(n, new)      # placed by the next run
                continue
            block_ = cut(new, self.mesh, sh.spec)
            if donate and n in state and live_spec(old) == sh.spec \
                    and local(old).shape == block_.shape:
                local(old).copy_(block_)    # in place: the donated block
            else:
                self.scope.set(n, from_local(block_.clone(), self.mesh,
                                             sh.spec, new.shape))
        if return_numpy:
            return [v.detach().cpu().numpy() for v in fetches]
        return list(fetches)

    def _drop(self, entry: _Entry) -> None:
        """Drop the CUDA graph of an entry the LRU let go."""
        token = entry.token
        self.graphs.drop(lambda key: ("key", token) in key[2])

    # ------------------------------------------------------------------
    def _build(self, program: Program, block: Block, state_in, kept_in,
               fetch_names, written, fusion_plan=None) -> _Entry:
        """The body of one key: the block's ops (with the plan's fused
        regions) over the feeds and the persistables, then every written
        persistable back — in place into its state tensor (donated), or as
        a new tensor (kept, or one with no value before the run)."""
        has_autodiff = any(op.type == "autodiff_grad" for op in block.ops)
        fused: Optional[Dict[int, _FusedRegion]] = None
        if fusion_plan is not None and not any(
                op.type == "fill_init" for op in block.ops):
            fused = {}
            for g in fusion_plan.groups:
                region = _FusedRegion(g, block)
                for i in g.op_idxs:
                    fused[i] = region
        written_state = [n for n in written if n in set(state_in)]
        written_new = [n for n in written if n not in set(state_in)]

        def body(feed, state, kept, key=None):
            env: Dict[str, Any] = {}
            env.update(feed)
            env.update(kept)
            env.update(state)
            inputs = {id(v) for v in env.values()}
            with torch.no_grad():
                if has_autodiff:
                    _forward_with_autodiff(block.ops, env, program, fused)
                else:
                    _run_ops(block.ops, env, program, fused)
                fetches = [env[n].clone() if id(env[n]) in inputs
                           else env[n] for n in fetch_names]
                # every new value is taken before any state is written
                vals = [env[n].clone() if id(env[n]) in inputs
                        and env[n] is not state[n] else env[n]
                        for n in written_state]
                for n, v in zip(written_state, vals):
                    if v is not state[n]:
                        state[n].copy_(v)
                new = {n: (env[n].clone() if id(env[n]) in inputs
                           else env[n]) for n in written_new if n in env}
            return fetches, state, new

        return _Entry(body, next(self._tokens),
                      _runs_eagerly(program, block), fused)

    def _fusion_plan(self, program, block, feed, fetch_names):
        """The (memoized) fusion decision for this run's key, as JAX's:
        with ``fuse=None`` and no ``fusion`` entry for this device in the
        active cache, nothing is analysed; plans memoize per (program
        version, fetch, mode, cache identity, feed shapes)."""
        if self.fuse is False or block.idx != 0:
            return None
        from ..tune import fusion as _fusion
        if self.fuse is None and not _fusion.cache_has_fusion_entries():
            return None
        mode = (True if self.fuse is True else
                tuple(sorted(self.fuse)) if self.fuse is not None else None)
        ctoken = None
        if self.fuse is None:
            # consults must not survive a cache swap: the active cache's
            # identity and entry count ride the memo key
            from ..tune.cache import get_cache
            c = get_cache()
            ctoken = (id(c), len(c.entries) if c is not None else 0)
        fkey = (program._serial, program.version, tuple(fetch_names), mode,
                ctoken, tuple((k, tuple(v.shape))
                              for k, v in sorted(feed.items())))
        plan = self._fusion_memo.get(fkey)
        if plan is None:
            plan = _fusion.plan_for(
                program, {k: tuple(v.shape) for k, v in feed.items()},
                fetch=fetch_names, feed=list(feed), force=self.fuse)
            if len(self._fusion_memo) > 256:
                self._fusion_memo.clear()
            self._fusion_memo[fkey] = plan
        return plan if plan.groups else None
