"""Dataflow analysis over Program IR — def-use chains, liveness, aliasing,
effects.

The structural verifier (verify.py) answers "is this desc well-formed"; this
module answers "who defines what, who reads it, and what may alias what" —
the dependency facts a fusion/layout pass (ROADMAP item 3(c)) and the
executor's donation fast path need to be *provably* safe rather than
dynamically lucky.  It is pure desc-level analysis: no jax import, no trace.

Model
-----
- :class:`Def` — one binding of a name: an op output, an attr-defined extra
  output, a control-flow bind (scan step slice / carried memory), or the
  block-entry value of a feed/data/persistable var.  SSA-flavored: every
  write site is its own Def; an "SSA variable" is a (name, site) pair.
- :class:`Use` — one read site; ``use.defs`` is the set of Defs that *may
  reach* it (reaching definitions, may-analysis).  Reads come from
  ``op.inputs`` plus the attr side channels the executor lowers from env
  (``verify._ATTR_READ_KEYS`` and the lowering-read keys).
- **alias roots** — each Def carries the set of root Defs whose *storage*
  its value shares.  View/share ops (``assign``, ``reshape``, ``squeeze``,
  ``unsqueeze``, ``seq_reshape``, ``lod_reset``) propagate their input's
  roots; every other Def is its own root.  A read of a Def rooted at a
  donated entry value is a read of the donated buffer.
- **effects** — per-op classification: ``pure`` (value function of inputs),
  ``in-place`` (writes one of its own input names — optimizer updates),
  ``side-effecting`` (RNG, host callables), ``control`` (lowers sub-blocks
  or replays the trace: while/cond/scan/beam/autodiff).

Control flow
------------
``conditional_block`` branches fork the reaching env and re-merge by union
(may-reach).  Loop bodies (``while``/``static_rnn``/``beam_search_gen``) are
walked **twice**: the second pass runs over the first pass's merged end
state so back-edge reads (a loop counter's ``increment`` feeding next
iteration's ``less_than``) land on the body's Defs — without it every loop
carry would look like a dead write.  Def/Use objects are interned per site,
so the replay adds edges but never duplicates nodes.  Zero-trip semantics
are preserved: the pre-loop env stays reaching after the loop.

Consumers
---------
- :func:`donation_hazards` — the donation-safety proof obligation: for each
  donated persistable ``p``, no Use may read a Def rooted at ``p``'s entry
  value after ``p``'s first overwrite (or share a loop with one — loops
  re-execute).  Backs lint **L011** and the executor's donate downgrade.
- :func:`fusable_groups` — the fusion-legality oracle: elementwise chains
  and single-consumer producer→consumer pairs in the global block, each
  with a dependence certificate (every internal edge's def/use site and
  consumer count).  Backs the ROADMAP 3(c) pass.
- :func:`explain_var` — the ``lint --explain`` chain text
  ("defined at block B, op #I; last read at block B', op #J").
- lints **L010** (dead write across blocks) and **L012** (alias escape from
  a sub-block) consume :class:`Dataflow` in ``lints.py``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .diagnostics import block_paths, op_site
from .verify import (BLOCK_ATTR_KEYS, _ATTR_BIND_KEYS, _ATTR_DEFINE_KEYS,
                     _ATTR_READ_KEYS, _attr_names, _names, _transitive_writes)


class Effect(str, enum.Enum):
    """Per-op effect taxonomy (docs/design/analysis.md)."""

    PURE = "pure"
    INPLACE = "in-place"
    SIDE_EFFECT = "side-effecting"
    CONTROL = "control"

    def __str__(self):
        return self.value


#: ops lowered through sub-blocks or trace replay, not their compute
CONTROL_OPS = frozenset(("while", "conditional_block", "static_rnn",
                         "beam_search_gen", "autodiff_grad"))

#: RNG / host-state ops: same inputs, different values (never fusable by
#: value equality, never safe to re-execute speculatively)
SIDE_EFFECT_OPS = frozenset(("gaussian_random", "uniform_random", "dropout",
                             "sampling_id", "fill_init"))

#: ops whose output VALUE is (a view of) an input's storage — alias roots
#: propagate through them.  In the reference these share the LoDTensor
#: buffer; in the executor's semantics they share the tensor.
VIEW_OPS = frozenset(("assign", "reshape", "squeeze", "unsqueeze",
                      "seq_reshape", "lod_reset"))

#: elementwise value functions: one output element per input element, no
#: cross-element reads — the always-fusable set (TVM's injective class)
ELEMENTWISE_OPS = frozenset((
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "scale", "cast", "clip", "sign", "minus", "pow",
    "power", "logical_not", "slope_intercept", "fill_zeros_like",
    "sigmoid", "tanh", "relu", "gelu", "leaky_relu", "elu", "softsign",
    "square", "sqrt", "abs_act", "exponential", "brelu", "soft_shrink",
    "hard_shrink", "thresholded_relu", "stanh", "softrelu", "hard_sigmoid",
    "swish", "reciprocal", "log",
))

#: attr keys naming sub-block results the executor reads when lowering a
#: control op (lints._EXTRA_READ_KEYS minus the keys verify already owns)
_LOWERING_READ_KEYS = ("mem_update_names", "step_out_names", "prob_name")


def classify_effect(op) -> Effect:
    """Desc-level effect of one op (no registry lookup, no trace)."""
    if op.type in CONTROL_OPS or any(k in op.attrs for k in BLOCK_ATTR_KEYS):
        return Effect.CONTROL
    if op.type in SIDE_EFFECT_OPS:
        return Effect.SIDE_EFFECT
    if any(callable(v) for v in op.attrs.values()):
        return Effect.SIDE_EFFECT
    if set(op.output_vars()) & set(op.input_vars()):
        return Effect.INPLACE
    return Effect.PURE


@dataclass(eq=False)
class Def:
    """One binding of ``name``.  ``kind``: ``"op"`` (an op output /
    attr-defined extra output), ``"bind"`` (control-flow entry binding),
    ``"entry"`` (block-entry value of a feed/data/persistable)."""

    name: str
    block_idx: Optional[int]
    op_idx: Optional[int]
    op_type: Optional[str]
    pos: int
    kind: str
    loops: Tuple = ()
    uses: List["Use"] = field(default_factory=list)
    roots: Set["Def"] = field(default_factory=set)

    def site(self, paths: Optional[Dict[int, str]] = None) -> str:
        if self.kind == "entry":
            return "entry"
        bp = (paths or {}).get(self.block_idx)
        return op_site(self.block_idx, self.op_idx, self.op_type,
                       block_path=bp)


@dataclass(eq=False)
class Use:
    """One read site; ``defs`` = the Defs that may reach it."""

    name: str
    block_idx: int
    op_idx: int
    op_type: str
    pos: int
    loops: Tuple = ()
    defs: Set[Def] = field(default_factory=set)

    def site(self, paths: Optional[Dict[int, str]] = None) -> str:
        bp = (paths or {}).get(self.block_idx)
        return op_site(self.block_idx, self.op_idx, self.op_type,
                       block_path=bp)


@dataclass
class Dataflow:
    """The analysis result: chains + liveness + aliasing + effects."""

    program: Any
    defs: List[Def]
    uses: List[Use]
    entry_defs: Dict[str, Def]
    final_env: Dict[str, Set[Def]]
    effects: Dict[Tuple[int, int], Effect]
    block_paths: Dict[int, str]
    alias_escapes: List[dict]
    fetch: Set[str]
    feed: Set[str]

    def defs_of(self, name: str) -> List[Def]:
        return sorted((d for d in self.defs if d.name == name),
                      key=lambda d: d.pos)

    def uses_of(self, name: str) -> List[Use]:
        return sorted((u for u in self.uses if u.name == name),
                      key=lambda u: u.pos)

    def site(self, node) -> str:
        return node.site(self.block_paths)


@dataclass
class DonationHazard:
    """Proof failure for one donated persistable: its entry value may be
    read after its first overwrite."""

    name: str
    entry: Def
    overwrites: List[Def]
    stale_reads: List[Use]

    def describe(self, paths: Optional[Dict[int, str]] = None) -> str:
        ow = ", ".join(d.site(paths) for d in self.overwrites[:3])
        reads = ", ".join(
            u.site(paths) + (f" via alias '{u.name}'"
                             if u.name != self.name else "")
            for u in self.stale_reads[:3])
        return (f"donated persistable '{self.name}' (defined on entry) is "
                f"overwritten at {ow} but its pre-update value may still be "
                f"read at {reads}")


@dataclass
class FusionGroup:
    """One legality-certified fusion candidate in the global block.

    ``edges`` is the dependence certificate the 3(c) pass consumes: every
    intra-group producer→consumer edge with its def site, use site, and
    consumer count (always 1 — the single-consumer proof)."""

    kind: str                   # "elementwise_chain" | "producer_consumer"
    block_idx: int
    op_idxs: List[int]
    inputs: List[str]
    outputs: List[str]
    edges: List[dict]

    def to_dict(self) -> dict:
        return {"kind": self.kind, "block_idx": self.block_idx,
                "op_idxs": list(self.op_idxs), "inputs": list(self.inputs),
                "outputs": list(self.outputs), "edges": list(self.edges)}


# --------------------------------------------------------------------------
# the walker
# --------------------------------------------------------------------------

class _Walker:
    def __init__(self, program, feed: Iterable[str], fetch: Iterable[str]):
        self.program = program
        self.feed = {n if isinstance(n, str) else getattr(n, "name", str(n))
                     for n in (feed or ())}
        self.fetch = {n if isinstance(n, str) else getattr(n, "name", str(n))
                      for n in (fetch or ())}
        self._pos = 0
        self._def_index: Dict[tuple, Def] = {}
        self._use_index: Dict[tuple, Use] = {}
        self.defs: List[Def] = []
        self.uses: List[Use] = []
        self.entry_defs: Dict[str, Def] = {}
        self.effects: Dict[Tuple[int, int], Effect] = {}
        self.alias_escapes: List[dict] = []
        self._escape_seen: Set[tuple] = set()
        self._loop_stack: List[Tuple[int, int]] = []
        # transitive write set of the OUTERMOST active control region —
        # "is the aliased base var updated anywhere in this loop/branch?"
        self._region_writes: List[Set[str]] = []

    # -- node interning ----------------------------------------------------
    def _entry(self, name: str) -> Def:
        d = self.entry_defs.get(name)
        if d is None:
            d = Def(name, None, None, None, 0, "entry")
            d.roots = {d}
            self.entry_defs[name] = d
            self.defs.append(d)
        return d

    def _def(self, name: str, block_idx: int, op_idx: Optional[int],
             op_type: Optional[str], kind: str) -> Def:
        key = (kind, block_idx, op_idx, name)
        d = self._def_index.get(key)
        if d is None:
            d = Def(name, block_idx, op_idx, op_type, self._pos, kind,
                    loops=tuple(self._loop_stack))
            d.roots = {d}
            self._def_index[key] = d
            self.defs.append(d)
        return d

    def _use(self, name: str, block_idx: int, op_idx: int, op_type: str,
             reaching: Set[Def]) -> Use:
        key = (block_idx, op_idx, name)
        u = self._use_index.get(key)
        if u is None:
            u = Use(name, block_idx, op_idx, op_type, self._pos,
                    loops=tuple(self._loop_stack))
            self._use_index[key] = u
            self.uses.append(u)
        for d in reaching:
            if u not in d.uses:
                d.uses.append(u)
            u.defs.add(d)
        return u

    # -- env helpers -------------------------------------------------------
    @staticmethod
    def _copy_env(env: Dict[str, Set[Def]]) -> Dict[str, Set[Def]]:
        return {k: set(v) for k, v in env.items()}

    @staticmethod
    def _merge_into(env: Dict[str, Set[Def]], other: Dict[str, Set[Def]]):
        for k, s in other.items():
            env.setdefault(k, set()).update(s)

    def _seed_block(self, block, env: Dict[str, Set[Def]]):
        for name, v in block.vars.items():
            if (v.is_data or v.persistable) and name not in env:
                env[name] = {self._entry(name)}

    def _reach(self, name: str, env: Dict[str, Set[Def]]) -> Set[Def]:
        got = env.get(name)
        if not got:
            # undefined read (V001's finding) or a feed-only name: give it
            # an entry Def so chains stay total and nothing here crashes
            got = {self._entry(name)}
            env[name] = set(got)
        return got

    # -- the walk ----------------------------------------------------------
    def run(self) -> Dataflow:
        program = self.program
        root = program.blocks[0]
        env: Dict[str, Set[Def]] = {}
        for n in self.feed:
            env[n] = {self._entry(n)}
        self._seed_block(root, env)
        self._walk_block(root, env, visiting=(0,))
        paths = block_paths(program)
        return Dataflow(program, self.defs, self.uses, self.entry_defs,
                        env, self.effects, paths, self.alias_escapes,
                        self.fetch, self.feed)

    def _walk_block(self, block, env: Dict[str, Set[Def]],
                    visiting: Tuple[int, ...]):
        program = self.program
        for idx, op in enumerate(block.ops):
            self._pos += 1
            self.effects.setdefault((block.idx, idx), classify_effect(op))

            # ---- reads (inputs + env-read attr names) -------------------
            for n in op.input_vars() + _attr_names(op, _ATTR_READ_KEYS):
                self._use(n, block.idx, idx, op.type, self._reach(n, env))
            if op.type == "autodiff_grad":
                # the grad replay re-runs forward ops from the trace-entry
                # env: every entry-defined feed/data value is read again
                for n, e in list(self.entry_defs.items()):
                    v = block.vars.get(n)
                    if v is not None and v.is_data or n in self.feed:
                        self._use(n, block.idx, idx, op.type, {e})

            # ---- sub-blocks ---------------------------------------------
            subs = []
            for key in BLOCK_ATTR_KEYS:
                si = op.attrs.get(key)
                if (isinstance(si, int) and 0 < si < len(program.blocks)
                        and si not in visiting):
                    subs.append(si)
            if subs and op.type == "conditional_block":
                branch_envs = []
                for si in subs:
                    benv = self._copy_env(env)
                    self._enter_region(op, block, idx)
                    self._seed_block(program.blocks[si], benv)
                    self._walk_block(program.blocks[si], benv,
                                     visiting + (si,))
                    self._exit_region()
                    branch_envs.append(benv)
                # may-reach merge; an else-less cond keeps env as the
                # implicit empty branch, and both-branch kills stay
                # conservatively reaching (union, never intersection)
                for benv in branch_envs:
                    self._merge_into(env, benv)
            elif subs:
                # loop-shaped: walk twice so back-edge reads land on the
                # body's Defs (see module docstring)
                for si in subs:
                    sub = program.blocks[si]
                    self._loop_stack.append((block.idx, idx))
                    self._enter_region(op, block, idx)
                    benv = self._copy_env(env)
                    for n in _attr_names(op, _ATTR_BIND_KEYS):
                        d = self._def(n, si, None, op.type, "bind")
                        benv[n] = {d}
                    self._seed_block(sub, benv)
                    self._walk_block(sub, benv, visiting + (si,))
                    merged = self._copy_env(env)
                    self._merge_into(merged, benv)
                    for n in _attr_names(op, _ATTR_BIND_KEYS):
                        merged[n] = {self._def(n, si, None, op.type, "bind")}
                    self._walk_block(sub, merged, visiting + (si,))
                    # per-iteration re-reads of the loop-carried inputs
                    # (the while condition, scan memories) hit body writes
                    for n in (op.input_vars()
                              + _attr_names(op, _ATTR_READ_KEYS)):
                        if n in merged:
                            self._use(n, block.idx, idx, op.type, merged[n])
                    self._exit_region()
                    self._loop_stack.pop()
                    self._merge_into(env, merged)
            # lowering-time reads of sub-block results (scan step outputs,
            # memory updates) — reads even though not in op.inputs
            for key in _LOWERING_READ_KEYS:
                if key in op.attrs:
                    for n in _names(op.attrs.get(key)):
                        self._use(n, block.idx, idx, op.type,
                                  self._reach(n, env))

            # ---- writes -------------------------------------------------
            view_roots: Optional[Set[Def]] = None
            if op.type in VIEW_OPS:
                ins = op.input_vars()
                if ins:
                    view_roots = set()
                    for d in env.get(ins[0], ()):
                        view_roots |= d.roots
            out_names = list(dict.fromkeys(op.output_vars()))
            for n in out_names:
                if block.idx != 0:
                    self._check_alias_escape(n, env, block, idx, op)
                d = self._def(n, block.idx, idx, op.type, "op")
                if view_roots:
                    d.roots |= view_roots
                env[n] = {d}
            for n in _attr_names(op, _ATTR_DEFINE_KEYS):
                d = self._def(n, block.idx, idx, op.type, "op")
                env[n] = {d}

    # -- alias escape (L012) ----------------------------------------------
    def _enter_region(self, op, block, idx):
        if not self._region_writes:
            writes: Set[str] = set()
            for key in BLOCK_ATTR_KEYS:
                si = op.attrs.get(key)
                if isinstance(si, int) and 0 < si < len(self.program.blocks):
                    writes |= _transitive_writes(self.program,
                                                 self.program.blocks[si])
            writes |= set(_attr_names(op, _ATTR_DEFINE_KEYS))
            self._region_writes.append(writes)
        else:
            self._region_writes.append(self._region_writes[0])

    def _exit_region(self):
        self._region_writes.pop()

    def _check_alias_escape(self, name, env, block, idx, op):
        region = self._region_writes[0] if self._region_writes else set()
        for d_prev in env.get(name, ()):
            for r in d_prev.roots:
                if r.name == name or r is d_prev:
                    continue
                outer = (r.kind == "entry"
                         or (r.block_idx is not None
                             and r.block_idx != block.idx
                             and self._is_ancestor(r.block_idx, block)))
                if not outer or r.name in region:
                    continue
                key = (block.idx, idx, name, r.name)
                if key in self._escape_seen:
                    continue
                self._escape_seen.add(key)
                self.alias_escapes.append({
                    "name": name, "base": r.name,
                    "block_idx": block.idx, "op_idx": idx,
                    "op_type": op.type,
                    "view_def": d_prev, "base_def": r})

    def _is_ancestor(self, anc_idx: int, block) -> bool:
        b = block
        guard = len(self.program.blocks) + 1
        while b is not None and guard:
            guard -= 1
            if b.idx == anc_idx:
                return True
            p = b.parent_idx
            b = (self.program.blocks[p]
                 if isinstance(p, int) and 0 <= p < len(self.program.blocks)
                 else None)
        return anc_idx == 0


def analyze_dataflow(program, feed: Iterable[str] = (),
                     fetch: Iterable[str] = ()) -> Dataflow:
    """Build def-use chains, reaching defs, alias roots, and effects for
    ``program``.  ``feed``/``fetch`` are var-name iterables (liveness roots
    and entry seeds); both optional."""
    return _Walker(program, feed, fetch).run()


# --------------------------------------------------------------------------
# consumer 1: donation-safety proof
# --------------------------------------------------------------------------

def donation_hazards(program, feed: Iterable[str] = (),
                     fetch: Iterable[str] = (),
                     df: Optional[Dataflow] = None) -> List[DonationHazard]:
    """Statically prove donation safety for every donate candidate.

    Candidates mirror the executor's split: global-block persistables the
    program overwrites, minus fed/fetched names.  For candidate ``p`` with
    entry Def ``e``: a :class:`DonationHazard` is reported iff some Use
    reads, *through a view alias*, a Def rooted at ``e`` after ``p``'s
    first overwrite in walk order, or from inside a loop that also
    contains an overwrite (loops re-execute, so intra-iteration order
    does not protect the read).  Direct reads of ``p``'s own name are
    never hazardous — a name read always observes the current scope
    value, and a post-overwrite read that still reaches ``e`` does so
    only on a path where the overwrite did not execute (zero-trip loop
    or untaken branch).  Only an alias captured *before* the overwrite
    can pin the donated buffer's pre-update bytes.  An empty return is
    the proof: every donated buffer's entry value is dead at its
    overwrite."""
    if df is None:
        df = analyze_dataflow(program, feed=feed, fetch=fetch)
    block = program.blocks[0]
    skip = df.feed | df.fetch
    hazards: List[DonationHazard] = []
    for name, v in sorted(block.vars.items()):
        if not v.persistable or name in skip:
            continue
        entry = df.entry_defs.get(name)
        if entry is None:
            continue
        overwrites = [d for d in df.defs_of(name) if d.kind == "op"]
        if not overwrites:
            continue
        first = min(d.pos for d in overwrites)
        ow_loops = {l for d in overwrites for l in d.loops}
        stale: List[Use] = []
        for u in df.uses:
            if u.name == name:
                continue   # a direct name read observes the current value
            if not any(entry in d.roots for d in u.defs):
                continue
            if u.pos > first or (ow_loops and set(u.loops) & ow_loops):
                stale.append(u)
        if stale:
            hazards.append(DonationHazard(
                name, entry, overwrites,
                sorted(stale, key=lambda u: u.pos)))
    return hazards


# --------------------------------------------------------------------------
# consumer 2: fusion-legality oracle
# --------------------------------------------------------------------------

def _single_consumer_edges(df: Dataflow, block) -> Dict[tuple, dict]:
    """(producer op idx, consumer op idx, name) -> certificate dict for
    every global-block edge that is provably single-consumer: the value is
    produced by exactly one reaching Def, read at exactly one op site, and
    escapes nowhere (not fetched, not persistable, not read from another
    block, not live-out as a data var)."""
    edges: Dict[tuple, dict] = {}
    for d in df.defs:
        if d.kind != "op" or d.block_idx != block.idx:
            continue
        v = block.vars.get(d.name)
        if v is not None and (v.persistable or v.is_data):
            continue
        if d.name in df.fetch:
            continue
        sites = {(u.block_idx, u.op_idx) for u in d.uses}
        if len(sites) != 1:
            continue
        (ub, uo), = sites
        if ub != block.idx:
            continue
        use = next(u for u in d.uses if u.op_idx == uo)
        if use.defs != {d}:
            continue          # the consumer may read a different Def too
        edges[(d.op_idx, uo, d.name)] = {
            "var": d.name, "def": df.site(d), "use": df.site(use),
            "n_consumers": 1}
    return edges


def fusable_groups(program, fetch: Iterable[str] = (),
                   feed: Iterable[str] = (),
                   df: Optional[Dataflow] = None) -> List[FusionGroup]:
    """The fusion-legality oracle over the global block.

    Emits two group kinds, each carrying a dependence certificate:

    - ``elementwise_chain`` — maximal components of pure elementwise ops
      linked by single-consumer intermediates.  Always legal to fuse: the
      composition is a pure per-element function of the group inputs.
    - ``producer_consumer`` — a pure non-elementwise producer (matmul,
      conv, reduce) whose single consumer is a pure elementwise op: the
      epilogue-fusion shape (TVM's complex-out-fusable class).

    A value read by two ops is *never* inside a group (the shared-consumer
    rejection): fusing one consumer would either recompute the producer or
    force a materialization — exactly the cases the 3(c) pass must prove
    about, so the oracle refuses to certify them.  Groups only ever
    contain ``pure`` ops: in-place, side-effecting, and control ops have
    ordering obligations a fused region cannot honor."""
    if df is None:
        df = analyze_dataflow(program, feed=feed, fetch=fetch)
    block = program.blocks[0]
    eff = df.effects
    ops = block.ops

    def pure(i):
        return eff.get((block.idx, i)) == Effect.PURE

    def ew(i):
        return pure(i) and ops[i].type in ELEMENTWISE_OPS

    edges = _single_consumer_edges(df, block)

    # union-find over elementwise ops linked by single-consumer edges
    parent = list(range(len(ops)))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    def union(i, j):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[rj] = ri

    for (i, j, _name) in edges:
        if ew(i) and ew(j):
            union(i, j)
    comps: Dict[int, List[int]] = {}
    for i in range(len(ops)):
        if ew(i):
            comps.setdefault(find(i), []).append(i)

    groups: List[FusionGroup] = []
    chained: Set[int] = set()
    for comp in comps.values():
        if len(comp) < 2:
            continue
        comp = sorted(comp)
        chained.update(comp)
        groups.append(_certify(df, block, comp, "elementwise_chain", edges))

    # producer -> consumer epilogues: pure non-elementwise producer whose
    # sole consumer is an elementwise op not already inside a chain
    for (i, j, name) in sorted(edges):
        if pure(i) and not ew(i) and ew(j) and j not in chained:
            groups.append(_certify(df, block, [i, j], "producer_consumer",
                                   edges))
    groups.sort(key=lambda g: g.op_idxs[0])
    return groups


def _certify(df: Dataflow, block, comp: List[int], kind: str,
             edges: Dict[tuple, dict]) -> FusionGroup:
    inside = set(comp)
    cert = [c for (i, j, _n), c in sorted(edges.items())
            if i in inside and j in inside]
    internal = {c["var"] for c in cert}
    inputs: List[str] = []
    for i in comp:
        for n in block.ops[i].input_vars():
            if n not in internal and n not in inputs:
                inputs.append(n)
    outputs: List[str] = []
    for i in comp:
        for n in block.ops[i].output_vars():
            if n not in internal and n not in outputs:
                outputs.append(n)
    return FusionGroup(kind, block.idx, sorted(comp), inputs, outputs, cert)


def region_schedulable(block, group: FusionGroup) -> bool:
    """Can ``group`` legally execute as ONE region at its first member's
    position?  The dependence certificate proves the intra-group edges;
    this proves the *rewrite*: hoisting every member up to the first
    member's slot must not cross a non-member op that (re)defines a group
    input or touches a group output name.  Conservative — a False here
    forgoes a fusion, never risks one (the executor counts it as
    ``reason="not_schedulable"``)."""
    s, e = group.op_idxs[0], group.op_idxs[-1]
    members = set(group.op_idxs)
    ins, outs = set(group.inputs), set(group.outputs)
    for k in range(s + 1, e):
        if k in members:
            continue
        op = block.ops[k]
        if set(op.output_vars()) & (ins | outs):
            return False
        if set(op.input_vars()) & outs:
            return False
    return True


def certificate_matches(cert: dict, group: FusionGroup,
                        op_types: Sequence[str]) -> bool:
    """Does a *persisted* certificate (an autotune-cache ``fusion`` entry)
    still describe ``group`` as the oracle certifies it TODAY?  Exact
    match on kind, member indices, member op types, boundary vars, and
    edge vars — any drift means the entry was measured on a different
    graph and is refused at consult time (and flagged by L008)."""
    if not isinstance(cert, dict):
        return False
    try:
        return (cert.get("kind") == group.kind
                and list(cert.get("op_idxs") or []) == list(group.op_idxs)
                and list(cert.get("op_types") or []) == list(op_types)
                and list(cert.get("inputs") or []) == list(group.inputs)
                and list(cert.get("outputs") or []) == list(group.outputs)
                and [e.get("var") for e in (cert.get("edges") or [])]
                == [e["var"] for e in group.edges])
    except (TypeError, AttributeError):
        return False


# --------------------------------------------------------------------------
# consumer 4: --explain chains
# --------------------------------------------------------------------------

def explain_var(df: Dataflow, name: str) -> Optional[str]:
    """One-line def-use chain for ``name``: where it is defined (and
    redefined), and where it is last read — the ``lint --explain`` text."""
    defs = df.defs_of(name)
    if not defs:
        return None
    paths = df.block_paths
    first = defs[0]
    if first.kind == "entry":
        s = f"'{name}': defined on entry"
    else:
        s = f"'{name}': defined at {first.site(paths)}"
    redefs = [d for d in defs[1:] if d.kind == "op"]
    if redefs:
        s += (f", redefined at {redefs[0].site(paths)}"
              + (f" (+{len(redefs) - 1} more)" if len(redefs) > 1 else ""))
    all_uses = sorted({u for d in defs for u in d.uses}, key=lambda u: u.pos)
    if all_uses:
        s += f", last read at {all_uses[-1].site(paths)}"
    elif name in df.fetch:
        s += ", read by fetch"
    else:
        s += ", never read"
    return s
