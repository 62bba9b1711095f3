"""Program IR: Program{Block{Operator, Variable}} — the gen-2 desc layer.

Re-provides the reference's ProgramDesc/BlockDesc/OpDesc/VarDesc IR
(paddle/framework/framework.proto; program_desc.h, block_desc.h, op_desc.h,
var_desc.h; Python mirror python/paddle/v2/fluid/framework.py) as plain Python
descs. The port's copy of ``paddle_tpu/fluid/framework.py``: the same
classes and the same JSON, so a program built with either package reads in the
other. The port's executor runs a block's ops over torch tensors and replays
them as one CUDA graph per feed signature (fluid/executor.py).

Serialization: ``Program.to_dict()/from_dict()`` (JSON-able) stands in for the
protobuf round-trip.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np


class Variable:
    """VarDesc analog: name, shape (-1 = dynamic batch), dtype, persistable."""

    def __init__(self, block: "Block", name: str, shape: Sequence[int] = (),
                 dtype: str = "float32", persistable: bool = False,
                 is_data: bool = False, lod_level: int = 0,
                 trainable: bool = True,
                 sharding: Optional[Sequence[Optional[str]]] = None,
                 bucket_axis: Optional[int] = None):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(dtype).name
        self.persistable = persistable
        self.is_data = is_data
        self.lod_level = lod_level
        # persistable state that is NOT a learnable weight (BN running stats,
        # evaluator accumulators) sets trainable=False so autodiff/optimizers
        # skip it while the executor still syncs it to the scope
        self.trainable = trainable
        # optional mesh-axis annotation, one entry per tensor dim (None =
        # replicated); validated against parallel.mesh.CANONICAL_ORDER by
        # analysis.lints L004. A bare string means one axis, not its chars.
        if isinstance(sharding, str):
            sharding = (sharding,)
        self.sharding = tuple(sharding) if sharding is not None else None
        # which axis of a feed varies in length (the executor's BucketSpec
        # pads it when no axis is pinned in the spec); rides Program JSON
        # like sharding so a deserialized program keeps its feed contract
        self.bucket_axis = (int(bucket_axis) if bucket_axis is not None
                            else None)

    def __repr__(self):
        return (f"Variable({self.name}, shape={self.shape}, dtype={self.dtype}"
                f"{', persistable' if self.persistable else ''})")

    def to_dict(self):
        d = {"name": self.name, "shape": list(self.shape),
             "dtype": self.dtype, "persistable": self.persistable,
             "is_data": self.is_data, "lod_level": self.lod_level,
             "trainable": self.trainable}
        # per-parameter attrs (ParamAttr) + sharding: only present when set
        for k in ("lr_scale", "l2_rate"):
            if getattr(self, k, None) is not None:
                d[k] = getattr(self, k)
        if self.sharding is not None:
            d["sharding"] = list(self.sharding)
        if self.bucket_axis is not None:
            d["bucket_axis"] = self.bucket_axis
        return d


class Operator:
    """OpDesc analog: type + named input/output var lists + attrs."""

    def __init__(self, block: "Block", op_type: str,
                 inputs: Dict[str, List[str]], outputs: Dict[str, List[str]],
                 attrs: Optional[Dict[str, Any]] = None):
        from .registry import OpRegistry  # late import to avoid cycle
        if not OpRegistry.has(op_type):
            raise ValueError(f"operator '{op_type}' is not registered")
        self.block = block
        self.type = op_type
        self.inputs = {k: list(v) for k, v in inputs.items()}
        self.outputs = {k: list(v) for k, v in outputs.items()}
        self.attrs = dict(attrs or {})

    def input_vars(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_vars(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def __repr__(self):
        return f"Operator({self.type}: {self.inputs} -> {self.outputs})"

    def to_dict(self):
        # callable attrs (host initializers) cannot serialize, but DROPPING
        # the key would make the serialized op lie about its attr surface —
        # diagnostics and goldens need the key, so emit a named placeholder
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs,
                "attrs": {k: (v if not callable(v) else
                              f"<callable:{getattr(v, '__name__', type(v).__name__)}>")
                          for k, v in self.attrs.items()}}


class Block:
    """BlockDesc analog: ordered op list + var table (scope.h namespace idea
    lives at runtime in executor.Scope)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    def create_var(self, name: Optional[str] = None, **kw) -> Variable:
        if name is None:
            name = self.program.unique_name("tmp")
        v = Variable(self, name, **kw)
        self.vars[name] = v
        return v

    def var(self, name: str) -> Variable:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = (self.program.blocks[b.parent_idx]
                 if b.parent_idx >= 0 else None)
        raise KeyError(f"variable '{name}' not found")

    def has_var(self, name: str) -> bool:
        try:
            self.var(name)
            return True
        except KeyError:
            return False

    def append_op(self, op_type: str, inputs, outputs, attrs=None) -> Operator:
        op = Operator(self, op_type, inputs, outputs, attrs)
        self.ops.append(op)
        self.program.version += 1
        return op

    def all_parameters(self) -> List[Variable]:
        return [v for v in self.vars.values()
                if v.persistable and not v.is_data and v.trainable]

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": self.parent_idx,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [o.to_dict() for o in self.ops]}


class Program:
    """ProgramDesc analog. Two default programs mirror fluid's
    default_startup_program (param init ops) + default_main_program."""

    _serial_counter = 0

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self._name_counter = 0
        # Monotonic identity + mutation stamp for the executor's compiled-fn
        # cache: id(program) can be reused after GC, and an op list edited in
        # place must invalidate the cache (the reference recompiles per Run).
        Program._serial_counter += 1
        self._serial = Program._serial_counter
        self.version = 0
        # block stack for control-flow builders (While/StaticRNN/IfElse):
        # layer builders append ops to current_block(), which is the global
        # block unless a sub-block guard is active (BlockDesc nesting,
        # block_desc.h + fluid framework.py Program.current_block)
        self._block_stack: List[int] = [0]

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self._block_stack[-1]]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        if parent_idx is None:
            parent_idx = self._block_stack[-1]
        b = Block(self, len(self.blocks), parent_idx)
        self.blocks.append(b)
        return b

    @contextlib.contextmanager
    def block_guard(self, block: "Block"):
        """Append subsequent ops into ``block`` (control-flow sub-block)."""
        self._block_stack.append(block.idx)
        try:
            yield block
        finally:
            self._block_stack.pop()

    def unique_name(self, prefix: str) -> str:
        self._name_counter += 1
        return f"{prefix}_{self._name_counter}"

    def to_dict(self):
        return {"blocks": [b.to_dict() for b in self.blocks]}

    @classmethod
    def from_dict(cls, d) -> "Program":
        p = cls()
        p.blocks = []
        for bd in d["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                v = Variable(
                    b, vd["name"], vd["shape"], vd["dtype"],
                    vd["persistable"], vd["is_data"], vd.get("lod_level", 0),
                    vd.get("trainable", True), vd.get("sharding"),
                    vd.get("bucket_axis"))
                for k in ("lr_scale", "l2_rate"):
                    if k in vd:
                        setattr(v, k, vd[k])
                b.vars[vd["name"]] = v
            for od in bd["ops"]:
                b.append_op(od["type"], od["inputs"], od["outputs"], od["attrs"])
            p.blocks.append(b)
        return p

    # pruning (framework/prune.cc analog): keep only ops feeding the targets
    def prune(self, targets: Sequence[str]) -> "Program":
        """The program cut to the global block's ops the targets need. An
        op that runs sub-blocks (While, Cond, StaticRNN, beam search) reads
        and writes what its sub-blocks do, and what its attrs name; the
        sub-blocks are kept, so control flow survives the cut (JAX's prune
        keeps the global block alone)."""
        block = self.global_block()
        needed = set(targets)
        keep: List[Operator] = []
        for op in reversed(block.ops):
            reads, writes = self._op_io(op)
            if needed & writes or op.type in ("feed",):
                keep.append(op)
                needed |= reads
        pruned = Program()
        nb = pruned.global_block()
        nb.vars = dict(block.vars)
        nb.ops = list(reversed(keep))
        pruned.blocks.extend(self.blocks[1:])
        pruned._name_counter = self._name_counter
        return pruned

    def _op_io(self, op: Operator, seen=()) -> Tuple[Set[str], Set[str]]:
        """(names read, names written) by ``op``, its attrs and, through
        its block attrs, every op of its sub-blocks."""
        from ..analysis.verify import (BLOCK_ATTR_KEYS, _ATTR_DEFINE_KEYS,
                                       _ATTR_READ_KEYS, _attr_names)
        reads = set(op.input_vars()) | set(_attr_names(op, _ATTR_READ_KEYS))
        writes = (set(op.output_vars())
                  | set(_attr_names(op, _ATTR_DEFINE_KEYS)))
        for key in BLOCK_ATTR_KEYS:
            idx = op.attrs.get(key)
            if isinstance(idx, int) and 0 < idx < len(self.blocks) \
                    and idx not in seen:
                for sub in self.blocks[idx].ops:
                    r, w = self._op_io(sub, tuple(seen) + (idx,))
                    reads |= r
                    writes |= w
        return reads, writes


# -- default-program context (fluid framework.py:default_main_program) ---------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def reset_default_programs():
    global _main_program, _startup_program
    _main_program = Program()
    _startup_program = Program()
    # Also rewind the layers seed counter: initializer seeds are minted
    # from a process-global stream, so without this a program's weight
    # draws depend on how many layers the process built before it —
    # programs built after a reset would not be reproducible.
    _layers = sys.modules.get(__package__ + ".layers")
    if _layers is not None:
        _layers._seed_counter[0] = 0


@contextlib.contextmanager
def program_guard(main: Program, startup: Optional[Program] = None):
    global _main_program, _startup_program
    prev_m, prev_s = _main_program, _startup_program
    _main_program = main
    if startup is not None:
        _startup_program = startup
    try:
        yield
    finally:
        _main_program, _startup_program = prev_m, prev_s
