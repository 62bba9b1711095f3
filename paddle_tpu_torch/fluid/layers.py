"""Op-emitting layer builders (fluid/layers.py analog).

Each function appends OpDescs+VarDescs to the default main program and returns
the output Variable — the same builder pattern as python/paddle/v2/fluid/
layers.py (fc:18, embedding:90, data:179, conv2d:638). Parameter creation goes
through ``_create_parameter`` which also appends the init op to the startup
program (fluid initializer semantics).
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from ..nn import initializer as I
from .framework import (Program, Variable, default_main_program,
                        default_startup_program)

_seed_counter = [0]


def _next_seed() -> int:
    _seed_counter[0] += 1
    return _seed_counter[0]


def _block():
    # current (possibly control-flow sub-) block — While/StaticRNN/Cond
    # builders push sub-blocks onto the program's block stack
    return default_main_program().current_block()


def _create_parameter(name_hint: str, shape, dtype="float32",
                      init: Optional[I.Initializer] = None,
                      trainable: bool = True, attr=None) -> Variable:
    """``attr`` carries ParamAttr-style per-parameter settings (the gen-1
    ParameterAttribute, trainer_config_helpers/attrs.py:52): dict keys
    ``name`` (exact name; a SECOND creation under the same name returns the
    existing parameter — the reference's name-based weight sharing between
    layers and between train/generate sub-models), ``init`` (overrides the
    layer's default initializer), ``is_static`` (frozen: no grad/update),
    ``lr_scale`` (per-param learning-rate multiplier) and ``l2_rate``
    (per-param weight decay) — the latter two consumed by
    fluid.optimizer.Optimizer.minimize — and ``sharding`` (one mesh axis
    name or None per dim; lowered by the mesh-aware Executor, linted by
    L004)."""
    main = default_main_program()
    attr = dict(attr) if attr else {}
    exact = attr.get("name")
    if exact is not None:
        existing = main.global_block().vars.get(exact)
        if existing is not None:
            if tuple(existing.shape) != tuple(shape):
                raise ValueError(
                    f"shared parameter {exact!r} shape mismatch: existing "
                    f"{existing.shape} vs requested {tuple(shape)}")
            if existing.dtype != np.dtype(dtype).name:
                raise ValueError(
                    f"shared parameter {exact!r} dtype mismatch: existing "
                    f"{existing.dtype} vs requested {dtype}")
            # behavioral attrs belong to the FIRST creation; a conflicting
            # re-declaration must fail loudly, not be silently dropped
            for key, current in (
                    ("is_static", not existing.trainable),
                    ("lr_scale", getattr(existing, "lr_scale", None)),
                    ("l2_rate", getattr(existing, "l2_rate", None)),
                    ("sharding", getattr(existing, "sharding", None))):
                if key in attr and attr[key] != current:
                    raise ValueError(
                        f"shared parameter {exact!r}: conflicting {key!r} "
                        f"({attr[key]!r} vs the creating layer's "
                        f"{current!r}); set attrs on the FIRST use only")
            return existing
        name = exact
    else:
        name = main.unique_name(name_hint)
    if attr.get("is_static"):
        trainable = False
    v = main.global_block().create_var(name=name, shape=shape, dtype=dtype,
                                       persistable=True, trainable=trainable)
    if attr.get("lr_scale") is not None:
        v.lr_scale = float(attr["lr_scale"])
    if attr.get("l2_rate") is not None:
        v.l2_rate = float(attr["l2_rate"])
    if attr.get("sharding") is not None:
        sh = attr["sharding"]
        v.sharding = (sh,) if isinstance(sh, str) else tuple(sh)
    sb = default_startup_program().global_block()
    sv = sb.create_var(name=name, shape=shape, dtype=dtype, persistable=True)
    sb.append_op("fill_init", inputs={}, outputs={"Out": [name]},
                 attrs={"shape": tuple(shape), "dtype": dtype,
                        "init": attr.get("init") or init or I.gen1_default(),
                        "seed": _next_seed()})
    return v


def data(name: str, shape: Sequence[int], dtype="float32",
         lod_level: int = 0,
         sharding: Optional[Sequence[Optional[str]]] = None,
         bucket_axis: Optional[int] = None) -> Variable:
    """Feed slot (layers.py data:179); shape excludes the batch dim.

    ``sharding`` optionally names one mesh axis per dim (batch dim included,
    None = replicated), e.g. ``("data", None)`` — checked against
    parallel.mesh axis names by ``analysis.lint_program`` (L004).

    ``bucket_axis`` marks the variable-length axis (batch dim included) the
    executor's ``BucketSpec`` pads when the spec doesn't pin one — set it
    when the dynamic axis is not the feed's first ``-1`` dim."""
    return _block().create_var(name=name, shape=(-1,) + tuple(shape),
                               dtype=dtype, is_data=True, lod_level=lod_level,
                               sharding=sharding, bucket_axis=bucket_axis)


def fc(input: Variable, size: int, act: Optional[str] = None,
       bias_attr: bool = True, param_init=None, param_attr=None,
       bias_param_attr=None) -> Variable:
    # reference fc semantics (num_flatten_dims=1): everything after the batch
    # dim is flattened into the contraction, weight is [prod(rest), size]
    b = _block()
    in_dim = int(np.prod(input.shape[1:]))
    w = _create_parameter("fc_w", (in_dim, size), input.dtype, param_init,
                          attr=param_attr)
    out = b.create_var(shape=(input.shape[0], size), dtype=input.dtype)
    b.append_op("mul", {"X": [input.name], "Y": [w.name]},
                {"Out": [out.name]}, {"x_num_col_dims": 1})
    if bias_attr:
        bias = _create_parameter("fc_b", (size,), input.dtype, I.zeros,
                                 attr=bias_param_attr)
        out2 = b.create_var(shape=out.shape, dtype=out.dtype)
        b.append_op("elementwise_add", {"X": [out.name], "Y": [bias.name]},
                    {"Out": [out2.name]})
        out = out2
    if act:
        out = activation(out, act)
    return out


def embedding(input: Variable, size: Sequence[int], param_init=None,
              param_attr=None) -> Variable:
    b = _block()
    w = _create_parameter("embedding_w", tuple(size), "float32",
                          param_init or I.normal(0.0, 0.01), attr=param_attr)
    out = b.create_var(shape=input.shape + (size[1],), dtype="float32")
    b.append_op("lookup_table", {"W": [w.name], "Ids": [input.name]},
                {"Out": [out.name]})
    return out


def activation(input: Variable, act: str) -> Variable:
    b = _block()
    out = b.create_var(shape=input.shape, dtype=input.dtype)
    b.append_op(act, {"X": [input.name]}, {"Out": [out.name]})
    return out


def relu(x):
    return activation(x, "relu")


def sigmoid(x):
    return activation(x, "sigmoid")


def tanh(x):
    return activation(x, "tanh")


def softmax(x):
    return activation(x, "softmax")


def _binary(op_type: str, x: Variable, y: Variable) -> Variable:
    b = _block()
    out = b.create_var(shape=x.shape, dtype=x.dtype)
    b.append_op(op_type, {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]})
    return out


def elementwise_add(x, y):
    return _binary("elementwise_add", x, y)


def elementwise_sub(x, y):
    return _binary("elementwise_sub", x, y)


def elementwise_mul(x, y):
    return _binary("elementwise_mul", x, y)


def elementwise_div(x, y):
    return _binary("elementwise_div", x, y)


def matmul(x: Variable, y: Variable, transpose_x=False, transpose_y=False) -> Variable:
    b = _block()
    out = b.create_var(shape=x.shape[:-1] + (y.shape[-1],), dtype=x.dtype)
    b.append_op("matmul", {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]},
                {"transpose_X": transpose_x, "transpose_Y": transpose_y})
    return out


def cross_entropy(input: Variable, label: Variable,
                  soft_label: bool = False) -> Variable:
    b = _block()
    out = b.create_var(shape=(input.shape[0], 1), dtype=input.dtype)
    b.append_op("cross_entropy", {"X": [input.name], "Label": [label.name]},
                {"Y": [out.name]}, {"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits: Variable, label: Variable) -> Variable:
    b = _block()
    loss = b.create_var(shape=(logits.shape[0], 1), dtype=logits.dtype)
    soft = b.create_var(shape=logits.shape, dtype=logits.dtype)
    b.append_op("softmax_with_cross_entropy",
                {"Logits": [logits.name], "Label": [label.name]},
                {"Loss": [loss.name], "Softmax": [soft.name]})
    return loss


def mean(x: Variable) -> Variable:
    b = _block()
    out = b.create_var(shape=(), dtype=x.dtype)
    b.append_op("mean", {"X": [x.name]}, {"Out": [out.name]})
    return out


def sums(xs: List[Variable]) -> Variable:
    b = _block()
    out = b.create_var(shape=xs[0].shape, dtype=xs[0].dtype)
    b.append_op("sum", {"X": [v.name for v in xs]}, {"Out": [out.name]})
    return out


def reshape(x: Variable, shape: Sequence[int]) -> Variable:
    b = _block()
    out = b.create_var(shape=tuple(shape), dtype=x.dtype)
    b.append_op("reshape", {"X": [x.name]}, {"Out": [out.name]},
                {"shape": tuple(shape)})
    return out


def concat(xs: List[Variable], axis: int = 0) -> Variable:
    b = _block()
    shape = list(xs[0].shape)
    shape[axis] = sum(v.shape[axis] for v in xs)
    out = b.create_var(shape=tuple(shape), dtype=xs[0].dtype)
    b.append_op("concat", {"X": [v.name for v in xs]}, {"Out": [out.name]},
                {"axis": axis})
    return out


def _ensure_step_var() -> str:
    """Implicit int32 step counter the Executor feeds and increments each run
    — gives stochastic ops a fresh key per batch (the reference reseeds
    per-batch via its global RNG)."""
    b = _block()
    if not b.has_var("__step__"):
        b.create_var(name="__step__", shape=(), dtype="int32", is_data=True)
    return "__step__"


def dropout(x: Variable, dropout_prob: float, is_test: bool = False) -> Variable:
    b = _block()
    out = b.create_var(shape=x.shape, dtype=x.dtype)
    inputs = {"X": [x.name]}
    if not is_test:
        inputs["Step"] = [_ensure_step_var()]
    b.append_op("dropout", inputs, {"Out": [out.name]},
                {"dropout_prob": dropout_prob, "is_test": is_test,
                 "seed": _next_seed()})
    return out


def _spatial_out(size: int, k: int, pad: int, stride: int) -> int:
    """Static conv/pool output extent; -1 propagates unknowns."""
    return (size + 2 * pad - k) // stride + 1 if size > 0 else -1


def conv2d(input: Variable, num_filters: int, filter_size: int, stride=1,
           padding=0, groups: int = 1, act: Optional[str] = None,
           bias_attr: bool = True) -> Variable:
    b = _block()
    cin = input.shape[-1]
    k = (filter_size, filter_size) if isinstance(filter_size, int) else filter_size
    w = _create_parameter("conv2d_w", k + (cin // groups, num_filters),
                          input.dtype, I.msra())
    s = (stride, stride) if isinstance(stride, int) else stride
    p = (padding, padding) if isinstance(padding, int) else padding
    oh = _spatial_out(input.shape[1], k[0], p[0], s[0])
    ow = _spatial_out(input.shape[2], k[1], p[1], s[1])
    out = b.create_var(shape=(input.shape[0], oh, ow, num_filters),
                       dtype=input.dtype)
    b.append_op("conv2d", {"Input": [input.name], "Filter": [w.name]},
                {"Out": [out.name]},
                {"strides": stride, "paddings": padding, "groups": groups})
    if bias_attr:
        bias = _create_parameter("conv2d_b", (num_filters,), input.dtype, I.zeros)
        out2 = b.create_var(shape=out.shape, dtype=out.dtype)
        b.append_op("elementwise_add", {"X": [out.name], "Y": [bias.name]},
                    {"Out": [out2.name]})
        out = out2
    if act:
        out = activation(out, act)
    return out


def pool2d(input: Variable, pool_size: int = 2, pool_type: str = "max",
           pool_stride=None, pool_padding=0,
           global_pooling: bool = False) -> Variable:
    b = _block()
    if global_pooling:
        out_shape = (input.shape[0], input.shape[-1])
    else:
        k = (pool_size, pool_size) if isinstance(pool_size, int) else pool_size
        st = pool_stride if pool_stride is not None else pool_size
        s = (st, st) if isinstance(st, int) else st
        p = ((pool_padding, pool_padding) if isinstance(pool_padding, int)
             else pool_padding)
        out_shape = (input.shape[0],
                     _spatial_out(input.shape[1], k[0], p[0], s[0]),
                     _spatial_out(input.shape[2], k[1], p[1], s[1]),
                     input.shape[-1])
    out = b.create_var(shape=out_shape, dtype=input.dtype)
    b.append_op("pool2d", {"X": [input.name]}, {"Out": [out.name]},
                {"ksize": pool_size, "pooling_type": pool_type,
                 "strides": pool_stride, "paddings": pool_padding,
                 "global_pooling": global_pooling})
    return out


def accuracy(input: Variable, label: Variable) -> Variable:
    b = _block()
    acc = b.create_var(shape=(), dtype="float32")
    cor = b.create_var(shape=(), dtype="float32")
    tot = b.create_var(shape=(), dtype="float32")
    b.append_op("accuracy", {"Out": [input.name], "Label": [label.name]},
                {"Accuracy": [acc.name], "Correct": [cor.name],
                 "Total": [tot.name]})
    return acc


# =============================================================================
# Control flow (fluid layers.py While:1163, StaticRNN:935; while_op.cc,
# conditional_block_op.cc, recurrent_op.cc) — builders emit sub-blocks the
# executor runs (fluid/executor.py: While and Cond with a host predicate,
# StaticRNN once a time step).
# =============================================================================

import contextlib as _contextlib


def fill_constant(shape, dtype="float32", value=0.0) -> Variable:
    b = _block()
    out = b.create_var(shape=tuple(shape), dtype=dtype)
    b.append_op("fill_constant", {}, {"Out": [out.name]},
                {"shape": tuple(shape), "dtype": dtype, "value": value})
    return out


def increment(x: Variable, value=1, in_place: bool = True) -> Variable:
    b = _block()
    out = x if in_place else b.create_var(shape=x.shape, dtype=x.dtype)
    b.append_op("increment", {"X": [x.name]}, {"Out": [out.name]},
                {"step": value})
    return out


def _compare_layer(op_type, x: Variable, y: Variable,
                   cond: Optional[Variable] = None) -> Variable:
    b = _block()
    out = cond if cond is not None else b.create_var(shape=x.shape, dtype="bool")
    b.append_op(op_type, {"X": [x.name], "Y": [y.name]}, {"Out": [out.name]})
    return out


def less_than(x, y, cond=None):
    return _compare_layer("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _compare_layer("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _compare_layer("greater_than", x, y, cond)


def equal(x, y, cond=None):
    return _compare_layer("equal", x, y, cond)


def logical_and(x, y, cond=None):
    return _compare_layer("logical_and", x, y, cond)


def logical_not(x: Variable, cond=None) -> Variable:
    b = _block()
    out = cond if cond is not None else b.create_var(shape=x.shape, dtype="bool")
    b.append_op("logical_not", {"X": [x.name]}, {"Out": [out.name]})
    return out


def assign(x: Variable, out: Variable) -> Variable:
    b = _block()
    b.append_op("assign", {"X": [x.name]}, {"Out": [out.name]})
    return out


def array_write(x: Variable, i: Variable, array: Optional[Variable] = None,
                capacity: Optional[int] = None) -> Variable:
    """Write x at index i. Without ``array``, allocates a fixed-capacity
    buffer (a CUDA graph needs static sizes; capacity stands in for the
    reference's growable TensorArray, tensor_array_read_write_op.cc)."""
    b = _block()
    inputs = {"X": [x.name], "I": [i.name]}
    attrs = {}
    if array is None:
        if capacity is None:
            raise ValueError("array_write needs `capacity` when creating a new array")
        array = b.create_var(shape=(capacity,) + tuple(x.shape), dtype=x.dtype)
        attrs["capacity"] = capacity
    else:
        inputs["Array"] = [array.name]
    b.append_op("array_write", inputs, {"Out": [array.name]}, attrs)
    return array


def array_read(array: Variable, i: Variable) -> Variable:
    b = _block()
    out = b.create_var(shape=tuple(array.shape[1:]), dtype=array.dtype)
    b.append_op("array_read", {"Array": [array.name], "I": [i.name]},
                {"Out": [out.name]})
    return out


def lod_tensor_to_array(x: Variable) -> Variable:
    """[B, T, ...] -> time-major array for per-step array_read."""
    b = _block()
    shape = (x.shape[1], x.shape[0]) + tuple(x.shape[2:])
    out = b.create_var(shape=shape, dtype=x.dtype)
    b.append_op("lod_tensor_to_array", {"X": [x.name]}, {"Out": [out.name]})
    return out


def array_to_lod_tensor(arr: Variable) -> Variable:
    b = _block()
    shape = (arr.shape[1], arr.shape[0]) + tuple(arr.shape[2:])
    out = b.create_var(shape=shape, dtype=arr.dtype)
    b.append_op("array_to_lod_tensor", {"X": [arr.name]}, {"Out": [out.name]})
    return out


class While:
    """``with While(cond).block(): ...`` — body ops re-run until cond is
    false; the body must update cond (e.g. ``less_than(i, n, cond=cond)``).
    Any outer var the body writes is loop state (while_op.cc semantics)."""

    def __init__(self, cond: Variable):
        self.cond = cond
        self.main = default_main_program()

    @_contextlib.contextmanager
    def block(self):
        parent = self.main.current_block()
        sub = self.main.create_block()
        with self.main.block_guard(sub):
            yield
        parent.append_op("while", {"Condition": [self.cond.name]}, {},
                         {"sub_block_idx": sub.idx})


class Cond:
    """Scalar-predicate conditional (conditional_block_op.cc). Vars written
    inside must already exist outside, giving the
    untaken branch a pass-through value::

        c = Cond(pred)
        with c.true_block():  assign(a, out)
        with c.false_block(): assign(b, out)
    """

    def __init__(self, pred: Variable):
        self.pred = pred
        self.main = default_main_program()
        self._op = None

    @_contextlib.contextmanager
    def true_block(self):
        parent = self.main.current_block()
        sub = self.main.create_block()
        with self.main.block_guard(sub):
            yield
        self._op = parent.append_op(
            "conditional_block", {"Condition": [self.pred.name]}, {},
            {"true_block_idx": sub.idx, "false_block_idx": None})

    @_contextlib.contextmanager
    def false_block(self):
        if self._op is None:
            raise ValueError("false_block() requires a prior true_block()")
        sub = self.main.create_block()
        with self.main.block_guard(sub):
            yield
        self._op.attrs["false_block_idx"] = sub.idx
        self.main.version += 1   # attrs edited post-append: invalidate cache


class StaticRNN:
    """Step-network builder run once a time step inside the block's graph
    (fluid StaticRNN / recurrent_op.cc; RecurrentGradientMachine's
    per-step frames)::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)            # x: [B, T, D]
            h_prev = rnn.memory(init=h0)       # or shape=(H,), value=0
            h = layers.fc(x_t, H, act='tanh')  # any ops
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out, = rnn()                           # [B, T, H]
    """

    def __init__(self):
        self.main = default_main_program()
        self._sub = None
        self._outer_inputs: List[str] = []
        self._step_in_names: List[str] = []
        self._boot_mems: List[str] = []
        self._mem_names: List[str] = []
        self._mem_updates: List[str] = []
        self._step_out_names: List[str] = []
        self._outer_outputs: List[Variable] = []
        self._parent = None

    @_contextlib.contextmanager
    def step(self):
        self._parent = self.main.current_block()
        self._sub = self.main.create_block()
        with self.main.block_guard(self._sub):
            yield
        if (len(self._mem_names) != len(self._mem_updates)
                or None in self._mem_updates):
            raise ValueError("every memory() needs an update_memory()")
        a = {"sub_block_idx": self._sub.idx,
             "outer_inputs": list(self._outer_inputs),
             "step_in_names": list(self._step_in_names),
             "boot_mems": list(self._boot_mems),
             "mem_names": list(self._mem_names),
             "mem_update_names": list(self._mem_updates),
             "step_out_names": list(self._step_out_names),
             "outer_outputs": [v.name for v in self._outer_outputs],
             "last_mem_outputs": []}
        self._parent.append_op(
            "static_rnn", {"X": list(self._outer_inputs)},
            {"Out": [v.name for v in self._outer_outputs]}, a)
        self._attrs = a

    def step_input(self, x: Variable) -> Variable:
        """Slice [B, T, ...] per step -> [B, ...] inside the step block."""
        v = self._sub.create_var(shape=(x.shape[0],) + tuple(x.shape[2:]),
                                 dtype=x.dtype)
        self._outer_inputs.append(x.name)
        self._step_in_names.append(v.name)
        return v

    def memory(self, init: Optional[Variable] = None,
               shape=None, value: float = 0.0,
               batch_ref: Optional[Variable] = None) -> Variable:
        """Recurrent state booted from ``init`` (an outer var — the
        bootLayer of MemoryFrameLine, RecurrentGradientMachine.h:329) or
        zeros/[value] of ``shape`` broadcast over the batch of ``batch_ref``."""
        if init is None:
            if shape is None or batch_ref is None:
                raise ValueError("memory() needs init= or (shape= and batch_ref=)")
            # the boot op runs in the parent block, so a step-input reference
            # must resolve to its outer [B, T, ...] source (same batch dim 0)
            ref_name = batch_ref.name
            if ref_name in self._step_in_names:
                ref_name = self._outer_inputs[self._step_in_names.index(ref_name)]
            b = self._parent   # boot op lives in the parent block
            boot = b.create_var(shape=(batch_ref.shape[0],) + tuple(shape),
                                dtype=batch_ref.dtype)
            b.append_op("fill_constant_batch_size_like",
                        {"Input": [ref_name]}, {"Out": [boot.name]},
                        {"shape": (1,) + tuple(shape), "value": value,
                         "dtype": batch_ref.dtype})
            init = boot
        v = self._sub.create_var(shape=tuple(init.shape), dtype=init.dtype)
        self._boot_mems.append(init.name)
        self._mem_names.append(v.name)
        return v

    def update_memory(self, mem: Variable, new_val: Variable):
        idx = self._mem_names.index(mem.name)
        while len(self._mem_updates) <= idx:
            self._mem_updates.append(None)
        self._mem_updates[idx] = new_val.name

    def step_output(self, out: Variable):
        self._step_out_names.append(out.name)
        v = self._parent.create_var(
            shape=(out.shape[0], -1) + tuple(out.shape[1:]), dtype=out.dtype)
        self._outer_outputs.append(v)

    def get_last_mem(self, mem: Variable) -> Variable:
        """Final memory value after the scan (sequence_last analogue)."""
        idx = self._mem_names.index(mem.name)
        v = self._parent.create_var(shape=tuple(mem.shape), dtype=mem.dtype)
        while len(self._attrs["last_mem_outputs"]) <= idx:
            self._attrs["last_mem_outputs"].append(None)
        self._attrs["last_mem_outputs"][idx] = v.name
        self.main.version += 1
        return v

    def __call__(self) -> List[Variable]:
        return list(self._outer_outputs)


# =============================================================================
# Layer builders — fluid/layers.py parity (batch_norm:765, dynamic_lstm:131,
# conv2d:638, sequence ops, losses, metrics).
# =============================================================================

def batch_norm(input: Variable, act: Optional[str] = None,
               momentum: float = 0.9, epsilon: float = 1e-5,
               is_test: bool = False) -> Variable:
    """Training-capable batch norm: scale/bias are parameters; running
    mean/variance are persistable stats the op updates in-place each step
    (batch_norm_op.cc; fixes round-1's inference-only registration)."""
    main = default_main_program()
    b = _block()
    C = input.shape[-1]
    scale = _create_parameter("bn_scale", (C,), input.dtype, I.constant(1.0))
    bias = _create_parameter("bn_bias", (C,), input.dtype, I.zeros)
    # running stats are state, not weights: trainable=False keeps them out of
    # all_parameters() so optimizers/regularizers never touch them
    mean = _create_parameter("bn_mean", (C,), input.dtype, I.zeros,
                             trainable=False)
    var = _create_parameter("bn_var", (C,), input.dtype, I.constant(1.0),
                            trainable=False)
    out = b.create_var(shape=input.shape, dtype=input.dtype)
    b.append_op("batch_norm",
                {"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
                 "Mean": [mean.name], "Variance": [var.name]},
                {"Y": [out.name], "MeanOut": [mean.name],
                 "VarianceOut": [var.name]},
                {"momentum": momentum, "epsilon": epsilon, "is_test": is_test})
    if act:
        out = activation(out, act)
    return out


def dynamic_lstm(input: Variable, lengths: Optional[Variable], size: int,
                 reverse: bool = False) -> Variable:
    """Whole-sequence LSTM as one op (dynamic_lstm analog; the scan is inside
    the 'lstm' registry op). input [B, T, D] -> [B, T, size]."""
    b = _block()
    D = input.shape[-1]
    w = _create_parameter("lstm_w", (D, 4 * size), input.dtype)
    u = _create_parameter("lstm_u", (size, 4 * size), input.dtype)
    bias = _create_parameter("lstm_b", (4 * size,), input.dtype, I.zeros)
    out = b.create_var(shape=input.shape[:-1] + (size,), dtype=input.dtype)
    h = b.create_var(shape=(input.shape[0], size), dtype=input.dtype)
    c = b.create_var(shape=(input.shape[0], size), dtype=input.dtype)
    inputs = {"X": [input.name], "W": [w.name], "U": [u.name], "B": [bias.name]}
    if lengths is not None:
        inputs["Lengths"] = [lengths.name]
    b.append_op("lstm", inputs,
                {"Out": [out.name], "LastH": [h.name], "LastC": [c.name]},
                {"reverse": reverse})
    return out


def dynamic_gru(input: Variable, lengths: Optional[Variable], size: int,
                reverse: bool = False) -> Variable:
    b = _block()
    D = input.shape[-1]
    w = _create_parameter("gru_w", (D, 3 * size), input.dtype)
    u = _create_parameter("gru_u", (size, 3 * size), input.dtype)
    bias = _create_parameter("gru_b", (3 * size,), input.dtype, I.zeros)
    out = b.create_var(shape=input.shape[:-1] + (size,), dtype=input.dtype)
    h = b.create_var(shape=(input.shape[0], size), dtype=input.dtype)
    inputs = {"X": [input.name], "W": [w.name], "U": [u.name], "B": [bias.name]}
    if lengths is not None:
        inputs["Lengths"] = [lengths.name]
    b.append_op("gru", inputs, {"Out": [out.name], "LastH": [h.name]},
                {"reverse": reverse})
    return out


def sequence_pool(input: Variable, lengths: Variable,
                  pool_type: str = "average") -> Variable:
    b = _block()
    out = b.create_var(shape=(input.shape[0],) + tuple(input.shape[2:]),
                       dtype=input.dtype)
    b.append_op("sequence_pool",
                {"X": [input.name], "Lengths": [lengths.name]},
                {"Out": [out.name]}, {"pool_type": pool_type})
    return out


def sequence_last_step(input: Variable, lengths: Variable) -> Variable:
    b = _block()
    out = b.create_var(shape=(input.shape[0],) + tuple(input.shape[2:]),
                       dtype=input.dtype)
    b.append_op("sequence_last_step",
                {"X": [input.name], "Lengths": [lengths.name]},
                {"Out": [out.name]})
    return out


def sequence_expand(x: Variable, ref_lengths: Variable, max_len: int) -> Variable:
    b = _block()
    out = b.create_var(shape=(x.shape[0], max_len) + tuple(x.shape[1:]),
                       dtype=x.dtype)
    b.append_op("sequence_expand",
                {"X": [x.name], "RefLengths": [ref_lengths.name]},
                {"Out": [out.name]}, {"max_len": max_len})
    return out


def sequence_softmax(x: Variable, lengths: Variable) -> Variable:
    b = _block()
    out = b.create_var(shape=x.shape, dtype=x.dtype)
    b.append_op("sequence_softmax",
                {"X": [x.name], "Lengths": [lengths.name]},
                {"Out": [out.name]})
    return out


def sequence_conv(input: Variable, lengths: Variable, num_filters: int,
                  filter_size: int = 3, act: Optional[str] = None) -> Variable:
    b = _block()
    D = input.shape[-1]
    filt = _create_parameter("seqconv_w", (filter_size * D, num_filters),
                             input.dtype)
    out = b.create_var(shape=input.shape[:-1] + (num_filters,),
                       dtype=input.dtype)
    b.append_op("sequence_conv",
                {"X": [input.name], "Lengths": [lengths.name],
                 "Filter": [filt.name]},
                {"Out": [out.name]},
                {"context_start": -(filter_size // 2),
                 "context_length": filter_size})
    if act:
        out = activation(out, act)
    return out


def linear_chain_crf(emission: Variable, label: Variable,
                     lengths: Variable) -> tuple:
    """Returns (nll_per_seq, transition_param). Transition packs
    [start; end; pairwise] rows like LinearChainCRF.cpp."""
    b = _block()
    N = emission.shape[-1]
    trans = _create_parameter("crf_transition", (N + 2, N), emission.dtype,
                              I.normal(0.0, 0.1))
    ll = b.create_var(shape=(emission.shape[0],), dtype=emission.dtype)
    b.append_op("linear_chain_crf",
                {"Emission": [emission.name], "Label": [label.name],
                 "Lengths": [lengths.name], "Transition": [trans.name]},
                {"LogLikelihood": [ll.name]})
    return ll, trans


def crf_decoding(emission: Variable, lengths: Variable,
                 transition: Variable) -> Variable:
    b = _block()
    path = b.create_var(shape=emission.shape[:-1], dtype="int32")
    score = b.create_var(shape=(emission.shape[0],), dtype=emission.dtype)
    b.append_op("crf_decoding",
                {"Emission": [emission.name], "Lengths": [lengths.name],
                 "Transition": [transition.name]},
                {"ViterbiPath": [path.name], "Score": [score.name]})
    return path


def conv2d_transpose(input: Variable, num_filters: int, filter_size: int,
                     stride=1, padding=0) -> Variable:
    b = _block()
    cin = input.shape[-1]
    k = (filter_size, filter_size) if isinstance(filter_size, int) else filter_size
    w = _create_parameter("deconv_w", k + (cin, num_filters), input.dtype,
                          I.msra())
    s = (stride, stride) if isinstance(stride, int) else stride
    p = (padding, padding) if isinstance(padding, int) else padding
    # inverse of _spatial_out: (in-1)*stride - 2*pad + kernel
    oh = ((input.shape[1] - 1) * s[0] - 2 * p[0] + k[0]
          if input.shape[1] > 0 else -1)
    ow = ((input.shape[2] - 1) * s[1] - 2 * p[1] + k[1]
          if input.shape[2] > 0 else -1)
    out = b.create_var(shape=(input.shape[0], oh, ow, num_filters),
                       dtype=input.dtype)
    b.append_op("conv2d_transpose",
                {"Input": [input.name], "Filter": [w.name]},
                {"Out": [out.name]},
                {"strides": stride, "paddings": padding})
    return out


def lrn(input: Variable, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        k: float = 1.0) -> Variable:
    b = _block()
    out = b.create_var(shape=input.shape, dtype=input.dtype)
    b.append_op("lrn", {"X": [input.name]}, {"Out": [out.name]},
                {"n": n, "alpha": alpha, "beta": beta, "k": k})
    return out


def topk(input: Variable, k: int) -> tuple:
    b = _block()
    vals = b.create_var(shape=input.shape[:-1] + (k,), dtype=input.dtype)
    idx = b.create_var(shape=input.shape[:-1] + (k,), dtype="int32")
    b.append_op("top_k", {"X": [input.name]},
                {"Out": [vals.name], "Indices": [idx.name]}, {"k": k})
    return vals, idx


def cast(x: Variable, dtype: str) -> Variable:
    b = _block()
    out = b.create_var(shape=x.shape, dtype=dtype)
    b.append_op("cast", {"X": [x.name]}, {"Out": [out.name]}, {"dtype": dtype})
    return out


def _reduced_shape(shape, dim, keep_dim):
    if dim is None:
        return (1,) * len(shape) if keep_dim else ()
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    dims = tuple(d % len(shape) for d in dims)
    if keep_dim:
        return tuple(1 if i in dims else s for i, s in enumerate(shape))
    return tuple(s for i, s in enumerate(shape) if i not in dims)


def reduce_sum(x: Variable, dim=None, keep_dim: bool = False) -> Variable:
    b = _block()
    out = b.create_var(shape=_reduced_shape(x.shape, dim, keep_dim),
                       dtype=x.dtype)
    b.append_op("reduce_sum", {"X": [x.name]}, {"Out": [out.name]},
                {"dim": dim, "keep_dim": keep_dim})
    return out


def auc(input: Variable, label: Variable, num_thresholds: int = 200) -> Variable:
    b = _block()
    out = b.create_var(shape=(), dtype="float32")
    ph = b.create_var(shape=(num_thresholds,), dtype="float32")
    nh = b.create_var(shape=(num_thresholds,), dtype="float32")
    b.append_op("auc", {"Out": [input.name], "Label": [label.name]},
                {"AUC": [out.name], "PosHist": [ph.name], "NegHist": [nh.name]},
                {"num_thresholds": num_thresholds})
    return out


def chunk_eval(inference: Variable, label: Variable, lengths: Variable,
               chunk_scheme: str = "IOB", num_chunk_types: int = 1) -> tuple:
    b = _block()
    c = b.create_var(shape=(), dtype="float32")
    p = b.create_var(shape=(), dtype="float32")
    l = b.create_var(shape=(), dtype="float32")
    b.append_op("chunk_eval",
                {"Inference": [inference.name], "Label": [label.name],
                 "Lengths": [lengths.name]},
                {"Correct": [c.name], "Predicted": [p.name], "Labeled": [l.name]},
                {"chunk_scheme": chunk_scheme,
                 "num_chunk_types": num_chunk_types})
    return c, p, l


def squeeze(x: Variable, axis: int) -> Variable:
    b = _block()
    shape = tuple(s for i, s in enumerate(x.shape) if i != axis % len(x.shape))
    out = b.create_var(shape=shape, dtype=x.dtype)
    b.append_op("squeeze", {"X": [x.name]}, {"Out": [out.name]},
                {"axis": axis})
    return out


def unsqueeze(x: Variable, axis: int) -> Variable:
    b = _block()
    shape = list(x.shape)
    shape.insert(axis % (len(x.shape) + 1), 1)
    out = b.create_var(shape=tuple(shape), dtype=x.dtype)
    b.append_op("unsqueeze", {"X": [x.name]}, {"Out": [out.name]},
                {"axis": axis})
    return out
