"""v2 layer DSL emitting fluid ops — the port's copy of
``paddle_tpu/v2/layer.py``: the same layers emit the same ops into the
port's fluid programs (``paddle_tpu_torch/fluid``).

Mirrors the surface of python/paddle/v2/layer.py + trainer_config_helpers/
layers.py (fc, embedding, lstmemory, conv, pooling, costs), but each call
appends to the fluid default programs. Sequence-typed layers carry a paired
``<name>__len__`` lengths variable (the LoD metadata under the static-shape
regime — core/lod.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..fluid import layers as FL
from ..fluid.framework import Variable, default_main_program
from ..nn import initializer as I
from .data_type import InputType


@dataclass
class LayerOutput:
    var: Variable
    lengths: Optional[Variable] = None      # set for sequence outputs
    input_type: Optional[InputType] = None
    sub_lengths: Optional[Variable] = None  # set for nested (2-level LoD) data
    values: Optional[Variable] = None       # set for sparse (ids, vals) data
    #: secondary outputs by arg_name (the reference's multi-output layers,
    #: e.g. lstm_step's 'state') — fetched via get_output_layer()
    outputs: Optional[dict] = None

    @property
    def name(self):
        return self.var.name


def data(name: str, type: InputType) -> LayerOutput:
    """paddle.v2.layer.data analog; sequence types get a lengths feed var,
    nested (sub-sequence) types additionally a [S] sub-lengths feed var."""
    if type.is_seq:
        elem = getattr(type.slot, "elem_dim", None)
        nested = getattr(type.slot, "nested", False)
        if nested:
            shape = (-1, -1) if elem is None else (-1, -1, elem)
            dtype = "int32" if elem is None else "float32"
            v = FL.data(name, shape=shape, dtype=dtype)        # [B, S, T(, D)]
            sublens = FL.data(name + "__sublen__", shape=(-1,), dtype="int32")
            lens = FL.data(name + "__len__", shape=(), dtype="int32")
            return LayerOutput(v, lens, type, sub_lengths=sublens)
        if elem is None:
            v = FL.data(name, shape=(-1,), dtype="int32")
        else:
            v = FL.data(name, shape=(-1, elem), dtype="float32")
        lens = FL.data(name + "__len__", shape=(), dtype="int32")
        return LayerOutput(v, lens, type)
    from ..data.feeder import DenseSlot, IndexSlot, SparseSlot
    if isinstance(type.slot, DenseSlot):
        v = FL.data(name, shape=(type.slot.dim,))
    elif isinstance(type.slot, IndexSlot):
        v = FL.data(name, shape=(), dtype="int32")
    else:  # sparse: padded COO pair (ids [B,K], vals [B,K]); vals carry the
        # padding mask (0 where padded) — consumed by embedding()/fc()
        v = FL.data(name, shape=(-1,), dtype="int32")
        vals = FL.data(name + "__vals__", shape=(-1,), dtype="float32")
        return LayerOutput(v, None, type, values=vals)
    return LayerOutput(v, None, type)


def _sparse_weighted_sum(ids_var, vals_var, table, size):
    """sum_k vals[b,k] * table[ids[b,k]] -> [B, size]: the padded-COO
    SelectedRows path (sparse_binary/float_vector inputs to fc/embedding;
    math/SparseRowMatrix + getParameterSparse analog — only touched rows
    enter the matmul)."""
    b = default_main_program().current_block()
    looked = b.create_var(shape=(-1, -1, size), dtype="float32")
    b.append_op("lookup_table", {"W": [table.name], "Ids": [ids_var.name]},
                {"Out": [looked.name]}, {})
    vals3 = b.create_var(shape=(-1, -1, 1), dtype="float32")
    b.append_op("unsqueeze", {"X": [vals_var.name]}, {"Out": [vals3.name]},
                {"axis": -1})
    weighted = b.create_var(shape=(-1, -1, size), dtype="float32")
    b.append_op("elementwise_mul", {"X": [looked.name], "Y": [vals3.name]},
                {"Out": [weighted.name]}, {})
    out = b.create_var(shape=(-1, size), dtype="float32")
    b.append_op("reduce_sum", {"X": [weighted.name]}, {"Out": [out.name]},
                {"dim": 1})
    return out


def _attr_dict(a):
    """ParamAttr -> fluid attr dict (None/bool pass through as None)."""
    if a is None or isinstance(a, bool):
        return None
    return a.to_fluid() if hasattr(a, "to_fluid") else dict(a)


def fc(input, size: int, act: Optional[str] = None,
       bias_attr: bool = True, name: Optional[str] = None,
       param_attr=None, layer_attr=None) -> LayerOutput:
    """Accepts a single layer or a list (concatenated, like the reference's
    multi-input fc). Sparse inputs (sparse_binary/float_vector data layers)
    take the weighted-row-sum path — the reference's sparse fc
    (quick_start LR config). ``name`` registers the output for memory()
    binding inside a recurrent_group/beam_search step. ``param_attr`` is a
    :class:`paddle.attr.ParamAttr` (name-based sharing, init, is_static,
    per-param lr/l2); ``bias_attr`` may be bool or a ParamAttr;
    ``layer_attr`` an ExtraAttr whose drop_rate appends dropout."""
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    sparse = [i for i in inputs if i.values is not None]
    dense = [i for i in inputs if i.values is None]
    # a NAMED ParamAttr names ONE weight matrix; with several weight-bearing
    # parts (each sparse table + the dense block) a single name would force
    # accidental sharing/shape clashes, so require one part (the reference
    # takes a per-input attr list; pass attrs per separate fc there)
    n_parts = len(sparse) + (1 if dense else 0)
    if (n_parts > 1 and param_attr is not None
            and not isinstance(param_attr, bool)
            and _attr_dict(param_attr) and "name" in _attr_dict(param_attr)):
        raise ValueError(
            "fc with multiple weight-bearing inputs cannot take a single "
            "named param_attr (it would share one matrix across parts with "
            "different shapes); build per-input fc/mixed projections instead")
    parts = []
    for s in sparse:
        dim = s.input_type.slot.dim
        table = FL._create_parameter("sparse_fc_w", (dim, size), "float32",
                                     I.xavier(), attr=_attr_dict(param_attr))
        parts.append(_sparse_weighted_sum(s.var, s.values, table, size))
    if dense:
        var = (FL.concat([i.var for i in dense], axis=-1)
               if len(dense) > 1 else dense[0].var)
        parts.append(FL.fc(var, size, act=None, bias_attr=False,
                           param_attr=_attr_dict(param_attr)))
    b = default_main_program().current_block()
    acc = parts[0]
    if len(parts) > 1:
        summed = b.create_var(shape=(-1, size), dtype="float32")
        b.append_op("sum", {"X": [p.name for p in parts]},
                    {"Out": [summed.name]}, {})
        acc = summed
    if bias_attr:
        bias = FL._create_parameter("fc_b", (size,), "float32", I.zeros,
                                    attr=_attr_dict(bias_attr))
        acc = FL.elementwise_add(acc, bias)
    if act:
        acc = FL.activation(acc, act)
    if layer_attr is not None and getattr(layer_attr, "drop_rate", None):
        acc = FL.dropout(acc, layer_attr.drop_rate)
    _register_named(name, acc)
    return LayerOutput(acc)


def embedding(input: LayerOutput, size: int, param_attr=None) -> LayerOutput:
    t = input.input_type
    if input.values is not None:
        # sparse input -> weighted-sum embedding [B, size] (bag-of-features)
        dim = t.slot.dim
        table = FL._create_parameter("embedding_w", (dim, size), "float32",
                                     I.normal(0.0, 0.01),
                                     attr=_attr_dict(param_attr))
        out = _sparse_weighted_sum(input.var, input.values, table, size)
        return LayerOutput(out)
    if t is None or not t.vocab:
        raise ValueError("embedding needs a data layer typed "
                         "integer_value[_sequence](vocab_size) or a sparse "
                         "vector type")
    out = FL.embedding(input.var, (t.vocab, size),
                       param_attr=_attr_dict(param_attr))
    return LayerOutput(out, input.lengths, input.input_type,
                       sub_lengths=input.sub_lengths)


def _seq_op(op_type, input: LayerOutput, extra_attrs=None, out_shape=None,
            seq_out=False, params=None) -> LayerOutput:
    # current (not global) block: seq layers compose inside rg/nested steps
    b = default_main_program().current_block()
    out = b.create_var(shape=out_shape or input.var.shape,
                       dtype="float32")
    inputs = {"X": [input.var.name], "Lengths": [input.lengths.name]}
    if params:
        inputs.update(params)
    b.append_op(op_type, inputs, {"Out": [out.name]}, extra_attrs or {})
    return LayerOutput(out, input.lengths if seq_out else None,
                       input.input_type if seq_out else None)


def lstmemory(input: LayerOutput, size: int, reverse: bool = False,
              forget_bias: float = 1.0) -> LayerOutput:
    """Whole-sequence masked LSTM (simple_lstm/lstmemory analog)."""
    b = default_main_program().current_block()
    in_dim = input.var.shape[-1]
    w = FL._create_parameter("lstm_w", (in_dim, 4 * size), "float32",
                             I.uniform(-0.08, 0.08))
    u = FL._create_parameter("lstm_u", (size, 4 * size), "float32",
                             I.uniform(-0.08, 0.08))
    bias = FL._create_parameter("lstm_b", (4 * size,), "float32", I.zeros)
    out = b.create_var(shape=input.var.shape[:-1] + (size,), dtype="float32")
    last_h = b.create_var(shape=(-1, size), dtype="float32")
    last_c = b.create_var(shape=(-1, size), dtype="float32")
    b.append_op("lstm",
                {"X": [input.var.name], "Lengths": [input.lengths.name],
                 "W": [w.name], "U": [u.name], "B": [bias.name]},
                {"Out": [out.name], "LastH": [last_h.name],
                 "LastC": [last_c.name]},
                {"reverse": reverse, "forget_bias": forget_bias})
    return LayerOutput(out, input.lengths, input.input_type)


def grumemory(input: LayerOutput, size: int, reverse: bool = False) -> LayerOutput:
    b = default_main_program().current_block()
    in_dim = input.var.shape[-1]
    w = FL._create_parameter("gru_w", (in_dim, 3 * size), "float32",
                             I.uniform(-0.08, 0.08))
    u = FL._create_parameter("gru_u", (size, 3 * size), "float32",
                             I.uniform(-0.08, 0.08))
    bias = FL._create_parameter("gru_b", (3 * size,), "float32", I.zeros)
    out = b.create_var(shape=input.var.shape[:-1] + (size,), dtype="float32")
    last = b.create_var(shape=(-1, size), dtype="float32")
    b.append_op("gru",
                {"X": [input.var.name], "Lengths": [input.lengths.name],
                 "W": [w.name], "U": [u.name], "B": [bias.name]},
                {"Out": [out.name], "LastH": [last.name]},
                {"reverse": reverse})
    return LayerOutput(out, input.lengths, input.input_type)


def pooling(input: LayerOutput, pooling_type: str = "max") -> LayerOutput:
    """Sequence pooling (SequencePoolLayer): max|average|sum."""
    return _seq_op("sequence_pool", input,
                   {"pool_type": pooling_type},
                   out_shape=(-1, input.var.shape[-1]))


def last_seq(input: LayerOutput) -> LayerOutput:
    return _seq_op("sequence_last_step", input,
                   out_shape=(-1, input.var.shape[-1]))


def first_seq(input: LayerOutput) -> LayerOutput:
    return _seq_op("sequence_first_step", input,
                   out_shape=(-1, input.var.shape[-1]))


def concat(inputs: List[LayerOutput], axis: int = -1) -> LayerOutput:
    return LayerOutput(FL.concat([i.var for i in inputs], axis=axis))


def dropout(input: LayerOutput, dropout_rate: float) -> LayerOutput:
    return LayerOutput(FL.dropout(input.var, dropout_rate, is_test=False),
                       input.lengths, input.input_type)


def img_conv(input: LayerOutput, num_filters: int, filter_size: int,
             stride: int = 1, padding: int = 0,
             act: Optional[str] = "relu") -> LayerOutput:
    return LayerOutput(FL.conv2d(input.var, num_filters, filter_size,
                                 stride=stride, padding=padding, act=act))


def img_pool(input: LayerOutput, pool_size: int = 2, pool_type: str = "max",
             stride: Optional[int] = None) -> LayerOutput:
    return LayerOutput(FL.pool2d(input.var, pool_size, pool_type,
                                 pool_stride=stride))


# ------------------------------------------------------------------- costs ---

def classification_cost(input: LayerOutput, label: LayerOutput) -> LayerOutput:
    loss = FL.softmax_with_cross_entropy(input.var, label.var)
    return LayerOutput(FL.mean(loss))


def cross_entropy_cost(input: LayerOutput, label: LayerOutput) -> LayerOutput:
    return LayerOutput(FL.mean(FL.cross_entropy(input.var, label.var)))


def square_error_cost(input: LayerOutput, label: LayerOutput) -> LayerOutput:
    d = FL.elementwise_sub(input.var, label.var)
    return LayerOutput(FL.mean(FL.elementwise_mul(d, d)))


# =============================================================================
# recurrent_group / memory / StaticInput / beam generation
# (trainer_config_helpers/layers.py:3939 recurrent_group, :3909 StaticInput,
# memory; RecurrentGradientMachine.cpp:964 generateSequence, :1020 beamSearch).
# Lowering: recurrent_group -> the fluid StaticRNN op (its step block run
# once a time step); generation -> the on-device masked-top-k beam decode
# (ops/beam_search.py) with the user's step net as the per-step function.
# =============================================================================

import contextlib as _ctxlib

from .. import fluid as _fluid


class StaticInput:
    """Non-scanned input visible unchanged at every step (layers.py:3909).
    In generation it is tiled across beams together with the memories."""

    def __init__(self, input: LayerOutput):
        self.layer = input


class BaseGeneratedInput:
    """Base of the generation feedback inputs (layers.py:4061
    BaseGeneratedInput): carries the bos/eos bookkeeping that beam_search
    fills in; subclasses define how the previous step's emission is fed
    back into the next step."""

    def __init__(self):
        self.bos_id = None
        self.eos_id = None


class GeneratedInput(BaseGeneratedInput):
    """The generation feedback input: at step t the decoder receives the
    embedding of the token emitted at t-1 (GeneratedInput in the reference's
    beam-gen DSL). ``embedding_param`` shares a training-time embedding
    table; otherwise a fresh [vocab, embedding_size] table is created."""

    def __init__(self, size: int, embedding_size: int, embedding_param=None):
        super().__init__()
        self.vocab_size = size
        self.embedding_size = embedding_size
        self.embedding_param = embedding_param


class _RGContext:
    def __init__(self, kind, rnn=None, sub=None):
        self.kind = kind               # "rg" | "beam"
        self.rnn = rnn
        self.sub = sub
        self.batch_ref = None          # a step-input var for zero boots
        self.memories = []             # (name, mem Variable, boot_name|None)
        self.named_outputs = {}        # name -> Variable


_rg_stack: List[_RGContext] = []


def _active_rg() -> Optional[_RGContext]:
    return _rg_stack[-1] if _rg_stack else None


@_ctxlib.contextmanager
def _push_rg(ctx: _RGContext):
    _rg_stack.append(ctx)
    try:
        yield ctx
    finally:
        _rg_stack.pop()


def _register_named(name: Optional[str], var: Variable):
    ctx = _active_rg()
    if ctx is not None and name:
        ctx.named_outputs[name] = var


def memory(name: str, size: int,
           boot_layer: Optional[LayerOutput] = None) -> LayerOutput:
    """Previous-step value of the step-net output called ``name``
    (layers.py memory semantics: the layer with the matching name updates
    this memory). Booted from ``boot_layer`` (an outer-graph layer — the
    MemoryFrameLine bootLayer, RecurrentGradientMachine.h:329) or zeros."""
    ctx = _active_rg()
    if ctx is None:
        raise ValueError("memory() is only valid inside a recurrent_group "
                         "or beam_search step function")
    if ctx.kind == "rg":
        if boot_layer is not None:
            mem = ctx.rnn.memory(init=boot_layer.var)
        else:
            mem = ctx.rnn.memory(shape=(size,), value=0.0,
                                 batch_ref=ctx.batch_ref)
        ctx.memories.append((name, mem, None))
        return LayerOutput(mem)
    # beam: inner var fed from the (beam-tiled) cell each step
    if boot_layer is None:
        raise ValueError("generation memories need boot_layer= (decoder "
                         "state boots from the encoder)")
    v = ctx.sub.create_var(shape=(-1, size), dtype="float32")
    ctx.memories.append((name, v, boot_layer.var.name))
    return LayerOutput(v)


def identity(input: LayerOutput, name: Optional[str] = None) -> LayerOutput:
    """Name a step-net output so a memory() can bind to it (the reference
    binds by layer name; our layers auto-name, so this is the explicit
    binding point)."""
    _register_named(name, input.var)
    return input


def recurrent_group(step, input, reverse: bool = False):
    """User-composed step network scanned over a sequence — the signature
    capability of RecurrentGradientMachine, run as ONE StaticRNN op.

    ``input``: a sequence LayerOutput, or a list mixing sequence layers and
    StaticInput wrappers. ``step(*step_args)`` builds the per-step net with
    v2 layers; memories declared via ``memory(name=...)`` update from the
    step output registered under the same name (fc(..., name=...) or
    identity(..., name=...)).
    """
    inputs = list(input) if isinstance(input, (list, tuple)) else [input]
    seq_inputs = [i for i in inputs if isinstance(i, LayerOutput)]
    if not seq_inputs:
        raise ValueError("recurrent_group needs at least one sequence input")
    lengths = next((i.lengths for i in seq_inputs if i.lengths is not None),
                   None)
    if reverse:
        if any(i.lengths is None for i in seq_inputs):
            raise ValueError(
                "recurrent_group(reverse=True) needs sequence inputs with "
                "lengths (sequence_reverse is length-aware); wrap plain "
                "tensors in a LayerOutput carrying the lengths var")
        inputs = [_seq_op("sequence_reverse", i, seq_out=True)
                  if isinstance(i, LayerOutput) else i for i in inputs]

    rnn = _fluid.StaticRNN()
    ctx = _RGContext("rg", rnn=rnn)
    with rnn.step(), _push_rg(ctx):
        args = []
        for i in inputs:
            if isinstance(i, StaticInput):
                args.append(i.layer)          # outer var, closed over
            else:
                x_t = rnn.step_input(i.var)
                if ctx.batch_ref is None:
                    ctx.batch_ref = x_t
                args.append(LayerOutput(x_t))
        outs = step(*args)
        outs = [outs] if isinstance(outs, LayerOutput) else list(outs)
        for name, mem, _ in ctx.memories:
            if name not in ctx.named_outputs:
                raise ValueError(
                    f"memory '{name}' has no matching named step output; "
                    f"name one with fc(..., name='{name}') or identity()")
            rnn.update_memory(mem, LayerOutput(ctx.named_outputs[name]).var)
        for o in outs:
            rnn.step_output(o.var)
    result = rnn()
    wrapped = []
    for v in result:
        lo = LayerOutput(v, lengths)
        if reverse:
            lo = _seq_op("sequence_reverse", lo, seq_out=True)
        wrapped.append(lo)
    return wrapped[0] if len(wrapped) == 1 else wrapped


def beam_search(step, input, bos_id: int, eos_id: int, beam_size: int = 5,
                max_length: int = 20, length_penalty: float = 0.0,
                constraint: Optional[str] = None):
    """Beam-search generation over a user step net (layers.py beam_search /
    generateSequence:964). Returns (tokens, scores) LayerOutputs with shapes
    [B, beam, max_length] / [B, beam], best-first.

    ``input``: one GeneratedInput (prev-token embedding feedback) plus any
    StaticInputs (encoder outputs etc. — tiled across beams). Memories boot
    from outer layers via memory(..., boot_layer=...). The step must return
    per-class *probabilities* [_, vocab] (softmax output, like the
    reference's generating sub-model).

    ``constraint`` names a logits-mask hook registered via
    :func:`paddle_tpu.ops.beam_search.register_constraint` — the user-callback
    capability of the reference's BeamSearchControlCallbacks
    (RecurrentGradientMachine.h:106-123) as a token-masking function; the
    name (not the callable) is stored in the Program so it stays
    JSON-serializable.
    """
    main = default_main_program()
    gens = [i for i in input if isinstance(i, GeneratedInput)]
    if len(gens) != 1:
        raise ValueError("beam_search needs exactly one GeneratedInput")
    g = gens[0]
    if g.embedding_param is not None:
        # a fluid Variable shares directly; a ParamAttr/dict shares by name
        # with a training-time table (the train-config/gen-config workflow)
        if hasattr(g.embedding_param, "to_fluid") or isinstance(
                g.embedding_param, dict):
            embed_w = FL._create_parameter(
                "gen_embed_w", (g.vocab_size, g.embedding_size), "float32",
                I.normal(0.0, 0.01), attr=_attr_dict(g.embedding_param))
        else:
            embed_w = g.embedding_param
    else:
        embed_w = FL._create_parameter(
            "gen_embed_w", (g.vocab_size, g.embedding_size), "float32",
            I.normal(0.0, 0.01))

    parent = main.current_block()
    sub = main.create_block()
    ctx = _RGContext("beam", sub=sub)
    static_outer, static_inner = [], []
    with main.block_guard(sub), _push_rg(ctx):
        tok_embed = sub.create_var(shape=(-1, g.embedding_size),
                                   dtype="float32")
        args = []
        for i in input:
            if isinstance(i, GeneratedInput):
                args.append(LayerOutput(tok_embed))
                continue
            lo = i.layer
            inner = sub.create_var(shape=lo.var.shape, dtype=lo.var.dtype)
            static_outer.append(lo.var.name)
            static_inner.append(inner.name)
            inner_len = None
            if lo.lengths is not None:
                inner_len = sub.create_var(shape=lo.lengths.shape,
                                           dtype=lo.lengths.dtype)
                static_outer.append(lo.lengths.name)
                static_inner.append(inner_len.name)
            args.append(LayerOutput(inner, inner_len))
        out = step(*args)
        for name, _, _ in ctx.memories:
            if name not in ctx.named_outputs:
                raise ValueError(f"memory '{name}' has no matching named "
                                 "step output")

    tokens = parent.create_var(shape=(-1, beam_size, max_length),
                               dtype="int32")
    scores = parent.create_var(shape=(-1, beam_size), dtype="float32")
    parent.append_op(
        "beam_search_gen",
        {"Embed": [embed_w.name]},
        {"Tokens": [tokens.name], "Scores": [scores.name]},
        {"sub_block_idx": sub.idx,
         "embed_param": embed_w.name,
         "token_embed_name": tok_embed.name,
         "static_outer": static_outer,
         "static_in_names": static_inner,
         "boot_mems": [boot for _, _, boot in ctx.memories],
         "mem_names": [m.name for _, m, _ in ctx.memories],
         "mem_update_names": [ctx.named_outputs[n].name
                              for n, _, _ in ctx.memories],
         "prob_name": out.var.name,
         "beam_size": beam_size, "max_length": max_length,
         "bos_id": bos_id, "eos_id": eos_id,
         "length_penalty": length_penalty,
         "constraint": constraint or ""})
    return LayerOutput(tokens), LayerOutput(scores)


# ------------------------------------------------ nested (2-level LoD) layers

def _nested_inputs(input: LayerOutput):
    if input.sub_lengths is None:
        raise ValueError("layer requires nested sequence input "
                         "(integer_value_sub_sequence / "
                         "dense_vector_sub_sequence data)")
    return {"X": [input.var.name], "SubLengths": [input.sub_lengths.name],
            "SeqLengths": [input.lengths.name]}


def nested_pooling(input: LayerOutput, pooling_type: str = "average"
                   ) -> LayerOutput:
    """Pool each sub-sequence -> ordinary sequence of sub-seq summaries
    [B, S, D] + outer lengths (SubNestedSequence pooling analog)."""
    b = default_main_program().current_block()
    out = b.create_var(shape=(-1, -1, input.var.shape[-1]), dtype="float32")
    b.append_op("nested_seq_pool", _nested_inputs(input), {"Out": [out.name]},
                {"pool_type": pooling_type})
    return LayerOutput(out, input.lengths)


def nested_last_seq(input: LayerOutput) -> LayerOutput:
    b = default_main_program().current_block()
    out = b.create_var(shape=(-1, -1, input.var.shape[-1]), dtype="float32")
    b.append_op("nested_last_step", _nested_inputs(input), {"Out": [out.name]})
    return LayerOutput(out, input.lengths)


def nested_lstmemory(input: LayerOutput, size: int,
                     reverse: bool = False) -> LayerOutput:
    """Inner LSTM over every sub-sequence (memory resets at boundaries);
    returns the sequence of per-sub-sequence last states [B, S, size] —
    ready for an outer recurrent layer (the nested recurrent_group stack)."""
    b = default_main_program().current_block()
    in_dim = input.var.shape[-1]
    w = FL._create_parameter("nlstm_w", (in_dim, 4 * size), "float32",
                             I.uniform(-0.08, 0.08))
    u = FL._create_parameter("nlstm_u", (size, 4 * size), "float32",
                             I.uniform(-0.08, 0.08))
    bias = FL._create_parameter("nlstm_b", (4 * size,), "float32", I.zeros)
    ins = _nested_inputs(input)
    ins.update({"W": [w.name], "U": [u.name], "B": [bias.name]})
    out = b.create_var(shape=(-1, -1, -1, size), dtype="float32")
    last = b.create_var(shape=(-1, -1, size), dtype="float32")
    b.append_op("nested_lstm", ins,
                {"Out": [out.name], "LastH": [last.name]},
                {"reverse": reverse})
    return LayerOutput(last, input.lengths)


# =============================================================================
# Gen-1 layer-zoo breadth (trainer_config_helpers/layers.py — the 106
# *_layer surface). Each function cites the gserver layer / CostLayer.cpp
# entry it re-provides; all lower onto registered fluid ops.
# =============================================================================

def _emit(op_type, ins, attrs=None, out_shape=None, out_dtype="float32",
          n_out=1, out_slot="Out"):
    """Append one registered op; returns its output Variable(s)."""
    b = default_main_program().current_block()
    outs = [b.create_var(shape=out_shape or (-1,), dtype=out_dtype)
            for _ in range(n_out)]
    b.append_op(op_type, ins, {out_slot: [o.name for o in outs]}, attrs or {})
    return outs[0] if n_out == 1 else outs


def _shape(l: LayerOutput):
    return tuple(l.var.shape)


# ------------------------------------------------------------ mixed / proj ---
# Projections return (emit_fn, out_size); mixed_layer sums their outputs
# (gserver Mixed layer + Projection.h: FullMatrix/Table/Context/DotMul/
# Scaling/Identity/Slice projections, DotMulOperator).

class _Projection:
    def __init__(self, emit, size, src: Optional[LayerOutput] = None):
        self.emit = emit        # () -> Variable with last dim == size
        self.size = size
        self.src = src          # source layer (sequence metadata propagation)


def full_matrix_projection(input: LayerOutput, size: int) -> _Projection:
    """FullMatrixProjection: x W."""
    in_dim = _shape(input)[-1]
    def emit():
        w = FL._create_parameter("proj_w", (in_dim, size), "float32",
                                 I.xavier())
        return _emit("mul", {"X": [input.var.name], "Y": [w.name]},
                     {"x_num_col_dims": len(_shape(input)) - 1},
                     out_shape=_shape(input)[:-1] + (size,))
    return _Projection(emit, size, src=input)


def trans_full_matrix_projection(input: LayerOutput, size: int) -> _Projection:
    """TransposedFullMatrixProjection: x Wᵀ (weight stored [size, in])."""
    in_dim = _shape(input)[-1]
    def emit():
        w = FL._create_parameter("tproj_w", (size, in_dim), "float32",
                                 I.xavier())
        return _emit("matmul", {"X": [input.var.name], "Y": [w.name]},
                     {"transpose_Y": True},
                     out_shape=_shape(input)[:-1] + (size,))
    return _Projection(emit, size, src=input)


def table_projection(input: LayerOutput, size: int) -> _Projection:
    """TableProjection: embedding lookup of integer input."""
    t = input.input_type
    if t is None or not t.vocab:
        raise ValueError("table_projection needs integer_value input")
    def emit():
        w = FL._create_parameter("table_w", (t.vocab, size), "float32",
                                 I.normal(0.0, 0.01))
        return _emit("lookup_table", {"W": [w.name], "Ids": [input.var.name]},
                     out_shape=_shape(input) + (size,))
    return _Projection(emit, size, src=input)


def identity_projection(input: LayerOutput, offset: Optional[int] = None,
                        size: Optional[int] = None) -> _Projection:
    """IdentityProjection / IdentityOffsetProjection (feature slice)."""
    in_dim = _shape(input)[-1]
    if offset is None:
        return _Projection(lambda: input.var, in_dim, src=input)
    end = offset + (size or (in_dim - offset))
    def emit():
        ndim = len(_shape(input))
        starts = [0] * (ndim - 1) + [offset]
        shape = [-1] * (ndim - 1) + [end - offset]   # -1: full batch extent
        return _emit("crop", {"X": [input.var.name]},
                     {"offsets": starts, "shape": shape},
                     out_shape=_shape(input)[:-1] + (end - offset,))
    return _Projection(emit, end - offset, src=input)


def dotmul_projection(input: LayerOutput) -> _Projection:
    """DotMulProjection: per-dimension learned weight, y = w ⊙ x."""
    in_dim = _shape(input)[-1]
    def emit():
        w = FL._create_parameter("dotmul_w", (in_dim,), "float32", I.ones)
        return _emit("elementwise_mul",
                     {"X": [input.var.name], "Y": [w.name]},
                     out_shape=_shape(input))
    return _Projection(emit, in_dim, src=input)


def scaling_projection(input: LayerOutput) -> _Projection:
    """ScalingProjection: one learned scalar, y = w * x."""
    in_dim = _shape(input)[-1]
    def emit():
        w = FL._create_parameter("scaling_w", (), "float32", I.ones)
        return _emit("elementwise_mul",
                     {"X": [input.var.name], "Y": [w.name]},
                     out_shape=_shape(input))
    return _Projection(emit, in_dim, src=input)


def context_projection_layer(input: LayerOutput, context_len: int,
                             context_start: Optional[int] = None) -> _Projection:
    """ContextProjection: concat of shifted frames (sequence input)."""
    in_dim = _shape(input)[-1]
    start = context_start if context_start is not None else -(context_len // 2)
    size = in_dim * context_len
    def emit():
        return _emit("context_projection",
                     {"X": [input.var.name],
                      "Lengths": [input.lengths.name]},
                     {"context_length": context_len, "context_start": start},
                     out_shape=_shape(input)[:-1] + (size,))
    return _Projection(emit, size, src=input)


def dotmul_operator(a: LayerOutput, b: LayerOutput,
                    scale: float = 1.0) -> _Projection:
    """DotMulOperator: scale * (a ⊙ b) — a Mixed-layer binary operator."""
    in_dim = _shape(a)[-1]
    def emit():
        prod = _emit("elementwise_mul", {"X": [a.var.name], "Y": [b.var.name]},
                     out_shape=_shape(a))
        if scale == 1.0:
            return prod
        return _emit("scale", {"X": [prod.name]}, {"scale": scale},
                     out_shape=_shape(a))
    return _Projection(emit, in_dim, src=a)


def mixed_layer(size: Optional[int] = None, input=None,
                act: Optional[str] = None, bias_attr: bool = False,
                name: Optional[str] = None) -> LayerOutput:
    """MixedLayer: sum of projections/operators, + bias, + activation."""
    projs: List[_Projection] = list(input or [])
    if not projs:
        raise ValueError("mixed_layer needs at least one projection")
    size = size or projs[0].size
    for p in projs:
        if p.size != size:
            raise ValueError(f"projection size {p.size} != mixed size {size}")
    outs = [p.emit() for p in projs]
    b = default_main_program().current_block()
    acc = outs[0]
    if len(outs) > 1:
        acc = _emit("sum", {"X": [o.name for o in outs]},
                    out_shape=tuple(outs[0].shape))
    if bias_attr:
        bias = FL._create_parameter("mixed_b", (size,), "float32", I.zeros)
        acc = _emit("elementwise_add", {"X": [acc.name], "Y": [bias.name]},
                    out_shape=tuple(acc.shape))
    if act:
        acc = _emit(act, {"X": [acc.name]}, out_shape=tuple(acc.shape))
    _register_named(name, acc)
    # propagate sequence metadata from the first sequence-typed source so a
    # mixed_layer output feeds seq layers (crf, pooling) without rewrapping
    seq_src = next((p.src for p in projs
                    if p.src is not None and p.src.lengths is not None), None)
    if seq_src is not None:
        return LayerOutput(acc, seq_src.lengths, seq_src.input_type)
    return LayerOutput(acc)


# ----------------------------------------------------------------- misc ------

def addto_layer(input: List[LayerOutput], act: Optional[str] = None,
                bias_attr: bool = False) -> LayerOutput:
    """AddtoLayer: elementwise sum of N inputs (+act)."""
    out = _emit("sum", {"X": [i.var.name for i in input]},
                out_shape=_shape(input[0]))
    if act:
        out = _emit(act, {"X": [out.name]}, out_shape=tuple(out.shape))
    return LayerOutput(out, input[0].lengths, input[0].input_type)


def cos_sim(a: LayerOutput, b: LayerOutput, scale: float = 1.0) -> LayerOutput:
    """CosSimLayer."""
    bkl = default_main_program().current_block()
    out = bkl.create_var(shape=(_shape(a)[0],), dtype="float32")
    bkl.append_op("cos_sim", {"X": [a.var.name], "Y": [b.var.name]},
                  {"Out": [out.name]}, {"scale": scale})
    return LayerOutput(out)


def power_layer(input: LayerOutput) -> LayerOutput:
    """PowerLayer: y = x^w with a learned scalar exponent."""
    w = FL._create_parameter("power_w", (), "float32", I.ones)
    out = _emit("power", {"X": [input.var.name], "W": [w.name]},
                out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


def scaling_layer(input: LayerOutput, weight: LayerOutput) -> LayerOutput:
    """ScalingLayer: rows of ``input`` scaled by per-row ``weight`` [B, 1]."""
    out = _emit("elementwise_mul",
                {"X": [input.var.name], "Y": [weight.var.name]},
                out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


def slope_intercept_layer(input: LayerOutput, slope: float = 1.0,
                          intercept: float = 0.0) -> LayerOutput:
    out = _emit("slope_intercept", {"X": [input.var.name]},
                {"slope": slope, "intercept": intercept},
                out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


def sum_to_one_norm_layer(input: LayerOutput) -> LayerOutput:
    out = _emit("sum_to_one_norm", {"X": [input.var.name]},
                out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


def interpolation_layer(input: List[LayerOutput],
                        weight: LayerOutput) -> LayerOutput:
    """InterpolationLayer: w*a + (1-w)*b with per-row w."""
    a, b = input
    out = _emit("interpolation",
                {"X": [a.var.name], "Y": [b.var.name],
                 "W": [weight.var.name]},
                out_shape=_shape(a))
    return LayerOutput(out)


def linear_comb_layer(weights: LayerOutput, vectors: LayerOutput,
                      size: int) -> LayerOutput:
    """LinearCombinationLayer (convex_comb_layer)."""
    out = _emit("linear_comb",
                {"X": [vectors.var.name], "W": [weights.var.name]},
                out_shape=(_shape(vectors)[0], size))
    return LayerOutput(out)


def bilinear_interp_layer(input: LayerOutput, out_h: int,
                          out_w: int) -> LayerOutput:
    """BilinearInterpLayer ([B, H, W, C] maps)."""
    shp = _shape(input)
    out = _emit("bilinear_interp", {"X": [input.var.name]},
                {"out_h": out_h, "out_w": out_w},
                out_shape=(shp[0], out_h, out_w, shp[-1]))
    return LayerOutput(out)


def repeat_layer(input: LayerOutput, num_repeats: int) -> LayerOutput:
    """FeatureMapExpandLayer."""
    shp = _shape(input)
    out = _emit("repeat", {"X": [input.var.name]}, {"times": num_repeats},
                out_shape=shp[:-1] + (shp[-1] * num_repeats,))
    return LayerOutput(out, input.lengths, input.input_type)


def rotate_layer(input: LayerOutput) -> LayerOutput:
    shp = _shape(input)
    out = _emit("rotate", {"X": [input.var.name]},
                out_shape=(shp[0], shp[2], shp[1], shp[3]))
    return LayerOutput(out)


def trans_layer(input: LayerOutput) -> LayerOutput:
    """TransLayer: matrix transpose of [B, D] -> handled as [D, B]."""
    shp = _shape(input)
    out = _emit("transpose", {"X": [input.var.name]}, {"axis": (1, 0)},
                out_shape=(shp[1], shp[0]))
    return LayerOutput(out)


def seq_reshape_layer(input: LayerOutput, reshape_size: int) -> LayerOutput:
    shp = _shape(input)
    out = _emit("seq_reshape", {"X": [input.var.name]},
                {"new_dim": reshape_size},
                out_shape=(shp[0], -1, reshape_size))
    return LayerOutput(out, input.lengths, input.input_type)


def expand_layer(input: LayerOutput, expand_as: LayerOutput) -> LayerOutput:
    """ExpandLayer: broadcast per-sequence rows to every step of expand_as."""
    out = _emit("sequence_expand",
                {"X": [input.var.name],
                 "RefLengths": [expand_as.lengths.name],
                 "Ref": [expand_as.var.name]},
                out_shape=(_shape(input)[0], _shape(expand_as)[1],
                           _shape(input)[-1]))
    return LayerOutput(out, expand_as.lengths, expand_as.input_type)


def max_id_layer(input: LayerOutput) -> LayerOutput:
    """MaxIdLayer."""
    out = _emit("argmax", {"X": [input.var.name]},
                out_shape=_shape(input)[:-1], out_dtype="int32")
    return LayerOutput(out, input.lengths)


def sampling_id_layer(input: LayerOutput, seed: int = 0) -> LayerOutput:
    """SamplingIdLayer."""
    out = _emit("sampling_id", {"X": [input.var.name]}, {"seed": seed},
                out_shape=_shape(input)[:-1], out_dtype="int32")
    return LayerOutput(out)


def clip_layer(input: LayerOutput, min: float, max: float) -> LayerOutput:
    out = _emit("clip", {"X": [input.var.name]}, {"min": min, "max": max},
                out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


def pad_layer(input: LayerOutput, pad) -> LayerOutput:
    shp = _shape(input)
    out_shape = tuple(s + lo + hi if s > 0 else s
                      for s, (lo, hi) in zip(shp, pad))
    out = _emit("pad", {"X": [input.var.name]}, {"paddings": pad},
                out_shape=out_shape)
    return LayerOutput(out)


def crop_layer(input: LayerOutput, offsets, shape) -> LayerOutput:
    out = _emit("crop", {"X": [input.var.name]},
                {"offsets": offsets, "shape": shape},
                out_shape=tuple(shape))
    return LayerOutput(out)


def multiplex_layer(index: LayerOutput,
                    inputs: List[LayerOutput]) -> LayerOutput:
    """MultiplexLayer: per-row selection among candidate inputs."""
    out = _emit("multiplex",
                {"Ids": [index.var.name],
                 "X": [i.var.name for i in inputs]},
                out_shape=_shape(inputs[0]))
    return LayerOutput(out)


def tensor_layer(a: LayerOutput, b: LayerOutput, size: int,
                 act: Optional[str] = None) -> LayerOutput:
    """TensorLayer: bilinear form aᵀ W_k b for k in 1..size."""
    da, db = _shape(a)[-1], _shape(b)[-1]
    w = FL._create_parameter("tensor_w", (size, da, db), "float32",
                             I.xavier())
    out = _emit("bilinear_tensor_product",
                {"X": [a.var.name], "Y": [b.var.name], "Weight": [w.name]},
                out_shape=(_shape(a)[0], size))
    if act:
        out = _emit(act, {"X": [out.name]}, out_shape=tuple(out.shape))
    return LayerOutput(out)


def conv_shift_layer(a: LayerOutput, b: LayerOutput) -> LayerOutput:
    """ConvShiftLayer (circular convolution, NTM-style addressing)."""
    out = _emit("conv_shift", {"X": [a.var.name], "Y": [b.var.name]},
                out_shape=_shape(a))
    return LayerOutput(out)


def block_expand_layer(input: LayerOutput, block_x: int, block_y: int,
                       stride_x: int = 1, stride_y: int = 1) -> LayerOutput:
    """BlockExpandLayer (im2col as a layer)."""
    shp = _shape(input)
    out = _emit("block_expand", {"X": [input.var.name]},
                {"block": (block_y, block_x),
                 "strides": (stride_y, stride_x), "paddings": 0},
                out_shape=(shp[0], -1, block_x * block_y * shp[-1]))
    return LayerOutput(out)


def maxout_layer(input: LayerOutput, groups: int) -> LayerOutput:
    """MaxOutLayer."""
    shp = _shape(input)
    out = _emit("maxout", {"X": [input.var.name]}, {"groups": groups},
                out_shape=shp[:-1] + (shp[-1] // groups,))
    return LayerOutput(out)


def row_conv_layer(input: LayerOutput, future_context: int) -> LayerOutput:
    """RowConvLayer (lookahead conv, DeepSpeech2)."""
    d = _shape(input)[-1]
    w = FL._create_parameter("rowconv_w", (future_context + 1, d), "float32",
                             I.xavier())
    out = _emit("row_conv",
                {"X": [input.var.name], "Filter": [w.name]},
                out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


def roi_pool_layer(input: LayerOutput, rois: LayerOutput, pooled_height: int,
                   pooled_width: int, spatial_scale: float = 1.0) -> LayerOutput:
    """ROIPoolLayer (detection)."""
    shp = _shape(input)
    out = _emit("roi_pool",
                {"X": [input.var.name], "ROIs": [rois.var.name]},
                {"pooled_height": pooled_height, "pooled_width": pooled_width,
                 "spatial_scale": spatial_scale},
                out_shape=(-1, pooled_height, pooled_width, shp[-1]))
    return LayerOutput(out)


def batch_norm_layer(input: LayerOutput, act: Optional[str] = None,
                     momentum: float = 0.9, epsilon: float = 1e-5,
                     is_test: bool = False) -> LayerOutput:
    """BatchNormLayer (3 gserver impls + operators/batch_norm_op.cc) — uses
    the TRAINING-mode fluid batch_norm (running stats updated in-graph)."""
    out = FL.batch_norm(input.var, act=act, momentum=momentum,
                        epsilon=epsilon, is_test=is_test)
    return LayerOutput(out, input.lengths, input.input_type)


def img_cmrnorm_layer(input: LayerOutput, size: int = 5, scale: float = 1e-4,
                      power: float = 0.75) -> LayerOutput:
    """CMRProjectionNormLayer (local response norm across channels)."""
    out = _emit("lrn", {"X": [input.var.name]},
                {"n": size, "alpha": scale, "beta": power},
                out_shape=_shape(input))
    return LayerOutput(out)


def img_conv3d(input: LayerOutput, num_filters: int, filter_size: int,
               stride: int = 1, padding: int = 0,
               act: Optional[str] = "relu") -> LayerOutput:
    """3-D convolution layer (operators/conv3d)."""
    shp = _shape(input)
    k = (filter_size,) * 3 if isinstance(filter_size, int) else filter_size
    w = FL._create_parameter("conv3d_w", tuple(k) + (shp[-1], num_filters),
                             "float32", I.xavier())
    out = _emit("conv3d", {"Input": [input.var.name], "Filter": [w.name]},
                {"strides": stride, "paddings": padding},
                out_shape=(shp[0], -1, -1, -1, num_filters))
    if act:
        out = _emit(act, {"X": [out.name]}, out_shape=tuple(out.shape))
    return LayerOutput(out)


def img_pool3d(input: LayerOutput, pool_size: int = 2, pool_type: str = "max",
               stride: Optional[int] = None) -> LayerOutput:
    shp = _shape(input)
    out = _emit("pool3d", {"X": [input.var.name]},
                {"ksize": pool_size, "pooling_type": pool_type,
                 "strides": stride or pool_size},
                out_shape=(shp[0], -1, -1, -1, shp[-1]))
    return LayerOutput(out)


def img_conv_transpose(input: LayerOutput, num_filters: int, filter_size: int,
                       stride: int = 1, padding: int = 0,
                       act: Optional[str] = None) -> LayerOutput:
    """Transposed convolution (operators/conv2d_transpose; GAN generators)."""
    shp = _shape(input)
    k = (filter_size,) * 2 if isinstance(filter_size, int) else filter_size
    w = FL._create_parameter("convT_w", tuple(k) + (shp[-1], num_filters),
                             "float32", I.xavier())
    out = _emit("conv2d_transpose",
                {"Input": [input.var.name], "Filter": [w.name]},
                {"strides": stride, "paddings": padding},
                out_shape=(shp[0], -1, -1, num_filters))
    if act:
        out = _emit(act, {"X": [out.name]}, out_shape=tuple(out.shape))
    return LayerOutput(out)


def spp_layer(input: LayerOutput, pyramid_height: int = 3,
              pool_type: str = "max") -> LayerOutput:
    """SpatialPyramidPoolLayer."""
    shp = _shape(input)
    bins = sum(4 ** i for i in range(pyramid_height))
    out = _emit("spp", {"X": [input.var.name]},
                {"pyramid_height": pyramid_height, "pooling_type": pool_type},
                out_shape=(shp[0], bins * shp[-1]))
    return LayerOutput(out)


def prelu_layer(input: LayerOutput) -> LayerOutput:
    d = _shape(input)[-1]
    alpha = FL._create_parameter("prelu_alpha", (d,), "float32",
                                 I.constant(0.25))
    out = _emit("prelu", {"X": [input.var.name], "Alpha": [alpha.name]},
                out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


# ------------------------------------------------------------- cost zoo ------
# CostLayer.cpp: 20+ losses; each cost returns a SCALAR mean cost layer.

def _mean_of(var) -> LayerOutput:
    return LayerOutput(_emit("mean", {"X": [var.name]}, out_shape=()))


def mse_cost(input: LayerOutput, label: LayerOutput) -> LayerOutput:
    return square_error_cost(input, label)


regression_cost = mse_cost


def multi_binary_label_cross_entropy_cost(input: LayerOutput,
                                          label: LayerOutput) -> LayerOutput:
    """CostLayer.cpp MultiBinaryLabelCrossEntropy."""
    v = _emit("multi_binary_label_cross_entropy",
              {"X": [input.var.name], "Label": [label.var.name]},
              out_shape=(_shape(input)[0],))
    return _mean_of(v)


def soft_binary_class_cross_entropy_cost(input: LayerOutput,
                                         label: LayerOutput) -> LayerOutput:
    v = _emit("soft_binary_class_cross_entropy",
              {"X": [input.var.name], "Label": [label.var.name]},
              out_shape=(_shape(input)[0],))
    return _mean_of(v)


def huber_regression_cost(input: LayerOutput, label: LayerOutput,
                          delta: float = 1.0) -> LayerOutput:
    v = _emit("huber_loss",
              {"X": [input.var.name], "Label": [label.var.name]},
              {"delta": delta}, out_shape=(_shape(input)[0],))
    return _mean_of(v)


def huber_classification_cost(input: LayerOutput,
                              label: LayerOutput) -> LayerOutput:
    """HuberTwoClassification ({-1,+1} labels)."""
    v = _emit("huber_classification",
              {"X": [input.var.name], "Label": [label.var.name]},
              out_shape=(_shape(input)[0],))
    return _mean_of(v)


def rank_cost(left: LayerOutput, right: LayerOutput,
              label: LayerOutput) -> LayerOutput:
    """RankingCost (pairwise logistic)."""
    v = _emit("rank_loss",
              {"Left": [left.var.name], "Right": [right.var.name],
               "Label": [label.var.name]},
              out_shape=(_shape(left)[0],))
    return _mean_of(v)


def lambda_cost(score: LayerOutput, label: LayerOutput) -> LayerOutput:
    """LambdaCost (LambdaRank with |ΔNDCG| pair weights) over a sequence of
    candidate scores per query."""
    v = _emit("lambda_cost",
              {"X": [score.var.name], "Label": [label.var.name],
               "Lengths": [score.lengths.name]},
              out_shape=(_shape(score)[0],))
    return _mean_of(v)


def cross_entropy_with_selfnorm_cost(input: LayerOutput, label: LayerOutput,
                                     softmax_selfnorm_alpha: float = 0.1
                                     ) -> LayerOutput:
    v = _emit("cross_entropy_over_selfnorm",
              {"X": [input.var.name], "Label": [label.var.name]},
              {"softmax_selfnorm_alpha": softmax_selfnorm_alpha},
              out_shape=(_shape(input)[0],))
    return _mean_of(v)


def smooth_l1_cost(input: LayerOutput, label: LayerOutput) -> LayerOutput:
    v = _emit("smooth_l1_loss",
              {"X": [input.var.name], "Label": [label.var.name]},
              out_shape=(_shape(input)[0],))
    return _mean_of(v)


def hinge_cost(input: LayerOutput, label: LayerOutput) -> LayerOutput:
    v = _emit("hinge_loss",
              {"X": [input.var.name], "Label": [label.var.name]},
              out_shape=(_shape(input)[0],))
    return _mean_of(v)


def log_loss_cost(input: LayerOutput, label: LayerOutput,
                  epsilon: float = 1e-7) -> LayerOutput:
    v = _emit("log_loss",
              {"Predicted": [input.var.name], "Label": [label.var.name]},
              {"eps": epsilon}, out_shape=(_shape(input)[0],))
    return _mean_of(v)


def sum_cost(input: LayerOutput) -> LayerOutput:
    """SumCost: sum of the input as the cost."""
    v = _emit("reduce_sum", {"X": [input.var.name]}, {"dim": None},
              out_shape=())
    return LayerOutput(v)


def sigmoid_cross_entropy_cost(input: LayerOutput,
                               label: LayerOutput) -> LayerOutput:
    v = _emit("sigmoid_cross_entropy_with_logits",
              {"X": [input.var.name], "Label": [label.var.name]},
              out_shape=_shape(input))
    return _mean_of(v)


def crf_layer(input: LayerOutput, label: LayerOutput,
              size: Optional[int] = None) -> LayerOutput:
    """CRFLayer (linear-chain CRF negative log-likelihood).

    The transition parameter is exposed as ``.transitions`` on the returned
    cost layer — pass it to :func:`crf_decoding_layer` so Viterbi decoding
    uses the TRAINED matrix (the reference shares it by parameter name)."""
    n_tags = size or _shape(input)[-1]
    trans = FL._create_parameter("crf_trans", (n_tags + 2, n_tags), "float32",
                                 I.constant(0.0))
    v = _emit("linear_chain_crf",
              {"Emission": [input.var.name], "Label": [label.var.name],
               "Transition": [trans.name],
               "Lengths": [input.lengths.name]},
              out_shape=(_shape(input)[0],), out_slot="LogLikelihood")
    neg = _emit("scale", {"X": [v.name]}, {"scale": -1.0},
                out_shape=(_shape(input)[0],))
    cost = _mean_of(neg)
    cost.transitions = LayerOutput(trans)
    return cost


def crf_decoding_layer(input: LayerOutput, size: Optional[int] = None,
                       transitions: Optional[LayerOutput] = None
                       ) -> LayerOutput:
    """CRFDecodingLayer (Viterbi). Pass ``transitions`` from the training
    crf_layer's ``.transitions`` to decode with the learned matrix; omitting
    it creates a FRESH zero matrix (argmax-of-emissions decoding)."""
    n_tags = size or _shape(input)[-1]
    if transitions is not None:
        trans = transitions.var
    else:
        trans = FL._create_parameter("crf_trans", (n_tags + 2, n_tags),
                                     "float32", I.constant(0.0))
    v = _emit("crf_decoding",
              {"Emission": [input.var.name], "Transition": [trans.name],
               "Lengths": [input.lengths.name]},
              out_shape=_shape(input)[:-1], out_dtype="int32",
              out_slot="ViterbiPath")
    return LayerOutput(v, input.lengths)


def ctc_layer(input: LayerOutput, label: LayerOutput, size: int,
              blank: int = 0) -> LayerOutput:
    """CTCLayer / WarpCTCLayer."""
    v = _emit("warpctc",
              {"Logits": [input.var.name], "Label": [label.var.name],
               "LogitsLengths": [input.lengths.name],
               "LabelLengths": [label.lengths.name]},
              {"blank": blank}, out_shape=(_shape(input)[0],),
              out_slot="Loss")
    return _mean_of(v)


def nce_layer(input: LayerOutput, label: LayerOutput, num_classes: int,
              num_neg_samples: int = 10, seed: int = 0) -> LayerOutput:
    """NCELayer (noise-contrastive estimation)."""
    d = _shape(input)[-1]
    w = FL._create_parameter("nce_w", (num_classes, d), "float32",
                             I.normal(0.0, 0.01))
    bias = FL._create_parameter("nce_b", (num_classes,), "float32", I.zeros)
    v = _emit("nce",
              {"Input": [input.var.name], "Label": [label.var.name],
               "Weight": [w.name], "Bias": [bias.name]},
              {"num_neg_samples": num_neg_samples, "seed": seed,
               "num_classes": num_classes},
              out_shape=(_shape(input)[0],), out_slot="Cost")
    return _mean_of(v)


def hsigmoid_layer(input: LayerOutput, label: LayerOutput,
                   num_classes: int) -> LayerOutput:
    """HierarchicalSigmoidLayer: O(log V) softmax over a Huffman-ish tree;
    paths/codes are derived in-op from the static num_classes attr."""
    d = _shape(input)[-1]
    w = FL._create_parameter("hsig_w", (2 * num_classes, d), "float32",
                             I.normal(0.0, 0.01))
    bias = FL._create_parameter("hsig_b", (2 * num_classes,), "float32",
                                I.zeros)
    v = _emit("hierarchical_sigmoid",
              {"Input": [input.var.name], "Label": [label.var.name],
               "InnerW": [w.name], "InnerB": [bias.name]},
              {"num_classes": num_classes},
              out_shape=(), out_slot="Cost")
    return LayerOutput(v)


# ======================================================================
# gen-1 tail (round 3): the last ~20 trainer_config_helpers/layers.py
# functions — see docs/v2_layer_parity.md for the name-for-name table.
# ======================================================================

def lstm_step_layer(input: LayerOutput, state: LayerOutput,
                    size: Optional[int] = None,
                    forget_bias: float = 0.0, bias_attr: bool = True,
                    name: Optional[str] = None) -> LayerOutput:
    """LSTM step with PRE-PROJECTED gates + peephole connections, for use
    inside recurrent_group (layers.py:3544; LstmStepLayer.cpp). ``input``
    is Wx_t + Wh_{t-1} [_, 4*size] built with mixed_layer projections;
    ``state`` the c_{t-1} memory. Default output h_t; the cell is the
    'state' secondary output (get_output_layer(out, 'state') — the
    reference's exact idiom for wiring the cell memory)."""
    if size is None:
        size = _shape(input)[-1] // 4
    w_peep = FL._create_parameter("lstm_step_peep", (3, size), "float32",
                                  I.zeros)
    ins = {"X": [input.var.name], "CPrev": [state.var.name],
           "WPeep": [w_peep.name]}
    if bias_attr:
        bias = FL._create_parameter("lstm_step_b", (4 * size,), "float32",
                                    I.zeros)
        ins["B"] = [bias.name]
    b = default_main_program().current_block()
    h = b.create_var(shape=(-1, size), dtype="float32")
    c = b.create_var(shape=(-1, size), dtype="float32")
    b.append_op("lstm_step", ins, {"H": [h.name], "C": [c.name]},
                {"forget_bias": forget_bias})
    _register_named(name, h)
    return LayerOutput(h, outputs={"state": c})


def gru_step_layer(input: LayerOutput, output_mem: LayerOutput,
                   size: Optional[int] = None, bias_attr: bool = True,
                   name: Optional[str] = None) -> LayerOutput:
    """GRU step for recurrent_group (layers.py:3642; GruStepLayer.cpp):
    ``input`` is x_t @ W [_, 3*size] (projected outside, as the reference
    requires); the recurrent transform of ``output_mem`` (h_{t-1}) happens
    here via the step's own U parameter."""
    if size is None:
        size = _shape(input)[-1] // 3
    u = FL._create_parameter("gru_step_u", (size, 3 * size), "float32",
                             I.uniform(-0.08, 0.08))
    ins = {"X": [input.var.name], "HPrev": [output_mem.var.name],
           "U": [u.name]}
    if bias_attr:
        bias = FL._create_parameter("gru_step_b", (3 * size,), "float32",
                                    I.zeros)
        ins["B"] = [bias.name]
    b = default_main_program().current_block()
    h = b.create_var(shape=(-1, size), dtype="float32")
    b.append_op("gru_unit", ins, {"H": [h.name]}, {})
    _register_named(name, h)
    return LayerOutput(h)


def get_output_layer(input: LayerOutput, arg_name: str,
                     name: Optional[str] = None) -> LayerOutput:
    """Fetch a layer's secondary output by name (layers.py:3802), e.g.
    lstm_step_layer's 'state' (the cell)."""
    if not input.outputs or arg_name not in input.outputs:
        have = sorted(input.outputs or {})
        raise ValueError(f"layer has no output {arg_name!r}; it has {have}")
    v = input.outputs[arg_name]
    _register_named(name, v)
    return LayerOutput(v, input.lengths, input.input_type)


def selective_fc_layer(input, size: int, select: Optional[LayerOutput] = None,
                       act: Optional[str] = "tanh",
                       bias_attr: bool = True,
                       name: Optional[str] = None) -> LayerOutput:
    """Selective fc (layers.py:4967, SelectiveFullyConnectedLayer.cpp):
    only the columns flagged by ``select`` (a 0/1 mask [B, size]) are
    produced. The reference exploits output sparsity on CPU
    (mul_ratio heuristics); here a masked dense matmul is the path — the
    GEMM computes the full [B, size] tile either way, so the
    select mask is applied to the result (zeros where unselected, matching
    the reference's sparse output semantics). Without ``select`` it is
    exactly fc_layer."""
    out = fc(input, size, act=act, bias_attr=bias_attr, name=None)
    if select is None:
        _register_named(name, out.var)
        return out
    masked = _emit("elementwise_mul",
                   {"X": [out.var.name], "Y": [select.var.name]},
                   out_shape=(-1, size))
    _register_named(name, masked)
    return LayerOutput(masked)


def gated_unit_layer(input: LayerOutput, size: int,
                     act: Optional[str] = None,
                     name: Optional[str] = None) -> LayerOutput:
    """Gated linear unit y = act(XW + b) * sigmoid(XV + c)
    (layers.py:6589, after arXiv:1612.08083). Sequence inputs keep their
    lengths: the projections are per-position matmuls (fc would flatten
    the time dim)."""
    d = _shape(input)[-1]
    w = FL._create_parameter("gated_w", (d, size), "float32", I.xavier())
    v_ = FL._create_parameter("gated_v", (d, size), "float32", I.xavier())
    bw = FL._create_parameter("gated_bw", (size,), "float32", I.zeros)
    bv = FL._create_parameter("gated_bv", (size,), "float32", I.zeros)
    shp = _shape(input)[:-1] + (size,)
    proj = _emit("matmul", {"X": [input.var.name], "Y": [w.name]},
                 out_shape=shp)
    proj = _emit("elementwise_add", {"X": [proj.name], "Y": [bw.name]},
                 out_shape=shp)
    if act:
        proj = _emit(act, {"X": [proj.name]}, out_shape=shp)
    gate = _emit("matmul", {"X": [input.var.name], "Y": [v_.name]},
                 out_shape=shp)
    gate = _emit("elementwise_add", {"X": [gate.name], "Y": [bv.name]},
                 out_shape=shp)
    gate = _emit("sigmoid", {"X": [gate.name]}, out_shape=shp)
    out = _emit("elementwise_mul", {"X": [proj.name], "Y": [gate.name]},
                out_shape=shp)
    _register_named(name, out)
    return LayerOutput(out, input.lengths, input.input_type)


def dot_prod_layer(input1: LayerOutput, input2: LayerOutput) -> LayerOutput:
    """Row-wise dot product [B, D] x [B, D] -> [B, 1] (layers.py:4146)."""
    prod = _emit("elementwise_mul",
                 {"X": [input1.var.name], "Y": [input2.var.name]},
                 out_shape=_shape(input1))
    out = _emit("reduce_sum", {"X": [prod.name]},
                {"dim": -1, "keep_dim": True}, out_shape=(-1, 1))
    return LayerOutput(out)


def out_prod_layer(input1: LayerOutput, input2: LayerOutput) -> LayerOutput:
    """Outer product [B, D1] x [B, D2] -> [B, D1*D2] (layers.py:4185)."""
    d1, d2 = _shape(input1)[-1], _shape(input2)[-1]
    a3 = _emit("unsqueeze", {"X": [input1.var.name]}, {"axis": -1},
               out_shape=(-1, d1, 1))
    b3 = _emit("unsqueeze", {"X": [input2.var.name]}, {"axis": 1},
               out_shape=(-1, 1, d2))
    m = _emit("matmul", {"X": [a3.name], "Y": [b3.name]},
              out_shape=(-1, d1, d2))
    out = _emit("reshape", {"X": [m.name]}, {"shape": (-1, d1 * d2)},
                out_shape=(-1, d1 * d2))
    return LayerOutput(out)


def eos_layer(input: LayerOutput, eos_id: int) -> LayerOutput:
    """1 where the id equals eos_id (layers.py:4224, EosIdCheckLayer) —
    the recurrent-group stop predicate."""
    v = _emit("equal_scalar", {"X": [input.var.name]}, {"value": eos_id},
              out_shape=_shape(input), out_dtype="int32")
    return LayerOutput(v, input.lengths, input.input_type)


def cross_channel_norm_layer(input: LayerOutput,
                             channels: Optional[int] = None) -> LayerOutput:
    """SSD's cross-channel L2 norm with a trainable per-channel scale
    (layers.py:1357, NormProjectionLayer cross-channel-norm). NHWC: the
    channel axis is last."""
    c = channels or _shape(input)[-1]
    scale = FL._create_parameter("ccn_scale", (c,), "float32", I.ones)
    normed = _emit("l2_normalize", {"X": [input.var.name]}, {"axis": -1},
                   out_shape=_shape(input))
    out = _emit("elementwise_mul", {"X": [normed.name], "Y": [scale.name]},
                out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


def row_l2_norm_layer(input: LayerOutput) -> LayerOutput:
    """Row-wise L2 normalization (layers.py:3191, RowL2NormLayer)."""
    v = _emit("l2_normalize", {"X": [input.var.name]}, {"axis": -1},
              out_shape=_shape(input))
    return LayerOutput(v, input.lengths, input.input_type)


def scale_shift_layer(input: LayerOutput, bias_attr: bool = True) -> LayerOutput:
    """y = w * x + b with SCALAR trainable w (and b) — layers.py:7114,
    ScaleShiftLayer (the trainable SlopeIntercept)."""
    w = FL._create_parameter("scale_shift_w", (1,), "float32", I.ones)
    out = _emit("elementwise_mul", {"X": [input.var.name], "Y": [w.name]},
                out_shape=_shape(input))
    if bias_attr:
        bias = FL._create_parameter("scale_shift_b", (1,), "float32", I.zeros)
        out = _emit("elementwise_add", {"X": [out.name], "Y": [bias.name]},
                    out_shape=_shape(input))
    return LayerOutput(out, input.lengths, input.input_type)


def resize_layer(input: LayerOutput, size: int) -> LayerOutput:
    """Reflow the batch matrix to row width ``size`` (layers.py:7155,
    ResizeLayer): [H, W] -> [H*W/size, size]."""
    v = _emit("reshape", {"X": [input.var.name]}, {"shape": (-1, size)},
              out_shape=(-1, size))
    return LayerOutput(v)


def switch_order_layer(input: LayerOutput) -> LayerOutput:
    """NCHW -> NHWC transpose (layers.py:6682, SwitchOrderLayer). This
    build is NHWC-native (the image stack's layout), so this layer
    exists for reference configs that interleave layout switches; it
    performs the same permutation on an explicitly NCHW tensor."""
    s = _shape(input)
    if len(s) != 4:
        raise ValueError(f"switch_order_layer needs a 4-D NCHW input, "
                         f"got shape {s}")
    v = _emit("transpose", {"X": [input.var.name]}, {"axis": (0, 2, 3, 1)},
              out_shape=(s[0], s[2], s[3], s[1]))
    return LayerOutput(v)


# ------------------------------------------------- sub-sequence family ---

def sub_seq_layer(input: LayerOutput, offsets: LayerOutput,
                  sizes: LayerOutput) -> LayerOutput:
    """Per-sequence slice by (offset, size) index layers (layers.py:7176,
    SubSequenceLayer). Output lengths are the sizes."""
    if input.lengths is None:
        raise ValueError("sub_seq_layer needs a sequence input")
    max_t = _shape(input)[1] if len(_shape(input)) > 2 else -1
    b = default_main_program().current_block()
    out = b.create_var(shape=_shape(input), dtype="float32")
    b.append_op("sequence_slice",
                {"X": [input.var.name], "Lengths": [input.lengths.name],
                 "Offset": [offsets.var.name], "Length": [sizes.var.name]},
                {"Out": [out.name]},
                {"max_out": max_t} if max_t and max_t > 0 else {})
    return LayerOutput(out, sizes.var, input.input_type)


def seq_slice_layer(input: LayerOutput, starts: Optional[LayerOutput],
                    ends: Optional[LayerOutput]) -> LayerOutput:
    """Slice each sequence between per-sample start/end indices
    (layers.py:6861, SequenceSliceLayer). starts=None slices from the
    beginning; ends=None to the sequence end. (The reference's multi-slice
    form — several (start, end) pairs per sequence — is expressed by
    calling this layer per pair and seq_concat_layer-ing the results.)"""
    if input.lengths is None:
        raise ValueError("seq_slice_layer needs a sequence input")
    if starts is None and ends is None:
        raise ValueError("give at least one of starts/ends")
    if starts is None:
        start_var = _emit("scale", {"X": [input.lengths.name]}, {"scale": 0},
                          out_shape=(-1,), out_dtype="int32")
    else:
        start_var = starts.var
    end_var = input.lengths if ends is None else ends.var
    length = _emit("elementwise_sub", {"X": [end_var.name],
                                       "Y": [start_var.name]},
                   out_shape=(-1,), out_dtype="int32")
    return sub_seq_layer(input, LayerOutput(start_var), LayerOutput(length))


def seq_concat_layer(a: LayerOutput, b: LayerOutput) -> LayerOutput:
    """Concatenate two sequences per sample: [a1..am, b1..bn]
    (layers.py:3391, SequenceConcatLayer)."""
    if a.lengths is None or b.lengths is None:
        raise ValueError("seq_concat_layer needs two sequence inputs")
    blk = default_main_program().current_block()
    ta = _shape(a)[1] if len(_shape(a)) > 2 else -1
    tb = _shape(b)[1] if len(_shape(b)) > 2 else -1
    t_out = (ta + tb) if (ta and tb and ta > 0 and tb > 0) else -1
    out = blk.create_var(shape=(_shape(a)[0], t_out) + _shape(a)[2:],
                         dtype="float32")
    lens = blk.create_var(shape=(-1,), dtype="int32")
    blk.append_op("sequence_concat",
                  {"X": [a.var.name], "XLengths": [a.lengths.name],
                   "Y": [b.var.name], "YLengths": [b.lengths.name]},
                  {"Out": [out.name], "OutLengths": [lens.name]}, {})
    return LayerOutput(out, lens, a.input_type)


def kmax_seq_score_layer(input: LayerOutput,
                         beam_size: int = 1) -> LayerOutput:
    """Indices of the beam_size highest-scoring positions per sequence
    (layers.py:6927, KmaxSeqScoreLayer); padding never selected."""
    if input.lengths is None:
        raise ValueError("kmax_seq_score_layer needs a sequence input")
    v = _emit("kmax_seq_score",
              {"X": [input.var.name], "Lengths": [input.lengths.name]},
              {"beam_size": beam_size}, out_shape=(-1, beam_size),
              out_dtype="int32")
    return LayerOutput(v)


def sub_nested_seq_layer(input: LayerOutput,
                         selected_indices: LayerOutput) -> LayerOutput:
    """Trim a nested sequence to the selected sub-sequences
    (layers.py:6781, SubNestedSequenceLayer — the beam-training trim);
    pairs with kmax_seq_score_layer."""
    if input.sub_lengths is None:
        raise ValueError("sub_nested_seq_layer needs a nested sequence "
                         "input (sub_lengths)")
    blk = default_main_program().current_block()
    k = _shape(selected_indices)[-1]
    out = blk.create_var(shape=(_shape(input)[0], k) + _shape(input)[2:],
                         dtype=input.var.dtype)
    sub = blk.create_var(shape=(-1, k), dtype="int32")
    blk.append_op("sub_nested_seq",
                  {"X": [input.var.name],
                   "SubLengths": [input.sub_lengths.name],
                   "Indices": [selected_indices.var.name]},
                  {"Out": [out.name], "SubLengthsOut": [sub.name]}, {})
    lens = _emit("scale", {"X": [input.lengths.name]},
                 {"scale": 0, "bias": k}, out_shape=(-1,), out_dtype="int32")
    return LayerOutput(out, lens, input.input_type, sub_lengths=sub)


# ------------------------------------------------- detection DSL trio ---

def _concat_heads(inputs, last_dim: int) -> Variable:
    """Normalize one-or-list of per-feature-map heads to a single
    [B, P_total, last_dim] variable (SSD multi-scale head concat)."""
    heads = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(heads) == 1:
        return heads[0].var
    return _emit("concat", {"X": [h.var.name for h in heads]}, {"axis": 1},
                 out_shape=(-1, -1, last_dim))


def priorbox_layer(input: LayerOutput, image: LayerOutput,
                   aspect_ratio, variance, min_size, max_size=(),
                   flip: bool = True, clip: bool = True) -> LayerOutput:
    """SSD prior boxes for one feature map (layers.py:1114). NHWC shapes
    are read statically from the feature/image layers; returns boxes
    [P, 4] with the variances as the 'variances' secondary output."""
    fh, fw = _shape(input)[1], _shape(input)[2]
    ih, iw = _shape(image)[1], _shape(image)[2]
    mins = list(min_size) if isinstance(min_size, (list, tuple)) else [min_size]
    maxs = list(max_size) if isinstance(max_size, (list, tuple)) else [max_size]
    blk = default_main_program().current_block()
    box_parts, var_parts = [], []
    for i, mn in enumerate(mins):
        boxes = blk.create_var(shape=(-1, 4), dtype="float32")
        variances = blk.create_var(shape=(-1, 4), dtype="float32")
        blk.append_op("prior_box", {},
                      {"Boxes": [boxes.name], "Variances": [variances.name]},
                      {"feature_hw": (fh, fw), "image_hw": (ih, iw),
                       "min_size": mn,
                       "max_size": maxs[i] if i < len(maxs) else None,
                       "aspect_ratios": tuple(aspect_ratio), "flip": flip,
                       "clip": clip, "variance": tuple(variance)})
        box_parts.append(boxes)
        var_parts.append(variances)
    if len(box_parts) == 1:
        return LayerOutput(box_parts[0], outputs={"variances": var_parts[0]})

    # Cell-major interleave across sizes (PriorBoxLayer.cpp: per cell, ALL
    # sizes' priors are contiguous) so prior rows line up with conv heads
    # that emit priors-per-cell; a plain axis-0 concat would be size-major.
    cells = fh * fw
    n_ratio = len(tuple(aspect_ratio)) * (2 if flip else 1)

    def per_cell(var, i):
        p_i = 1 + (1 if i < len(maxs) and maxs[i] is not None else 0) + n_ratio
        return _emit("reshape", {"X": [var.name]},
                     {"shape": (cells, p_i, 4)}, out_shape=(cells, p_i, 4))

    boxes3 = _emit("concat",
                   {"X": [per_cell(b, i).name
                          for i, b in enumerate(box_parts)]},
                   {"axis": 1}, out_shape=(cells, -1, 4))
    vars3 = _emit("concat",
                  {"X": [per_cell(v, i).name
                         for i, v in enumerate(var_parts)]},
                  {"axis": 1}, out_shape=(cells, -1, 4))
    boxes = _emit("reshape", {"X": [boxes3.name]}, {"shape": (-1, 4)},
                  out_shape=(-1, 4))
    variances = _emit("reshape", {"X": [vars3.name]}, {"shape": (-1, 4)},
                      out_shape=(-1, 4))
    return LayerOutput(boxes, outputs={"variances": variances})


def multibox_loss_layer(input_loc, input_conf, priorbox: LayerOutput,
                        label: LayerOutput, num_classes: int,
                        overlap_threshold: float = 0.5,
                        neg_pos_ratio: float = 3.0,
                        background_id: int = 0) -> LayerOutput:
    """SSD loss (layers.py:1160): localization smooth-L1 + mined softmax
    confidence vs matched priors. ``label`` packs ground truth as
    (boxes [B,G,4], classes [B,G], mask [B,G]) secondary outputs of a
    ground-truth data composite (see tests) or a LayerOutput with
    .outputs {'gt_label','gt_mask'}."""
    loc = _concat_heads(input_loc, 4)
    conf = _concat_heads(input_conf, num_classes)
    if not label.outputs or not {"gt_label", "gt_mask"} <= set(label.outputs):
        raise ValueError("multibox_loss_layer label needs outputs "
                         "{'gt_label', 'gt_mask'} (ground-truth composite)")
    v = _emit("multibox_loss",
              {"Loc": [loc.name], "Conf": [conf.name],
               "PriorBox": [priorbox.var.name],
               "PriorVar": [priorbox.outputs["variances"].name],
               "GTBox": [label.var.name],
               "GTLabel": [label.outputs["gt_label"].name],
               "GTMask": [label.outputs["gt_mask"].name]},
              {"overlap_threshold": overlap_threshold,
               "neg_pos_ratio": neg_pos_ratio,
               "background_id": background_id},
              out_shape=(-1,), out_slot="Loss")
    return _mean_of(v)


def detection_output_layer(input_loc, input_conf, priorbox: LayerOutput,
                           num_classes: int, nms_threshold: float = 0.45,
                           confidence_threshold: float = 0.01,
                           keep_top_k: int = 100,
                           background_id: int = 0) -> LayerOutput:
    """SSD inference head (layers.py:1233): decode + per-class NMS. Boxes
    are the default output; scores and the valid mask are secondary
    outputs ('scores', 'valid')."""
    loc = _concat_heads(input_loc, 4)
    conf = _concat_heads(input_conf, num_classes)
    blk = default_main_program().current_block()
    nc = num_classes - 1                     # per non-background class
    boxes = blk.create_var(shape=(-1, nc, keep_top_k, 4), dtype="float32")
    scores = blk.create_var(shape=(-1, nc, keep_top_k), dtype="float32")
    valid = blk.create_var(shape=(-1, nc, keep_top_k), dtype="float32")
    blk.append_op("detection_output",
                  {"Loc": [loc.name], "Conf": [conf.name],
                   "PriorBox": [priorbox.var.name],
                   "PriorVar": [priorbox.outputs["variances"].name]},
                  {"Boxes": [boxes.name], "Scores": [scores.name],
                   "Valid": [valid.name]},
                  {"num_classes": num_classes,
                   "nms_threshold": nms_threshold,
                   "score_threshold": confidence_threshold,
                   "keep_top_k": keep_top_k,
                   "background_id": background_id})
    return LayerOutput(boxes, outputs={"scores": scores, "valid": valid})


def conv_operator(img: LayerOutput, filter: LayerOutput, filter_size: int,
                  num_filters: int, num_channels: Optional[int] = None,
                  stride: int = 1, padding: int = 0) -> _Projection:
    """Conv with a DYNAMIC filter input inside mixed_layer
    (layers.py conv_operator; ConvOperator.cpp): the second input IS the
    filter tensor (parameter-free), e.g. attention-generated kernels.
    ``filter``: [B, num_filters*C*k*k] per-sample filters flattened in the
    reference's (num_filters, C, k, k) order; the conv runs per sample
    (vmap in the op)."""
    c = num_channels or _shape(img)[-1]

    def emit():
        return _emit("dyn_conv2d",
                     {"X": [img.var.name], "Filter": [filter.var.name]},
                     {"filter_size": filter_size, "num_filters": num_filters,
                      "channels": c, "stride": stride, "padding": padding},
                     out_shape=(-1, -1, -1, num_filters))
    return _Projection(emit, num_filters, src=img)


def conv_projection(input: LayerOutput, filter_size: int, num_filters: int,
                    num_channels: Optional[int] = None, stride: int = 1,
                    padding: int = 0) -> _Projection:
    """Conv with a TRAINABLE filter as a mixed_layer projection
    (layers.py conv_projection; ConvProjection.cpp). NHWC."""
    c = num_channels or _shape(input)[-1]

    def emit():
        w = FL._create_parameter(
            "convproj_w", (filter_size, filter_size, c, num_filters),
            "float32", I.msra())
        return _emit("conv2d", {"Input": [input.var.name],
                                "Filter": [w.name]},
                     {"strides": stride, "paddings": padding},
                     out_shape=(-1, -1, -1, num_filters))
    return _Projection(emit, num_filters, src=input)


def scale_sub_region_layer(input: LayerOutput, indices: LayerOutput,
                           value: float) -> LayerOutput:
    """Scale a per-sample sub-region of a CHW/HWC feature map by ``value``
    (layers.py scale_sub_region_layer; ScaleSubRegionLayer.cpp). indices:
    [B, 6] = (C_start, C_end, H_start, H_end, W_start, W_end), 1-based
    inclusive, matching the reference layout."""
    v = _emit("scale_sub_region",
              {"X": [input.var.name], "Indices": [indices.var.name]},
              {"value": value}, out_shape=_shape(input))
    return LayerOutput(v)


def slice_projection(input: LayerOutput, slices) -> _Projection:
    """Concatenate feature slices [(start, end), ...] of the input
    (SliceProjection, layers.py slice_projection)."""
    total = sum(e - s for s, e in slices)

    def emit():
        parts = []
        ndim = len(_shape(input))
        for s, e in slices:
            starts = [0] * (ndim - 1) + [s]
            shape = [-1] * (ndim - 1) + [e - s]
            parts.append(_emit("crop", {"X": [input.var.name]},
                               {"offsets": starts, "shape": shape},
                               out_shape=_shape(input)[:-1] + (e - s,)))
        if len(parts) == 1:
            return parts[0]
        return _emit("concat", {"X": [p.name for p in parts]}, {"axis": -1},
                     out_shape=_shape(input)[:-1] + (total,))
    return _Projection(emit, total, src=input)


def cross_entropy_over_beam(scores: LayerOutput, gold_index: LayerOutput,
                            gold_score: Optional[LayerOutput] = None) -> LayerOutput:
    """Beam-training cross entropy (CrossEntropyOverBeamLayer,
    layers.py cross_entropy_over_beam): softmax CE over each sample's beam
    candidate scores [B, K] with the gold candidate's beam position as the
    label. When the gold fell OUT of the beam, pass gold_index = K and its
    model score via ``gold_score`` — it joins as a (K+1)-th slot, the
    reference's append-gold construction. In-beam samples never see the
    appended slot (it is masked), so their gold score is counted exactly
    once in the softmax partition."""
    ins = {"X": [scores.var.name], "GoldIdx": [gold_index.var.name]}
    if gold_score is not None:
        ins["GoldScore"] = [gold_score.var.name]
    v = _emit("cross_entropy_over_beam", ins, out_shape=(-1,))
    return _mean_of(v)


def print_layer(input: LayerOutput, head: int = 8) -> LayerOutput:
    """Forward-value printer (layers.py print_layer / PrintLayer): registers
    a fetchable head-of-values metric (the v2 evaluator DSL's printer) and
    passes the input through unchanged — host-side logging decides
    formatting, as in the reference."""
    from .evaluator import value_printer_evaluator
    value_printer_evaluator(input, head=head)
    return input


# ---------------------------------------------------------------------------
# Verbatim name parity with the reference DSL. Every name in the reference's
# __all__ (trainer_config_helpers/layers.py:34-140, 115 names) is importable
# under its reference spelling — either the canonical function above or an
# alias/enum here. Swept by tests/test_v2_import_parity.py.
# ---------------------------------------------------------------------------

class AggregateLevel:
    """Aggregation level enum (layers.py:284): TO_NO_SEQUENCE pools each
    (sub-)sequence down to one vector; TO_SEQUENCE pools each nested
    sub-sequence to one timestep of the outer sequence (our nested_* ops)."""
    TO_NO_SEQUENCE = "non-seq"
    TO_SEQUENCE = "seq"
    # deprecated spellings kept by the reference for old configs
    EACH_TIMESTEP = TO_NO_SEQUENCE
    EACH_SEQUENCE = TO_SEQUENCE


class ExpandLevel:
    """Expansion level enum (layers.py:1816) — the inverse of
    AggregateLevel, used by expand_layer."""
    FROM_NO_SEQUENCE = AggregateLevel.TO_NO_SEQUENCE
    FROM_SEQUENCE = AggregateLevel.TO_SEQUENCE
    FROM_TIMESTEP = FROM_NO_SEQUENCE


class LayerType:
    """Layer type string enum (layers.py:153). The v2 DSL here compiles to
    Program IR ops rather than proto layer configs, so these are parity
    constants: ``LayerOutput``s don't carry them, but configs written
    against the reference enum keep importing and comparing."""
    DATA = "data"
    MIXED_LAYER = "mixed"
    LSTMEMORY = "lstmemory"
    GRUMEMORY = "gated_recurrent"
    SEQUENCE_LAST_INSTANCE = "seqlastins"
    SEQUENCE_FIRST_INSTANCE = "seqfirstins"
    SEQUENCE_RESHAPE = "seqreshape"
    POOLING_MAX = "max"
    POOLING_AVG = "average"
    FC_LAYER = "fc"
    COST = "cost"
    COSINE_SIM = "cos"
    HSIGMOID = "hsigmoid"
    CONV_LAYER = "conv"
    CONVTRANS_LAYER = "convt"
    POOL_LAYER = "pool"
    POOL3D_LAYER = "pool3d"
    BATCH_NORM_LAYER = "batch_norm"
    NORM_LAYER = "norm"
    SUM_TO_ONE_NORM_LAYER = "sum_to_one_norm"
    ROW_L2_NORM_LAYER = "row_l2_norm"
    ADDTO_LAYER = "addto"
    CONCAT_LAYER = "concat"
    CONCAT_PROJ_LAYER = "concat2"
    SEQUENCE_CONCAT_LAYER = "seqconcat"
    LSTM_STEP_LAYER = "lstm_step"
    GRU_STEP_LAYER = "gru_step"
    GET_OUTPUT_LAYER = "get_output"
    EXPAND_LAYER = "expand"
    INTERPOLATION_LAYER = "interpolation"
    BILINEAR_INTERP_LAYER = "bilinear_interp"
    POWER_LAYER = "power"
    SCALING_LAYER = "scaling"
    TRANS_LAYER = "trans"
    ROTATE_LAYER = "rotate"
    DROPOUT_LAYER = "dropout"
    TENSOR_LAYER = "tensor"
    SELECTIVE_FC_LAYER = "selective_fc"
    SAMPLING_ID_LAYER = "sampling_id"
    SLOPE_INTERCEPT_LAYER = "slope_intercept"
    LINEAR_COMBINATION_LAYER = "convex_comb"
    BLOCK_EXPAND = "blockexpand"
    MAXOUT = "maxout"
    SPP_LAYER = "spp"
    PAD_LAYER = "pad"
    MULTIPLEX_LAYER = "multiplex"
    ROW_CONV_LAYER = "row_conv"
    PRINT_LAYER = "print"
    PRIORBOX_LAYER = "priorbox"
    MULTIBOX_LOSS_LAYER = "multibox_loss"
    DETECTION_OUTPUT_LAYER = "detection_output"
    CTC_LAYER = "ctc"
    WARP_CTC_LAYER = "warp_ctc"
    CRF_LAYER = "crf"
    CRF_DECODING_LAYER = "crf_decoding"
    NCE_LAYER = "nce"
    MAXID_LAYER = "maxid"
    EOSID_LAYER = "eos_id"
    RECURRENT_LAYER = "recurrent"
    CROP_LAYER = "crop"
    SUB_NESTED_SEQ = "sub_nested_seq"
    CLIP_LAYER = "clip"
    SEQ_SLICE = "seq_slice"
    KMAX_SEQ_SCORE = "kmax_seq_score"
    SCALE_SHIFT_LAYER = "scale_shift"
    RESIZE = "resize"
    SUB_SEQ_LAYER = "subseq"
    SCALE_SUB_REGION_LAYER = "scale_sub_region"

    @classmethod
    def is_layer_type(cls, type_name) -> bool:
        return any(getattr(cls, k) == type_name for k in dir(cls)
                   if not k.startswith("_") and
                   isinstance(getattr(cls, k), str))


def SubsequenceInput(input: LayerOutput) -> LayerOutput:
    """DEPRECATED in the reference (layers.py:3925) and here: nested
    sub-sequence inputs to recurrent_group are detected from the layer's
    own input_type, so this marker is an identity passthrough."""
    return input


def layer_support(*attrs):
    """Parity decorator (layers.py:388). The reference uses it to validate
    ExtraLayerAttribute support per layer; Program-IR layers take plain
    keyword attrs, so this wraps the function unchanged."""
    def decorator(method):
        return method
    return decorator


class BeamInput:
    """One beam for cross_entropy_over_beam (layers.py:6206): candidate
    scores over the beam, the selected candidate ids, and the gold index."""

    def __init__(self, candidate_scores: LayerOutput,
                 selected_candidates: LayerOutput, gold: LayerOutput):
        self.candidate_scores = candidate_scores
        self.selected_candidates = selected_candidates
        self.gold = gold


def recurrent_layer(input: LayerOutput, act: Optional[str] = None,
                    bias_attr: bool = True,
                    reverse: bool = False) -> LayerOutput:
    """Simple (Elman) full-matrix recurrence over a sequence
    (layers.py:3846 recurrent_layer; gserver/layers/RecurrentLayer.cpp):
    h_t = act(x_t + h_{t-1} @ U + b). As in the reference, the input is
    NOT projected — its width is the state width; compose with fc/mixed
    for the input transform. Runs as one masked loop over time."""
    b = default_main_program().current_block()
    size = _shape(input)[-1]
    u = FL._create_parameter("rnn_u", (size, size), "float32",
                             I.uniform(-0.08, 0.08))
    ins = {"X": [input.var.name], "Lengths": [input.lengths.name],
           "U": [u.name]}
    if bias_attr:
        bias = FL._create_parameter("rnn_b", (size,), "float32", I.zeros)
        ins["B"] = [bias.name]
    out = b.create_var(shape=input.var.shape, dtype="float32")
    last = b.create_var(shape=(-1, size), dtype="float32")
    b.append_op("simple_rnn", ins,
                {"Out": [out.name], "LastH": [last.name]},
                {"act": act or "tanh", "reverse": reverse})
    return LayerOutput(out, input.lengths, input.input_type)


def warp_ctc_layer(input: LayerOutput, label: LayerOutput, size: int,
                   blank: int = 0,
                   norm_by_times: bool = False) -> LayerOutput:
    """warp_ctc_layer (layers.py WarpCTCLayer): the reference keeps two CTC
    backends (CTCLayer and Baidu's warp-ctc) with identical loss semantics;
    here one implementation serves both names. ``norm_by_times`` is
    accepted for signature parity — the returned loss is already
    batch-mean-normalized, matching the trainer's use."""
    return ctc_layer(input, label, size, blank=blank)


# name-parity aliases (the reference exports these spellings in __all__)
convex_comb_layer = linear_comb_layer
cross_entropy = cross_entropy_cost
cross_entropy_with_selfnorm = cross_entropy_with_selfnorm_cost
multi_binary_label_cross_entropy = multi_binary_label_cross_entropy_cost
hsigmoid = hsigmoid_layer
data_layer = data
embedding_layer = embedding
fc_layer = fc
pooling_layer = pooling
img_conv_layer = img_conv
img_pool_layer = img_pool
img_pool3d_layer = img_pool3d
img_conv3d_layer = img_conv3d
concat_layer = concat
dropout_layer = dropout
context_projection = context_projection_layer
maxid_layer = max_id_layer
printer_layer = print_layer
# gru_step_naive_layer (layers.py:3713) differs from gru_step_layer only in
# dropping the fused-kernel constraint on gate layout; one gru_unit op
# serves both spellings
gru_step_naive_layer = gru_step_layer
