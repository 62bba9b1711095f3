"""Prebuilt networks (trainer_config_helpers/networks.py analog):
simple_lstm:553, bidirectional_lstm:1230, text_conv_pool, simple_img_conv_pool:144,
vgg_16_network:468."""

from __future__ import annotations

from typing import Optional

from ..fluid import layers as FL
from ..fluid.framework import default_main_program
from ..nn import initializer as I
from . import layer as L
from .layer import LayerOutput


def simple_lstm(input: LayerOutput, size: int, reverse: bool = False) -> LayerOutput:
    """networks.py simple_lstm — the reference projects inputs to 4*size then
    runs lstmemory; our lstm op fuses that projection (one GEMM)."""
    return L.lstmemory(input, size, reverse=reverse)


def bidirectional_lstm(input: LayerOutput, size: int,
                       return_concat: bool = True) -> LayerOutput:
    fwd = L.lstmemory(input, size)
    bwd = L.lstmemory(input, size, reverse=True)
    last_f = L.last_seq(fwd)
    first_b = L.first_seq(bwd)
    return L.concat([last_f, first_b], axis=-1)


def text_conv_pool(input: LayerOutput, hidden_size: int,
                   context_len: int = 3) -> LayerOutput:
    """sequence conv + max pool (networks.py text_conv_pool)."""
    b = default_main_program().global_block()
    in_dim = input.var.shape[-1]
    filt = FL._create_parameter("seqconv_w", (context_len * in_dim, hidden_size),
                                "float32", I.uniform(-0.08, 0.08))
    out = b.create_var(shape=input.var.shape[:-1] + (hidden_size,),
                       dtype="float32")
    b.append_op("sequence_conv",
                {"X": [input.var.name], "Lengths": [input.lengths.name],
                 "Filter": [filt.name]},
                {"Out": [out.name]},
                {"context_start": -(context_len // 2),
                 "context_length": context_len})
    h = LayerOutput(FL.relu(out), input.lengths, input.input_type)
    return L.pooling(h, "max")


def simple_img_conv_pool(input: LayerOutput, filter_size: int,
                         num_filters: int, pool_size: int,
                         act: str = "relu") -> LayerOutput:
    conv = L.img_conv(input, num_filters, filter_size, act=act)
    return L.img_pool(conv, pool_size)


def vgg_16_network(input_image: LayerOutput, num_classes: int = 1000,
                   width_mult: float = 1.0) -> LayerOutput:
    """VGG-16 conv stack (networks.py vgg_16_network:468)."""
    cfg = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
    h = input_image
    for n, ch in cfg:
        ch = max(8, int(ch * width_mult))
        for _ in range(n):
            h = L.img_conv(h, ch, 3, padding=1, act="relu")
        h = L.img_pool(h, 2)
    h = LayerOutput(FL.pool2d(h.var, global_pooling=True))
    h = L.fc(h, 512, act="relu")
    h = L.fc(h, 512, act="relu")
    return L.fc(h, num_classes)


def simple_attention(encoded_sequence: LayerOutput,
                     encoded_proj: LayerOutput,
                     decoder_state: LayerOutput,
                     name: Optional[str] = None) -> LayerOutput:
    """Bahdanau-style attention context (networks.py:654 simple_attention).

    For use inside a recurrent_group / beam_search step: ``encoded_sequence``
    [B, T, H] and ``encoded_proj`` [B, T, A] come in as StaticInputs (with
    lengths); ``decoder_state`` is the current [B, S] memory. Returns the
    [B, H] context vector. The reference expands the decoder state over the
    sequence and runs sequence_softmax over the scores — identical math here,
    as fixed-shape masked ops.

    ``name`` fixes the internal parameter names (``<name>_dp_w``,
    ``<name>_v``) so a second call — e.g. the generation sub-model reusing a
    training decoder's attention — shares the SAME weights, the reference's
    name-based sharing in its networks.py helpers.
    """
    A = encoded_proj.var.shape[-1]
    # project decoder state to attention space: [B, A]
    dp = FL.fc(decoder_state.var, A, bias_attr=False,
               param_attr={"name": f"{name}_dp_w"} if name else None)
    dp3 = FL.reshape(dp, (-1, 1, A))
    summed = FL.elementwise_add(encoded_proj.var, dp3)     # broadcast over T
    e = FL.activation(summed, "tanh")
    # per-step score: contract the attention dim with a learned vector
    v = FL._create_parameter("att_v", (A, 1), "float32",
                             I.uniform(-0.1, 0.1),
                             attr={"name": f"{name}_v"} if name else None)
    scores3 = FL.matmul(e, v)                              # [B, T, 1]
    scores = FL.squeeze(scores3, -1)                       # [B, T]
    weights = FL.sequence_softmax(scores, encoded_sequence.lengths)
    w3 = FL.unsqueeze(weights, -1)                         # [B, T, 1]
    weighted = FL.elementwise_mul(encoded_sequence.var, w3)
    context = FL.reduce_sum(weighted, dim=1)               # [B, H]
    return LayerOutput(context)


def simple_gru(input: LayerOutput, size: int,
               reverse: bool = False) -> LayerOutput:
    """networks.py simple_gru / simple_gru2 — fused projection + GRU scan."""
    return L.grumemory(input, size, reverse=reverse)


def bidirectional_gru(input: LayerOutput, size: int) -> LayerOutput:
    """networks.py bidirectional_gru: concat(last fwd state, first bwd)."""
    fwd = L.grumemory(input, size)
    bwd = L.grumemory(input, size, reverse=True)
    return L.concat([L.last_seq(fwd), L.first_seq(bwd)], axis=-1)


def sequence_conv_pool(input: LayerOutput, context_len: int,
                       hidden_size: int,
                       pool_type: str = "max") -> LayerOutput:
    """networks.py sequence_conv_pool: context window FC + sequence pool."""
    proj = L.mixed_layer(
        size=hidden_size,
        input=[L.full_matrix_projection(
            L.mixed_layer(size=input.var.shape[-1] * context_len,
                          input=[L.context_projection_layer(
                              input, context_len)]),
            hidden_size)],
        act="relu")
    ctx = LayerOutput(proj.var, input.lengths, input.input_type)
    return L.pooling(ctx, pool_type)


def img_conv_group(input: LayerOutput, conv_filters,
                   pool_size: int = 2) -> LayerOutput:
    """networks.py img_conv_group: N conv+BN blocks then one pool (channel
    count inferred from the input)."""
    h = input
    for nf in conv_filters:
        h = L.img_conv(h, nf, 3, padding=1, act=None)
        h = L.batch_norm_layer(h, act="relu")
    return L.img_pool(h, pool_size)


def simple_attention_pool(encoded: LayerOutput,
                          hidden: int = 64) -> LayerOutput:
    """Self-attentive pooling: tanh hidden projection then a learned scalar
    query over encoder states — the building block behind networks.py
    simple_attention when used without a decoder state."""
    # projections handle the [B, T, D] rank (plain fc would flatten the time
    # dim into the feature dim)
    h = L.mixed_layer(size=hidden,
                      input=[L.full_matrix_projection(encoded, hidden)],
                      act="tanh")
    scores = L.mixed_layer(size=1, input=[L.full_matrix_projection(h, 1)])
    b = default_main_program().current_block()
    flat = b.create_var(shape=scores.var.shape[:-1], dtype="float32")
    b.append_op("squeeze", {"X": [scores.var.name]}, {"Out": [flat.name]},
                {"axis": -1})
    sm = b.create_var(shape=flat.shape, dtype="float32")
    b.append_op("sequence_softmax",
                {"X": [flat.name], "Lengths": [encoded.lengths.name]},
                {"Out": [sm.name]}, {})
    w3 = b.create_var(shape=tuple(sm.shape) + (1,), dtype="float32")
    b.append_op("unsqueeze", {"X": [sm.name]}, {"Out": [w3.name]},
                {"axis": -1})
    weighted = L.scaling_layer(encoded, LayerOutput(w3))
    return L.pooling(LayerOutput(weighted.var, encoded.lengths,
                                 encoded.input_type), "sum")
