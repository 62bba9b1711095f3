"""v2 evaluator DSL (trainer_config_helpers/evaluators.py analog).

The reference attaches evaluators inside the model config
(classification_error_evaluator:211, auc_evaluator:263, sum_evaluator:519,
value_printer:576 ...); each becomes part of the proto and is computed by
the C++ Evaluator zoo every batch. Here each ``*_evaluator`` call emits the
metric as in-graph ops and returns a LayerOutput — pass it to
``SGD(..., extra_layers=[...])`` and the per-batch value arrives in the
EndIteration event's metrics dict (one fused computation with the train
step, no second forward).

Host-side streaming accumulation across batches (AUC histograms, chunk F1,
detection mAP, CTC error) lives in :mod:`paddle_tpu.trainer.evaluator`;
these in-graph evaluators are the per-batch config-DSL surface.
"""

from __future__ import annotations

from typing import Optional

from ..fluid import layers as FL
from .layer import LayerOutput, _emit, _shape


def classification_error_evaluator(input: LayerOutput,
                                   label: LayerOutput) -> LayerOutput:
    """Per-batch error rate 1 - accuracy (evaluators.py:211). The metric
    arrives in EndIteration.metrics keyed by the returned layer's var name."""
    acc = FL.accuracy(input.var, label.var)
    err = _emit("scale", {"X": [acc.name]}, {"scale": -1.0, "bias": 1.0},
                out_shape=())
    return LayerOutput(err)


def auc_evaluator(input: LayerOutput, label: LayerOutput,
                  num_thresholds: int = 200,
                  positive_label: int = 1) -> LayerOutput:
    """Per-batch AUC (evaluators.py:263). ``input`` may be [B, C] logits
    (the positive-class softmax probability is extracted) or already-[B]
    positive scores."""
    var = input.var
    shp = _shape(input)
    if len(shp) >= 2 and shp[-1] != 1:
        probs = _emit("softmax", {"X": [var.name]}, out_shape=shp)
        col = _emit("crop", {"X": [probs.name]},
                    {"offsets": [0, positive_label], "shape": [-1, 1]},
                    out_shape=shp[:-1] + (1,))
        var = _emit("squeeze", {"X": [col.name]}, {"axis": -1},
                    out_shape=shp[:-1])
    elif len(shp) >= 2:           # [B, 1] scores: drop the unit column too
        var = _emit("squeeze", {"X": [var.name]}, {"axis": -1},
                    out_shape=shp[:-1])
    v = FL.auc(var, label.var, num_thresholds=num_thresholds)
    return LayerOutput(v)


def sum_evaluator(input: LayerOutput) -> LayerOutput:
    """Sum of the input over the batch (evaluators.py:519)."""
    v = _emit("reduce_sum", {"X": [input.var.name]}, {"dim": None},
              out_shape=())
    return LayerOutput(v)


def column_sum_evaluator(input: LayerOutput) -> LayerOutput:
    """Per-column sums (evaluators.py:545)."""
    v = _emit("reduce_sum", {"X": [input.var.name]}, {"dim": 0},
              out_shape=_shape(input)[1:])
    return LayerOutput(v)


def precision_recall_evaluator(input: LayerOutput, label: LayerOutput,
                               positive_label: int = 1) -> LayerOutput:
    """Per-batch F1 for one positive class (evaluators.py:340's role; the
    streaming multi-class version is trainer.PrecisionRecallEvaluator).
    Lowers to the registry's ``binary_f1`` op (built on
    ops/metrics.precision_recall_counts)."""
    v = _emit("binary_f1",
              {"X": [input.var.name], "Label": [label.var.name]},
              {"positive_label": positive_label}, out_shape=())
    return LayerOutput(v)


def value_printer_evaluator(input: LayerOutput,
                            head: int = 8) -> LayerOutput:
    """Printer evaluator (evaluators.py:576): surfaces the first values of a
    layer as a fetchable metric vector (host logging decides formatting)."""
    shp = _shape(input)
    known = all(d and d > 0 for d in shp[1:])   # batch dim may be dynamic
    if known and len(shp) >= 1:
        # static bound on the slice: never larger than one sample row
        per_row = 1
        for d in shp[1:]:
            per_row *= d
        head = min(head, max(per_row, 1))
    flat = _emit("reshape", {"X": [input.var.name]}, {"shape": (-1,)},
                 out_shape=(-1,))
    # the flattened batch can still be shorter than `head` at runtime (tiny
    # batch, dynamic row size): pad up to `head` so the crop never reads
    # out of bounds
    padded = _emit("pad", {"X": [flat.name]}, {"paddings": [[0, head]]},
                   out_shape=(-1,))
    v = _emit("crop", {"X": [padded.name]}, {"offsets": [0], "shape": [head]},
              out_shape=(head,))
    return LayerOutput(v)


def maxid_printer_evaluator(input: LayerOutput) -> LayerOutput:
    """Printer of argmax ids (evaluators.py:622)."""
    v = _emit("argmax", {"X": [input.var.name]},
              out_shape=_shape(input)[:-1], out_dtype="int32")
    return LayerOutput(v)
