"""infer() facade (python/paddle/v2/inference.py:111).

Field selection follows the reference Inference.infer: ``field`` may be one
name or a list drawn from {'value', 'prob', 'id'}; multiple fields return a
tuple in the requested order. 'value'/'prob' fetch the activation tensor;
'id' fetches integer outputs directly or the argmax of a float distribution
(the reference reads Arguments.ids, which its id-emitting layers populate).
Sequence outputs (a lengths-carrying LayerOutput) come back as a list of
per-sample arrays trimmed to their true lengths, the analog of the
reference's row-slicing by sequence start positions.

The counterpart of ``paddle_tpu/v2/inference.py``. JAX's ``infer`` runs the
whole training program, optimizer ops included, so each call also takes a
training step (ROADMAP C.9). The port runs the program pruned to the
fetched layers and their lengths (``Program.prune``): forward only, every
parameter left as it was, on the trainer's executor.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np

from .layer import LayerOutput
from .trainer import SGD, _V2Feeder

_FIELDS = ("value", "prob", "id")


def _select(field: str, out: np.ndarray):
    if field not in _FIELDS:
        raise ValueError(f"field must be one of {_FIELDS}, got {field!r}")
    if field == "id" and not np.issubdtype(out.dtype, np.integer):
        out = np.argmax(out, axis=-1).astype(np.int32)
    return out


def _forward_program(trainer: SGD, fetch_vars):
    """The main program pruned to ``fetch_vars``, one per (program,
    version, fetch) so the executor's graphs are reused from call to
    call."""
    from ..fluid.framework import default_main_program
    main = default_main_program()
    names = tuple(v.name for v in fetch_vars)
    key = (main._serial, main.version, names)
    prog = trainer._forward.get(key)
    if prog is None:
        prog = trainer._forward[key] = main.prune(list(names))
    return prog


def infer(output_layer: Union[LayerOutput, Sequence[LayerOutput]],
          trainer: SGD, input,
          feeding: Optional[Sequence[LayerOutput]] = None,
          field: Union[str, Sequence[str]] = "value"):
    """Run the trained program forward and fetch ``output_layer`` for a batch
    of raw rows (same reader-row format as training).

    Returns one result per (layer, field) pair, flattened in layer-major
    order like the reference; a single pair returns the bare result.
    """
    layers = ([output_layer] if isinstance(output_layer, LayerOutput)
              else list(output_layer))
    fields = [field] if isinstance(field, str) else list(field)
    for f in fields:                         # fail fast, before device work
        if f not in _FIELDS:
            raise ValueError(f"field must be one of {_FIELDS}, got {f!r}")
    feed = (_V2Feeder(feeding, trainer.exe.device)(input) if feeding
            else input)

    fetch_vars = [l.var for l in layers]
    len_idx = {}
    for i, l in enumerate(layers):
        if l.lengths is not None:
            len_idx[i] = len(fetch_vars)
            fetch_vars.append(l.lengths)
    outs = trainer.exe.run(_forward_program(trainer, fetch_vars), feed=feed,
                           fetch_list=fetch_vars)

    results = []
    for i, l in enumerate(layers):
        raw = np.asarray(outs[i])
        for f in fields:
            sel = _select(f, raw)
            if i in len_idx:
                lens = np.asarray(outs[len_idx[i]]).astype(np.int64)
                sel = [sel[b, : lens[b]] for b in range(sel.shape[0])]
            results.append(sel)
    return results[0] if len(results) == 1 else tuple(results)
