"""v2 SGD trainer facade (python/paddle/v2/trainer.py:24-202) — the
counterpart of ``paddle_tpu/v2/trainer.py``.

Same event-driven reader loop as the reference's SGD.train, executing the
fluid Program the v2 layers emitted on one fluid ``Executor`` (one CUDA
graph a feed signature on the card). The goodput ledger of JAX's loop
waits for the obs plane (ROADMAP A.8).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np

from ..core.lod import SeqBatch
from ..data.feeder import DataFeeder
from ..fluid.executor import Executor, Scope
from ..fluid.framework import (default_main_program, default_startup_program)
from ..trainer import event as EV
from .layer import LayerOutput
from .parameters import Parameters


class _V2Feeder:
    """Map reader rows -> executor feed dict per the data layers' types.

    Sequence slots expand to (name, name__len__) feeds (the LoD pair), as
    tensors on ``device``."""

    def __init__(self, data_layers: Sequence[LayerOutput], device=None):
        self.layers = list(data_layers)
        self.feeder = DataFeeder([dl.input_type.slot for dl in self.layers],
                                 device=device)

    def __call__(self, rows) -> Dict[str, Any]:
        cols = self.feeder.feed(rows)
        feed: Dict[str, Any] = {}
        from ..core.lod import NestedSeqBatch
        for dl, col in zip(self.layers, cols):
            base = dl.var.name
            if isinstance(col, NestedSeqBatch):
                feed[base] = col.data
                feed[base + "__sublen__"] = col.sub_lengths
                feed[base + "__len__"] = col.seq_lengths
            elif isinstance(col, SeqBatch):
                feed[base] = col.data
                feed[base + "__len__"] = col.lengths
            elif isinstance(col, tuple):      # sparse (ids, vals)
                feed[base] = col[0]
                feed[base + "__vals__"] = col[1]
            else:
                feed[base] = col
        return feed


class SGD:
    """trainer.SGD(cost, parameters=None, update_equation=optimizer). The
    executor runs on the card unless ``device="cpu"`` (no card raises)."""

    def __init__(self, cost: LayerOutput, update_equation,
                 extra_layers: Optional[List[LayerOutput]] = None, *,
                 device=None):
        self.cost = cost
        self.extra = extra_layers or []
        self.exe = Executor(scope=Scope(), device=device)
        update_equation.fluid_opt.minimize(cost.var)
        self.exe.run(default_startup_program())
        self.parameters = Parameters(self.exe.scope, default_main_program(),
                                     device=self.exe.device)
        #: forward-only programs of ``infer`` by (program, fetch names)
        self._forward: Dict[tuple, object] = {}

    def train(self, reader: Callable[[], Iterable], *, num_passes: int = 1,
              event_handler: Optional[Callable] = None,
              feeding: Optional[Sequence[LayerOutput]] = None):
        """reader yields row-batches (use paddle_tpu.v2.batch); ``feeding``
        lists the data layers in row order."""
        event_handler = event_handler or (lambda e: None)
        feeder = (_V2Feeder(feeding, self.exe.device) if feeding
                  else None)
        fetches = [self.cost.var] + [e.var for e in self.extra]
        for pass_id in range(num_passes):
            event_handler(EV.BeginPass(pass_id))
            it = iter(reader())
            batch_id = 0
            while True:
                try:
                    rows = next(it)
                except StopIteration:
                    break
                # BeginIteration between the reader pull and the feed
                # conversion — exactly where the plain for-loop fired it
                event_handler(EV.BeginIteration(pass_id, batch_id))
                feed = feeder(rows) if feeder else rows
                outs = self.exe.run(feed=feed, fetch_list=fetches)
                metrics = {e.var.name: float(np.asarray(o).mean())
                           for e, o in zip(self.extra, outs[1:])}
                cost = float(outs[0])
                event_handler(EV.EndIteration(pass_id, batch_id,
                                              cost, None, metrics))
                self._maybe_param_stats(batch_id)
                batch_id += 1
            event_handler(EV.EndPass(pass_id))

    def _maybe_param_stats(self, batch_id: int):
        """--show_parameter_stats_period analog (TrainerInternal.cpp:80-87)
        over the fluid scope, gated by the global flag
        (PDTPU_SHOW_PARAMETER_STATS_PERIOD)."""
        from ..utils.flags import FLAGS
        from ..utils.logging import get_logger
        period = FLAGS.show_parameter_stats_period
        if not period or (batch_id + 1) % period:
            return
        log = get_logger(__name__)
        from ..fluid.framework import default_main_program
        for p in default_main_program().global_block().all_parameters():
            if not self.exe.scope.has(p.name):
                continue
            a = np.abs(self.parameters.get(p.name).astype(np.float32))
            log.info("param %-40s shape=%-16s absmax=%.4e absmean=%.4e",
                     p.name, str(tuple(a.shape)), float(a.max(initial=0.0)),
                     float(a.mean()) if a.size else 0.0)

    def test(self, reader, feeding: Optional[Sequence[LayerOutput]] = None):
        feeder = (_V2Feeder(feeding, self.exe.device) if feeding
                  else None)
        total, n = 0.0, 0
        for rows in reader():
            feed = feeder(rows) if feeder else rows
            c, = self.exe.run(feed=feed, fetch_list=[self.cost.var])
            total += float(c)
            n += 1
        return EV.TestResult(0, total / max(n, 1))
