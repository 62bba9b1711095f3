"""Topology — the ``paddle.v2.topology`` facade (v2/topology.py:27).

The reference's Topology wrapped the cost layer(s), validated the config,
and serialized the ModelConfig proto the gserver engine consumed. Here the
engine artifact is the fluid Program (JSON-serializable), so Topology wraps
the cost and exposes the same surface: ``proto()`` (the serialized model —
a Program dict), ``data_type()`` (ordered (name, InputType) feed slots),
``get_layer_proto(name)`` (a var's serialized desc), and
``serialize_for_inference(outputs)`` (the pruned forward program, the
merged-model role of Topology.serialize_for_inference).
"""

from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple, Union

from ..fluid.framework import default_main_program
from .layer import LayerOutput


class Topology:
    def __init__(self, cost: Union[LayerOutput, Sequence[LayerOutput]],
                 program=None):
        if isinstance(cost, LayerOutput):
            self.costs = [cost]
        elif isinstance(cost, (list, tuple)):
            self.costs = list(cost)
        else:
            raise ValueError("Topology expects LayerOutput cost(s), "
                             f"got {type(cost).__name__}")
        self.program = program or default_main_program()
        for c in self.costs:          # validation, as the reference's
            if not isinstance(c, LayerOutput):   # Topology.__init__ did
                raise ValueError("Topology expects LayerOutput cost(s), "
                                 f"got {type(c).__name__}")

    def proto(self) -> dict:
        """The serialized model config (Program dict; ModelConfig analog)."""
        return self.program.to_dict()

    def serialize(self) -> str:
        return json.dumps(self.proto())

    def data_type(self) -> List[Tuple[str, object]]:
        """Ordered (name, InputType-or-None) for every feed slot — the
        DataFeeder contract (reference Topology.data_type)."""
        out = []
        for blk in self.program.blocks:
            for v in blk.vars.values():
                if getattr(v, "is_data", False):
                    out.append((v.name, getattr(v, "input_type", None)))
        return out

    def get_layer_proto(self, name: str) -> Optional[dict]:
        for blk in self.program.blocks:
            if name in blk.vars:
                return blk.vars[name].to_dict()
        return None

    def serialize_for_inference(self,
                                outputs: Sequence[LayerOutput]) -> dict:
        """Pruned forward-only program reaching ``outputs`` (the
        merge-model/inference topology artifact)."""
        names = [o.var.name for o in outputs]
        return self.program.prune(names).to_dict()
