"""v2-style user API — the reference's ``paddle.v2`` facade, the port's
copy of ``paddle_tpu/v2``. ``SGD`` runs on the card unless given
``device="cpu"``.

Reference surface (python/paddle/v2/: trainer.py:24 SGD, layer.py, topology,
parameters.py, inference.py:111 infer, event.py, minibatch batch). Design:
unlike the reference — which kept two engines (gserver behind SWIG for v2,
the op framework for fluid) — this facade is a SECOND FRONT END over the same
fluid Program IR (the convergence the reference's refactorization doc aimed
for, doc/design/refactorization.md): ``v2.layer.*`` emit ops into a fluid
Program, and ``v2.trainer.SGD`` drives the fluid Executor.
"""

from .. import data as _data
from ..data import dataset
from ..trainer import event
from . import attr, data_type, evaluator, layer, networks, optimizer, topology
from .topology import Topology
from .inference import infer
from .parameters import Parameters
from .trainer import SGD

batch = _data.batch
reader = _data.reader

_initialized = {}


def init(**kwargs):
    """paddle.init analog: capture runtime flags (use_gpu etc.)."""
    _initialized.update(kwargs)
    return _initialized


__all__ = ["init", "layer", "networks", "data_type", "optimizer", "event",
           "evaluator", "attr", "dataset", "topology", "Topology",
           "batch", "reader", "SGD", "Parameters", "infer"]
