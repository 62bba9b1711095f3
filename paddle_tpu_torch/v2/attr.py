"""Parameter / layer attributes — the ``paddle.v2.attr`` facade.

Reference surface: ``trainer_config_helpers/attrs.py`` ParameterAttribute
(:52 — name, is_static, initial_std/mean/max/min, l2_rate, learning_rate,
sparse_update) and ExtraLayerAttribute (:183 — drop_rate), re-exported by
``python/paddle/v2/attr.py``. The mapping: attrs lower to
fluid-parameter settings at layer-build time — an exact ``name`` makes a
SECOND layer reuse the SAME parameter variable (the reference's name-based
weight sharing, e.g. between a training decoder and its generation
sub-model), ``is_static`` freezes it (no grad/update), and
``l2_rate``/``learning_rate`` ride the Program as per-variable fields that
``fluid.optimizer`` consumes.
"""

from __future__ import annotations

from typing import Optional

from ..nn import initializer as I


class ParameterAttribute:
    def __init__(self, name: Optional[str] = None, is_static: bool = False,
                 initial_std: Optional[float] = None,
                 initial_mean: Optional[float] = None,
                 initial_max: Optional[float] = None,
                 initial_min: Optional[float] = None,
                 l2_rate: Optional[float] = None,
                 learning_rate: Optional[float] = None,
                 sparse_update: bool = False):
        self.name = name
        self.is_static = is_static
        self.initial_std = initial_std
        self.initial_mean = initial_mean
        self.initial_max = initial_max
        self.initial_min = initial_min
        self.l2_rate = l2_rate
        self.learning_rate = learning_rate
        # advisory: the sparse path is chosen by the data type (SelectedRows
        # flows through ShardedEmbedding); kept for config compatibility
        self.sparse_update = sparse_update

    def initializer(self) -> Optional[I.Initializer]:
        if self.initial_max is not None or self.initial_min is not None:
            lo = self.initial_min if self.initial_min is not None else 0.0
            hi = self.initial_max if self.initial_max is not None else 1.0
            return I.uniform(lo, hi)
        if self.initial_std is not None or self.initial_mean is not None:
            return I.normal(self.initial_mean or 0.0,
                            self.initial_std if self.initial_std is not None
                            else 0.01)
        return None

    def to_fluid(self) -> dict:
        """The dict fluid.layers._create_parameter(attr=...) consumes."""
        d: dict = {}
        if self.name is not None:
            d["name"] = self.name
        if self.is_static:
            d["is_static"] = True
        init = self.initializer()
        if init is not None:
            d["init"] = init
        if self.l2_rate is not None:
            d["l2_rate"] = self.l2_rate
        if self.learning_rate is not None:
            d["lr_scale"] = self.learning_rate
        return d


class ExtraLayerAttribute:
    """Per-layer extras (attrs.py:183); ``drop_rate`` is the one with
    behavior — layers that take ``layer_attr`` append dropout after their
    activation."""

    def __init__(self, drop_rate: Optional[float] = None):
        self.drop_rate = drop_rate


# the reference's short aliases (v2/attr.py __all__)
Param = ParameterAttribute
ParamAttr = ParameterAttribute
Extra = ExtraLayerAttribute
ExtraAttr = ExtraLayerAttribute

__all__ = ["ParameterAttribute", "ExtraLayerAttribute", "Param", "ParamAttr",
           "Extra", "ExtraAttr"]
