"""The reference's 115 layer-DSL names (``tests/test_v2_import_parity.py``
``REFERENCE_ALL``) import from ``paddle_tpu_torch.v2.layer`` as they do
from ``paddle_tpu.v2.layer``: the same kind of object under each name,
and the DSL's enums with JAX's values. ``recurrent_layer`` runs on the
CPU and equals JAX's from the same weights."""

import inspect

import numpy as np
import pytest

import paddle_tpu.v2.layer as JL
import paddle_tpu_torch.v2.layer as TL
from test_v2_import_parity import REFERENCE_ALL
from torch_fluid_common import Pair


def _kind(obj):
    if inspect.isclass(obj):
        return "class"
    return "callable" if callable(obj) else type(obj).__name__


@pytest.mark.parametrize("name", REFERENCE_ALL)
def test_reference_name_importable(name):
    assert getattr(TL, name, None) is not None, name
    assert _kind(getattr(TL, name)) == _kind(getattr(JL, name)), name


def test_enum_values_equal_jax():
    for enum in ("AggregateLevel", "ExpandLevel"):
        j, t = getattr(JL, enum), getattr(TL, enum)
        names = [n for n in vars(j) if n.isupper()]
        assert names and {n: getattr(t, n) for n in names} == \
            {n: getattr(j, n) for n in names}
    assert TL.LayerType.is_layer_type("fc")
    assert not TL.LayerType.is_layer_type("no_such_layer")
    gi = TL.GeneratedInput(size=7, embedding_size=4)
    assert isinstance(gi, TL.BaseGeneratedInput)
    assert gi.bos_id is None and gi.eos_id is None


def test_recurrent_layer_equals_jax():
    import paddle_tpu.fluid as jfluid
    import paddle_tpu.v2 as jv2
    import paddle_tpu_torch.v2 as tv2

    def build(fl):
        v2 = jv2 if fl is jfluid else tv2
        x = v2.layer.data("x", v2.data_type.dense_vector_sequence(5))
        return v2.layer.recurrent_layer(x)

    p = Pair(build)
    xs = np.random.RandomState(0).randn(2, 4, 5).astype(np.float32)
    j, t = p.run({"x": xs, "x__len__": np.array([4, 2], np.int32)},
                 [p.tout.var.name])
    assert t[0].shape == (2, 4, 5)
    np.testing.assert_allclose(t[0], j[0], atol=1e-5, rtol=1e-5)
