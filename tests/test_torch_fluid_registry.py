"""Every op of the port's fluid registry against the JAX package's, on the
CPU: the same op types, and for each op of ``tests/test_registry_sweep.py``
``SPECS`` the port's compute on the same numpy inputs and attrs equals
JAX's, slot by slot (atol 1e-5 and rtol 1e-5: f32 on both sides, the
summation order only). Random ops draw from the port's own generators,
so they are held to JAX's shapes and dtypes and to finite values."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.fluid.registry import OpRegistry as JRegistry
from paddle_tpu_torch.fluid.registry import RANDOM_OPS, OpRegistry
from test_registry_sweep import SPECS

ATOL = RTOL = 1e-5


def test_the_same_op_types_are_registered():
    assert OpRegistry.registered() == JRegistry.registered()


def _torch(v):
    return torch.tensor(np.asarray(v))


@pytest.mark.parametrize("op_type", sorted(SPECS))
def test_op_matches_jax(op_type):
    spec = SPECS[op_type]
    attrs = dict(spec.get("attrs", {}))
    want = JRegistry.get(op_type)(
        {k: [jnp.asarray(v) for v in vs] for k, vs in spec["ins"].items()},
        dict(attrs))
    got = OpRegistry.get(op_type)(
        {k: [_torch(v) for v in vs] for k, vs in spec["ins"].items()},
        dict(attrs))
    assert set(got) == set(want), op_type
    for key in want:
        assert len(got[key]) == len(want[key]), (op_type, key)
        for g, w in zip(got[key], want[key]):
            w = np.asarray(w)
            g = g.detach().numpy() if isinstance(g, torch.Tensor) \
                else np.asarray(g)
            assert g.shape == w.shape, (op_type, key, g.shape, w.shape)
            if op_type in RANDOM_OPS and not attrs.get("is_test", False):
                if np.issubdtype(w.dtype, np.floating):
                    assert np.isfinite(g).all(), (op_type, key)
                continue
            if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
                np.testing.assert_array_equal(g.astype(w.dtype), w,
                                              err_msg=f"{op_type}.{key}")
            else:
                np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{op_type}.{key}")
