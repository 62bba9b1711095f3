"""The package surfaces of the port against the JAX package's: each
subpackage's ``__all__`` holds JAX's names, but for the exceptions listed
here with their reasons, and each exported name resolves."""

import importlib

import pytest

#: per module: JAX name -> the port's name in its place (None: no
#: counterpart yet), with the reason
RENAMED = {
    "": {"TPUPlace": "CUDAPlace",       # the card's place
         "enable_compile_cache": None,   # no XLA compile cache to point at
         "COMPILE_CACHE_ENV": None},     # (init refuses compile_cache_dir)
    ".core": {"TPUPlace": "CUDAPlace"},
    ".nn": {},
    ".trainer": {"ElasticMaster": None,  # the elastic plane, ROADMAP A.8
                 "ElasticWorker": None},
    ".utils": {},
    ".obs": {},
    ".ops": {"pallas_kernels": "cuda_kernels"},
    ".analysis": {},
    ".v2": {},
    ".parallel": {},
}


@pytest.mark.parametrize("mod", sorted(RENAMED))
def test_all_holds_jax_names(mod):
    jax_mod = importlib.import_module("paddle_tpu" + mod)
    port = importlib.import_module("paddle_tpu_torch" + mod)
    want = set()
    for name in jax_mod.__all__:
        name = RENAMED[mod].get(name, name)
        if name is not None:
            want.add(name)
    missing = want - set(port.__all__)
    assert not missing, (mod, sorted(missing))
    for name in port.__all__:
        assert hasattr(port, name), (mod, name)


def test_places_resolve_to_torch_devices():
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import fluid

    assert pt.CPUPlace().device() == torch.device("cpu")
    assert pt.CUDAPlace(1).device() == torch.device("cuda", 1)
    assert pt.core.default_place() == pt.CUDAPlace(0)
    assert fluid.Executor(place=pt.CPUPlace()).device == torch.device("cpu")
    assert pt.core.DeviceContext(pt.CPUPlace()).device().type == "cpu"


def test_init_records_flags_and_refuses_a_compile_cache():
    import paddle_tpu_torch as pt

    assert pt.init(use_gpu=True)["use_gpu"] is True
    with pytest.raises(ValueError, match="no XLA"):
        pt.init(compile_cache_dir="/nonexistent")


def test_import_builds_nothing():
    """Importing the package leaves the kernel library unbuilt (it is
    compiled at the first launch)."""
    import subprocess
    import sys
    code = ("import paddle_tpu_torch, sys; "
            "from paddle_tpu_torch.ops import _build; "
            "print(_build._loaded is None, "
            "any(m == 'jax' or m.startswith(('jax.', 'paddle_tpu.')) "
            "for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["True", "False"]
