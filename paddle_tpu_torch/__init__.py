"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

The JAX package (``paddle_tpu``) stays the reference; this package mirrors
its module names so each counterpart is easy to find, and replaces every
Pallas TPU kernel on its path with a CUDA kernel written for ``sm_90a``
(``paddle_tpu_torch/csrc``). It imports ``torch`` and numpy only — never
``jax`` and nothing of ``paddle_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; with no card they fail rather than fall back. Importing the
package builds nothing: the kernels are compiled at their first launch.

JAX's ``enable_compile_cache`` and ``COMPILE_CACHE_ENV`` have no
counterpart: the port compiles no XLA programs, and ``init`` refuses a
``compile_cache_dir``. The ``parallel`` subpackage waits for ROADMAP A.7.
"""

__version__ = "0.1.0"

from . import (analysis, core, data, faults, fluid, models, nn, obs, ops,
               optimizer, trainer, utils, v2)
from .core import (CPUPlace, CUDAPlace, Place, SeqBatch, default_device,
                   sequence_mask)
from .trainer import Trainer


def init(compile_cache_dir: str = None, **flags):
    """Process-level runtime init (the ``paddle.init`` analog): records
    the keyword flags through :func:`v2.init` and returns them. There is
    no XLA compile cache to point at a directory, so ``compile_cache_dir``
    raises."""
    if compile_cache_dir is not None:
        raise ValueError(
            "init(compile_cache_dir=...): the port compiles no XLA "
            "programs, so there is no compile cache to enable (its CUDA "
            "kernels are built once into paddle_tpu_torch/_build/)")
    return v2.init(**flags)


__all__ = ["analysis", "core", "data", "faults", "fluid", "nn", "obs", "ops",
           "optimizer", "trainer", "utils", "models", "v2", "Trainer",
           "Place", "CUDAPlace", "CPUPlace", "SeqBatch", "sequence_mask",
           "init", "default_device", "__version__"]
