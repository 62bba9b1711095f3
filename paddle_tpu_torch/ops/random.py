"""Random ops — the counterpart of ``paddle_tpu/ops/random.py``:
``dropout``, ``gaussian_random`` and ``uniform_random``.

JAX passes an explicit PRNG key; the port passes an explicit
``torch.Generator`` on the tensor's device. The two draw different bits,
so tests compare the keep rate and the scale, not the masks, and the
fills' moments and ranges, not their values.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.place import DeviceLike, require_device


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator], train: bool = True,
            scale_in_train: bool = True) -> torch.Tensor:
    """Zero each element with probability ``rate``; the kept ones are
    scaled by 1 / (1 - rate) (upscale in train). In eval (or at rate 0)
    x comes back as it is, or scaled by 1 - rate where the scale is not
    applied in train (downgrade in infer)."""
    if not train or rate <= 0.0:
        return x if scale_in_train else x * (1.0 - rate)
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep if scale_in_train else x,
                       x.new_zeros(()))


def gaussian_random(generator: Optional[torch.Generator], shape,
                    mean: float = 0.0, std: float = 1.0,
                    dtype: torch.dtype = torch.float32,
                    device: DeviceLike = None) -> torch.Tensor:
    """``mean + std * N(0, 1)`` of ``shape`` on ``device`` (default: the
    card; no card raises), drawn from ``generator`` (on that device)."""
    dev = require_device(device)
    return mean + std * torch.randn(tuple(shape), generator=generator,
                                    dtype=dtype, device=dev)


def uniform_random(generator: Optional[torch.Generator], shape,
                   low: float = -1.0, high: float = 1.0,
                   dtype: torch.dtype = torch.float32,
                   device: DeviceLike = None) -> torch.Tensor:
    """Uniform in [low, high) of ``shape`` on ``device`` (default: the
    card; no card raises), drawn from ``generator`` (on that device)."""
    dev = require_device(device)
    return low + (high - low) * torch.rand(tuple(shape), generator=generator,
                                           dtype=dtype, device=dev)
