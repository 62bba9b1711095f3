"""Device placement — the counterpart of ``paddle_tpu/core/place.py``.

The port runs on the card. ``default_device()`` is ``cuda`` whether or not
a card is present: code that allocates on it then fails where there is
none, instead of quietly carrying on on the CPU. The CPU is used only when
a caller names it (the parity tests do).

JAX's ``Place`` names a platform and an index; here ``CUDAPlace`` takes
the place of ``TPUPlace``, and a place resolves to a ``torch.device``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class Place:
    """A logical device slot: platform ("cuda" or "cpu") + index."""

    platform: str
    index: int = 0

    def device(self) -> torch.device:
        if self.platform == "cpu":
            return torch.device("cpu")
        return torch.device(self.platform, self.index)


def CUDAPlace(index: int = 0) -> Place:
    return Place("cuda", index)


def CPUPlace(index: int = 0) -> Place:
    return Place("cpu", index)


def default_place() -> Place:
    """The card's place, whether or not a card is present (as
    :func:`default_device`)."""
    return Place(default_device().type, 0)


@dataclass
class DeviceContext:
    """Per-place execution context (ref: platform/device_context.h): the
    device binding and the numeric policy the ops compute with."""

    place: Place
    matmul_precision: str = "default"
    compute_dtype: Optional[str] = None  # e.g. "bfloat16"

    def device(self) -> torch.device:
        return self.place.device()


DeviceLike = Union[str, torch.device, Place, None]


def default_device() -> torch.device:
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the card; a :class:`Place` -> its device; anything else
    as given. A bare ``cuda`` gets the current card's index, so it compares
    equal to a tensor's device."""
    if isinstance(device, Place):
        device = device.device()
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def require_device(device: DeviceLike = None) -> torch.device:
    """``resolve_device`` that raises at once when the device is the card
    and there is none (an entry point then fails where it is built)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run on the "
                           "CPU")
    return dev
