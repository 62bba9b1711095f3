"""Device placement — the counterpart of ``paddle_tpu/core/place.py``.

The port runs on the card. ``default_device()`` is ``cuda`` whether or not
a card is present: code that allocates on it then fails where there is
none, instead of quietly carrying on on the CPU. The CPU is used only when
a caller names it (the parity tests do).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the card; anything else as given. A bare ``cuda`` gets
    the current card's index, so it compares equal to a tensor's device."""
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
