"""The port's one rule for devices: CUDA unless the caller asks otherwise."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and no card
    is visible.  Nothing falls back to the CPU on its own: a CPU run is asked
    for by passing ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU")
    return dev
