"""Where the port's entry points run: the CUDA device unless the caller asks
for another. With no CUDA device and no device named they raise; nothing
falls back to the CPU quietly."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the current CUDA device.

    Raises ``RuntimeError`` when None is given and no CUDA device exists:
    pass ``device="cpu"`` to run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())
