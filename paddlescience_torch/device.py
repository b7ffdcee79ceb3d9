"""Device resolution for the port's entry points.

The port targets one NVIDIA GPU. Every entry point that allocates tensors
takes a ``device`` argument; ``None`` means the current CUDA device. A call
without a device on a machine with no CUDA raises instead of dropping to
the CPU, so a CPU run is always one that the caller asked for
(``device="cpu"``, as the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """Return ``torch.device(device)``, or ``cuda`` when ``device`` is None.

    Raises ``RuntimeError`` when ``device`` is None and CUDA is unavailable.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddlescience_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly"
        )
    return torch.device("cuda", torch.cuda.current_device())
