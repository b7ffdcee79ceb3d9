"""Named weight initializers (counterpart of
``paddlescience_tpu/utils/initializer.py``).

In-place, ``torch.nn.init`` style, each drawing from the
``torch.Generator`` it is given. Fans follow the JAX layout: a kernel is
(in, out), so ``fan_in = shape[-2]`` and ``fan_out = shape[-1]``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["glorot_normal_", "xavier_uniform_"]


def _fans(shape: Sequence[int]):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


@torch.no_grad()
def xavier_uniform_(tensor: torch.Tensor, generator: torch.Generator, gain: float = 1.0) -> torch.Tensor:
    """U(-b, b) with b = gain * sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = _fans(tensor.shape)
    bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
    return tensor.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def glorot_normal_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Truncated normal on [-2, 2] standard deviations, scaled so the
    variance is 1 / fan_avg (``jax.nn.initializers.glorot_normal``:
    stddev = sqrt(1 / fan_avg) / 0.87962566103423978)."""
    fan_in, fan_out = _fans(tensor.shape)
    std = math.sqrt(2.0 / (fan_in + fan_out)) / 0.87962566103423978
    # inverse-CDF sampling of the standard normal truncated to [-2, 2]
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    tensor.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
    tensor.erfinv_().mul_(math.sqrt(2.0) * std)
    return tensor.clamp_(-2.0 * std, 2.0 * std)
