"""Activations (counterpart of ``paddlescience_tpu/arch/activation.py``).

Ported: tanh, the activation of the ported archs, as the plain torch
function that the jet forward (``autodiff/jet.py``) and the fused segment
kernels recognise by identity. The other activations of the JAX package,
stateless and parametric (Stan, Swish, Siren), are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["get_activation"]


_FUNCS = {"tanh": torch.tanh}


def get_activation(act_name: str) -> Callable:
    name = act_name.lower()
    if name in _FUNCS:
        return _FUNCS[name]
    raise ValueError(f"act_name({act_name}) not found; available: {sorted(_FUNCS)}")
