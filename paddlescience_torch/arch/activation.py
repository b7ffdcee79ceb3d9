"""Activations (counterpart of ``paddlescience_tpu/arch/activation.py``).

Ported: every stateless activation of the JAX package (its ``_FUNCS``)
and ``Siren``, each an :class:`Activation` that carries the id and
parameter of its closed-form jet rule (``autodiff/jet.py::ACT_RULES``,
``csrc/jet_common.cuh::psci_act``), so the jet forward and the fused
segment kernels take every one of them. ``gelu`` is the tanh
approximation, ``jax.nn.gelu``'s default; ``leaky_relu`` has slope 0.01.
The parametric Stan and Swish are not ported yet (the JAX package keeps
them off its fused kernels too).
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch
import torch.nn.functional as F

from paddlescience_torch.autodiff import jet

__all__ = ["Activation", "Siren", "get_activation"]


class Activation:
    """A stateless activation: ``fn`` and the id and parameter of its jet
    rule (``jet_act``)."""

    __slots__ = ("name", "fn", "jet_act")

    def __init__(self, name: str, fn: Callable, act_id: int, param: float = 0.0):
        self.name = name
        self.fn = fn
        self.jet_act = (act_id, float(param))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)

    def __repr__(self):
        return f"Activation({self.name})"


class Siren(Activation):
    """sin(w0 * x) with the SIREN init scheme (JAX ``Siren``)."""

    def __init__(self, w0: float = 30.0):
        super().__init__("siren", lambda x: torch.sin(w0 * x), jet.SIREN, w0)

    @staticmethod
    @torch.no_grad()
    def first_layer_init(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """U(-1/fan_in, 1/fan_in), fan_in = shape[-2]."""
        bound = 1.0 / tensor.shape[-2]
        return tensor.uniform_(-bound, bound, generator=generator)

    @staticmethod
    def hidden_layer_init(w0: float = 30.0) -> Callable:
        """U(-b, b), b = sqrt(6 / fan_in) / w0."""

        @torch.no_grad()
        def init(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
            bound = math.sqrt(6.0 / tensor.shape[-2]) / w0
            return tensor.uniform_(-bound, bound, generator=generator)

        return init


def _identity(x):
    return x


_FUNCS = {
    "elu": Activation("elu", F.elu, jet.ELU),
    "relu": Activation("relu", torch.relu, jet.RELU),
    "relu6": Activation("relu6", F.relu6, jet.RELU6),
    "selu": Activation("selu", F.selu, jet.SELU),
    "gelu": Activation("gelu", lambda x: F.gelu(x, approximate="tanh"), jet.GELU),
    "leaky_relu": Activation("leaky_relu", lambda x: F.leaky_relu(x, jet.LEAKY_SLOPE), jet.LEAKY_RELU),
    "sigmoid": Activation("sigmoid", torch.sigmoid, jet.SIGMOID),
    "silu": Activation("silu", F.silu, jet.SILU),
    "sin": Activation("sin", torch.sin, jet.SIN),
    "cos": Activation("cos", torch.cos, jet.COS),
    "tanh": Activation("tanh", torch.tanh, jet.TANH),
    "identity": Activation("identity", _identity, jet.IDENTITY),
    "linear": Activation("linear", _identity, jet.IDENTITY),
    "softplus": Activation("softplus", lambda x: torch.logaddexp(x, torch.zeros_like(x)), jet.SOFTPLUS),
    "mish": Activation("mish", lambda x: x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x))), jet.MISH),
}

_CLASSES = {"siren": Siren}


def get_activation(act_name: str) -> Union[Activation, type]:
    """The :class:`Activation` of a stateless activation; the class itself
    for ``siren``, which the caller instantiates."""
    name = act_name.lower()
    if name in _FUNCS:
        return _FUNCS[name]
    if name in _CLASSES:
        return _CLASSES[name]
    raise ValueError(f"act_name({act_name}) not found; available: {sorted(_FUNCS) + sorted(_CLASSES)}")
