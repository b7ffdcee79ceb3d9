"""Activations (counterpart of ``paddlescience_tpu/arch/activation.py``).

Ported: every stateless activation of the JAX package (its ``_FUNCS``)
and ``Siren``, each an :class:`Activation` that carries the id and
parameter of its closed-form jet rule (``autodiff/jet.py::ACT_RULES``,
``csrc/jet_common.cuh::psci_act``), so the jet forward and the fused
segment kernels take every one of them. ``gelu`` is the tanh
approximation, ``jax.nn.gelu``'s default; ``leaky_relu`` has slope 0.01.
The parametric ``Stan`` and ``Swish`` are modules with a learnable
``beta``: their jet rule (``jet_derivs``) reads ``beta``, so they have no
id and the fused segment kernels do not take them; a net with one runs the
plain jet path, as the JAX package keeps them off its kernels
(``arch/mlp.py::_segment_act`` decides).
"""

from __future__ import annotations

import math
from typing import Callable, Union

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.autodiff import jet

__all__ = ["Activation", "Stan", "Swish", "Siren", "get_activation"]


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


class Stan(nn.Module):
    """Self-scalable tanh, tanh(x) * (1 + beta * x), with a learnable
    ``beta`` of ``out_features`` ones (the JAX ``Stan``)."""

    def __init__(self, out_features: int = 1):
        super().__init__()
        self.beta = nn.Parameter(torch.ones(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x) * (1 + self.beta * x)

    def jet_derivs(self, x: torch.Tensor):
        """(f, f', f'') at ``x``, differentiable in ``beta``."""
        t = torch.tanh(x)
        sp = 1 - t * t
        lin = 1 + self.beta * x
        return t * lin, sp * lin + t * self.beta, -2 * t * sp * lin + 2 * self.beta * sp


class Swish(nn.Module):
    """x * sigmoid(beta * x) with a learnable scalar ``beta`` (the JAX
    ``Swish``)."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = nn.Parameter(torch.tensor(float(beta)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.beta * x)

    def jet_derivs(self, x: torch.Tensor):
        """(f, f', f'') at ``x``, differentiable in ``beta``."""
        b = self.beta
        s = torch.sigmoid(b * x)
        s1 = s * (1 - s)
        s2 = s1 * (1 - 2 * s)
        return x * s, s + b * x * s1, 2 * b * s1 + b * b * x * s2


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

_CLASSES = {"stan": Stan, "swish": Swish, "siren": Siren}


def get_activation(act_name: str) -> Union[Activation, type]:
    """The :class:`Activation` of a stateless activation; the class itself
    for ``stan``, ``swish`` and ``siren``, which the caller instantiates."""
    name = act_name.lower()
    if name in _FUNCS:
        return _FUNCS[name]
    if name in _CLASSES:
        return _CLASSES[name]
    raise ValueError(f"act_name({act_name}) not found; available: {sorted(_FUNCS) + sorted(_CLASSES)}")
