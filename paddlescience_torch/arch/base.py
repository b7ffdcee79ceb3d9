"""Arch — base class for networks with dict-keyed inputs and outputs
(counterpart of ``paddlescience_tpu/arch/base.py``).

Every input and output key maps to a ``(N, k)`` tensor, usually an
``(N, 1)`` column; ``forward(x: Dict[str, Tensor]) -> Dict[str, Tensor]``.
``freeze``/``unfreeze`` mark a network's parameters fixed or trainable,
as the JAX package's ``Arch.freeze``.

``register_input_transform(fn)`` and ``register_output_transform(fn)``
set plain Python callables that every ``Arch`` applies around its
forward, here in ``Arch.__call__`` (the JAX package applies them in each
class's ``__call__``): ``fn_in(x) -> x'`` before the forward,
``fn_out(x_seen, y) -> y'`` after it. ``x_seen`` is what the JAX class
hands its output transform (:meth:`Arch._output_transform_inputs`): the
transformed inputs, except for ``ModifiedMLP``, which hands the inputs as
given, and the MLP and PirateNet, whose period embedding replaces the
embedded keys first. A transform is not a module and a checkpoint does
not hold it. A net with either transform has no jet forward
(``supports_jet`` is False), so it never reaches a fused segment: its
derivatives come from nested jvp of this ``__call__``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

__all__ = ["Arch"]


class Arch(nn.Module):
    input_keys: Tuple[str, ...]
    output_keys: Tuple[str, ...]
    _input_transform: Optional[Callable] = None
    _output_transform: Optional[Callable] = None

    def __call__(self, x: Dict[str, torch.Tensor], *args, **kwargs):
        t_in, t_out = self._input_transform, self._output_transform
        if t_in is None and t_out is None:
            return super().__call__(x, *args, **kwargs)
        x_in = t_in(x) if t_in is not None else x
        y = super().__call__(x_in, *args, **kwargs)
        if t_out is not None:
            y = t_out(self._output_transform_inputs(x, x_in), y)
        return y

    def _output_transform_inputs(self, x_given, x_transformed):
        """The inputs the output transform receives: the transformed ones
        (the JAX classes' default)."""
        return x_transformed

    def register_input_transform(self, transform: Optional[Callable[[Dict], Dict]]) -> None:
        """transform(input_dict) -> new_input_dict, applied before the forward."""
        self._input_transform = transform

    def register_output_transform(self, transform: Optional[Callable[[Dict, Dict], Dict]]) -> None:
        """transform(input_dict, output_dict) -> new_output_dict (a hard
        constraint, a renaming, a stream function), applied after the forward."""
        self._output_transform = transform

    @property
    def has_transform(self) -> bool:
        return self._input_transform is not None or self._output_transform is not None

    @staticmethod
    def concat_to_tensor(data_dict: Dict[str, torch.Tensor], keys: Sequence[str], axis: int = -1) -> torch.Tensor:
        if len(keys) == 1:
            return data_dict[keys[0]]
        return torch.cat([data_dict[key] for key in keys], dim=axis)

    @staticmethod
    def split_to_dict(data_tensor: torch.Tensor, keys: Sequence[str], axis: int = -1) -> Dict[str, torch.Tensor]:
        if len(keys) == 1:
            return {keys[0]: data_tensor}
        parts = torch.chunk(data_tensor, len(keys), dim=axis)
        return {key: parts[i] for i, key in enumerate(keys)}

    def supports_jet(self) -> bool:
        """Whether this arch provides ``forward_jet`` (a fused Taylor-jet
        forward, see ``autodiff/jet.py``)."""
        return False

    def freeze(self) -> None:
        """Fix every parameter: none requires a gradient, so an optimizer
        built afterwards leaves them out and the backward takes no gradient
        for them. (The JAX package zeroes a frozen network's updates after
        the optimizer's transform; with no update either way, the Adam
        moments it keeps for them are not observable.)"""
        self._frozen = True
        self.requires_grad_(False)

    def unfreeze(self) -> None:
        self._frozen = False
        self.requires_grad_(True)

    @property
    def frozen(self) -> bool:
        return getattr(self, "_frozen", False)
