"""Arch — base class for networks with dict-keyed inputs and outputs
(counterpart of ``paddlescience_tpu/arch/base.py``).

Every input and output key maps to a ``(N, k)`` tensor, usually an
``(N, 1)`` column; ``forward(x: Dict[str, Tensor]) -> Dict[str, Tensor]``.
``freeze``/``unfreeze`` mark a network's parameters fixed or trainable,
as the JAX package's ``Arch.freeze``. Input and output transforms are not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

__all__ = ["Arch"]


class Arch(nn.Module):
    input_keys: Tuple[str, ...]
    output_keys: Tuple[str, ...]

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
