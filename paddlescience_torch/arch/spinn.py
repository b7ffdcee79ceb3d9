"""SPINN, the separable physics-informed network (counterpart of
``paddlescience_tpu/arch/spinn.py``; arXiv:2211.08761).

A d-dimensional field on a product grid is a sum of rank-one terms,
u(x_1, ..., x_d) = sum_r prod_i f_i^r(x_i): each input key has its own
branch net (a :class:`~paddlescience_torch.arch.mlp.ModifiedMLP` from one
coordinate to r features per output), evaluated on that axis's N_i
points, and the outer product over the axes gives the (N_1, ..., N_d, 1)
output, so an N^d grid costs O(N d) network evaluations. Its derivatives
come from the tape's grid stack (``autodiff/ad.py::_GridStack``): one
forward-mode derivative along each axis, which keeps that cost.
``branch_calls`` counts the branch-net evaluations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from paddlescience_torch.arch import base
from paddlescience_torch.arch.mlp import ModifiedMLP
from paddlescience_torch.device import DeviceLike, resolve_device

__all__ = ["SPINN"]


class SPINN(base.Arch):
    """Each input key takes its own (N_i, 1) coordinate column; the outputs
    are (N_1, ..., N_d, 1) over the product grid. The branch nets' weights
    come from one ``generator`` in input-key order, as the JAX class's
    ``Rngs``."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], r: int, num_layers: int,
                 hidden_size: Union[int, Tuple[int, ...]], activation: str = "tanh", skip_connection: bool = False,
                 weight_norm: bool = False, periods: Optional[Dict[str, Tuple[float, bool]]] = None,
                 fourier: Optional[Dict[str, Union[float, int]]] = None,
                 random_weight: Optional[Dict[str, float]] = None, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.r = r
        self.branch_nets = nn.ModuleList([
            ModifiedMLP((key,), ("f",), num_layers, hidden_size, activation, skip_connection, weight_norm,
                        output_dim=r * len(self.output_keys),
                        periods={key: periods[key]} if periods and key in periods else None, fourier=fourier,
                        random_weight=random_weight, generator=generator, device=device)
            for key in self.input_keys])
        self.branch_calls = 0

    @staticmethod
    def _tensor_contraction(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """[*N, C] x [*M, C] -> [*N, *M, C] by a broadcast outer product."""
        out_dim = x.ndim + y.ndim - 1
        x = x.reshape(x.shape[:-1] + (1,) * (out_dim - x.ndim) + (x.shape[-1],))
        y = y.reshape((1,) * (out_dim - y.ndim) + tuple(y.shape))
        return x * y

    def forward_tensor(self, *coords: torch.Tensor) -> List[torch.Tensor]:
        features = []
        for net, key, c in zip(self.branch_nets, self.input_keys, coords):
            self.branch_calls += 1
            features.append(net({key: c})["f"])  # (N_i, r * n_out)
        outputs = []
        for i in range(len(self.output_keys)):
            st, ed = i * self.r, (i + 1) * self.r
            out = features[0][:, st:ed]
            for f in features[1:]:
                out = self._tensor_contraction(out, f[:, st:ed])
            outputs.append(out.sum(dim=-1, keepdim=True))
        return outputs

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        outputs = self.forward_tensor(*(x[k] for k in self.input_keys))
        return dict(zip(self.output_keys, outputs))

    def supports_jet(self) -> bool:
        return False

    def jet_pallas_eligible(self) -> bool:
        return False

    def jet_segment_lengths(self) -> List[int]:
        return []
