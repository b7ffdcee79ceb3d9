"""DeepONet (counterpart of ``paddlescience_tpu/arch/deeponet.py``).

G(u)(y) = sum_k b_k(u) t_k(y) + b: a branch MLP maps the ``num_loc`` sensor
values of ``u`` to ``num_features`` coefficients b, a trunk MLP maps the
query point ``y`` to as many features t, with ``trunk_activation`` applied
to the trunk's output, and a trainable bias b (zeros) is added. Parameter
names follow the JAX module (``branch_net.*``, ``trunk_net.*``, ``b``), so
``utils/jax_params.py`` carries its weights key for key.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch
from torch import nn

from paddlescience_torch.arch import base, mlp
from paddlescience_torch.device import DeviceLike, resolve_device

__all__ = ["DeepONet"]


class DeepONet(base.Arch):
    """Deep operator network (Lu et al., Nat Mach Intell 2021), with the
    JAX signature. Parameters are drawn on the CPU from ``generator`` (seed
    0 when None), the branch's first, and moved to ``device`` (CUDA when
    None)."""

    def __init__(
        self,
        u_key: str,
        y_key: str,
        G_key: str,
        num_loc: int,
        num_features: int,
        branch_num_layers: Optional[int],
        trunk_num_layers: Optional[int],
        branch_hidden_size: Union[int, Sequence[int]],
        trunk_hidden_size: Union[int, Sequence[int]],
        branch_skip_connection: bool = False,
        trunk_skip_connection: bool = False,
        branch_activation: str = "tanh",
        trunk_activation: str = "tanh",
        branch_weight_norm: bool = False,
        trunk_weight_norm: bool = False,
        use_bias: bool = True,
        *,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.u_key, self.y_key, self.G_key = u_key, y_key, G_key
        self.input_keys = (u_key, y_key)
        self.output_keys = (G_key,)
        self.branch_net = mlp.MLP((u_key,), ("b",), branch_num_layers, branch_hidden_size, branch_activation,
                                  branch_skip_connection, branch_weight_norm, input_dim=num_loc,
                                  output_dim=num_features, generator=generator, device="cpu")
        self.trunk_net = mlp.MLP((y_key,), ("t",), trunk_num_layers, trunk_hidden_size, trunk_activation,
                                 trunk_skip_connection, trunk_weight_norm, input_dim=1, output_dim=num_features,
                                 generator=generator, device="cpu")
        self.trunk_act = mlp._make_act(trunk_activation, num_features)
        self.use_bias = use_bias
        if use_bias:
            self.b = nn.Parameter(torch.zeros(1))
        self.to(device)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        u_features = self.branch_net({self.u_key: x[self.u_key]})["b"]
        y_features = self.trunk_act(self.trunk_net({self.y_key: x[self.y_key]})["t"])
        G_u = torch.sum(u_features * y_features, dim=-1, keepdim=True)
        if self.use_bias:
            G_u = G_u + self.b
        return {self.G_key: G_u}
