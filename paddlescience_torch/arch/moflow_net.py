"""MoFlow, the normalizing flow over molecular graphs (counterpart of
``paddlescience_tpu/arch/moflow_net.py``).

* The bond flow is a Glow over each node's flattened adjacency features:
  ActNorm, an invertible feature mixing (:class:`_Inv1x1`) and an affine
  coupling a block.
* The atom flow (:class:`_GlowOnGraph`) is a stack of node-masked affine
  couplings whose scale and shift come from relational graph
  convolutions over the bond tensor, each after an ActNorm.
* Log-determinants are exact; :meth:`MoFlowNet.reverse` decodes the bonds
  first, then the atoms conditioned on them.

As in the JAX module, :class:`_Inv1x1` takes ``torch.linalg.slogdet`` of
its weight on every forward call and solves with its transpose on every
reverse call. Weights are (in, out) as in JAX (``nn/layers.py::Linear``);
parameter names follow the JAX module (``bond_flow.layers.1.w``,
``atom_flow.couplings.0.gc1.rel.2.weight``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch import base
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Linear

__all__ = ["MoFlowNet", "MoFlowProp"]


def _positions(x: torch.Tensor) -> int:
    """The number of positions a per-feature map acts on: the axes between
    the batch and the features."""
    return int(np.prod(x.shape[1:-1])) if x.ndim > 2 else 1


class _ActNorm(nn.Module):
    """(x + bias) exp(log_scale) per feature, with its exact log-det."""

    def __init__(self, dim: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor):
        y = (x + self.bias) * torch.exp(self.log_scale)
        logdet = torch.sum(self.log_scale) * _positions(x)
        return y, logdet.expand(x.shape[0])

    def reverse(self, y: torch.Tensor) -> torch.Tensor:
        return y * torch.exp(-self.log_scale) - self.bias


class _Inv1x1(nn.Module):
    """x @ w over the features, w started orthogonal (the QR of a normal
    draw)."""

    def __init__(self, dim: int, *, generator: torch.Generator):
        super().__init__()
        q, _ = torch.linalg.qr(torch.randn(dim, dim, generator=generator))
        self.w = nn.Parameter(q)

    def forward(self, x: torch.Tensor):
        logdet = torch.linalg.slogdet(self.w)[1] * _positions(x)
        return x @ self.w, logdet.expand(x.shape[0])

    def reverse(self, y: torch.Tensor) -> torch.Tensor:
        return torch.linalg.solve(self.w.T, y[..., None])[..., 0]


class _AffineCoupling(nn.Module):
    """x2' = x2 sigmoid(s(x1) + 2) + t(x1), the features split in halves."""

    def __init__(self, dim: int, hidden: int, *, generator: torch.Generator):
        super().__init__()
        half = dim // 2
        self.net1 = Linear(half, hidden, generator=generator)
        self.net2 = Linear(hidden, 2 * (dim - half), generator=generator)
        self.half = half

    def _st(self, x1: torch.Tensor):
        s, t = torch.chunk(self.net2(F.relu(self.net1(x1))), 2, dim=-1)
        return torch.sigmoid(s + 2.0), t

    def forward(self, x: torch.Tensor):
        x1, x2 = x[..., : self.half], x[..., self.half:]
        s, t = self._st(x1)
        logdet = torch.sum(torch.log(s), dim=tuple(range(1, x.ndim)))
        return torch.cat([x1, x2 * s + t], dim=-1), logdet

    def reverse(self, y: torch.Tensor) -> torch.Tensor:
        y1, y2 = y[..., : self.half], y[..., self.half:]
        s, t = self._st(y1)
        return torch.cat([y1, (y2 - t) / s], dim=-1)


class _Flow(nn.Module):
    """[ActNorm -> Inv1x1 -> AffineCoupling] x n_blocks."""

    def __init__(self, dim: int, hidden: int, n_blocks: int, *, generator: torch.Generator):
        super().__init__()
        layers = []
        for _ in range(n_blocks):
            layers += [_ActNorm(dim), _Inv1x1(dim, generator=generator), _AffineCoupling(dim, hidden,
                                                                                         generator=generator)]
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor):
        logdet = x.new_zeros(x.shape[0])
        for layer in self.layers:
            x, ld = layer(x)
            logdet = logdet + ld
        return x, logdet

    def reverse(self, z: torch.Tensor) -> torch.Tensor:
        for layer in reversed(self.layers):
            z = layer.reverse(z)
        return z


class _RelGraphConv(nn.Module):
    """Relational graph convolution: a self loop plus, per bond type, the
    degree-normalised adjacency times a linear map of the node features."""

    def __init__(self, in_dim: int, out_dim: int, n_rels: int, *, generator: torch.Generator):
        super().__init__()
        self.rel = nn.ModuleList(Linear(in_dim, out_dim, generator=generator) for _ in range(n_rels))
        self.self_w = Linear(in_dim, out_dim, generator=generator)
        self.n_rels = n_rels

    def forward(self, adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """adj (B, R, N, N), x (B, N, D)."""
        adj = adj / torch.clamp(torch.sum(adj, dim=-1, keepdim=True), min=1.0)
        out = self.self_w(x)
        for r in range(self.n_rels):
            out = out + adj[:, r] @ self.rel[r](x)
        return out


class _GraphAffineCoupling(nn.Module):
    """Node-masked affine coupling: the kept rows pass through, the others
    are scaled and shifted by graph convolutions over the kept ones."""

    def __init__(self, n_node: int, a_dim: int, b_dim: int, hidden: int, mask_row_start: int,
                 mask_row_stride: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.gc1 = _RelGraphConv(a_dim, hidden, b_dim, generator=g)
        self.gc2 = _RelGraphConv(hidden, hidden, b_dim, generator=g)
        self.s_lin = Linear(hidden, a_dim, generator=g)
        self.t_lin = Linear(hidden, a_dim, generator=g)
        mask = torch.zeros(n_node, 1)
        mask[mask_row_start::mask_row_stride] = 1.0  # the kept rows
        self.register_buffer("mask", mask, persistent=False)

    def _st(self, adj: torch.Tensor, x_kept: torch.Tensor):
        h = F.relu(self.gc2(adj, F.relu(self.gc1(adj, x_kept))))
        return torch.sigmoid(self.s_lin(h) + 2.0), self.t_lin(h)

    def forward(self, adj: torch.Tensor, x: torch.Tensor):
        xk = x * self.mask
        s, t = self._st(adj, xk)
        y = xk + (1.0 - self.mask) * (x * s + t)
        logdet = torch.sum(torch.log(s) * (1.0 - self.mask), dim=(1, 2))
        return y, logdet

    def reverse(self, adj: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        yk = y * self.mask
        s, t = self._st(adj, yk)
        return yk + (1.0 - self.mask) * ((y - t) / s)


class _GlowOnGraph(nn.Module):
    """Graph couplings with alternating node masks, each after an ActNorm."""

    def __init__(self, n_node: int, a_dim: int, b_dim: int, hidden: int, n_blocks: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.norms = nn.ModuleList(_ActNorm(a_dim) for _ in range(n_blocks))
        self.couplings = nn.ModuleList(
            _GraphAffineCoupling(n_node, a_dim, b_dim, hidden, mask_row_start=i % 2, mask_row_stride=2,
                                 generator=generator) for i in range(n_blocks))

    def forward(self, adj: torch.Tensor, x: torch.Tensor):
        logdet = x.new_zeros(x.shape[0])
        for norm, coup in zip(self.norms, self.couplings):
            x, ld1 = norm(x)
            x, ld2 = coup(adj, x)
            logdet = logdet + ld1 + ld2
        return x, logdet

    def reverse(self, adj: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        for norm, coup in zip(reversed(self.norms), reversed(self.couplings)):
            z = norm.reverse(coup.reverse(adj, z))
        return z


class MoFlowNet(base.Arch):
    """The flow over (bonds, atoms): inputs nodes (B, N, atom types) and
    edges (B, bond types, N, N); outputs the latent z = [z_x, z_adj] (B,
    N atom types + N bond types N) and the summed log-det (B,)."""

    def __init__(self, input_keys: Tuple[str, ...] = ("nodes", "edges"),
                 output_keys: Tuple[str, ...] = ("output", "sum_log_det"), b_n_type: int = 4, a_n_node: int = 9,
                 a_n_type: int = 5, b_hidden: int = 128, a_hidden: int = 128, b_n_blocks: int = 4,
                 a_n_blocks: int = 4, noise_scale: float = 0.6, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.n_node = a_n_node
        self.a_dim = a_n_type
        self.b_dim = b_n_type
        self.bond_flow = _Flow(b_n_type * a_n_node, b_hidden, b_n_blocks, generator=g)
        self.atom_flow = _GlowOnGraph(a_n_node, a_n_type, b_n_type, a_hidden, a_n_blocks, generator=g)
        self.to(device)

    @property
    def latent_dim(self) -> int:
        return self.n_node * self.a_dim + self.n_node * self.b_dim * self.n_node

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        nodes = x[self.input_keys[0]]
        edges = x[self.input_keys[1]]
        B, N = nodes.shape[0], nodes.shape[1]
        adj_feat = edges.transpose(1, 2).reshape(B, N, -1)  # (B, N, bond types N)
        z_adj, ld_adj = self.bond_flow(adj_feat)
        z_x, ld_x = self.atom_flow(edges, nodes)
        z = torch.cat([z_x.reshape(B, -1), z_adj.reshape(B, -1)], dim=-1)
        return {self.output_keys[0]: z, self.output_keys[1]: ld_adj + ld_x}

    def reverse(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """latent -> (nodes, edges): the bonds first, then the atoms on them."""
        B = z.shape[0]
        n_x = self.n_node * self.a_dim
        z_x = z[:, :n_x].reshape(B, self.n_node, self.a_dim)
        z_adj = z[:, n_x:].reshape(B, self.n_node, self.b_dim * self.n_node)
        adj_feat = self.bond_flow.reverse(z_adj)
        edges = adj_feat.reshape(B, self.n_node, self.b_dim, self.n_node).transpose(1, 2)
        return self.atom_flow.reverse(edges, z_x), edges

    def log_prob(self, z: torch.Tensor, logdet: torch.Tensor) -> torch.Tensor:
        prior = -0.5 * torch.sum(z ** 2, dim=-1) - 0.5 * z.shape[-1] * math.log(2 * math.pi)
        return prior + logdet


class MoFlowProp(base.Arch):
    """A latent property regressor (tanh hidden layers, a linear output)
    over a MoFlowNet: outputs the latent and the property."""

    def __init__(self, model: MoFlowNet, hidden_size: Tuple[int, ...] = (128,), *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(1)
        self.model = model
        self.input_keys = model.input_keys
        self.output_keys = ("latent", "property")
        layers, c = [], model.latent_dim
        for h in hidden_size:
            layers.append(Linear(c, h, generator=g))
            c = h
        self.hidden = nn.ModuleList(layers)
        self.out = Linear(c, 1, generator=g)
        self.to(next(model.parameters()).device)

    def head(self, z: torch.Tensor) -> torch.Tensor:
        """The property of latents ``z``."""
        h = z
        for lin in self.hidden:
            h = torch.tanh(lin(h))
        return self.out(h)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        z = self.model(x)[self.model.output_keys[0]]
        return {"latent": z, "property": self.head(z)}
