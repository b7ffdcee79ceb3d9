"""ExtFormer-MoE building blocks: noisy top-k mixture-of-experts routing
(counterpart of ``paddlescience_tpu/arch/extformer_moe.py``).

The experts are stacked on a leading axis and computed densely, every
expert on every token by one einsum, then the top-k outputs are gathered
and weighted by their renormalised gates (the reference's "dense"
dispatch), as in the JAX package.

``GatingNet`` takes a (B, T, H, W, C) volume and gives the top-k gates,
their expert indices and the auxiliary load-balancing loss. Its logits are
a per-token linear gate, a learnable latent table over the static (T, H,
W) grid ("spatial-" or "cuboid-latent"), or the two blended by a learnable
combine weight ("-linear" variants). In training (a generator given, or a
noise tensor) the logits get Gaussian noise scaled by ``softplus(noise_lin
(x)) + 1e-2``; the noise is drawn from the generator, or taken as given
(``noise``: a standard-normal tensor of the logits' shape), so a test can
feed the JAX package's draw. Top-(k+1) of the softmax, the first k gates
renormalised; the importance loss is the squared coefficient of variation
of the summed routing weights, the load loss that of the probability of
each expert staying in the top k under the noise (a normal CDF around the
k-th and (k+1)-th largest post-softmax values, with the pre-softmax
logits, as the reference and the JAX package compute it), over all tokens
("all") or per location ("cell").
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.nn.layers import Linear

__all__ = ["GATE_STYLES", "default_moe_config", "GatingNet", "MixtureLinear", "MixtureFFN"]

GATE_STYLES = ("linear", "spatial-latent", "cuboid-latent", "spatial-latent-linear", "cuboid-latent-linear")


def default_moe_config(**overrides) -> Dict:
    """The reference configuration's defaults: 10 experts, top-4,
    "cuboid-latent" gates, dense dispatch, both aux weights 0."""
    cfg = {"num_experts": 10, "out_planes": 4, "importance_weight": 0.0, "load_weight": 0.0,
           "gate_style": "cuboid-latent", "dispatch_style": "dense", "aux_loss_style": "all", "use_ffn_moe": True,
           "use_linear_moe": False, "use_attn_moe": False}
    cfg.update(overrides)
    return cfg


def _cv_squared(x: torch.Tensor, eps: float = 1e-25) -> torch.Tensor:
    """Squared coefficient of variation over the last axis."""
    return torch.var(x, dim=-1, unbiased=False) / (torch.mean(x, dim=-1) ** 2 + eps)


def _normal_cdf(value: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(value / math.sqrt(2.0)))


def gate_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """The gating noise: standard normal draws from ``generator``."""
    return torch.randn(shape, generator=generator, device=device)


class GatingNet(nn.Module):
    """Noisy top-k gate over a (T, H, W) expert grid (``input_shape``)."""

    def __init__(self, moe_config: Dict, input_shape: Tuple[int, int, int], in_channels: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.num_experts = E = int(moe_config["num_experts"])
        self.out_planes = int(moe_config["out_planes"])
        self.aux_loss_style = moe_config.get("aux_loss_style", "all")
        self.importance_weight = float(moe_config.get("importance_weight", 0.0))
        self.load_weight = float(moe_config.get("load_weight", 0.0))
        self.style = moe_config.get("gate_style", "linear")
        if not (1 < self.out_planes <= E):
            raise ValueError(f"out_planes must be in (1, num_experts], got {self.out_planes}")
        if self.style not in GATE_STYLES:
            raise ValueError(f"gate_style '{self.style}' not in {GATE_STYLES}")
        T, H, W = input_shape
        self.noise_lin = Linear(in_channels, E, bias=False, generator=generator)
        self.noise_eps = 1e-2
        bound = math.sqrt(3.0 / (self.out_planes / E))

        def uniform(shape):
            return nn.Parameter(torch.empty(shape).uniform_(-bound, bound, generator=generator))

        if self.style in ("linear", "spatial-latent-linear", "cuboid-latent-linear"):
            self.lin = Linear(in_channels, E, bias=False, generator=generator)
        spatial = self.style.startswith("spatial")
        if self.style != "linear":
            self.latent_table = uniform((H, W, E) if spatial else (T, H, W, E))
        if self.style.endswith("-linear"):
            self.combine_weight = uniform((H, W, E, 2) if spatial else (T, H, W, E, 2))

    def _raw_logits(self, x: torch.Tensor) -> torch.Tensor:
        B, T = x.shape[:2]
        if self.style == "linear":
            return self.lin(x)
        table = self.latent_table
        lead = (B, T) if table.ndim == 3 else (B,)
        latent = table.expand(lead + table.shape)
        if not self.style.endswith("-linear"):
            return latent
        both = torch.stack([latent, self.lin(x)], dim=-1)  # (B, T, H, W, E, 2)
        return torch.sum(both * self.combine_weight, dim=-1)

    def _load_prob(self, clean, noisy, noise_std, top_values):
        k = self.out_planes
        thr_in = top_values[..., k: k + 1]  # the (k+1)-th largest
        thr_out = top_values[..., k - 1: k]  # the k-th largest
        prob_in = _normal_cdf((clean - thr_in) / noise_std)
        prob_out = _normal_cdf((clean - thr_out) / noise_std)
        return torch.where(noisy > thr_in, prob_in, prob_out)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None, eps: float = 1e-25):
        """(top_k_gates, top_k_indices, aux_loss) for x (B, T, H, W, C);
        noisy with aux losses when ``generator`` or ``noise`` is given,
        else deterministic with aux_loss 0."""
        k, E = self.out_planes, self.num_experts
        raw = self._raw_logits(x)
        training = generator is not None or noise is not None
        if training:
            noise_std = F.softplus(self.noise_lin(x)) + self.noise_eps
            if noise is None:
                noise = gate_noise(raw.shape, generator, x.device)
            noisy = raw + noise * noise_std
            logits = torch.softmax(noisy, dim=-1)
        else:
            logits = torch.softmax(raw, dim=-1)
        top_logits, top_indices = torch.topk(logits, min(k + 1, E), dim=-1)
        top_k_logits = top_logits[..., :k]
        gates = top_k_logits / (torch.sum(top_k_logits, dim=-1, keepdim=True) + eps)
        aux = torch.zeros((), device=x.device)
        if training and (self.importance_weight or self.load_weight):
            if self.aux_loss_style == "cell":
                importance = torch.mean(_cv_squared(torch.sum(logits, dim=0)))
                prob = self._load_prob(raw, noisy, noise_std, top_logits)
                load = torch.mean(_cv_squared(torch.sum(prob, dim=0)))
            elif self.aux_loss_style == "all":
                flat = lambda a: a.reshape(-1, a.shape[-1])  # noqa: E731
                importance = _cv_squared(torch.sum(flat(logits), dim=0))
                prob = self._load_prob(flat(raw), flat(noisy), flat(noise_std), flat(top_logits))
                load = _cv_squared(torch.sum(prob, dim=0))
            else:
                raise NotImplementedError(f"aux_loss_style {self.aux_loss_style}")
            aux = self.importance_weight * importance + self.load_weight * load
        return gates, top_indices[..., :k], aux


def _combine(expert_out: torch.Tensor, gates: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Dense dispatch: expert_out (..., E, C), gates and indices (..., K)
    -> the gate-weighted sum of the selected experts' outputs (..., C)."""
    idx = indices.unsqueeze(-1).expand(*indices.shape, expert_out.shape[-1])
    return torch.sum(torch.gather(expert_out, -2, idx) * gates.unsqueeze(-1), dim=-2)


class MixtureLinear(nn.Module):
    """Top-k routed linear layer with stacked expert kernels (E, in, out)."""

    def __init__(self, in_dim: int, out_dim: int, expert_shape: Tuple[int, int, int], moe_config: Dict,
                 bias: bool = True, *, generator: torch.Generator):
        super().__init__()
        E = int(moe_config["num_experts"])
        self.gate = GatingNet(moe_config, expert_shape, in_dim, generator=generator)
        self.w = nn.Parameter(math.sqrt(1.0 / in_dim) * torch.randn((E, in_dim, out_dim), generator=generator))
        self.b = nn.Parameter(torch.zeros((E, out_dim))) if bias else None

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        gates, idx, aux = self.gate(x, generator)
        outs = torch.einsum("bthwd,edc->bthwec", x, self.w)
        if self.b is not None:
            outs = outs + self.b
        return _combine(outs, gates, idx), aux


class MixtureFFN(nn.Module):
    """Top-k routed positionwise FFN: stacked experts of two linear layers
    with tanh GELU between them."""

    def __init__(self, units: int, hidden_size: int, expert_shape: Tuple[int, int, int], moe_config: Dict, *,
                 generator: torch.Generator):
        super().__init__()
        E = self.num_experts = int(moe_config["num_experts"])
        self.gate = GatingNet(moe_config, expert_shape, units, generator=generator)
        self.w_in = nn.Parameter(math.sqrt(1.0 / units) * torch.randn((E, units, hidden_size), generator=generator))
        self.b_in = nn.Parameter(torch.zeros((E, hidden_size)))
        self.w_out = nn.Parameter(math.sqrt(1.0 / hidden_size) * torch.randn((E, hidden_size, units),
                                                                             generator=generator))
        self.b_out = nn.Parameter(torch.zeros((E, units)))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        gates, idx, aux = self.gate(x, generator)
        h = F.gelu(torch.einsum("bthwd,edf->bthwef", x, self.w_in) + self.b_in, approximate="tanh")
        outs = torch.einsum("bthwef,efd->bthwed", h, self.w_out) + self.b_out
        return _combine(outs, gates, idx), aux
