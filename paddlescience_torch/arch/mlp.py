"""PINN backbone MLP family (counterpart of ``paddlescience_tpu/arch/mlp.py``).

Ported: ``RandomWeightFactorization``, ``PeriodEmbedding``,
``FourierEmbedding`` and ``MLP`` with its batched forward and its fused
Taylor-jet forward (``forward_jet``). On the ``jet_pallas`` derivative
paths the hidden tanh layers run as fused jet segments
(``ops/jet_mlp.py``: CUDA kernels on the GPU, their plain versions on the
CPU). Weights keep the JAX layout, W of shape (in, out) used as ``x @ W``,
so parameters carry over key for key (``utils/jax_params.py``).

Not ported yet: ``WeightNormLinear``, ``ModifiedMLP``, ``PirateNet``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from paddlescience_torch.arch import activation as act_mod
from paddlescience_torch.arch import base
from paddlescience_torch.autodiff import jet
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Linear
from paddlescience_torch.utils import initializer

__all__ = ["RandomWeightFactorization", "PeriodEmbedding", "FourierEmbedding", "MLP"]


class RandomWeightFactorization(nn.Module):
    """W = g * v with g = exp(N(mean, std)) at init and v = W0 / g (W0 glorot
    normal), so the effective initial weight equals W0."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 mean: float = 0.5, std: float = 0.1, *, generator: torch.Generator):
        super().__init__()
        w0 = initializer.glorot_normal_(torch.empty(in_features, out_features), generator)
        g = torch.exp(mean + std * torch.randn(out_features, generator=generator))
        self.weight_g = nn.Parameter(g)
        self.weight_v = nn.Parameter(w0 / g)
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x):
        y = x @ (self.weight_g * self.weight_v)
        return y + self.bias if self.bias is not None else y


class PeriodEmbedding(nn.Module):
    """Replace key k's column with [cos(w x_k), sin(w x_k)], w = 2 pi / period,
    optionally trainable."""

    def __init__(self, periods: Dict[str, Tuple[float, bool]]):
        super().__init__()
        self.keys = tuple(periods.keys())
        for k, (p, trainable) in periods.items():
            w = torch.tensor(2 * math.pi / float(p), dtype=torch.float32)
            if trainable:
                setattr(self, f"freq_{k}", nn.Parameter(w))
            else:
                self.register_buffer(f"freq_{k}", w)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        y = dict(x)
        for k in self.keys:
            w = getattr(self, f"freq_{k}")
            y[k] = torch.cat([torch.cos(w * x[k]), torch.sin(w * x[k])], dim=-1)
        return y


class FourierEmbedding(nn.Module):
    """Random Fourier features [cos(xB), sin(xB)], B ~ N(0, scale^2),
    trainable."""

    def __init__(self, in_features: int, out_features: int, scale: float, *,
                 generator: torch.Generator):
        super().__init__()
        if out_features % 2 != 0:
            raise ValueError(f"out_features must be even, but got {out_features}.")
        self.kernel = nn.Parameter(scale * torch.randn(in_features, out_features // 2, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        z = x @ self.kernel
        return torch.cat([torch.cos(z), torch.sin(z)], dim=-1)


def _make_linear(in_features, out_features, random_weight, generator):
    if random_weight:
        return RandomWeightFactorization(in_features, out_features, mean=random_weight["mean"],
                                         std=random_weight["std"], generator=generator)
    return Linear(in_features, out_features, generator=generator)


def _linear_eff(layer):
    """Effective (W, b) of a linear layer: constant w.r.t. the coordinates,
    differentiable w.r.t. the underlying parameters."""
    if isinstance(layer, RandomWeightFactorization):
        return layer.weight_g * layer.weight_v, layer.bias
    return layer.weight, layer.bias


def _linear_out_features(layer) -> int:
    """Output width of a linear layer, read without forming its weight."""
    w = layer.weight_v if isinstance(layer, RandomWeightFactorization) else layer.weight
    return int(w.shape[-1])


def _jet_linear(layer, jx: jet.Jet) -> jet.Jet:
    w, b = _linear_eff(layer)
    return jet.linear(jx, w, b)


def _jet_pallas_ok(model) -> bool:
    """The fused segment kernels implement the tanh jet rule; other
    activations (and narrow layers unless the candidate lifts the lane
    gate) stay on the plain jet path."""
    min_lanes = int(deriv_path.flag("PSCI_JET_PALLAS_MIN_LANES", "128"))
    if any(_linear_out_features(l) < min_lanes for l in model.linears):
        return False
    return all(a is torch.tanh for a in model.acts)


def _segment_lengths(model) -> List[int]:
    """Layers per fused segment: ``PSCI_JET_SEG`` each (default: the whole
    stack for widths below 128, else 3), the last segment taking the rest.

    ``PSCI_JET_BLOCK_M`` has no counterpart: it sizes the TPU kernel's VMEM
    batch tile, while the Hopper kernels' row tile is fixed at 16 rows by
    shared memory (``ops/jet_mlp.py``)."""
    n = len(model.linears)
    width = max(_linear_out_features(l) for l in model.linears)
    seg_flag = deriv_path.flag("PSCI_JET_SEG", "")
    g = int(seg_flag) if seg_flag else (n if width < 128 else 3)
    return [min(g, n - s) for s in range(0, n, g)]


def _jet_pallas_segments(model, jx: jet.Jet, lengths: List[int]) -> jet.Jet:
    """Run the hidden (linear + tanh) layers as fused segments of the given
    lengths."""
    from paddlescience_torch.ops import jet_mlp

    save_bounds = deriv_path.flag("PSCI_JET_SAVE_BOUNDS", "0") == "1"
    y, s = jx, 0
    for n in lengths:
        ws, bs = zip(*(_linear_eff(l) for l in model.linears[s : s + n]))
        y = jet_mlp.jet_mlp_segment(y, ws, bs, save_bounds=save_bounds)
        s += n
    return y


def _jet_embed(model, jx: jet.Jet) -> jet.Jet:
    """Period + Fourier embeddings on a Jet of the concatenated coordinates
    (input_keys order), mirroring the batched forward."""
    if model.periods:
        cols = jet.split(jx, [1] * len(model.input_keys))
        new_cols = []
        for k, c in zip(model.input_keys, cols):
            if k in model.periods:
                wc = jet.scale_const(c, getattr(model.period_emb, f"freq_{k}"))
                new_cols.append(jet.concat([jet.elementwise(wc, torch.cos),
                                            jet.elementwise(wc, torch.sin)], axis=-1))
            else:
                new_cols.append(c)
        jx = jet.concat(new_cols, axis=-1)
    if model.fourier:
        z = jet.linear(jx, model.fourier_emb.kernel)
        jx = jet.concat([jet.elementwise(z, torch.cos), jet.elementwise(z, torch.sin)], axis=-1)
    return jx


class MLP(base.Arch):
    """Multi-layer perceptron with optional period embedding, Fourier
    features and random weight factorization. (The JAX MLP's skip
    connections, weight normalization, list-valued hidden sizes and
    explicit input/output dims are not ported.)

    Parameters are drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) and then moved to ``device``
    (CUDA when None).
    """

    def __init__(
        self,
        input_keys: Tuple[str, ...],
        output_keys: Tuple[str, ...],
        num_layers: int,
        hidden_size: int,
        activation: str = "tanh",
        periods: Optional[Dict[str, Tuple[float, bool]]] = None,
        fourier: Optional[Dict[str, Union[float, int]]] = None,
        random_weight: Optional[Dict[str, float]] = None,
        *,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.periods = dict(periods) if periods else None
        self.fourier = dict(fourier) if fourier else None

        if self.periods:
            self.period_emb = PeriodEmbedding(self.periods)
        cur_size = len(self.input_keys)
        if self.periods:
            cur_size += len(self.periods)  # each period-embedded key doubles
        if self.fourier:
            self.fourier_emb = FourierEmbedding(cur_size, self.fourier["dim"], self.fourier["scale"],
                                                generator=generator)
            cur_size = self.fourier["dim"]

        linears, acts = [], []
        for _ in range(num_layers):
            linears.append(_make_linear(cur_size, hidden_size, random_weight, generator))
            acts.append(act_mod.get_activation(activation))
            cur_size = hidden_size
        self.linears = nn.ModuleList(linears)
        self.acts = acts
        self.last_fc = _make_linear(cur_size, len(self.output_keys), random_weight, generator)
        self.to(device)

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for linear, act in zip(self.linears, self.acts):
            y = act(linear(y))
        return self.last_fc(y)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.periods:
            x = self.period_emb(x)
        y = self.concat_to_tensor(x, self.input_keys, axis=-1)
        if self.fourier:
            y = self.fourier_emb(y)
        y = self.forward_tensor(y)
        return self.split_to_dict(y, self.output_keys, axis=-1)

    def supports_jet(self) -> bool:
        return True

    def jet_segment_lengths(self) -> List[int]:
        """Layers per fused jet segment on the current derivative path;
        empty when the hidden layers take the plain jet path."""
        if deriv_path.flag("PSCI_JET_PALLAS_MLP", "0") == "1" and _jet_pallas_ok(self):
            return _segment_lengths(self)
        return []

    def forward_jet(self, jx: jet.Jet) -> jet.Jet:
        jx = _jet_embed(self, jx)
        lengths = self.jet_segment_lengths()
        if lengths:
            jx = _jet_pallas_segments(self, jx, lengths)
        else:
            for linear, act in zip(self.linears, self.acts):
                jx = jet.elementwise(_jet_linear(linear, jx), act)
        return _jet_linear(self.last_fc, jx)
