"""PINN backbone MLP family (counterpart of ``paddlescience_tpu/arch/mlp.py``).

Ported: ``WeightNormLinear``, ``RandomWeightFactorization``,
``PeriodEmbedding``, ``FourierEmbedding``, and ``MLP``, ``ModifiedMLP`` and
``PirateNet`` with their batched forward and their fused Taylor-jet forward
(``forward_jet``). On the ``jet_pallas`` derivative paths the hidden layers
run as fused jet segments, whatever their activation
(``arch/activation.py``): the MLP's through ``ops/jet_mlp.py``, the gated
ModifiedMLP layers and the PirateNet block groups through
``ops/jet_gated.py`` (CUDA kernels on the GPU, their plain versions on the
CPU). As in the JAX package, ModifiedMLP and PirateNet take the segments
whenever ``PSCI_JET_PALLAS`` is not "0", the MLP only with
``PSCI_JET_PALLAS_MLP``; layers narrower than ``PSCI_JET_PALLAS_MIN_LANES``
take the plain jet path, as under the JAX gate, and nothing else does: a
segment of any other shape goes to the kernels (widths that are no
multiple of 4 zero-padded, a segment at most ``ops/jet_mlp.py::MAX_LAYERS``
deep), whose wrappers raise where they cannot take it. Weights keep the JAX layout, W of shape (in, out)
used as ``x @ W``, and parameters keep the JAX names, so they carry over
key for key (``utils/jax_params.py``). The parametric activations
``stan`` and ``swish`` (a learnable ``beta`` per activation, named
``acts.<i>.beta``, ``embed_act_u.beta``, ``blocks.<i>.act1.beta``, ...)
keep every net on the plain jet path, as the JAX package keeps them off
its fused kernels (:func:`_segment_act`).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddlescience_torch.arch import activation as act_mod
from paddlescience_torch.arch import base
from paddlescience_torch.autodiff import jet
from paddlescience_torch.autodiff import path as deriv_path
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Linear
from paddlescience_torch.utils import initializer

__all__ = ["WeightNormLinear", "RandomWeightFactorization", "PeriodEmbedding", "FourierEmbedding", "MLP",
           "ModifiedMLP", "PirateNetBlock", "PirateNet"]


class WeightNormLinear(nn.Module):
    """y = x @ (g * v / |v|_col) + b: ``weight_v`` (in, out) xavier uniform,
    ``weight_g`` (out,) ones, ``bias`` zeros (the JAX names and init)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.weight_v = nn.Parameter(initializer.xavier_uniform_(torch.empty(in_features, out_features), generator))
        self.weight_g = nn.Parameter(torch.ones(out_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def effective_weight(self) -> torch.Tensor:
        v = self.weight_v
        return self.weight_g * v / torch.linalg.vector_norm(v, dim=0, keepdim=True)

    def forward(self, x):
        y = x @ self.effective_weight()
        return y + self.bias if self.bias is not None else y


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


def _make_linear(in_features, out_features, random_weight, generator, weight_norm=False, kernel_init=None):
    if weight_norm:
        return WeightNormLinear(in_features, out_features, generator=generator)
    if random_weight:
        return RandomWeightFactorization(in_features, out_features, mean=random_weight["mean"],
                                         std=random_weight["std"], generator=generator)
    return Linear(in_features, out_features, kernel_init=kernel_init, generator=generator)


def _linear_eff(layer):
    """Effective (W, b) of a linear layer: constant w.r.t. the coordinates,
    differentiable w.r.t. the underlying parameters."""
    if isinstance(layer, WeightNormLinear):
        return layer.effective_weight(), layer.bias
    if isinstance(layer, RandomWeightFactorization):
        return layer.weight_g * layer.weight_v, layer.bias
    return layer.weight, layer.bias


def _linear_out_features(layer) -> int:
    """Output width of a linear layer, read without forming its weight."""
    w = layer.weight_v if isinstance(layer, (RandomWeightFactorization, WeightNormLinear)) else layer.weight
    return int(w.shape[-1])


def _jet_linear(layer, jx: jet.Jet) -> jet.Jet:
    w, b = _linear_eff(layer)
    return jet.linear(jx, w, b)


def _jet_gate(y: jet.Jet, u: jet.Jet, v: jet.Jet) -> jet.Jet:
    """y*u + (1-y)*v == v + y*(u-v): one jet product instead of two."""
    return jet.add(v, jet.mul(y, jet.sub(u, v)))


def _segment_act(acts) -> Optional[jet.Act]:
    """The (id, parameter) of the activation every layer of ``acts`` shares,
    or None if they differ or one has no closed-form rule by id. Stan and
    Swish have none (their rule reads a learnable ``beta``, which the
    kernels do not take), so a net with one never runs the fused segments:
    this is where the port keeps them off the kernels, as the JAX package
    does (``_jet_pallas_ok`` there admits parameterless activations only)."""
    rules = {jet.act_of(a) for a in acts}
    return rules.pop() if len(rules) == 1 and None not in rules else None


def _jet_pallas_ok(linears, acts) -> bool:
    """``PSCI_JET_PALLAS`` not "0", and layers the fused segment kernels
    take: every stateless activation (as the JAX gate, which admits any
    parameterless one), one for the whole stack; narrow layers only where
    the candidate lifts the lane gate."""
    if deriv_path.flag("PSCI_JET_PALLAS", "1") != "1":
        return False
    min_lanes = int(deriv_path.flag("PSCI_JET_PALLAS_MIN_LANES", "128"))
    if any(_linear_out_features(l) < min_lanes for l in linears):
        return False
    return _segment_act(acts) is not None


def _segment_lengths(model) -> List[int]:
    """Layers per fused segment: ``PSCI_JET_SEG`` each (default: the whole
    stack for widths below 128, else 3; at most the kernels' MAX_LAYERS),
    the last segment taking the rest.

    ``PSCI_JET_BLOCK_M`` has no counterpart: it sizes the TPU kernel's VMEM
    batch tile, while the Hopper kernels' row tile is fixed at 16 rows by
    shared memory (``ops/jet_mlp.py``)."""
    from paddlescience_torch.ops.jet_mlp import MAX_LAYERS

    n = len(model.linears)
    width = max(_linear_out_features(l) for l in model.linears)
    seg_flag = deriv_path.flag("PSCI_JET_SEG", "")
    g = min(int(seg_flag) if seg_flag else (n if width < 128 else 3), MAX_LAYERS)
    return [min(g, n - s) for s in range(0, n, g)]


def _jet_pallas_segments(model, jx: jet.Jet, lengths: List[int], uv=None) -> jet.Jet:
    """Run the hidden (linear + activation [+ gate with the jets ``uv``])
    layers as fused segments of the given lengths."""
    from paddlescience_torch.ops import jet_gated, jet_mlp

    save_bounds = deriv_path.flag("PSCI_JET_SAVE_BOUNDS", "0") == "1"
    act = _segment_act(model.acts)
    y, s = jx, 0
    for n in lengths:
        ws, bs = zip(*(_linear_eff(l) for l in model.linears[s : s + n]))
        if uv is None:
            y = jet_mlp.jet_mlp_segment(y, ws, bs, save_bounds=save_bounds, act=act)
        else:
            y = jet_gated.jet_gated_segment(y, uv[0], uv[1], ws, bs, (), jet_gated.modified_mlp_program(n),
                                            save_bounds=save_bounds, act=act)
        s += n
    return y


def _make_act(name: str, size: int = 1):
    """The activation called ``name``; Siren instantiated (w0 = 30), Stan
    with ``size`` betas, Swish with one (beta 1), as the JAX ``_make_act``."""
    act = act_mod.get_activation(name)
    if act is act_mod.Stan:
        return act(size)
    if act is act_mod.Swish:
        return act(1.0)
    return act() if act is act_mod.Siren else act


def _act_list(acts):
    """``acts`` as a ``ModuleList`` when they hold parameters (Stan,
    Swish), so their ``beta`` are the net's parameters; else the list."""
    return nn.ModuleList(acts) if any(isinstance(a, nn.Module) for a in acts) else acts


def _resolve_sizes(hidden_size, num_layers) -> List[int]:
    """The hidden widths: ``hidden_size`` itself when a list (then
    ``num_layers`` must be None), else ``num_layers`` times it."""
    if isinstance(hidden_size, (tuple, list)):
        if num_layers is not None:
            raise ValueError("num_layers should be None when hidden_size is specified as a list")
        return list(hidden_size)
    if isinstance(hidden_size, int):
        if not isinstance(num_layers, int):
            raise ValueError("num_layers should be an int when hidden_size is an int")
        return [hidden_size] * num_layers
    raise ValueError(f"hidden_size should be list of int or int, but got {type(hidden_size)}")


def _embedded_size(model, generator, input_dim: Optional[int] = None) -> int:
    """Create ``model``'s period and Fourier embeddings (from its
    ``periods``/``fourier`` settings) and return the width they produce
    (from ``input_dim`` input columns when given, as in the JAX MLP, else
    one per input key)."""
    if model.periods:
        model.period_emb = PeriodEmbedding(model.periods)
    cur_size = len(model.input_keys) if input_dim is None else input_dim
    if input_dim is None and model.periods:
        cur_size += len(model.periods)  # each period-embedded key doubles
    if model.fourier:
        model.fourier_emb = FourierEmbedding(cur_size, model.fourier["dim"], model.fourier["scale"],
                                             generator=generator)
        cur_size = model.fourier["dim"]
    return cur_size


def _embed(model, x: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Period + Fourier embeddings of a dict of input columns."""
    if model.periods:
        x = model.period_emb(x)
    y = model.concat_to_tensor(x, model.input_keys, axis=-1)
    return model.fourier_emb(y) if model.fourier else y


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


def _refuse_transformed(model) -> None:
    if model.has_transform:
        raise ValueError(f"{type(model).__name__} has an input or output transform: it has no jet forward "
                         "(its derivatives come from nested jvp)")


class MLP(base.Arch):
    """Multi-layer perceptron with optional period embedding, Fourier
    features, random weight factorization or weight normalization
    (``weight_norm``: every hidden layer a :class:`WeightNormLinear`, the
    output layer plain, as in the JAX MLP), and any activation of
    ``arch/activation.py`` (``siren`` with the SIREN init of plain linear
    layers). ``hidden_size`` is one width (``num_layers`` of them) or a
    list of widths (``num_layers`` None); ``input_dim``/``output_dim``
    give the widths of a single input key and of the output (DeepONet's
    100-column ``u``); ``skip_connection`` adds, as the JAX MLP does, each
    even layer's pre-activation to itself from the second one on. The
    fused segments do not take skip connections: such an MLP runs the
    plain jet path (``jet_pallas_eligible`` is False), as in JAX.

    Parameters are drawn on the CPU from ``generator`` (a CPU
    ``torch.Generator``; seed 0 when None) and then moved to ``device``
    (CUDA when None).
    """

    def __init__(
        self,
        input_keys: Tuple[str, ...],
        output_keys: Tuple[str, ...],
        num_layers: Optional[int],
        hidden_size: Union[int, Sequence[int]],
        activation: str = "tanh",
        skip_connection: bool = False,
        weight_norm: bool = False,
        input_dim: Optional[int] = None,
        output_dim: Optional[int] = None,
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
        self.skip_connection = skip_connection
        self.periods = dict(periods) if periods else None
        self.fourier = dict(fourier) if fourier else None

        sizes = _resolve_sizes(hidden_size, num_layers)
        cur_size = _embedded_size(self, generator, input_dim)
        linears, acts = [], []
        for i, size in enumerate(sizes):
            kernel_init = None
            if activation == "siren":
                kernel_init = act_mod.Siren.first_layer_init if i == 0 else act_mod.Siren.hidden_layer_init()
            linears.append(_make_linear(cur_size, size, random_weight, generator, weight_norm, kernel_init))
            acts.append(_make_act(activation, size))
            cur_size = size
        self.linears = nn.ModuleList(linears)
        self.acts = _act_list(acts)
        out_dim = len(self.output_keys) if output_dim is None else output_dim
        self.last_fc = _make_linear(cur_size, out_dim, random_weight, generator)
        self.to(device)

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        y, skip = x, None
        for i, (linear, act) in enumerate(zip(self.linears, self.acts)):
            y = linear(y)
            if self.skip_connection and i % 2 == 0:
                if skip is not None:
                    skip = y
                    y = y + skip
                else:
                    skip = y
            y = act(y)
        return self.last_fc(y)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.split_to_dict(self.forward_tensor(_embed(self, x)), self.output_keys, axis=-1)

    def _output_transform_inputs(self, x_given, x_transformed):
        """The transformed inputs after the period embedding, as the JAX
        class hands them."""
        return self.period_emb(x_transformed) if self.periods else x_transformed

    def supports_jet(self) -> bool:
        return not self.has_transform

    def jet_pallas_eligible(self) -> bool:
        """Whether the hidden layers would take the fused segments on the
        current path's flags, ``PSCI_JET_PALLAS_MLP`` aside: structural, as
        the JAX method the autotuner reads; never with a transform."""
        return self.supports_jet() and not self.skip_connection and _jet_pallas_ok(self.linears, self.acts)

    def jet_segment_lengths(self) -> List[int]:
        """Layers per fused jet segment on the current derivative path;
        empty when the hidden layers take the plain jet path."""
        if deriv_path.flag("PSCI_JET_PALLAS_MLP", "0") == "1" and self.jet_pallas_eligible():
            return _segment_lengths(self)
        return []

    def forward_jet(self, jx: jet.Jet) -> jet.Jet:
        _refuse_transformed(self)
        jx = _jet_embed(self, jx)
        lengths = self.jet_segment_lengths()
        if lengths:
            return _jet_linear(self.last_fc, _jet_pallas_segments(self, jx, lengths))
        skip = None
        for i, (linear, act) in enumerate(zip(self.linears, self.acts)):
            jx = _jet_linear(linear, jx)
            if self.skip_connection and i % 2 == 0:
                if skip is not None:
                    skip = jx
                    jx = jet.add(jx, skip)
                else:
                    skip = jx
            jx = jet.elementwise(jx, act)
        return _jet_linear(self.last_fc, jx)


class ModifiedMLP(base.Arch):
    """Two-stream gated MLP (arXiv:2001.04536): y <- act(W y), then
    y * u + (1 - y) * v with gates u, v embedded once from the input.
    ``weight_norm`` makes the gate embeddings and the hidden layers
    :class:`WeightNormLinear` (the output layer stays plain, as in JAX);
    ``skip_connection`` adds, after the gate, each even layer's output to
    itself from the second one on, as the JAX class does, and keeps the
    net off the fused segments (``jet_pallas_eligible`` is False);
    ``input_dim``/``output_dim`` as for :class:`MLP`. Parameters and
    device as for :class:`MLP`."""

    def __init__(
        self,
        input_keys: Tuple[str, ...],
        output_keys: Tuple[str, ...],
        num_layers: int,
        hidden_size: int,
        activation: str = "tanh",
        skip_connection: bool = False,
        weight_norm: bool = False,
        input_dim: Optional[int] = None,
        output_dim: Optional[int] = None,
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
        if not isinstance(hidden_size, int):
            raise ValueError(f"hidden_size should be int, but got {type(hidden_size)}")
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.skip_connection = skip_connection
        self.periods = dict(periods) if periods else None
        self.fourier = dict(fourier) if fourier else None

        cur_size = _embedded_size(self, generator, input_dim)
        self.embed_u = _make_linear(cur_size, hidden_size, random_weight, generator, weight_norm)
        self.embed_v = _make_linear(cur_size, hidden_size, random_weight, generator, weight_norm)
        self.embed_act_u = _make_act(activation, hidden_size)
        self.embed_act_v = _make_act(activation, hidden_size)
        linears, acts = [], []
        for _ in range(num_layers):
            linears.append(_make_linear(cur_size, hidden_size, random_weight, generator, weight_norm))
            acts.append(_make_act(activation, hidden_size))
            cur_size = hidden_size
        self.linears = nn.ModuleList(linears)
        self.acts = _act_list(acts)
        out_dim = len(self.output_keys) if output_dim is None else output_dim
        self.last_fc = _make_linear(cur_size, out_dim, random_weight, generator)
        self.to(device)

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        u = self.embed_act_u(self.embed_u(x))
        v = self.embed_act_v(self.embed_v(x))
        y, skip = x, None
        for i, (linear, act) in enumerate(zip(self.linears, self.acts)):
            y = act(linear(y))
            y = y * u + (1 - y) * v
            if self.skip_connection and i % 2 == 0:
                if skip is not None:
                    skip = y
                    y = y + skip
                else:
                    skip = y
        return self.last_fc(y)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.split_to_dict(self.forward_tensor(_embed(self, x)), self.output_keys, axis=-1)

    def _output_transform_inputs(self, x_given, x_transformed):
        """The inputs as given, before the input transform (the JAX
        class's ``x_identity``)."""
        return x_given

    def supports_jet(self) -> bool:
        return not self.has_transform

    def jet_pallas_eligible(self) -> bool:
        """Whether the hidden layers take the fused gated segments on the
        current path's flags (structural, as in JAX): never with skip
        connections or a transform."""
        return self.supports_jet() and not self.skip_connection and _jet_pallas_ok(
            self.linears, [*self.acts, self.embed_act_u, self.embed_act_v])

    def jet_segment_lengths(self) -> List[int]:
        """Layers per fused gated segment on the current derivative path;
        empty when the hidden layers take the plain jet path."""
        return _segment_lengths(self) if self.jet_pallas_eligible() else []

    def forward_jet(self, jx: jet.Jet) -> jet.Jet:
        _refuse_transformed(self)
        jx = _jet_embed(self, jx)
        u = jet.elementwise(_jet_linear(self.embed_u, jx), self.embed_act_u)
        v = jet.elementwise(_jet_linear(self.embed_v, jx), self.embed_act_v)
        lengths = self.jet_segment_lengths()
        if lengths:
            y = _jet_pallas_segments(self, jx, lengths, uv=(u, v))
        else:
            y, skip = jx, None
            for i, (linear, act) in enumerate(zip(self.linears, self.acts)):
                y = _jet_gate(jet.elementwise(_jet_linear(linear, y), act), u, v)
                if self.skip_connection and i % 2 == 0:
                    if skip is not None:
                        skip = y
                        y = jet.add(y, skip)
                    else:
                        skip = y
        return _jet_linear(self.last_fc, y)


class PirateNetBlock(nn.Module):
    """Residual adaptive block (arXiv:2402.00326): three gated layers and
    x_out = alpha * h + (1 - alpha) * x, alpha starting at 0 (the block
    starts as the identity)."""

    def __init__(self, embed_dim: int, activation: str = "tanh",
                 random_weight: Optional[Dict[str, float]] = None, *, generator: torch.Generator):
        super().__init__()
        self.linear1 = _make_linear(embed_dim, embed_dim, random_weight, generator)
        self.linear2 = _make_linear(embed_dim, embed_dim, random_weight, generator)
        self.linear3 = _make_linear(embed_dim, embed_dim, random_weight, generator)
        self.alpha = nn.Parameter(torch.zeros(1))
        self.act1 = _make_act(activation, embed_dim)
        self.act2 = _make_act(activation, embed_dim)
        self.act3 = _make_act(activation, embed_dim)

    @property
    def linears(self):
        return (self.linear1, self.linear2, self.linear3)

    @property
    def acts(self):
        return (self.act1, self.act2, self.act3)

    def forward(self, x, u, v):
        f = self.act1(self.linear1(x))
        z1 = f * u + (1 - f) * v
        g = self.act2(self.linear2(z1))
        z2 = g * u + (1 - g) * v
        h = self.act3(self.linear3(z2))
        return self.alpha * h + (1 - self.alpha) * x

    def forward_jet(self, x: jet.Jet, u: jet.Jet, v: jet.Jet) -> jet.Jet:
        f = jet.elementwise(_jet_linear(self.linear1, x), self.act1)
        z1 = _jet_gate(f, u, v)
        g = jet.elementwise(_jet_linear(self.linear2, z1), self.act2)
        z2 = _jet_gate(g, u, v)
        h = jet.elementwise(_jet_linear(self.linear3, z2), self.act3)
        return jet.add(jet.scale_const(h, self.alpha), jet.scale_const(x, 1 - self.alpha))


def _piratenet_block_ws(block: PirateNetBlock):
    """Effective weights and biases of a block's three layers."""
    return zip(*(_linear_eff(l) for l in block.linears))


def _checkpointed_block_jet(block: PirateNetBlock, y: jet.Jet, u: jet.Jet, v: jet.Jet) -> jet.Jet:
    """``block.forward_jet`` with its inner jets rematerialised in the
    backward, so only the block-boundary jets stay alive."""
    S, index = len(y.index), y.index

    def run(*streams):
        parts = [jet.Jet(streams[k * S : (k + 1) * S], index) for k in range(3)]
        return block.forward_jet(*parts).streams

    return jet.Jet(checkpoint(run, *y.streams, *u.streams, *v.streams, use_reentrant=False), index)


class PirateNet(base.Arch):
    """PirateNet (arXiv:2402.00326): ``num_blocks`` residual adaptive
    blocks of width ``hidden_size`` on the embedded input, with gates u, v
    embedded once. The blocks act on the embedding itself, so
    ``hidden_size`` must equal the embedding's width (``fourier["dim"]``,
    else ``input_dim`` or the input keys' count). ``weight_norm`` makes the
    gate embeddings :class:`WeightNormLinear` (the blocks' layers and the
    output layer stay as they are, as in JAX); ``input_dim``/``output_dim``
    as for :class:`MLP`. Parameters and device as for :class:`MLP`.

    On the fused path, consecutive blocks run as one segment in groups of
    ``PSCI_JET_PBLOCK_GROUP`` blocks (default 3; ``jet_pallas_full`` takes
    all blocks as one group). On the plain jet path each block is
    rematerialised in the backward (``torch.utils.checkpoint``) unless
    the environment sets ``PSCI_JET_REMAT=0``.
    """

    def __init__(
        self,
        input_keys: Tuple[str, ...],
        output_keys: Tuple[str, ...],
        num_blocks: int,
        hidden_size: int,
        activation: str = "tanh",
        weight_norm: bool = False,
        input_dim: Optional[int] = None,
        output_dim: Optional[int] = None,
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
        if not isinstance(hidden_size, int):
            raise ValueError(f"hidden_size should be int, but got {type(hidden_size)}")
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.periods = dict(periods) if periods else None
        self.fourier = dict(fourier) if fourier else None

        cur_size = _embedded_size(self, generator, input_dim)
        if cur_size != hidden_size:
            raise ValueError(f"PirateNet blocks act on the embedding: hidden_size {hidden_size} must equal "
                             f"the embedded width {cur_size}")
        self.embed_u = _make_linear(cur_size, hidden_size, random_weight, generator, weight_norm)
        self.embed_v = _make_linear(cur_size, hidden_size, random_weight, generator, weight_norm)
        self.embed_act_u = _make_act(activation, hidden_size)
        self.embed_act_v = _make_act(activation, hidden_size)
        self.blocks = nn.ModuleList(
            PirateNetBlock(cur_size, activation=activation, random_weight=random_weight, generator=generator)
            for _ in range(num_blocks))
        out_dim = len(self.output_keys) if output_dim is None else output_dim
        self.last_fc = _make_linear(cur_size, out_dim, random_weight, generator)
        self.to(device)

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        u = self.embed_act_u(self.embed_u(x))
        v = self.embed_act_v(self.embed_v(x))
        y = x
        for block in self.blocks:
            y = block(y, u, v)
        return self.last_fc(y)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.split_to_dict(self.forward_tensor(_embed(self, x)), self.output_keys, axis=-1)

    def _output_transform_inputs(self, x_given, x_transformed):
        """The transformed inputs after the period embedding, as the JAX
        class hands them."""
        return self.period_emb(x_transformed) if self.periods else x_transformed

    def supports_jet(self) -> bool:
        return not self.has_transform

    def jet_pallas_eligible(self) -> bool:
        """Whether the blocks take the fused gated segments on the current
        path's flags (structural, as in JAX); never with a transform."""
        return self.supports_jet() and _jet_pallas_ok([l for b in self.blocks for l in b.linears],
                                                      [a for b in self.blocks for a in b.acts])

    def jet_segment_lengths(self) -> List[int]:
        """Layers per fused segment (three per block of a group of
        ``PSCI_JET_PBLOCK_GROUP`` blocks, at most the kernels' MAX_LAYERS)
        on the current derivative path; empty on the plain jet path."""
        if not self.jet_pallas_eligible():
            return []
        n = len(self.blocks)
        from paddlescience_torch.ops.jet_mlp import MAX_LAYERS

        grp = min(int(deriv_path.flag("PSCI_JET_PBLOCK_GROUP", "3")), MAX_LAYERS // 3)
        return [3 * min(grp, n - i) for i in range(0, n, grp)]

    def forward_jet(self, jx: jet.Jet) -> jet.Jet:
        _refuse_transformed(self)
        jx = _jet_embed(self, jx)
        u = jet.elementwise(_jet_linear(self.embed_u, jx), self.embed_act_u)
        v = jet.elementwise(_jet_linear(self.embed_v, jx), self.embed_act_v)
        y = jx
        lengths = self.jet_segment_lengths()
        if lengths:
            from paddlescience_torch.ops import jet_gated

            save_bounds = deriv_path.flag("PSCI_JET_SAVE_BOUNDS", "0") == "1"
            act = _segment_act([a for b in self.blocks for a in b.acts])
            i = 0
            for n_layers in lengths:
                group = self.blocks[i : i + n_layers // 3]
                ws, bs = zip(*(_piratenet_block_ws(b) for b in group))
                y = jet_gated.jet_gated_segment(
                    y, u, v, [w for blk in ws for w in blk], [b for blk in bs for b in blk],
                    [b.alpha for b in group], jet_gated.piratenet_program(len(group)), save_bounds=save_bounds,
                    act=act)
                i += len(group)
            return _jet_linear(self.last_fc, y)
        remat = os.environ.get("PSCI_JET_REMAT", "1") == "1" and torch.is_grad_enabled()
        for block in self.blocks:
            y = _checkpointed_block_jet(block, y, u, v) if remat else block.forward_jet(y, u, v)
        return _jet_linear(self.last_fc, y)
