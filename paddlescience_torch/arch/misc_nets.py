"""Smaller nets (counterpart of ``paddlescience_tpu/arch/misc_nets.py``):
Epnn, USCNN, HEDeepONets, ChipDeepONets and the encoder-decoder
Transformer for symbolic regression.

Parameter names follow the JAX modules (``layers.2.weight``,
``convs.0.weight``, ``heat_net.linears.0.weight``, ``b``,
``src_embed.weight``, ``dec_blocks.1.kv_x.bias``, ``ln.scale``), so
``utils/jax_params.py`` carries their weights key for key (conv kernels
transposed). Every constructor draws on the CPU from ``generator`` (seed
0 when None) and moves the module to ``device`` (CUDA when None).

Details kept from the JAX modules: Epnn's last layer has no bias and its
``drop_p`` is unused; USCNN resizes its channel-first input with JAX's
bilinear rule (``nn/resize.py``) to (ny, nx) before its convolutions;
HEDeepONets' bias ``b`` has one entry per output key, ChipDeepONets' one;
the Transformer embeds ``astype(int32)`` of float token inputs, adds the
sin/cos position table (sines in the even columns, cosines in the odd
ones), masks causal attention with -1e9, and its GELU is the tanh
approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch import activation as act_mod
from paddlescience_torch.arch import base, mlp
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv, Embedding, LayerNorm, Linear
from paddlescience_torch.nn.resize import resize

__all__ = ["Epnn", "USCNN", "HEDeepONets", "ChipDeepONets", "Transformer"]


def _gen(generator: Optional[torch.Generator]) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


class Epnn(base.Arch):
    """Elasto-plastic constitutive network: ``node_sizes[0]`` ->
    ``node_sizes[-1]`` through Linear layers, ``activations[i]`` after
    layer i (as many as are given), the last layer without bias."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], node_sizes: Sequence[int],
                 activations: Sequence[str], drop_p: float = 0.0, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = _gen(generator)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        acts = [act_mod.get_activation(a) for a in activations]
        # a parametric activation (stan, swish) is a module: its beta is ``acts.<position>.beta``, as in JAX
        self.acts = nn.ModuleDict({str(i): a() for i, a in enumerate(acts) if isinstance(a, type)})
        self._acts = [self.acts[str(i)] if isinstance(a, type) else a for i, a in enumerate(acts)]
        layers = [Linear(node_sizes[0], node_sizes[1], generator=g)]
        for h1, h2 in zip(node_sizes[1:-2], node_sizes[2:-1]):
            layers.append(Linear(h1, h2, generator=g))
        layers.append(Linear(node_sizes[-2], node_sizes[-1], bias=False, generator=g))
        self.layers = nn.ModuleList(layers)
        self.drop_p = drop_p
        self.to(device)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        y = self.concat_to_tensor(x, self.input_keys, axis=-1)
        for i, layer in enumerate(self.layers):
            y = layer(y)
            if i < len(self._acts):
                y = self._acts[i](y)
        return self.split_to_dict(y, self.output_keys, axis=-1)


class USCNN(base.Arch):
    """Upsampled structured-grid CNN: the (B, nvar_in, h, w) input resized
    bilinearly to (ny, nx), then ``hidden_size`` convolutions (k x k,
    stride s, zero padding p) with ReLU and a last one to ``nvar_out``
    channels. Channel-first in and out."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...],
                 hidden_size: Union[int, Sequence[int]], h: float, nx: int, ny: int, nvar_in: int = 1,
                 nvar_out: int = 1, pad_singleside: int = 1, k: int = 5, s: int = 1, p: int = 2, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = _gen(generator)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.nx, self.ny = nx, ny
        self.pad_singleside = pad_singleside
        sizes = [hidden_size] * 3 if isinstance(hidden_size, int) else list(hidden_size)
        convs, c_in = [], nvar_in
        for c in sizes + [nvar_out]:
            convs.append(Conv(c_in, c, (k, k), strides=s, padding=p, generator=g))
            c_in = c
        self.convs = nn.ModuleList(convs)
        self.to(device)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        h = x[self.input_keys[0]]
        h = resize(h, (h.shape[0], h.shape[1], self.ny, self.nx), "bilinear")
        for i, conv in enumerate(self.convs):
            h = conv(h)
            if i < len(self.convs) - 1:
                h = F.relu(h)
        return {self.output_keys[0]: h}


class HEDeepONets(base.Arch):
    """Heat-exchanger DeepONet: hot and cold boundary branch MLPs and a
    trunk MLP, each with ``num_features`` outputs per output key; output
    key i is the sum over its feature block of the three products, plus
    ``b[i]``."""

    def __init__(self, heat_input_keys: Tuple[str, ...], cold_input_keys: Tuple[str, ...],
                 trunk_input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], heat_num_loc: int,
                 cold_num_loc: int, num_features: int, branch_num_layers: int, trunk_num_layers: int,
                 branch_hidden_size: Union[int, Sequence[int]], trunk_hidden_size: Union[int, Sequence[int]],
                 branch_activation: str = "tanh", trunk_activation: str = "tanh", use_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = _gen(generator)
        self.heat_input_keys = tuple(heat_input_keys)
        self.cold_input_keys = tuple(cold_input_keys)
        self.trunk_input_keys = tuple(trunk_input_keys)
        self.input_keys = self.heat_input_keys + self.cold_input_keys + self.trunk_input_keys
        self.output_keys = tuple(output_keys)
        self.num_features = num_features
        width = num_features * len(output_keys)
        self.heat_net = mlp.MLP(self.heat_input_keys, ("b",), branch_num_layers, branch_hidden_size,
                                branch_activation, input_dim=heat_num_loc, output_dim=width, generator=g,
                                device="cpu")
        self.cold_net = mlp.MLP(self.cold_input_keys, ("b",), branch_num_layers, branch_hidden_size,
                                branch_activation, input_dim=cold_num_loc, output_dim=width, generator=g,
                                device="cpu")
        self.trunk_net = mlp.MLP(self.trunk_input_keys, ("t",), trunk_num_layers, trunk_hidden_size,
                                 trunk_activation, input_dim=len(trunk_input_keys), output_dim=width, generator=g,
                                 device="cpu")
        self.use_bias = use_bias
        if use_bias:
            self.b = nn.Parameter(torch.zeros(len(output_keys)))
        self.to(device)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        heat = self.heat_net({k: x[k] for k in self.heat_input_keys})["b"]
        cold = self.cold_net({k: x[k] for k in self.cold_input_keys})["b"]
        trunk = self.trunk_net({k: x[k] for k in self.trunk_input_keys})["t"]
        nf, out = self.num_features, {}
        for i, key in enumerate(self.output_keys):
            sl = slice(i * nf, (i + 1) * nf)
            y = torch.sum(heat[:, sl] * cold[:, sl] * trunk[:, sl], dim=-1, keepdim=True)
            out[key] = y + self.b[i] if self.use_bias else y
        return out


class ChipDeepONets(base.Arch):
    """Chip-thermal DeepONet: power-map, boundary-type and boundary-value
    branch MLPs and a coordinate trunk MLP, ``num_features`` outputs each;
    the output is the sum of their four-way product plus ``b``."""

    def __init__(self, branch_input_keys: Tuple[str, ...], BCtype_input_keys: Tuple[str, ...],
                 BC_input_keys: Tuple[str, ...], trunk_input_keys: Tuple[str, ...], output_keys: Tuple[str, ...],
                 num_loc: int, bctype_loc: int, BC_num_loc: int, num_features: int, branch_num_layers: int,
                 BC_num_layers: int, trunk_num_layers: int, branch_hidden_size: Union[int, Sequence[int]],
                 BC_hidden_size: Union[int, Sequence[int]], trunk_hidden_size: Union[int, Sequence[int]],
                 branch_activation: str = "swish", BC_activation: str = "swish", trunk_activation: str = "swish",
                 use_bias: bool = True, *, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = _gen(generator)
        self.branch_input_keys = tuple(branch_input_keys)
        self.BCtype_input_keys = tuple(BCtype_input_keys)
        self.BC_input_keys = tuple(BC_input_keys)
        self.trunk_input_keys = tuple(trunk_input_keys)
        self.input_keys = self.branch_input_keys + self.BCtype_input_keys + self.BC_input_keys + self.trunk_input_keys
        self.output_keys = tuple(output_keys)
        self.branch_net = mlp.MLP(self.branch_input_keys, ("b",), branch_num_layers, branch_hidden_size,
                                  branch_activation, input_dim=num_loc, output_dim=num_features, generator=g,
                                  device="cpu")
        self.BCtype_net = mlp.MLP(self.BCtype_input_keys, ("b",), BC_num_layers, BC_hidden_size, BC_activation,
                                  input_dim=bctype_loc, output_dim=num_features, generator=g, device="cpu")
        self.BC_net = mlp.MLP(self.BC_input_keys, ("b",), BC_num_layers, BC_hidden_size, BC_activation,
                              input_dim=BC_num_loc, output_dim=num_features, generator=g, device="cpu")
        self.trunk_net = mlp.MLP(self.trunk_input_keys, ("t",), trunk_num_layers, trunk_hidden_size,
                                 trunk_activation, input_dim=len(trunk_input_keys), output_dim=num_features,
                                 generator=g, device="cpu")
        self.use_bias = use_bias
        if use_bias:
            self.b = nn.Parameter(torch.zeros(1))
        self.to(device)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        b = self.branch_net({k: x[k] for k in self.branch_input_keys})["b"]
        bct = self.BCtype_net({k: x[k] for k in self.BCtype_input_keys})["b"]
        bc = self.BC_net({k: x[k] for k in self.BC_input_keys})["b"]
        t = self.trunk_net({k: x[k] for k in self.trunk_input_keys})["t"]
        out = torch.sum(b * bct * bc * t, dim=-1, keepdim=True)
        return {self.output_keys[0]: out + self.b if self.use_bias else out}


class _TransformerBlock(nn.Module):
    """Pre-norm block: causal or full self-attention, optional
    cross-attention over a context, a GELU feed-forward."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int, causal: bool = False, cross: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.ln1 = LayerNorm(d_model)
        self.qkv = Linear(d_model, 3 * d_model, generator=g)
        self.proj = Linear(d_model, d_model, generator=g)
        self.causal = causal
        self.cross = cross
        if cross:
            self.ln_x = LayerNorm(d_model)
            self.q_x = Linear(d_model, d_model, generator=g)
            self.kv_x = Linear(d_model, 2 * d_model, generator=g)
            self.proj_x = Linear(d_model, d_model, generator=g)
        self.ln2 = LayerNorm(d_model)
        self.fc1 = Linear(d_model, d_ff, generator=g)
        self.fc2 = Linear(d_ff, d_model, generator=g)
        self.h = num_heads
        self.d = d_model

    def _mha(self, q, k, v, causal: bool):
        B, T, E = q.shape
        S = k.shape[1]
        H = self.h
        q = q.reshape(B, T, H, E // H)
        k = k.reshape(B, S, H, E // H)
        v = v.reshape(B, S, H, E // H)
        att = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(E // H)
        if causal:
            mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril()
            att = torch.where(mask, att, torch.full_like(att, -1e9))
        att = torch.softmax(att, dim=-1)
        return torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, E)

    def forward(self, x, context=None):
        q, k, v = torch.chunk(self.qkv(self.ln1(x)), 3, dim=-1)
        x = x + self.proj(self._mha(q, k, v, self.causal))
        if self.cross and context is not None:
            q = self.q_x(self.ln_x(x))
            k, v = torch.chunk(self.kv_x(context), 2, dim=-1)
            x = x + self.proj_x(self._mha(q, k, v, False))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))


class Transformer(base.Arch):
    """Encoder-decoder transformer over token ids: ``input_keys[0]`` the
    source (B, S), ``input_keys[1]`` the target (B, T) (the source again
    when absent) -> ``output_keys[0]`` logits (B, T, tgt_vocab_size)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], src_vocab_size: int = 512,
                 tgt_vocab_size: int = 512, d_model: int = 256, num_heads: int = 8, num_layers: int = 4,
                 d_ff: int = 1024, max_len: int = 256, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = _gen(generator)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.d_model = d_model
        self.num_heads = num_heads
        self.src_embed = Embedding(src_vocab_size, d_model, generator=g)
        self.tgt_embed = Embedding(tgt_vocab_size, d_model, generator=g)
        self.enc_blocks = nn.ModuleList(_TransformerBlock(d_model, num_heads, d_ff, causal=False, generator=g)
                                        for _ in range(num_layers))
        self.dec_blocks = nn.ModuleList(_TransformerBlock(d_model, num_heads, d_ff, causal=True, cross=True,
                                                          generator=g) for _ in range(num_layers))
        self.ln = LayerNorm(d_model)
        self.head = Linear(d_model, tgt_vocab_size, generator=g)
        self.max_len = max_len
        self.to(device)

    def _pos(self, n: int, device) -> torch.Tensor:
        """(n, d_model): sin(pos / 10000^(2i/d)) in column 2i, cos in 2i + 1."""
        pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
        i = torch.arange(self.d_model // 2, dtype=torch.float32, device=device)[None, :]
        angle = pos / torch.pow(torch.full_like(i, 10000.0), 2 * i / self.d_model)
        pe = torch.zeros(n, self.d_model, device=device)
        pe[:, 0::2] = torch.sin(angle)
        pe[:, 1::2] = torch.cos(angle)
        return pe

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        src = x[self.input_keys[0]].to(torch.int32)
        tgt = x[self.input_keys[1]].to(torch.int32) if len(self.input_keys) > 1 else src
        h = self.src_embed(src) + self._pos(src.shape[1], src.device)[None]
        for blk in self.enc_blocks:
            h = blk(h)
        d = self.tgt_embed(tgt) + self._pos(tgt.shape[1], tgt.device)[None]
        for blk in self.dec_blocks:
            d = blk(d, context=h)
        return {self.output_keys[0]: self.head(self.ln(d))}
