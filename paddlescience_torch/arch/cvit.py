"""CVit1D and CVit, the continuous vision-transformer operators
(counterpart of ``paddlescience_tpu/arch/cvit.py``).

An encoder (a strided-conv patchifier, sin-cos position embeddings that
train after their initialisation, and pre-norm self-attention blocks; the
3-D encoder adds a time embedding and a ``TimeAggregation`` perceiver in
which learnable latents cross-attend over the time axis of each spatial
patch) and a decoder (query embeddings of the coordinates, either a
nearest-grid softmax lookup of learnable grid latents or an MLP, then
cross-attention blocks from the queries into the encoded function, then a
residual LayerNorm MLP head). Attention is the JAX package's plain
scaled dot product (``_MHA``: separate q, k, v and output projections),
written with ``torch.einsum`` and ``softmax`` as it is written with
``jnp`` there; GELU is the tanh form; LayerNorm takes the configured eps.
Convolutions run channel-first here (the JAX encoders run channel-last).
When the query coordinates come batched (B, N, C), the first row's are
used for every sample, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.arch.fno import gelu_tanh
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv, LayerNorm, Linear

__all__ = ["CVit1D", "CVit", "TimeAggregation", "get_1d_sincos_pos_embed", "get_2d_sincos_pos_embed"]


def _sincos_1d(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    omega = torch.arange(embed_dim // 2, dtype=torch.float32) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = torch.einsum("m,d->md", pos.reshape(-1), omega)
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)  # (M, D)


def get_1d_sincos_pos_embed(embed_dim: int, length: int) -> torch.Tensor:
    return _sincos_1d(embed_dim, torch.arange(length, dtype=torch.float32))[None]


def get_2d_sincos_pos_embed(embed_dim: int, grid_size) -> torch.Tensor:
    gh = torch.arange(grid_size[0], dtype=torch.float32)
    gw = torch.arange(grid_size[1], dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(gw, gh, indexing="ij"), dim=0)  # w first, as the JAX package
    return torch.cat([_sincos_1d(embed_dim // 2, grid[0]), _sincos_1d(embed_dim // 2, grid[1])], dim=1)[None]


def _linspace01(n: int) -> torch.Tensor:
    """n points on [0, 1] as ``jnp.linspace(0, 1, n)`` gives them in float32
    (i times the float32 reciprocal of n - 1, then 1): the grid query
    embedding's softmax of -1e5 x the squared distance reads the last bits
    of the grid."""
    if n == 1:
        return torch.zeros(1)
    inv = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(float(n - 1), dtype=torch.float32)
    return torch.cat([torch.arange(n - 1, dtype=torch.float32) * inv, torch.ones(1)])


def _normal(shape, std: float, generator: torch.Generator) -> nn.Parameter:
    return nn.Parameter(std * torch.randn(shape, generator=generator))


class _MHA(nn.Module):
    """Multi-head scaled dot-product attention with q, k, v and output
    projections (with bias)."""

    def __init__(self, dim: int, num_heads: int, kv_dim: Optional[int] = None, *, generator: torch.Generator):
        super().__init__()
        kv_dim = kv_dim or dim
        self.q = Linear(dim, dim, generator=generator)
        self.k = Linear(kv_dim, dim, generator=generator)
        self.v = Linear(kv_dim, dim, generator=generator)
        self.o = Linear(dim, dim, generator=generator)
        self.h = num_heads

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor) -> torch.Tensor:
        *batch, T, E = q_in.shape
        S, H = kv_in.shape[-2], self.h
        q = self.q(q_in).reshape(*batch, T, H, E // H)
        k = self.k(kv_in).reshape(*batch, S, H, E // H)
        v = self.v(kv_in).reshape(*batch, S, H, E // H)
        att = torch.softmax(torch.einsum("...thd,...shd->...hts", q, k) / math.sqrt(E // H), dim=-1)
        return self.o(torch.einsum("...hts,...shd->...thd", att, v).reshape(*batch, T, E))


class _MlpBlock(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden, generator=generator)
        self.fc2 = Linear(hidden, out_dim, generator=generator)

    def forward(self, x):
        return self.fc2(gelu_tanh(self.fc1(x)))


class _SelfAttnBlock(nn.Module):
    def __init__(self, num_heads: int, emb_dim: int, mlp_ratio: int, eps: float, *, generator: torch.Generator):
        super().__init__()
        self.ln1 = LayerNorm(emb_dim, epsilon=eps)
        self.attn = _MHA(emb_dim, num_heads, generator=generator)
        self.ln2 = LayerNorm(emb_dim, epsilon=eps)
        self.mlp = _MlpBlock(emb_dim, emb_dim * mlp_ratio, emb_dim, generator=generator)

    def forward(self, x):
        h = self.ln1(x)
        x = x + self.attn(h, h)
        return x + self.mlp(self.ln2(x))


class _CrossAttnBlock(nn.Module):
    def __init__(self, num_heads: int, emb_dim: int, mlp_ratio: int, eps: float, *, generator: torch.Generator):
        super().__init__()
        self.ln_q = LayerNorm(emb_dim, epsilon=eps)
        self.ln_kv = LayerNorm(emb_dim, epsilon=eps)
        self.attn = _MHA(emb_dim, num_heads, generator=generator)
        self.ln_y = LayerNorm(emb_dim, epsilon=eps)
        self.mlp = _MlpBlock(emb_dim, emb_dim * mlp_ratio, emb_dim, generator=generator)

    def forward(self, q_inputs, kv_inputs):
        x = self.attn(self.ln_q(q_inputs), self.ln_kv(kv_inputs)) + q_inputs
        return x + self.mlp(self.ln_y(x))


class _Mlp(nn.Module):
    """x <- norm(x + gelu(linear(x))) per layer, then a linear output."""

    def __init__(self, num_layers: int, hidden_dim: int, out_dim: int, eps: float, *, generator: torch.Generator):
        super().__init__()
        self.linears = nn.ModuleList(Linear(hidden_dim, hidden_dim, generator=generator) for _ in range(num_layers))
        self.norms = nn.ModuleList(LayerNorm(hidden_dim, epsilon=eps) for _ in range(num_layers))
        self.out = Linear(hidden_dim, out_dim, generator=generator)

    def forward(self, x):
        for lin, norm in zip(self.linears, self.norms):
            x = norm(x + gelu_tanh(lin(x)))
        return self.out(x)


class TimeAggregation(nn.Module):
    """(B, T, S, D) -> (B, num_latents, S, D): learnable latents
    cross-attend over the time axis of each spatial patch."""

    def __init__(self, emb_dim: int, depth: int, num_heads: int = 8, num_latents: int = 64, mlp_ratio: int = 1,
                 eps: float = 1e-5, *, generator: torch.Generator):
        super().__init__()
        self.latents = _normal((num_latents, emb_dim), 1e-2, generator)
        self.blocks = nn.ModuleList(_CrossAttnBlock(num_heads, emb_dim, mlp_ratio, eps, generator=generator)
                                    for _ in range(depth))

    def forward(self, x):
        B, T, S, D = x.shape
        latents = self.latents[None, None].expand((B, S) + tuple(self.latents.shape))
        x = x.transpose(1, 2)  # (B, S, T, D)
        for blk in self.blocks:
            latents = blk(latents, x)
        return latents.transpose(1, 2)


class Encoder1D(nn.Module):
    """(B, L, C) -> (B, L / p, D): patchify, position embedding,
    self-attention blocks."""

    def __init__(self, in_dim, spatial_dims, patch_size, emb_dim, depth, num_heads, mlp_ratio, eps, *,
                 generator: torch.Generator):
        super().__init__()
        self.patch_conv = Conv(in_dim, emb_dim, (patch_size[0],), strides=patch_size[0], padding="VALID",
                               generator=generator)
        self.pos_emb = nn.Parameter(get_1d_sincos_pos_embed(emb_dim, spatial_dims // patch_size[0]))
        self.blocks = nn.ModuleList(_SelfAttnBlock(num_heads, emb_dim, mlp_ratio, eps, generator=generator)
                                    for _ in range(depth))

    def forward(self, x):
        x = self.patch_conv(x.transpose(1, 2)).transpose(1, 2) + self.pos_emb
        for blk in self.blocks:
            x = blk(x)
        return x


class Encoder(nn.Module):
    """(B, T, H, W, C) -> (B, S, D): 3-D patchify, time and space
    embeddings, time aggregation, LayerNorm, self-attention blocks."""

    def __init__(self, in_dim, spatial_dims, patch_size, emb_dim, depth, num_heads, mlp_ratio, eps, *,
                 generator: torch.Generator):
        super().__init__()
        t, h, w = spatial_dims
        self.num_patches = (t // patch_size[0], h // patch_size[1], w // patch_size[2])
        self.patch_conv = Conv(in_dim, emb_dim, tuple(patch_size), strides=tuple(patch_size), padding="VALID",
                               generator=generator)
        self.time_agg = TimeAggregation(emb_dim, depth=2, num_heads=num_heads, num_latents=1, mlp_ratio=mlp_ratio,
                                        eps=eps, generator=generator)
        self.norm = LayerNorm(emb_dim, epsilon=eps)
        self.time_emb = nn.Parameter(get_1d_sincos_pos_embed(emb_dim, self.num_patches[0]))
        self.pos_emb = nn.Parameter(get_2d_sincos_pos_embed(emb_dim, (self.num_patches[1], self.num_patches[2])))
        self.blocks = nn.ModuleList(_SelfAttnBlock(num_heads, emb_dim, mlp_ratio, eps, generator=generator)
                                    for _ in range(depth))

    def forward(self, x):
        b = x.shape[0]
        x = self.patch_conv(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)  # (B, T', H', W', D)
        tp, hp, wp = self.num_patches
        x = x.reshape(b, tp, hp * wp, -1)
        x = x + self.time_emb[:, :, None] + self.pos_emb[:, None]
        x = self.norm(self.time_agg(x))  # (B, 1, S, D)
        x = x.reshape(b, -1, x.shape[-1])
        for blk in self.blocks:
            x = blk(x)
        return x


class _GridQueryEmbed(nn.Module):
    """Query coordinates -> embeddings: a softmax of -1e5 x the squared
    distance to each grid point weights the grid's learnable latents."""

    def __init__(self, grid: torch.Tensor, latent_dim: int, dec_emb_dim: int, eps: float, *,
                 generator: torch.Generator):
        super().__init__()
        self.register_buffer("grid", grid, persistent=False)  # (G,) or (G, 2), fixed
        self.latents = _normal((grid.shape[0], latent_dim), 1e-2, generator)
        self.fc = Linear(latent_dim, dec_emb_dim, generator=generator)
        self.norm = LayerNorm(dec_emb_dim, epsilon=eps)

    def forward(self, coords):
        if self.grid.ndim == 1:
            d2 = (coords - self.grid[None, :]) ** 2  # (P, G)
        else:
            d2 = torch.sum((coords[:, None, :] - self.grid[None]) ** 2, dim=-1)
        w = torch.softmax(-1e5 * d2, dim=1)
        return self.norm(self.fc(torch.einsum("ic,pi->pc", self.latents, w)))


class _MlpQueryEmbed(nn.Module):
    def __init__(self, coords_dim: int, dec_emb_dim: int, eps: float, *, generator: torch.Generator):
        super().__init__()
        self.mlp = _MlpBlock(coords_dim, dec_emb_dim, dec_emb_dim, generator=generator)
        self.norm = LayerNorm(dec_emb_dim, epsilon=eps)

    def forward(self, coords):
        return self.norm(self.mlp(coords))


class _CVitBase(Arch):
    """The decoder and head that CVit1D and CVit share."""

    def _build_decoder(self, emb_dim, dec_emb_dim, dec_num_heads, dec_depth, num_mlp_layers, mlp_ratio, out_dim, eps,
                       g):
        self.enc_norm = LayerNorm(emb_dim, epsilon=eps)
        self.fc1 = Linear(emb_dim, dec_emb_dim, generator=g)
        self.cross_blocks = nn.ModuleList(_CrossAttnBlock(dec_num_heads, dec_emb_dim, mlp_ratio, eps, generator=g)
                                          for _ in range(dec_depth))
        self.block_norm = LayerNorm(dec_emb_dim, epsilon=eps)
        self.final_mlp = _Mlp(num_mlp_layers, dec_emb_dim, out_dim, eps, generator=g)

    def _decode(self, enc, cemb, b):
        x = self.fc1(self.enc_norm(enc))
        q = cemb[None].expand((b,) + tuple(cemb.shape))
        for blk in self.cross_blocks:
            q = blk(q, x)
        return self.final_mlp(self.block_norm(q))

    def forward(self, x_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x, coords = x_dict[self.input_keys[0]], x_dict[self.input_keys[1]]
        if coords.ndim >= 3:
            coords = coords[0]  # (B, N, C) -> (N, C): one set of queries for the batch
        return {self.output_keys[0]: self.forward_tensor(x, coords)}


class CVit1D(_CVitBase):
    """1-D continuous ViT operator: (B, L, C) functions, (N, 1) queries."""

    def __init__(self, input_keys: Sequence[str], output_keys: Sequence[str], spatial_dims: int, in_dim: int,
                 coords_dim: int, patch_size: Sequence[int] = (4,), grid_size: Sequence[int] = (200,),
                 latent_dim: int = 256, emb_dim: int = 256, depth: int = 3, num_heads: int = 8,
                 dec_emb_dim: int = 256, dec_num_heads: int = 8, dec_depth: int = 1, num_mlp_layers: int = 1,
                 mlp_ratio: int = 1, out_dim: int = 1, layer_norm_eps: float = 1e-5, embedding_type: str = "grid",
                 *, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.embedding_type = embedding_type
        eps = layer_norm_eps
        if embedding_type == "grid":
            self.query_embed = _GridQueryEmbed(_linspace01(grid_size[0]), latent_dim, dec_emb_dim, eps,
                                               generator=g)
        else:
            self.query_embed = _MlpQueryEmbed(coords_dim, dec_emb_dim, eps, generator=g)
        self.encoder = Encoder1D(in_dim, spatial_dims, patch_size, emb_dim, depth, num_heads, mlp_ratio, eps,
                                 generator=g)
        self._build_decoder(emb_dim, dec_emb_dim, dec_num_heads, dec_depth, num_mlp_layers, mlp_ratio, out_dim, eps, g)
        self.to(resolve_device(device))

    def forward_tensor(self, x, coords):
        return self._decode(self.encoder(x), self.query_embed(coords), x.shape[0])


class CVit(_CVitBase):
    """(T, H, W) continuous ViT operator: (B, T, H, W, C) (or (B, H, W, C),
    one frame) functions, (N, 2) queries."""

    def __init__(self, input_keys: Sequence[str], output_keys: Sequence[str], in_dim: int, coords_dim: int,
                 spatial_dims: Sequence[int], patch_size: Sequence[int] = (1, 16, 16),
                 grid_size: Sequence[int] = (128, 128), latent_dim: int = 256, emb_dim: int = 256, depth: int = 3,
                 num_heads: int = 8, dec_emb_dim: int = 256, dec_num_heads: int = 8, dec_depth: int = 1,
                 num_mlp_layers: int = 1, mlp_ratio: int = 1, out_dim: int = 1, layer_norm_eps: float = 1e-5,
                 embedding_type: str = "grid", *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.embedding_type = embedding_type
        eps = layer_norm_eps
        if len(spatial_dims) == 2:  # plain 2-D inputs: a one-frame volume
            spatial_dims = (1, *spatial_dims)
            patch_size = (1, *patch_size) if len(patch_size) == 2 else patch_size
        if embedding_type == "grid":
            gh, gw = grid_size
            gx, gy = torch.meshgrid(_linspace01(gh), _linspace01(gw), indexing="ij")
            grid = torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (gh gw, 2)
            self.query_embed = _GridQueryEmbed(grid, latent_dim, dec_emb_dim, eps, generator=g)
        else:
            self.query_embed = _MlpQueryEmbed(coords_dim, dec_emb_dim, eps, generator=g)
        self.encoder = Encoder(in_dim, spatial_dims, patch_size, emb_dim, depth, num_heads, mlp_ratio, eps,
                               generator=g)
        self._build_decoder(emb_dim, dec_emb_dim, dec_num_heads, dec_depth, num_mlp_layers, mlp_ratio, out_dim, eps, g)
        self.to(resolve_device(device))

    def forward_tensor(self, x, coords):
        if x.ndim == 4:  # (B, H, W, C): one frame
            x = x[:, None]
        return self._decode(self.encoder(x), self.query_embed(coords), x.shape[0])
