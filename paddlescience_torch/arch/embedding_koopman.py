"""Koopman-operator embedding networks (counterpart of
``paddlescience_tpu/arch/embedding_koopman.py``).

An encoder to an embedding, a learned Koopman matrix that advances the
embedding one step (a batched matmul), and a decoder back to the state.
``LorenzEmbedding`` (and ``RosslerEmbedding``, the same net): MLP encoder
and decoder (ReLU, LayerNorm on the embedding, inputs normalised by the
``mean`` and ``std`` buffers), and a Koopman matrix of a learned diagonal
and two skew-symmetric bands. ``CylinderEmbedding``: replicate-padded
conv encoder and decoder over a 64 x 128 grid (the decoder upsamples with
``jax.image.resize``'s bilinear rule and zeroes the cylinder), and a
per-sample banded Koopman matrix whose diagonal and four upper and lower
bands are small MLPs of 100 x the viscosity.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv, LayerNorm, Linear
from paddlescience_torch.nn.resize import resize

__all__ = ["LorenzEmbedding", "RosslerEmbedding", "CylinderEmbedding"]


@torch.no_grad()
def linear_init_(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) of an (in, out) kernel."""
    bound = 1.0 / float(np.sqrt(tensor.shape[-2]))
    return tensor.uniform_(-bound, bound, generator=generator)


class LorenzEmbedding(Arch):
    """x (B, T, D) -> (pred (B, T-1, D), recover (B, T, D), koopman matrix
    (E, E)) under ``output_keys`` (as many as are named)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...],
                 mean: Optional[Tuple[float, ...]] = None, std: Optional[Tuple[float, ...]] = None,
                 input_size: int = 3, hidden_size: int = 500, embed_size: int = 32, drop: float = 0.0, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.input_size, self.hidden_size, self.embed_size = input_size, hidden_size, embed_size
        self.enc1 = Linear(input_size, hidden_size, kernel_init=linear_init_, generator=g)
        self.enc2 = Linear(hidden_size, embed_size, kernel_init=linear_init_, generator=g)
        self.enc_norm = LayerNorm(embed_size)
        self.dec1 = Linear(embed_size, hidden_size, kernel_init=linear_init_, generator=g)
        self.dec2 = Linear(hidden_size, input_size, kernel_init=linear_init_, generator=g)
        self.k_diag = nn.Parameter(torch.linspace(1, 0, embed_size))
        self.k_ut = nn.Parameter(0.1 * torch.rand((2 * embed_size - 3,), generator=g))
        mean = [0.0] * input_size if mean is None else list(mean)
        std = [1.0] * input_size if std is None else list(std)
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32).reshape(1, input_size))
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32).reshape(1, input_size))
        self.to(resolve_device(device))

    def encoder(self, x: torch.Tensor) -> torch.Tensor:
        x = (x - self.mean) / self.std
        return self.enc_norm(self.enc2(F.relu(self.enc1(x))))

    def decoder(self, g: torch.Tensor) -> torch.Tensor:
        return self.std * self.dec2(F.relu(self.dec1(g))) + self.mean

    def get_koopman_matrix(self) -> torch.Tensor:
        e = self.embed_size
        ut = torch.diag(self.k_ut[: e - 1], 1) + torch.diag(self.k_ut[e - 1:], 2)
        return ut - ut.T + torch.diag(self.k_diag)

    @staticmethod
    def koopman_operation(embed_data: torch.Tensor, k_matrix: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bte,fe->btf", embed_data, k_matrix)

    def forward_tensor(self, x: torch.Tensor):
        k_matrix = self.get_koopman_matrix()
        embed = self.encoder(x)
        recover = self.decoder(embed)
        pred = self.decoder(self.koopman_operation(embed, k_matrix))
        return pred[:, :-1, :], recover, k_matrix

    @staticmethod
    def split_to_dict(data_tensors, keys):
        return {key: data_tensors[i] for i, key in enumerate(keys)}

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self.split_to_dict(self.forward_tensor(self.concat_to_tensor(x, self.input_keys)), self.output_keys)


class RosslerEmbedding(LorenzEmbedding):
    """The same net for the Rossler system."""


class _KoopmanBandNet(nn.Module):
    """1 -> 50 -> n MLP (ReLU) giving Koopman bands from the viscosity."""

    def __init__(self, out_features: int, *, generator: torch.Generator):
        super().__init__()
        self.fc1 = Linear(1, 50, kernel_init=linear_init_, generator=generator)
        self.fc2 = Linear(50, out_features, kernel_init=linear_init_, generator=generator)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class CylinderEmbedding(Arch):
    """(states (B, T, 3, 64, 128), visc (B, 1)) -> (pred (B, T-1, 3, 64,
    128), recover (B, T, 3, 64, 128), koopman matrices (B, E, E))."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...],
                 mean: Optional[Tuple[float, ...]] = None, std: Optional[Tuple[float, ...]] = None,
                 embed_size: int = 128, encoder_channels: Optional[Tuple[int, ...]] = None,
                 decoder_channels: Optional[Tuple[int, ...]] = None, drop: float = 0.0, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.embed_size = E = embed_size
        self.drop = drop
        enc_ch = list(encoder_channels or (4, 16, 32, 64, 128))
        dec_ch = list(decoder_channels or (embed_size // 32, 128, 64, 32, 16))
        X, Y = np.meshgrid(np.linspace(-2, 14, 128), np.linspace(-4, 4, 64))
        self.register_buffer("mask", torch.from_numpy((np.sqrt(X**2 + Y**2) >= 1).astype(np.float32)))
        rp = dict(padding=1, padding_mode="replicate", generator=g)
        self.enc_convs = nn.ModuleList(Conv(enc_ch[i - 1], enc_ch[i], (3, 3), strides=2, **rp)
                                       for i in range(1, len(enc_ch)))
        self.enc_out = Conv(enc_ch[-1], E // 32, (3, 3), **rp)
        self.enc_norm = LayerNorm(E)
        self.dec_convs = nn.ModuleList(Conv(dec_ch[i - 1], dec_ch[i], (3, 3), **rp) for i in range(1, len(dec_ch)))
        self.dec_out = Conv(dec_ch[-1], 3, (3, 3), **rp)
        self.k_diag_net = _KoopmanBandNet(E, generator=g)
        self.k_ut_net = _KoopmanBandNet(4 * E - 10, generator=g)
        self.k_lt_net = _KoopmanBandNet(4 * E - 10, generator=g)
        self.register_buffer("_xidx", torch.from_numpy(np.concatenate([np.arange(0, E - i) for i in range(1, 5)])),
                             persistent=False)
        self.register_buffer("_yidx", torch.from_numpy(np.concatenate([np.arange(i, E) for i in range(1, 5)])),
                             persistent=False)
        mean = [0.0] * 4 if mean is None else list(mean)
        std = [1.0] * 4 if std is None else list(std)
        self.register_buffer("mean", torch.tensor(mean, dtype=torch.float32).reshape(1, 4, 1, 1))
        self.register_buffer("std", torch.tensor(std, dtype=torch.float32).reshape(1, 4, 1, 1))
        self.to(resolve_device(device))

    def get_koopman_matrix(self, g, visc):
        B, E = visc.shape[0], self.embed_size
        v = 100.0 * visc
        k = visc.new_zeros((B, E, E))
        k[:, self._xidx, self._yidx] = self.k_ut_net(v)
        k[:, self._yidx, self._xidx] = self.k_lt_net(v)
        diag = torch.arange(E, device=visc.device)
        k[:, diag, diag] = self.k_diag_net(v)
        return k

    def encoder(self, x, visc):
        B, T, C, H, W = x.shape
        x = x.reshape(B * T, C, H, W)
        vmap = visc.reshape(B, 1).repeat_interleave(T, dim=1).reshape(B * T, 1, 1, 1)
        x = torch.cat([x, vmap * torch.ones_like(x[:, :1])], dim=1)
        h = (x - self.mean) / self.std
        for conv in self.enc_convs:
            h = F.relu(conv(h))
        h = self.enc_out(h)  # (B T, E / 32, 4, 8)
        return self.enc_norm(h.reshape(B * T, -1)).reshape(B, T, -1)

    def decoder(self, g):
        B, T, _ = g.shape
        h = g.reshape(B * T, self.embed_size // 32, 4, 8)
        for conv in self.dec_convs:
            h = resize(h, (h.shape[0], h.shape[1], h.shape[2] * 2, h.shape[3] * 2), "linear")
            h = F.relu(conv(h))
        h = self.dec_out(h)
        h = (self.std[:, :3] * h + self.mean[:, :3]) * self.mask
        return h.reshape(B, T, 3, h.shape[-2], h.shape[-1])

    @staticmethod
    def koopman_operation(embed_data, k_matrix):
        return torch.einsum("bef,btf->bte", k_matrix, embed_data)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        states, visc = x[self.input_keys[0]], x[self.input_keys[1]]
        embed = self.encoder(states, visc)
        recover = self.decoder(embed)
        k_matrix = self.get_koopman_matrix(embed, visc)
        pred = self.decoder(self.koopman_operation(embed, k_matrix))
        return LorenzEmbedding.split_to_dict((pred[:, :-1], recover, k_matrix), self.output_keys)
