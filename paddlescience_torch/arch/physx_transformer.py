"""PhysformerGPT2, a GPT-2 style decoder over embedded physics states
(counterpart of ``paddlescience_tpu/arch/physx_transformer.py``).

Sinusoidal position embeddings, pre-LayerNorm blocks of causal masked
self-attention (plain ``torch.einsum`` and ``softmax``: scores above the
diagonal filled with -1e9 before the softmax, as in the JAX package) and a
tanh-GELU MLP, a final LayerNorm and a linear head. ``generate`` rolls the
model out, each step's last prediction appended to the sequence (the last
``num_ctx`` entries its context). With an ``embedding_model`` the inputs
are encoded first and the outputs decoded. The model always runs its
teacher-forced forward (the JAX class's ``training`` flag, which nothing
there turns off). The dropout rates are accepted and unused, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch.base import Arch
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import LayerNorm, Linear

__all__ = ["PhysformerGPT2"]


def _normal_init(std: float):
    @torch.no_grad()
    def init(tensor: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return tensor.normal_(0.0, std, generator=generator)

    return init


class _Block(nn.Module):
    """Pre-LN block: causal attention, then the 4x MLP, each residual."""

    def __init__(self, num_ctx: int, embed_size: int, num_heads: int, initializer_range: float, *,
                 generator: torch.Generator):
        super().__init__()
        init, g = _normal_init(initializer_range), generator
        self.ln1 = LayerNorm(embed_size)
        self.qkv = Linear(embed_size, 3 * embed_size, kernel_init=init, generator=g)
        self.proj = Linear(embed_size, embed_size, kernel_init=init, generator=g)
        self.ln2 = LayerNorm(embed_size)
        self.fc1 = Linear(embed_size, 4 * embed_size, kernel_init=init, generator=g)
        self.fc2 = Linear(4 * embed_size, embed_size, kernel_init=init, generator=g)
        self.num_heads = num_heads
        self.embed_size = embed_size

    def _attn(self, x: torch.Tensor) -> torch.Tensor:
        B, T, E = x.shape
        H = self.num_heads
        qkv = self.qkv(x).reshape(B, T, 3, H, E // H)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(E // H)
        causal = torch.ones((T, T), dtype=torch.bool, device=x.device).tril()
        att = torch.softmax(torch.where(causal, att, torch.full_like(att, -1e9)), dim=-1)
        return self.proj(torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, E))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self._attn(self.ln1(x))
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="tanh"))


class PhysformerGPT2(Arch):
    """Transformer decoder over embedded physics states: (B, T, E) ->
    (B, T, E) next-step predictions."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], num_layers: int, num_ctx: int,
                 embed_size: int, num_heads: int, embd_pdrop: float = 0.0, attn_pdrop: float = 0.0,
                 resid_pdrop: float = 0.0, initializer_range: float = 0.05, embedding_model: Optional[Arch] = None,
                 *, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.num_layers, self.num_ctx, self.embed_size, self.num_heads = num_layers, num_ctx, embed_size, num_heads
        self.blocks = nn.ModuleList(_Block(num_ctx, embed_size, num_heads, initializer_range, generator=g)
                                    for _ in range(num_layers))
        self.ln = LayerNorm(embed_size)
        self.linear = Linear(embed_size, embed_size, kernel_init=_normal_init(initializer_range), generator=g)
        self.embedding_model = embedding_model  # a child: its parameters train with this model's, as in JAX
        self.to(resolve_device(device))

    @staticmethod
    def get_position_embed(x: torch.Tensor) -> torch.Tensor:
        """Sinusoidal embedding: sin at even, cos at odd channels."""
        B, N, E = x.shape
        position = torch.arange(N, dtype=torch.float32, device=x.device)[:, None]
        i = torch.arange(E // 2, dtype=torch.float32, device=x.device)[None, :]
        angle = position / torch.pow(10000.0, 2 * i / E)
        pe = torch.stack([torch.sin(angle), torch.cos(angle)], dim=-1).reshape(N, E)
        return pe[None].expand(B, N, E)

    def forward_tensor(self, x: torch.Tensor):
        h = x + self.get_position_embed(x)
        for block in self.blocks:
            h = block(h)
        return (self.linear(self.ln(h)),)

    def generate(self, input_embeds: torch.Tensor, max_length: Optional[int] = None) -> torch.Tensor:
        """The rollout to ``max_length`` entries (default ``num_ctx``)."""
        seq = input_embeds
        for _ in range((max_length or self.num_ctx) - 1):
            pred = self.forward_tensor(seq[:, -self.num_ctx:])[0]
            seq = torch.cat([seq, pred[:, -1:]], dim=1)
        return seq

    @staticmethod
    def split_to_dict(data_tensors, keys):
        return {key: data_tensors[i] for i, key in enumerate(keys)}

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        x_tensor = self.concat_to_tensor(x, self.input_keys)
        emb = self.embedding_model
        if emb is not None:
            from paddlescience_torch.arch.embedding_koopman import CylinderEmbedding

            x_tensor = emb.encoder(x_tensor, x["visc"]) if isinstance(emb, CylinderEmbedding) else emb.encoder(x_tensor)
        y = self.forward_tensor(x_tensor)
        if emb is not None:
            y = tuple(emb.decoder(t) for t in y)
        return self.split_to_dict(y, self.output_keys)
