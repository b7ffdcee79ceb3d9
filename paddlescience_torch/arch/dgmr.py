"""DGMR, the deep generative model of radar (counterpart of
``paddlescience_tpu/arch/dgmr.py``): the context conditioning stack, the
latent conditioning stack, the ConvGRU sampler, and the spatial and
temporal discriminators.

Channel-first throughout: frames are (B, C, H, W); the model's input and
output keep the JAX contract (B, T, C, H, W); the temporal discriminator's
3-D blocks see (B, C, T, H, W), depth = time. As in the JAX module:

* :func:`pixel_unshuffle` keeps JAX's channel order: output channel
  (i r + j) C + c reads input channel c at offset (i, j) (``F.pixel_unshuffle``
  orders them c r^2 + i r + j); the sampler's depth-to-space is
  ``nn/recurrent.py::pixel_shuffle``, JAX's order too;
* :class:`SNConv` and :class:`SNLinear` divide the weight by sigma from 5
  power iterations started at a fixed buffer ``u0`` (one entry an output
  channel) at every call, ``u0`` never updated (not
  ``torch.nn.utils.spectral_norm``, which runs one iteration and updates
  its ``u`` in place); vectors are normalised as u / (|u| + eps); the
  iteration runs on the detached (fan_in, C_out) matrix, so the gradient
  flows through W / sigma only. The port's (out, in, *window) kernel gives
  the matrix ``w.flatten(1).T``: its fan-in rows are JAX's in another
  order, to which sigma is blind;
* :class:`BatchNorm` normalises with the batch statistics and the biased
  variance, in training and in evaluation alike, and keeps no running
  statistics;
* :class:`AttentionLayer`'s ``last_conv`` takes ``output_channels // 8``
  inputs whatever the ratios, its gate ``gamma`` starts at 0;
* ``ContextConditioningStack`` stacks the T per-frame scales into the
  channels time-major, channel t C + c;
* the latent stack's N(0, 2) noise has one sample, (1, C, h, w), broadcast
  over the batch.

Computed in another arrangement, with the same values: the conditioning
stack runs its T frames through its blocks as one batch, the
discriminators their frames likewise up to the batch norm, and the
sampler its forecast steps outside the ConvGRU as one batch whose batch
norms take their statistics per step (``groups``). Each ConvGRU computes
its cell's three spectral-normalised kernels once for all its steps
(:meth:`ConvGRUCell.kernels`).

The JAX ``DGMR`` draws its latent noise from one fixed key (``PRNGKey(0)``,
or the key given to ``set_rng``) at every call. The port keeps that: the
(generation_steps, 1, C, h, w) standard normal draw is made once per shape
from a CPU ``torch.Generator`` seeded with 0 (or the seed given to
:meth:`DGMR.set_rng`), kept on the device and read at every call; nothing
is drawn inside a CUDA graph. :meth:`DGMR.set_noise` puts a given draw in
place (the parity tests pass JAX's in).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch import base
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv, Linear
from paddlescience_torch.nn.recurrent import pixel_shuffle

__all__ = ["DGMR", "DGMRGenerator", "DGMRDiscriminator", "DGMRDiscriminators", "ContextConditioningStack",
           "LatentConditioningStack", "Sampler", "SNConv", "SNLinear", "BatchNorm", "pixel_unshuffle"]


# ---------------------------------------------------------------- primitives --


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C, H r, W r) -> (B, C r^2, H, W), JAX's channel order."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // r, r, W // r, r).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(B, r * r * C, H // r, W // r)


def _avg_pool(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """Mean over windows of ``window`` with stride ``window`` over the
    spatial axes of (B, C, *spatial), a short edge dropped (XLA's
    "VALID"). A reshape and a mean: its backward adds nothing up twice."""
    n = [s // w for s, w in zip(x.shape[2:], window)]
    x = x[(slice(None), slice(None)) + tuple(slice(0, k * w) for k, w in zip(n, window))]
    shape = tuple(x.shape[:2]) + tuple(v for k, w in zip(n, window) for v in (k, w))
    return x.reshape(shape).mean(dim=tuple(range(3, 3 + 2 * len(window), 2)))


def _upsample(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of (B, C, H, W)."""
    B, C, H, W = x.shape
    return x[:, :, :, None, :, None].expand(B, C, H, 2, W, 2).reshape(B, C, 2 * H, 2 * W)


def _sn_sigma(mat: torch.Tensor, u0: torch.Tensor, eps: float, iters: int) -> torch.Tensor:
    """sigma of ``mat`` (fan_in, C_out) by ``iters`` power iterations from
    ``u0`` on the detached matrix; differentiable through ``mat`` only."""
    m = mat.detach()
    u = u0 / (torch.linalg.vector_norm(u0) + eps)
    for _ in range(iters):
        v = m @ u
        v = v / (torch.linalg.vector_norm(v) + eps)
        u = m.T @ v
        u = u / (torch.linalg.vector_norm(u) + eps)
    return v @ (mat @ u)


class _SpectralNorm:
    """The shared part of :class:`SNConv` and :class:`SNLinear`."""

    def _sn_init(self, out_features: int, sn_eps: float, power_iters: int, generator: torch.Generator) -> None:
        self.sn_eps = sn_eps
        self.power_iters = power_iters
        self.register_buffer("u0", torch.randn(out_features, generator=generator))

    def _normalised(self, mat: torch.Tensor) -> torch.Tensor:
        return self.weight / (_sn_sigma(mat, self.u0, self.sn_eps, self.power_iters) + self.sn_eps)


class SNConv(_SpectralNorm, Conv):
    """A spectral-normalised :class:`~paddlescience_torch.nn.layers.Conv`."""

    def __init__(self, *args, sn_eps: float = 1e-4, power_iters: int = 5, generator: torch.Generator, **kwargs):
        super().__init__(*args, generator=generator, **kwargs)
        self._sn_init(self.weight.shape[0], sn_eps, power_iters, generator)

    def _kernel(self) -> torch.Tensor:
        return self._normalised(self.weight.flatten(1).T)


class SNLinear(_SpectralNorm, Linear):
    """A spectral-normalised :class:`~paddlescience_torch.nn.layers.Linear`
    (W of shape (in, out))."""

    def __init__(self, *args, sn_eps: float = 1e-4, power_iters: int = 5, generator: torch.Generator, **kwargs):
        super().__init__(*args, generator=generator, **kwargs)
        self._sn_init(self.weight.shape[1], sn_eps, power_iters, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self._normalised(self.weight)
        return y + self.bias if self.bias is not None else y


class BatchNorm(nn.Module):
    """Normalisation of (N, C, *spatial) over N and the spatial axes with
    the batch statistics and the biased variance, then ``scale`` and
    ``shift`` per channel. With ``groups`` G the batch is G stacked
    batches of N / G, each normalised with its own statistics."""

    def __init__(self, num_features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(num_features))
        self.shift = nn.Parameter(torch.zeros(num_features))

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        shape = x.shape
        x = x.reshape((groups, shape[0] // groups) + tuple(shape[1:]))
        dims = (1,) + tuple(range(3, x.ndim))
        var, mean = torch.var_mean(x, dim=dims, correction=0, keepdim=True)
        affine = (-1,) + (1,) * (len(shape) - 2)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return (y.reshape(shape) * self.scale.reshape(affine)) + self.shift.reshape(affine)


# ------------------------------------------------------------------- blocks --


class GBlock(nn.Module):
    """Residual generator block without upsampling."""

    def __init__(self, input_channels: int, output_channels: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.bn1 = BatchNorm(input_channels)
        self.bn2 = BatchNorm(input_channels)
        self.conv_1x1 = SNConv(input_channels, output_channels, (1, 1), generator=g)
        self.first_conv_3x3 = SNConv(input_channels, input_channels, (3, 3), padding="SAME", generator=g)
        self.last_conv_3x3 = SNConv(input_channels, output_channels, (3, 3), padding="SAME", generator=g)
        self._proj = input_channels != output_channels

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        sc = self.conv_1x1(x) if self._proj else x
        h = self.first_conv_3x3(F.relu(self.bn1(x, groups)))
        h = self.last_conv_3x3(F.relu(self.bn2(h, groups)))
        return h + sc


class UpsampleGBlock(nn.Module):
    """Residual generator block with 2x nearest upsampling."""

    def __init__(self, input_channels: int, output_channels: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.bn1 = BatchNorm(input_channels)
        self.bn2 = BatchNorm(input_channels)
        self.conv_1x1 = SNConv(input_channels, output_channels, (1, 1), generator=g)
        self.first_conv_3x3 = SNConv(input_channels, input_channels, (3, 3), padding="SAME", generator=g)
        self.last_conv_3x3 = SNConv(input_channels, output_channels, (3, 3), padding="SAME", generator=g)

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        sc = self.conv_1x1(_upsample(x))
        h = self.first_conv_3x3(_upsample(F.relu(self.bn1(x, groups))))
        h = self.last_conv_3x3(F.relu(self.bn2(h, groups)))
        return h + sc


class DBlock(nn.Module):
    """Discriminator and conditioning residual block, 2-D or 3-D
    (``conv_type="3d"``): an optional first ReLU, a 2x mean-pool
    downsample unless ``keep_same_output``."""

    def __init__(self, input_channels: int, output_channels: int, conv_type: str = "standard",
                 first_relu: bool = True, keep_same_output: bool = False, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.first_relu = first_relu
        self.keep_same_output = keep_same_output
        is3d = conv_type == "3d"
        self._proj = input_channels != output_channels
        k = (3, 3, 3) if is3d else (3, 3)
        one = (1, 1, 1) if is3d else (1, 1)
        self._pool_window = (2, 2, 2) if is3d else (2, 2)
        self.conv_1x1 = SNConv(input_channels, output_channels, one, generator=g)
        self.first_conv_3x3 = SNConv(input_channels, output_channels, k, padding="SAME", generator=g)
        self.last_conv_3x3 = SNConv(output_channels, output_channels, k, padding="SAME", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._proj:
            sc = self.conv_1x1(x)
            if not self.keep_same_output:
                sc = _avg_pool(sc, self._pool_window)
        else:
            sc = x
        h = F.relu(x) if self.first_relu else x
        h = self.last_conv_3x3(F.relu(self.first_conv_3x3(h)))
        if not self.keep_same_output:
            h = _avg_pool(h, self._pool_window)
        return h + sc


class LBlock(nn.Module):
    """Latent-stack residual block growing the channels: the shortcut
    appends a 1x1 convolution's channels to its input."""

    def __init__(self, input_channels: int, output_channels: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self._grow = input_channels < output_channels
        if self._grow:
            self.conv_1x1 = Conv(input_channels, output_channels - input_channels, (1, 1), generator=g)
        self.first_conv_3x3 = Conv(input_channels, output_channels, (3, 3), padding="SAME", generator=g)
        self.last_conv_3x3 = Conv(output_channels, output_channels, (3, 3), padding="SAME", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = torch.cat([x, self.conv_1x1(x)], dim=1) if self._grow else x
        h = self.last_conv_3x3(F.relu(self.first_conv_3x3(F.relu(x))))
        return h + sc


class AttentionLayer(nn.Module):
    """Single-head spatial self-attention behind a zero-initialised gate
    ``gamma``."""

    def __init__(self, input_channels: int, output_channels: int, ratio_kq: int = 8, ratio_v: int = 8, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.query = Conv(input_channels, output_channels // ratio_kq, (1, 1), bias=False, generator=g)
        self.key = Conv(input_channels, output_channels // ratio_kq, (1, 1), bias=False, generator=g)
        self.value = Conv(input_channels, output_channels // ratio_v, (1, 1), bias=False, generator=g)
        self.last_conv = Conv(output_channels // 8, output_channels, (1, 1), bias=False, generator=g)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        q = self.query(x).flatten(2).transpose(1, 2)  # (B, HW, c)
        k = self.key(x).flatten(2)  # (B, c, HW)
        v = self.value(x).flatten(2).transpose(1, 2)
        beta = torch.softmax(q @ k, dim=-1)
        out = (beta @ v).transpose(1, 2).reshape(B, -1, H, W)
        return self.gamma * self.last_conv(out) + x


class ConvGRUCell(nn.Module):
    """Spectral-normalised ConvGRU cell with a ReLU candidate."""

    def __init__(self, input_channels: int, output_channels: int, kernel_size: int = 3, sn_eps: float = 1e-4, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        k = (kernel_size, kernel_size)
        self.read_gate_conv = SNConv(input_channels, output_channels, k, padding="SAME", sn_eps=sn_eps, generator=g)
        self.update_gate_conv = SNConv(input_channels, output_channels, k, padding="SAME", sn_eps=sn_eps,
                                       generator=g)
        self.output_conv = SNConv(input_channels, output_channels, k, padding="SAME", sn_eps=sn_eps, generator=g)

    def kernels(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The read gate's, update gate's and output's normalised kernels
        (the same at every step)."""
        return tuple(c._kernel() for c in (self.read_gate_conv, self.update_gate_conv, self.output_conv))

    def forward(self, x: torch.Tensor, prev_state: torch.Tensor,
                kernels: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]):
        """One step from ``prev_state`` with :meth:`kernels`' three kernels."""
        read_k, update_k, output_k = kernels
        xh = torch.cat([x, prev_state], dim=1)
        read_gate = torch.sigmoid(self.read_gate_conv(xh, read_k))
        update_gate = torch.sigmoid(self.update_gate_conv(xh, update_k))
        c = F.relu(self.output_conv(torch.cat([x, read_gate * prev_state], dim=1), output_k))
        out = update_gate * prev_state + (1.0 - update_gate) * c
        return out, out


class ConvGRU(nn.Module):
    """The cell unrolled over a list of per-step inputs."""

    def __init__(self, input_channels: int, output_channels: int, kernel_size: int = 3, sn_eps: float = 1e-4, *,
                 generator: torch.Generator):
        super().__init__()
        self.cell = ConvGRUCell(input_channels, output_channels, kernel_size, sn_eps, generator=generator)

    def forward(self, xs: List[torch.Tensor], hidden_state: torch.Tensor) -> List[torch.Tensor]:
        outputs, kernels = [], self.cell.kernels()
        for x in xs:
            out, hidden_state = self.cell(x, hidden_state, kernels)
            outputs.append(out)
        return outputs


# ------------------------------------------------------------------- stacks --


class ContextConditioningStack(nn.Module):
    """Per-frame DBlock pyramid over the context frames (B, T, C, H, W):
    four scales, the largest first, each the frames' features stacked
    time-major and mixed by a 3x3 convolution."""

    def __init__(self, input_channels: int = 1, output_channels: int = 384, num_context_steps: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        oc, ic, steps = output_channels, input_channels, num_context_steps
        self.d1 = DBlock(4 * ic, (oc // 4) * ic // steps, generator=g)
        self.d2 = DBlock((oc // 4) * ic // steps, (oc // 2) * ic // steps, generator=g)
        self.d3 = DBlock((oc // 2) * ic // steps, oc * ic // steps, generator=g)
        self.d4 = DBlock(oc * ic // steps, oc * 2 * ic // steps, generator=g)
        self.conv1 = SNConv((oc // 4) * ic, (oc // 8) * ic, (3, 3), padding="SAME", generator=g)
        self.conv2 = SNConv((oc // 2) * ic, (oc // 4) * ic, (3, 3), padding="SAME", generator=g)
        self.conv3 = SNConv(oc * ic, (oc // 2) * ic, (3, 3), padding="SAME", generator=g)
        self.conv4 = SNConv(oc * 2 * ic, oc * ic, (3, 3), padding="SAME", generator=g)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        B, T, C, H, W = x.shape
        h = pixel_unshuffle(x.reshape(B * T, C, H, W), 2)
        out = []
        for block, conv in ((self.d1, self.conv1), (self.d2, self.conv2), (self.d3, self.conv3),
                            (self.d4, self.conv4)):
            h = block(h)
            stacked = h.reshape((B, T * h.shape[1]) + tuple(h.shape[2:]))  # channel t C' + c'
            out.append(F.relu(conv(stacked)))
        return tuple(out)


class LatentConditioningStack(nn.Module):
    """N(0, 2) noise -> 3x3 conv -> LBlocks -> attention -> LBlock: the
    (1, output_channels, H/32, W/32) input of the sampler's recurrences."""

    def __init__(self, shape: Tuple[int, int, int] = (8, 8, 8), output_channels: int = 768,
                 use_attention: bool = True, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.shape = tuple(shape)  # (C_noise, H/32, W/32)
        self.use_attention = use_attention
        c = self.shape[0]
        self.conv_3x3 = SNConv(c, c, (3, 3), padding="SAME", generator=g)
        self.l_block1 = LBlock(c, output_channels // 32, generator=g)
        self.l_block2 = LBlock(output_channels // 32, output_channels // 16, generator=g)
        self.l_block3 = LBlock(output_channels // 16, output_channels // 4, generator=g)
        if use_attention:
            self.att_block = AttentionLayer(output_channels // 4, output_channels // 4, generator=g)
        self.l_block4 = LBlock(output_channels // 4, output_channels, generator=g)

    def forward(self, noise: torch.Tensor) -> torch.Tensor:
        """``noise``: a standard normal (1, C_noise, H/32, W/32) draw."""
        z = self.conv_3x3(2.0 * noise)
        z = self.l_block3(self.l_block2(self.l_block1(z)))
        if self.use_attention:
            z = self.att_block(z)
        return self.l_block4(z)


class Sampler(nn.Module):
    """Four ConvGRU levels, each followed by a spectral-normed 1x1
    convolution, a GBlock and an UpsampleGBlock, then batch norm, a 1x1
    convolution and the depth-to-space: (B, T, C, H, W) frames."""

    def __init__(self, forecast_steps: int = 18, latent_channels: int = 768, context_channels: int = 384,
                 output_channels: int = 1, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.forecast_steps = forecast_steps
        lc, cc = latent_channels, context_channels
        self.convGRU1 = ConvGRU(lc + cc, cc, generator=g)
        self.gru_conv_1x1 = SNConv(cc, lc, (1, 1), generator=g)
        self.g1 = GBlock(lc, lc, generator=g)
        self.up_g1 = UpsampleGBlock(lc, lc // 2, generator=g)
        self.convGRU2 = ConvGRU(lc // 2 + cc // 2, cc // 2, generator=g)
        self.gru_conv_1x1_2 = SNConv(cc // 2, lc // 2, (1, 1), generator=g)
        self.g2 = GBlock(lc // 2, lc // 2, generator=g)
        self.up_g2 = UpsampleGBlock(lc // 2, lc // 4, generator=g)
        self.convGRU3 = ConvGRU(lc // 4 + cc // 4, cc // 4, generator=g)
        self.gru_conv_1x1_3 = SNConv(cc // 4, lc // 4, (1, 1), generator=g)
        self.g3 = GBlock(lc // 4, lc // 4, generator=g)
        self.up_g3 = UpsampleGBlock(lc // 4, lc // 8, generator=g)
        self.convGRU4 = ConvGRU(lc // 8 + cc // 8, cc // 8, generator=g)
        self.gru_conv_1x1_4 = SNConv(cc // 8, lc // 8, (1, 1), generator=g)
        self.g4 = GBlock(lc // 8, lc // 8, generator=g)
        self.up_g4 = UpsampleGBlock(lc // 8, lc // 16, generator=g)
        self.bn = BatchNorm(lc // 16)
        self.conv_1x1 = SNConv(lc // 16, 4 * output_channels, (1, 1), generator=g)

    def forward(self, conditioning_states: Sequence[torch.Tensor], latent_dim: torch.Tensor) -> torch.Tensor:
        T = self.forecast_steps
        B = conditioning_states[0].shape[0]
        hs = [latent_dim.expand((B,) + tuple(latent_dim.shape[1:]))] * T
        levels = ((self.convGRU1, self.gru_conv_1x1, self.g1, self.up_g1, conditioning_states[3]),
                  (self.convGRU2, self.gru_conv_1x1_2, self.g2, self.up_g2, conditioning_states[2]),
                  (self.convGRU3, self.gru_conv_1x1_3, self.g3, self.up_g3, conditioning_states[1]),
                  (self.convGRU4, self.gru_conv_1x1_4, self.g4, self.up_g4, conditioning_states[0]))
        for gru, conv1x1, gblock, up, init_state in levels:
            h = torch.cat(gru(hs, init_state), dim=0)  # the T steps stacked time-major: (T B, C, h, w)
            h = up(gblock(conv1x1(h), T), T)
            hs = list(h.chunk(T, dim=0))
        h = self.conv_1x1(F.relu(self.bn(torch.cat(hs, dim=0), T)))
        frames = pixel_shuffle(h, 2)
        return frames.reshape((T, B) + tuple(frames.shape[1:])).transpose(0, 1)


class DGMRGenerator(nn.Module):
    """The conditioning stack, the latent stack and the sampler."""

    def __init__(self, conditioning_stack: ContextConditioningStack, latent_stack: LatentConditioningStack,
                 sampler: Sampler):
        super().__init__()
        self.conditioning_stack = conditioning_stack
        self.latent_stack = latent_stack
        self.sampler = sampler

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """(B, T_ctx, C, H, W) context frames and a standard normal latent
        draw (1, C_noise, H/32, W/32) -> (B, forecast_steps, C, H, W)."""
        return self.sampler(self.conditioning_stack(x), self.latent_stack(noise))


# ----------------------------------------------------------- discriminators --


def _scores(rep: torch.Tensor, n: int, bn: BatchNorm, fc: SNLinear) -> torch.Tensor:
    """(n B, C, h, w) frame features, frame-major -> the (B, 1, 1) sum over
    the n frames of fc(bn(sum of relu over space)), each frame's batch norm
    with its own statistics."""
    rep = torch.sum(F.relu(rep), dim=(2, 3))
    out = fc(bn(rep, n))  # (n B, 1)
    return out.reshape(n, -1, 1).sum(dim=0)[:, None]


class SpatialDiscriminator(nn.Module):
    """A DBlock stack over ``num_timesteps`` frames: random ones when a
    ``generator`` is given, else the first ones."""

    def __init__(self, input_channels: int = 12, num_timesteps: int = 8, num_layers: int = 4, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.num_timesteps = num_timesteps
        internal = 24
        self.d1 = DBlock(4 * input_channels, 2 * internal * input_channels, first_relu=False, generator=g)
        blocks = []
        for _ in range(num_layers):
            internal *= 2
            blocks.append(DBlock(internal * input_channels, 2 * internal * input_channels, generator=g))
        self.intermediate_dblocks = nn.ModuleList(blocks)
        self.d6 = DBlock(2 * internal * input_channels, 2 * internal * input_channels, keep_same_output=True,
                         generator=g)
        self.bn = BatchNorm(2 * internal * input_channels)
        self.fc = SNLinear(2 * internal * input_channels, 1, generator=g)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, T, C, H, W) -> (B, 1, 1)."""
        B, T, C, H, W = x.shape
        if generator is None:
            frames = x[:, :min(self.num_timesteps, T)]
        else:
            frames = x[:, torch.randint(0, T, (self.num_timesteps,), generator=generator).tolist()]
        n = frames.shape[1]
        rep = frames.transpose(0, 1).reshape(n * B, C, H, W)
        rep = self.d1(pixel_unshuffle(_avg_pool(rep, (2, 2)), 2))
        for d in self.intermediate_dblocks:
            rep = d(rep)
        return _scores(self.d6(rep), n, self.bn, self.fc)


class TemporalDiscriminator(nn.Module):
    """3-D DBlocks over (time, height, width), then a 2-D DBlock stack per
    remaining time slice."""

    def __init__(self, input_channels: int = 12, num_layers: int = 3, *, generator: torch.Generator):
        super().__init__()
        g = generator
        internal = 48
        self.d1 = DBlock(4 * input_channels, internal * input_channels, conv_type="3d", first_relu=False,
                         generator=g)
        self.d2 = DBlock(internal * input_channels, 2 * internal * input_channels, conv_type="3d", generator=g)
        blocks = []
        for _ in range(num_layers):
            internal *= 2
            blocks.append(DBlock(internal * input_channels, 2 * internal * input_channels, generator=g))
        self.intermediate_dblocks = nn.ModuleList(blocks)
        self.d_last = DBlock(2 * internal * input_channels, 2 * internal * input_channels, keep_same_output=True,
                             generator=g)
        self.bn = BatchNorm(2 * internal * input_channels)
        self.fc = SNLinear(2 * internal * input_channels, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C, H, W) -> (B, 1, 1)."""
        B, T, C, H, W = x.shape
        x = pixel_unshuffle(_avg_pool(x.reshape(B * T, C, H, W), (2, 2)), 2)
        x = x.reshape((B, T) + tuple(x.shape[1:])).transpose(1, 2)  # (B, 4C, T, H/4, W/4): depth = time
        x = self.d2(self.d1(x))
        n = x.shape[2]
        rep = x.permute(2, 0, 1, 3, 4).reshape((n * B,) + (x.shape[1],) + tuple(x.shape[3:]))
        for d in self.intermediate_dblocks:
            rep = d(rep)
        return _scores(self.d_last(rep), n, self.bn, self.fc)


class DGMRDiscriminator(nn.Module):
    """The spatial and temporal discriminator pair: (B, T, C, H, W) frames
    -> (B, 2, 1) scores."""

    def __init__(self, input_channels: int = 1, num_spatial_frames: int = 8, spatial_layers: int = 4,
                 temporal_layers: int = 3, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(1)
        self.spatial_discriminator = SpatialDiscriminator(input_channels, num_timesteps=num_spatial_frames,
                                                          num_layers=spatial_layers, generator=g)
        self.temporal_discriminator = TemporalDiscriminator(input_channels, num_layers=temporal_layers, generator=g)
        self.to(device)

    def forward(self, frames: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s = self.spatial_discriminator(frames, generator)
        t = self.temporal_discriminator(frames)
        return torch.cat([s, t], dim=1)


class DGMRDiscriminators(DGMRDiscriminator):
    """The pair at the JAX example's depth, returning the per-head (B,)
    scores as a tuple; ``hidden`` is accepted and ignored, as in JAX."""

    def __init__(self, input_channels: int = 1, hidden: Optional[int] = None, num_spatial_frames: int = 4,
                 spatial_layers: int = 1, temporal_layers: int = 1, *, generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        super().__init__(input_channels, num_spatial_frames=num_spatial_frames, spatial_layers=spatial_layers,
                         temporal_layers=temporal_layers, generator=generator, device=device)

    def forward(self, frames: torch.Tensor, generator: Optional[torch.Generator] = None):
        scores = super().forward(frames, generator)
        return scores[:, 0, 0], scores[:, 1, 0]


# ----------------------------------------------------------------- the Arch --


class DGMR(base.Arch):
    """The deep generative model of radar: input (B, T_ctx, C, H, W),
    output (B, forecast_steps, C, H, W) under ``output_keys[0]``, H and W
    divisible by 32. With ``generation_steps`` S > 1 the output is the
    mean of S latent draws' forecasts and ``"samples"`` holds them all,
    (S, B, T, C, H, W)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], forecast_steps: int = 18,
                 input_channels: int = 1, output_shape: int = 256, latent_channels: int = 768,
                 context_channels: int = 384, num_input_frames: int = 4, generation_steps: int = 1,
                 conv_type: str = "standard", noise_channels: Optional[int] = None, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        if noise_channels is None:
            noise_channels = 8 * input_channels
        if latent_channels < 32 * noise_channels:  # the LBlocks grow the noise's channels 32x
            noise_channels = max(latent_channels // 32, 1)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.forecast_steps = forecast_steps
        self.generation_steps = generation_steps
        self.latent_channels = latent_channels
        self.context_channels = context_channels
        self.conditioning_stack = ContextConditioningStack(input_channels=input_channels,
                                                           output_channels=context_channels,
                                                           num_context_steps=num_input_frames, generator=g)
        self.latent_stack = LatentConditioningStack(shape=(noise_channels, output_shape // 32, output_shape // 32),
                                                    output_channels=latent_channels, generator=g)
        self.sampler = Sampler(forecast_steps=forecast_steps, latent_channels=latent_channels,
                               context_channels=context_channels, output_channels=input_channels, generator=g)
        self._seed = 0  # the JAX module's PRNGKey(0)
        self._noise: Dict[tuple, torch.Tensor] = {}
        self.to(device)

    @property
    def generator(self) -> DGMRGenerator:
        """The three generator stages as one module (built on access: the
        stacks stay this module's children)."""
        return DGMRGenerator(self.conditioning_stack, self.latent_stack, self.sampler)

    def set_rng(self, seed: int) -> None:
        """Draw the latent noise from ``seed`` from now on (the JAX module's
        ``set_rng`` takes a key); the kept draws are dropped."""
        self._seed = int(seed)
        self._noise.clear()

    def set_noise(self, noise: torch.Tensor) -> None:
        """Use ``noise``, a standard normal (generation_steps, 1, C_noise,
        H/32, W/32) draw, at every call on inputs of its dtype."""
        p = self.sampler.conv_1x1.weight
        noise = noise.detach().to(p.device)
        self._noise[(tuple(noise.shape), noise.device, noise.dtype)] = noise

    def noise(self, like: torch.Tensor) -> torch.Tensor:
        """The (generation_steps, 1, C_noise, H/32, W/32) draw for ``like``'s
        device and dtype (drawn at the first call)."""
        shape = (self.generation_steps, 1) + self.latent_stack.shape
        key = (shape, like.device, like.dtype)
        if key not in self._noise:
            if like.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"DGMR: no latent noise of shape {shape} drawn before the CUDA graph capture "
                                   "(run the step once eagerly first)")
            g = torch.Generator().manual_seed(self._seed)
            self._noise[key] = torch.randn(shape, generator=g).to(like.device, like.dtype)
        return self._noise[key]

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        seq = x[self.input_keys[0]]
        noise = self.noise(seq)
        gen = self.generator
        samples = [gen(seq, noise[s]) for s in range(self.generation_steps)]
        if self.generation_steps == 1:
            return {self.output_keys[0]: samples[0]}
        stacked = torch.stack(samples, 0)
        return {self.output_keys[0]: torch.mean(stacked, 0), "samples": stacked}
