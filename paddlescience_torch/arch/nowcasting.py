"""NowcastNet, physics-conditional precipitation nowcasting (counterpart of
``paddlescience_tpu/arch/nowcasting.py``; DGMR is ``arch/dgmr.py``).

The evolution network (a U-Net encoder with two decoders: the intensity
residual behind a zero-initialised gate, and a 2-channel motion field a
prediction step) advects the last input frame step by step with
:func:`warp`; the generative network encodes the input frames with the
evolution result, lifts noise through the noise projector, and decodes
with SPADE GenBlocks that the evolution result modulates. Spectral norm and
batch norm are ``arch/dgmr.py``'s (fixed-``u0`` power iteration, batch
statistics always).

Channel-first inside; the model keeps the JAX contract: input (B, T, H, W,
C), the radar field channel 0; output (B, total_length - input_length, H,
W, 1). As in the JAX module:

* :func:`warp` samples at (x + flow_0, y + flow_1), clipped to the field
  before rounding (``torch.round`` and ``jnp.round`` both round half to
  even); "nearest" reads one pixel, "bilinear" four, through
  ``nn/segment.py::gather_rows``, whose backward sums in a fixed order
  (no float atomics), so a step repeats bitwise and runs inside a CUDA
  graph;
* :func:`_upsample2` is JAX's half-pixel "linear" resize
  (``nn/resize.py``);
* the evolution result is divided by 128;
* the projected noise goes 4x depth-to-space in JAX's channel order
  (``nn/recurrent.py::pixel_shuffle``, not ``F.pixel_shuffle``).

The JAX module draws its noise (B, H/32, W/32, ngf) from one fixed key at
every call; the port draws the (B, ngf, H/32, W/32) standard normal once
per shape from a CPU ``torch.Generator`` seeded with 0 (or the seed given
to :meth:`NowcastNet.set_rng`), keeps it on the device and reads it at
every call, drawing nothing inside a CUDA graph; :meth:`NowcastNet.set_noise`
puts a given draw in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch import base
from paddlescience_torch.arch.dgmr import BatchNorm, SNConv
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv
from paddlescience_torch.nn.recurrent import pixel_shuffle
from paddlescience_torch.nn.resize import resize
from paddlescience_torch.nn.segment import gather_rows

__all__ = ["NowcastNet", "warp"]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    B, C, H, W = x.shape
    return resize(x, (B, C, 2 * H, 2 * W), "linear")


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)


def _adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Adaptive mean pool of (B, C, H, W) for integer ratios."""
    B, C, H, W = x.shape
    oh, ow = out_hw
    return x.reshape(B, C, oh, H // oh, ow, W // ow).mean(dim=(3, 5))


def warp(field: torch.Tensor, flow: torch.Tensor, mode: str = "nearest") -> torch.Tensor:
    """Backward warp of ``field`` (B, C, H, W) by ``flow`` (B, 2, H, W) in
    pixels, border-clamped; flow channel 0 is the x (width) offset, 1 the y
    offset. ``mode``: "nearest" or "bilinear"."""
    B, C, H, W = field.shape
    gy, gx = torch.meshgrid(torch.arange(H, dtype=flow.dtype, device=flow.device),
                            torch.arange(W, dtype=flow.dtype, device=flow.device), indexing="ij")
    sx = torch.clamp(gx + flow[:, 0], 0, W - 1)
    sy = torch.clamp(gy + flow[:, 1], 0, H - 1)
    rows = field.permute(0, 2, 3, 1).reshape(B * H * W, C)
    base_idx = (torch.arange(B, device=field.device) * (H * W)).reshape(B, 1, 1)

    def read(yy, xx):  # (B, H, W) integer coordinates -> (B, C, H, W)
        out = gather_rows(rows, (base_idx + yy * W + xx).reshape(-1))
        return out.reshape(B, H, W, C).permute(0, 3, 1, 2)

    if mode == "nearest":
        return read(torch.round(sy).long(), torch.round(sx).long())
    x0 = torch.floor(sx).long()
    y0 = torch.floor(sy).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = (sx - x0)[:, None]
    wy = (sy - y0)[:, None]
    return (read(y0, x0) * (1 - wy) * (1 - wx) + read(y0, x1) * (1 - wy) * wx
            + read(y1, x0) * wy * (1 - wx) + read(y1, x1) * wy * wx)


class DoubleConv(nn.Module):
    """BN-ReLU-SNConv twice, plus a BN-SNConv shortcut."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, mid: Optional[int] = None, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        mid = mid or c_out
        k = (kernel, kernel)
        self.bn1 = BatchNorm(c_in)
        self.conv1 = SNConv(c_in, mid, k, padding="SAME", generator=g)
        self.bn2 = BatchNorm(mid)
        self.conv2 = SNConv(mid, c_out, k, padding="SAME", generator=g)
        self.bn_s = BatchNorm(c_in)
        self.conv_s = SNConv(c_in, c_out, k, padding="SAME", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sc = self.conv_s(self.bn_s(x))
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return h + sc


class Down(nn.Module):
    """2x max pool, then a DoubleConv."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, *, generator: torch.Generator):
        super().__init__()
        self.conv = DoubleConv(c_in, c_out, kernel, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(_max_pool2(x))


class Up(nn.Module):
    """2x linear upsampling, the skip prepended, a DoubleConv (mid c_in / 2)."""

    def __init__(self, c_in: int, c_out: int, kernel: int = 3, *, generator: torch.Generator):
        super().__init__()
        self.conv = DoubleConv(c_in, c_out, kernel, mid=c_in // 2, generator=generator)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([x2, _upsample2(x1)], dim=1))


class EvolutionNetwork(nn.Module):
    """The shared U-Net encoder, the intensity decoder and the motion
    decoder: (B, T_in, H, W) -> intensity (B, P, H, W), motion (B, 2P, H,
    W), motion channel 2 p + xy."""

    def __init__(self, n_channels: int, n_classes: int, base_c: int = 32, *, generator: torch.Generator):
        super().__init__()
        g = generator
        c = base_c
        self.inc = DoubleConv(n_channels, c, generator=g)
        self.down1 = Down(c, 2 * c, generator=g)
        self.down2 = Down(2 * c, 4 * c, generator=g)
        self.down3 = Down(4 * c, 8 * c, generator=g)
        self.down4 = Down(8 * c, 8 * c, generator=g)
        self.up1 = Up(16 * c, 4 * c, generator=g)
        self.up2 = Up(8 * c, 2 * c, generator=g)
        self.up3 = Up(4 * c, c, generator=g)
        self.up4 = Up(2 * c, c, generator=g)
        self.outc = Conv(c, n_classes, (1, 1), generator=g)
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, n_classes))  # the JAX layout: channels last
        self.up1_v = Up(16 * c, 4 * c, generator=g)
        self.up2_v = Up(8 * c, 2 * c, generator=g)
        self.up3_v = Up(4 * c, c, generator=g)
        self.up4_v = Up(2 * c, c, generator=g)
        self.outc_v = Conv(c, n_classes * 2, (1, 1), generator=g)

    def forward(self, x: torch.Tensor):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        h = self.up4(self.up3(self.up2(self.up1(x5, x4), x3), x2), x1)
        intensity = self.outc(h) * self.gamma.reshape(1, -1, 1, 1)
        v = self.up4_v(self.up3_v(self.up2_v(self.up1_v(x5, x4), x3), x2), x1)
        return intensity, self.outc_v(v)


class GenerativeEncoder(nn.Module):
    """A DoubleConv and three Downs: (B, C, H, W) -> (B, 8 base_c, H/8, W/8)."""

    def __init__(self, n_channels: int, base_c: int = 64, *, generator: torch.Generator):
        super().__init__()
        g = generator
        c = base_c
        self.inc = DoubleConv(n_channels, c, generator=g)
        self.down1 = Down(c, 2 * c, generator=g)
        self.down2 = Down(2 * c, 4 * c, generator=g)
        self.down3 = Down(4 * c, 8 * c, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down3(self.down2(self.down1(self.inc(x))))


class SPADE(nn.Module):
    """Spatially adaptive denormalisation: a parameter-free instance norm
    (biased variance) of x, scaled and shifted by convolutions of the
    evolution result pooled to x's size."""

    def __init__(self, norm_nc: int, label_nc: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.epsilon = 1e-5
        nhidden = 64
        self.mlp_shared = Conv(label_nc, nhidden, (3, 3), padding="SAME", generator=g)
        self.mlp_gamma = Conv(nhidden, norm_nc, (3, 3), padding="SAME", generator=g)
        self.mlp_beta = Conv(nhidden, norm_nc, (3, 3), padding="SAME", generator=g)

    def forward(self, x: torch.Tensor, evo: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(x, dim=(2, 3), correction=0, keepdim=True)
        normalized = (x - mean) * torch.rsqrt(var + self.epsilon)
        actv = F.relu(self.mlp_shared(_adaptive_avg_pool(evo, x.shape[2:])))
        return normalized * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class GenBlock(nn.Module):
    """SPADE residual block (leaky ReLU 0.2)."""

    def __init__(self, fin: int, fout: int, evo_ic: int, double_conv: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.learned_shortcut = fin != fout
        fmid = min(fin, fout)
        self.double = double_conv
        self.conv_0 = SNConv(fin, fmid, (3, 3), padding="SAME", generator=g)
        self.conv_1 = SNConv(fmid, fout, (3, 3), padding="SAME", generator=g)
        self.norm_0 = SPADE(fin, evo_ic, generator=g)
        self.norm_1 = SPADE(fmid, evo_ic, generator=g)
        if self.learned_shortcut:
            self.conv_s = SNConv(fin, fout, (1, 1), bias=False, generator=g)
            self.norm_s = SPADE(fin, evo_ic, generator=g)

    def forward(self, x: torch.Tensor, evo: torch.Tensor) -> torch.Tensor:
        x_s = self.conv_s(self.norm_s(x, evo)) if self.learned_shortcut else x
        dx = self.conv_0(F.leaky_relu(self.norm_0(x, evo), 0.2))
        if self.double:
            dx = self.conv_1(F.leaky_relu(self.norm_1(dx, evo), 0.2))
        return x_s + dx


class GenerativeDecoder(nn.Module):
    """SPADE GenBlocks with three 2x upsamplings, H/8 -> H."""

    def __init__(self, ngf: int, ic_feature: int, evo_ic: int, gen_oc: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        nf = ngf
        self.fc = Conv(ic_feature, 8 * nf, (3, 3), padding="SAME", generator=g)
        self.head_0 = GenBlock(8 * nf, 8 * nf, evo_ic, generator=g)
        self.G_middle_0 = GenBlock(8 * nf, 4 * nf, evo_ic, double_conv=True, generator=g)
        self.G_middle_1 = GenBlock(4 * nf, 4 * nf, evo_ic, double_conv=True, generator=g)
        self.up_0 = GenBlock(4 * nf, 2 * nf, evo_ic, generator=g)
        self.up_1 = GenBlock(2 * nf, nf, evo_ic, double_conv=True, generator=g)
        self.up_2 = GenBlock(nf, nf, evo_ic, double_conv=True, generator=g)
        self.conv_img = Conv(nf, gen_oc, (3, 3), padding="SAME", generator=g)

    def forward(self, x: torch.Tensor, evo: torch.Tensor) -> torch.Tensor:
        x = self.head_0(self.fc(x), evo)
        x = self.G_middle_1(self.G_middle_0(_upsample2(x), evo), evo)
        x = self.up_0(_upsample2(x), evo)
        x = self.up_2(self.up_1(_upsample2(x), evo), evo)
        return self.conv_img(F.leaky_relu(x, 0.2))


class ProjBlock(nn.Module):
    """Channel-growing residual block: [x, 1x1 conv of x] + two 3x3 convs."""

    def __init__(self, c_in: int, c_out: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.one_conv = SNConv(c_in, c_out - c_in, (1, 1), generator=g)
        self.conv1 = SNConv(c_in, c_out, (3, 3), padding="SAME", generator=g)
        self.conv2 = SNConv(c_out, c_out, (3, 3), padding="SAME", generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, self.one_conv(x)], dim=1) + self.conv2(F.relu(self.conv1(x)))


class NoiseProjector(nn.Module):
    """Noise (B, ngf, h, w) -> (B, 32 ngf, h, w)."""

    def __init__(self, ngf: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv_first = SNConv(ngf, 2 * ngf, (3, 3), padding="SAME", generator=g)
        self.L1 = ProjBlock(2 * ngf, 4 * ngf, generator=g)
        self.L2 = ProjBlock(4 * ngf, 8 * ngf, generator=g)
        self.L3 = ProjBlock(8 * ngf, 16 * ngf, generator=g)
        self.L4 = ProjBlock(16 * ngf, 32 * ngf, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.L4(self.L3(self.L2(self.L1(self.conv_first(x)))))


class NowcastNet(base.Arch):
    """The evolution network and the SPADE generative network: input (B,
    T, H, W, C >= 1), output (B, total_length - input_length, H, W, 1)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], input_length: int = 9,
                 total_length: int = 29, image_height: int = 512, image_width: int = 512, image_ch: int = 2,
                 ngf: int = 32, *, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.input_length = input_length
        self.pred_length = total_length - input_length
        self.ngf = ngf
        self.evo_net = EvolutionNetwork(input_length, self.pred_length, base_c=32, generator=g)
        self.gen_enc = GenerativeEncoder(total_length, base_c=ngf, generator=g)
        self.gen_dec = GenerativeDecoder(ngf, ngf * 10, self.pred_length, self.pred_length, generator=g)
        self.proj = NoiseProjector(ngf, generator=g)
        self._seed = 0  # the JAX module's PRNGKey(0)
        self._noise: Dict[tuple, torch.Tensor] = {}
        self.to(device)

    def set_rng(self, seed: int) -> None:
        """Draw the noise from ``seed`` from now on; the kept draws are dropped."""
        self._seed = int(seed)
        self._noise.clear()

    def set_noise(self, noise: torch.Tensor) -> None:
        """Use ``noise``, a standard normal (B, ngf, H/32, W/32) draw, at
        every call with its batch size and dtype."""
        p = self.proj.conv_first.weight
        noise = noise.detach().to(p.device)
        self._noise[(tuple(noise.shape), noise.device, noise.dtype)] = noise

    def noise(self, like: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
        """The standard normal draw of ``shape`` for ``like``'s device and
        dtype (drawn at the first call)."""
        key = (tuple(shape), like.device, like.dtype)
        if key not in self._noise:
            if like.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"NowcastNet: no noise of shape {tuple(shape)} drawn before the CUDA graph "
                                   "capture (run the step once eagerly first)")
            g = torch.Generator().manual_seed(self._seed)
            self._noise[key] = torch.randn(shape, generator=g).to(like.device, like.dtype)
        return self._noise[key]

    def evolve(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The evolution half: input (B, T, H, W, C >= 1) -> the input frames
        (B, input_length, H, W) and the advected frames over 128, (B, P, H,
        W)."""
        frames = x[..., 0]  # (B, T, H, W)
        B, _, H, W = frames.shape
        n_in, P = self.input_length, self.pred_length
        input_frames = frames[:, :n_in]
        intensity, motion = self.evo_net(input_frames)
        motion = motion.reshape(B, P, 2, H, W)
        last = frames[:, n_in - 1: n_in]
        series = []
        for i in range(P):
            last = warp(last, motion[:, i], mode="nearest") + intensity[:, i: i + 1]
            series.append(last)
        return input_frames, torch.cat(series, dim=1) / 128.0

    def generate(self, input_frames: torch.Tensor, evo_result: torch.Tensor) -> torch.Tensor:
        """The generative half: the input frames and the advected ones (each
        (B, *, H, W)) -> the forecast (B, P, H, W)."""
        B, _, H, W = evo_result.shape
        evo_feature = self.gen_enc(torch.cat([input_frames, evo_result], dim=1))
        noise = self.proj(self.noise(evo_result, (B, self.ngf, H // 32, W // 32)))
        feature = torch.cat([evo_feature, pixel_shuffle(noise, 4)], dim=1)  # 8 ngf + 2 ngf channels at H/8
        return self.gen_dec(feature, evo_result)

    def forward_tensor(self, x: torch.Tensor) -> torch.Tensor:
        return self.generate(*self.evolve(x))[..., None]  # (B, P, H, W, 1)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {self.output_keys[0]: self.forward_tensor(x[self.input_keys[0]])}
