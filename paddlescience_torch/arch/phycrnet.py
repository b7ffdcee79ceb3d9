"""PhyCRNet, the physics-informed convolutional-recurrent net (counterpart
of ``paddlescience_tpu/arch/phycrnet.py``), and its finite-difference
physics loss.

Channel-first (B, C, H, W) throughout. A step: weight-normed encoder
convolutions with ReLU, ConvLSTM cells, the pixel shuffle
(``nn/recurrent.py``, JAX's channel order), a 5x5 output convolution,
and the Euler update x_{t+1} = x_t + dt f; rolled out ``step`` times.
Every convolution pads circularly. As in the JAX module:

* ``_WeightNormConv`` stores the direction ``weight`` already normalised
  and the per-output-channel gain ``wn_g``; its kernel is wn_g v / (|v| +
  1e-12), the norm over every axis of an output channel (JAX's kernel
  axes but the last), 1e-12 added outside the square root (not
  ``torch.nn.utils.weight_norm``);
* this module's ``ConvLSTMCell`` pads both of its convolutions
  circularly and starts the output gate's bias at 1 (the one in
  ``nn/recurrent.py`` pads "SAME");
* ``second_last_state`` is filled only at step ``step - 2``: it stays an
  empty list when ``step`` is 1;
* :class:`loss_generator` applies its fixed stencils as VALID
  cross-correlations (``F.conv2d``: no kernel flip).

Parameter names follow the JAX module (``encoder.0.conv.wn_g``,
``convlstm.0.conv_x.weight``, ``output_layer.bias``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch import base
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Conv
from paddlescience_torch.nn import recurrent
from paddlescience_torch.nn.recurrent import pixel_shuffle

__all__ = ["PhyCRNet", "ConvLSTMCell", "loss_generator"]


def _wn_norm(v: torch.Tensor) -> torch.Tensor:
    """|v| of each output channel, (C_out, 1, ..., 1)."""
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))


class _WeightNormConv(Conv):
    """A circular convolution with a weight-normed kernel."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        with torch.no_grad():
            norm = _wn_norm(self.weight)
            self.wn_g = nn.Parameter(norm.reshape(-1).clone())
            self.weight.copy_(self.weight / (norm + 1e-12))

    def _kernel(self) -> torch.Tensor:
        v = self.weight
        g = self.wn_g.reshape((-1,) + (1,) * (v.ndim - 1))
        return g * v / (_wn_norm(v) + 1e-12)


class _EncoderBlock(nn.Module):
    def __init__(self, in_ch, out_ch, k, s, p, *, generator: torch.Generator):
        super().__init__()
        self.conv = _WeightNormConv(in_ch, out_ch, (k, k), strides=s, padding=p, padding_mode="circular",
                                    generator=generator)

    def forward(self, x):
        return F.relu(self.conv(x))


class ConvLSTMCell(recurrent.ConvLSTMCell):
    """ConvLSTM cell with circular convolutions (a 4C input convolution,
    possibly strided, and a bias-free 3x3 hidden one) and the output gate's
    bias starting at 1 (gates i, f, g, o along the channels)."""

    def __init__(self, input_channels, hidden_channels, input_kernel_size, input_stride=1, input_padding=0, *,
                 generator: torch.Generator):
        super().__init__(input_channels, hidden_channels, input_kernel_size, input_stride, input_padding,
                         padding_mode="circular", generator=generator)
        with torch.no_grad():
            self.conv_x.bias[3 * hidden_channels:] = 1.0


class PhyCRNet(base.Arch):
    """``{"initial_state": list of (h, c) per ConvLSTM cell, channel-first,
    or None; "input": (B, C, H, W)}`` -> ``{"outputs": [x_{t+1} for t in
    effective_step], "second_last_state": [(h, c), ...]}``."""

    def __init__(self, input_channels: int, hidden_channels: Sequence[int], input_kernel_size: Sequence[int],
                 input_stride: Sequence[int], input_padding: Sequence[int], dt: float, num_layers: Sequence[int],
                 upscale_factor: int, step: int = 1, effective_step: Sequence[int] = (1,), *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = ("initial_state", "input")
        self.output_keys = ("outputs", "second_last_state")
        in_chs = [input_channels] + list(hidden_channels)
        self.num_encoder, self.num_convlstm = num_layers[0], num_layers[1]
        self.dt = dt
        self.step = step
        self.effective_step = tuple(effective_step)
        self.upscale_factor = upscale_factor
        self.encoder = nn.ModuleList(
            _EncoderBlock(in_chs[i], hidden_channels[i], input_kernel_size[i], input_stride[i], input_padding[i],
                          generator=g) for i in range(self.num_encoder))
        self.convlstm = nn.ModuleList(
            ConvLSTMCell(in_chs[i], hidden_channels[i], input_kernel_size[i], input_stride[i], input_padding[i],
                         generator=g) for i in range(self.num_encoder, self.num_encoder + self.num_convlstm))
        self.output_layer = Conv(2, 2, (5, 5), padding=2, padding_mode="circular", generator=g)
        self.to(device)

    def forward(self, x: Dict[str, object]) -> Dict[str, List]:
        initial_state = x["initial_state"]
        h_prev = x["input"]
        internal_state: List = []
        outputs: List = []
        second_last_state: List = []
        for step in range(self.step):
            h = h_prev
            for enc in self.encoder:
                h = enc(h)
            for i, cell in enumerate(self.convlstm):
                if step == 0:
                    if initial_state is not None and len(initial_state) > i:
                        internal_state.append(tuple(initial_state[i]))
                    else:
                        internal_state.append(cell.init_state(h.shape))
                h, internal_state[i] = cell(h, internal_state[i])
            out = self.output_layer(pixel_shuffle(h, self.upscale_factor))
            h_next = h_prev + self.dt * out  # the Euler step
            if step in self.effective_step:
                outputs.append(h_next)
            if step == self.step - 2:
                second_last_state = list(internal_state)
            h_prev = h_next
        return {"outputs": outputs, "second_last_state": second_last_state}


# 4th-order finite-difference stencils (the JAX module's _LALP_OP, _PARTIAL_X, _PARTIAL_Y)
_LALP_OP = np.array(
    [[0, 0, -1 / 12, 0, 0],
     [0, 0, 4 / 3, 0, 0],
     [-1 / 12, 4 / 3, -5, 4 / 3, -1 / 12],
     [0, 0, 4 / 3, 0, 0],
     [0, 0, -1 / 12, 0, 0]], np.float32)
_PARTIAL_X = np.array(
    [[0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0],
     [1 / 12, -8 / 12, 0, 8 / 12, -1 / 12],
     [0, 0, 0, 0, 0],
     [0, 0, 0, 0, 0]], np.float32)
_PARTIAL_Y = _PARTIAL_X.T.copy()


class loss_generator:
    """The fixed derivative operators of the PhyCRNet physics loss on a
    (T, C, H, W) rollout: 5x5 Laplacian, d/dx and d/dy over the interior
    (VALID cross-correlations) and the central difference in time."""

    def __init__(self, dt: float, dx: float):
        self.dt = dt
        self.dx = dx
        self._stencils: Dict[tuple, torch.Tensor] = {}

    def _conv2d(self, u: torch.Tensor, name: str, resol: float) -> torch.Tensor:
        key = (name, u.device, u.dtype)
        if key not in self._stencils:  # on the device once: a captured step makes no host copy
            table = {"lap": _LALP_OP, "dx": _PARTIAL_X, "dy": _PARTIAL_Y}[name]
            self._stencils[key] = torch.as_tensor(table, dtype=u.dtype, device=u.device)[None, None]
        return F.conv2d(u, self._stencils[key]) / resol

    def get_phy_loss(self, output: torch.Tensor, R: float = 200.0):
        """The 2-D Burgers residuals (f_u, f_v) of a rollout (T, 2, H, W)."""
        u_in, v_in = output[1:-1, 0:1], output[1:-1, 1:2]
        lap_u = self._conv2d(u_in, "lap", self.dx ** 2)
        lap_v = self._conv2d(v_in, "lap", self.dx ** 2)
        u_x = self._conv2d(u_in, "dx", self.dx)
        u_y = self._conv2d(u_in, "dy", self.dx)
        v_x = self._conv2d(v_in, "dx", self.dx)
        v_y = self._conv2d(v_in, "dy", self.dx)
        u_t = (output[2:, 0:1, 2:-2, 2:-2] - output[:-2, 0:1, 2:-2, 2:-2]) / (2 * self.dt)
        v_t = (output[2:, 1:2, 2:-2, 2:-2] - output[:-2, 1:2, 2:-2, 2:-2]) / (2 * self.dt)
        u = output[1:-1, 0:1, 2:-2, 2:-2]
        v = output[1:-1, 1:2, 2:-2, 2:-2]
        f_u = u_t + u * u_x + v * u_y - (1.0 / R) * lap_u
        f_v = v_t + u * v_x + v * v_y - (1.0 / R) * lap_v
        return f_u, f_v
