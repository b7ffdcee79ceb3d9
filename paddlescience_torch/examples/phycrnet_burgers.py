"""PhyCRNet for the 2-D Burgers equations on the port (counterpart of
``examples/phycrnet_burgers.py``).

Physics-only training: PhyCRNet (``arch/phycrnet.py``; encoder channels
8, 32, 32, a 128-channel ConvLSTM, pixel shuffle by 8 to 2 channels at 32
x 32) rolls the initial field out 4 Euler steps (dt 0.002), and the loss
is the mean square of both Burgers residuals (nu 0.01) of the 5-frame
rollout from the fixed 4th-order stencils (``loss_generator``). The
initial field is the JAX example's band-limited random field
(:func:`initial_field`, numpy, bitwise equal to it). Adam at 2e-3 (optax's
rule); a hand loop of one step per update, run on CUDA K steps to a CUDA
graph (``utils/step_graph.py``; compare graphed and eager steps inside
``deterministic_convs()``).

Run on the GPU: ``python -m paddlescience_torch.examples.phycrnet_burgers
[steps]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from paddlescience_torch.arch.phycrnet import PhyCRNet, loss_generator
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.hand_loop import HandLoop, run_and_check
from paddlescience_torch.optimizer.optimizer import Adam

__all__ = ["PhyCRNetFit", "build", "main", "initial_field"]

H = W = 32
DT, NU = 0.002, 0.01
SEED = 0  # the JAX example's set_random_seed


def initial_field(seed: int = 0) -> np.ndarray:
    """(1, 2, H, W): a random field of wavenumbers |k| <= 5, scaled to max 1."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(H, 1.0 / H)
    KX, KY = np.meshgrid(k, k, indexing="ij")
    spec = rng.normal(size=(2, H, W)) + 1j * rng.normal(size=(2, H, W))
    spec *= ((KX ** 2 + KY ** 2) <= 25).astype(float)
    f = np.real(np.fft.ifft2(spec, axes=(-2, -1)))
    f = f / (np.abs(f).max() + 1e-9)
    return f[None].astype(np.float32)


class PhyCRNetFit(HandLoop):
    """The initial field on the device, the model, its Adam and the step loop."""

    def __init__(self, *, device: DeviceLike = None):
        self.device = device = resolve_device(device)
        self.model = PhyCRNet(input_channels=2, hidden_channels=(8, 32, 32, 128), input_kernel_size=(4, 4, 4, 3),
                              input_stride=(2, 2, 2, 1), input_padding=(1, 1, 1, 1), dt=DT, num_layers=(3, 1),
                              upscale_factor=8, step=4, effective_step=tuple(range(4)),
                              generator=torch.Generator().manual_seed(SEED), device=device)
        self.u0 = torch.from_numpy(initial_field()).to(device)
        self.lg = loss_generator(dt=DT, dx=1.0 / H)
        self.modules, self.optimizers = [self.model], [Adam(2e-3)(self.model)]
        self._start_loop(device)

    def loss(self) -> torch.Tensor:
        """The Burgers residual of the rollout [u0, x_1, ..., x_4]."""
        out = self.model({"initial_state": None, "input": self.u0})
        roll = torch.stack([u[0] for u in [self.u0] + list(out["outputs"])], 0)  # (5, 2, H, W)
        f_u, f_v = self.lg.get_phy_loss(roll, R=1.0 / NU)
        return torch.mean(f_u ** 2) + torch.mean(f_v ** 2)


def build(*, device: DeviceLike = None) -> PhyCRNetFit:
    return PhyCRNetFit(device=device)


def main(steps: int = 60, *, device: DeviceLike = None) -> float:
    """The JAX ``main``: ``steps`` Adam steps; returns the last residual
    and raises if it did not fall."""
    return run_and_check(build(device=device), steps, "PhyCRNet Burgers residual", ".2f")


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 60)
