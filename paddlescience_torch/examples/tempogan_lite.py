"""tempoGAN-style adversarial super-resolution of fluid fields on the port
(counterpart of ``examples/tempogan_lite.py``).

The training frames are the lid-driven cavity's velocity magnitude from
the D2Q9 lattice-Boltzmann solver (``ops/lbm.py``): 16 frames at 64 x 64
(nu = 0.1 nx / 400, lid speed 0.1), 50 steps apart, each step through
``lbm_step``, whose collision and streaming are the hand-written
``lbm_collide_stream`` kernel on the card (the plain version on a CPU
lattice), normalised to max 1 (:func:`make_lbm_frames`). The JAX example
makes them with ``lbm_step_reference``, the same function. The generator
(``arch/gan.py``: three variant residual blocks of 3x3 convolutions, 16
channels) maps the 4x nearest-upsampled 16 x 16 frames to 64 x 64; the
discriminator (8 and 16 channels, stride 2, leaky ReLU 0.2, a Linear
head) scores them. Each iteration is the JAX example's pair: the
discriminator's Adam step on the non-saturating loss mean(softplus(-D(hi)))
+ mean(softplus(D(G(lo)))) with G(lo) held constant, then the generator's
on 5 L1 + 0.1 mean(softplus(-D(G(lo)))) against the updated
discriminator; Adam 2e-4 each (optax's rule). On CUDA the pair runs K
iterations to a CUDA graph (``utils/step_graph.py``).

Run on the GPU: ``python -m paddlescience_torch.examples.tempogan_lite
[epochs]``.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import torch

from paddlescience_torch.arch.gan import Discriminator, Generator
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.hand_loop import GANLoop
from paddlescience_torch.nn.resize import resize
from paddlescience_torch.ops import lbm
from paddlescience_torch.optimizer.optimizer import Adam

__all__ = ["TempoGAN", "build", "train", "make_lbm_frames"]

SEED = 42  # the JAX example's set_random_seed


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def make_lbm_frames(n_frames: int = 16, nx: int = 64, steps_between: int = 50, *, device: DeviceLike = None,
                    step=None) -> torch.Tensor:
    """(n_frames, 1, nx, nx) velocity magnitudes of the cavity from rest,
    one every ``steps_between`` steps of ``step`` (default ``lbm.lbm_step``),
    divided by their largest magnitude."""
    device = resolve_device(device)
    step = lbm.lbm_step if step is None else step
    nu = 0.1 * nx / 400.0
    tau = 3.0 * nu + 0.5
    rest = torch.zeros(nx, nx, device=device)
    f = lbm._equilibrium(torch.ones(nx, nx, device=device), rest, rest)
    frames = []
    for _ in range(n_frames):
        for _ in range(steps_between):
            f = step(f, tau, 0.1)
        _, ux, uy = lbm._macroscopic(f)
        frames.append(torch.sqrt(ux ** 2 + uy ** 2))
    frames = torch.stack(frames)[:, None]
    return frames / (frames.abs().max() + 1e-9)


class TempoGAN(GANLoop):
    """The frames, both networks, their optimizers and the step pair."""

    def __init__(self, n_frames: int = 16, nx: int = 64, *, device: DeviceLike = None,
                 frames: Optional[torch.Tensor] = None):
        self.device = device = resolve_device(device)
        self.nx = nx
        self.hi = (make_lbm_frames(n_frames, nx, device=device) if frames is None else frames).to(device)
        self.lo = self.hi[:, :, ::4, ::4].contiguous()  # 4x downsampled
        g = torch.Generator().manual_seed(SEED)
        self.gen = Generator(("in",), ("out",), 1, out_channels_tuple=((16, 16), (16, 16), (16, 1)),
                             kernel_sizes_tuple=((3, 3),) * 3, strides_tuple=((1, 1),) * 3,
                             use_bns_tuple=((False, False),) * 3, acts_tuple=(("relu", None),) * 3, generator=g,
                             device=device)
        self.disc = Discriminator(("x",), ("f1", "f2", "score"), 1, (8, 16), 16 * (nx // 4) ** 2, (3, 3), (2, 2),
                                  (False, False), ("leaky_relu", "leaky_relu"), generator=g, device=device)
        self.g_opt = Adam(2e-4)(self.gen)
        self.d_opt = Adam(2e-4)(self.disc)
        self._start_loop(device)

    def generate(self, lo: torch.Tensor) -> torch.Tensor:
        up = resize(lo, lo.shape[:2] + (self.nx, self.nx), "nearest")
        return self.gen.forward_tensor(up)

    def score(self, img: torch.Tensor) -> torch.Tensor:
        return self.disc.forward_tensor(img)[-1]

    def d_loss(self) -> torch.Tensor:
        with torch.no_grad():
            fake = self.generate(self.lo)
        return torch.mean(_softplus(-self.score(self.hi))) + torch.mean(_softplus(self.score(fake)))

    def g_loss(self) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        fake = self.generate(self.lo)
        adv = torch.mean(_softplus(-self.score(fake)))
        pix = torch.mean(torch.abs(fake - self.hi))
        return 5.0 * pix + 0.1 * adv, {"pix": pix, "adv": adv}


def build(n_frames: int = 16, nx: int = 64, *, device: DeviceLike = None) -> TempoGAN:
    return TempoGAN(n_frames, nx, device=device)


def train(epochs: int = 20, n_frames: int = 16, nx: int = 64, *, device: DeviceLike = None) -> float:
    """The JAX ``train``: ``epochs`` step pairs; prints the losses ten
    times; returns the last pixel L1."""
    gan = build(n_frames, nx, device=device)
    every = max(epochs // 10, 1)
    for epoch in range(1, epochs + 1):
        logs = gan.train_steps(1)
        if epoch % every == 0:
            print(f"epoch {epoch}: pix L1 {logs['pix']:.5f}, adv {logs['adv']:.4f}, d {logs['d_loss']:.4f}")
    return logs["pix"]


if __name__ == "__main__":
    argv = sys.argv[1:]
    train(int(argv[0]) if argv else 20)
