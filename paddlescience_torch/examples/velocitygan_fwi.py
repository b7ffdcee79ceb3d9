"""VelocityGAN: adversarial full-waveform inversion, on the port
(counterpart of ``examples/velocitygan_fwi.py``).

The generator maps seismic gathers to velocity maps (32 x 32), the
discriminator scores velocity maps (``arch/geofno.py``, both ``dim`` 16).
Data: ``FWIDataset``'s 16 synthetic layered-velocity samples, both fields
normalised to zero mean and unit deviation. Each iteration is the JAX
example's pair of steps: the discriminator's, on the hinge loss
mean(relu(1 - D(y))) + mean(relu(1 + D(G(x)))) with G(x) held constant;
then the generator's, against the updated discriminator, on -mean(D(G(x)))
+ 100 L1 + 100 L2 of G(x) - y. Each network has its own Adam (2e-4, b1 =
0.5; optax's rule). On CUDA the pair runs captured in a CUDA graph
(``utils/step_graph.py``), K iterations a replay.

Run on the GPU: ``python -m paddlescience_torch.examples.velocitygan_fwi
[steps]``.
"""

from __future__ import annotations

import sys
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from paddlescience_torch.arch.geofno import VelocityDiscriminator, VelocityGenerator
from paddlescience_torch.data.dataset.domain_dataset import FWIDataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.hand_loop import GANLoop, run_and_check
from paddlescience_torch.optimizer.optimizer import Adam

__all__ = ["VelocityGAN", "build", "main"]

SEED = 0  # the JAX example's set_random_seed


class VelocityGAN(GANLoop):
    """The data, both networks, their optimizers and the step pair."""

    def __init__(self, num_samples: int = 16, dim: int = 16, *, device: DeviceLike = None):
        self.device = device = resolve_device(device)
        ds = FWIDataset(("data",), ("label",), num_samples=num_samples)
        x = torch.from_numpy(ds.input["data"]).to(device)
        y = torch.from_numpy(ds.label["label"]).to(device)
        self.x = (x - x.mean()) / (x.std(unbiased=False) + 1e-8)
        self.y = (y - y.mean()) / (y.std(unbiased=False) + 1e-8)
        self.gen = VelocityGenerator(("data",), ("velocity",), in_channels=1, dim=dim, out_size=(32, 32),
                                     generator=torch.Generator().manual_seed(SEED), device=device)
        self.disc = VelocityDiscriminator(("velocity",), ("score",), in_channels=1, dim=dim,
                                          generator=torch.Generator().manual_seed(SEED + 1), device=device)
        self.g_opt = Adam(2e-4, beta1=0.5)(self.gen)
        self.d_opt = Adam(2e-4, beta1=0.5)(self.disc)
        self._start_loop(device)

    def d_loss(self) -> torch.Tensor:
        with torch.no_grad():
            fake = self.gen.forward_tensor(self.x)
        s_real = self.disc.forward_tensor(self.y)
        s_fake = self.disc.forward_tensor(fake)
        return torch.mean(F.relu(1.0 - s_real)) + torch.mean(F.relu(1.0 + s_fake))

    def g_loss(self) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        fake = self.gen.forward_tensor(self.x)
        s_fake = self.disc.forward_tensor(fake)
        l1 = torch.mean(torch.abs(fake - self.y))
        l2 = torch.mean((fake - self.y) ** 2)
        return -torch.mean(s_fake) + 100.0 * l1 + 100.0 * l2, {"l1": l1}


def build(num_samples: int = 16, dim: int = 16, *, device: DeviceLike = None) -> VelocityGAN:
    return VelocityGAN(num_samples, dim, device=device)


def main(steps: int = 60, *, device: DeviceLike = None) -> float:
    """The JAX ``main``: ``steps`` step pairs; returns the last
    reconstruction L1 and raises if it did not fall."""
    return run_and_check(build(device=device), steps, "VelocityGAN reconstruction L1", ".4f", key="l1")


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 60)
