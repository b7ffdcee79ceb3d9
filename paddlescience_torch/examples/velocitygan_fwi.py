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
import weakref
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from paddlescience_torch.arch.geofno import VelocityDiscriminator, VelocityGenerator
from paddlescience_torch.data.dataset.domain_dataset import FWIDataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.utils.step_graph import StepGraph

__all__ = ["VelocityGAN", "build", "main"]


class VelocityGAN:
    """The data, both networks, their optimizers and the step pair."""

    def __init__(self, num_samples: int = 16, dim: int = 16, seed: int = 0, *, device: DeviceLike = None):
        self.device = device = resolve_device(device)
        ds = FWIDataset(("data",), ("label",), num_samples=num_samples)
        x = torch.from_numpy(ds.input["data"]).to(device)
        y = torch.from_numpy(ds.label["label"]).to(device)
        self.x = (x - x.mean()) / (x.std(unbiased=False) + 1e-8)
        self.y = (y - y.mean()) / (y.std(unbiased=False) + 1e-8)
        self.gen = VelocityGenerator(("data",), ("velocity",), in_channels=1, dim=dim, out_size=(32, 32),
                                     generator=torch.Generator().manual_seed(seed), device=device)
        self.disc = VelocityDiscriminator(("velocity",), ("score",), in_channels=1, dim=dim,
                                          generator=torch.Generator().manual_seed(seed + 1), device=device)
        self.g_opt = Adam(2e-4, beta1=0.5)(self.gen)
        self.d_opt = Adam(2e-4, beta1=0.5)(self.disc)
        me = weakref.proxy(self)  # the loop reaches its model weakly: dropping the model frees its graphs
        self.loop = StepGraph(lambda i: me._step(), device, state=lambda: me._state())

    def d_loss(self) -> torch.Tensor:
        with torch.no_grad():
            fake = self.gen.forward_tensor(self.x)
        s_real = self.disc.forward_tensor(self.y)
        s_fake = self.disc.forward_tensor(fake)
        return torch.mean(F.relu(1.0 - s_real)) + torch.mean(F.relu(1.0 + s_fake))

    def g_loss(self):
        fake = self.gen.forward_tensor(self.x)
        s_fake = self.disc.forward_tensor(fake)
        l1 = torch.mean(torch.abs(fake - self.y))
        l2 = torch.mean((fake - self.y) ** 2)
        return -torch.mean(s_fake) + 100.0 * l1 + 100.0 * l2, l1

    def _state(self) -> List[torch.Tensor]:
        out = list(self.gen.parameters()) + list(self.disc.parameters())
        for opt in (self.g_opt, self.d_opt):
            out += [t for s in opt.state_tensors().values() for t in s.values()]
        return out

    def _step(self) -> Dict[str, torch.Tensor]:
        self.d_opt.zero_grad()
        d_loss = self.d_loss()
        d_loss.backward()
        self.d_opt.step(0)
        self.g_opt.zero_grad()
        g_loss, l1 = self.g_loss()
        g_loss.backward(inputs=list(self.gen.parameters()))  # the discriminator stays as it is
        self.g_opt.step(0)
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(), "l1": l1.detach()}

    def train_steps(self, n: int, k: int = 1) -> Dict[str, float]:
        """``n`` step pairs in chunks of ``k`` (one graph replay each on
        CUDA when k > 1); returns the last pair's logs."""
        if n % k:
            raise ValueError(f"{n} steps do not split into chunks of {k}")
        for _ in range(n // k):
            logs = self.loop.run(k, graphed=k > 1)
        return {name: float(v) for name, v in logs.items()}


def build(num_samples: int = 16, dim: int = 16, seed: int = 0, *, device: DeviceLike = None) -> VelocityGAN:
    return VelocityGAN(num_samples, dim, seed, device=device)


def main(steps: int = 60, k: Optional[int] = None, *, device: DeviceLike = None) -> float:
    """The JAX ``main``: ``steps`` step pairs (chunks of ``k``); returns the
    last reconstruction L1 and raises if it did not fall."""
    gan = build(device=device)
    k = k or 1
    first = gan.train_steps(1)["l1"]
    last = first
    if steps > 1:
        if (steps - 1) % k:
            raise ValueError(f"{steps - 1} steps after the first do not split into chunks of {k}")
        for _ in range((steps - 1) // k):
            last = gan.train_steps(k, k)["l1"]
    print(f"VelocityGAN reconstruction L1: {first:.4f} -> {last:.4f} over {steps} steps")
    if not last < first:
        raise AssertionError(f"the reconstruction L1 did not fall: {first} -> {last}")
    return last


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 60)
