"""AutoEncoder, the variational autoencoder (counterpart of
``paddlescience_tpu/arch/vae.py``): tanh encoder to (mu, log_sigma),
z = mu + eps exp(log_sigma), tanh decoder; outputs (mu, log_sigma,
decoded z).

The JAX module draws eps from one fixed key (``PRNGKey(0)``, or the key
given to ``set_rng``) at every call, so every call with the same shape
sees the same eps. The port keeps that: eps of a shape is drawn once, from
a CPU ``torch.Generator`` seeded with 0, or with the seed given to
:meth:`set_rng`, moved to the device and kept, and every later call reads it.
Nothing is drawn inside a CUDA graph: a captured step reads the eps that
its warm-up steps drew (a capture that meets a new shape raises).
:meth:`set_noise` puts a given eps in place (the parity tests pass JAX's
draw in). The generator is not JAX's, so the draws themselves differ.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from paddlescience_torch.arch import base
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Linear

__all__ = ["AutoEncoder"]


class AutoEncoder(base.Arch):
    """``input_keys`` concatenated (B, input_dim) -> ``output_keys``: mu,
    log_sigma (B, latent_dim) and the decoded z (B, input_dim)."""

    def __init__(self, input_keys: Tuple[str, ...], output_keys: Tuple[str, ...], input_dim: int, latent_dim: int,
                 hidden_dim: int, *, generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_keys = tuple(input_keys)
        self.output_keys = tuple(output_keys)
        self.enc_lin = Linear(input_dim, hidden_dim, generator=g)
        self.enc_mu = Linear(hidden_dim, latent_dim, generator=g)
        self.enc_log_sigma = Linear(hidden_dim, latent_dim, generator=g)
        self.dec1 = Linear(latent_dim, hidden_dim, generator=g)
        self.dec2 = Linear(hidden_dim, input_dim, generator=g)
        self._seed = 0  # the JAX module's PRNGKey(0)
        self._eps: Dict[tuple, torch.Tensor] = {}
        self.to(device)

    def set_rng(self, seed: int) -> None:
        """Draw eps from ``seed`` from now on (the JAX module's ``set_rng``
        takes a key); the kept draws are dropped."""
        self._seed = int(seed)
        self._eps.clear()

    def set_noise(self, eps: torch.Tensor) -> None:
        """Use ``eps`` at every call whose mu has its shape."""
        eps = eps.detach().to(self.enc_mu.weight.device, self.enc_mu.weight.dtype)
        self._eps[(tuple(eps.shape), eps.device, eps.dtype)] = eps

    def noise(self, mu: torch.Tensor) -> torch.Tensor:
        """The eps of ``mu``'s shape on its device (drawn at the first call)."""
        key = (tuple(mu.shape), mu.device, mu.dtype)
        if key not in self._eps:
            if mu.is_cuda and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"AutoEncoder: no eps of shape {tuple(mu.shape)} drawn before the CUDA graph "
                                   "capture (run the step once eagerly first)")
            g = torch.Generator().manual_seed(self._seed)
            self._eps[key] = torch.randn(mu.shape, generator=g).to(mu.device, mu.dtype)
        return self._eps[key]

    def encoder(self, x):
        h = torch.tanh(self.enc_lin(x))
        return self.enc_mu(h), self.enc_log_sigma(h)

    def decoder(self, z):
        return self.dec2(torch.tanh(self.dec1(z)))

    def forward_tensor(self, x):
        mu, log_sigma = self.encoder(x)
        z = mu + self.noise(mu) * torch.exp(log_sigma)
        return mu, log_sigma, self.decoder(z)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        mu, log_sigma, dz = self.forward_tensor(self.concat_to_tensor(x, self.input_keys, axis=-1))
        return {self.output_keys[0]: mu, self.output_keys[1]: log_sigma, self.output_keys[2]: dz}
