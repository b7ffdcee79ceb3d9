"""DeepPhyLSTM for seismic structural response on the port (counterpart
of ``examples/phylstm_seismic.py``; ``model_type=3`` is
``examples/phylstm3_seismic.py``, see ``phylstm3_seismic.py``).

Type 2: the LSTM stacks predict displacement, velocity and restoring
force from the ground acceleration, and the physics term ties the
displacement's derivative (the spectral differentiation matrix phi times
it) to the predicted velocity. Type 3 adds the hysteresis term: phi g
against the third stack's g rate. Data: the JAX example's 16 damped
single-degree-of-freedom responses to random pulse trains, T = 32
(:func:`synthetic_records`, numpy, bitwise equal to it). DeepPhyLSTM with
hidden 32; Adam at 1e-3 (optax's rule); a hand loop of full-batch steps,
run on CUDA K steps to a CUDA graph (``utils/step_graph.py``).

Run on the GPU: ``python -m paddlescience_torch.examples.phylstm_seismic
[steps [model_type]]``.
"""

from __future__ import annotations

import sys
import numpy as np
import torch

from paddlescience_torch.arch.phylstm import DeepPhyLSTM
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.hand_loop import HandLoop, run_and_check
from paddlescience_torch.optimizer.optimizer import Adam

__all__ = ["PhyLSTMFit", "build", "main", "synthetic_records"]

T, N_SAMPLES = 32, 16
SEED = 0  # the JAX example's set_random_seed


def synthetic_records(n: int = N_SAMPLES, seed: int = 0):
    """(ag, eta) of (n, T, 1) each and phi (1, T, T)."""
    rng = np.random.default_rng(seed)
    dt = 0.02
    ag = np.zeros((n, T, 1), np.float32)
    eta = np.zeros((n, T, 1), np.float32)
    for s in range(n):
        a = np.zeros(T)
        for _ in range(3):
            t0 = rng.integers(0, T - 4)
            a[t0: t0 + 4] += rng.normal(0, 5)
        x = v = 0.0
        for t in range(T):
            acc = -a[t] - 2 * 0.05 * 2 * np.pi * v - (2 * np.pi) ** 2 * x
            v += dt * acc
            x += dt * v
            ag[s, t, 0] = a[t]
            eta[s, t, 0] = x
    k = np.fft.fftfreq(T, d=dt) * 2j * np.pi
    F = np.fft.fft(np.eye(T), axis=0)
    Finv = np.fft.ifft(np.eye(T), axis=0)
    phi = np.real(Finv @ np.diag(k) @ F).astype(np.float32)
    return ag, eta, phi[None]


class PhyLSTMFit(HandLoop):
    """The data on the device, the model, its Adam and the step loop."""

    def __init__(self, model_type: int = 2, hidden_size: int = 32, *, device: DeviceLike = None):
        self.device = device = resolve_device(device)
        self.model_type = model_type
        ag, eta, phi = synthetic_records()
        self.inputs = {"ag": torch.from_numpy(ag).to(device), "ag_c": torch.from_numpy(ag).to(device),
                       "phi": torch.from_numpy(phi).to(device)}
        self.eta = torch.from_numpy(eta).to(device)
        self.model = DeepPhyLSTM(1, 1, hidden_size=hidden_size, model_type=model_type,
                                 generator=torch.Generator().manual_seed(SEED), device=device)
        self.modules, self.optimizers = [self.model], [Adam(1e-3)(self.model)]
        self._start_loop(device)

    def loss(self) -> torch.Tensor:
        out = self.model(self.inputs)
        data = torch.mean((out["eta_pred"] - self.eta) ** 2)
        phys = torch.mean((out["eta_t_pred_c"] - out["eta_dot_pred_c"]) ** 2)
        if self.model_type == 3:
            phys = phys + torch.mean(out["g_t_pred_c"] ** 2)
        return data + phys


def build(model_type: int = 2, *, device: DeviceLike = None) -> PhyLSTMFit:
    return PhyLSTMFit(model_type, device=device)


def main(steps: int = 80, model_type: int = 2, *, device: DeviceLike = None) -> float:
    """The JAX ``main``: ``steps`` Adam steps; returns the last loss and
    raises if it did not fall."""
    return run_and_check(build(model_type, device=device), steps, "DeepPhyLSTM loss")


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 80, int(argv[1]) if len(argv) > 1 else 2)
