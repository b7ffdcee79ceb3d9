"""The (2+1)-D Brusselator data set of the LNO example, generated by the
port (counterpart of ``tools/gen_brusselator3d.py``, whose rollout needs
JAX).

    u_t = Du lap(u) + a - (b + 1) u + u^2 v + phi(t)
    v_t = Dv lap(v) + b u - u^2 v

on a 28 x 28 periodic grid with a = 1, b = 1.7 (stable: the forcing to
response map is a smooth nonlinear filter), Du = 0.002, Dv = 0.02, one
fixed random perturbation of the initial u shared by every sample, and a
random smooth forcing phi(t) = sum_k c_k sin(w_k t + theta_k), k < 4, per
sample. The forcings and the perturbation are drawn in numpy with the
tool's seeds (1234 for the perturbation; 7 for the train set, 8 for the
test set, each sample's coefficients from ``default_rng`` of the set's
``integers(1 << 31)``), so the inputs equal the tool's bitwise. The IMEX
rollout (exact diffusion through the FFT, explicit reaction, dt = 2e-3,
250 steps a frame, u recorded on 39 frames over t in [0, 19]) runs in
torch in float32 and complex64, batched over the samples, on the given
device. Nothing is written to disk.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from paddlescience_torch.device import DeviceLike, resolve_device

__all__ = ["NT", "NX", "forcings", "signals", "initial_perturbation", "simulate", "generate", "load_or_generate"]

NT, NX = 39, 28
T_END = 19.0
A, B = 1.0, 1.7
DU, DV = 0.002, 0.02
DT = 2e-3
KEYS = ("inputs_train", "outputs_train", "inputs_test", "outputs_test")


def initial_perturbation() -> np.ndarray:
    """The perturbation of the initial u shared by all samples (NX, NX), float64."""
    return 0.1 * np.random.default_rng(1234).standard_normal((NX, NX))


def forcings(n: int, seed: int) -> np.ndarray:
    """(n, 3, 4) forcing coefficients (c, w, theta) of ``n`` samples."""
    rng = np.random.default_rng(seed)
    coefs = np.empty((n, 3, 4))
    for i in range(n):
        c_rng = np.random.default_rng(rng.integers(1 << 31))
        coefs[i, 0] = c_rng.normal(0, 0.3, 4)
        coefs[i, 1] = c_rng.uniform(0.3, 2.0, 4)
        coefs[i, 2] = c_rng.uniform(0, 2 * np.pi, 4)
    return coefs


def _phi(coef: np.ndarray, t: np.ndarray) -> np.ndarray:
    c, w, th = coef
    return np.sum(c[:, None] * np.sin(w[:, None] * t[None, :] + th[:, None]), 0)


def signals(coefs: np.ndarray) -> np.ndarray:
    """The forcings phi on the NT frames (n, NT), float32: the data set's inputs."""
    frames_t = np.linspace(0.0, T_END, NT)
    return np.stack([_phi(c, frames_t) for c in coefs]).astype(np.float32).reshape(len(coefs), NT)


def simulate(coefs: np.ndarray, ic_pert: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """The u frames (n, NT, NX, NX), float32 on ``device``, of the
    samples with forcing coefficients ``coefs`` (n, 3, 4)."""
    device = resolve_device(device)
    dt = DT
    frames_t = np.linspace(0.0, T_END, NT)
    k = np.fft.fftfreq(NX, d=1.0 / NX) * 2 * np.pi
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    eu = torch.as_tensor(np.exp(-DU * k2 * dt).astype(np.float32), device=device)
    ev = torch.as_tensor(np.exp(-DV * k2 * dt).astype(np.float32), device=device)
    steps_per_frame = int(round((frames_t[1] - frames_t[0]) / dt))
    n_steps = steps_per_frame * (NT - 1)
    t = np.arange(n_steps) * dt
    phis = torch.as_tensor(np.stack([_phi(c, t) for c in coefs]).astype(np.float32).T.copy(), device=device)
    n = len(coefs)
    u = torch.as_tensor(np.asarray(A + ic_pert, np.float32), device=device).expand(n, NX, NX).clone()
    v = torch.full((n, NX, NX), B / A, dtype=torch.float32, device=device)
    frames = torch.empty((n, NT, NX, NX), dtype=torch.float32, device=device)
    frames[:, 0] = u
    for s in range(n_steps):
        phi = phis[s][:, None, None]
        uuv = u * u * v
        ru = A - (B + 1.0) * u + uuv + phi
        rv = B * u - uuv
        u = torch.fft.ifft2(torch.fft.fft2(u + dt * ru) * eu).real
        v = torch.fft.ifft2(torch.fft.fft2(v + dt * rv) * ev).real
        if (s + 1) % steps_per_frame == 0:
            frames[:, (s + 1) // steps_per_frame] = u
    return frames


def generate(n_train: int = 800, n_test: int = 200, device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """The tool's four arrays: inputs (n, NT) and outputs (n, NT, NX, NX),
    float32, for the train (seed 7) and test (seed 8) sets."""
    ic = initial_perturbation()
    out = {}
    for part, n, seed in (("train", n_train, 7), ("test", n_test, 8)):
        coefs = forcings(n, seed)
        out[f"inputs_{part}"] = signals(coefs)
        out[f"outputs_{part}"] = simulate(coefs, ic, device).cpu().numpy()
    return out


def load_or_generate(path: Optional[str] = None, device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """The data set: read from the ``.npz`` at ``path`` (the tool's layout)
    when given, else generated on ``device``."""
    if path is not None:
        with np.load(path) as raw:
            return {k: np.asarray(raw[k]) for k in KEYS}
    return generate(device=device)
