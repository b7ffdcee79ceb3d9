"""DGMR, the deep generative model of radar, on the port (counterpart of
``examples/dgmr.py``).

A short generator fit on the precipitation-weighted grid-cell
regulariser (mean |G(x) - y| clip(y, 0, 24)) over synthetic radar
sequences (:func:`synth_radar`: one advecting Gaussian cell a sequence,
numpy, bitwise the JAX example's), then the three scores of the JAX
example: the hinge d_loss and g_loss from an untrained
``DGMRDiscriminators`` (spatial and temporal, one layer each) and the
grid-cell loss, which must not exceed the first step's. ``DGMR`` at
latent and context 32 (the example's widths), Adam (optax's rule); a hand
loop of one step an update, run on CUDA K steps to a CUDA graph
(``utils/step_graph.py``; compare graphed and eager steps inside
``deterministic_convs()``).

Run on the GPU: ``python -m paddlescience_torch.examples.dgmr [epochs]``.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from paddlescience_torch.arch.dgmr import DGMR, DGMRDiscriminators
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.hand_loop import HandLoop
from paddlescience_torch.optimizer.optimizer import Adam

__all__ = ["DGMRFit", "synth_radar", "grid_cell_regularizer", "hinge_scores", "run"]

SEED = 0  # the JAX example's set_random_seed


def synth_radar(n: int = 4, t_in: int = 4, t_out: int = 6, hw: int = 32, seed: int = 0):
    """``n`` sequences of one advecting cell: the (n, t_in, 1, hw, hw)
    context and the (n, t_out, 1, hw, hw) future."""
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n):
        x0, y0 = rng.uniform(8, 24, 2)
        vx, vy = rng.uniform(-1.5, 1.5, 2)
        gx, gy = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
        frames = []
        for t in range(t_in + t_out):
            cx, cy = x0 + vx * t, y0 + vy * t
            frames.append((10 * np.exp(-(((gx - cx) ** 2 + (gy - cy) ** 2) / 18.0))).astype("float32"))
        seqs.append(np.stack(frames)[:, None])
    seqs = np.stack(seqs)
    return seqs[:, :t_in], seqs[:, t_in:]


def grid_cell_regularizer(gen: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The precipitation-weighted L1: mean |gen - target| clip(target, 0, 24)."""
    return torch.mean(torch.abs(gen - target) * torch.clamp(target, 0.0, 24.0))


def hinge_scores(disc, real: torch.Tensor, gen: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The JAX example's d_loss, g_loss and grid_loss of ``gen`` against
    ``real`` under ``disc`` (the spatial plus the temporal score)."""
    score_real, score_gen = sum(disc(real)), sum(disc(gen))
    grid = grid_cell_regularizer(gen, real)
    return {"d_loss": torch.mean(F.relu(1.0 - score_real)) + torch.mean(F.relu(1.0 + score_gen)),
            "g_loss": -torch.mean(score_gen) + 20 * grid, "grid_loss": grid}


class DGMRFit(HandLoop):
    """The context and future frames on the device, the model, its Adam and
    the step loop on the grid-cell loss."""

    def __init__(self, t_in: int = 4, t_out: int = 6, hw: int = 64, lr: float = 1e-4, n_seq: int = 4, *,
                 latent_channels: int = 32, context_channels: int = 32, device: DeviceLike = None):
        self.device = device = resolve_device(device)
        ctx, future = synth_radar(n=n_seq, t_in=t_in, t_out=t_out, hw=hw)
        self.x = torch.from_numpy(ctx).to(device)
        self.y = torch.from_numpy(future).to(device)
        self.model = DGMR(("input_frames",), ("future_frames",), forecast_steps=t_out, input_channels=1,
                          latent_channels=latent_channels, context_channels=context_channels,
                          num_input_frames=t_in, output_shape=hw, generator=torch.Generator().manual_seed(SEED),
                          device=device)
        self.modules, self.optimizers = [self.model], [Adam(lr)(self.model)]
        self._start_loop(device)

    def forecast(self) -> torch.Tensor:
        return self.model({"input_frames": self.x})["future_frames"]

    def loss(self) -> torch.Tensor:
        return grid_cell_regularizer(self.forecast(), self.y)


def run(epochs: int = 5, t_in: int = 4, t_out: int = 6, hw: int = 64, lr: float = 1e-4, n_seq: int = 4, *,
        device: DeviceLike = None, fit: Optional[DGMRFit] = None,
        disc: Optional[DGMRDiscriminators] = None) -> Tuple[float, Dict[str, float]]:
    """The JAX ``run``: ``epochs`` Adam steps on the grid-cell loss (of
    ``fit``, when given, else a new :class:`DGMRFit`), then the scores
    under ``disc`` (an untrained ``DGMRDiscriminators`` when None); raises
    if the grid-cell loss exceeds the first step's. Returns the grid-cell
    loss and the scores."""
    fit = fit if fit is not None else DGMRFit(t_in, t_out, hw, lr, n_seq, device=device)
    first = fit.train_steps(1)["loss"]
    if epochs > 1:
        fit.train_steps(epochs - 1)
    with torch.no_grad():
        disc = disc if disc is not None else DGMRDiscriminators(input_channels=1, device=fit.device)
        scores = {k: float(v) for k, v in hinge_scores(disc, fit.y, fit.forecast()).items()}
    print(f"d_loss: {scores['d_loss']:.4f}")
    print(f"g_loss: {scores['g_loss']:.4f}")
    print(f"grid_loss: {first:.4f} -> {scores['grid_loss']:.4f}")
    if not scores["grid_loss"] <= first:
        raise AssertionError(f"the grid-cell loss rose: {first} -> {scores['grid_loss']}")
    return scores["grid_loss"], scores


if __name__ == "__main__":
    argv = sys.argv[1:]
    run(int(argv[0]) if argv else 5)
