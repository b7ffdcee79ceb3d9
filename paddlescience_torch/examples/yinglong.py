"""YingLong-style regional weather rollout, on the port (counterpart of
``examples/yinglong.py``).

An ``AFNONet`` backbone (32 x 64 fields of 2 channels plus two
sinusoidal time-of-day features, patch 4, embed 96, depth 2, 4 blocks) is
fitted for ``fit_steps`` Adam steps on frame 0 -> frame 1 of the JAX
example's synthetic sequences (:func:`synth_fields`, the same numpy
draw), or loaded from a checkpoint, then rolled out ``rollout_steps``
steps with the time features of each step appended; the per-step RMSE
against the sequence is the score. On CUDA the fit runs its step captured
in a CUDA graph (``utils/step_graph.py``).

Run on the GPU: ``python -m paddlescience_torch.examples.yinglong
[rollout steps]``.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from paddlescience_torch.arch.afno import AFNONet
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.hand_loop import HandLoop
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.utils import save_load

__all__ = ["H", "W", "C", "time_features", "synth_fields", "YingLong", "run"]

H, W, C = 32, 64, 2


def time_features(step, h=H, w=W):
    """Sin and cos of the hour of the day, broadcast over the grid: (h, w, 2)."""
    ang = 2 * np.pi * (step % 24) / 24.0
    return np.stack([np.full((h, w), np.sin(ang), "float32"), np.full((h, w), np.cos(ang), "float32")], -1)


def synth_fields(n=6, t=8, seed=0):
    """(n, t, H, W, C) sequences: smooth fields rolled east one and two
    cells a frame."""
    rng = np.random.default_rng(seed)
    k = np.fft.fftfreq(H)[:, None] ** 2 + np.fft.fftfreq(W)[None, :] ** 2
    amp = 1.0 / (1.0 + 500 * k)
    seqs = []
    for _ in range(n):
        f = np.real(np.fft.ifft2(np.fft.fft2(rng.standard_normal((H, W))) * amp))
        frames = [np.stack([np.roll(f, s, axis=1), np.roll(f, 2 * s, axis=1)], -1) for s in range(t)]
        seqs.append(np.stack(frames).astype("float32"))
    return np.stack(seqs)


class YingLong(HandLoop):
    """The backbone, the sequences on the device and the fit step."""

    def __init__(self, lr: float = 1e-3, seed: int = 0, *, device: DeviceLike = None):
        self.device = device = resolve_device(device)
        self.model = AFNONet(("input",), ("output",), img_size=(H, W), in_channels=C + 2, out_channels=C,
                             patch_size=(4, 4), embed_dim=96, depth=2, num_blocks=4,
                             generator=torch.Generator().manual_seed(seed), device=device)
        self.data = torch.from_numpy(synth_fields()).to(device)  # (N, T, H, W, C)
        n = self.data.shape[0]
        tf0 = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(time_features(0), (n, H, W, 2)))).to(device)
        self.x = torch.cat([self.data[:, 0], tf0], -1).permute(0, 3, 1, 2).contiguous()
        self.y = self.data[:, 1]
        self.optimizer = Adam(lr)(self.model)
        self.modules, self.optimizers = [self.model], [self.optimizer]
        self._start_loop(device)

    def forward(self, frame: torch.Tensor, step: int) -> torch.Tensor:
        """One rollout step: (N, H, W, C) frame -> the next, with the time
        features of ``step`` appended."""
        tf = torch.from_numpy(np.ascontiguousarray(np.broadcast_to(time_features(step), frame.shape[:-1] + (2,))))
        inp = torch.cat([frame, tf.to(frame.device)], -1).permute(0, 3, 1, 2)
        return self.model({"input": inp})["output"].permute(0, 2, 3, 1)

    def loss(self) -> torch.Tensor:
        pred = self.model({"input": self.x})["output"]
        return torch.mean((pred.permute(0, 2, 3, 1) - self.y) ** 2)

    def fit(self, steps: int, k: int = 1) -> float:
        """``steps`` Adam steps in chunks of ``k``; returns the last loss."""
        return self.train_steps(steps, k)["loss"]

    @torch.no_grad()
    def rollout(self, rollout_steps: int) -> List[float]:
        frame, rmses = self.data[:, 0], []
        for s in range(1, rollout_steps + 1):
            frame = self.forward(frame, s - 1)
            rmses.append(float(torch.sqrt(torch.mean((frame - self.data[:, s]) ** 2))))
        return rmses


def run(rollout_steps: int = 4, fit_steps: int = 40, lr: float = 1e-3, pretrained: Optional[str] = None,
        k: Optional[int] = None, *, device: DeviceLike = None) -> float:
    """The JAX ``run``: fit (or load ``pretrained``), roll out, print each
    step's RMSE; returns their mean."""
    yl = YingLong(lr, device=device)
    if pretrained:
        params = save_load.load_pretrain(pretrained, dict(yl.model.named_parameters()))
        with torch.no_grad():
            for n, p in yl.model.named_parameters():
                p.copy_(params[n])
    else:
        print(f"fit loss: {yl.fit(fit_steps, k or 1):.5f}")
    rmses = yl.rollout(rollout_steps)
    for s, r in enumerate(rmses, 1):
        print(f"rollout step {s}: RMSE {r:.4f}")
    return float(np.mean(rmses))


if __name__ == "__main__":
    argv = sys.argv[1:]
    run(rollout_steps=int(argv[0]) if argv else 4)
