"""Visualizers (counterpart of ``paddlescience_tpu/visualize/visualizer.py``):
each holds input points, output expressions and a batch size, and
``save(filename, data_dict)`` writes the fields it is handed.

``VisualizerRadar`` writes one PNG a field: a strip of its frames, one
panel a time step ("turbo" colour map from 0). matplotlib is imported
when a strip is written, with its "Agg" backend, so the module imports on
a machine without it. Given the same arrays it writes the JAX writer's
file byte for byte.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

__all__ = ["Visualizer", "VisualizerRadar"]


class Visualizer:
    """Input points, output expressions ``{name: fn(outputs)}``, batch
    size, timestamps and a file prefix; subclasses write in ``save``."""

    def __init__(self, input_dict: Dict[str, np.ndarray], output_expr: Dict[str, Callable], batch_size: int = 64,
                 num_timestamps: int = 1, prefix: str = "vtu"):
        self.input_dict = input_dict
        self.input_keys = tuple(input_dict.keys())
        self.output_expr = output_expr
        self.output_keys = tuple(output_expr.keys())
        self.batch_size = batch_size
        self.num_timestamps = num_timestamps
        self.prefix = prefix

    def save(self, filename: str, data_dict: Dict[str, np.ndarray]):
        raise NotImplementedError

    def __str__(self):
        return ", ".join([self.__class__.__name__, f"input_keys = {self.input_keys}",
                          f"output_keys = {self.output_keys}", f"prefix = {self.prefix}"])


class VisualizerRadar(Visualizer):
    """Radar echo frame strips: ``{filename}_{key}.png`` for each output
    key, its (T, H, W) frames (squeezed; one frame is a strip of one) in
    a row."""

    def __init__(self, input_dict, output_expr, batch_size: int = 1, num_timestamps: int = 1,
                 prefix: str = "plot_radar", **kwargs):
        super().__init__(input_dict, output_expr, batch_size, num_timestamps, prefix)

    def save(self, filename: str, data_dict):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for k in self.output_keys:
            frames = np.squeeze(np.asarray(data_dict[k]))
            if frames.ndim == 2:
                frames = frames[None]
            T = frames.shape[0]
            fig, axes = plt.subplots(1, T, figsize=(2 * T, 2.2), squeeze=False)
            for t in range(T):
                axes[0][t].imshow(frames[t], cmap="turbo", vmin=0)
                axes[0][t].set_axis_off()
                axes[0][t].set_title(f"t={t}", fontsize=8)
            os.makedirs(os.path.dirname(os.path.abspath(filename)) or ".", exist_ok=True)
            fig.savefig(f"{filename}_{k}.png", dpi=100, bbox_inches="tight")
            plt.close(fig)
