"""Earthformer on ENSO sea-surface temperature, on the port (counterpart
of ``examples/earthformer_enso.py``).

``CuboidTransformer`` maps 6 months of SST on a 16 x 32 grid to the next
4 (base 32 channels, 4 heads, two levels of one block each, 4 global
vectors, the axial / axial / cross_1x1 patterns, dropout 0.1 at all three
sites); the data are ``ENSODataset``'s synthetic spectral SST (no archive
is read), windows every month, batches of 4 (shuffled, the short last
dropped), 3 steps an epoch; MSE; AdamW (weight decay 1e-5) on a cosine
schedule at 2e-3 with one warmup epoch; the score RMSE. Dropout draws
from the solver's generator in train steps and is off in eval.

``build_solver`` takes the JAX example's arguments (and ``device``);
:func:`make_solver` takes the shapes, widths and dropout besides, which
``chip_smoke.py`` uses for the reference pretrain width (12 -> 14 months
at 24 x 48, base 64, no global vectors, batch 8). The MoE variant
(``extformer_moe_enso.py``) builds on it too.

Run on the GPU: ``python -m paddlescience_torch.examples.earthformer_enso
[epochs]``.
"""

from __future__ import annotations

import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.cuboid_transformer import CuboidTransformer
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import RMSE
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import AdamW
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["IN_LEN", "OUT_LEN", "LAT", "LON", "make_solver", "build_solver"]

IN_LEN, OUT_LEN, LAT, LON = 6, 4, 16, 32


def make_solver(model_cls=CuboidTransformer, epochs: int = 3, iters_per_epoch: int = 3,
                output_dir: Optional[str] = "./output_earthformer_enso", batch_size: int = 4,
                learning_rate: float = 2e-3, device: DeviceLike = None, in_len: int = IN_LEN,
                out_len: int = OUT_LEN, lat: int = LAT, lon: int = LON, base_units: int = 32, drop: float = 0.1,
                **model_args) -> Solver:
    """The ENSO solver of a ``model_cls`` ("sst" -> "target") on windows
    of ``in_len`` -> ``out_len`` months over a ``lat`` x ``lon`` grid: the
    reference's axial patterns and its three dropout sites at ``drop``,
    ``model_args`` replacing or adding model arguments."""
    device = resolve_device(device)
    np.random.seed(0)
    random.seed(0)
    kw = dict(input_shape=(in_len, lat, lon, 1), target_shape=(out_len, lat, lon, 1), base_units=base_units,
              num_heads=4, enc_depth=(1, 1), dec_depth=(1, 1), cuboid_size=(2, 4, 4), self_pattern="axial",
              cross_self_pattern="axial", cross_pattern="cross_1x1", attn_drop=drop, proj_drop=drop, ffn_drop=drop)
    kw.update(model_args)
    model = model_cls(("sst",), ("target",), generator=torch.Generator().manual_seed(0), device=device, **kw)
    dl = {"dataset": {"name": "ENSODataset", "input_keys": ("sst",), "label_keys": ("target",), "in_len": in_len,
                      "out_len": out_len, "lat": lat, "lon": lon},
          "batch_size": batch_size, "sampler": {"shuffle": True, "drop_last": True}}
    expr = {"target": lambda out: out["target"]}
    sup = SupervisedConstraint(dl, MSELoss("mean"), expr, name="Sup")
    validator = SupervisedValidator(dict(dl, sampler={"shuffle": False, "drop_last": False}), MSELoss("mean"),
                                    metric={"RMSE": RMSE()}, name="enso_valid")
    lr = Cosine(epochs=epochs, iters_per_epoch=iters_per_epoch, learning_rate=learning_rate, warmup_epoch=1)()
    return Solver(model, {"Sup": sup}, output_dir, AdamW(lr, weight_decay=1e-5)(model), epochs=epochs,
                  iters_per_epoch=iters_per_epoch, validator={"enso_valid": validator}, eval_during_train=False,
                  log_freq=3, device=device)


def build_solver(epochs: int = 3, output_dir: Optional[str] = "./output_earthformer_enso", *,
                 device: DeviceLike = None) -> Solver:
    """The JAX example's solver."""
    return make_solver(epochs=epochs, output_dir=output_dir, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 3)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final RMSE = {solver.eval()[0]:.4e}")
