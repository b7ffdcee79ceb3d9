"""Earthformer on SEVIR radar nowcasting, on the port (counterpart of
``examples/earthformer_sevir.py``).

``CuboidTransformer`` maps 8 VIL frames at 32 x 32 to the next 6 (base
32, 4 heads, two levels of one block each, 4 global vectors, axial /
axial / cross_1x1, dropout 0.1); ``SEVIRDataset`` reads the SEVIR layout
under ``data_dir`` or synthesises 6 advecting rain-cell events (one window
each), batches of ``batch_size`` (shuffled, the short last dropped), 3
steps an epoch; MSE; AdamW (weight decay 1e-5) on a cosine schedule with
one warmup epoch. Eval reports the RMSE and the SEVIR skill scores
(:func:`sevir_skill_scores`).

Run on the GPU: ``python -m paddlescience_torch.examples.earthformer_sevir
[epochs]``.
"""

from __future__ import annotations

import math
import random
import sys
from typing import Optional

import numpy as np
import torch

from paddlescience_torch.arch.cuboid_transformer import CuboidTransformer
from paddlescience_torch.constraint.constraints import SupervisedConstraint
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.metric import RMSE, FunctionalMetric
from paddlescience_torch.optimizer.lr_scheduler import Cosine
from paddlescience_torch.optimizer.optimizer import AdamW
from paddlescience_torch.solver.solver import Solver
from paddlescience_torch.validate import SupervisedValidator

__all__ = ["IN_LEN", "OUT_LEN", "H", "W", "THRESHOLDS", "sevir_skill_scores", "make_solver", "build_solver"]

IN_LEN, OUT_LEN, H, W = 8, 6, 32, 32
THRESHOLDS = (16, 74, 133, 160, 181, 219)  # VIL thresholds in raw 0-255 units
_VIL_SCALE, _VIL_OFFSET = 1 / 47.54, -33.44  # the dataset's preprocess x -> scale * (x + offset)


def sevir_skill_scores(output_dict, label_dict):
    """CSI, POD, SUCR and BIAS per threshold and their averages over the
    thresholds: hits, misses and false alarms summed over every pixel of
    the frames mapped back to raw VIL units. ``bias`` is the JAX
    example's formula, ((hits + fas) / (hits + misses + eps) / log 2)^2."""
    pred = output_dict["vil"] / _VIL_SCALE - _VIL_OFFSET
    target = label_dict["vil"] / _VIL_SCALE - _VIL_OFFSET
    thr = torch.tensor(THRESHOLDS, dtype=pred.dtype, device=pred.device).reshape(-1, *([1] * pred.ndim))
    t = (target[None] >= thr).to(pred.dtype)
    p = (pred[None] >= thr).to(pred.dtype)
    axes = tuple(range(1, t.ndim))
    hits = torch.sum(t * p, axes)
    misses = torch.sum(t * (1 - p), axes)
    fas = torch.sum((1 - t) * p, axes)
    eps = 1e-4
    scores = {"csi": hits / (hits + misses + fas + eps), "pod": hits / (hits + misses + eps),
              "sucr": hits / (hits + fas + eps),
              "bias": ((hits + fas) / (hits + misses + eps) / np.float32(math.log(2.0))) ** 2}
    out = {}
    for name, s in scores.items():
        for i, th in enumerate(THRESHOLDS):
            out[f"{name}_{th}"] = s[i]
        out[f"{name}_avg"] = torch.mean(s)
    return out


def make_solver(epochs: int = 3, output_dir: Optional[str] = "./output_earthformer_sevir",
                data_dir: Optional[str] = None, batch_size: int = 2, lr: float = 1e-3,
                device: DeviceLike = None, in_len: int = IN_LEN, out_len: int = OUT_LEN,
                height: int = H, width: int = W, drop: float = 0.1, **model_args) -> Solver:
    """The SEVIR solver; ``model_args`` replace or add cuboid-transformer
    arguments."""
    device = resolve_device(device)
    np.random.seed(0)
    random.seed(0)
    kw = dict(input_shape=(in_len, height, width, 1), target_shape=(out_len, height, width, 1), base_units=32,
              num_heads=4, enc_depth=(1, 1), dec_depth=(1, 1), cuboid_size=(2, 4, 4), self_pattern="axial",
              cross_self_pattern="axial", cross_pattern="cross_1x1", attn_drop=drop, proj_drop=drop, ffn_drop=drop)
    kw.update(model_args)
    model = CuboidTransformer(("vil",), ("vil_out",), generator=torch.Generator().manual_seed(0), device=device,
                              **kw)
    dl = {"dataset": {"name": "SEVIRDataset", "input_keys": ("vil",), "label_keys": ("vil",), "data_dir": data_dir,
                      "data_types": ("vil",), "in_len": in_len, "out_len": out_len, "img_height": height,
                      "img_width": width, "num_events": 6, "synthetic": data_dir is None},
          "batch_size": batch_size, "sampler": {"shuffle": True, "drop_last": True}}
    expr = {"vil": lambda out: out["vil_out"]}
    sup = SupervisedConstraint(dl, MSELoss("mean"), expr, name="Sup")
    validator = SupervisedValidator(dict(dl, sampler={"shuffle": False, "drop_last": False}), MSELoss("mean"), expr,
                                    metric={"rmse": RMSE(), "skill": FunctionalMetric(sevir_skill_scores)},
                                    name="sevir_valid")
    sched = Cosine(epochs=epochs, iters_per_epoch=3, learning_rate=lr, warmup_epoch=1)()
    return Solver(model, {"Sup": sup}, output_dir, AdamW(sched, weight_decay=1e-5)(model), epochs=epochs,
                  iters_per_epoch=3, validator={"sevir_valid": validator}, eval_during_train=False, log_freq=3,
                  device=device)


def build_solver(epochs: int = 3, output_dir: Optional[str] = "./output_earthformer_sevir",
                 data_dir: Optional[str] = None, batch_size: int = 2, lr: float = 1e-3, *,
                 device: DeviceLike = None) -> Solver:
    """The JAX example's solver."""
    return make_solver(epochs=epochs, output_dir=output_dir, data_dir=data_dir, batch_size=batch_size, lr=lr,
                       device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 3)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final RMSE = {solver.eval()[0]:.4e}")
