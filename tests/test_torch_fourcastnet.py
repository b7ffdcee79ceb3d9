"""The port's fourcastnet and fourcastnet_finetune examples against the
JAX examples on the CPU: three train steps (shuffle off in both) and the
eval's RMSE and ACC, the finetune stage through its own entry point.

JAX runs at "highest" matmul precision (``_operator_parity.py``); the
steps' losses within 1e-4 relative, the metrics 1e-4 (ACC, a correlation
near 0 here, 1e-4 of its range).
"""

import os
import sys

import numpy as np
import pytest

from _operator_parity import highest_precision, three_steps  # noqa: F401
from paddlescience_torch.examples import fourcastnet as tfcn
from paddlescience_torch.examples import fourcastnet_finetune as tfcn_ft

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import fourcastnet as jfcn  # noqa: E402  (the JAX example)


@pytest.mark.parametrize("steps", [1, 2], ids=["pretrain", "finetune"])
def test_fourcastnet_three_train_steps_match_jax(tmp_path, steps):
    """The example (the finetune stage through its own entry point): three
    steps, shuffle off in both, then the eval (RMSE, ACC)."""
    pytest.importorskip("h5py")  # the JAX example writes its fields to an HDF5 file
    js = jfcn.build_solver(epochs=2, output_dir=str(tmp_path / "jax"), data_path=str(tmp_path / "era5.h5"),
                           num_timestamps=steps)
    build = tfcn.build_solver if steps == 1 else tfcn_ft.build_solver
    ts = build(epochs=2, output_dir=str(tmp_path / "port"), shuffle=False, device="cpu")
    three_steps(js, ts)
    j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-4)
    for k, v in j_group["era5_valid"].items():  # ACC, a correlation in [-1, 1], near 0 here: 1e-4 of its range
        np.testing.assert_allclose(t_group["era5_valid"][k], float(v), rtol=1e-4, atol=1e-4 if "ACC" in k else 0,
                                   err_msg=k)
