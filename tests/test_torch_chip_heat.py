"""The port's chip_heat example against paddlescience_tpu on the CPU:
every constraint's ``ChipHeatDataset`` holding the JAX example's arrays
bitwise (the Gaussian random fields, the points, the cartesian-product
factors), then three train steps of the JAX solver's compiled step
(``_earthformer_parity.py``; shuffle off on both sides) and of the port's
from the same parameters, through the nested-jvp Hessians and the
boundary-type switch: losses within 1e-4, the parameters after them
within 1e-4 of the largest magnitude (``_misc_parity.py``). The grid, the
number of fields and the widths are cut (``CHIP_CUT``). The JAX networks
are built from numpy draws."""

import os
import sys

import numpy as np

from _earthformer_parity import numpy_init, one_torch_thread  # noqa: F401
from _misc_parity import solver_steps
from _operator_parity import highest_precision  # noqa: F401
from paddlescience_torch.examples import chip_heat as tchip

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import chip_heat as jchip  # noqa: E402  (the JAX example)


CHIP_CUT = dict(nl=6, nw=6, nu=4, nbc=4, batch_size=32, num_features=8, branch_layers=2, trunk_layers=2,
                branch_hidden=16, trunk_hidden=16)  # the example's 20 x 20 grid, 500 + 500 fields and widths cut


def test_chip_heat_data_and_three_steps_match_jax(tmp_path):
    with numpy_init():
        js = jchip.build_solver(epochs=1, output_dir=str(tmp_path), **CHIP_CUT)
    ts = tchip.build_solver(epochs=1, output_dir=None, device="cpu", **CHIP_CUT)
    for name, jc in js.constraint.items():
        jd, td = jc.dataset, ts.constraint[name].dataset
        assert type(td).__name__ == "ChipHeatDataset" and len(td) == len(jd)
        for k in jd.input:
            assert np.array_equal(jd.input[k], td.input[k]), (name, k)
    solver_steps(js, ts)
