"""ExtFormer-MoE on ENSO sea-surface temperature, on the port
(counterpart of ``examples/extformer_moe_enso.py``).

``ExtFormerMoECuboid``: the Earthformer ENSO example's model
(``earthformer_enso.py``, whose solver this builds on) with every FFN a
noisy top-k mixture of experts (``default_moe_config`` with
``num_experts`` experts, top-4: "cuboid-latent" gates, dense dispatch, aux
weights 0, so ``aux_loss`` is an output the loss does not read). The
gates' noise and the dropout draw from the solver's generator in train
steps; eval routes deterministically.

Run on the GPU: ``python -m paddlescience_torch.examples.extformer_moe_enso
[epochs]``.
"""

from __future__ import annotations

import sys
from typing import Optional

from paddlescience_torch.arch.cuboid_transformer import ExtFormerMoECuboid
from paddlescience_torch.device import DeviceLike
from paddlescience_torch.examples.earthformer_enso import make_solver
from paddlescience_torch.solver.solver import Solver

__all__ = ["build_solver", "make_solver"]


def build_solver(epochs: int = 3, iters_per_epoch: int = 3, output_dir: Optional[str] = "./outputs_extformer_moe",
                 base_units: int = 32, num_experts: int = 4, learning_rate: float = 2e-3, *,
                 device: DeviceLike = None) -> Solver:
    """The JAX example's solver."""
    return make_solver(ExtFormerMoECuboid, epochs=epochs, iters_per_epoch=iters_per_epoch, output_dir=output_dir,
                       learning_rate=learning_rate, device=device, base_units=base_units, num_experts=num_experts)


if __name__ == "__main__":
    argv = sys.argv[1:]
    solver = build_solver(epochs=int(argv[0]) if argv else 3)
    solver.train(num_fused_steps=solver.iters_per_epoch)
    print(f"final RMSE = {solver.eval()[0]:.4e}")
