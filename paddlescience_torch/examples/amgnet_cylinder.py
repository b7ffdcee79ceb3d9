"""AMGNet flow-field prediction on cylinder meshes, on the port
(counterpart of ``examples/amgnet_cylinder.py``; reference
``examples/amgnet/amgnet_cylinder.py``): ``amgnet_airfoil`` with
``case="cylinder"`` (``MeshCylinderDataset``, 4 node features).

Run on the GPU: ``python -m paddlescience_torch.examples.amgnet_cylinder
[steps]``.
"""

from __future__ import annotations

import sys

from paddlescience_torch.device import DeviceLike
from paddlescience_torch.examples import amgnet_airfoil
from paddlescience_torch.examples.graph_fit import GraphFit

__all__ = ["build", "main"]


def build(*, device: DeviceLike = None, **kwargs) -> GraphFit:
    return amgnet_airfoil.build("cylinder", device=device, **kwargs)


def main(steps: int = 40, *, device: DeviceLike = None) -> float:
    return amgnet_airfoil.main(steps, case="cylinder", device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 40)
