"""paddlescience_torch — the PyTorch/CUDA port of paddlescience_tpu.

Same ppsci-style surface (arch, autodiff, equation, geometry, constraint,
data, loss, metric, optimizer, solver, validate, visualize), written in PyTorch for one NVIDIA H100. Each Pallas
kernel of the JAX package on a ported path has a hand-written CUDA kernel
here (``csrc/``), built with nvcc at first use, plus a plain PyTorch
version that the CPU runs. Entry points run on CUDA unless given a device.

Float32 matrix products run in true float32: importing the package turns
TF32 off for matmuls and cuDNN, which is the precision the JAX package
calls "highest".
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from paddlescience_torch import (arch, autodiff, constraint, data, equation, geometry, loss, metric,  # noqa: E402
                                 optimizer, solver, utils, validate, visualize)
from paddlescience_torch.device import resolve_device  # noqa: E402

__all__ = ["arch", "autodiff", "constraint", "data", "equation", "geometry", "loss", "metric", "optimizer",
           "solver", "utils", "validate", "visualize", "resolve_device"]
__version__ = "0.1.0"
