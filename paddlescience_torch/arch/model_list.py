"""ModelList (counterpart of ``paddlescience_tpu/arch/model_list.py``):
several networks run side by side on one input dict.

The children sit in ``model_list`` (an ``nn.ModuleList``), so their
parameters are named ``model_list.0.linears.0.weight``, ..., the dotted
form of the JAX package's ``params["model_list"]["0"]`` tree. The
``Solver`` takes the children as its models: each gets its own derivative
stack and its own jet requests. A child frozen with ``Arch.freeze`` stays
out of the optimizer. Each child keeps its own input and output
transforms (bubble transforms one child of three; deephpms's PDE net maps
(t, x) onto derivative features by its input transform).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from paddlescience_torch.arch import base

__all__ = ["ModelList"]


class ModelList(base.Arch):
    """Holds ``model_list`` in order; its input and output keys are the
    union of the children's, first occurrence first; ``forward`` runs each
    child on its own input keys (a child with an input transform whose
    keys are not all given gets every given input, as the expression layer
    feeds it) and merges the output dicts."""

    def __init__(self, model_list: Sequence[base.Arch]):
        super().__init__()
        self.model_list = nn.ModuleList(model_list)
        self.input_keys = tuple(dict.fromkeys(k for m in model_list for k in m.input_keys))
        self.output_keys = tuple(dict.fromkeys(k for m in model_list for k in m.output_keys))

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        y_all: Dict[str, torch.Tensor] = {}
        for model in self.model_list:
            keys = model.input_keys
            if getattr(model, "_input_transform", None) is not None and not all(k in x for k in keys):
                keys = tuple(x)
            y_all.update(model({k: x[k] for k in keys}))
        return y_all
