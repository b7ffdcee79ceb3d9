"""DeepPhyLSTM, the physics-informed LSTM for structural seismic response
(counterpart of ``paddlescience_tpu/arch/phylstm.py``), model types 2
and 3.

Each stack is three LSTMs with ReLU (``nn/recurrent.py``), an extra
Linear for type 2, and a Linear head. The differentiation matrix ``phi``
(1, T, T) multiplies each (B, T, k) prediction, broadcast over the batch.
Parameter names follow the JAX module (``lstm_model.l1.w``,
``lstm_model_f.extra.weight``, ``lstm_model_g.head.bias``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from paddlescience_torch.arch import base
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.nn.layers import Linear
from paddlescience_torch.nn.recurrent import LSTM

__all__ = ["DeepPhyLSTM"]


class _LSTMStack(nn.Module):
    """3 x (LSTM + ReLU), an optional Linear, then the Linear head."""

    def __init__(self, in_size, hidden_size, out_size, extra_linear: bool, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.l1 = LSTM(in_size, hidden_size, generator=g)
        self.l2 = LSTM(hidden_size, hidden_size, generator=g)
        self.l3 = LSTM(hidden_size, hidden_size, generator=g)
        self.extra = Linear(hidden_size, hidden_size, generator=g) if extra_linear else None
        self.head = Linear(hidden_size, out_size, generator=g)

    def forward(self, x):
        h = F.relu(self.l3(F.relu(self.l2(F.relu(self.l1(x))))))
        if self.extra is not None:
            h = self.extra(h)
        return self.head(h)


class DeepPhyLSTM(base.Arch):
    """Inputs ``ag``, ``ag_c`` (B, T, 1) ground accelerations and ``phi``
    (1, T, T); outputs as the JAX module's ``_forward_type_2`` /
    ``_forward_type_3``."""

    def __init__(self, input_size: int, output_size: int, hidden_size: int = 100, model_type: int = 2, *,
                 generator: Optional[torch.Generator] = None, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.input_size = input_size
        self.output_size = output_size
        self.model_type = model_type
        self.input_keys = ("ag", "ag_c", "phi")
        n = output_size
        if model_type == 2:
            self.lstm_model = _LSTMStack(input_size, hidden_size, 3 * n, True, generator=g)
            self.lstm_model_f = _LSTMStack(3 * n, hidden_size, n, True, generator=g)
            self.output_keys = ("eta_pred", "eta_dot_pred", "g_pred", "eta_t_pred_c", "eta_dot_pred_c",
                                "lift_pred_c")
        elif model_type == 3:
            self.lstm_model = _LSTMStack(1, hidden_size, 3 * n, False, generator=g)
            self.lstm_model_f = _LSTMStack(3 * n, hidden_size, n, False, generator=g)
            self.lstm_model_g = _LSTMStack(2 * n, hidden_size, n, False, generator=g)
            self.output_keys = ("eta_pred", "eta_dot_pred", "g_pred", "eta_t_pred_c", "eta_dot_pred_c",
                                "lift_pred_c", "g_t_pred_c")
        else:
            raise ValueError(f"model_type should be 2 or 3, but got {model_type}")
        self.to(device)

    def _split(self, output):
        n = self.output_size
        return output[:, :, :n], output[:, :, n: 2 * n], output[:, :, 2 * n:]

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        phi = x["phi"]
        eta_pred, eta_dot_pred, g_pred = self._split(self.lstm_model(x["ag"]))
        eta_pred_c, eta_dot_pred_c, g_pred_c = self._split(self.lstm_model(x["ag_c"]))
        eta_t_pred_c = torch.matmul(phi, eta_pred_c)
        eta_tt_pred_c = torch.matmul(phi, eta_dot_pred_c)
        f = self.lstm_model_f(torch.cat([eta_pred_c, eta_dot_pred_c[:, :, 0:1], g_pred_c], dim=2))
        out = {"eta_pred": eta_pred, "eta_dot_pred": eta_dot_pred, "g_pred": g_pred, "eta_t_pred_c": eta_t_pred_c,
               "eta_dot_pred_c": eta_dot_pred_c, "lift_pred_c": eta_tt_pred_c + f}
        if self.model_type == 3:
            g_dot_pred_c = self.lstm_model_g(torch.cat([eta_dot_pred_c, eta_pred_c], dim=2))
            out["g_t_pred_c"] = torch.matmul(phi, g_pred_c) - g_dot_pred_c
        return out
