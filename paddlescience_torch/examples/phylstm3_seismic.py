"""DeepPhyLSTM-3 on the port (counterpart of
``examples/phylstm3_seismic.py``): ``phylstm_seismic`` with model type 3,
the hysteresis-rate LSTM and its consistency term.

Run on the GPU: ``python -m paddlescience_torch.examples.phylstm3_seismic
[steps]``.
"""

from __future__ import annotations

import sys
from paddlescience_torch.device import DeviceLike
from paddlescience_torch.examples import phylstm_seismic

__all__ = ["main"]


def main(steps: int = 80, *, device: DeviceLike = None) -> float:
    return phylstm_seismic.main(steps, model_type=3, device=device)


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 80)
