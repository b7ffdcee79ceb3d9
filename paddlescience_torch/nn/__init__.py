from paddlescience_torch.nn.layers import Conv, LayerNorm, Linear
from paddlescience_torch.nn.resize import resize

__all__ = ["Linear", "Conv", "LayerNorm", "resize"]
