from paddlescience_torch.nn.layers import Conv, LayerNorm, Linear
from paddlescience_torch.nn.resize import resize
from paddlescience_torch.nn.segment import Segments, gather, segment_sum, segments

__all__ = ["Linear", "Conv", "LayerNorm", "resize", "Segments", "segments", "segment_sum", "gather"]
