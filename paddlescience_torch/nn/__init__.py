from paddlescience_torch.nn.layers import Conv, Embedding, LayerNorm, Linear
from paddlescience_torch.nn.resize import resize
from paddlescience_torch.nn.segment import Segments, gather, segment_sum, segments

__all__ = ["Linear", "Conv", "LayerNorm", "Embedding", "resize", "Segments", "segments", "segment_sum", "gather"]
