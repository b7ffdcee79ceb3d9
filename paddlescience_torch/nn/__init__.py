from paddlescience_torch.nn.layers import Linear

__all__ = ["Linear"]
