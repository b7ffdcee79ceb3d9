from paddlescience_torch.data.dataset import DeviceSampledDataset, IterableNamedArrayDataset

__all__ = ["DeviceSampledDataset", "IterableNamedArrayDataset"]
