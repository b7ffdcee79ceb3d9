from paddlescience_torch.data.dataset.array_dataset import DeviceSampledDataset, IterableNamedArrayDataset

__all__ = ["DeviceSampledDataset", "IterableNamedArrayDataset"]
