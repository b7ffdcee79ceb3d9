from paddlescience_torch.data.dataset.array_dataset import (DeviceSampledDataset, IterableNamedArrayDataset,
                                                            NamedArrayDataset)

__all__ = ["DeviceSampledDataset", "IterableNamedArrayDataset", "NamedArrayDataset"]
