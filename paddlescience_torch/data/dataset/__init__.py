from paddlescience_torch.data.dataset.array_dataset import (ContinuousNamedArrayDataset, DeviceSampledDataset,
                                                            IterableNamedArrayDataset, NamedArrayDataset)
from paddlescience_torch.data.dataset.domain_dataset import (CylinderDataset, ENSODataset, ERA5SampledDataset,
                                                             ExtMoEENSODataset, FWIDataset, LorenzDataset,
                                                             RosslerDataset, SEVIRDataset, SphericalSWEDataset)
from paddlescience_torch.data.dataset.science_dataset import ERA5Dataset

__all__ = ["ContinuousNamedArrayDataset", "DeviceSampledDataset", "IterableNamedArrayDataset", "NamedArrayDataset",
           "ERA5Dataset", "ERA5SampledDataset", "FWIDataset", "SphericalSWEDataset", "ENSODataset",
           "ExtMoEENSODataset", "SEVIRDataset", "LorenzDataset", "RosslerDataset", "CylinderDataset"]
