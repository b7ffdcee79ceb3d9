from paddlescience_torch.data.dataset.array_dataset import (ContinuousNamedArrayDataset, DeviceSampledDataset,
                                                            IterableNamedArrayDataset, NamedArrayDataset)
from paddlescience_torch.data.dataset.domain_dataset import (CGCNNDataset, ChipHeatDataset, CylinderDataset, DGMRDataset,
                                                             ENSODataset, ERA5SampledDataset, ExtMoEENSODataset,
                                                             FWIDataset, GridMeshAtmosphericDataset, LorenzDataset,
                                                             MeshAirfoilDataset, MeshCylinderDataset, MOlFLOWDataset,
                                                             MRMSDataset, MRMSSampledDataset, PEMSDataset,
                                                             RadarDataset, RosslerDataset, SEVIRDataset,
                                                             SphericalSWEDataset)
from paddlescience_torch.data.dataset.science_dataset import ERA5Dataset

__all__ = ["ContinuousNamedArrayDataset", "DeviceSampledDataset", "IterableNamedArrayDataset", "NamedArrayDataset",
           "ERA5Dataset", "ERA5SampledDataset", "FWIDataset", "SphericalSWEDataset", "ENSODataset",
           "ExtMoEENSODataset", "SEVIRDataset", "LorenzDataset", "RosslerDataset", "CylinderDataset", "PEMSDataset",
           "MeshAirfoilDataset", "MeshCylinderDataset", "GridMeshAtmosphericDataset", "CGCNNDataset", "ChipHeatDataset",
           "DGMRDataset", "RadarDataset", "MRMSDataset", "MRMSSampledDataset", "MOlFLOWDataset"]
