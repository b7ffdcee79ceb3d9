from paddlescience_torch.data.process.transform import (Compose, CropData, FunctionalTransform, Log1p, Normalize,
                                                         Scale, SqueezeData, Translate, build_transforms)

__all__ = ["Compose", "Translate", "Scale", "Normalize", "Log1p", "CropData", "SqueezeData", "FunctionalTransform",
           "build_transforms"]
