"""Sample transforms (counterpart of
``paddlescience_tpu/data/process/transform.py``; reference
``ppsci/data/process/transform/preprocess.py:25-287``).

Each transform is ``t(input, label, weight) -> (input, label, weight)``
over numpy dicts on the host; ``Compose`` chains them (a dataset's
``transforms``), and :func:`build_transforms` compiles a config list of
``{"name": ..., **kwargs}`` into a ``Compose``. The arithmetic is the JAX
package's, numpy for numpy, so the batches are bitwise the same."""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "Compose",
    "Translate",
    "Scale",
    "Normalize",
    "Log1p",
    "CropData",
    "SqueezeData",
    "FunctionalTransform",
    "build_transforms",
]


class Compose:
    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, input, label, weight):
        for t in self.transforms:
            input, label, weight = t(input, label, weight)
        return input, label, weight


class Translate:
    """input[key] += offset[key]."""

    def __init__(self, offset: Dict[str, float]):
        self.offset = offset

    def __call__(self, input, label, weight):
        input = dict(input)
        for k, v in self.offset.items():
            if k in input:
                input[k] = input[k] + v
        return input, label, weight


class Scale:
    """input[key] *= scale[key]."""

    def __init__(self, scale: Dict[str, float]):
        self.scale = scale

    def __call__(self, input, label, weight):
        input = dict(input)
        for k, v in self.scale.items():
            if k in input:
                input[k] = input[k] * v
        return input, label, weight


class Normalize:
    """(x - mean) / std on selected keys (both input and label if present)."""

    def __init__(self, mean: Union[np.ndarray, float], std: Union[np.ndarray, float], apply_keys: Tuple[str, ...] = ("input", "label")):
        self.mean = mean
        self.std = std
        self.apply_keys = apply_keys

    def __call__(self, input, label, weight):
        if "input" in self.apply_keys:
            input = {k: (v - self.mean) / self.std for k, v in input.items()}
        if "label" in self.apply_keys:
            label = {k: (v - self.mean) / self.std for k, v in label.items()}
        return input, label, weight


class Log1p:
    def __init__(self, scale: float = 1.0, apply_keys: Tuple[str, ...] = ("input", "label")):
        self.scale = scale
        self.apply_keys = apply_keys

    def __call__(self, input, label, weight):
        if "input" in self.apply_keys:
            input = {k: np.log1p(v / self.scale) for k, v in input.items()}
        if "label" in self.apply_keys:
            label = {k: np.log1p(v / self.scale) for k, v in label.items()}
        return input, label, weight


class CropData:
    """Crop spatial dims to [xmin, xmax) on (C, H, W)-style arrays."""

    def __init__(self, xmin: Tuple[int, ...], xmax: Tuple[int, ...], apply_keys: Tuple[str, ...] = ("input", "label")):
        self.xmin = xmin
        self.xmax = xmax
        self.apply_keys = apply_keys

    def _crop(self, v):
        return v[..., self.xmin[0] : self.xmax[0], self.xmin[1] : self.xmax[1]]

    def __call__(self, input, label, weight):
        if "input" in self.apply_keys:
            input = {k: self._crop(v) for k, v in input.items()}
        if "label" in self.apply_keys:
            label = {k: self._crop(v) for k, v in label.items()}
        return input, label, weight


class SqueezeData:
    """Merge (B, T, C, H, W) -> (B*T, C, H, W) (reference preprocess.py)."""

    def __init__(self, apply_keys: Tuple[str, ...] = ("input", "label")):
        self.apply_keys = apply_keys

    def _squeeze(self, v):
        if v.ndim == 5:
            return v.reshape(-1, *v.shape[2:])
        return v

    def __call__(self, input, label, weight):
        if "input" in self.apply_keys:
            input = {k: self._squeeze(v) for k, v in input.items()}
        if "label" in self.apply_keys:
            label = {k: self._squeeze(v) for k, v in label.items()}
        return input, label, weight


class FunctionalTransform:
    def __init__(self, transform_func: Callable):
        self.transform_func = transform_func

    def __call__(self, input, label, weight):
        return self.transform_func(input, label, weight)


_REGISTRY = {
    "Translate": Translate,
    "Scale": Scale,
    "Normalize": Normalize,
    "Log1p": Log1p,
    "CropData": CropData,
    "SqueezeData": SqueezeData,
    "FunctionalTransform": FunctionalTransform,
}


def build_transforms(cfg) -> Compose:
    import copy

    transforms = []
    for item in cfg or []:
        item = copy.deepcopy(dict(item))
        name = item.pop("name")
        if name not in _REGISTRY:
            raise ValueError(f"unknown transform '{name}'")
        transforms.append(_REGISTRY[name](**item))
    return Compose(transforms)
