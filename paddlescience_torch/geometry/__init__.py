"""Geometry (counterpart of ``paddlescience_tpu/geometry``): host-side
numpy sampling, as in the JAX package. Ported: the ``Geometry`` base,
``sampler.sample`` and the STL ``Mesh``."""

from paddlescience_torch.geometry.geometry import Geometry
from paddlescience_torch.geometry.mesh import Mesh, load_stl

__all__ = ["Geometry", "Mesh", "load_stl"]
