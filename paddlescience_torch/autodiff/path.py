"""Derivative-path selection flags (counterpart of
``paddlescience_tpu/autodiff/path.py``).

The candidate bundles keep the JAX package's names, so a configuration
pins the same path in both packages, and hold only the flags the port
reads:

* ``PSCI_JET``                  - "0": no jet forward, every derivative
  by nested jvp (``autodiff/ad.py``);
* ``PSCI_JET_PALLAS``           - "0": no fused segments at all. Otherwise
  (the default) ModifiedMLP and PirateNet run their hidden layers as fused
  segments, as in the JAX package;
* ``PSCI_JET_PALLAS_MLP``       - "1": the plain MLP's hidden layers do so
  too (default "0", as in the JAX package);
* ``PSCI_JET_PALLAS_MIN_LANES`` - narrowest layer sent to the segments;
* ``PSCI_JET_SEG``              - MLP/ModifiedMLP layers per segment;
* ``PSCI_JET_PBLOCK_GROUP``     - PirateNet blocks per segment (default 3);
* ``PSCI_JET_SAVE_BOUNDS``      - "1": the forward saves stage boundaries.

The JAX package's TPU tiling flags (``PSCI_JET_BLOCK_M``,
``PSCI_JET_PALLAS_MATMUL``) have no counterpart. The candidates:

* ``jet``              - fused Taylor-jet forward in plain PyTorch
  (``autodiff/jet.py``);
* ``jet_pallas``       - hidden layers run as hand-written CUDA jet-segment
  kernels (``ops/jet_mlp.py``, ``ops/jet_gated.py``) in segments of
  ``PSCI_JET_SEG`` layers (default 3) or ``PSCI_JET_PBLOCK_GROUP`` blocks;
* ``jet_pallas_full``  - the whole hidden stack as one segment;
* ``jet_pallas_full_sb`` - as above, with the forward kernel saving the
  stage boundaries so the backward skips its recompute pass.

* ``jvp``              - no jet: every derivative component by nested
  forward-mode derivatives of the models' plain batched forward.

``solver/autotune.py`` times them on a solver and pins the fastest with
:func:`set_default` (the kernel candidates on CUDA only).

Flags resolve as: context override > process default > environment >
built-in default. :func:`override` sets only the flags of the bundle it is
given; the rest fall through to the process default, so pin a whole
candidate with :func:`set_default`.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Dict, Optional

__all__ = ["flag", "override", "set_default", "get_default", "CANDIDATES"]

CANDIDATES: Dict[str, Dict[str, str]] = {
    "jvp": {"PSCI_JET": "0"},
    "jet": {"PSCI_JET": "1", "PSCI_JET_PALLAS": "0", "PSCI_JET_PALLAS_MLP": "0"},
    "jet_pallas": {
        "PSCI_JET": "1",
        "PSCI_JET_PALLAS": "1",
        "PSCI_JET_PALLAS_MLP": "1",
        "PSCI_JET_PALLAS_MIN_LANES": "0",
    },
    "jet_pallas_full": {
        "PSCI_JET": "1",
        "PSCI_JET_PALLAS": "1",
        "PSCI_JET_PALLAS_MLP": "1",
        "PSCI_JET_PALLAS_MIN_LANES": "0",
        "PSCI_JET_PBLOCK_GROUP": "999",
        "PSCI_JET_SEG": "999",
    },
    "jet_pallas_full_sb": {
        "PSCI_JET": "1",
        "PSCI_JET_PALLAS": "1",
        "PSCI_JET_PALLAS_MLP": "1",
        "PSCI_JET_PALLAS_MIN_LANES": "0",
        "PSCI_JET_PBLOCK_GROUP": "999",
        "PSCI_JET_SEG": "999",
        "PSCI_JET_SAVE_BOUNDS": "1",
    },
}

_OVERRIDE: contextvars.ContextVar[Optional[Dict[str, str]]] = contextvars.ContextVar(
    "psci_torch_deriv_path_override", default=None
)
_DEFAULT: Dict[str, str] = {}


def flag(name: str, default: str) -> str:
    """Resolve a derivative-path flag: context override > process default >
    environment > built-in default."""
    ov = _OVERRIDE.get()
    if ov is not None and name in ov:
        return ov[name]
    if name in _DEFAULT:
        return _DEFAULT[name]
    return os.environ.get(name, default)


@contextlib.contextmanager
def override(flags: Dict[str, str]):
    """Force flags for everything run inside the context."""
    token = _OVERRIDE.set(dict(flags))
    try:
        yield
    finally:
        _OVERRIDE.reset(token)


def set_default(flags: Optional[Dict[str, str]]) -> None:
    """Install a candidate as the process-wide default (below any active
    :func:`override`, above the environment)."""
    _DEFAULT.clear()
    if flags:
        _DEFAULT.update(flags)


def get_default() -> Dict[str, str]:
    return dict(_DEFAULT)
