"""Ghia, Ghia & Shin (1982) lid-driven-cavity benchmark profiles (a numpy
copy of ``paddlescience_tpu/utils/ghia.py``: the same tables and the same
``profile_rmse``).

"High-Re solutions for incompressible flow using the Navier-Stokes
equations and a multigrid method", J. Comput. Phys. 48, 387-411: Table I
(u-velocity along the vertical line through the cavity center) and Table
II (v-velocity along the horizontal line), 129x129 multigrid solution.
The LDC curriculum recipes (``examples/ldc_curriculum.py``) print a
profile RMSE against these points after each stage, so one LDC accuracy
number does not depend on the generated reference fields
(``data/dataset/ldc_reference.py``).

Only Re=100 and Re=1000 are embedded, as in the JAX package.

Caveat for comparisons: Ghia's cavity has a uniform lid (u=1 on the whole
moving wall); the recipes train with the regularized lid profile
``1 - cosh(50(x-1/2))/cosh(25)``. The profiles differ mainly near the lid,
so :func:`profile_rmse` excludes points with coordinate > ``clip``
(default 0.95) from the u-profile.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

__all__ = ["GHIA_TABLES", "profiles", "profile_rmse"]

_Y = np.array([
    0.0000, 0.0547, 0.0625, 0.0703, 0.1016, 0.1719, 0.2813, 0.4531, 0.5000,
    0.6172, 0.7344, 0.8516, 0.9531, 0.9609, 0.9688, 0.9766, 1.0000,
])
_X = np.array([
    0.0000, 0.0625, 0.0703, 0.0781, 0.0938, 0.1563, 0.2266, 0.2344, 0.5000,
    0.8047, 0.8594, 0.9063, 0.9453, 0.9531, 0.9609, 0.9688, 1.0000,
])

GHIA_TABLES: Dict[int, Dict[str, np.ndarray]] = {
    100: {
        "y": _Y,
        "u": np.array([
            0.00000, -0.03717, -0.04192, -0.04775, -0.06434, -0.10150,
            -0.15662, -0.21090, -0.20581, -0.13641, 0.00332, 0.23151,
            0.68717, 0.73722, 0.78871, 0.84123, 1.00000,
        ]),
        "x": _X,
        "v": np.array([
            0.00000, 0.09233, 0.10091, 0.10890, 0.12317, 0.16077, 0.17507,
            0.17527, 0.05454, -0.24533, -0.22445, -0.16914, -0.10313,
            -0.08864, -0.07391, -0.05906, 0.00000,
        ]),
    },
    1000: {
        "y": _Y,
        "u": np.array([
            0.00000, -0.18109, -0.20196, -0.22220, -0.29730, -0.38289,
            -0.27805, -0.10648, -0.06080, 0.05702, 0.18719, 0.33304,
            0.46604, 0.51117, 0.57492, 0.65928, 1.00000,
        ]),
        "x": _X,
        "v": np.array([
            0.00000, 0.27485, 0.29012, 0.30353, 0.32627, 0.37095, 0.33075,
            0.32235, 0.02526, -0.31966, -0.42665, -0.51550, -0.39188,
            -0.33714, -0.27669, -0.21388, 0.00000,
        ]),
    },
}


def profiles(Re: int) -> Dict[str, np.ndarray]:
    """Centerline benchmark profiles for a supported Reynolds number."""
    if int(Re) not in GHIA_TABLES:
        raise KeyError(f"Ghia tables embedded only for Re in {sorted(GHIA_TABLES)}, got {Re}")
    return GHIA_TABLES[int(Re)]


def profile_rmse(
    uv_fn: Callable[[np.ndarray, np.ndarray], Dict[str, np.ndarray]],
    Re: int,
    clip: float = 0.95,
) -> Dict[str, float]:
    """RMSE of a solution against the Ghia centerline tables.

    ``uv_fn(x, y) -> {"u": ..., "v": ...}`` evaluates the velocity field at
    (N,) coordinate vectors (cavity on [0,1]^2, lid at y=1 moving in +x).
    Points with y > ``clip`` are excluded from the u-profile (regularized vs
    uniform lid — see module docstring). Returns
    {"ghia_u_rmse", "ghia_v_rmse", "n_u", "n_v"}.
    """
    tab = profiles(Re)
    keep = tab["y"] <= clip
    y_u = tab["y"][keep]
    out_u = uv_fn(np.full_like(y_u, 0.5), y_u)
    u_err = np.asarray(out_u["u"]).reshape(-1) - tab["u"][keep]
    out_v = uv_fn(tab["x"], np.full_like(tab["x"], 0.5))
    v_err = np.asarray(out_v["v"]).reshape(-1) - tab["v"]
    return {
        "ghia_u_rmse": float(np.sqrt(np.mean(u_err**2))),
        "ghia_v_rmse": float(np.sqrt(np.mean(v_err**2))),
        "n_u": int(keep.sum()),
        "n_v": int(len(tab["x"])),
    }
