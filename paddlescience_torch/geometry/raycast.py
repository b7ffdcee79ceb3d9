"""The mesh ray cast and distance library (``csrc/mesh_raycast.cpp``):
host C++ on one thread per core, built with ``g++`` at first use into
``csrc/_build/`` under a name keyed by a hash of the source, the flags and
the host's machine type, and loaded with ``ctypes``.

The flags hold no ``-march``: a checkout that moves between hosts of one
architecture loads the same library; and no ``-fopenmp``: the GPU
machine's toolchain has no OpenMP runtime to link (``libgomp.spec`` is
missing), so the source splits the points over ``std::thread``s itself. ``-ffp-contract=off`` keeps every
product and sum a separate rounding, as numpy's, so the hit counts equal
the numpy version's. A failed build or load raises ``RuntimeError``;
nothing falls back to numpy behind the caller's back (``Mesh(...,
native=False)`` chooses the numpy version).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["SOURCE", "FLAGS", "library_path", "load", "ray_hits_z", "unsigned_distance"]

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "mesh_raycast.cpp"
BUILD_DIR = SOURCE.parent / "_build"
FLAGS = ("-O3", "-std=c++17", "-pthread", "-ffp-contract=off", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256()
    h.update(" ".join(FLAGS).encode())
    h.update(platform.machine().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmesh_raycast-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the mesh ray cast needs g++ to build csrc/mesh_raycast.cpp (or Mesh(native=False))")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed (exit {res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> ctypes.CDLL:
    """The loaded library, built first where it is not."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            dp, ip, n = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64), ctypes.c_int64
            lib.psci_ray_hits_z.argtypes = [dp, n, dp, n, ip]
            lib.psci_ray_hits_z.restype = None
            lib.psci_unsigned_distance.argtypes = [dp, n, dp, n, dp]
            lib.psci_unsigned_distance.restype = None
            _LIB = lib
        return _LIB


def _c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float64)


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def ray_hits_z(tri9: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """+z ray hit counts (P,) of points (P, 3) against triangles (F, 9),
    both in the rotated frame."""
    tri9, pts = _c(tri9), _c(pts)
    out = np.empty(len(pts), np.int64)
    load().psci_ray_hits_z(_dp(tri9), len(tri9), _dp(pts), len(pts), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def unsigned_distance(tri9: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Exact min point-triangle distances (P,) of points (P, 3) to the
    triangles (F, 9) = (v0, v1, v2)."""
    tri9, pts = _c(tri9), _c(pts)
    out = np.empty(len(pts), np.float64)
    load().psci_unsigned_distance(_dp(tri9), len(tri9), _dp(pts), len(pts), _dp(out))
    return out
