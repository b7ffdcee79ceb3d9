"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library goes into ``csrc/_build/`` (listed in ``.gitignore``) under a name
keyed by a hash of the sources and flags, so a checkout builds at first use
and a changed source rebuilds. :func:`build` compiles several sources in
parallel, one ``nvcc`` process each; :class:`Build` does so in the
background.

The wrappers bind a kernel's host entry point with :func:`declare` and call
it with :func:`launch`, which raises on a CUDA error code; :func:`ptrs`,
:func:`ints`, :func:`stream_handle`, :func:`on_device` and :func:`is_cpu`
are what they share in marshalling and checking tensors.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import signal
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["CSRC", "BUILD_DIR", "KERNELS", "Build", "build", "load", "nvcc_path", "declare", "launch", "ptrs",
           "ints", "stream_handle", "on_device", "is_cpu", "P", "I", "F"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
KERNELS = ("jet_mlp_fwd", "jet_mlp_bwd", "jet_wgrad", "jet_gated_fwd", "jet_gated_bwd",
           "lbm_collide_stream")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    "-split-compile", "0",  # a source's kernels (one per stream count) are optimised in parallel
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


class Build:
    """Starts compiling every kernel in ``names`` that is not built yet, one
    ``nvcc`` per source, all together, at the lowest scheduling priority
    (nice 19: the caller's own work stays first in line), and returns at
    once. :meth:`wait` finishes them; :meth:`close` kills any still
    running, with the compiler processes each started; :func:`load` of a
    kernel in flight waits for its build."""

    def __init__(self, names: Sequence[str] = KERNELS):
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        self.logs: Optional[Dict[str, str]] = None
        self.procs = []
        todo = [(n, _library_path(n)) for n in names if not _library_path(n).exists()]
        if not todo:
            self.logs = {}
            return
        nvcc = nvcc_path()
        try:
            for name, out in todo:
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                self.procs.append((name, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                    preexec_fn=lambda: os.nice(19), start_new_session=True)))
                _PENDING[name] = self
        except BaseException:
            self.close()
            raise

    def wait(self) -> Dict[str, str]:
        """``{name: compiler log}`` (the ``-Xptxas -v`` register and spill
        report) for the sources built. Raises ``RuntimeError`` with the
        compiler's output if any build failed."""
        if self.logs is not None:
            return self.logs
        try:
            logs, failed = {}, []
            for name, out, tmp, proc in self.procs:
                log, _ = proc.communicate()
                logs[name] = log
                if proc.returncode != 0:
                    failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, out)
            if failed:
                raise RuntimeError("\n".join(failed))
            self.logs = logs
            return logs
        finally:
            self.close()

    def close(self) -> None:
        for name, _, tmp, proc in self.procs:
            if proc.poll() is None:  # nvcc and the compilers it started (its own process group)
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                proc.wait()
            if tmp.exists():
                tmp.unlink()
            if _PENDING.get(name) is self:
                del _PENDING[name]


_PENDING: Dict[str, Build] = {}  # kernel -> the build in flight that compiles it


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every kernel in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns ``{name: compiler log}`` (the
    ``-Xptxas -v`` register and spill report) for the sources it built.
    Raises ``RuntimeError`` with the compiler's output if any build fails."""
    return Build(names).wait()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _library_path(name)
            if name in _PENDING:
                _PENDING[name].wait()
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.psci_error_string.argtypes = [ctypes.c_int]
            lib.psci_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


# ------------------------------------------------------ calling a kernel --

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ENTRY_POINTS: Dict[str, Tuple[str, list]] = {}  # entry point -> (library, argtypes)
_BOUND: Dict[str, Tuple[ctypes.CDLL, object]] = {}


def declare(entry: str, argtypes: list, library: Optional[str] = None) -> None:
    """Register the C signature of host entry point ``entry`` of
    ``csrc/<library>.cu`` (the library is named after the entry point
    unless given). Every entry point returns a ``cudaError_t`` as int."""
    _ENTRY_POINTS[entry] = (library or entry, argtypes)


def launch(entry: str, *args) -> None:
    """Call a declared entry point (building and loading its library at
    first use); raises ``RuntimeError`` unless it returns 0."""
    hit = _BOUND.get(entry)
    if hit is None:
        library, argtypes = _ENTRY_POINTS[entry]
        lib = load(library)
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        hit = _BOUND[entry] = (lib, fn)
    lib, fn = hit
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}: {lib.psci_error_string(rc).decode()}")


def ptrs(ts: Sequence[Optional[torch.Tensor]]):
    """Host array of device pointers; None gives a null pointer."""
    return (ctypes.c_void_p * len(ts))(*[None if t is None else t.data_ptr() for t in ts])


def ints(xs: Sequence[int]):
    return (ctypes.c_int * len(xs))(*xs)


def stream_handle(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def on_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Contiguous float32 on ``dev``, 16-byte aligned (the kernels read
    float4); raises on anything else."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"expected float32 tensors on {dev}, got {t.dtype} on {t.device}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def is_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (the wrapper takes its plain version), False
    for a CUDA tensor (it launches its kernel); anything else raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"the kernels run on CUDA (or plainly on the CPU), got {t.device}")
    return False
