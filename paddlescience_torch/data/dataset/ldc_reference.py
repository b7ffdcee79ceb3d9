"""Lid-driven-cavity reference fields for the LDC curriculum recipes (a torch
copy of ``tools/gen_ldc_reference.py``).

The fields are the steady state of the vorticity-streamfunction equations
on a uniform n x n grid of the unit square,

    laplace(psi) = -omega                   (DST-I Poisson solve, psi = 0 on the walls)
    omega_t = J(psi, omega) + laplace(omega) / Re

marched in pseudo time by Heun's RK2 with Arakawa's 9-point Jacobian,
central diffusion, Thom's wall vorticity and the regularised lid
u_lid(x) = 1 - cosh(50 (x - 1/2)) / cosh(25) of the PINN's boundary
condition. The same operations as the tool, in the same order and in
float32 (the tool runs under JAX's default precision): the time step is
min(0.4 h, 0.2 h^2 Re), the step budget min(max(300, 0.6 Re), 2400) / dt,
and the march runs in chunks of 2000 steps with one host read of psi a
chunk, stopping once max |dpsi| / (2000 dt) < ``TOL`` (1e-7). On the GPU a
chunk is one replay of a CUDA graph of its 2000 steps, captured once per
call.
The DST-I is the tool's: the imaginary part of the real FFT of the odd
extension (length 2n + 2), ``torch.fft.rfft`` with numpy's sign and
scale.

:func:`load_reference` reads ``ldc_Re{Re}.npz`` (``ldc_Re{Re}_n{n}.npz``
for a grid other than 257) from a cache directory (the repository's
``dataset/``, listed in ``.gitignore``, by default) or solves and writes it
first: the keys ``u``, ``v`` (n, n) indexed [x, y], ``psi``, ``omega``,
``x``, ``y``, as the tool writes them, and ``steps`` (the steps
marched). Nothing is downloaded.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from paddlescience_torch.device import DeviceLike, resolve_device

__all__ = ["dst1", "poisson_dst", "solve_cavity", "load_reference", "reference_path", "DATA_DIR", "CHUNK"]

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
                        "dataset")
CHUNK = 2000  # steps between host reads of psi (the tool's)
TOL = 1e-7  # the march stops once max |dpsi| / (CHUNK dt) falls below this (the tool's)
GRAPH_STEPS = 100  # steps a captured CUDA graph holds: a chunk replays it CHUNK // GRAPH_STEPS times
DEFAULT_N = 257


def dst1(x: torch.Tensor, axis: int) -> torch.Tensor:
    """DST-I along ``axis`` (twice the unnormalised transform): the
    negated imaginary part of the real FFT of the odd extension
    [0, x, 0, -x reversed]."""
    n = x.shape[axis]
    x = torch.movedim(x, axis, -1)
    zero = x.new_zeros(x.shape[:-1] + (1,))
    ext = torch.cat([zero, x, zero, -x.flip(-1)], dim=-1)
    out = -torch.fft.rfft(ext, dim=-1).imag[..., 1: n + 1]
    return torch.movedim(out, -1, axis)


def poisson_dst(rhs: torch.Tensor, h: float) -> torch.Tensor:
    """Solve laplace(p) = rhs with p = 0 on the boundary; ``rhs`` holds
    the (m, m) interior values."""
    m = rhs.shape[0]
    k = torch.arange(1, m + 1, dtype=torch.float32, device=rhs.device)
    lam = (2.0 * (torch.cos(math.pi * k / (m + 1)) - 1.0)) / (h * h)
    rhat = dst1(dst1(rhs, 0), 1)
    phat = rhat / (lam[:, None] + lam[None, :])
    # a forward and an inverse DST-I per axis scale by 2 (m + 1) each
    p = dst1(dst1(phat, 0), 1)
    return p / (2.0 * (m + 1)) ** 2


def _stepper(n: int, Re: float, device: torch.device):
    """(dt, step): ``step(omega)`` is one Heun step, returning the new
    omega and the psi of the old one."""
    h = 1.0 / (n - 1)
    x = np.linspace(0.0, 1.0, n)
    u_lid_np = 1.0 - np.cosh(50.0 * (x - 0.5)) / np.cosh(25.0)
    u_lid = torch.as_tensor(u_lid_np, dtype=torch.float32, device=device)
    dt = float(min(0.4 * h, 0.2 * h * h * Re))

    def arakawa(a, b):
        j1 = ((a[2:, 1:-1] - a[:-2, 1:-1]) * (b[1:-1, 2:] - b[1:-1, :-2])
              - (a[1:-1, 2:] - a[1:-1, :-2]) * (b[2:, 1:-1] - b[:-2, 1:-1]))
        j2 = (a[2:, 1:-1] * (b[2:, 2:] - b[2:, :-2])
              - a[:-2, 1:-1] * (b[:-2, 2:] - b[:-2, :-2])
              - a[1:-1, 2:] * (b[2:, 2:] - b[:-2, 2:])
              + a[1:-1, :-2] * (b[2:, :-2] - b[:-2, :-2]))
        j3 = (a[2:, 2:] * (b[1:-1, 2:] - b[2:, 1:-1])
              - a[:-2, :-2] * (b[:-2, 1:-1] - b[1:-1, :-2])
              - a[:-2, 2:] * (b[1:-1, 2:] - b[:-2, 1:-1])
              + a[2:, :-2] * (b[2:, 1:-1] - b[1:-1, :-2]))
        return (j1 + j2 + j3) / (12.0 * h * h)

    def rhs(omega):
        """(omega_t on the interior, omega with its walls closed, psi)."""
        psi = torch.zeros_like(omega)
        psi[1:-1, 1:-1] = poisson_dst(-omega[1:-1, 1:-1], h)
        omega = omega.clone()
        omega[0, :] = -2.0 * psi[1, :] / h**2
        omega[-1, :] = -2.0 * psi[-2, :] / h**2
        omega[:, 0] = -2.0 * psi[:, 1] / h**2
        omega[:, -1] = -2.0 * psi[:, -2] / h**2 - 2.0 * u_lid / h
        oc = omega[1:-1, 1:-1]
        lap = (omega[2:, 1:-1] + omega[:-2, 1:-1] + omega[1:-1, 2:] + omega[1:-1, :-2] - 4.0 * oc) / (h * h)
        return arakawa(psi, omega) + lap / Re, omega, psi

    def step(omega):
        f1, omega_bc, psi = rhs(omega)
        o1 = omega_bc.clone()
        o1[1:-1, 1:-1] = omega_bc[1:-1, 1:-1] + dt * f1
        f2, o1_bc, _ = rhs(o1)
        new = o1_bc.clone()
        new[1:-1, 1:-1] = omega_bc[1:-1, 1:-1] + 0.5 * dt * (f1 + f2)
        return new, psi

    return dt, step, u_lid_np


def _chunk_runner(step, omega: torch.Tensor, psi: torch.Tensor, graphed: bool) -> Callable[[], None]:
    """A function that advances (``omega``, ``psi``) in place by ``CHUNK``
    steps: ``CHUNK // GRAPH_STEPS`` replays of a CUDA graph of
    ``GRAPH_STEPS`` steps captured here when ``graphed`` (the same steps as
    one graph of the whole chunk, whose capture costs the host as much as
    running the chunk eagerly), else eager steps."""

    def advance(steps):
        o = omega
        for _ in range(steps):
            o, p = step(o)
        omega.copy_(o)
        psi.copy_(p)

    if not graphed:
        return lambda: advance(CHUNK)
    side = torch.cuda.Stream(omega.device)
    side.wait_stream(torch.cuda.current_stream(omega.device))
    with torch.cuda.stream(side):  # one warm-up step (the FFT plans); a step writes no input
        step(omega)
    torch.cuda.current_stream(omega.device).wait_stream(side)
    torch.cuda.synchronize(omega.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # recorded, not run: omega and psi are unchanged
        advance(GRAPH_STEPS)

    def replay():
        for _ in range(CHUNK // GRAPH_STEPS):
            graph.replay()

    return replay


def solve_cavity(Re: float, n: int = DEFAULT_N, steps: Optional[int] = None, report: Callable[[str], None] = print,
                 device: DeviceLike = None, graphed: Optional[bool] = None) -> Dict[str, np.ndarray]:
    """March the cavity at ``Re`` on an ``n`` x ``n`` grid to its steady
    state (at most ``steps`` steps, rounded up to whole chunks; None: the
    tool's budget); returns the tool's dict of float32 arrays (u, v, psi,
    omega, x, y). ``graphed`` (default: on CUDA) replays each chunk as one
    CUDA graph."""
    device = resolve_device(device)
    graphed = device.type == "cuda" if graphed is None else graphed
    dt, step, u_lid = _stepper(n, float(Re), device)
    if steps is None:
        steps = int(min(max(300.0, 0.6 * Re), 2400.0) / dt)
    omega = torch.zeros((n, n), dtype=torch.float32, device=device)
    psi = torch.zeros((n, n), dtype=torch.float32, device=device)
    run = _chunk_runner(step, omega, psi, graphed)
    done = 0
    psi_prev = psi.cpu().numpy()
    while done < steps:
        run()
        done += CHUNK
        psi_now = psi.cpu().numpy()
        dpsi = float(np.abs(psi_now - psi_prev).max()) / (CHUNK * dt)
        psi_prev = psi_now
        if done % 20000 == 0 or dpsi < TOL:
            report(f"Re={Re} n={n}: step {done}/{steps} dpsi/dt {dpsi:.3e} psi_min {psi_now.min():.6f}")
        if dpsi < TOL:
            break
    h = 1.0 / (n - 1)
    x = np.linspace(0.0, 1.0, n)
    u = np.zeros((n, n))
    v = np.zeros((n, n))
    u[1:-1, 1:-1] = (psi_prev[1:-1, 2:] - psi_prev[1:-1, :-2]) / (2 * h)
    v[1:-1, 1:-1] = -(psi_prev[2:, 1:-1] - psi_prev[:-2, 1:-1]) / (2 * h)
    u[:, -1] = u_lid.astype(np.float32)
    return {"u": u.astype(np.float32), "v": v.astype(np.float32), "psi": psi_prev.astype(np.float32),
            "omega": omega.cpu().numpy(), "x": x.astype(np.float32), "y": x.astype(np.float32),
            "steps": np.int64(done)}


def reference_path(Re: float, n: int = DEFAULT_N, cache_dir: Optional[str] = None) -> str:
    """Where :func:`load_reference` keeps the fields of ``Re`` at ``n``."""
    tag = int(Re) if float(Re).is_integer() else Re
    name = f"ldc_Re{tag}.npz" if n == DEFAULT_N else f"ldc_Re{tag}_n{n}.npz"
    return os.path.join(DATA_DIR if cache_dir is None else cache_dir, name)


def load_reference(Re: float, n: int = DEFAULT_N, cache_dir: Optional[str] = None, device: DeviceLike = None,
                   report: Callable[[str], None] = print) -> Dict[str, np.ndarray]:
    """{u, v, x, y} of the cavity at ``Re`` on the ``n`` grid, read from
    :func:`reference_path` or solved (:func:`solve_cavity` on ``device``)
    and written there first (whole, for a concurrent reader)."""
    path = reference_path(Re, n, cache_dir)
    if not os.path.exists(path):
        fields = solve_cavity(Re, n=n, device=device, report=report)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **fields)
        os.replace(tmp, path)
    d = np.load(path)
    return {k: d[k] for k in ("u", "v", "x", "y")}
