"""D2Q9 lattice-Boltzmann solver (counterpart of
``paddlescience_tpu/ops/lbm.py``): a BGK stream-collide update for the
lid-driven cavity, used to generate training data.

* :func:`lbm_collide_stream` - collision and periodic streaming in one
  hand-written CUDA kernel (``csrc/lbm_collide_stream.cu``, which replaces
  ``_lbm_kernel``, ``lbm.py:141``). On a CPU tensor, and only there, it
  takes :func:`lbm_collide_stream_plain`; on a CUDA tensor it launches the
  kernel or raises;
* :func:`lbm_step` - that, then the walls and the moving lid in plain
  tensor operations on the boundary rows, as the JAX version keeps them
  outside its kernel;
* :func:`lbm_step_plain` - the whole step in plain tensor operations (the
  JAX package's ``lbm_step_reference``).

``lbm_collide_stream.launches`` counts kernel launches,
``lbm_collide_stream_plain.cuda_calls`` calls of the plain version on CUDA
tensors. The lattice is (9, H, W) float32 with any H and W.
"""

from __future__ import annotations

from typing import Tuple

import torch

from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.ops import cuda_build
from paddlescience_torch.ops.cuda_build import F, I, P, is_cpu, launch, on_device, stream_handle

__all__ = ["D2Q9_E", "D2Q9_W", "lbm_collide_stream", "lbm_collide_stream_plain", "lbm_step", "lbm_step_plain",
           "run_cavity", "reset_counters"]

# D2Q9 lattice: velocities e_i = (ex, ey), weights w_i, opposite directions
D2Q9_E = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1), (1, 1), (-1, 1), (-1, -1), (1, -1))
D2Q9_W = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4
_OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)


def _equilibrium(rho, ux, uy):
    """f_eq_i = w_i rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u), (9, H, W)."""
    eu = torch.stack([ex * ux + ey * uy for ex, ey in D2Q9_E])
    usq = ux * ux + uy * uy
    w = torch.tensor(D2Q9_W, dtype=rho.dtype, device=rho.device)[:, None, None]
    return w * rho[None] * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq[None])


def _macroscopic(f):
    e = torch.tensor(D2Q9_E, dtype=f.dtype, device=f.device)
    rho = f.sum(0)
    ux = (f * e[:, 0, None, None]).sum(0) / rho
    uy = (f * e[:, 1, None, None]).sum(0) / rho
    return rho, ux, uy


def _collide(f, tau: float):
    rho, ux, uy = _macroscopic(f)
    return f - (f - _equilibrium(rho, ux, uy)) / tau


def _stream(f_post):
    """Periodic shift of each distribution by its velocity."""
    return torch.stack([torch.roll(f_post[i], shifts=(ey, ex), dims=(0, 1)) for i, (ex, ey) in enumerate(D2Q9_E)])


def _bounce(f, u_lid: float):
    """Bounce-back walls on the streamed lattice ``f`` (updated in place):
    bottom row, then both side columns, then the moving lid on the top row
    with its momentum correction (Ladd), each step seeing the one before,
    in the order of the JAX package's ``_stream_and_bounce``."""
    opp = list(_OPP)
    rho_top = f[:, -1, :].sum(0)
    f[:, 0, :] = f[opp, 0, :]
    f[:, :, 0] = f[opp, :, 0]
    f[:, :, -1] = f[opp, :, -1]
    top = f[:, -1, :].clone()
    for i, (ex, _) in enumerate(D2Q9_E):
        top[_OPP[i]] = top[i] - (6.0 * D2Q9_W[i] * ex * u_lid) * rho_top
    f[:, -1, :] = top
    return f


def lbm_collide_stream_plain(f: torch.Tensor, tau: float) -> torch.Tensor:
    """BGK collision and periodic streaming in plain tensor operations."""
    if f.is_cuda:
        lbm_collide_stream_plain.cuda_calls += 1
    return _stream(_collide(f, tau))


def lbm_step_plain(f: torch.Tensor, tau: float, u_lid: float) -> torch.Tensor:
    """One BGK collide + stream + boundary step, (9, H, W) -> (9, H, W)."""
    return _bounce(lbm_collide_stream_plain(f, tau), u_lid)


cuda_build.declare("lbm_collide_stream", [P, P, I, I, F, P])


def lbm_collide_stream(f: torch.Tensor, tau: float) -> torch.Tensor:
    """BGK collision and periodic streaming of a (9, H, W) lattice through
    the fused kernel; returns a new lattice."""
    if f.dim() != 3 or f.shape[0] != 9:
        raise ValueError(f"the lattice is (9, H, W), got {tuple(f.shape)}")
    if is_cpu(f):
        return lbm_collide_stream_plain(f, tau)
    f = on_device(f, f.device)
    out = torch.empty_like(f)
    launch("lbm_collide_stream", f.data_ptr(), out.data_ptr(), int(f.shape[1]), int(f.shape[2]), float(tau),
           stream_handle(f.device))
    lbm_collide_stream.launches += 1
    return out


def lbm_step(f: torch.Tensor, tau: float, u_lid: float) -> torch.Tensor:
    """One step: collision and streaming through the kernel, then the walls
    and the lid in plain tensor operations."""
    return _bounce(lbm_collide_stream(f, tau), u_lid)


def reset_counters() -> None:
    lbm_collide_stream.launches = 0
    lbm_collide_stream_plain.cuda_calls = 0


reset_counters()


def run_cavity(nx: int = 128, ny: int = 128, re: float = 400.0, u_lid: float = 0.1, steps: int = 1000,
               device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the lid-driven cavity for ``steps`` steps from rest; returns the
    (rho, ux, uy) fields, each (ny, nx). tau follows from
    Re = u_lid * nx / nu, nu = (tau - 0.5) / 3. Runs on CUDA unless given a
    device."""
    device = resolve_device(device)
    tau = 3.0 * (u_lid * nx / re) + 0.5
    rest = torch.zeros(ny, nx, device=device)
    f = _equilibrium(torch.ones(ny, nx, device=device), rest, rest)
    for _ in range(steps):
        f = lbm_step(f, tau, u_lid)
    return _macroscopic(f)
