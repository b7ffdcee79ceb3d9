"""The nested-jvp path and the TIPC cases on a GPU, without JAX: the MLP
jet kernels at the cylinder2d workload's shape, the nested-jvp derivative
path against the jet path, and the cylinder and euler_beam solvers in
CUDA graphs (the nested jvp captured with the rest of the step).

On the CPU the CUDA tests skip (the kernels have no CPU mode); the two
CPU tests here check what a captured nested jvp relies on. This file
imports only torch and the port, so it also runs where JAX is not
installed: ``python -m pytest --noconftest -m cuda tests/test_torch_nested_jvp_gpu.py``.
"""

import math

import numpy as np
import pytest
import torch

from paddlescience_torch.autodiff import ad as tad
from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import cylinder2d_unsteady as cyl
from paddlescience_torch.examples import euler_beam
from paddlescience_torch.ops import jet_mlp as J

RTOL = 1e-4  # kernels against their plain versions: of the reference's largest magnitude
CYL_INDEX = [(0,), (1,), (1, 1), (2,), (2, 2)]  # the 2-D unsteady residual's jet: S = 6 with the value
CYL_DIMS = (3,) + (52,) * 5  # MLP 5 x 50, widths padded to 52
SMALL_MATCHED = dict(pde=400, inlet_cylinder=20, outlet=10, ic=400, ntime=5)


@pytest.fixture(autouse=True)
def _restore_path():
    saved = tpath.get_default()
    yield
    tpath.set_default(saved)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, ref, rtol=RTOL):
    got, ref = got.detach().cpu(), ref.detach().cpu()
    assert got.shape == ref.shape
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= rtol * max(scale, 1e-30), f"max abs err {err:.3e} > {rtol} * {scale:.3e}"


def _flat(solver):
    return torch.cat([p.detach().reshape(-1) for p in solver.model.parameters()])


def _graphed_against_eager(solver, k):
    """Two graphed chunks of k steps against 2k eager steps from the same
    state (restored in place): the parameters' relative difference."""
    snap = solver.state
    solver.train_chunk(k)
    solver.train_chunk(k)
    graphed = _flat(solver).clone()
    solver._load_state(snap)
    solver.train_steps(2 * k)
    torch.cuda.synchronize()
    eager = _flat(solver)
    return float((graphed - eager).norm() / eager.norm())


# ------------------------------------------------------------------ CPU --


def test_one_hot_tangents_are_filled_on_the_device():
    """The nested jvp's tangents come from a fill on the tensor's device
    (no host copy, so a CUDA graph can capture them)."""
    x = torch.rand(5, 3)
    t = tad._one_hot(x, 1)
    assert t.device == x.device and t.dtype == x.dtype
    assert torch.equal(t, torch.tensor([[0.0, 1.0, 0.0]]).expand(5, 3))


def test_nested_jvp_of_the_batched_forward_is_per_row():
    """Rows are independent: the batched nested jvp equals row-by-row
    nested jvps (what the JAX package vmaps)."""
    w = torch.randn(2, 7, generator=torch.Generator().manual_seed(1))
    fn = lambda x, ex: torch.tanh(x @ w).sum(-1, keepdim=True) * x[..., :1]
    x = torch.rand(6, 2)
    batched = tad._nested_jvp(fn, x, {}, (0, 1, 1))
    rows = torch.cat([tad._nested_jvp(fn, x[i:i + 1], {}, (0, 1, 1)) for i in range(6)])
    torch.testing.assert_close(batched, rows, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ GPU --


@pytest.mark.cuda
@pytest.mark.parametrize("n", [282600, 9419])
def test_mlp_kernels_at_the_cylinder_shape(cuda_device, n):
    """S = 6, 3 -> 52 x 5, tanh, both forward modes, the backward and the
    weight gradient, at the workload's interior batch (282,600 rows: a
    ragged last tile of 16) and a second ragged batch."""
    idx = tjet.build_index(CYL_INDEX)
    assert len(idx) == 6 and J.kernels_take(6, CYL_DIMS, False)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=cuda_device)
    L = len(CYL_DIMS) - 1
    streams = [rn(n, CYL_DIMS[0]) for _ in range(6)]
    weights = [rn(CYL_DIMS[l], CYL_DIMS[l + 1]) / math.sqrt(CYL_DIMS[l]) for l in range(L)]
    biases = [0.1 * rn(CYL_DIMS[l + 1]) for l in range(L)]
    g_out = [rn(n, CYL_DIMS[-1]) for _ in range(6)]
    J.reset_counters()
    outs, _ = J.jet_mlp_fwd(streams, weights, biases, idx)
    outs_sb, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True)
    r_outs, r_bounds = J.jet_mlp_fwd_plain(streams, weights, biases, idx, save_bounds=True)
    g_in, gzs = J.jet_mlp_bwd(streams, r_bounds, weights, biases, g_out, idx)
    r_gin, r_gzs = J.jet_mlp_bwd_plain(streams, r_bounds, weights, biases, g_out, idx)
    ys = [streams] + [b.unbind(0) for b in r_bounds]
    dws, dbs = J.jet_wgrad(ys, r_gzs)
    r_dws, r_dbs = J.jet_wgrad_plain(ys, r_gzs)
    torch.cuda.synchronize()
    assert (J.jet_mlp_fwd.launches, J.jet_mlp_bwd.launches, J.jet_wgrad.launches) == (2, 1, 1)
    for got, ref in zip([*outs, *outs_sb, *bounds, *g_in, *gzs, *dws, *dbs],
                        [*r_outs, *r_outs, *r_bounds, *r_gin, *r_gzs, *r_dws, *r_dbs]):
        _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cylinder", "euler_beam"])
def test_jvp_path_matches_the_jet_path_on_gpu(cuda_device, case):
    """The loss of every constraint and its parameter gradient under the
    ``jvp`` candidate against the plain jet path, on the card (loss 1e-5
    relative, gradient 1e-4 relative norm)."""
    if case == "cylinder":
        solver, _ = cyl.build_matched_solver(2, deriv="jet_pallas_full", device=cuda_device, sizes=SMALL_MATCHED)
    else:
        solver = euler_beam.build_solver(epochs=1, iters_per_epoch=1, output_dir=None, deriv="jet_pallas_full",
                                         device=cuda_device)
    batches = solver._batches()
    results = {}
    for deriv in ("jet", "jvp"):
        tpath.set_default(tpath.CANDIDATES[deriv])
        losses = solver._constraint_losses(batches)
        total = sum(losses.values())
        results[deriv] = (torch.stack(list(losses.values())).detach(), torch.autograd.grad(total, solver._params()))
    (l_jet, g_jet), (l_jvp, g_jvp) = results["jet"], results["jvp"]
    torch.testing.assert_close(l_jvp, l_jet, rtol=1e-5, atol=0)
    g_a = torch.cat([g.reshape(-1) for g in g_jvp])
    g_b = torch.cat([g.reshape(-1) for g in g_jet])
    assert float((g_a - g_b).norm() / g_b.norm()) < 1e-4


@pytest.mark.cuda
def test_cylinder_graphed_equals_eager_on_gpu(cuda_device):
    """The matched workload (cut) on the MLP kernels: two graphed chunks
    against eager steps, every kernel launched during the capture."""
    solver, points = cyl.build_matched_solver(4, deriv="jet_pallas_full", device=cuda_device, sizes=SMALL_MATCHED)
    assert points == 400 * 5 + 20 * 5 + 10 * 5 + 400
    J.reset_counters()
    assert _graphed_against_eager(solver, 4) <= 1e-6
    assert min(J.jet_mlp_fwd.launches, J.jet_mlp_bwd.launches, J.jet_wgrad.launches) >= 1
    assert solver.graph_stats[4]["replays"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("deriv", ["jet_pallas_full", "jvp"])
def test_euler_beam_graphed_equals_eager_on_gpu(cuda_device, deriv):
    """The fourth-order residual and the boundary's third derivative by
    nested jvp inside a captured graph: graphed chunks equal eager steps."""
    solver = euler_beam.build_solver(epochs=1, iters_per_epoch=1, output_dir=None, device=cuda_device, deriv=deriv)
    assert _graphed_against_eager(solver, 5) <= 1e-6
    assert solver.graph_stats[5]["replays"] == 2


@pytest.mark.cuda
def test_euler_beam_trains_graphed_on_gpu(cuda_device, tmp_path):
    """``train()`` by epochs of one graphed chunk each against the same
    epochs of eager steps: the L2Rel against the analytic solution finite
    and equal to 1e-4."""
    kw = dict(epochs=20, iters_per_epoch=10, deriv="jet_pallas_full", device=cuda_device)
    graphed = euler_beam.build_solver(output_dir=str(tmp_path / "graphed"), **kw)
    graphed.train()
    eager = euler_beam.build_solver(output_dir=str(tmp_path / "eager"), **kw)
    eager.train(num_fused_steps=1)
    assert graphed.graph_stats[10]["replays"] == 20 and not eager.graph_stats
    l2_graphed, _ = graphed.eval()
    l2_eager, _ = eager.eval()
    assert np.isfinite(l2_graphed)
    np.testing.assert_allclose(l2_graphed, l2_eager, rtol=1e-4)
