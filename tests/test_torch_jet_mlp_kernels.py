"""The port's jet-segment kernels and their plain versions
(paddlescience_torch/ops/jet_mlp.py), without JAX.

On the CPU: the hand-derived backward against torch.autograd through the
plain forward, the saved stage boundaries, and the wrappers' device rule.
On a GPU (tests marked ``cuda``, skipped elsewhere): each kernel against its
plain version at the main-path segment depths (L=4 and the 3+1 split),
with a ragged batch, and at a small shape.
This file imports only torch and the port, so it also runs where JAX is
not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_jet_mlp_kernels.py``.
Tolerance on the GPU: 1e-4 times the reference's largest magnitude (the
float32 sums run in another order).
"""

import numpy as np
import pytest
import torch

from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.ops import jet_mlp as J

RTOL = 1e-4
INDICES = [[(0,), (1,), (1, 1)], [(0,), (0, 1), (1, 1)]]


def _close(got, ref, rtol=RTOL):
    got, ref = got.detach().cpu(), ref.detach().cpu()
    assert got.shape == ref.shape
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= rtol * max(scale, 1e-30), f"max abs err {err:.3e} > {rtol} * {scale:.3e}"


def _case(multis, L, n=70, w=24, seed=0):
    rng = np.random.default_rng(seed)
    S = len(tjet.build_index(multis))
    streams = [rng.standard_normal((n, w)).astype(np.float32) for _ in range(S)]
    weights = [(rng.standard_normal((w, w)) / np.sqrt(w)).astype(np.float32) for _ in range(L)]
    biases = [(0.1 * rng.standard_normal((w,))).astype(np.float32) for _ in range(L)]
    cot = [rng.standard_normal((n, w)).astype(np.float32) for _ in range(S)]
    return streams, weights, biases, cot


@pytest.mark.parametrize("multis", INDICES + [[(1,)], []])
@pytest.mark.parametrize("save_bounds", [False, True])
def test_hand_derived_backward_matches_autograd(multis, save_bounds):
    """jet_mlp_bwd_plain + jet_wgrad_plain (through the autograd.Function)
    against torch.autograd through the plain forward, in float64 so only the
    derivation is tested."""
    idx = tjet.build_index(multis)
    streams, weights, biases, cot = _case(multis, 3, n=37, w=12, seed=1)
    to64 = lambda arrs: [torch.from_numpy(a).double().requires_grad_() for a in arrs]
    ss, ws, bs = to64(streams), to64(weights), to64(biases)
    g_out = [torch.from_numpy(c).double() for c in cot]
    outs, _ = J.jet_mlp_fwd_plain(ss, ws, bs, idx)
    ref = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, g_out)), ss + ws + bs)
    out = J.jet_mlp_segment(tjet.Jet(ss, idx), ws, bs, save_bounds=save_bounds)
    got = torch.autograd.grad(sum((o * g).sum() for o, g in zip(out.streams, g_out)), ss + ws + bs)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_save_bounds_returns_stage_boundaries():
    multis = INDICES[0]
    idx = tjet.build_index(multis)
    streams, weights, biases, _ = _case(multis, 3, n=9, w=8)
    ss = [torch.from_numpy(a) for a in streams]
    ws = [torch.from_numpy(a) for a in weights]
    bs = [torch.from_numpy(a) for a in biases]
    outs, bounds = J.jet_mlp_fwd_plain(ss, ws, bs, idx, save_bounds=True)
    assert len(bounds) == 2 and tuple(bounds[0].shape) == (len(idx), 9, 8)
    first, _ = J.jet_mlp_fwd_plain(ss, ws[:1], bs[:1], idx)
    torch.testing.assert_close(bounds[0], torch.stack(first))
    rest, _ = J.jet_mlp_fwd_plain(list(bounds[1].unbind(0)), ws[2:], bs[2:], idx)
    for a, b in zip(rest, outs):
        torch.testing.assert_close(a, b)


def test_segment_second_derivative_raises():
    """The backward kernels carry no autograd history, so differentiating the
    segment's gradient must fail loudly rather than return a partial
    second derivative."""
    idx = tjet.build_index(INDICES[0])
    streams, weights, biases, _ = _case(INDICES[0], 2, n=9, w=8)
    ss, ws, bs = ([torch.from_numpy(a).requires_grad_() for a in arrs] for arrs in (streams, weights, biases))
    out = J.jet_mlp_segment(tjet.Jet(ss, idx), ws, bs)
    (gw,) = torch.autograd.grad(sum((o * o).sum() for o in out.streams), ws[:1], create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gw.sum().backward()


@pytest.mark.parametrize("deriv,lengths", [("jet", []), ("jet_pallas", [3, 1]), ("jet_pallas_full", [4])])
def test_segment_lengths_per_path(deriv, lengths):
    """The depths at which each derivative path runs the segment kernels
    (what the GPU smoke test checks them at)."""
    from paddlescience_torch.arch.mlp import MLP
    from paddlescience_torch.autodiff import path as tpath

    model = MLP(("t", "x"), ("u",), num_layers=4, hidden_size=128, device="cpu")
    saved = tpath.get_default()
    try:
        tpath.set_default(tpath.CANDIDATES[deriv])  # pins the whole candidate, unlike override
        assert model.jet_segment_lengths() == lengths
    finally:
        tpath.set_default(saved)


def test_wrappers_take_plain_versions_only_on_cpu():
    """A tensor that is neither on the CPU nor on CUDA is refused, not run
    plainly; the CPU path counts no kernel launch."""
    idx = tjet.build_index([(0,)])
    meta = [torch.empty(4, 8, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA"):
        J.jet_mlp_fwd(meta, [torch.empty(8, 8, device="meta")], [torch.empty(8, device="meta")], idx)
    J.reset_counters()
    cpu = [torch.randn(4, 8) for _ in range(2)]
    J.jet_mlp_fwd(cpu, [torch.randn(8, 8)], [torch.randn(8)], idx)
    assert J.jet_mlp_fwd.launches == 0 and J.jet_mlp_fwd_plain.cuda_calls == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("multis", INDICES)
@pytest.mark.parametrize("n,L,w", [(4096, 4, 256), (4096, 3, 256), (4095, 4, 256), (4096, 1, 256),
                                   (70, 3, 24)])
def test_kernels_match_plain_versions_on_gpu(cuda_device, multis, n, L, w):
    idx = tjet.build_index(multis)
    streams, weights, biases, cot = _case(multis, L, n=n, w=w)
    dev = lambda arrs: [torch.from_numpy(a).to(cuda_device) for a in arrs]
    ss, ws, bs, gs = dev(streams), dev(weights), dev(biases), dev(cot)
    J.reset_counters()
    outs, bounds = J.jet_mlp_fwd(ss, ws, bs, idx, save_bounds=True)
    r_outs, r_bounds = J.jet_mlp_fwd_plain(ss, ws, bs, idx, save_bounds=True)
    g_in, gzs = J.jet_mlp_bwd(ss, r_bounds, ws, bs, gs, idx)
    r_gin, r_gzs = J.jet_mlp_bwd_plain(ss, r_bounds, ws, bs, gs, idx)
    ys = [ss] + [b.unbind(0) for b in r_bounds]
    dws, dbs = J.jet_wgrad(ys, r_gzs)
    r_dws, r_dbs = J.jet_wgrad_plain(ys, r_gzs)
    torch.cuda.synchronize()
    assert (J.jet_mlp_fwd.launches, J.jet_mlp_bwd.launches, J.jet_wgrad.launches) == (1, 1, 1)
    for got, ref in zip([*outs, *bounds, *g_in, *gzs, *dws, *dbs],
                        [*r_outs, *r_bounds, *r_gin, *r_gzs, *r_dws, *r_dbs]):
        _close(got, ref)


@pytest.mark.cuda
def test_segment_gradients_on_gpu(cuda_device):
    """The autograd.Function on the card against autograd through the plain
    forward, recompute and save-bounds modes."""
    multis = INDICES[0]
    idx = tjet.build_index(multis)
    streams, weights, biases, cot = _case(multis, 4, n=1000, w=64)
    leaves = lambda: [torch.from_numpy(a).to(cuda_device).requires_grad_()
                      for a in (*streams, *weights, *biases)]
    gs = [torch.from_numpy(c).to(cuda_device) for c in cot]
    S, L = len(streams), len(weights)
    ref_leaves = leaves()
    outs, _ = J.jet_mlp_fwd_plain(ref_leaves[:S], ref_leaves[S:S + L], ref_leaves[S + L:], idx)
    ref = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, gs)), ref_leaves)
    for save_bounds in (False, True):
        lv = leaves()
        out = J.jet_mlp_segment(tjet.Jet(lv[:S], idx), lv[S:S + L], lv[S + L:], save_bounds=save_bounds)
        got = torch.autograd.grad(sum((o * g).sum() for o, g in zip(out.streams, gs)), lv)
        for a, b in zip(got, ref):
            _close(a, b)
