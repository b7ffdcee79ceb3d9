"""The port's kernels and their plain versions (paddlescience_torch/ops/
jet_mlp.py, jet_gated.py, lbm.py), without JAX.

On the CPU: the hand-derived backwards (tanh MLP segment, gated layer
programs) against torch.autograd through the plain forward, the saved
stage boundaries, the backward kernels' tile and shared-memory plan,
jet_wgrad's unit plan (every output element and batch
row covered once, the last wave nearly full), the wrappers' device rule,
the one predicate of what the kernels take (``kernels_take``), the
segments' zero padding of widths that are no multiple of 4, and the
dispatcher: only the lane gate sends layers to the plain jet path, so
cylinder2d's MLP 5x50 trains through the padded segments under
``jet_pallas_full`` and on the plain jet path where the gate holds.
On a GPU (tests marked ``cuda``, skipped elsewhere): each kernel against its
plain version at the main-path segment depths (MLP: L=4 and the 3+1 split;
PirateNet groups of 3 and 9 blocks; ModifiedMLP segments of 3 and 1
layers), with a ragged batch, and at a small shape; the gated backward
also at S = 6 x width 256 (the widest that keeps two tiles), S = 7 and 8
(one tile, the cotangent parked), a narrow first input, the bare program
and bitwise the same from call to call; padded segments of width 50; jet_wgrad also at the
aneurysm's 3 -> 512 x 6 (S = 7), an input width that is not a multiple of
4, and bitwise the same from call to call (dW, db, d alpha); jet_mlp_bwd
at width 512 with S = 5 (two tiles) and S = 8 (parked), and bitwise the
same from call to call (aneurysm, MLP 4x256); all three ungated kernels
at 9-16 streams (the halves kernels: heart's 3 -> 256 x 6 at S = 10,
S = 15 and 16 at width 256, width 128 at S = 10, 16 streams of width 64,
13 of width 300), bitwise the same from call to call at S = 10 and 16;
the aneurysm MLP's
segments (SiLU, S = 7, 3 -> 512 -> ... -> 512, 6 layers and 3 + 3);
every activation, ungated and gated; MLP 5x50 trains under
``jet_pallas_full`` through the kernels; the LBM kernel at square,
ragged and large lattices.
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
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.ops import jet_gated as G
from paddlescience_torch.ops import jet_mlp as J
from paddlescience_torch.ops import kinks as K
from paddlescience_torch.ops import lbm

RTOL = 1e-4
INDICES = [[(0,), (1,), (1, 1)], [(0,), (0, 1), (1, 1)]]


def _close(got, ref, rtol=RTOL):
    got, ref = got.detach().cpu(), ref.detach().cpu()
    assert got.shape == ref.shape
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= rtol * max(scale, 1e-30), f"max abs err {err:.3e} > {rtol} * {scale:.3e}"


def _case(multis, L, n=70, w=24, seed=0, k_in=None):
    """numpy inputs of an ungated segment: S streams (n, k_in), layers
    k_in -> w -> ... -> w (k_in = w unless given), output cotangents."""
    rng = np.random.default_rng(seed)
    S = len(tjet.build_index(multis))
    dims = [k_in or w] + [w] * L
    streams = [rng.standard_normal((n, dims[0])).astype(np.float32) for _ in range(S)]
    weights = [(rng.standard_normal((dims[l], w)) / np.sqrt(dims[l])).astype(np.float32) for l in range(L)]
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


# (streams, width) -> the backward's (tile rows, parks, shared-memory bytes): two tiles and the ring of
# GB_STAGES chunks of 16 x kmax where they fit, else one tile and the cotangent parked
BWD_PLANS = {
    (4, 256): (16, False, 2 * 4 * 256 * 16 * 4 + 32768),
    (6, 256): (16, False, 229376),   # the widest S for two 16-row tiles at 256
    (7, 256): (16, True, 147456),    # two 7-stream tiles and the ring would need 262,144 bytes
    (8, 256): (16, True, 163840),
    (5, 512): (8, False, 229376),    # two 8-row tiles at 512
    (6, 512): (8, True, 163840),
    (7, 512): (8, True, 180224),     # the aneurysm: 114,688 for the tile + 65,536 for the ring
    (8, 512): (8, True, 196608),     # its unsteady form
    (10, 256): (16, True, 196608),   # heart's 3-D Hooke jet: the halves kernel, which always parks
    (11, 256): (16, True, 212992),   # the most streams at 16 rows and width 256
    (12, 256): (8, True, 131072),    # 16 rows would need 246,528 bytes for the forward
    (16, 256): (8, True, 163840),
}


@pytest.mark.parametrize("S,w", list(BWD_PLANS))
def test_tiling_and_shared_memory_plan(S, w):
    """Which row tile and cotangent placement each shape gets (above 8
    streams the backward always parks), and that every shape the wrappers
    admit up to 8 streams (widths <= 512; gated <= 256) fits the shared
    memory of one CTA."""
    rows, parks, smem = BWD_PLANS[(S, w)]
    dims = [3] + [w] * 6
    assert J.tile_rows(S, dims) == rows and J.bwd_parks(S, dims) is parks and J.bwd_smem(S, dims) == smem
    assert parks is (S > J.GROUP_STREAMS or (2 * S * w * rows + J.GB_STAGES * 16 * w) * 4 > J.SMEM_LIMIT)
    assert max(J.fwd_smem(S, dims), smem) <= J.SMEM_LIMIT
    for S_ in range(1, J.GATED_MAX_STREAMS + 1):
        for w_ in (24, 256, 260, 512):
            dims = [3] + [w_] * 4
            assert J.fwd_smem(S_, dims) <= J.SMEM_LIMIT and J.bwd_smem(S_, dims) <= J.SMEM_LIMIT, (S_, w_)
    idx = tjet.build_index([(0,)])
    t = [torch.zeros(4, 516)] * 2
    with pytest.raises(ValueError, match="widths <= 512"):
        J._segment_dims(t, [torch.zeros(516, 516)], [torch.zeros(516)], idx)
    with pytest.raises(ValueError, match="widths <= 256"):
        G._gated_dims(t[:1] * 2, (), (), [torch.zeros(516, 260)], [torch.zeros(260)], (), G.mlp_program(1), idx)
    with pytest.raises(ValueError, match="unknown activation"):
        J.act_args((99, 0.0))


def test_backward_shared_memory_matches_the_kernels():
    """The plan's byte count is the one both backward kernels launch with
    (csrc/jet_common.cuh::bwd_smem), with the ring's stage count, and only
    the parked instances that the plan can ask for exist (S >= 6), and
    above 8 streams the halves kernel, which always parks."""
    common = (J.cuda_build.CSRC / "jet_common.cuh").read_text()
    mlp_bwd = (J.cuda_build.CSRC / "jet_mlp_bwd.cu").read_text()
    assert f"#define GB_STAGES {J.GB_STAGES} " in common
    assert "((park ? 1 : 2) * (size_t)S * kmax * bm + (size_t)GB_STAGES * PSCI_KC * kmax) * sizeof(float)" in common
    assert "bwd_smem(S, p.kmax, BM, PARK)" in mlp_bwd
    assert "bwd_smem(S, p.kmax, PSCI_BM, p.park)" in (J.cuda_build.CSRC / "jet_gated_bwd.cu").read_text()
    parked = {(S, w) for S in range(1, J.GROUP_STREAMS + 1) for w in range(4, J.MAX_WIDTH + 1, 4)
              if J.bwd_parks(S, [w] * 3)}
    assert min(S for S, _ in parked) == 6 and {S for S, w in parked if w <= J.NARROW_WIDTH} == {7, 8}
    for S in range(6, J.GROUP_STREAMS + 1):
        assert f"case {S}: return launch<{S}, BM, true, true>(p, st);" in mlp_bwd
    assert "bwd_smem(S, p.kmax, BM, 1)" in mlp_bwd
    for S in range(J.GROUP_STREAMS + 1, J.MAX_STREAMS + 1):
        assert f"case {S}: return launch_halves<{S}, BM>(p, st);" in mlp_bwd
        assert all(J.bwd_parks(S, [w] * 3) for w in range(4, J.NARROW_WIDTH + 1, 4))


PIRATENET_9 = [256] * 28
ANEURYSM_DIMS = [3] + [512] * 6


def _index_of(S):
    """A jet index of S streams: the primal and S - 1 first derivatives."""
    return tjet.build_index([(i,) for i in range(S - 1)])


@pytest.mark.parametrize("S,dims,gated,takes", [
    (4, [256] + [50] * 5, False, False),        # cylinder2d's MLP 5x50 unpadded: outputs not a multiple of 4
    (1, [3] + [50] * 5, False, False),          # (the segments pad them: pad_widths)
    (4, [516] * 3, False, False),               # wider than 512
    (4, [260] * 3, True, False),                # gated wider than 256
    (7, [264] * 28, True, False),               # the same at S = 7
    (17, [24] * 3, False, False),               # more than 16 streams
    (9, [24] * 3, True, False),                 # gated, more than 8 streams
    (10, [3] + [256] * 6, False, True),         # heart's 3-D Hooke jet, MLP 6x256
    (16, [4] + [256] * 3, False, True),         # 16 streams at width 256 (8-row tiles)
    (10, [3] + [128] * 5, False, True),         # aneurysm_flow's width at 10 streams
    (9, ANEURYSM_DIMS, False, False),           # 9 streams of width 512: more than the forward's shared memory
    (4, [256] * 34, False, False),              # more than 32 layers
    (4, [256] * 5, False, True),                # the Allen-Cahn MLP 4x256
    (4, PIRATENET_9, True, True),               # PirateNet 9 blocks
    (6, PIRATENET_9, True, True),               # the widest S for two tiles in the gated backward
    (7, PIRATENET_9, True, True),               # gated S = 7 at width 256: one tile, the cotangent parked
    (8, PIRATENET_9, True, True),
    (4, [256] + [52] * 5, False, True),         # MLP 5x50 padded
    (7, ANEURYSM_DIMS, False, True),            # the aneurysm MLP 3 -> 512 x 6
    (8, [5] + [64] * 3, True, True),            # a narrow first input, every stream count
])
def test_kernels_take(S, dims, gated, takes):
    """The one statement of the kernels' limits, and the wrappers' shape
    check that raises on it."""
    assert J.kernels_take(S, dims, gated) is takes
    assert (J.kernel_refusal(S, dims, gated) is None) is takes
    idx = _index_of(S)
    streams = [torch.zeros(2, dims[0])] * S
    weights = [torch.zeros(dims[l], dims[l + 1]) for l in range(len(dims) - 1)]
    biases = [torch.zeros(d) for d in dims[1:]]
    if takes:
        assert J._segment_dims(streams, weights, biases, idx, gated) == dims
    else:
        with pytest.raises(ValueError, match="kernels take|shared memory"):
            J._segment_dims(streams, weights, biases, idx, gated)


@pytest.mark.parametrize("w", [64, 128, 256])
@pytest.mark.parametrize("S", range(1, J.GATED_MAX_STREAMS + 1))
def test_gated_backward_shared_memory_plan(S, w):
    """jet_gated_bwd's shared memory (the input and cotangent tiles, and its
    ring of weight chunks, as csrc/jet_common.cuh::bwd_smem sizes them;
    test_backward_shared_memory_matches_the_kernels) against the wrapper's
    plan: two tiles where they fit, else one tile with the
    cotangent parked (S >= 7 at width 256); every stream count fits a CTA
    and the wrapper takes it."""
    dims = [w] * 5
    two_tiles = (2 * S * w * 16 + J.GB_STAGES * 16 * w) * 4
    parks = two_tiles > J.SMEM_LIMIT
    assert J.bwd_parks(S, dims) is parks
    assert parks is (w == 256 and S >= 7)
    need = two_tiles - parks * S * w * 16 * 4
    assert J.bwd_smem(S, dims) == need <= J.SMEM_LIMIT
    assert J.kernels_take(S, dims, gated=True) and max(need, J.fwd_smem(S, dims)) <= J.SMEM_LIMIT
    idx = _index_of(S)
    t = [torch.zeros(2, w)] * S
    args = (t, t, t, [torch.zeros(w, w)] * 4, [torch.zeros(w)] * 4, (), G.modified_mlp_program(4), idx)
    assert G._gated_dims(*args) == dims


def _mlp_5x50_solver():
    """The Allen-Cahn solver with cylinder2d's MLP 5x50 (bench.py:165) on a
    small batch, pinned to jet_pallas_full."""
    from paddlescience_torch.examples.allen_cahn import build_solver

    return build_solver(num_layers=5, hidden_size=50, batch_size=64, ic_points=32, fourier_dim=16,
                        deriv="jet_pallas_full", device="cpu")


# jet_pallas_full with the lane gate at its default: layers narrower than 128 take the plain jet path
LANE_GATED = {**tpath.CANDIDATES["jet_pallas_full"], "PSCI_JET_PALLAS_MIN_LANES": "128"}


def test_refused_widths_send_no_segment_to_the_kernels(monkeypatch):
    """Only the lane gate, as in the JAX package, sends layers to the plain
    jet path: where it holds (128 lanes), MLP 5x50 gets no fused segment
    and forward_jet never calls the segment function; under
    jet_pallas_full, which lifts it, its 5 layers go to the kernels as one
    segment, zero-padded to width 52."""
    from paddlescience_torch.arch.mlp import MLP
    from paddlescience_torch.autodiff import path as tpath

    saved = tpath.get_default()
    real = J.jet_mlp_segment
    calls = []
    try:
        tpath.set_default(LANE_GATED)
        model = MLP(("t", "x", "y"), ("u", "v", "p"), 5, 50, device="cpu")
        assert model.jet_segment_lengths() == []
        monkeypatch.setattr(J, "jet_mlp_segment", lambda *a, **k: 1 / 0)
        out = model.forward_jet(tjet.seed(torch.rand(8, 3), tjet.build_index([(0,), (1,), (1, 1)])))
        assert len(out.streams) == 4 and tuple(out.streams[0].shape) == (8, 3)
        tpath.set_default(tpath.CANDIDATES["jet_pallas_full"])
        assert model.jet_segment_lengths() == [5]
        with pytest.raises(ZeroDivisionError):
            model.forward_jet(tjet.seed(torch.rand(8, 3), tjet.build_index([(0,)])))
        monkeypatch.setattr(J, "jet_mlp_segment", lambda *a, **k: calls.append(a[1]) or real(*a, **k))
        monkeypatch.setattr(J, "jet_mlp_fwd", lambda s, w, *a, **k: calls.append(w) or J.jet_mlp_fwd_plain(s, w, *a))
        out = model.forward_jet(tjet.seed(torch.rand(8, 3), tjet.build_index([(0,), (1,), (1, 1)])))
        assert tuple(out.streams[3].shape) == (8, 3)
        assert [tuple(w.shape) for w in calls[0]] == [(3, 50)] + [(50, 50)] * 4  # the model's layers
        assert [tuple(w.shape) for w in calls[1]] == [(3, 52)] + [(52, 52)] * 4  # what the kernel gets
    finally:
        tpath.set_default(saved)


def test_refused_widths_train_on_the_plain_jet_path():
    """Where the lane gate holds, MLP 5x50 takes a train step on the plain
    jet path, and on one batch its PDE loss and every parameter gradient
    equal the jet path's bitwise."""
    from paddlescience_torch.autodiff import path as tpath

    saved = tpath.get_default()
    try:
        solver = _mlp_5x50_solver()
        batches = solver._batches()
        results = {}
        for flags in (LANE_GATED, tpath.CANDIDATES["jet"]):
            tpath.set_default(flags)
            losses = solver._constraint_losses(batches)
            results[len(results)] = (losses["PDE"].detach(), torch.autograd.grad(losses["PDE"], solver._params()))
        (lk, gk), (lp, gp) = results[0], results[1]
        assert torch.equal(lk, lp) and all(torch.equal(a, b) for a, b in zip(gk, gp))
        assert any(float(g.abs().max()) > 0 for g in gp)
        tpath.set_default(LANE_GATED)
        logs = solver.train_steps(2)
        assert all(np.isfinite(entry["loss"]) for entry in logs)
    finally:
        tpath.set_default(saved)


def test_padded_widths_train_through_the_segments():
    """Under jet_pallas_full MLP 5x50 trains through its padded segment
    (the kernels' plain versions here): on one batch its PDE loss and
    every parameter gradient agree with the plain jet path's, and two train
    steps give finite losses."""
    from paddlescience_torch.autodiff import path as tpath

    saved = tpath.get_default()
    try:
        solver = _mlp_5x50_solver()
        batches = solver._batches()
        results = {}
        for deriv in ("jet_pallas_full", "jet"):
            tpath.set_default(tpath.CANDIDATES[deriv])
            J.reset_counters()
            losses = solver._constraint_losses(batches)
            results[deriv] = (losses["PDE"].detach(), torch.autograd.grad(losses["PDE"], solver._params()))
        (lk, gk), (lp, gp) = results["jet_pallas_full"], results["jet"]
        _close(lk, lp, 1e-5)
        assert len(gk) == len(gp) and any(float(g.abs().max()) > 0 for g in gp)
        for a, b in zip(gk, gp):
            _close(a, b)
        tpath.set_default(tpath.CANDIDATES["jet_pallas_full"])
        logs = solver.train_steps(2)
        assert all(np.isfinite(entry["loss"]) for entry in logs)
    finally:
        tpath.set_default(saved)


PADDED = {  # program (None: the ungated jet_mlp_segment), width, first input width
    "mlp_segment": (None, 10, 5),
    "mlp_segment_narrow_in": (None, 6, 3),
    "piratenet_2": (G.piratenet_program(2), 10, None),
    "modified_mlp_3": (G.modified_mlp_program(3), 50, 5),
    "mlp_program_2": (G.mlp_program(2), 10, 3),
}


def _padded_case(case, multis, n, dtype, seed=3):
    """Inputs of a segment whose widths are no multiple of 4, as leaves."""
    program, w, k_in = PADDED[case]
    if program is None:
        arrs = _case(multis, 3, n=n, w=w, seed=seed, k_in=k_in)
        return program, [[torch.from_numpy(a.astype(dtype)) for a in part] for part in arrs]
    arrs = _gated_case(multis, program, n=n, w=w, seed=seed, dtype=dtype, k_in=k_in)
    return program, [[torch.from_numpy(a) for a in part] for part in arrs]


def _padded_run(program, parts, idx, device):
    """(output streams, cotangent leaves) of the padded segment, and the
    same of autograd through the unpadded plain forward."""
    runs = []
    for padded in (True, False):
        leaves = [[t.to(device).requires_grad_() for t in part] for part in parts[:-1]]
        g_out = [t.to(device) for t in parts[-1]]
        if program is None:
            ss, ws, bs = leaves
            outs = (J.jet_mlp_segment(tjet.Jet(ss, idx), ws, bs).streams if padded
                    else J.jet_mlp_fwd_plain(ss, ws, bs, idx)[0])
        else:
            y, u, v, ws, bs, al = leaves
            if not G._has_gates(program):
                leaves[1:3] = [[], []]
            outs = (G.jet_gated_segment(tjet.Jet(y, idx), tjet.Jet(u, idx), tjet.Jet(v, idx), ws, bs, al,
                                        program).streams if padded
                    else G.jet_gated_fwd_plain(y, u, v, ws, bs, al, program, idx)[0])
        flat = [t for part in leaves for t in part]
        grads = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, g_out)), flat)
        runs.append(([o.detach() for o in outs], grads))
    return runs


@pytest.mark.parametrize("multis", INDICES + [[]])
@pytest.mark.parametrize("case", list(PADDED))
def test_padded_segments_match_autograd(case, multis):
    """A segment whose widths are no multiple of 4 runs zero-padded: its
    outputs and the gradients of every input, weight, bias and alpha are
    those of the unpadded layers (autograd through the plain forward, in
    float64)."""
    idx = tjet.build_index(multis)
    program, parts = _padded_case(case, multis, 29, np.float64)
    (outs, grads), (r_outs, r_grads) = _padded_run(program, parts, idx, "cpu")
    assert [tuple(o.shape) for o in outs] == [tuple(o.shape) for o in r_outs]
    for a, b in zip([*outs, *grads], [*r_outs, *r_grads]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


WGRAD_SHAPES = {  # (dims, S, N)
    "allen_cahn_L4": ((256,) * 5, 4, 4096),
    "piratenet_27_layers": ((256,) * 28, 4, 4096),
    "aneurysm": ((3,) + (512,) * 6, 7, 2048),
    "ragged_N4095": ((256,) * 5, 4, 4095),
    "ragged_N70": ((24,) * 4, 3, 70),
    "K3_D24": ((3, 24, 24), 3, 70),
}


def _wgrad_units(dims, S, N, plan):
    """jet_wgrad's work units in launch order, as the kernel derives them
    from the plan: (layer, first dW row, tile height, first dW column,
    first batch row, end batch row, adds db)."""
    units = []
    for l in range(len(dims) - 1):
        K, D = dims[l], dims[l + 1]
        tk, td = J.wgrad_tiles(K, D)
        height = J.WG_NARROW if K <= J.WG_NARROW else J.WG_T
        for q in range(plan.splits[l]):
            r0 = q * plan.rows[l]
            for t in range(tk * td):
                k0 = (t // td) * J.WG_T
                units.append((l, k0, height, (t % td) * J.WG_T, r0, min(S * N, r0 + plan.rows[l]), k0 == 0 and r0 < N))
    return units


def _contiguous(ranges, end):
    ranges = sorted(ranges)
    return ranges[0][0] == 0 and ranges[-1][1] == end and all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("shape", list(WGRAD_SHAPES))
def test_wgrad_plan_covers_every_output_and_row_once(shape):
    """jet_wgrad's work units on an H100 (132 SMs, 2 CTAs each): the tiles
    of each layer cover its dW once, each tile's row ranges cover the S*N
    rows once, the units that add db cover the N rows of stream 0 once per
    column; a layer of <= 8 inputs takes 8-row tiles; the last wave leaves
    at most 10% of the slots empty, or the launch is one wave of units that
    cannot be cut finer."""
    dims, S, N = WGRAD_SHAPES[shape]
    plan = J.wgrad_plan(dims, S, N, 132 * 2)
    units = _wgrad_units(dims, S, N, plan)
    assert len(units) == plan.units
    for l in range(len(dims) - 1):
        K, D = dims[l], dims[l + 1]
        mine = [u for u in units if u[0] == l]
        cover = np.zeros((K, D), np.int64)
        rows = {}
        for _, k0, height, c0, r0, r1, _ in mine:
            assert height == (J.WG_NARROW if K <= J.WG_NARROW else J.WG_T)
            rows.setdefault((k0, c0), []).append((r0, r1))
        for (k0, c0), ranges in rows.items():
            cover[k0 : k0 + J.WG_T, c0 : c0 + J.WG_T] += 1
            assert _contiguous(ranges, S * N), (l, k0, c0)
        assert (cover == 1).all()
        for c0 in range(0, D, J.WG_T):
            bias = [(r0, min(r1, N)) for _, _, _, c, r0, r1, b in mine if b and c == c0]
            assert _contiguous(bias, N), (l, c0)
    cost = max(r * (J.WG_NARROW_COST if k <= J.WG_NARROW else 1) for r, k in zip(plan.rows, dims))
    assert plan.tail <= 0.1 or (plan.waves == 1 and cost == J.WG_RC), (plan, plan.tail)


def test_wgrad_takes_plain_versions_only_on_cpu():
    """jet_wgrad with alpha_partials on CPU tensors is jet_wgrad_plain plus
    jet_alpha_reduce_plain and launches nothing; on a tensor that is neither
    on the CPU nor on CUDA it raises."""
    rng = np.random.default_rng(3)
    ys = [[torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32)) for _ in range(2)]]
    gzs = [torch.from_numpy(rng.standard_normal((2, 6, 8)).astype(np.float32))]
    partials = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    J.reset_counters()
    dws, dbs, d_alpha = J.jet_wgrad(ys, gzs, alpha_partials=partials)
    ref_dw, ref_db = J.jet_wgrad_plain(ys, gzs)
    torch.testing.assert_close(dws[0], ref_dw[0], rtol=0, atol=0)
    torch.testing.assert_close(dbs[0], ref_db[0], rtol=0, atol=0)
    torch.testing.assert_close(d_alpha, J.jet_alpha_reduce_plain(partials), rtol=0, atol=0)
    assert len(J.jet_wgrad(ys, gzs)) == 2
    assert J.jet_wgrad.launches == 0 and J.jet_wgrad_plain.cuda_calls == 0
    meta = [[torch.empty(6, 5, device="meta")] * 2]
    with pytest.raises(ValueError, match="CUDA"):
        J.jet_wgrad(meta, [torch.empty(2, 6, 8, device="meta")], alpha_partials=torch.empty(4, 3, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


NS3D = [(0,), (1,), (2,), (0, 0), (1, 1), (2, 2)]
SEGMENT_SHAPES = [(multis, n, L, w, None) for multis in INDICES
                  for n, L, w in [(4096, 4, 256), (4096, 3, 256), (4095, 4, 256), (4096, 1, 256), (70, 3, 24)]]
# jet_wgrad's narrow units and 4-byte copies: the aneurysm's 3 -> 512 x 6 at S = 7, input widths of 5 and
# 3, batches that are not a multiple of the 32 staged rows
SEGMENT_SHAPES += [(NS3D, 2048, 6, 512, 3), (NS3D, 2047, 2, 512, 3), (INDICES[0], 1000, 2, 64, 5),
                   (INDICES[1], 4095, 3, 256, 3)]
# jet_mlp_bwd at width 512: S = 8 (the aneurysm's unsteady jet; one tile, the cotangent parked) and S = 5
# (two 8-row tiles), at batches that are not a multiple of the 8-row tile
S5 = [(0,), (1,), (0, 0), (1, 1)]
SEGMENT_SHAPES += [(NS3D + [(0, 1)], 2045, 3, 512, 3), (S5, 1001, 3, 512, 3), (S5, 2046, 2, 512, None)]


def _order2(d, S):
    """The first S - 1 multi-indices of order 1 and 2 of d inputs."""
    return ([(i,) for i in range(d)] + [(i, j) for i in range(d) for j in range(i, d)])[: S - 1]


# more than 8 streams (the halves kernels): heart's 3-D Hooke jet (S = 10) on 3 -> 256 x 6 with a ragged
# batch, S = 9; S = 15 and 16 at width 256 (8-row tiles); aneurysm_flow's width 128 at S = 10; 16 streams
# at 16-row tiles (width 64); a wide 8-row tile (width 300, S = 13)
HEART = _order2(3, 10)
SEGMENT_SHAPES += [(HEART, 1024, 6, 256, 3), (HEART, 1023, 6, 256, 3), (_order2(3, 9), 1023, 3, 256, 3),
                   (_order2(4, 15), 4096, 3, 256, 4), (_order2(5, 16), 4096, 3, 256, 5),
                   (HEART, 2048, 5, 128, 3), (_order2(5, 16), 1001, 2, 64, 5), (_order2(4, 13), 1003, 2, 300, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("multis,n,L,w,k_in", SEGMENT_SHAPES)
def test_kernels_match_plain_versions_on_gpu(cuda_device, multis, n, L, w, k_in):
    idx = tjet.build_index(multis)
    streams, weights, biases, cot = _case(multis, L, n=n, w=w, k_in=k_in)
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


BITWISE = {  # multis, n, L, w, k_in, act
    "aneurysm": (NS3D, 2047, 6, 512, 3, (tjet.SILU, 0.0)),
    "mlp_4x256": (INDICES[0], 4095, 4, 256, None, J.TANH),
    "heart_S10": (HEART, 1023, 6, 256, 3, J.TANH),
    "S16_w256": (_order2(5, 16), 4095, 3, 256, 5, J.TANH),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(BITWISE))
def test_mlp_bwd_is_bitwise_repeatable_on_gpu(cuda_device, shape):
    """Two jet_mlp_bwd calls on the same inputs give bitwise the same input
    cotangents and gz: no atomics, a fixed summation order. The aneurysm's
    3 -> 512 x 6 at S = 7 (8-row tiles, the cotangent parked; SiLU), the
    Allen-Cahn MLP 4x256 at S = 4 (two 16-row tiles; tanh), heart's 3 ->
    256 x 6 at S = 10 and 16 streams at width 256 (the halves kernel)."""
    multis, n, L, w, k_in, act = BITWISE[shape]
    idx = tjet.build_index(multis)
    ss, ws, bs, gs = ([torch.from_numpy(a).to(cuda_device) for a in arrs]
                      for arrs in _case(multis, L, n=n, w=w, k_in=k_in))
    _, bounds = J.jet_mlp_fwd(ss, ws, bs, idx, save_bounds=True, act=act)
    first = J.jet_mlp_bwd(ss, bounds, ws, bs, gs, idx, act)
    second = J.jet_mlp_bwd(ss, bounds, ws, bs, gs, idx, act)
    torch.cuda.synchronize()
    for a, b in zip([*first[0], *first[1]], [*second[0], *second[1]]):
        assert torch.equal(a, b)


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


# ------------------------------------------------- gated layer programs --

PROGRAMS = {
    "piratenet_2": G.piratenet_program(2),
    "modified_mlp_3": G.modified_mlp_program(3),
    "mlp_2": G.mlp_program(2),
    "block_then_gated_layer": G.piratenet_program(1) + G.modified_mlp_program(1),
}


def _gated_case(multis, program, n=37, w=12, seed=2, dtype=np.float32, k_in=None):
    """numpy inputs of a gated segment: y streams (n, k_in), u, v streams
    (n, w), layers k_in -> w -> ... -> w (k_in = w unless given), biases,
    alphas drawn in (0.1, 0.9) (alpha = 0 would zero every block gradient),
    output cotangents."""
    rng = np.random.default_rng(seed)
    S, L = len(tjet.build_index(multis)), len(program)
    draw = lambda *shape: rng.standard_normal(shape).astype(dtype)
    y = [draw(n, k_in or w) for _ in range(S)]
    u, v, cot = ([draw(n, w) for _ in range(S)] for _ in range(3))
    weights = [(draw(k_in or w if l == 0 else w, w) / np.sqrt(k_in or w if l == 0 else w)).astype(dtype)
               for l in range(L)]
    biases = [(0.1 * draw(w)).astype(dtype) for _ in range(L)]
    alphas = [rng.uniform(0.1, 0.9, (1,)).astype(dtype) for op in program if op & G.RESIDUAL]
    return y, u, v, weights, biases, alphas, cot


@pytest.mark.parametrize("multis", INDICES + [[(1,)], []])
@pytest.mark.parametrize("program", list(PROGRAMS))
@pytest.mark.parametrize("save_bounds", [False, True])
def test_gated_hand_derived_backward_matches_autograd(multis, program, save_bounds):
    """jet_gated_bwd_plain + jet_wgrad_plain + the alpha sum (through the
    autograd.Function) against torch.autograd through the plain forward, in
    float64: cotangents of the y, u and v streams, dW, db and d alpha."""
    prog = PROGRAMS[program]
    idx = tjet.build_index(multis)
    arrs = _gated_case(multis, prog, dtype=np.float64)
    y, u, v, ws, bs, al = ([torch.from_numpy(a).requires_grad_() for a in part] for part in arrs[:6])
    g_out = [torch.from_numpy(c) for c in arrs[6]]
    leaves = y + ws + bs + al + (u + v if G._has_gates(prog) else [])
    outs, _ = G.jet_gated_fwd_plain(y, u, v, ws, bs, al, prog, idx)
    ref = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, g_out)), leaves)
    out = G.jet_gated_segment(tjet.Jet(y, idx), tjet.Jet(u, idx), tjet.Jet(v, idx), ws, bs, al, prog,
                              save_bounds=save_bounds)
    got = torch.autograd.grad(sum((o * g).sum() for o, g in zip(out.streams, g_out)), leaves)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


def test_ungated_program_is_the_mlp_segment():
    """The program table with no gate and no residual computes what
    ops/jet_mlp.py computes."""
    multis = INDICES[0]
    idx = tjet.build_index(multis)
    y, _, _, ws, bs, _, cot = ([torch.from_numpy(a) for a in part] for part in _gated_case(multis, G.mlp_program(3)))
    ref_outs, ref_bounds = J.jet_mlp_fwd_plain(y, ws, bs, idx, save_bounds=True)
    outs, bounds = G.jet_gated_fwd_plain(y, (), (), ws, bs, (), G.mlp_program(3), idx, save_bounds=True)
    for a, b in zip([*outs, *bounds], [*ref_outs, *ref_bounds]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ref_gin, ref_gz = J.jet_mlp_bwd_plain(y, ref_bounds, ws, bs, cot, idx)
    g_y, g_u, g_v, gzs, ins, d_alpha = G.jet_gated_bwd_plain(y, (), (), bounds, ws, bs, (), cot, G.mlp_program(3), idx)
    assert g_u == () and g_v == () and d_alpha.numel() == 0 and len(ins) == 3
    for a, b in zip([*g_y, *gzs], [*ref_gin, *ref_gz]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gated_save_bounds_are_the_stage_inputs():
    """PirateNet saves one boundary per block, ModifiedMLP one per layer;
    the backward's layer inputs are the boundaries plus what it recomputes."""
    multis = INDICES[0]
    idx = tjet.build_index(multis)
    S = len(idx)
    for prog, n_bounds in ((G.piratenet_program(3), 2), (G.modified_mlp_program(3), 2)):
        y, u, v, ws, bs, al, cot = ([torch.from_numpy(a) for a in part] for part in _gated_case(multis, prog, n=9, w=8))
        outs, bounds = G.jet_gated_fwd_plain(y, u, v, ws, bs, al, prog, idx, save_bounds=True)
        assert len(bounds) == n_bounds and tuple(bounds[0].shape) == (S, 9, 8)
        stage = len(prog) // 3
        first, _ = G.jet_gated_fwd_plain(y, u, v, ws[:stage], bs[:stage], al[:1], prog[:stage], idx)
        torch.testing.assert_close(bounds[0], torch.stack(first))
        *_, ins, _ = G.jet_gated_bwd_plain(y, u, v, bounds, ws, bs, al, cot, prog, idx)
        assert len(ins) == len(prog)
        torch.testing.assert_close(torch.stack(ins[stage]), bounds[0])


@pytest.mark.parametrize("program,message", [
    ((G.GATE, G.STAGE), "starts with a STAGE"),
    ((G.STAGE | G.RESIDUAL, G.GATE), "residual closes its stage"),
    ((G.STAGE | G.GATE | G.RESIDUAL,), "residual closes its stage"),
])
def test_invalid_programs_are_refused(program, message):
    idx = tjet.build_index([(0,)])
    t = [torch.zeros(4, 8) for _ in range(2)]
    w, b = [torch.zeros(8, 8)] * len(program), [torch.zeros(8)] * len(program)
    with pytest.raises(ValueError, match=message):
        G.jet_gated_fwd(t, t, t, w, b, [torch.zeros(1)], program, idx)


def test_gated_wrappers_take_plain_versions_only_on_cpu():
    idx = tjet.build_index([(0,)])
    meta = [torch.empty(4, 8, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA"):
        G.jet_gated_fwd(meta, meta, meta, [torch.empty(8, 8, device="meta")], [torch.empty(8, device="meta")],
                        (), G.modified_mlp_program(1), idx)
    with pytest.raises(ValueError, match="CUDA"):
        J.jet_wgrad([meta], [torch.empty(2, 4, 8, device="meta")], alpha_partials=torch.empty(4, 2, device="meta"))
    G.reset_counters()
    J.reset_counters()
    cpu = [torch.randn(4, 8) for _ in range(2)]
    G.jet_gated_fwd(cpu, cpu, cpu, [torch.randn(8, 8)], [torch.randn(8)], (), G.modified_mlp_program(1), idx)
    *_, d_alpha = J.jet_wgrad([cpu], [torch.randn(2, 4, 8)], alpha_partials=torch.ones(5, 2))
    torch.testing.assert_close(d_alpha, torch.full((2,), 5.0))
    assert G.jet_gated_fwd.launches == 0 and J.jet_wgrad.launches == 0
    assert G.jet_gated_fwd_plain.cuda_calls == 0


def _alpha_tol(ref, n_terms):
    """d alpha sums ``n_terms`` signed products of order 1 that largely
    cancel: the limit is RTOL times the larger of the result and the size
    such a sum has by chance, sqrt(n_terms)."""
    return RTOL * max(float(ref.abs().max()), float(n_terms) ** 0.5)


S6 = [(0,), (1,), (0, 0), (1, 1), (0, 1)]  # 6 streams: the shared-memory edge of the gated backward at 256
BARE_PIRATENET_3 = tuple(op & G.STAGE for op in G.piratenet_program(3))  # its stages, no gate, no residual
GATED_SHAPES = [(multis, program, n, w, None) for multis in INDICES for program, n, w in [
    (G.piratenet_program(3), 4096, 256), (G.piratenet_program(9), 4096, 256), (G.piratenet_program(3), 4095, 256),
    (G.modified_mlp_program(3), 4096, 256), (G.modified_mlp_program(1), 4095, 256),
    (G.piratenet_program(2), 70, 24), (G.piratenet_program(1) + G.modified_mlp_program(1), 70, 24),
]]
GATED_SHAPES += [
    (S6, G.piratenet_program(3), 1001, 256, None), (S6, G.modified_mlp_program(2), 4096, 256, None),
    (INDICES[0], G.piratenet_program(2), 1001, 64, None),          # N not a multiple of the 16-row tile
    (INDICES[0], G.modified_mlp_program(3), 1001, 256, 3),         # a narrow first input
    (INDICES[1], G.modified_mlp_program(2), 70, 24, 5),
    (INDICES[0], BARE_PIRATENET_3, 4095, 256, None), (INDICES[1], G.mlp_program(3), 70, 24, 5),
    (INDICES[1], G.modified_mlp_program(4), 1001, 256, None),      # the ModifiedMLP program of the GPU run
    (NS3D, G.piratenet_program(3), 1001, 256, None),                # S = 7 at 256: one tile, the cotangent parked
    (NS3D + [(0, 1)], G.modified_mlp_program(2), 1001, 256, 5),     # S = 8, parked, a narrow first input
    (NS3D + [(0, 1)], G.piratenet_program(2), 1001, 64, None),      # S = 8 narrow: two tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("multis,program,n,w,k_in", GATED_SHAPES)
def test_gated_kernels_match_plain_versions_on_gpu(cuda_device, multis, program, n, w, k_in):
    idx = tjet.build_index(multis)
    y, u, v, ws, bs, al, gs = ([torch.from_numpy(a).to(cuda_device) for a in part]
                               for part in _gated_case(multis, program, n=n, w=w, k_in=k_in))
    if not G._has_gates(program):
        u = v = []
    G.reset_counters()
    J.reset_counters()
    outs, _ = G.jet_gated_fwd(y, u, v, ws, bs, al, program, idx)
    outs_sb, bounds = G.jet_gated_fwd(y, u, v, ws, bs, al, program, idx, save_bounds=True)
    r_outs, r_bounds = G.jet_gated_fwd_plain(y, u, v, ws, bs, al, program, idx, save_bounds=True)
    g_y, g_u, g_v, gzs, ins, part = G.jet_gated_bwd(y, u, v, r_bounds, ws, bs, al, gs, program, idx)
    r_gy, r_gu, r_gv, r_gzs, r_ins, r_da = G.jet_gated_bwd_plain(y, u, v, r_bounds, ws, bs, al, gs, program, idx)
    dws, dbs, d_alpha = J.jet_wgrad(ins, gzs, alpha_partials=part)
    r_dws, r_dbs = J.jet_wgrad_plain(r_ins, r_gzs)
    torch.cuda.synchronize()
    assert (G.jet_gated_fwd.launches, G.jet_gated_bwd.launches, J.jet_wgrad.launches) == (2, 1, 1)
    assert tuple(d_alpha.shape) == (len(al),) and len(g_u) == len(r_gu) and len(g_v) == len(r_gv)
    case = dict(y=y, u=u, v=v, ws=ws, bs=bs, alphas=al, g_out=gs, bounds=r_bounds)
    ref = {"out": r_outs, "bound": r_bounds, "g_y": r_gy, "g_u": r_gu, "g_v": r_gv, "gz": r_gzs, "in": r_ins}
    for fwd_outs in (outs, outs_sb):
        got = {"out": fwd_outs, "bound": bounds, "g_y": g_y, "g_u": g_u, "g_v": g_v, "gz": gzs, "in": ins}
        _gated_kink_aware_close(case, got, ref, program, idx, J.TANH)
    for got, ref in zip([*dws, *dbs], [*r_dws, *r_dbs]):
        _close(got, ref)
    if al:
        assert float((d_alpha - r_da).abs().max()) <= _alpha_tol(r_da, n * w * len(idx))


def _tensors(out):
    """The tensors of a nest of tuples, in order."""
    return [out] if isinstance(out, torch.Tensor) else [t for part in out for t in _tensors(part)]


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["piratenet_9", "modified_mlp_4"])
def test_gated_bwd_is_bitwise_repeatable_on_gpu(cuda_device, program):
    """Two jet_gated_bwd calls on the same inputs give bitwise the same
    outputs, every one of them: no atomics, a fixed summation order."""
    program = G.piratenet_program(9) if program == "piratenet_9" else G.modified_mlp_program(4)
    idx = tjet.build_index(INDICES[0])
    y, u, v, ws, bs, al, gs = ([torch.from_numpy(a).to(cuda_device) for a in part]
                               for part in _gated_case(INDICES[0], program, n=4095, w=256))
    _, bounds = G.jet_gated_fwd(y, u, v, ws, bs, al, program, idx, save_bounds=True)
    first = _tensors(G.jet_gated_bwd(y, u, v, bounds, ws, bs, al, gs, program, idx))
    second = _tensors(G.jet_gated_bwd(y, u, v, bounds, ws, bs, al, gs, program, idx))
    torch.cuda.synchronize()
    assert len(first) == len(second) > 0
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_padded_widths_train_on_gpu_through_the_kernels(cuda_device):
    """MLP 5x50 under jet_pallas_full trains on the card through the
    ungated kernels (width 50 padded to 52): no error, every step launches
    them, none of the plain versions runs."""
    from paddlescience_torch.autodiff import path as tpath
    from paddlescience_torch.examples.allen_cahn import build_solver

    saved = tpath.get_default()
    try:
        solver = build_solver(num_layers=5, hidden_size=50, batch_size=1024, deriv="jet_pallas_full",
                              device=cuda_device)
        J.reset_counters()
        G.reset_counters()
        logs = solver.train_steps(2)
        torch.cuda.synchronize()
        assert all(np.isfinite(entry["loss"]) for entry in logs)
        assert J.jet_mlp_fwd.launches >= 2 and J.jet_mlp_bwd.launches >= 2 and J.jet_wgrad.launches >= 2
        assert J.jet_mlp_fwd_plain.cuda_calls == J.jet_mlp_bwd_plain.cuda_calls == 0
    finally:
        tpath.set_default(saved)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PADDED))
def test_padded_segments_on_gpu(cuda_device, case):
    """Segments whose widths are no multiple of 4, zero-padded onto the
    kernels, against autograd through the unpadded plain forward on the
    card."""
    multis = INDICES[1]
    idx = tjet.build_index(multis)
    program, parts = _padded_case(case, multis, 1001, np.float32)
    J.reset_counters()
    G.reset_counters()
    (outs, grads), (r_outs, r_grads) = _padded_run(program, parts, idx, cuda_device)
    torch.cuda.synchronize()
    assert (J.jet_mlp_fwd.launches if program is None else G.jet_gated_fwd.launches) >= 1
    n_alpha = len(parts[5]) if program is not None else 0
    for a, b in zip([*outs, *grads[: len(grads) - n_alpha]], [*r_outs, *r_grads[: len(r_grads) - n_alpha]]):
        _close(a, b)
    for a, b in zip(grads[len(grads) - n_alpha:], r_grads[len(r_grads) - n_alpha:]):
        assert float((a - b).abs()) <= _alpha_tol(b, 1001 * PADDED[case][1] * len(idx))


@pytest.mark.cuda
@pytest.mark.parametrize("save_bounds", [False, True])
@pytest.mark.parametrize("program", ["piratenet_2", "modified_mlp_3"])
def test_gated_segment_gradients_on_gpu(cuda_device, program, save_bounds):
    """The gated autograd.Function on the card against autograd through the
    plain forward: y, u, v cotangents, dW, db, d alpha."""
    prog = PROGRAMS[program]
    multis = INDICES[1]
    idx = tjet.build_index(multis)
    arrs = _gated_case(multis, prog, n=1000, w=64)
    leaves = lambda: [[torch.from_numpy(a).to(cuda_device).requires_grad_() for a in part] for part in arrs[:6]]
    gs = [torch.from_numpy(c).to(cuda_device) for c in arrs[6]]
    y, u, v, ws, bs, al = leaves()
    outs, _ = G.jet_gated_fwd_plain(y, u, v, ws, bs, al, prog, idx)
    ref = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, gs)), y + u + v + ws + bs + al)
    y, u, v, ws, bs, al = leaves()
    out = G.jet_gated_segment(tjet.Jet(y, idx), tjet.Jet(u, idx), tjet.Jet(v, idx), ws, bs, al, prog,
                              save_bounds=save_bounds)
    got = torch.autograd.grad(sum((o * g).sum() for o, g in zip(out.streams, gs)), y + u + v + ws + bs + al)
    n_alpha = len(al)
    for a, b in zip(got[: len(got) - n_alpha], ref):
        _close(a, b)
    for a, b in zip(got[len(got) - n_alpha:], ref[len(ref) - n_alpha:]):
        assert float((a - b).abs()) <= _alpha_tol(b, 1000 * 64 * len(idx))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["piratenet_3_blocks", "aneurysm", "heart_S10", "S16_w256"])
def test_wgrad_is_bitwise_repeatable_on_gpu(cuda_device, shape):
    """Two jet_wgrad calls on the same inputs give bitwise the same dW, db
    and d alpha: a fixed summation order, no atomics (also at 10 and 16
    streams)."""
    if shape != "piratenet_3_blocks":
        multis, n, L, w, k_in, _ = BITWISE[shape]
        streams, weights, biases, cot = _case(multis, L, n=n, w=w, k_in=k_in)
        idx = tjet.build_index(multis)
        ss, ws, bs, gs = ([torch.from_numpy(a).to(cuda_device) for a in arrs] for arrs in (streams, weights, biases, cot))
        _, bounds = J.jet_mlp_fwd(ss, ws, bs, idx, save_bounds=True)
        _, gzs = J.jet_mlp_bwd(ss, bounds, ws, bs, gs, idx)
        ins, part = [ss] + [b.unbind(0) for b in bounds], torch.randn(128, 0, device=cuda_device)
    else:
        program = G.piratenet_program(3)
        idx = tjet.build_index(INDICES[0])
        y, u, v, ws, bs, al, gs = ([torch.from_numpy(a).to(cuda_device) for a in part]
                                   for part in _gated_case(INDICES[0], program, n=4096, w=256))
        _, bounds = G.jet_gated_fwd(y, u, v, ws, bs, al, program, idx, save_bounds=True)
        *_, gzs, ins, part = G.jet_gated_bwd(y, u, v, bounds, ws, bs, al, gs, program, idx)
    first = J.jet_wgrad(ins, gzs, alpha_partials=part)
    second = J.jet_wgrad(ins, gzs, alpha_partials=part)
    torch.cuda.synchronize()
    for a, b in zip([*first[0], *first[1], first[2]], [*second[0], *second[1], second[2]]):
        assert torch.equal(a, b)


ACTS = [(i, 1.7 if i == tjet.SIREN else 0.0) for i in sorted(tjet.ACT_RULES)]
KINKS = K.KINKS  # the relu family: activations whose derivatives jump, at these pre-activations


def _kink_aware_close(ss, ws, bs, gs, r_bounds, act, got, ref):
    """The MLP kernels' outputs ``got`` = (outs, bounds, g_in, gzs) against
    the plain version's ``ref`` for an activation with kinks
    (``ops/kinks.py``, the MLP segment as ``mlp_program(L)``): rows whose
    pre-activations lie within float32 rounding of a kink (at most
    MAX_KINK_SHARE of them) must equal, within the usual limit, the float64
    plain rule with those elements on one side or the other, in some
    combination; every other row the plain version within the usual limit.
    Forward outputs go by the forward's kinks (its own chain), backward
    outputs by the backward's (its layer inputs are ``r_bounds``)."""
    case = dict(y=ss, u=[], v=[], ws=ws, bs=bs, alphas=[], g_out=gs, bounds=r_bounds)
    names = ("out", "bound", "g_y", "gz")
    K.kink_aware_close(case, dict(zip(names, got)), dict(zip(names, ref)), G.mlp_program(len(ws)),
                       tjet.build_index(INDICES[0]), act, RTOL)


def _gated_kink_aware_close(case, got, ref, program, idx, act):
    """The gated kernels' outputs against the plain version's with the same
    either-side rule at kinks, over the layer program (gates v + y (u - v)
    and residuals included): ``got``/``ref`` hold any of "out", "bound",
    "g_y", "g_u", "g_v", "gz", "in"; ``case`` the inputs (y, u, v, ws, bs,
    alphas, g_out) and the plain forward's boundaries."""
    K.kink_aware_close(case, got, ref, program, idx, act, RTOL)


def test_kink_aware_check_takes_either_side_and_nothing_else():
    """The check of the relu family on the CPU: a "kernel" result that takes
    the other side of a pre-activation exactly at the kink passes, the
    plain result passes, a result off by 1e-3 at a kink row or elsewhere
    fails, and so does a case with too many kinks; the same for a gated
    program (a ModifiedMLP program of 2 layers: a gate after each)."""
    act = (tjet.LEAKY_RELU, 0.0)
    idx = tjet.build_index(INDICES[0])
    ss, ws, bs, gs = (list(map(torch.from_numpy, a)) for a in _case(INDICES[0], 2, n=40, w=16, seed=3))
    ss[0][7] = 0.0  # row 7's first pre-activations are their biases
    bs[0][5] = 0.0  # so (row 7, column 5) of layer 0 is exactly at the kink
    r_outs, r_bounds = J.jet_mlp_fwd_plain(ss, ws, bs, idx, save_bounds=True, act=act)
    r_gin, r_gzs = J.jet_mlp_bwd_plain(ss, r_bounds, ws, bs, gs, idx, act)
    ref = (r_outs, r_bounds, r_gin, r_gzs)
    _kink_aware_close(ss, ws, bs, gs, r_bounds, act, ref, ref)
    case = dict(y=ss, u=[], v=[], ws=ws, bs=bs, alphas=[], g_out=gs, bounds=r_bounds)
    left = K.one_sided(case, G.mlp_program(2), idx, act, 7, {(0, 5): -1}, backward=False)
    flipped = ([o.clone() for o in r_outs], [b.clone() for b in r_bounds], r_gin, r_gzs)
    for s in range(len(ss)):
        flipped[0][s][7] = left["out"][s][0].float()
        flipped[1][0][s][7] = left["bound"][0][s][0].float()
    assert not torch.equal(flipped[0][1], r_outs[1])  # the tangent took the other slope
    _kink_aware_close(ss, ws, bs, gs, r_bounds, act, flipped, ref)
    for row in (7, 8):
        bad = ([o.clone() for o in flipped[0]], *flipped[1:])
        bad[0][1][row] += 1e-3 * float(r_outs[1].abs().max()) * 2
        with pytest.raises(AssertionError):
            _kink_aware_close(ss, ws, bs, gs, r_bounds, act, bad, ref)
    crowded = [s.clone() for s in ss]
    crowded[0][:] = 0.0
    with pytest.raises(AssertionError, match="at a kink"):
        _kink_aware_close(crowded, ws, [b * 0 for b in bs], gs, r_bounds, act, ref, ref)

    # the gated program: (row 7, column 5) of layer 0 at the kink; forward and backward flipped
    prog = G.modified_mlp_program(2)
    y, u, v, gws, gbs, al, ggs = (list(map(torch.from_numpy, part)) for part in _gated_case(INDICES[0], prog, n=40,
                                                                                              w=16, seed=4))
    y[0][7] = 0.0
    gbs[0][5] = 0.0
    g_outs, g_bounds = G.jet_gated_fwd_plain(y, u, v, gws, gbs, al, prog, idx, save_bounds=True, act=act)
    g_y, g_u, g_v, g_gz, g_ins, _ = G.jet_gated_bwd_plain(y, u, v, g_bounds, gws, gbs, al, ggs, prog, idx, act)
    gref = {"out": g_outs, "bound": g_bounds, "g_y": g_y, "g_u": g_u, "g_v": g_v, "gz": g_gz, "in": g_ins}
    gcase = dict(y=y, u=u, v=v, ws=gws, bs=gbs, alphas=al, g_out=ggs, bounds=g_bounds)
    _gated_kink_aware_close(gcase, gref, gref, prog, idx, act)
    fwd = K.one_sided(gcase, prog, idx, act, 7, {(0, 5): -1}, backward=False)
    bwd = K.one_sided(gcase, prog, idx, act, 7, {(0, 5): -1}, backward=True)
    gflip = {k: [t.clone() if isinstance(t, torch.Tensor) else [x.clone() for x in t] for t in val]
             for k, val in gref.items()}
    for s in range(len(y)):
        gflip["out"][s][7] = fwd["out"][s][0].float()
        gflip["bound"][0][s][7] = fwd["bound"][0][s][0].float()
        for key in ("g_y", "g_u", "g_v"):
            gflip[key][s][7] = bwd[key][s][0].float()
        for l in range(len(prog)):
            gflip["gz"][l][s][7] = bwd["gz"][l][s][0].float()
    assert not torch.equal(gflip["out"][1], g_outs[1]) and not torch.equal(gflip["g_u"][0], g_u[0])
    _gated_kink_aware_close(gcase, gflip, gref, prog, idx, act)
    for key, row in (("out", 7), ("g_v", 7), ("out", 8), ("gz", 9)):
        bad = {k: [t.clone() if isinstance(t, torch.Tensor) else [x.clone() for x in t] for t in val]
               for k, val in gflip.items()}
        target = bad[key][1] if key != "gz" else bad[key][1][0]
        target[row] += 2e-3 * float(target.abs().max())
        with pytest.raises(AssertionError):
            _gated_kink_aware_close(gcase, bad, gref, prog, idx, act)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ACTS, ids=lambda a: tjet.ACT_NAMES[a[0]])
def test_every_activation_on_gpu(cuda_device, act):
    """Each activation through the MLP kernels (S=4, W=256, L=2) and the
    gated ones (a ModifiedMLP program of 2 layers). For the relu family
    both kernels' results are held by the either-side check
    (``_kink_aware_close``, ``_gated_kink_aware_close``): at a
    pre-activation within float32 rounding of a kink, the kernel and the
    plain version may rightly take different sides."""
    multis = INDICES[0]
    idx = tjet.build_index(multis)
    dev = lambda arrs: [torch.from_numpy(a).to(cuda_device) for a in arrs]
    ss, ws, bs, gs = (dev(a) for a in _case(multis, 2, n=1000, w=256))
    outs, bounds = J.jet_mlp_fwd(ss, ws, bs, idx, save_bounds=True, act=act)
    r_outs, r_bounds = J.jet_mlp_fwd_plain(ss, ws, bs, idx, save_bounds=True, act=act)
    g_in, gzs = J.jet_mlp_bwd(ss, r_bounds, ws, bs, gs, idx, act)
    r_gin, r_gzs = J.jet_mlp_bwd_plain(ss, r_bounds, ws, bs, gs, idx, act)
    if act[0] in KINKS:
        _kink_aware_close(ss, ws, bs, gs, r_bounds, act, (outs, bounds, g_in, gzs), (r_outs, r_bounds, r_gin, r_gzs))
    else:
        for got, ref in zip([*outs, *bounds, *g_in, *gzs], [*r_outs, *r_bounds, *r_gin, *r_gzs]):
            _close(got, ref)
    prog = G.modified_mlp_program(2)
    y, u, v, ws, bs, al, gs = (dev(part) for part in _gated_case(multis, prog, n=1000, w=256))
    outs, bounds = G.jet_gated_fwd(y, u, v, ws, bs, al, prog, idx, save_bounds=True, act=act)
    r_outs, r_bounds = G.jet_gated_fwd_plain(y, u, v, ws, bs, al, prog, idx, save_bounds=True, act=act)
    got = G.jet_gated_bwd(y, u, v, r_bounds, ws, bs, al, gs, prog, idx, act)
    ref = G.jet_gated_bwd_plain(y, u, v, r_bounds, ws, bs, al, gs, prog, idx, act)
    torch.cuda.synchronize()
    names = ("g_y", "g_u", "g_v", "gz")
    _gated_kink_aware_close(dict(y=y, u=u, v=v, ws=ws, bs=bs, alphas=al, g_out=gs, bounds=r_bounds),
                            {"out": outs, "bound": bounds, **dict(zip(names, got[:4]))},
                            {"out": r_outs, "bound": r_bounds, **dict(zip(names, ref[:4]))}, prog, idx, act)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2048, 2047])
@pytest.mark.parametrize("lengths", [[6], [3, 3]])
def test_aneurysm_segments_on_gpu(cuda_device, n, lengths):
    """The aneurysm MLP's hidden layers (3 -> 512, then 512 -> 512; SiLU;
    S = 7) as one 6-layer segment and as 3 + 3: forward in both modes,
    backward, weight gradients."""
    idx = tjet.build_index(NS3D)
    silu = (tjet.SILU, 0.0)
    rng = np.random.default_rng(5)
    dims = [3] + [512] * 6
    rn = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda_device)
    x = [rn(n, 3) for _ in range(len(idx))]
    weights = [rn(dims[l], dims[l + 1]) / dims[l] ** 0.5 for l in range(6)]
    biases = [0.1 * rn(512) for _ in range(6)]
    s = 0
    for L in lengths:
        ws, bs = weights[s : s + L], biases[s : s + L]
        gs = [rn(n, 512) for _ in range(len(idx))]
        outs, none = J.jet_mlp_fwd(x, ws, bs, idx, act=silu)
        outs_sb, bounds = J.jet_mlp_fwd(x, ws, bs, idx, save_bounds=True, act=silu)
        r_outs, r_bounds = J.jet_mlp_fwd_plain(x, ws, bs, idx, save_bounds=True, act=silu)
        g_in, gzs = J.jet_mlp_bwd(x, r_bounds, ws, bs, gs, idx, silu)
        r_gin, r_gzs = J.jet_mlp_bwd_plain(x, r_bounds, ws, bs, gs, idx, silu)
        ys = [x] + [b.unbind(0) for b in r_bounds]
        dws, dbs = J.jet_wgrad(ys, r_gzs)
        r_dws, r_dbs = J.jet_wgrad_plain(ys, r_gzs)
        torch.cuda.synchronize()
        assert none == () and len(bounds) == L - 1
        for got, ref in zip([*outs, *outs_sb, *bounds, *g_in, *gzs, *dws, *dbs],
                            [*r_outs, *r_outs, *r_bounds, *r_gin, *r_gzs, *r_dws, *r_dbs]):
            _close(got, ref)
        x, s = list(r_outs), s + L


# ------------------------------------------------------------------ LBM --


def _lattice(ny, nx, seed=0):
    rng = np.random.default_rng(seed)
    rho = torch.from_numpy(1.0 + 0.05 * rng.standard_normal((ny, nx))).float()
    ux, uy = (torch.from_numpy(0.05 * rng.standard_normal((ny, nx))).float() for _ in range(2))
    return lbm._equilibrium(rho, ux, uy)


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,steps", [(256, 256, 1), (256, 256, 200), (1000, 1000, 1), (24, 40, 50), (3, 5, 4)])
def test_lbm_kernel_matches_plain_version_on_gpu(cuda_device, ny, nx, steps):
    f = _lattice(ny, nx).to(cuda_device)
    lbm.reset_counters()
    got, ref = f, f
    for _ in range(steps):
        got = lbm.lbm_step(got, 0.62, 0.1)
        ref = lbm.lbm_step_plain(ref, 0.62, 0.1)
    torch.cuda.synchronize()
    assert lbm.lbm_collide_stream.launches == steps and lbm.lbm_collide_stream_plain.cuda_calls == steps
    _close(got, ref)
