"""The forward jet-segment kernels (csrc/jet_mlp_fwd.cu, jet_gated_fwd.cu)
and their shared-memory plan, without JAX.

On the CPU: the plan's byte count (``ops/jet_mlp.py::fwd_smem``) is the one
the C launches compute (``csrc/jet_common.cuh::fwd_smem``, evaluated from
the source), two CTAs share an SM up to 4 streams at width 256, and
``kernels_take`` takes exactly the shapes it took before the forwards moved
onto the tensor cores up to 8 streams: 1..32 layers, widths <= 512 (<= 256
gated), layer outputs a multiple of 4; from 9 to 16 streams the ungated
kernels take every width <= 256 and the wider ones whose 8-row tile fits
shared memory, and the gated ones refuse them.
On a GPU (tests marked ``cuda``, skipped elsewhere): both forwards against
their plain versions, in both modes (recompute and save-bounds), at every
stream count (the ungated one also at 9, 10, 15 and 16 streams, the
product in two halves), narrow and ragged shapes (first inputs of 3 and 5, outputs of
4, widths 24, 52 and 512, batches that are no multiple of the row tile),
and two calls on the same inputs bitwise equal. Tolerance on the GPU: 1e-4
times the reference's largest magnitude (the 3xTF32 products sum float32
terms in another order).
This file imports only torch and the port, so it also runs where JAX is
not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_jet_fwd_kernels.py``.
"""

import re

import numpy as np
import pytest
import torch

from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.ops import cuda_build
from paddlescience_torch.ops import jet_gated as G
from paddlescience_torch.ops import jet_mlp as J

RTOL = 1e-4
SM_SMEM = 233472  # shared memory of an H100 SM
CTA_RESERVED = 1024  # shared memory the runtime reserves per CTA


def _c_fwd_smem():
    """``fwd_smem(S, kst, bm, dmax)`` of csrc/jet_common.cuh as a Python
    function, read from its source (with ``fwd_ring_stride`` and
    ``FW_STAGES``)."""
    common = (cuda_build.CSRC / "jet_common.cuh").read_text()
    stages = int(re.search(r"#define FW_STAGES (\d+)", common).group(1))
    kc = int(re.search(r"#define PSCI_KC (\d+)", common).group(1))
    ring = re.search(r"int fwd_ring_stride\(int dmax\) \{ return (.*?); \}", common).group(1)
    body = re.search(r"size_t fwd_smem\(int S, int kst, int bm, int dmax\) \{\s*return (.*?);\s*\}", common, re.S)
    expr = body.group(1).replace("(size_t)", "").replace("sizeof(float)", "4").replace("FW_STAGES", str(stages))
    expr = expr.replace("PSCI_KC", str(kc)).replace("fwd_ring_stride(dmax)", f"({ring.replace('/', '//')})")
    return lambda S, kst, bm, dmax: eval(expr, {}, {"S": S, "kst": kst, "bm": bm, "dmax": dmax})


def test_forward_shared_memory_matches_the_kernels():
    """The plan's bytes are the ones both forward kernels launch with, over
    every stream count and width the wrappers take; the wrappers pass the
    tile stride the plan counts; up to 4 streams at width 256 two CTAs fit
    an SM; every shape fits a CTA."""
    c_smem = _c_fwd_smem()
    common = (cuda_build.CSRC / "jet_common.cuh").read_text()
    assert f"#define FW_STAGES {J.FW_STAGES} " in common and f"#define PSCI_KC {J.KC} " in common
    mlp_src = (cuda_build.CSRC / "jet_mlp_fwd.cu").read_text()
    gated_src = (cuda_build.CSRC / "jet_gated_fwd.cu").read_text()
    assert "const size_t smem = fwd_smem(S, p.kmax, BM, dmax);" in mlp_src
    assert "const size_t smem = fwd_smem(S, p.kmax, PSCI_BM, dmax);" in gated_src
    for src in (mlp_src, gated_src):  # dmax: the widest layer output; the ring stride from the same
        assert "for (int l = 1; l <= p.L; ++l) dmax = p.dims[l] > dmax ? p.dims[l] : dmax;" in src
        assert "p.rs = fwd_ring_stride(dmax);" in src
    mlp_py = (cuda_build.CSRC.parent / "ops" / "jet_mlp.py").read_text()
    assert "S, L, N, fwd_kst(dims), tile_rows(S, dims), act_id" in mlp_py
    assert "launch_halves<16, BM>(p, st)" in mlp_src and "fwd_smem(S, p.kmax, BM, dmax)" in mlp_src
    assert "S, L, N, jet_mlp.fwd_kst(dims), act_id" in (cuda_build.CSRC.parent / "ops" / "jet_gated.py").read_text()
    for S in range(1, J.MAX_STREAMS + 1):
        for w in range(4, J.MAX_WIDTH + 1, 4):
            for dims in ([w] * 4, [3] + [w] * 3, [5, w, 4], [w, 24, w]):
                got = J.fwd_smem(S, dims)
                assert got == c_smem(S, J.fwd_kst(dims), J.tile_rows(S, dims), max(dims[1:])), (S, dims)
                assert (got <= J.SMEM_LIMIT) is (S <= J.GATED_MAX_STREAMS or J.kernels_take(S, dims)), (S, dims)
                assert J.fwd_kst(dims) % 32 == 0 and J.fwd_kst(dims) >= max(dims)
    for S in range(1, 5):  # the gated PirateNet and ModifiedMLP shapes keep two CTAs an SM
        assert 2 * (J.fwd_smem(S, [256] * 28) + CTA_RESERVED) <= SM_SMEM, S
    assert J.fwd_smem(4, [256] * 28) == 115456


def _takes_before(S, dims, gated):
    """What ``kernels_take`` answered before the forwards' redesign: the
    stream, layer and width limits (every shape within them fit shared
    memory)."""
    return (1 <= S <= 8 and 1 <= len(dims) - 1 <= 32 and max(dims) <= (256 if gated else 512)
            and all(d % 4 == 0 for d in dims[1:]))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("S", range(1, J.GATED_MAX_STREAMS + 1))
def test_kernels_take_the_same_shapes(S, gated):
    """``kernels_take`` over widths 4..516 (and widths that are no multiple
    of 4), first inputs of 3, 5 and the width, 1, 3 and 27 layers: the same
    answer as before, up to 8 streams, and the forward's shared memory
    within a CTA's wherever it takes a shape; past each pair's stream limit
    (8 gated, 16 ungated) nothing."""
    for w in list(range(4, 517, 4)) + [50, 255, 257, 513]:
        for k_in in (3, 5, w):
            for L in (1, 3, 27):
                dims = [k_in] + [w] * L
                takes = J.kernels_take(S, dims, gated)
                assert takes is _takes_before(S, dims, gated), (S, dims, gated)
                assert (J.kernel_refusal(S, dims, gated) is None) is takes
                if takes:
                    assert J.fwd_smem(S, dims) <= J.SMEM_LIMIT
    assert not J.kernels_take(S + (J.GATED_MAX_STREAMS if gated else J.MAX_STREAMS), [256] * 3, gated)


@pytest.mark.parametrize("S", range(J.GATED_MAX_STREAMS + 1, J.MAX_STREAMS + 1))
def test_kernels_take_up_to_16_streams(S):
    """From 9 to 16 streams: the ungated kernels take every width <= 256
    (16-row tiles where both kernels' S-stream tiles fit, 8 rows above:
    12-16 streams at width 256), and the widths 260-512 where the forward's
    8-row tile and ring fit (none at width 512); the backward always parks
    its cotangent there. The gated kernels refuse every shape, naming
    their limit."""
    for w in list(range(4, 517, 4)) + [50, 255]:
        for k_in in (3, 5, w):
            dims = [k_in] + [w] * 3
            fits = max(dims) <= J.MAX_WIDTH and w % 4 == 0 and J.fwd_smem(S, dims) <= J.SMEM_LIMIT
            assert J.kernels_take(S, dims) is fits, (S, dims)
            assert not J.kernels_take(S, dims, gated=True)
            if w <= J.NARROW_WIDTH and w % 4 == 0:
                assert fits and J.bwd_parks(S, dims) and J.bwd_smem(S, dims) <= J.SMEM_LIMIT
            if fits:  # 16 rows where the 16-row forward tile and the parked backward tile fit
                kst, kmax = -(-w // 32) * 32, -(-w // 4) * 4
                fwd16 = (S * 16 * kst + J.FW_STAGES * 16 * (-(-w // 16) * 16 + 4)) * 4
                bwd16 = (S * kmax * 16 + J.GB_STAGES * 16 * kmax) * 4
                rows = 16 if w <= 256 and max(fwd16, bwd16) <= J.SMEM_LIMIT else 8
                assert J.tile_rows(S, dims) == rows, (S, dims)
    assert [J.tile_rows(S_, [3] + [256] * 6) for S_ in (10, 11, 12, 16)] == [16, 16, 8, 8]
    assert "the gated kernels take 1..8 streams" in J.kernel_refusal(S, [256] * 3, gated=True)
    assert not J.kernels_take(S, [3] + [512] * 6) and "shared memory" in J.kernel_refusal(S, [3] + [512] * 6)


# ---------------------------------------------------------------- on a GPU --


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    return torch.device("cuda")


NS3D = [(0,), (1,), (2,), (0, 0), (1, 1), (2, 2)]


def _index(S):
    """A jet index of S streams with pairs: the Allen-Cahn one cut to S <= 4,
    a 2-D second-order one at S = 5, 6, the 3-D NavierStokes one at S = 7
    (the aneurysm's) and with u_xy at S = 8; above, every order <= 2
    multi-index of 3 inputs (S = 10, the 3-D Hooke jet), 4 (S = 15) or 5
    (cut to S)."""
    if S <= 4:
        return tjet.build_index([(0,), (1,), (1, 1)][: S - 1])
    if S <= 6:
        return tjet.build_index([(0,), (1,), (0, 0), (1, 1), (0, 1)][: S - 1])
    if S <= 8:
        return tjet.build_index(NS3D + [(0, 1)] * (S - 7))
    d = 3 if S <= 10 else 4 if S <= 15 else 5
    multis = [(i,) for i in range(d)] + [(i, j) for i in range(d) for j in range(i, d)]
    return tjet.build_index(multis[: S - 1])


def _close(got, ref):
    got, ref = got.detach().cpu(), ref.detach().cpu()
    assert got.shape == ref.shape
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    assert err <= RTOL * max(scale, 1e-30), f"max abs err {err:.3e} > {RTOL} * {scale:.3e}"


def _mlp_inputs(S, n, dims, dev, seed=0):
    rng = np.random.default_rng(seed)
    rn = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    streams = [rn(n, dims[0]) for _ in range(S)]
    weights = [rn(dims[l], dims[l + 1]) / dims[l] ** 0.5 for l in range(len(dims) - 1)]
    biases = [0.1 * rn(d) for d in dims[1:]]
    return streams, weights, biases


def _gated_inputs(S, n, w, program, dev, k_in=None, seed=1):
    rng = np.random.default_rng(seed)
    rn = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    dims = [k_in or w] + [w] * len(program)
    y = [rn(n, dims[0]) for _ in range(S)]
    u, v = ([rn(n, w) for _ in range(S)] for _ in range(2))
    weights = [rn(dims[l], w) / dims[l] ** 0.5 for l in range(len(program))]
    biases = [0.1 * rn(w) for _ in program]
    alphas = [torch.tensor([rng.uniform(0.1, 0.9)], dtype=torch.float32, device=dev)
              for op in program if op & G.RESIDUAL]
    if not G._has_gates(program):
        u = v = []
    return y, u, v, weights, biases, alphas


GATED_FWD_SHAPES = [(S, w) for S in range(1, J.GATED_MAX_STREAMS + 1) for w in (52, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,w", GATED_FWD_SHAPES)
def test_gated_fwd_matches_plain_version_on_gpu(cuda_device, S, w):
    """jet_gated_fwd at S streams on the PirateNet program of 2 blocks
    (gates and residuals) and a ModifiedMLP program with a 5-wide first
    input, at width 52 (cylinder2d's 50 padded) and 256, N = 4095 (a
    ragged last tile); outputs and saved boundaries."""
    idx = _index(S)
    assert len(idx) == S
    for program, k_in in ((G.piratenet_program(2), None), (G.modified_mlp_program(3), 5)):
        args = (*_gated_inputs(S, 4095, w, program, cuda_device, k_in), program, idx)
        G.reset_counters()
        outs, none = G.jet_gated_fwd(*args)
        outs_sb, bounds = G.jet_gated_fwd(*args, save_bounds=True)
        r_outs, r_bounds = G.jet_gated_fwd_plain(*args, save_bounds=True)
        torch.cuda.synchronize()
        assert G.jet_gated_fwd.launches == 2 and none == () and len(bounds) == len(r_bounds) > 0
        for got, ref in zip([*outs, *outs_sb, *bounds], [*r_outs, *r_outs, *r_bounds]):
            _close(got, ref)


MLP_FWD_SHAPES = {  # (streams, first input and widths, activation)
    "aneurysm_K3_D4": (7, (3, 512, 512, 4), (tjet.SILU, 0.0)),
    "unsteady_S8_K3": (8, (3, 512, 512), (tjet.SILU, 0.0)),
    "K5_w24_D4": (4, (5, 24, 24, 4), J.TANH),
    "w52_D4": (4, (52, 52, 52, 4), J.TANH),
    "K5_w52_w24": (1, (5, 52, 24, 4), (tjet.GELU, 0.0)),
    "w24_w512_D4": (5, (24, 512, 4), (tjet.SIREN, 1.7)),
    "K3_w52": (2, (3, 52, 52, 52), J.TANH),
    # more than 8 streams: the product in two halves
    "heart_S9": (9, (3,) + (256,) * 6, J.TANH),
    "heart_S10": (10, (3,) + (256,) * 6, J.TANH),
    "S15_w256": (15, (4, 256, 256, 256), J.TANH),      # 8-row tiles
    "S16_w256": (16, (5, 256, 256, 256), (tjet.SILU, 0.0)),
    "S10_w128": (10, (3,) + (128,) * 5, J.TANH),       # aneurysm_flow's width
    "S16_w64_D4": (16, (5, 64, 64, 4), (tjet.GELU, 0.0)),  # 16-row tiles at 16 streams
    "S13_w300": (13, (3, 300, 300, 8), J.TANH),         # a wide 8-row tile
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(MLP_FWD_SHAPES))
def test_mlp_fwd_matches_plain_version_on_gpu(cuda_device, shape):
    """jet_mlp_fwd at first inputs of 3 and 5, outputs of 4, widths 24, 52
    and 512 (8-row tiles), N = 2047; and at 9-16 streams (the product in two
    halves; 16- and 8-row tiles); outputs and saved boundaries."""
    S, dims, act = MLP_FWD_SHAPES[shape]
    idx = _index(S)
    streams, weights, biases = _mlp_inputs(S, 2047, dims, cuda_device)
    J.reset_counters()
    outs, none = J.jet_mlp_fwd(streams, weights, biases, idx, act=act)
    outs_sb, bounds = J.jet_mlp_fwd(streams, weights, biases, idx, save_bounds=True, act=act)
    r_outs, r_bounds = J.jet_mlp_fwd_plain(streams, weights, biases, idx, save_bounds=True, act=act)
    torch.cuda.synchronize()
    assert J.jet_mlp_fwd.launches == 2 and none == () and len(bounds) == len(dims) - 2
    for got, ref in zip([*outs, *outs_sb, *bounds], [*r_outs, *r_outs, *r_bounds]):
        _close(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["piratenet_9", "aneurysm", "heart_S10", "S16_w256"])
def test_forwards_are_bitwise_repeatable_on_gpu(cuda_device, shape):
    """Two calls of a forward on the same inputs give bitwise the same
    outputs and boundaries, in both modes: jet_gated_fwd on the PirateNet
    program of 9 blocks (S = 4, width 256), jet_mlp_fwd on the aneurysm's
    3 -> 512 x 6 (S = 7, SiLU), on heart's 3 -> 256 x 6 at S = 10 and at
    S = 16, width 256; ragged batches."""
    if shape == "piratenet_9":
        program = G.piratenet_program(9)
        args = (*_gated_inputs(4, 4095, 256, program, cuda_device), program, _index(4))
        call = lambda sb: G.jet_gated_fwd(*args, save_bounds=sb)
    elif shape in MLP_FWD_SHAPES:
        S, dims, act = MLP_FWD_SHAPES[shape]
        streams, weights, biases = _mlp_inputs(S, 4095, dims, cuda_device)
        call = lambda sb: J.jet_mlp_fwd(streams, weights, biases, _index(S), save_bounds=sb, act=act)
    else:
        streams, weights, biases = _mlp_inputs(7, 2047, (3,) + (512,) * 6, cuda_device)
        call = lambda sb: J.jet_mlp_fwd(streams, weights, biases, _index(7), save_bounds=sb, act=(tjet.SILU, 0.0))
    for sb in (False, True):
        first, second = call(sb), call(sb)
        torch.cuda.synchronize()
        a, b = [*first[0], *first[1]], [*second[0], *second[1]]
        assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))
