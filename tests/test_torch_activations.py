"""Every activation of the port's fused jet segments against the JAX
package, on the CPU.

For each activation that the JAX kernels take (``arch/activation.py``'s
``_FUNCS`` and Siren):

* the port's ``jet.elementwise`` against the JAX one (which takes a
  closed-form rule for tanh, sin, cos and ``jax.jvp`` for the rest) on a
  seven-stream jet, the NavierStokes-3D index (u, three firsts, three
  pure seconds);
* the plain segment forward and its hand-derived VJP (through the port's
  ``autograd.Function`` on CPU tensors, which runs the plain versions)
  against the JAX Pallas segment (``ops/jet_pallas.py::fused_jet_segment``)
  run through the Pallas interpreter, values and gradients of the input
  streams, weights and biases;
* the hand-derived VJP, ungated and as a ModifiedMLP program, against
  ``torch.autograd`` through the plain forward in float64.

Tolerances: 1e-5 relative (with an absolute floor of 1e-5 times the
reference's largest magnitude) against JAX in float32, where both sides
round differently (closed forms against ``jvp``, other summation orders);
1e-10 against autograd in float64, where only the derivation is tested.
At the kinks (relu, relu6 at 0 and 6, elu, selu, leaky_relu at 0) the rules
must give exactly the derivatives of JAX's nested ``jvp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.arch.mlp import _mlp_segment_fn, _stage_leaf_ranges
from paddlescience_tpu.autodiff import jet as jjet
from paddlescience_tpu.ops import jet_pallas as jp
from paddlescience_torch.arch import activation as tact
from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.ops import jet_gated as G
from paddlescience_torch.ops import jet_mlp as J

RTOL = 1e-5
NS3D = [(0,), (1,), (2,), (0, 0), (1, 1), (2, 2)]  # 7 streams with the primal
NAMES = sorted(psci.arch.activation._FUNCS) + ["siren"]
SIREN_W0 = 1.7  # a Siren of w0 = 30 turns these random inputs into noise


@pytest.fixture(autouse=True)
def _interpret_and_float32(monkeypatch):
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    with jax.default_matmul_precision("highest"):
        yield


def _acts(name):
    """(JAX activation, port activation) of the same name."""
    if name == "siren":
        return psci.arch.activation.Siren(SIREN_W0), tact.Siren(SIREN_W0)
    return psci.arch.activation.get_activation(name), tact.get_activation(name)


def _close(got, ref, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _case(L, n, w, k0=None, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    S = len(tjet.build_index(NS3D))
    dims = [k0 or w] + [w] * L
    streams = [rng.standard_normal((n, dims[0])).astype(dtype) for _ in range(S)]
    weights = [(rng.standard_normal((dims[l], dims[l + 1])) / np.sqrt(dims[l])).astype(dtype) for l in range(L)]
    biases = [(0.1 * rng.standard_normal((dims[l + 1],))).astype(dtype) for l in range(L)]
    cot = [rng.standard_normal((n, w)).astype(dtype) for _ in range(S)]
    return streams, weights, biases, cot


@pytest.mark.parametrize("name", NAMES)
def test_elementwise_matches_jax(name):
    j_act, t_act = _acts(name)
    rng = np.random.default_rng(1)
    idx_j, idx_t = jjet.build_index(NS3D), tjet.build_index(NS3D)
    streams = [(2.0 * rng.standard_normal((33, 5))).astype(np.float32) for _ in range(len(idx_t))]
    got = tjet.elementwise(tjet.Jet([torch.from_numpy(s) for s in streams], idx_t), t_act)
    ref = jjet.elementwise(jjet.Jet([jnp.asarray(s) for s in streams], idx_j), j_act)
    for a, b in zip(got.streams, ref.streams):
        _close(a, b)
    # the batched forward is the rule's primal
    _close(t_act(torch.from_numpy(streams[0])), got.streams[0], 1e-6)


def _jax_segment(j_act, streams, weights, biases, cot, block_m):
    """Outputs and gradients of sum_s <out_s, cot_s> through the Pallas
    segment of ``len(weights)`` ``linear + j_act`` layers."""
    L = len(weights)
    idx = jjet.build_index(NS3D)

    def layer_stage(i):
        def stage(ws, y_):
            return (jjet.elementwise(jjet.linear(y_, ws[2 * i], ws[2 * i + 1]), j_act),)
        return stage

    spec = jp.SegmentSpec(
        _mlp_segment_fn((j_act,) * L, False), idx, n_in=1, n_out=1, block_m=block_m, interpret=True,
        stages=tuple(layer_stage(i) for i in range(L)),
        stage_ws_idx=_stage_leaf_ranges([(w, b) for w, b in zip(weights, biases)]),
    )
    ws = tuple(jnp.asarray(a) for pair in zip(weights, biases) for a in pair)

    def loss(ws, ss):
        out = jp.fused_jet_segment(spec, ws, jjet.Jet(ss, idx))
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(out.streams, cot)), out.streams

    (_, outs), (gws, gss) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        ws, [jnp.asarray(s) for s in streams])
    return outs, gss, gws[0::2], gws[1::2]


def _check_segment_against_jax(name, L, n, w, k0, block_m):
    j_act, t_act = _acts(name)
    streams, weights, biases, cot = _case(L, n, w, k0)
    j_outs, j_gs, j_gw, j_gb = _jax_segment(j_act, streams, weights, biases, cot, block_m)
    idx = tjet.build_index(NS3D)
    act = tjet.act_of(t_act)
    plain, _ = J.jet_mlp_fwd_plain([torch.from_numpy(a) for a in streams], [torch.from_numpy(a) for a in weights],
                                   [torch.from_numpy(a) for a in biases], idx, act=act)
    for a, b in zip(plain, j_outs):
        _close(a, b)
    ss, ws, bs = ([torch.from_numpy(a).requires_grad_() for a in arrs] for arrs in (streams, weights, biases))
    out = J.jet_mlp_segment(tjet.Jet(ss, idx), ws, bs, act=act)
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out.streams, cot))
    grads = torch.autograd.grad(loss, ss + ws + bs)
    for a, b in zip(grads, list(j_gs) + list(j_gw) + list(j_gb)):
        _close(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_segment_and_its_vjp_match_the_pallas_kernel(name):
    """Two layers, a 3-wide first layer as in the aneurysm MLP, 40 rows in
    tiles of 16 (a ragged last tile)."""
    _check_segment_against_jax(name, L=2, n=40, w=16, k0=3, block_m=16)


def test_width_512_seven_streams_match_the_pallas_kernel():
    """The aneurysm MLP's layer shape: SiLU, width 512, S = 7, two layers
    at 16 rows."""
    _check_segment_against_jax("silu", L=2, n=16, w=512, k0=512, block_m=16)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("gated", [False, True])
def test_hand_derived_vjp_matches_autograd(name, gated):
    """jet_mlp_bwd_plain / jet_gated_bwd_plain and jet_wgrad_plain, through
    the autograd.Functions, against torch.autograd through the plain
    forward, in float64."""
    _, t_act = _acts(name)
    act = tjet.act_of(t_act)
    idx = tjet.build_index(NS3D)
    streams, weights, biases, cot = _case(3, 23, 8, seed=2, dtype=np.float64)
    to64 = lambda arrs: [torch.from_numpy(a).requires_grad_() for a in arrs]
    ss, ws, bs = to64(streams), to64(weights), to64(biases)
    g_out = [torch.from_numpy(c) for c in cot]
    if gated:
        rng = np.random.default_rng(3)
        u, v = (to64([rng.standard_normal(s.shape) for s in streams]) for _ in range(2))
        prog = G.modified_mlp_program(3)
        leaves = ss + u + v + ws + bs
        outs, _ = G.jet_gated_fwd_plain(ss, u, v, ws, bs, (), prog, idx, act=act)
        out = G.jet_gated_segment(tjet.Jet(ss, idx), tjet.Jet(u, idx), tjet.Jet(v, idx), ws, bs, (), prog,
                                  act=act).streams
    else:
        leaves = ss + ws + bs
        outs, _ = J.jet_mlp_fwd_plain(ss, ws, bs, idx, act=act)
        out = J.jet_mlp_segment(tjet.Jet(ss, idx), ws, bs, act=act).streams
    ref = torch.autograd.grad(sum((o * g).sum() for o, g in zip(outs, g_out)), leaves)
    got = torch.autograd.grad(sum((o * g).sum() for o, g in zip(out, g_out)), leaves)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name,x", [("relu", 0.0), ("relu6", 0.0), ("relu6", 6.0), ("elu", 0.0), ("selu", 0.0),
                                    ("leaky_relu", 0.0)])
def test_rules_at_the_kinks_take_jax_jvp_derivatives(name, x):
    j_act, t_act = _acts(name)
    d1 = lambda f: lambda y: jax.jvp(f, (y,), (jnp.ones_like(y),))[1]
    xj = jnp.asarray([x], jnp.float32)
    ref = [j_act(xj), d1(j_act)(xj), d1(d1(j_act))(xj), d1(d1(d1(j_act)))(xj)]
    got = tjet.act_derivs(tjet.act_of(t_act), torch.tensor([x]))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_every_jax_activation_is_ported_with_its_own_rule():
    assert set(tact._FUNCS) == set(psci.arch.activation._FUNCS)
    ids = {tjet.act_of(a)[0] for a in tact._FUNCS.values()} | {tjet.act_of(tact.Siren())[0]}
    assert ids == set(tjet.ACT_RULES) - {tjet.EXP}  # exp: a jet primitive, no activation of the zoo
    assert tjet.act_of(tact.Siren(2.0)) == (tjet.SIREN, 2.0)
    # the parametric ones are classes, as in JAX; Stan and Swish have no rule by id (their beta is learnable)
    assert set(tact._CLASSES) == set(psci.arch.activation._CLASSES)
    assert tact.get_activation("swish") is tact.Swish and tact.get_activation("Stan") is tact.Stan
    assert tjet.act_of(tact.Swish()) is None and tjet.act_of(tact.Stan(4)) is None
    with pytest.raises(ValueError, match="act_name"):
        tact.get_activation("swishh")
