"""The port's gated archs (PirateNet, ModifiedMLP: paddlescience_torch/arch/
mlp.py with the fused gated segments of ops/jet_gated.py) against the JAX
package on the CPU.

Both sides get the same parameters (``load_jax_params``, no renaming) and
the same numpy-seeded inputs; JAX runs at matmul precision "highest" with
its Pallas kernels interpreted (``PSCI_JET_PALLAS_INTERPRET=1``), the port
runs its plain versions and hand-derived backward because the tensors are
on the CPU. PirateNet's alpha starts at 0, which makes every block the
identity and every block gradient zero, so the tests nudge it off 0.

Tolerances: batched forward 1e-6, jet streams 1e-5, parameter gradients
1e-4, each relative to the reference tensor's largest magnitude (the
Pallas kernel's split matmuls order the float32 sums differently); three
train steps as in tests/test_torch_allen_cahn.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import jet as jjet
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.constraint.base import Constraint as JConstraint
from paddlescience_tpu.data import DeviceSampledDataset as JDeviceSampledDataset
from paddlescience_tpu.loss import mtl as jmtl
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch.mlp import ModifiedMLP as TModifiedMLP
from paddlescience_torch.arch.mlp import PirateNet as TPirateNet
from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.data import DeviceSampledDataset
from paddlescience_torch.examples.allen_cahn import build_solver, ic_data
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

N, WIDTH, BLOCKS = 64, 32, 3
INDICES = [[(0,), (1,), (1, 1)], [(0,), (0, 1), (1, 1)]]
COMMON = dict(activation="tanh", periods={"x": (2.0, False)}, fourier={"dim": WIDTH, "scale": 2.0},
              random_weight={"mean": 1.0, "std": 0.1})


@pytest.fixture(autouse=True)
def _float32_and_paths(monkeypatch):
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    torch.backends.cuda.matmul.allow_tf32 = False
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _close(got, ref, rtol, scale=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), scale, 1e-30))


def _rwf_scale(name, grads, params):
    """The size of the terms that make up a ``weight_g`` gradient. With
    W = g * v, d/dg_j = sum_i v_ij dW_ij and d/dv_ij = g_j dW_ij, so the
    terms are v_ij (d/dv_ij) / g_j. They cancel (a one-column last layer
    sums 32 terms of order 10 to a value below 1), and float32 noise in
    the terms does not: the tolerance is relative to their summed size."""
    if not name.endswith("weight_g"):
        return 0.0
    stem = name[: -len("weight_g")]
    terms = params[stem + "weight_v"] * grads[stem + "weight_v"] / params[stem + "weight_g"]
    return float(np.abs(terms).sum(0).max())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch, seed=3, blocks=BLOCKS):
    """The JAX model and the port's, with the same parameters; PirateNet's
    alphas are moved off 0 first."""
    if arch == "piratenet":
        jm = psci.arch.PirateNet(("t", "x"), ("u",), num_blocks=blocks, hidden_size=WIDTH, rngs=Rngs(seed), **COMMON)
        tm = TPirateNet(("t", "x"), ("u",), num_blocks=blocks, hidden_size=WIDTH, device="cpu", **COMMON)
        tree = _np_tree(jm.param_tree())
        for i in range(blocks):
            tree["blocks"][str(i)]["alpha"] = np.array([0.2 + 0.15 * i], np.float32)
        jm.load_param_tree(tree)
    else:
        jm = psci.arch.ModifiedMLP(("t", "x"), ("u",), num_layers=4, hidden_size=WIDTH, rngs=Rngs(seed), **COMMON)
        tm = TModifiedMLP(("t", "x"), ("u",), num_layers=4, hidden_size=WIDTH, device="cpu", **COMMON)
    load_jax_params(tm, _np_tree(jm.param_tree()), _np_tree(jm.buffer_tree()))
    return jm, tm


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tx = np.concatenate([rng.uniform(0, 1, (N, 1)), rng.uniform(-1, 1, (N, 1))], axis=1).astype(np.float32)
    return tx


def test_param_names_carry_over():
    """No renaming table: the port's parameter names are the JAX tree's
    dotted keys, alpha of shape (1,), gates embed_u / embed_v included."""
    jm, tm = _models("piratenet")
    names = set(flatten_tree(_np_tree(jm.param_tree())))
    assert names == {n for n, _ in tm.named_parameters()}
    assert {"embed_u.weight_g", "embed_v.weight_v", "blocks.0.linear1.weight_g", "blocks.2.linear3.bias",
            "blocks.1.alpha"} <= names
    assert tuple(tm.blocks[1].alpha.shape) == (1,) and float(tm.blocks[1].alpha.detach()) == pytest.approx(0.35)
    jm, tm = _models("modified_mlp")
    assert set(flatten_tree(_np_tree(jm.param_tree()))) == {n for n, _ in tm.named_parameters()}


@pytest.mark.parametrize("arch", ["piratenet", "modified_mlp"])
def test_batched_forward_matches(arch):
    jm, tm = _models(arch)
    tx = _inputs()
    ref = jm({"t": jnp.asarray(tx[:, :1]), "x": jnp.asarray(tx[:, 1:])})["u"]
    got = tm({"t": torch.from_numpy(tx[:, :1]), "x": torch.from_numpy(tx[:, 1:])})["u"]
    _close(got, ref, 1e-6)


def _flags(deriv, group, save_bounds):
    flags = dict(jpath.CANDIDATES[deriv])
    if deriv != "jet":
        flags.update({"PSCI_JET_PBLOCK_GROUP": str(group), "PSCI_JET_SEG": str(group),
                      "PSCI_JET_SAVE_BOUNDS": "1" if save_bounds else "0"})
    return flags


def _jet_case(arch, multis, deriv, group, save_bounds):
    """Output jet streams and d(sum_s <out_s, cot_s>)/d(params) on both
    sides; returns ((jax streams, jax grads), (port streams, port grads))."""
    jm, tm = _models(arch)
    tx = _inputs()
    rng = np.random.default_rng(5)
    jidx, tidx = jjet.build_index(multis), tjet.build_index(multis)
    cot = [rng.standard_normal((N, 1)).astype(np.float32) for _ in range(len(jidx))]
    flags = _flags(deriv, group, save_bounds)
    assert set(flags) <= set(tpath.CANDIDATES["jet_pallas_full_sb"]) | {"PSCI_JET"}

    def jloss(params):
        with jm.bind(params):
            out = jm.forward_jet(jjet.seed(jnp.asarray(tx), jidx))
        return sum(jnp.sum(o * jnp.asarray(c)) for o, c in zip(out.streams, cot)), out.streams

    with jpath.override(flags):
        (_, j_streams), j_grads = jax.value_and_grad(jloss, has_aux=True)(jm.param_tree())
    with tpath.override(flags):
        out = tm.forward_jet(tjet.seed(torch.from_numpy(tx), tidx))
        loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(out.streams, cot))
        names, params = zip(*tm.named_parameters())
        t_grads = dict(zip(names, torch.autograd.grad(loss, params)))
        lengths = tm.jet_segment_lengths()
    j_params = flatten_tree(_np_tree(jm.param_tree()))
    return (j_streams, flatten_tree(_np_tree(j_grads)), j_params), (out.streams, t_grads), lengths


def _check_jet_case(arch, multis, deriv, group, save_bounds, lengths):
    (j_streams, j_grads, j_params), (t_streams, t_grads), got_lengths = _jet_case(arch, multis, deriv, group,
                                                                                   save_bounds)
    assert got_lengths == lengths
    for a, b in zip(t_streams, j_streams):
        _close(a, b, 1e-5)
    assert set(t_grads) == set(j_grads)
    for name, g in j_grads.items():
        assert np.abs(g).max() > 0, f"{name}: the reference gradient is zero, the case proves nothing"
        _close(t_grads[name], g, 1e-4, scale=_rwf_scale(name, j_grads, j_params))


@pytest.mark.parametrize("multis", INDICES)
@pytest.mark.parametrize("arch", ["piratenet", "modified_mlp"])
def test_forward_jet_plain_path_matches(arch, multis):
    """The plain jet path (PirateNet blocks under torch.utils.checkpoint)."""
    _check_jet_case(arch, multis, "jet", 0, False, [])


@pytest.mark.parametrize("save_bounds", [False, True])
@pytest.mark.parametrize("group,lengths", [(1, [3, 3, 3]), (2, [6, 3]), (999, [9])])
@pytest.mark.parametrize("multis", INDICES)
def test_piratenet_fused_path_matches(multis, group, lengths, save_bounds):
    _check_jet_case("piratenet", multis, "jet_pallas", group, save_bounds, lengths)


@pytest.mark.parametrize("save_bounds", [False, True])
@pytest.mark.parametrize("group,lengths", [(1, [1, 1, 1, 1]), (2, [2, 2]), (999, [4])])
@pytest.mark.parametrize("multis", INDICES)
def test_modified_mlp_fused_path_matches(multis, group, lengths, save_bounds):
    _check_jet_case("modified_mlp", multis, "jet_pallas", group, save_bounds, lengths)


@pytest.mark.parametrize("deriv,lengths", [("jet", []), ("jet_pallas", [9, 9, 9]), ("jet_pallas_full", [27]),
                                           ("jet_pallas_full_sb", [27])])
def test_piratenet_segment_lengths_per_path(deriv, lengths):
    """The depths at which each candidate runs the gated kernels on the
    9-block net of the GPU run; with no candidate pinned PirateNet takes
    the segments by default (wide layers), as in the JAX package."""
    tm = TPirateNet(("t", "x"), ("u",), num_blocks=9, hidden_size=128, fourier={"dim": 128, "scale": 2.0},
                    device="cpu")
    tpath.set_default(None)
    assert tm.jet_segment_lengths() == [9, 9, 9]
    tpath.set_default(tpath.CANDIDATES[deriv])
    assert tm.jet_segment_lengths() == lengths


def test_remat_gives_the_same_gradients(monkeypatch):
    """PSCI_JET_REMAT=0 (no checkpointing on the plain jet path) changes
    memory, not numbers."""
    _, tm = _models("piratenet")
    tidx = tjet.build_index(INDICES[0])
    tx = torch.from_numpy(_inputs())
    grads = []
    for remat in ("1", "0"):
        monkeypatch.setenv("PSCI_JET_REMAT", remat)
        with tpath.override(tpath.CANDIDATES["jet"]):
            out = tm.forward_jet(tjet.seed(tx, tidx))
        grads.append(torch.autograd.grad(sum((o * o).sum() for o in out.streams), list(tm.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ------------------------------------------------------------ the slice --

N_PDE, N_IC, LR, GAMMA, DECAY_STEPS, UPDATE_FREQ, STEPS = 256, 64, 1e-3, 0.9, 2, 2, 3


def _jax_solver(jm, t, x, ic, tmp_path):
    t_ic, x_ic, u_ic = ic
    batch = ({"t": jnp.asarray(t), "x": jnp.asarray(x)}, {"allen_cahn": jnp.zeros((N_PDE, 1))}, {})
    eq = psci.equation.AllenCahn(eps=0.01)
    pde = JConstraint(JDeviceSampledDataset(lambda key: batch), None,
                      psci.loss.CausalMSELoss(32, "mean", tol=1.0), "PDE")
    pde.output_expr = eq.equations
    ic_c = psci.constraint.SupervisedConstraint(
        {"dataset": {"name": "IterableNamedArrayDataset", "input": {"t": t_ic, "x": x_ic},
                     "label": {"u": u_ic}}},
        psci.loss.MSELoss("mean"), {"u": lambda out: out["u"]}, name="IC")
    lr = psci.optimizer.lr_scheduler.ExponentialDecay(epochs=1, iters_per_epoch=STEPS, learning_rate=LR,
                                                      gamma=GAMMA, decay_steps=DECAY_STEPS)()
    return psci.solver.Solver(
        jm, {"PDE": pde, "IC": ic_c}, str(tmp_path), psci.optimizer.Adam(lr)(jm), epochs=1,
        iters_per_epoch=STEPS, equation={"AllenCahn": eq},
        loss_aggregator=jmtl.GradNorm(jm, 2, UPDATE_FREQ, 0.9), seed=42)


@pytest.mark.parametrize("arch", ["piratenet", "modified_mlp"])
def test_three_train_steps_match_jax_solver(tmp_path, arch):
    """build_solver(arch=...) at 2 blocks (or 4 layers) x 32 on
    jet_pallas_full against the JAX solver's jitted step: losses of every
    step, the step-0 gradient of every parameter, parameters after step 3."""
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0.0, 1.0, (N_PDE, 1)), axis=0).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (N_PDE, 1)).astype(np.float32)
    ic = ic_data(N_IC)
    jm, _ = _models(arch, seed=7, blocks=2)
    params0, buffers0 = _np_tree(jm.param_tree()), _np_tree(jm.buffer_tree())

    js = _jax_solver(jm, t, x, ic, tmp_path)
    j_losses, j_grads0 = [], None
    with jpath.override(jpath.CANDIDATES["jet_pallas_full"]):
        step_fn = js._build_train_step()
        for i in range(STEPS):
            host = {"IC": jax.tree.map(jnp.asarray, next(js.constraint["IC"].data_iter))}
            js._maybe_refresh_agg_weights(host, i)
            if i == 0:
                w = js.state["agg_state"]["weight"]
                batches = {"PDE": js.constraint["PDE"].dataset.sample_fn(None), **host}

                def total(p):
                    ls = js._constraint_losses(p, js.state["rest"], {}, batches)
                    return w[0] * ls["PDE"] + w[1] * ls["IC"]

                j_grads0 = flatten_tree(_np_tree(jax.grad(total)(js.state["params"])))
            js.state, logs = step_fn(js.state, host)
            j_losses.append([float(logs[k]) for k in ("loss", "loss/PDE", "loss/IC")])
    j_params = flatten_tree(_np_tree(js.state["params"]))

    ts = build_solver(epochs=1, iters_per_epoch=STEPS, batch_size=N_PDE, num_layers=4, hidden_size=WIDTH,
                      fourier_dim=WIDTH, ic_points=N_IC, learning_rate=LR, gamma=GAMMA, decay_steps=DECAY_STEPS,
                      update_freq=UPDATE_FREQ, deriv="jet_pallas_full", device="cpu", arch=arch,
                      piratenet_blocks=2)
    assert ts.model.jet_segment_lengths() == ([6] if arch == "piratenet" else [4])
    assert ts.model.fourier["scale"] == 2.0
    load_jax_params(ts.model, params0, buffers0)
    fixed = ({"t": torch.from_numpy(t), "x": torch.from_numpy(x)}, {"allen_cahn": torch.zeros(N_PDE, 1)}, {})
    ts.constraint["PDE"].dataset = DeviceSampledDataset(lambda gen: fixed)
    t_losses = []
    for i in range(STEPS):
        logs = ts.train_step()
        t_losses.append([float(logs[k]) for k in ("loss", "loss/PDE", "loss/IC")])
        if i == 0:
            t_grads0 = {n: p.grad.clone() for n, p in ts.model.named_parameters()}

    assert set(t_grads0) == set(j_grads0)
    for name, g in j_grads0.items():
        err = np.linalg.norm(t_grads0[name].numpy() - g) / np.linalg.norm(g)
        assert err < 1e-4, f"step-0 gradient of {name}: relative error {err:.2e}"
    np.testing.assert_allclose(np.array(t_losses), np.array(j_losses), rtol=1e-4)
    # as in tests/test_torch_allen_cahn.py: 1e-2 lr catches any flipped Adam
    # update or wrong moment
    diffs = np.concatenate([np.abs(p.detach().numpy() - j_params[n]).ravel()
                            for n, p in ts.model.named_parameters()])
    assert diffs.max() <= 1e-2 * LR
