"""The port's aneurysm slice against paddlescience_tpu on the CPU: the STL
geometry and its samples, the NavierStokes and NormalDotVec residuals, the
losses, the schedule, and the whole solver of ``examples/aneurysm.py`` at
a small width for three train steps.

The STLs are written to a temporary directory by running
``tools/gen_aneurysm_stl.py``. The JAX package's mesh code takes its
optional C++ ray cast where that library is built; the tests pin it to its
numpy branch, and the port's meshes to theirs (``native=False``; the
port's C++ ray cast keeps the same points and is held against its numpy
version in ``test_torch_mesh_raycast.py``), so that one ``np.random`` seed
gives bitwise the same points, SDF, normals and areas in both packages.

The solver tests build the JAX example itself (``examples/aneurysm.py``,
its MLP cut to 3 x 32 and its residual validator to ``VAL`` points) and
the port's ``build_solver`` with the same sizes, load the JAX weights into
the port, and run both on the ``jet_pallas`` candidate (the JAX Pallas
kernels interpreted, the port's plain versions): three train steps, and
the residual validator's eval. Tolerances: residuals, losses and the
validator's MSE 1e-4 relative (float32, other summation orders), as the
Allen-Cahn slice's tests.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu import native as jnative
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.solver.solver import _convert_expr
from paddlescience_tpu.utils import expression as jexpr
from paddlescience_torch.arch.mlp import MLP as TMLP
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.equation import NavierStokes as TNavierStokes, NormalDotVec as TNormalDotVec
from paddlescience_torch.examples import aneurysm as taneurysm
from paddlescience_torch.geometry.mesh import Mesh as TMesh
from paddlescience_torch.loss import IntegralLoss as TIntegralLoss, MSELoss as TMSELoss
from paddlescience_torch.optimizer.lr_scheduler import ExponentialDecay as TExponentialDecay
from paddlescience_torch.utils import expression as texpr
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import aneurysm as janeurysm  # noqa: E402  (the JAX example)

BS = dict(bs_pde=64, bs_bc=32, bs_igc=1, integral_bs=32)
VAL = dict(total_size=96, batch_size=40)  # the residual validator: 2 batches of 40 (drop_last), a third of 16 left out
WIDTH, LAYERS, STEPS, LR = 32, 3, 3, 1e-3


@pytest.fixture(scope="module")
def stl_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("aneurysm")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "gen_aneurysm_stl.py"), "--out", str(out)],
                   check=True, capture_output=True, timeout=120)
    return str(out)


@pytest.fixture(autouse=True)
def _numpy_geometry_float32_and_paths(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(taneurysm, "Mesh", functools.partial(TMesh, native=False))
    monkeypatch.setenv("PSCI_JET_PALLAS_INTERPRET", "1")
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _close(got, ref, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _meshes(stl_dir, part):
    center = np.asarray(janeurysm.CENTER)
    path = os.path.join(stl_dir, f"aneurysm_{part}.stl")
    return (psci.geometry.Mesh(path).translate(-center).scale(janeurysm.SCALE),
            TMesh(path, native=False).translate(-center).scale(taneurysm.SCALE))


# ------------------------------------------------------------- geometry --


@pytest.mark.parametrize("part", taneurysm.PARTS)
def test_mesh_boundary_samples_are_bitwise_equal(stl_dir, part):
    jm, tm = _meshes(stl_dir, part)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    assert tm.area == jm.area
    for seed in (0, 1):
        np.random.seed(seed)
        jb = jm.sample_boundary(200)
        np.random.seed(seed)
        tb = tm.sample_boundary(200)
        assert set(tb) == set(jb) == {"x", "y", "z", "normal_x", "normal_y", "normal_z", "area"}
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


def test_mesh_interior_samples_and_sdf_are_bitwise_equal(stl_dir):
    jm, tm = _meshes(stl_dir, "closed")
    np.random.seed(3)
    ji = jm.sample_interior(300)
    np.random.seed(3)
    ti = tm.sample_interior(300)
    assert set(ti) == set(ji) == {"x", "y", "z", "sdf"}
    for k in ji:
        np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    assert (ti["sdf"] > 0).all()
    probe = np.random.default_rng(4).uniform(-2.0, 2.0, (500, 3))
    np.testing.assert_array_equal(tm.is_inside(probe), jm.is_inside(probe))
    np.testing.assert_array_equal(tm.sdf_func(probe), jm.sdf_func(probe))


@pytest.mark.parametrize("method", ["pseudo", "LHS", "Halton", "Hammersley", "Sobol"])
def test_unit_cube_sampler_matches(method):
    """The deterministic methods give the same points from the same seed;
    LHS and Sobol draw their own scrambling, so only shape, type and range
    are compared."""
    from paddlescience_tpu.geometry import sampler as jsampler
    from paddlescience_torch.geometry import sampler as tsampler

    np.random.seed(9)
    ref = jsampler.sample(64, 3, method)
    np.random.seed(9)
    got = tsampler.sample(64, 3, method)
    assert got.shape == ref.shape == (64, 3) and got.dtype == ref.dtype == np.float32
    assert ((got >= 0) & (got <= 1)).all()
    if method in ("pseudo", "Halton", "Hammersley"):
        np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------- equations --


def _models(inputs, outputs, seed=5):
    jm = psci.arch.MLP(inputs, outputs, LAYERS, WIDTH, activation="silu", weight_norm=True, rngs=Rngs(seed))
    tm = TMLP(inputs, outputs, LAYERS, WIDTH, activation="silu", weight_norm=True, device="cpu")
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    return jm, tm


@pytest.mark.parametrize("deriv", ["jet", "jet_pallas", "jet_pallas_full"])
@pytest.mark.parametrize("dim,time", [(3, False), (2, True)])
def test_navier_stokes_residuals_match_the_sympy_form(dim, time, deriv):
    coords = (("t",) if time else ()) + ("x", "y", "z")[:dim]
    outs = ("u", "v", "w", "p") if dim == 3 else ("u", "v", "p")
    jm, tm = _models(coords, outs)
    rng = np.random.default_rng(6)
    inp = {k: rng.uniform(-1.0, 1.0, (48, 1)).astype(np.float32) for k in coords}
    j_eq = psci.equation.NavierStokes(0.01, 1.3, dim, time)
    t_eq = TNavierStokes(0.01, 1.3, dim, time)
    assert set(t_eq.equations) == set(j_eq.equations)
    with jpath.override(jpath.CANDIDATES["jet"]):
        jr = jexpr.evaluate_expressions([jm], {k: jnp.asarray(v) for k, v in inp.items()},
                                        _convert_expr(j_eq.equations))
    with tpath.override(tpath.CANDIDATES[deriv]):
        tr = texpr.evaluate_expressions([tm], {k: torch.from_numpy(v) for k, v in inp.items()}, t_eq.equations)
    for name in j_eq.equations:
        _close(tr[name], jr[name], 1e-4)


def test_navier_stokes_with_a_string_viscosity_is_not_ported():
    """A bare name is a field and a number string a number; an expression
    string is read without sympy (held against JAX in
    ``test_torch_equations_basic.py``); only a form outside the reader's
    grammar is not ported, and raises naming it."""
    assert TNavierStokes("nu * (1 + x)", 1.0, 3, False).nu.names == ("nu", "x")
    with pytest.raises(NotImplementedError, match="Max"):
        TNavierStokes("Max(nu, x)", 1.0, 3, False)


def test_normal_dot_vec_and_integral_loss_on_point_sets():
    """NormalDotVec on (sets, points, 1) inputs: the model runs its batched
    forward, no derivative stack, and the area column rides to the loss."""
    jm, tm = _models(("x", "y", "z"), ("u", "v", "w", "p"))
    rng = np.random.default_rng(7)
    keys = ("x", "y", "z", "normal_x", "normal_y", "normal_z")
    inp = {k: rng.uniform(-1.0, 1.0, (2, 40, 1)).astype(np.float32) for k in keys}
    inp["area"] = np.full((2, 40, 1), 0.03, np.float32)
    jr = jexpr.evaluate_expressions([jm], {k: jnp.asarray(v) for k, v in inp.items()},
                                    _convert_expr(psci.equation.NormalDotVec(("u", "v", "w")).equations))
    tr = texpr.evaluate_expressions([tm], {k: torch.from_numpy(v) for k, v in inp.items()},
                                    TNormalDotVec(("u", "v", "w")).equations)
    _close(tr["normal_dot_vec"], jr["normal_dot_vec"], 1e-5)
    _close(tr["area"], jr["area"], 0)
    lab, wgt = {"normal_dot_vec": np.full((2, 1), 0.4, np.float32)}, {"normal_dot_vec": np.full((2, 1), 0.1, np.float32)}
    jl = psci.loss.IntegralLoss("sum")(jr, {k: jnp.asarray(v) for k, v in lab.items()},
                                       {k: jnp.asarray(v) for k, v in wgt.items()})
    tl = TIntegralLoss("sum")(tr, {k: torch.from_numpy(v) for k, v in lab.items()},
                              {k: torch.from_numpy(v) for k, v in wgt.items()})
    _close(tl["normal_dot_vec"], jl["normal_dot_vec"], 1e-5)


def test_mse_sum_weights_by_area_and_exponential_decay_matches():
    rng = np.random.default_rng(8)
    out = {"u": rng.standard_normal((30, 1)).astype(np.float32), "area": np.full((30, 1), 0.2, np.float32)}
    lab = {"u": rng.standard_normal((30, 1)).astype(np.float32)}
    jl = psci.loss.MSELoss("sum")({k: jnp.asarray(v) for k, v in out.items()}, {"u": jnp.asarray(lab["u"])})
    tl = TMSELoss("sum")({k: torch.from_numpy(v) for k, v in out.items()}, {"u": torch.from_numpy(lab["u"])})
    _close(tl["u"], jl["u"], 1e-6)
    kw = dict(epochs=100, iters_per_epoch=100, learning_rate=1e-3, gamma=0.95, decay_steps=15000)
    jf, tf = psci.optimizer.lr_scheduler.ExponentialDecay(**kw)(), TExponentialDecay(**kw)()
    for step in (0, 1, 7500, 15000, 9999):
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6)


# --------------------------------------------------------------- solver --


def test_build_solver_needs_the_stls(tmp_path):
    with pytest.raises(FileNotFoundError, match="gen_aneurysm_stl"):
        taneurysm.build_solver(str(tmp_path), device="cpu")


def _jax_solver(monkeypatch, stl_dir, tmp_path):
    """The JAX example's solver at MLP 3 x 32 with the test's batch sizes
    and its residual validator cut to ``VAL`` points."""
    mlp, geo_validator = psci.arch.MLP, psci.validate.GeometryValidator
    monkeypatch.setattr(janeurysm, "_STL", stl_dir)
    monkeypatch.setattr(psci.arch, "MLP", lambda i, o, n, w, **kw: mlp(i, o, LAYERS, WIDTH, **kw))
    monkeypatch.setattr(psci.validate, "GeometryValidator",
                        lambda expr, label, geom, cfg, *a, **kw: geo_validator(expr, label, geom, {**cfg, **VAL}, *a, **kw))
    return janeurysm.build_solver(epochs=1, iters_per_epoch=STEPS, output_dir=str(tmp_path), **BS)


def _port_solver(stl_dir, tmp_path):
    return taneurysm.build_solver(stl_dir, epochs=1, iters_per_epoch=STEPS, deriv="jet_pallas", width=WIDTH,
                                  num_layers=LAYERS, device="cpu", output_dir=str(tmp_path),
                                  val_total_size=VAL["total_size"], val_batch_size=VAL["batch_size"], **BS)


def test_three_train_steps_match_jax_solver(monkeypatch, stl_dir, tmp_path):
    """Per-constraint losses at every step, the step-0 gradient of every
    parameter, and the parameters after three Adam steps."""
    js = _jax_solver(monkeypatch, stl_dir, tmp_path)
    params0 = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    names = list(js.constraint)
    j_losses = []
    with jpath.override(jpath.CANDIDATES["jet_pallas"]):
        step_fn = js._build_train_step()
        host = {n: jax.tree.map(jnp.asarray, next(js.constraint[n].data_iter)) for n in names}
        j_grads0 = flatten_tree(jax.tree.map(np.asarray, jax.grad(
            lambda p: sum(js._constraint_losses(p, js.state["rest"], {}, host).values()))(js.state["params"])))
        for _ in range(STEPS):
            js.state, logs = step_fn(js.state, host)
            j_losses.append([float(logs["loss"])] + [float(logs[f"loss/{n}"]) for n in names])
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))

    ts = _port_solver(stl_dir, tmp_path)
    assert list(ts.constraint) == names
    assert ts.model.jet_segment_lengths() == [LAYERS]
    load_jax_params(ts.model, params0)
    for n in names:  # the same points and labels from the same seed
        for j_part, t_part in zip(host[n], ts._static_batches[n]):
            assert set(j_part) == set(t_part)
            for k in j_part:
                np.testing.assert_array_equal(t_part[k].numpy(), np.asarray(j_part[k]), err_msg=f"{n} {k}")
    t_losses = []
    for i in range(STEPS):
        logs = ts.train_step()
        t_losses.append([float(logs["loss"])] + [float(logs[f"loss/{n}"]) for n in names])
        if i == 0:
            t_grads0 = {n: p.grad.clone() for n, p in ts.model.named_parameters()}
    assert set(t_grads0) == set(j_grads0)
    for name, g in j_grads0.items():
        err = np.linalg.norm(t_grads0[name].numpy() - g) / np.linalg.norm(g)
        assert err < 1e-4, f"step-0 gradient of {name}: relative error {err:.2e}"
    np.testing.assert_allclose(np.array(t_losses), np.array(j_losses), rtol=1e-4)
    diffs = np.concatenate([np.abs(p.detach().numpy() - j_params[n]).ravel() for n, p in ts.model.named_parameters()])
    assert diffs.max() <= 1e-2 * LR


def test_residual_validator_matches_jax(monkeypatch, stl_dir, tmp_path):
    """The residual GeometryValidator: bitwise the same points and labels
    as the JAX example's, and from the same weights the same eval (each
    residual's MSE, the loss) within 1e-4, through the jet path."""
    js = _jax_solver(monkeypatch, stl_dir, tmp_path / "jax")
    ts = _port_solver(stl_dir, tmp_path / "port")
    load_jax_params(ts.model, flatten_tree(jax.tree.map(np.asarray, js.state["params"])))
    jv, tv = js.validator["residual"], ts.validator["residual"]
    assert len(tv.data_loader) == len(jv.data_loader) == VAL["total_size"] // VAL["batch_size"]
    for part in ("input", "label"):
        j_arrs, t_arrs = getattr(jv.dataset, part), getattr(tv.dataset, part)
        assert set(t_arrs) == set(j_arrs)
        for k in j_arrs:
            np.testing.assert_array_equal(t_arrs[k], j_arrs[k], err_msg=f"{part} {k}")
    with jpath.override(jpath.CANDIDATES["jet_pallas"]):
        j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    assert set(t_group["residual"]) == set(j_group["residual"]) == {
        f"MSE.{k}" for k in ("continuity", "momentum_x", "momentum_y", "momentum_z")}
    for key, ref in j_group["residual"].items():
        np.testing.assert_allclose(t_group["residual"][key], ref, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(t_metric, j_metric, rtol=1e-4)
    assert ts._eval_requests["residual"]  # the derivatives were served by the jet
