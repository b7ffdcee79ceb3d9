"""The port's derivative-path autotuner (``paddlescience_torch/solver/
autotune.py``) against ``tests/test_autotune.py`` on the CPU, and the
port examples' unpinned default path against the JAX examples'.

One counterpart of each JAX test: flag resolution order, the CPU
candidates (the same list as JAX's for the same model), pick and cache,
training after tuning (losses bitwise those of a run pinned to the winner
from the start), the signature against the kernel sources, the
multi-process skip. Port-specific: the solver's state is bitwise what it
was before tuning; only the kernels' pre-launch refusal drops a candidate,
any other failure propagates. And: with no ``deriv``, each of the four
older example builders leaves the derivative path where the JAX example's
default leaves it (the JAX side read as on the TPU: Pallas available, the
lane gate applied).
"""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.autodiff import path as jpath
from paddlescience_tpu.nn.core import Rngs
from paddlescience_tpu.ops import jet_pallas
from paddlescience_tpu.solver import autotune as jautotune
from paddlescience_torch.arch.mlp import MLP as TMLP
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.constraint.base import Constraint
from paddlescience_torch.data import DeviceSampledDataset
from paddlescience_torch.equation.pde.basic import AllenCahn
from paddlescience_torch.loss.losses import MSELoss
from paddlescience_torch.ops.jet_mlp import KernelRefusal
from paddlescience_torch.optimizer.optimizer import Adam
from paddlescience_torch.solver import autotune
from paddlescience_torch.solver.solver import Solver

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("PSCI_JET", "PSCI_JET_PALLAS", "PSCI_JET_PALLAS_MLP", "PSCI_JET_PALLAS_MIN_LANES", "PSCI_JET_SEG",
         "PSCI_JET_PBLOCK_GROUP", "PSCI_JET_SAVE_BOUNDS")


@pytest.fixture(autouse=True)
def _clean_paths(monkeypatch):
    for name in [*FLAGS, "PSCI_JET_PALLAS_INTERPRET", "PSCI_AUTOTUNE", "PSCI_AUTOTUNE_CACHE"]:
        monkeypatch.delenv(name, raising=False)
    saved = tpath.get_default()
    tpath.set_default(None)
    jpath.set_default(None)
    yield
    tpath.set_default(saved)
    jpath.set_default(None)


def test_flag_resolution_order(monkeypatch):
    monkeypatch.setenv("PSCI_JET", "0")
    assert tpath.flag("PSCI_JET", "1") == "0"  # env beats built-in
    tpath.set_default({"PSCI_JET": "1"})
    assert tpath.flag("PSCI_JET", "1") == "1"  # default beats env
    with tpath.override({"PSCI_JET": "0"}):
        assert tpath.flag("PSCI_JET", "1") == "0"  # override beats all
    assert tpath.flag("PSCI_JET", "1") == "1"
    tpath.set_default(None)
    assert tpath.flag("PSCI_JET", "1") == "0"


def _tiny_solver(batch=64, iters=4, epochs=1, model=None):
    """The JAX test's tiny solver: MLP 2x16, the AllenCahn residual on a
    device-sampled batch, Adam 1e-3."""
    model = model or TMLP(("t", "x"), ("u",), 2, 16, generator=torch.Generator().manual_seed(0), device="cpu")
    eq = AllenCahn(eps=0.01)

    def sample_fn(gen):
        t = torch.rand(batch, 1, generator=gen)
        x = torch.rand(batch, 1, generator=gen) * 2 - 1
        return {"t": t, "x": x}, {"allen_cahn": torch.zeros(batch, 1)}, {}

    pde = Constraint(DeviceSampledDataset(sample_fn), None, MSELoss("mean"), "PDE")
    pde.output_expr = eq.equations
    return Solver(model, {"PDE": pde}, None, Adam(1e-3)(model), epochs=epochs, iters_per_epoch=iters,
                  log_freq=10**9, device="cpu")


def _jax_tiny(model):
    from paddlescience_tpu.constraint.base import Constraint as JConstraint
    from paddlescience_tpu.data import DeviceSampledDataset as JDS

    import jax.numpy as jnp

    def sample_fn(key):
        return {"t": jnp.zeros((8, 1)), "x": jnp.zeros((8, 1))}, {"allen_cahn": jnp.zeros((8, 1))}, {}

    pde = JConstraint(JDS(sample_fn), None, psci.loss.MSELoss("mean"), "PDE")
    pde.output_expr = psci.equation.AllenCahn(eps=0.01).equations
    return psci.solver.Solver(model, {"PDE": pde}, None, psci.optimizer.Adam(1e-3)(model), epochs=1,
                              iters_per_epoch=2, log_freq=10**9)


@pytest.mark.parametrize("arch", ["mlp", "piratenet"])
def test_candidate_names_cpu(arch):
    """On the CPU both packages offer jvp and jet only, for the same model;
    on CUDA the port adds the kernel candidates where a model is eligible
    under the jet_pallas flags (and not for an MLP with skip connections)."""
    if arch == "mlp":
        jm = psci.arch.MLP(("t", "x"), ("u",), 2, 16, rngs=Rngs(0))
        tm = TMLP(("t", "x"), ("u",), 2, 16, device="cpu")
    else:
        from paddlescience_torch.arch.mlp import PirateNet

        fourier = {"dim": 16, "scale": 1.0}
        jm = psci.arch.PirateNet(("t", "x"), ("u",), 2, 16, fourier=fourier, rngs=Rngs(0))
        tm = PirateNet(("t", "x"), ("u",), 2, 16, fourier=fourier, device="cpu")
    names = autotune.candidate_names(_tiny_solver(model=tm))
    assert names == jautotune.candidate_names(_jax_tiny(jm)) == ["jvp", "jet"]
    fake_cuda = types.SimpleNamespace(models=[tm], device=torch.device("cuda"))
    assert autotune.candidate_names(fake_cuda) == ["jvp", "jet", "jet_pallas", "jet_pallas_full",
                                                   "jet_pallas_full_sb"]
    skip = TMLP(("t", "x"), ("u",), 2, 16, skip_connection=True, device="cpu")
    assert autotune.candidate_names(types.SimpleNamespace(models=[skip], device=torch.device("cuda"))) == [
        "jvp", "jet"]


def test_autotune_picks_and_caches(tmp_path, monkeypatch):
    cache_file = tmp_path / "autotune.json"
    monkeypatch.setenv("PSCI_AUTOTUNE_CACHE", str(cache_file))
    monkeypatch.setenv("PSCI_AUTOTUNE_FUSED", "2")
    monkeypatch.setenv("PSCI_AUTOTUNE_CALLS", "1")
    timed = []
    real = autotune._time_candidate

    def spy(solver, k, calls):
        timed.append(tpath.get_default())
        return real(solver, k, calls)

    monkeypatch.setattr(autotune, "_time_candidate", spy)
    solver = _tiny_solver()
    winner = autotune.autotune(solver, solver._static_batches, fused=2)
    assert winner in ("jvp", "jet")
    assert tpath.get_default() == tpath.CANDIDATES[winner]
    assert timed == [tpath.CANDIDATES["jvp"], tpath.CANDIDATES["jet"]]  # each pinned whole
    saved = json.loads(cache_file.read_text())
    (entry,) = saved.values()
    assert entry["winner"] == winner == min(entry["timings_ms_per_step"], key=entry["timings_ms_per_step"].get)
    assert set(entry["timings_ms_per_step"]) == {"jvp", "jet"}

    # a second run hits the cache: no timing, the file unchanged
    tpath.set_default(None)
    solver2 = _tiny_solver()
    monkeypatch.setattr(autotune, "_time_candidate", lambda *a: pytest.fail("timed on a cache hit"))
    assert autotune.autotune(solver2, solver2._static_batches, fused=2) == winner
    assert json.loads(cache_file.read_text()) == saved
    assert tpath.get_default() == tpath.CANDIDATES[winner]


def test_training_correct_after_autotune(tmp_path, monkeypatch):
    """The losses of ``train()`` with PSCI_AUTOTUNE=1 equal, bitwise, those
    of a run with the winner pinned from the start: timing trains nothing."""
    monkeypatch.setenv("PSCI_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setenv("PSCI_AUTOTUNE_FUSED", "2")
    monkeypatch.setenv("PSCI_AUTOTUNE_CALLS", "1")
    monkeypatch.setenv("PSCI_AUTOTUNE", "1")
    tuned = _tiny_solver(iters=4, epochs=2)
    tuned.train()
    winner = next(n for n, f in tpath.CANDIDATES.items() if f == tpath.get_default())
    monkeypatch.setenv("PSCI_AUTOTUNE", "0")
    tpath.set_default(tpath.CANDIDATES[winner])
    pinned = _tiny_solver(iters=4, epochs=2)
    pinned.train()
    assert tuned.loss_history == pinned.loss_history and len(tuned.loss_history) == 2
    for (n, a), b in zip(tuned.model.named_parameters(), pinned.model.parameters()):
        assert torch.equal(a, b), n


def test_state_after_tuning_is_bitwise_the_state_before(tmp_path, monkeypatch):
    monkeypatch.setenv("PSCI_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setenv("PSCI_AUTOTUNE_FUSED", "3")
    monkeypatch.setenv("PSCI_AUTOTUNE_CALLS", "2")
    solver = _tiny_solver()
    solver.train_steps(2)  # a state with a non-zero Adam moment and step
    before = solver.state
    autotune.autotune(solver, solver._static_batches, fused=4)
    after = solver.state_dict()
    assert after["step"] == before["step"] == 2
    assert torch.equal(after["generator"], before["generator"])
    for n in before["params"]:
        assert torch.equal(after["params"][n], before["params"][n]), n
    for i, st in before["opt_state"].items():
        for key, v in st.items():
            assert torch.equal(after["opt_state"][i][key], v), (i, key)
    for key, v in before["agg_state"].items():
        assert torch.equal(after["agg_state"][key], v)


def test_autotune_times_a_solver_with_indexed_batches(tmp_path, monkeypatch):
    """A solver with an indexed constraint (heart's shuffled DATA loader):
    each candidate's timing first draws K host batches into the chunk
    buffers, as a train chunk does, so every candidate is timed; the state
    is bitwise what it was."""
    from paddlescience_torch.examples import heart

    monkeypatch.setenv("PSCI_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setenv("PSCI_AUTOTUNE_FUSED", "2")
    monkeypatch.setenv("PSCI_AUTOTUNE_CALLS", "1")
    solver = heart.build_solver("inverse", epochs=1, iters_per_epoch=4, output_dir=None,
                                geom_dir=str(tmp_path / "heart"), n_interior=32, n_bc=8, n_data=16, sample_iters=1,
                                width=8, num_layers=2, device="cpu")
    assert solver._indexed == ["DATA"]
    before = solver.state
    winner = autotune.autotune(solver, solver._static_batches, fused=4)
    entry = next(iter(json.loads((tmp_path / "c.json").read_text()).values()))
    assert winner in ("jvp", "jet") and set(entry["timings_ms_per_step"]) == {"jvp", "jet"}
    after = solver.state_dict()
    for n in before["params"]:
        assert torch.equal(after["params"][n], before["params"][n]), n
    assert torch.equal(after["eq_params"]["E"], before["eq_params"]["E"])


def test_only_the_kernel_refusal_drops_a_candidate(tmp_path, monkeypatch):
    """A candidate the kernels refuse (before any launch) is dropped and the
    reason cached; any other error from a candidate propagates, the
    caller's path and the solver's state put back."""
    monkeypatch.setenv("PSCI_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setenv("PSCI_AUTOTUNE_FUSED", "1")
    monkeypatch.setenv("PSCI_AUTOTUNE_CALLS", "1")
    real = autotune._time_candidate

    def refuse_jet(solver, k, calls):
        if tpath.get_default() == tpath.CANDIDATES["jet"]:
            raise KernelRefusal("the kernels take 1..8 streams, got 9")
        return real(solver, k, calls)

    monkeypatch.setattr(autotune, "_time_candidate", refuse_jet)
    solver = _tiny_solver()
    assert autotune.autotune(solver, solver._static_batches, fused=1) == "jvp"
    (entry,) = json.loads((tmp_path / "c.json").read_text()).values()
    assert entry["refused"] == {"jet": "the kernels take 1..8 streams, got 9"}

    def fail_jet(solver, k, calls):
        if tpath.get_default() == tpath.CANDIDATES["jet"]:
            solver._step(solver.step)  # trains a step, then fails
            raise RuntimeError("an injected launch failure")
        return real(solver, k, calls)

    monkeypatch.setenv("PSCI_AUTOTUNE_CACHE", str(tmp_path / "d.json"))
    monkeypatch.setattr(autotune, "_time_candidate", fail_jet)
    caller = {"PSCI_JET": "1"}
    tpath.set_default(caller)
    solver = _tiny_solver()
    before = solver.state
    with pytest.raises(RuntimeError, match="injected launch failure"):
        autotune.autotune(solver, solver._static_batches, fused=1)
    assert tpath.get_default() == caller
    assert all(torch.equal(p, before["params"][n]) for n, p in solver.model.named_parameters())
    assert not (tmp_path / "d.json").exists()


def test_signature_changes_with_kernel_source(tmp_path, monkeypatch):
    """A change of a kernel source (or of the jet, path or segment modules)
    changes the cache key."""
    solver = _tiny_solver()
    sig1 = autotune.signature(solver, solver._static_batches)
    orig = autotune._source_version
    monkeypatch.setattr(autotune, "_source_version", lambda: "deadbeef0badcafe")
    assert autotune.signature(solver, solver._static_batches) != sig1
    monkeypatch.setattr(autotune, "_source_version", orig)
    assert autotune.signature(solver, solver._static_batches) == sig1  # deterministic
    pkg = tmp_path / "pkg"
    for sub in ("autodiff", "ops", "csrc"):
        shutil.copytree(os.path.join(autotune._PKG, sub), pkg / sub)
    monkeypatch.setattr(autotune, "_PKG", str(pkg))
    v1 = autotune._source_version()
    cu = pkg / "csrc" / "jet_wgrad.cu"
    cu.write_text(cu.read_text() + "\n// a change\n")
    assert autotune._source_version() != v1


def test_maybe_autotune_gated_multiprocess(monkeypatch):
    """Ranks of a multi-process run must not each pick by their own clock:
    maybe_autotune is a no-op at world size > 1."""
    monkeypatch.setenv("PSCI_AUTOTUNE", "1")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    solver = _tiny_solver()
    assert autotune.maybe_autotune(solver, solver._static_batches, fused=2) is None
    assert not tpath.get_default()  # no winner installed


# ------------------------------------------------ the examples' default path --


@pytest.fixture(scope="module")
def stl_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("stl")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "gen_aneurysm_stl.py"), "--out", str(out)],
                   check=True, capture_output=True, timeout=300)
    return str(out)


def _port_model(case, stl_dir):
    from paddlescience_torch.examples import allen_cahn, aneurysm, cylinder2d_unsteady, euler_beam

    if case in ("mlp", "piratenet"):
        return allen_cahn.build_solver(arch=case, piratenet_blocks=9, batch_size=32, ic_points=8, device="cpu",
                                       with_validator=False, output_dir=None).model
    if case == "aneurysm":
        return aneurysm.build_solver(stl_dir, bs_pde=32, bs_bc=16, integral_bs=16, val_total_size=32,
                                     val_batch_size=32, device="cpu", output_dir=None).model
    if case == "cylinder":
        return cylinder2d_unsteady.build_solver(pde_points=32, bc_points=16, ic_points=16, validator_points=32,
                                                device="cpu", output_dir=None).model
    return euler_beam.build_solver(device="cpu", output_dir=None).model


def _jax_model(case):
    """The JAX example's model, structurally (the widths, depth, activation
    and weight norm that eligibility reads)."""
    if case == "mlp":
        return psci.arch.MLP(("t", "x"), ("u",), 4, 256, rngs=Rngs(0))
    if case == "piratenet":
        return psci.arch.PirateNet(("t", "x"), ("u",), 9, 256, fourier={"dim": 256, "scale": 2.0}, rngs=Rngs(0))
    if case == "aneurysm":
        return psci.arch.MLP(("x", "y", "z"), ("u", "v", "w", "p"), 6, 512, activation="silu", weight_norm=True,
                             rngs=Rngs(0))
    if case == "cylinder":
        return psci.arch.MLP(("t", "x", "y"), ("u", "v", "p"), 5, 50, rngs=Rngs(0))
    return psci.arch.MLP(("x",), ("u",), 3, 20, rngs=Rngs(0))


@pytest.mark.parametrize("case", ["mlp", "piratenet", "aneurysm", "cylinder", "euler_beam"])
def test_unpinned_examples_take_the_jax_default_path(monkeypatch, stl_dir, case):
    """No ``deriv``: the builder pins nothing, the flags resolve to the JAX
    package's defaults, and the model takes fused segments exactly where
    the JAX model would on the TPU (gated stacks on the segments, in groups
    of 3 blocks; plain MLPs, and layers under 128 lanes, on the plain jet)."""
    tm = _port_model(case, stl_dir)
    assert tpath.get_default() == {}
    monkeypatch.setattr(jet_pallas, "pallas_available", lambda: True)  # as on the TPU: the lane gate applies
    monkeypatch.setattr(jet_pallas, "interpret_forced", lambda: False)
    jm = _jax_model(case)
    defaults = {"PSCI_JET": "1", "PSCI_JET_PALLAS": "1", "PSCI_JET_PALLAS_MLP": "0", "PSCI_JET_PALLAS_MIN_LANES": "128",
                "PSCI_JET_SEG": "", "PSCI_JET_PBLOCK_GROUP": "3", "PSCI_JET_SAVE_BOUNDS": "0"}
    for name, d in defaults.items():
        assert tpath.flag(name, d) == jpath.flag(name, d) == d, name
    eligible = jm.jet_pallas_eligible()
    assert tm.jet_pallas_eligible() == eligible
    gated = case == "piratenet"
    takes = eligible and (gated or jpath.flag("PSCI_JET_PALLAS_MLP", "0") == "1")
    lengths = tm.jet_segment_lengths()
    assert bool(lengths) == takes
    assert lengths == ([9, 9, 9] if case == "piratenet" else [])
