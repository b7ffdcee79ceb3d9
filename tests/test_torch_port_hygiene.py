"""Import hygiene of the PyTorch port and the contract of chip_smoke.py
that a machine without a GPU can check.

The port runs where neither JAX, sympy nor optax is installed, so importing
it (every module of the slice) must load none of them, nor the JAX package.
"""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "paddlescience_torch"
FORBIDDEN = ("jax", "jaxlib", "paddlescience_tpu", "sympy", "optax")


def _modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_importing_every_port_module_loads_no_jax_sympy_or_optax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_nothing_forbidden(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_repo_script(path):
    """The port keeps its own copies of what it needs from the repo's
    scripts: no import of ``tools`` or ``examples`` (a module or a path
    put on ``sys.path`` for them)."""
    text = path.read_text()
    for node in ast.walk(ast.parse(text)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("tools", "examples", "gen_ldc_reference", "_ldc_common"), \
                f"{path.name} imports {name}"
    assert not re.search(r"sys\.path\.\w+\([^)]*(tools|examples)", text), f"{path.name} puts a script dir on sys.path"


CSRC = sorted((PORT / "csrc").glob("*.cu")) + sorted((PORT / "csrc").glob("*.cuh"))
NEW_MODULES = ("ops/jet_gated.py", "ops/lbm.py", "csrc/jet_gated_fwd.cu", "csrc/jet_gated_bwd.cu",
               "csrc/lbm_collide_stream.cu")


def test_the_gated_and_lbm_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in [*PORT.rglob("*.py"), *CSRC]}
    assert set(NEW_MODULES) <= checked


@pytest.mark.parametrize("path", CSRC, ids=lambda p: p.name)
def test_kernel_sources_have_a_plain_c_interface(path):
    """The kernels build with nvcc alone and bind through ctypes: no
    PyTorch, pybind or library-kernel headers (cuBLAS, CUTLASS, cuDNN), and
    every host entry point is extern "C"."""
    text = path.read_text()
    includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', text)
    for inc in includes:
        assert inc in ("cuda_runtime.h", "stdint.h", "jet_common.cuh"), f"{path.name} includes {inc}"
    if path.suffix == ".cu":
        assert 'extern "C" int ' + path.stem + "(" in text
        assert "<<<" in text, f"{path.name} launches no kernel of its own"


# Figures measured on a TPU (rates, utilisation, on-chip memory sizes) must
# not be carried into the port's sources as if they were its own.
TPU_FIGURES = [
    re.compile(r"\bMFU\b"),
    re.compile(r"\bv5e\b|\bv5 ?lite\b|\bv6e\b|\bv4-\d", re.I),
    re.compile(r"\d[\d.]*\s*(KiB|KB|MiB|MB|GiB|GB)\b[^.\n]*\bVMEM\b|\bVMEM\b[^.\n]*\d[\d.]*\s*(KiB|KB|MiB|MB|GiB|GB)\b"),
    re.compile(r"\bTPU\b[^.\n]*\d[\d.]*\s*(steps/s|ms\b|us\b|TFLOP|GB/s|TB/s|%)"),
    re.compile(r"\d[\d.]*\s*(steps/s|ms\b|TFLOP|GB/s|TB/s)[^.\n]*\bTPU\b"),
]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + CSRC + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_state_no_tpu_figures(path):
    for n, line in enumerate(path.read_text().splitlines(), 1):
        for pat in TPU_FIGURES:
            assert not pat.search(line), f"{path.name}:{n}: a TPU figure in the port: {line.strip()}"


def _run_smoke(cwd, hide_gpus):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="") if hide_gpus else None
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_chip_smoke_fails_without_a_gpu():
    res = _run_smoke(ROOT, hide_gpus=True)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run_smoke(tmp_path, hide_gpus=False)  # on a GPU machine: fails to find the port
    assert res.returncode != 0
    assert res.stdout.strip() == ""


ANEURYSM_MODULES = ("geometry/geometry.py", "geometry/mesh.py", "geometry/sampler.py", "examples/aneurysm.py",
                    "constraint/constraints.py", "equation/pde/basic.py")


def test_the_aneurysm_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(ANEURYSM_MODULES) <= checked


def _imported_names(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reaches_neither_tools_nor_the_native_library(path):
    """The port keeps its own copy of what it needs: no import of the
    repository's ``tools`` scripts, no read of the JAX package's C++ mesh
    library."""
    for name in _imported_names(path):
        assert name.split(".")[0] != "tools" and "gen_aneurysm_stl" not in name, f"{path.name} imports {name}"
    text = path.read_text()
    for needle in ("paddlescience_tpu/native", "libpsci_mesh", "mesh_kernels"):
        assert needle not in text, f"{path.name} names {needle}"


def test_chip_smoke_runs_the_stl_generator_only_as_a_subprocess():
    path = ROOT / "chip_smoke.py"
    assert not any("tools" in n.split(".") or "gen_aneurysm_stl" in n for n in _imported_names(path))
    tree = ast.parse(path.read_text())
    docstrings = {id(n.body[0].value) for n in ast.walk(tree)
                  if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
                  and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    mentions = [n for n in ast.walk(tree) if isinstance(n, ast.Constant) and "gen_aneurysm_stl" in str(n.value)
                and id(n) not in docstrings]
    assert mentions, "chip_smoke.py generates the aneurysm STLs"
    runs = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and isinstance(n.func.value, ast.Name) and n.func.value.id == "subprocess"]
    inside = {id(c) for call in runs for c in ast.walk(call)}
    assert all(id(m) in inside for m in mentions), "the STL generator is named outside a subprocess call"


TENTH_SLICE_MODULES = ("autodiff/ad.py", "utils/expression.py", "geometry/geometry_1d.py", "geometry/geometry_2d.py",
                       "geometry/geometry_3d.py", "geometry/geometry_nd.py", "geometry/csg.py",
                       "geometry/timedomain.py", "geometry/pointcloud.py", "optimizer/lr_scheduler.py",
                       "examples/euler_beam.py", "examples/cylinder2d_unsteady.py")


def test_the_nested_jvp_geometry_and_tipc_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(TENTH_SLICE_MODULES) <= checked


ELEVENTH_SLICE_MODULES = ("solver/autotune.py", "arch/deeponet.py", "ops/kinks.py", "examples/laplace2d.py",
                          "examples/ldc2d_steady.py", "examples/deeponet.py")


def test_the_autotuner_deeponet_and_new_example_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(ELEVENTH_SLICE_MODULES) <= checked


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_reads_no_cache_of_the_jax_package(path):
    """The port's autotuner keeps its own cache: no source names the JAX
    package's cache directory, in a path or as a directory name."""
    text = path.read_text()
    assert not re.search(r"\.cache\W+paddlescience_tpu", text), f"{path.name} names ~/.cache/paddlescience_tpu"
    consts = [n.value for n in ast.walk(ast.parse(text)) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
    assert "paddlescience_tpu" not in consts, f"{path.name} has the string 'paddlescience_tpu'"


def test_the_autotune_cache_is_the_ports_own(monkeypatch):
    from paddlescience_torch.solver import autotune

    monkeypatch.delenv("PSCI_AUTOTUNE_CACHE", raising=False)
    parts = pathlib.Path(autotune._cache_path()).parts
    assert parts[-3:] == (".cache", "paddlescience_torch", "deriv_autotune.json")
    assert "paddlescience_tpu" not in parts


TWELFTH_SLICE_MODULES = ("optimizer/linesearch.py", "optimizer/optimizer.py", "optimizer/lr_scheduler.py",
                         "loss/losses.py", "arch/fno.py", "arch/lno.py", "data/dataset/science_dataset.py",
                         "data/dataset/brusselator.py", "examples/darcy_tfno.py", "examples/brusselator3d_lno.py",
                         "utils/jax_params.py", "solver/solver.py")


def test_the_lbfgs_and_operator_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(TWELFTH_SLICE_MODULES) <= checked


THIRTEENTH_SLICE_MODULES = ("loss/mtl/__init__.py", "optimizer/lr_scheduler.py", "solver/solver.py",
                            "data/dataset/ldc_reference.py", "utils/ghia.py", "examples/ldc_curriculum.py",
                            "examples/allen_cahn.py", "arch/mlp.py", "arch/activation.py", "autodiff/jet.py")


def test_the_recipe_and_curriculum_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(THIRTEENTH_SLICE_MODULES) <= checked


FOURTEENTH_SLICE_MODULES = ("equation/pde/base.py", "equation/pde/basic.py", "equation/pde/extra.py",
                            "arch/model_list.py", "arch/base.py", "solver/solver.py", "utils/jax_params.py",
                            "geometry/raycast.py", "geometry/mesh.py", "ops/jet_mlp.py", "ops/jet_gated.py",
                            "loss/losses.py", "examples/bracket_elasticity.py", "examples/control_arm.py",
                            "examples/viv.py")


def test_the_elasticity_and_inverse_problem_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(FOURTEENTH_SLICE_MODULES) <= checked
    assert (PORT / "csrc" / "mesh_raycast.cpp").exists()


def test_the_mesh_raycast_source_is_the_ports_own():
    """The port's host C++ mesh code names nothing of the JAX package's
    native library."""
    text = (PORT / "csrc" / "mesh_raycast.cpp").read_text()
    for needle in ("paddlescience_tpu", "libpsci_mesh", "mesh_kernels", "native/"):
        assert needle not in text, f"mesh_raycast.cpp names {needle}"


FIFTEENTH_SLICE_MODULES = ("ops/jet_mlp.py", "examples/heart.py", "examples/aneurysm_flow.py", "examples/burgers.py",
                           "examples/shock_wave.py", "examples/nlsmb_soliton.py", "examples/nlsmb_rogue_wave.py",
                           "examples/heat_exchanger.py")


def test_the_heart_flow_and_small_example_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(FIFTEENTH_SLICE_MODULES) <= checked


@pytest.mark.parametrize("rel", dict.fromkeys(TENTH_SLICE_MODULES + ELEVENTH_SLICE_MODULES + TWELFTH_SLICE_MODULES
                                              + THIRTEENTH_SLICE_MODULES + FOURTEENTH_SLICE_MODULES
                                              + FIFTEENTH_SLICE_MODULES))
def test_the_new_modules_import_alone_without_jax(rel):
    """Each new module, imported first in a fresh process, loads no JAX,
    sympy, optax or JAX-package module."""
    mod = "paddlescience_torch." + rel[:-3].replace("/", ".")
    code = (f"import importlib, sys\nimportlib.import_module({mod!r})\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\nassert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


EIGHTEENTH_SLICE_MODULES = ("utils/step_graph.py", "examples/xpinn.py", "examples/hpinns.py", "geometry/mesh.py",
                            "examples/ldc_curriculum.py", "nn/layers.py", "nn/resize.py",
                            "arch/unonet.py", "examples/darcy_uno.py", "arch/geofno.py", "examples/catheter.py",
                            "data/dataset/domain_dataset.py", "examples/velocitygan_fwi.py", "arch/afno.py",
                            "data/dataset/science_dataset.py", "examples/fourcastnet.py",
                            "examples/fourcastnet_finetune.py", "examples/yinglong.py", "arch/sht.py",
                            "arch/sfnonet.py", "examples/sfno_swe.py", "arch/cvit.py", "data/dataset/array_dataset.py",
                            "examples/adv_cvit.py", "examples/ns_cvit.py")


def test_the_hand_loop_and_operator_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(EIGHTEENTH_SLICE_MODULES) <= checked


def test_the_eighteenth_slice_imports_without_jax_or_h5py():
    """Every module of the slice, imported in a fresh process, loads no JAX,
    sympy, optax or JAX-package module, and no h5py (the GPU machine has
    none: the HDF5 readers import it when they read a file)."""
    mods = ["paddlescience_torch." + rel[:-3].replace("/", ".") for rel in EIGHTEENTH_SLICE_MODULES]
    code = (f"import importlib, sys\nfor m in {mods!r}:\n    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('h5py',)!r})\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_port_has_no_torch_lbfgs():
    """optax's L-BFGS is copied by hand; ``torch.optim.LBFGS`` (another
    first step, line search and stopping rule) is used nowhere."""
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr == "LBFGS" and "optim" in ast.unparse(node.value):
                raise AssertionError(f"{path.name} uses {ast.unparse(node)}")
            if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("torch.optim"):
                assert "LBFGS" not in [a.name for a in node.names], path.name


TWENTY_SECOND_SLICE_MODULES = ("arch/dgmr.py", "arch/nowcasting.py", "arch/moflow_net.py",
                               "data/dataset/domain_dataset.py", "visualize/__init__.py", "visualize/visualizer.py",
                               "examples/dgmr.py", "examples/nowcastnet_radar.py", "examples/moflow_qm9.py",
                               "examples/moflow_optimize.py")


def test_the_radar_and_molecule_files_are_among_the_checked_sources():
    checked = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert set(TWENTY_SECOND_SLICE_MODULES) <= checked


def test_the_twenty_second_slice_imports_without_jax_h5py_or_matplotlib():
    """Every module of the slice, imported in a fresh process, loads no JAX,
    sympy, optax or JAX-package module, no h5py (the radar readers import
    it when they read a file) and no matplotlib (``VisualizerRadar``
    imports it when it writes a strip): the GPU machine may have neither."""
    mods = ["paddlescience_torch." + rel[:-3].replace("/", ".").removesuffix(".__init__")
            for rel in TWENTY_SECOND_SLICE_MODULES]
    code = (f"import importlib, sys\nfor m in {mods!r}:\n    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + ('h5py', 'matplotlib')!r})\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("rel", TWENTY_SECOND_SLICE_MODULES)
def test_the_radar_slice_calls_no_library_reorder_or_spectral_norm(rel):
    """The JAX modules' space-to-depth orders and fixed-u spectral norm are
    the port's own: no ``F.pixel_shuffle``/``F.pixel_unshuffle`` (another
    channel order) and no ``torch.nn.utils.spectral_norm`` (one iteration,
    u updated in place) on these paths."""
    for node in ast.walk(ast.parse((PORT / rel).read_text())):
        if isinstance(node, ast.Attribute) and node.attr in ("pixel_shuffle", "pixel_unshuffle", "spectral_norm"):
            raise AssertionError(f"{rel} reaches {ast.unparse(node)}")
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("torch"):
            names = {a.name for a in node.names}
            assert not names & {"pixel_shuffle", "pixel_unshuffle", "spectral_norm"}, (rel, names)
