"""Import hygiene of the PyTorch port and the contract of chip_smoke.py
that a machine without a GPU can check.

The port runs where neither JAX, sympy nor optax is installed, so importing
it (every module of the slice) must load none of them, nor the JAX package.
"""

import ast
import os
import pathlib
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
