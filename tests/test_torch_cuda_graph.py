"""The solver's chunks of train steps in a CUDA graph, without JAX.

On the CPU: what a captured step relies on, checked where it runs
eagerly: the training state is updated in place (parameters, Adam's state
made when the optimizer is built, the GradNorm weights the refresh writes,
the state a checkpoint or a warm-up restores), the jet seed builds its unit
tangents without a host copy, and a chunk on the CPU is eager steps.
On a GPU (tests marked ``cuda``, skipped elsewhere): two graphed chunks
against eager steps across a GradNorm refresh, a new batch every replay, a
capture that fails raises with the state untouched, and the aneurysm's
residual validator evaluating through the jet kernels.

This file imports only torch and the port, so it also runs where JAX is
not installed: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda_graph.py``.
"""

import os
import subprocess
import sys

import pytest
import torch

from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import allen_cahn
from paddlescience_torch.ops import jet_mlp as J

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_layers=2, hidden_size=32, fourier_dim=32, batch_size=512, ic_points=64, with_validator=False,
             output_dir=None, log_freq=10**6)


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


def _solver(device, **kw):
    return allen_cahn.build_solver(device=device, **{**SMALL, "deriv": "jet_pallas_full", **kw})


def _ptrs(solver):
    sd = solver.state_dict()
    tensors = list(sd["params"].values()) + [v for st in sd["opt_state"].values() for v in st.values()]
    return [t.data_ptr() for t in tensors + list(sd["agg_state"].values())] + [solver._step_t.data_ptr()]


def _flat(solver):
    return torch.cat([p.detach().reshape(-1) for p in solver.model.parameters()])


# ------------------------------------------------------------------ CPU --


def test_training_state_stays_in_place_across_steps_refreshes_and_loads(tmp_path):
    """Every tensor a captured step reads or writes keeps its storage: over
    eager steps with GradNorm refreshes, a checkpoint load and a
    warm-up's restore."""
    s = _solver("cpu", update_freq=2, output_dir=str(tmp_path), epochs=2, iters_per_epoch=4)
    before = _ptrs(s)
    snap = s.state
    s.train_steps(5)
    assert _ptrs(s) == before and s.step == 5 and float(s._step_t) == 5.0
    assert not torch.equal(s.agg_state["weight"], snap["agg_state"]["weight"])
    s._load_state(snap)
    assert _ptrs(s) == before and s.step == 0 and float(s._step_t) == 0.0
    for n, p in s.model.named_parameters():
        assert torch.equal(p, snap["params"][n])
    s.train(num_fused_steps=4)
    assert _ptrs(s) == before
    other = _solver("cpu", checkpoint_path=str(tmp_path / "checkpoints" / "latest"))
    assert torch.equal(_flat(other), _flat(s)) and other.step == s.step and float(other._step_t) == s.step


def test_a_chunk_on_the_cpu_is_eager_steps():
    """Chunks of 4 and 2 steps (GradNorm refreshed at 0 and 4, each at a
    chunk's start) equal 6 eager steps bitwise, and take no graph."""
    chunked, stepped = _solver("cpu", update_freq=4), _solver("cpu", update_freq=4)
    logs = chunked.train_chunk(4)
    chunked.train_chunk(2)
    stepped.train_steps(6)
    assert not chunked.graph_stats and chunked.step == stepped.step == 6
    assert torch.equal(_flat(chunked), _flat(stepped))
    assert torch.equal(chunked.agg_state["weight"], stepped.agg_state["weight"])
    assert set(logs) == {"loss", "loss/PDE", "loss/IC", "lr"} and float(logs["lr"]) > 0


def test_jet_seed_unit_tangents():
    x = torch.rand(5, 3)
    idx = tjet.build_index([(0,), (2,), (0, 2)])
    streams = tjet.seed(x, idx).streams
    assert torch.equal(streams[0], x)
    for s, axis in ((1, 0), (2, 2)):
        want = torch.zeros(5, 3)
        want[:, axis] = 1.0
        assert torch.equal(streams[s], want)
    assert not streams[3].any()


def test_adam_learning_rate_lives_on_the_device_only_for_cuda_params():
    s = _solver("cpu")
    assert s.optimizer.lr_t is None and s.optimizer.torch_opt.defaults["capturable"] is False
    logs = s.train_step()
    assert float(logs["lr"]) == pytest.approx(1e-3)


# ------------------------------------------------------------------ GPU --


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mlp", "piratenet"])
def test_graphed_chunks_equal_eager_steps_on_gpu(cuda_device, arch):
    """Two chunks of 4 steps in one captured graph against 8 eager steps,
    GradNorm refreshed at steps 0 and 4: parameters within 1e-6 relative
    (bitwise in practice), the same generator state and weights."""
    kw = dict(arch=arch, piratenet_blocks=2, deriv="jet_pallas_full", update_freq=4)
    graphed, eager = _solver(cuda_device, **kw), _solver(cuda_device, **kw)
    J.reset_counters()
    graphed.train_chunk(4)
    graphed.train_chunk(4)
    eager.train_steps(8)
    torch.cuda.synchronize()
    a, b = _flat(graphed), _flat(eager)
    assert float((a - b).norm() / b.norm()) <= 1e-6
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    torch.testing.assert_close(graphed.agg_state["weight"], eager.agg_state["weight"], rtol=1e-6, atol=0)
    assert graphed.graph_stats[4]["replays"] == 2 and graphed.step == eager.step == 8


@pytest.mark.cuda
def test_every_replay_draws_a_new_batch_on_gpu(cuda_device):
    s = _solver(cuda_device, deriv="jet_pallas_full")
    ds = s.constraint["PDE"].dataset
    draw, seen = ds.sample_fn, {}

    def spy(gen):
        out = draw(gen)
        seen.setdefault("t", torch.empty_like(out[0]["t"])).copy_(out[0]["t"])
        return out

    ds.sample_fn = spy
    batches = []
    for _ in range(3):
        s.train_chunk(3)
        batches.append(seen["t"].clone())
    torch.cuda.synchronize()
    assert not torch.equal(batches[0], batches[1]) and not torch.equal(batches[1], batches[2])
    assert s.graph_stats[3]["replays"] == 3


@pytest.mark.cuda
def test_a_capture_that_fails_raises_and_leaves_the_state_on_gpu(cuda_device):
    """A step that reads a value back to the host cannot be captured: the
    chunk raises (no eager fallback) and the training state is as before."""
    s = _solver(cuda_device, deriv="jet_pallas_full")
    ds = s.constraint["PDE"].dataset
    draw = ds.sample_fn
    ds.sample_fn = lambda gen: (lambda out: (out, float(out[0]["t"].sum()))[0])(draw(gen))
    s.train_steps(1)  # the GradNorm refresh of step 0, so the chunk below refreshes nothing
    before, gen_before = _flat(s).clone(), s.generator.get_state()
    with pytest.raises(RuntimeError, match="CUDA graph failed"):
        s.train_chunk(4)
    torch.cuda.synchronize()
    assert torch.equal(_flat(s), before) and torch.equal(s.generator.get_state(), gen_before) and s.step == 1
    assert not s.graph_stats


@pytest.mark.cuda
def test_aneurysm_residual_eval_runs_the_jet_kernels_on_gpu(cuda_device, tmp_path):
    from paddlescience_torch.examples import aneurysm

    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "gen_aneurysm_stl.py"), "--out", str(tmp_path)],
                   check=True, capture_output=True, timeout=300)
    s = aneurysm.build_solver(str(tmp_path), deriv="jet_pallas_full", device=cuda_device, width=64, num_layers=3,
                              bs_pde=256, bs_bc=64, integral_bs=64, val_total_size=600, val_batch_size=256,
                              output_dir=None)
    J.reset_counters()
    metric, group = s.eval()
    torch.cuda.synchronize()
    assert J.jet_mlp_fwd.launches == 2 and J.jet_mlp_bwd.launches == 0  # two batches, forward only
    assert J.jet_mlp_fwd_plain.cuda_calls == 0
    assert set(group["residual"]) == {f"MSE.{k}" for k in ("continuity", "momentum_x", "momentum_y", "momentum_z")}
    assert all(v == v and v < float("inf") for v in group["residual"].values()) and metric == group["residual"]["MSE.continuity"]
