"""The autotuner and the indexed-batch CUDA graphs on the card, without
JAX (tests marked ``cuda``, skipped without a card):

* ``autotune`` on a small Allen-Cahn solver (MLP 2 x 128): every candidate
  timed as a captured graph, the kernel candidates among them, the argmin
  installed and cached, a second call served from the cache without
  timing, the solver's state bitwise what it was, the losers' graphs
  dropped;
* the DeepONet example's indexed batches: ``train(num_fused_steps=K)``,
  K host batches staged a replay, bitwise equal to eager steps.

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_autotune_gpu.py``.
"""

import json

import pytest
import torch

from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.solver import autotune


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    saved = tpath.get_default()
    yield torch.device("cuda")
    tpath.set_default(saved)


@pytest.mark.cuda
def test_autotune_on_gpu(cuda_device, tmp_path, monkeypatch):
    from paddlescience_torch.examples import allen_cahn

    monkeypatch.setenv("PSCI_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    monkeypatch.setenv("PSCI_AUTOTUNE_CALLS", "2")
    tpath.set_default(None)
    solver = allen_cahn.build_solver(num_layers=2, hidden_size=128, fourier_dim=128, batch_size=512, ic_points=64,
                                     with_validator=False, output_dir=None, device=cuda_device)
    names = autotune.candidate_names(solver)
    assert names == ["jvp", "jet", "jet_pallas", "jet_pallas_full", "jet_pallas_full_sb"]
    before = solver.state
    winner = autotune.autotune(solver, solver._static_batches, fused=4)
    torch.cuda.synchronize()
    (entry,) = json.loads((tmp_path / "c.json").read_text()).values()
    times = entry["timings_ms_per_step"]
    assert set(times) == set(names) and winner == min(times, key=times.get)
    assert tpath.get_default() == tpath.CANDIDATES[winner]
    assert [key[1] for key in solver.loop.graphs] == [tuple(sorted(tpath.CANDIDATES[winner].items()))]
    after = solver.state_dict()
    assert torch.equal(after["generator"], before["generator"]) and after["step"] == before["step"]
    for n, v in before["params"].items():
        assert torch.equal(after["params"][n], v), n
    monkeypatch.setattr(autotune, "_time_candidate", lambda *a: pytest.fail("timed on a cache hit"))
    tpath.set_default(None)
    assert autotune.autotune(solver, solver._static_batches, fused=4) == winner


@pytest.mark.cuda
def test_indexed_graph_chunks_equal_eager_steps_on_gpu(cuda_device, tmp_path):
    from paddlescience_torch.examples import deeponet

    runs = {}
    for k in (1, 8):
        s = deeponet.build_solver(epochs=2, iters_per_epoch=8, n_train=4096, output_dir=str(tmp_path / f"k{k}"),
                                  device=cuda_device, log_freq=1)
        s.train(num_fused_steps=k)
        runs[k] = s
    torch.cuda.synchronize()
    assert runs[8].graph_stats[8]["replays"] == 2
    for (n, a), b in zip(runs[1].model.named_parameters(), runs[8].model.parameters()):
        assert torch.equal(a, b), n
