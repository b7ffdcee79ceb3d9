"""The operator examples and L-BFGS on the card, without JAX (tests marked
``cuda``, skipped without a card):

* darcy_tfno and brusselator3d_lno at small sizes: one epoch as one CUDA
  graph (the host batches staged a replay, the cuFFT plans made by the
  warm-up steps before the capture) equals the same epoch of eager steps
  within 1e-6 relative;
* ldc2d_steady with ``lbfgs=True``: two L-BFGS steps on the card against
  the same two on the CPU: losses within 1e-4 relative, the same number of
  line-search trials each step, parameters within 1e-3 of their largest
  magnitude.

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_operators_gpu.py``.
"""

import pytest
import torch

from paddlescience_torch.autodiff import path as tpath


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs, cuFFT and the card's L-BFGS path have no CPU mode")
    saved = tpath.get_default()
    yield torch.device("cuda")
    tpath.set_default(saved)


def _flat(solver):
    return torch.cat([p.detach().reshape(-1) for p in solver.model.parameters()])


def _graphed_epoch_equals_eager(build):
    runs = {}
    for graphed in (False, True):
        s = build()
        k = s.iters_per_epoch
        s.train(num_fused_steps=k if graphed else 1)
        runs[graphed] = (s, k)
    torch.cuda.synchronize()
    (g, k), (e, _) = runs[True], runs[False]
    a, b = _flat(g), _flat(e)
    assert g.graph_stats[k]["replays"] == 1 and g.step == e.step == k
    assert float((a - b).norm() / b.norm()) <= 1e-6


@pytest.mark.cuda
def test_darcy_graphed_epoch_equals_eager_steps(cuda_device, tmp_path):
    from paddlescience_torch.examples import darcy_tfno

    data = darcy_tfno.make_data(80, 16)
    _graphed_epoch_equals_eager(lambda: darcy_tfno.build_solver(epochs=1, n_train=64, n_eval=16, data=data,
                                                               output_dir=str(tmp_path), device=cuda_device))


@pytest.mark.cuda
def test_brusselator_graphed_epoch_equals_eager_steps(cuda_device, tmp_path):
    from paddlescience_torch.data.dataset import brusselator
    from paddlescience_torch.examples import brusselator3d_lno

    data = brusselator.generate(8, 4, device=cuda_device)
    _graphed_epoch_equals_eager(lambda: brusselator3d_lno.build_solver(
        epochs=1, iters_per_epoch=4, batch_size=2, data=data, output_dir=str(tmp_path), device=cuda_device))


@pytest.mark.cuda
def test_lbfgs_step_on_the_card_equals_the_cpu(cuda_device):
    from paddlescience_torch.examples import ldc2d_steady

    tpath.set_default(None)
    rows = {}
    for device in ("cpu", cuda_device):
        s = ldc2d_steady.build_solver(iters_per_epoch=1, lbfgs=True, output_dir=None, device=device)
        rows[str(device)] = ([(float(s.train_step()["loss"]), len(s.optimizer.linesearch.trace)) for _ in range(2)],
                             _flat(s).cpu())
    (cpu, p_cpu), (gpu, p_gpu) = rows["cpu"], rows[str(cuda_device)]
    assert [t for _, t in gpu] == [t for _, t in cpu]
    for (lg, _), (lc, _) in zip(gpu, cpu):
        assert abs(lg - lc) <= 1e-4 * abs(lc)
    assert float((p_gpu - p_cpu).abs().max()) <= 1e-3 * float(p_cpu.abs().max())
