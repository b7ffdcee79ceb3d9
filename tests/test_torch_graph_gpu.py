"""The graph slice on the card, without JAX (tests marked ``cuda``,
skipped without a card): the fixed-order segment sum and gather
(``nn/segment.py``) bitwise equal over two calls, forward and backward,
at a kNN graph's receivers, and within 1e-5 of the largest magnitude of
the ``index_add_`` version; one MeshGraphNet Adam step captured in a CUDA
graph against the same step run eagerly from the same state (bitwise
expected, 1e-6 relative held); the UNetEx topopt step likewise.

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_graph_gpu.py``.
"""

import numpy as np
import pytest
import torch

from paddlescience_torch.arch.graph_nets import MeshGraphNet
from paddlescience_torch.data.dataset.domain_dataset import make_synthetic_graph
from paddlescience_torch.examples.graph_fit import GraphFit, to_device
from paddlescience_torch.nn import segment as seg
from paddlescience_torch.utils.step_graph import deterministic_convs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_segment_sum_and_gather_repeat_bitwise(cuda_device):
    _, _, s, r, _ = make_synthetic_graph(np.random.default_rng(0), 4096, 4, 5, 3, 3)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    e = torch.randn((len(r), 64), generator=g, device=cuda_device, requires_grad=True)
    x = torch.randn((4096, 64), generator=g, device=cuda_device, requires_grad=True)
    cot_n = torch.randn((4096, 64), generator=g, device=cuda_device)
    cot_e = torch.randn((len(r), 64), generator=g, device=cuda_device)
    runs = []
    for _ in range(2):
        agg = seg.segment_sum(e, r, 4096)
        rows = seg.gather(x, s)
        ge, gx = torch.autograd.grad((agg * cot_n).sum() + (rows * cot_e).sum(), (e, x))
        runs.append([t.detach().clone() for t in (agg, rows, ge, gx)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    plain = seg.segment_sum_plain(e.detach(), torch.as_tensor(r, device=cuda_device).long(), 4096)
    agg, _, _, gx = runs[0]
    for got, ref in ((agg, plain), (gx, seg.segment_sum_plain(cot_e, torch.as_tensor(s, device=cuda_device).long(),
                                                               4096))):
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def _flat(fit):
    return torch.cat([t.detach().reshape(-1).float() for t in fit.state()])


@pytest.mark.cuda
def test_mesh_graph_net_graphed_step_equals_eager(cuda_device):
    samples = []
    rng = np.random.default_rng(1)
    for _ in range(2):
        nf, ef, s, r, lab = make_synthetic_graph(rng, 256, 4, 5, 3, 3)
        samples.append(({"g": to_device((nf, ef, s, r), cuda_device, host=(2, 3))},
                        torch.as_tensor(lab, device=cuda_device)))
    model = MeshGraphNet(("g",), ("o",), 5, 3, 3, hidden=64, n_layers=4, device=cuda_device)
    fit = GraphFit(model, samples, 1e-3, "o", cuda_device)
    fit.train_steps(2, graphed=False)  # moments away from zero
    snap = fit.snapshot()
    fit.train_steps(4, graphed=True)
    torch.cuda.synchronize()
    graphed = _flat(fit)
    fit.restore(snap, 2)
    fit.train_steps(4, graphed=False)
    eager = _flat(fit)
    assert all(loop.stats[1]["replays"] == 2 for loop in fit.loops)
    assert float((graphed - eager).norm() / eager.norm()) <= 1e-6
    assert torch.equal(graphed, eager)


@pytest.mark.cuda
def test_topopt_graphed_epoch_equals_eager(cuda_device):
    from paddlescience_torch.examples import topopt

    runs = {}
    with deterministic_convs():
        for k in (1, 4):  # 16 training samples in batches of 4: one epoch of 4 steps
            s = topopt.build_solver(epochs=1, n_samples=20, batch_size=4, output_dir=None, device=cuda_device)
            c = s.constraint["sup_constraint"]
            c.data_loader.shuffle = False
            np.random.seed(0)  # the augmentation's draws
            s.train(num_fused_steps=k)
            runs[k] = torch.cat([p.detach().reshape(-1) for p in s.model.parameters()])
    rel = float((runs[4] - runs[1]).norm() / runs[1].norm())
    assert rel <= 1e-6, rel
