"""Frozen weights through the fused segments on the card, without JAX
(tests marked ``cuda``, skipped without a card):

* ``_JetMLPSegment`` with weights and biases that need no gradient: the
  backward returns None for them, launches ``jet_mlp_bwd`` for the input
  streams' cotangent and no ``jet_wgrad``; the streams' gradient equals
  the unfrozen segment's;
* the control arm's inverse solver at a small width on jet_pallas_full:
  a few graphed steps leave the frozen networks bitwise unchanged, move
  the Lame networks, and launch no backward kernel (the frozen networks'
  jet needs no gradient at all).

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_frozen_gpu.py``.
"""

import pytest
import torch

from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.ops import jet_mlp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    saved = tpath.get_default()
    yield torch.device("cuda")
    tpath.set_default(saved)


@pytest.mark.cuda
def test_segment_backward_with_frozen_weights_launches_no_wgrad(cuda_device):
    gen = torch.Generator(device="cuda").manual_seed(0)
    idx = tjet.build_index([(0,), (1,), (2,)])
    dims = (3, 64, 64, 64)
    rn = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    ws = [rn(dims[l], dims[l + 1]) / dims[l] ** 0.5 for l in range(3)]
    bs = [0.1 * rn(dims[l + 1]) for l in range(3)]
    xs = [rn(300, 3).requires_grad_() for _ in range(len(idx))]
    grads = {}
    for frozen in (True, False):
        w = [t.clone().requires_grad_(not frozen) for t in ws]
        b = [t.clone().requires_grad_(not frozen) for t in bs]
        jet_mlp.reset_counters()
        outs = jet_mlp._JetMLPSegment.apply(idx, False, 3, jet_mlp.TANH, *xs, *w, *b)
        # the segment's backward on the cotangents of sum |out|^2: (index, save_bounds, n_layers, act,
        # streams, weights, biases)
        raw = outs[0].grad_fn.apply(*[2 * o.detach() for o in outs])
        torch.cuda.synchronize()
        assert jet_mlp.jet_mlp_bwd.launches == 1
        assert jet_mlp.jet_wgrad.launches == (0 if frozen else 1)
        params = raw[4 + len(idx):]
        assert len(params) == 6 and all((g is None) == frozen for g in params)
        grads[frozen] = raw[4 : 4 + len(idx)]
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_inverse_solver_keeps_the_frozen_networks_and_launches_no_backward(cuda_device, tmp_path):
    from paddlescience_torch.examples import control_arm

    fwd, geom = control_arm.build_forward(epochs=1, iters_per_epoch=4, output_dir=None, n_interior=256, n_bc=32,
                                          sample_iters=1, width=64, num_layers=3, deriv="jet_pallas_full",
                                          device=cuda_device, geom_path=str(tmp_path / "arm.stl"))
    fwd.train_steps(2)
    inv = control_arm.build_inverse(fwd, geom, epochs=1, iters_per_epoch=4, output_dir=None, n_interior=256,
                                    sample_iters=1)
    before = {n: p.detach().clone() for n, p in inv.model.named_parameters()}
    jet_mlp.reset_counters()
    inv.train(num_fused_steps=4)
    torch.cuda.synchronize()
    assert jet_mlp.jet_mlp_fwd.launches > 0
    assert jet_mlp.jet_mlp_bwd.launches == 0 and jet_mlp.jet_wgrad.launches == 0
    for n, p in inv.model.named_parameters():
        if n.startswith(("model_list.0.", "model_list.1.")):
            assert torch.equal(p, before[n]), n
    assert any(not torch.equal(p, before[n]) for n, p in inv.model.named_parameters()
               if n.startswith(("model_list.2.", "model_list.3.")))
