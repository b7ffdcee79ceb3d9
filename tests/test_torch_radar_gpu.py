"""The radar and molecule slice on the card, without JAX (tests marked
``cuda``, skipped without a card):

* the dgmr example's hand loop, two graphed chunks of 2 steps against the
  same 4 steps eager, and nowcastnet_radar's solver, a graphed epoch of 4
  steps against 4 eager steps, each under cuDNN's deterministic
  algorithms: bitwise;
* DGMR, the discriminator pair and NowcastNet on the card against the same
  module on the CPU with the same weights and one batch: each output, and
  the parameter gradient of sum(out * c) as one vector, within 1e-4 of its
  largest magnitude, in float64 (float32 rounding in their batch norms
  over small batches reaches about 2e-5 of the largest output on any one
  device);
* ``warp``'s gather on the card: its forward and its fixed-order backward
  equal to the CPU's, and the backward bitwise from call to call;
* the MoFlow round trip on the card within 1e-4.

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_radar_gpu.py``.
"""

import copy

import pytest
import torch

from paddlescience_torch.arch import dgmr as tdgmr
from paddlescience_torch.arch import nowcasting as tnow
from paddlescience_torch.utils.step_graph import deterministic_convs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only there")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _card_vs_cpu(module, call, inputs, tol=1e-4):
    """``call(module, inputs) -> {name: tensor}`` on the card and on a CPU
    copy, both in float64: outputs and the parameter gradient within ``tol``."""
    cpu = copy.deepcopy(module).cpu().double()
    card = copy.deepcopy(module).cuda().double()
    gen = torch.Generator().manual_seed(3)
    res = {}
    for tag, m, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        out = call(m, {k: v.to(dev, torch.float64) for k, v in inputs.items()})
        if tag == "card":
            cots = {k: torch.randn(v.shape, generator=gen, dtype=torch.float64) for k, v in out.items()}
        loss = sum((v * cots[k].to(dev)).sum() for k, v in out.items())
        ps = [p for p in m.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        res[tag] = ({k: v.detach().cpu() for k, v in out.items()},
                    torch.cat([(g if g is not None else torch.zeros_like(p)).reshape(-1).cpu()
                               for g, p in zip(grads, ps)]))
    for k in res["cpu"][0]:
        assert _rel(res["card"][0][k], res["cpu"][0][k]) <= tol, k
    assert _rel(res["card"][1], res["cpu"][1]) <= tol


def _cases():
    r = torch.Generator().manual_seed(1)
    n = lambda *s: torch.randn(*s, generator=r)  # noqa: E731
    yield "dgmr", tdgmr.DGMR(("x",), ("y",), forecast_steps=2, output_shape=64, latent_channels=32,
                             context_channels=32, generation_steps=2, device="cpu"), \
        lambda m, f: m({"x": f["x"]}), {"x": n(2, 4, 1, 64, 64)}
    yield "discriminators", tdgmr.DGMRDiscriminators(input_channels=1, device="cpu"), \
        lambda m, f: dict(zip("st", m(f["x"]))), {"x": n(2, 4, 1, 64, 64)}
    yield "nowcastnet", tnow.NowcastNet(("x",), ("y",), input_length=4, total_length=10, image_height=32,
                                        image_width=32, ngf=16, device="cpu"), \
        lambda m, f: m({"x": f["x"]}), {"x": torch.rand(2, 4, 32, 32, 1, generator=r)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dgmr", "discriminators", "nowcastnet"])
def test_module_card_matches_cpu(cuda_device, name):
    for case_name, module, call, inputs in _cases():
        if case_name == name:
            _card_vs_cpu(module, call, inputs)
            return
    raise KeyError(name)


@pytest.mark.cuda
def test_dgmr_graphed_chunks_equal_eager_steps(cuda_device):
    from paddlescience_torch.examples import dgmr

    fit = dgmr.DGMRFit(t_out=4, device=cuda_device)
    with deterministic_convs():
        fit.train_steps(1)  # Adam's moments away from zero, the latent noise drawn
        snap = fit.loop.snapshot()
        fit.train_steps(4, 2)
        graphed = torch.cat([t.detach().reshape(-1) for t in fit.state()])
        fit.loop.restore(snap)
        fit.train_steps(4, 1)
        eager = torch.cat([t.detach().reshape(-1) for t in fit.state()])
    assert torch.equal(graphed, eager)


@pytest.mark.cuda
def test_nowcastnet_radar_graphed_epoch_equals_eager_steps(cuda_device):
    from paddlescience_torch.examples import nowcastnet_radar

    runs = {}
    with deterministic_convs():
        for k in (1, 4):
            s = nowcastnet_radar.build_solver(epochs=1, output_dir=None, device=cuda_device)
            s.train(num_fused_steps=k)
            runs[k] = torch.cat([p.detach().reshape(-1) for p in s.model.parameters()])
    assert torch.equal(runs[4], runs[1])


@pytest.mark.cuda
def test_warp_gather_on_the_card(cuda_device):
    r = torch.Generator().manual_seed(2)
    field = torch.randn(2, 3, 17, 19, generator=r)
    flow = torch.rand(2, 2, 17, 19, generator=r) * 8 - 4
    cot = torch.randn(2, 3, 17, 19, generator=r)
    for mode in ("nearest", "bilinear"):
        grads = []
        for dev in ("cpu", "cuda", "cuda"):
            f = field.to(dev).requires_grad_()
            out = tnow.warp(f, flow.to(dev), mode)
            (g,) = torch.autograd.grad(out, f, cot.to(dev))
            grads.append((out.detach().cpu(), g.cpu()))
        assert _rel(grads[1][0], grads[0][0]) <= 1e-6 and _rel(grads[1][1], grads[0][1]) <= 1e-5
        assert torch.equal(grads[1][1], grads[2][1])  # the backward repeats bitwise


@pytest.mark.cuda
def test_moflow_round_trip_on_the_card(cuda_device):
    from paddlescience_torch.examples import moflow_qm9

    fit = moflow_qm9.MoFlowFit(device=cuda_device)
    fit.train_steps(3)
    assert moflow_qm9.roundtrip_error(fit) < 1e-4
