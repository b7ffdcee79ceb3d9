"""The recurrent, misc and generative slice on the card, without JAX (tests
marked ``cuda``, skipped without a card):

* every new module (Embedding, the LSTM, both ConvLSTM cells and the pixel
  shuffle, Epnn, USCNN, HEDeepONets, ChipDeepONets, the Transformer,
  DeepPhyLSTM types 2 and 3, PhyCRNet, the AutoEncoder, the tempoGAN
  generator and discriminator) on the card against the same module on
  the CPU with the same weights and one batch: each output, and the
  parameter gradient of sum(out * c) as one vector, within 1e-4 of its
  largest magnitude, in float32 (cuDNN's and cuBLAS's sums in another
  order);
* phycrnet_burgers' hand loop, two graphed chunks of 3 steps against the
  same 6 steps eager (cuDNN held to its deterministic algorithms), and
  chip_heat's solver, a graphed epoch of 4 steps against 4 eager steps:
  bitwise;
* tempogan_lite's frames through the ``lbm_collide_stream`` kernel
  (launched, and within 1e-4 of the plain LBM step's on the card).

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_misc_gpu.py``.
"""

import copy

import pytest
import torch

from paddlescience_torch import arch as tarch
from paddlescience_torch.arch import phycrnet as tphy
from paddlescience_torch.nn import recurrent as trec
from paddlescience_torch.nn.layers import Embedding
from paddlescience_torch.utils.step_graph import deterministic_convs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the LBM kernel have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _card_vs_cpu(module, call, inputs, tol=1e-4):
    """``call(module, inputs) -> {name: tensor}`` on the card and on a CPU
    copy: outputs and the parameter gradient within ``tol``."""
    cpu = copy.deepcopy(module).cpu()
    card = copy.deepcopy(module).cuda()
    gen = torch.Generator().manual_seed(3)
    res = {}
    for tag, m, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        feed = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v) for k, v in inputs.items()}
        out = call(m, feed)
        if tag == "card":
            cots = {k: torch.randn(v.shape, generator=gen) for k, v in out.items()}
        loss = sum((v * cots[k].to(dev)).sum() for k, v in out.items())
        ps = [p for p in m.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, ps)
        res[tag] = ({k: v.detach().cpu() for k, v in out.items()}, torch.cat([g.reshape(-1).cpu() for g in grads]))
    for k in res["cpu"][0]:
        assert _rel(res["card"][0][k], res["cpu"][0][k]) <= tol, k
    assert _rel(res["card"][1], res["cpu"][1]) <= tol


def _dict_call(m, feed):
    return m(feed)


G = lambda: torch.Generator().manual_seed(0)  # noqa: E731


def _cases():
    r = torch.Generator().manual_seed(1)
    n = lambda *s: torch.randn(*s, generator=r)  # noqa: E731
    yield "embedding", Embedding(11, 8, generator=G()), lambda m, f: {"e": m(f["i"])}, \
        {"i": torch.randint(0, 11, (4, 6), generator=r)}
    yield "lstm", trec.LSTM(3, 16, generator=G()), lambda m, f: {"h": m(f["x"])}, {"x": n(4, 8, 3)}
    yield "conv_lstm_cell", trec.ConvLSTMCell(3, 8, 4, 2, 1, generator=G()), \
        lambda m, f: dict(zip("hc", m(f["x"], (f["h"], f["c"]))[1])), {"x": n(2, 3, 16, 16), "h": n(2, 8, 8, 8),
                                                                       "c": n(2, 8, 8, 8)}
    yield "phycrnet_cell", tphy.ConvLSTMCell(3, 8, 3, 1, 1, generator=G()), \
        lambda m, f: dict(zip("hc", m(f["x"], (f["h"], f["c"]))[1])), {"x": n(2, 3, 8, 8), "h": n(2, 8, 8, 8),
                                                                       "c": n(2, 8, 8, 8)}
    yield "pixel_shuffle", trec.ConvLSTMCell(2, 32, 3, 1, 1, generator=G()), \
        lambda m, f: {"y": trec.pixel_shuffle(m(f["x"], m.init_state(f["x"].shape))[0], 4)}, {"x": n(2, 2, 4, 4)}
    yield "epnn", tarch.Epnn(("s",), ("d",), (3, 64, 64, 1), ("leaky_relu", "leaky_relu"), device="cpu"), \
        _dict_call, {"s": n(64, 3)}
    yield "uscnn", tarch.USCNN(("c",), ("v",), (16, 32, 16), 0.01, 84, 19, nvar_in=2, device="cpu"), _dict_call, \
        {"c": n(1, 2, 19, 84)}
    yield "he_deeponets", tarch.HEDeepONets(("h",), ("c",), ("x", "t"), ("a", "b", "w"), 10, 10, 16, 3, 3, 32, 32,
                                            device="cpu"), _dict_call, \
        {"h": n(32, 10), "c": n(32, 10), "x": n(32, 1), "t": n(32, 1)}
    yield "chip_deeponets", tarch.ChipDeepONets(("u",), ("bc",), ("bd",), ("x", "y"), ("T",), 324, 1, 76, 400, 9, 9,
                                                6, 256, 256, 128, device="cpu"), _dict_call, \
        {"u": n(256, 324), "bc": torch.randint(0, 4, (256, 1), generator=r).float(), "bd": n(256, 76),
         "x": n(256, 1), "y": n(256, 1)}
    yield "transformer", tarch.Transformer(("s", "t"), ("l",), 64, 8, 128, 4, 2, 512, device="cpu"), _dict_call, \
        {"s": torch.randint(0, 64, (16, 24), generator=r).float(),
         "t": torch.randint(0, 8, (16, 8), generator=r).float()}
    phi = n(1, 32, 32) * 0.1
    for mt in (2, 3):
        yield f"deep_phylstm{mt}", tarch.DeepPhyLSTM(1, 1, 32, mt, device="cpu"), _dict_call, \
            {"ag": n(16, 32, 1), "ag_c": n(16, 32, 1), "phi": phi}
    yield "phycrnet", tarch.PhyCRNet(2, (8, 32, 32, 128), (4, 4, 4, 3), (2, 2, 2, 1), (1, 1, 1, 1), 0.002, (3, 1), 8,
                                     step=4, effective_step=(0, 1, 2, 3), device="cpu"), \
        lambda m, f: {f"o{i}": o for i, o in enumerate(m({"initial_state": None, "input": f["x"]})["outputs"])}, \
        {"x": n(1, 2, 32, 32)}
    vae = tarch.AutoEncoder(("p",), ("mu", "ls", "z"), 784, 50, 200, device="cpu")
    yield "autoencoder", vae, _dict_call, {"p": n(64, 784)}
    yield "generator", tarch.Generator(("i",), ("o",), 1, ((16, 16), (16, 16), (16, 1)), ((3, 3),) * 3,
                                       ((1, 1),) * 3, ((False, False),) * 3, (("relu", None),) * 3, device="cpu"), \
        _dict_call, {"i": n(4, 1, 64, 64)}
    yield "discriminator", tarch.Discriminator(("x",), ("f1", "f2", "s"), 1, (8, 16), 16 * 16 * 16, (3, 3), (2, 2),
                                               (False, False), ("leaky_relu", "leaky_relu"), device="cpu"), \
        _dict_call, {"x": n(4, 1, 64, 64)}


NAMES = ("embedding", "lstm", "conv_lstm_cell", "phycrnet_cell", "pixel_shuffle", "epnn", "uscnn", "he_deeponets",
         "chip_deeponets", "transformer", "deep_phylstm2", "deep_phylstm3", "phycrnet", "autoencoder", "generator",
         "discriminator")


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_module_card_matches_cpu(cuda_device, name):
    for case_name, module, call, inputs in _cases():  # built one at a time, up to the one asked for
        if case_name == name:
            _card_vs_cpu(module, call, inputs)
            return
    raise KeyError(name)


@pytest.mark.cuda
def test_phycrnet_graphed_chunks_equal_eager_steps(cuda_device):
    from paddlescience_torch.examples import phycrnet_burgers

    fit = phycrnet_burgers.build(device=cuda_device)
    with deterministic_convs():
        fit.train_steps(1)  # Adam's moments away from zero
        snap = fit.loop.snapshot()
        fit.train_steps(6, 3)
        graphed = torch.cat([t.detach().reshape(-1) for t in fit.state()])
        fit.loop.restore(snap)
        fit.train_steps(6, 1)
        eager = torch.cat([t.detach().reshape(-1) for t in fit.state()])
    assert torch.equal(graphed, eager)


@pytest.mark.cuda
def test_chip_heat_graphed_epoch_equals_eager_steps(cuda_device):
    from paddlescience_torch.examples import chip_heat

    runs = {}
    for k in (1, 4):
        s = chip_heat.build_solver(epochs=1, iters_per_epoch=4, nu=20, nbc=20, output_dir=None, device=cuda_device)
        s.train(num_fused_steps=k)
        runs[k] = torch.cat([p.detach().reshape(-1) for p in s.model.parameters()])
    assert torch.equal(runs[4], runs[1])


@pytest.mark.cuda
def test_tempogan_frames_run_the_lbm_kernel(cuda_device):
    from paddlescience_torch.examples import tempogan_lite
    from paddlescience_torch.ops import lbm

    lbm.reset_counters()
    frames = tempogan_lite.make_lbm_frames(4, 64, device=cuda_device)
    assert lbm.lbm_collide_stream.launches == 4 * 50 and lbm.lbm_collide_stream_plain.cuda_calls == 0
    plain = tempogan_lite.make_lbm_frames(4, 64, device=cuda_device, step=lbm.lbm_step_plain)
    assert _rel(frames, plain) <= 1e-4
