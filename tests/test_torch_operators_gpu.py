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

* the eighteenth slice's operators (UNONet, FNO1d, the velocity GAN's
  networks, AFNONet, SFNONet, CVit1D, CVit) on the card against the same
  module on the CPU with the same weights: each output, and the
  parameter gradient as one vector, within 1e-4 x its largest magnitude
  (cuFFT against pocketfft on spectra whose DC and Nyquist bins carry
  imaginary parts; strided "SAME" convs; JAX's resizes);
* the XPINN, hPINNs and velocity-GAN hand loops: two graphed chunks
  against the same steps eager within 1e-6 relative (cuDNN held to its
  deterministic algorithms); a loop run on a second derivative path
  captures a graph of its own.

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_operators_gpu.py``.
"""

import pytest
import torch

from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.utils.step_graph import deterministic_convs


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


def _card_vs_cpu(model, inputs):
    import copy

    cpu = copy.deepcopy(model).cpu()
    gen = torch.Generator().manual_seed(3)
    res = {}
    for tag, m, dev in (("card", model, "cuda"), ("cpu", cpu, "cpu")):
        out = m({k: v.to(dev) for k, v in inputs.items()})
        if tag == "card":
            cots = {k: torch.randn(v.shape, generator=gen) for k, v in out.items()}
        loss = sum((v * cots[k].to(dev)).sum() for k, v in out.items())
        ps = list(m.parameters())
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        res[tag] = [v.detach().cpu() for v in out.values()] + [torch.cat(
            [(g if g is not None else torch.zeros_like(p)).detach().cpu().reshape(-1) for g, p in zip(grads, ps)])]
    for a, b in zip(res["card"], res["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), 1e-30)


def _operators():
    from paddlescience_torch.arch import afno, cvit, geofno, sfnonet, unonet

    g = torch.Generator().manual_seed(0)
    rn = lambda *shape: torch.randn(*shape, generator=g)
    uno_kw = dict(in_channels=3, out_channels=1, hidden_channels=8, lifting_channels=16, projection_channels=16,
                  n_layers=4, uno_out_channels=(8, 16, 16, 8), uno_n_modes=((12, 12), (8, 8), (8, 8), (12, 12)),
                  uno_scalings=((1.0, 1.0), (0.5, 0.5), (2.0, 2.0), (1.0, 1.0)))
    return {
        "uno": lambda d: (unonet.UNONet(("a",), ("u",), device=d, **uno_kw), {"a": rn(4, 3, 16, 16)}),
        "fno1d": lambda d: (geofno.FNO1d(modes=16, width=16, padding=20, output_np=301, device=d),
                            {"input": rn(4, 257, 2)}),
        "velocity_generator": lambda d: (geofno.VelocityGenerator(("data",), ("v",), in_channels=1, dim=8,
                                                                  out_size=(32, 32), device=d),
                                         {"data": rn(4, 1, 32, 32)}),
        "velocity_discriminator": lambda d: (geofno.VelocityDiscriminator(("v",), ("s",), dim=8, device=d),
                                             {"v": rn(4, 1, 31, 30)}),
        "afno": lambda d: (afno.AFNONet(("x",), ("y0", "y1"), img_size=(32, 64), patch_size=(4, 4), in_channels=4,
                                        out_channels=4, embed_dim=32, depth=2, num_blocks=4,
                                        hard_thresholding_fraction=0.75, num_timestamps=2, device=d),
                           {"x": rn(2, 4, 32, 64)}),
        "sfno": lambda d: (sfnonet.SFNONet(("a",), ("u",), n_modes=(8, 8), hidden_channels=16, in_channels=3,
                                           out_channels=3, n_layers=2, img_size=(16, 32), device=d),
                           {"a": rn(4, 3, 16, 32)}),
        "cvit1d": lambda d: (cvit.CVit1D(("u", "y"), ("s",), spatial_dims=200, in_dim=1, coords_dim=1, grid_size=(200,),
                                         latent_dim=32, emb_dim=32, depth=2, num_heads=4, dec_emb_dim=32,
                                         dec_num_heads=4, mlp_ratio=2, device=d),
                             {"u": rn(4, 200, 1), "y": torch.rand(64, 1, generator=g)}),
        "cvit": lambda d: (cvit.CVit(("u", "y"), ("s",), in_dim=3, coords_dim=2, spatial_dims=(4, 32, 32),
                                     patch_size=(1, 4, 4), grid_size=(32, 32), latent_dim=32, emb_dim=32, depth=2,
                                     num_heads=4, dec_emb_dim=32, dec_num_heads=4, out_dim=3, device=d),
                           {"u": rn(2, 4, 32, 32, 3), "y": torch.rand(64, 2, generator=g)}),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uno", "fno1d", "velocity_generator", "velocity_discriminator", "afno", "sfno",
                                  "cvit1d", "cvit"])
def test_operator_on_the_card_equals_the_cpu(cuda_device, name):
    model, inputs = _operators()[name](cuda_device)
    _card_vs_cpu(model, inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("example", ["xpinn", "hpinns", "velocitygan_fwi"])
def test_hand_loop_graphed_chunks_equal_eager_steps(cuda_device, example):
    import importlib

    mod = importlib.import_module(f"paddlescience_torch.examples.{example}")
    small = {"xpinn": dict(num_residual1_points=256, num_residual2_points=128, num_residual3_points=128),
             "hpinns": dict(num_opt_points=128, num_pde_points=256)}.get(example)
    model = mod.build(small, device=cuda_device) if small is not None else mod.build(device=cuda_device)
    loop = model.loop
    snap = loop.snapshot()
    with deterministic_convs():  # cuDNN's atomics would reorder the GAN's weight-gradient sums
        loop.run(3)
        loop.run(3)
        graphed = torch.cat([t.detach().reshape(-1).float() for t in loop.state()])
        loop.restore(snap)
        loop.run(6, graphed=False)
        eager = torch.cat([t.detach().reshape(-1).float() for t in loop.state()])
    assert float((graphed - eager).norm() / eager.norm()) <= 1e-6


@pytest.mark.cuda
def test_hand_loop_keeps_a_graph_per_derivative_path(cuda_device):
    from paddlescience_torch.examples import xpinn

    model = xpinn.build(dict(num_residual1_points=256, num_residual2_points=128, num_residual3_points=128),
                        device=cuda_device)
    model.loop.run(2)
    tpath.set_default(tpath.CANDIDATES["jvp"])
    model.loop.run(2)
    paths = [key[1] for key in model.loop.graphs]
    assert len(paths) == 2 and paths[1] == tuple(sorted(tpath.CANDIDATES["jvp"].items())) and paths[0] != paths[1]
