"""The Earthformer family on the card, without JAX (tests marked
``cuda``, skipped without a card): the cuboid attention (a fully masked
query row, a bias and global keys; a shifted, padded layer with global
vectors) and the MoE gates (the same noise fed to both) on the card
against the CPU within 1e-5 of the largest magnitude, and the ENSO
solver's graphed epoch (one replay of a K-step CUDA graph, dropout and the
gates' noise drawn inside it) against K eager steps from the same fresh
state, under cuDNN's deterministic algorithms: parameters within 1e-6
relative.

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_earthformer_gpu.py``.
"""

import copy

import pytest
import torch

from paddlescience_torch.arch import cuboid_transformer as tct
from paddlescience_torch.arch import extformer_moe as tmoe
from paddlescience_torch.examples import earthformer_enso as tenso
from paddlescience_torch.utils.step_graph import deterministic_convs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, ref, tol=1e-5):
    got, ref = got.detach().cpu(), ref.detach().cpu()
    assert got.shape == ref.shape
    err = float((got - ref).abs().max() / max(float(ref.abs().max()), 1e-30))
    assert err <= tol, err


@pytest.mark.cuda
def test_masked_attention_card_matches_cpu(cuda_device):
    g = torch.Generator().manual_seed(0)
    B, nc, L, C, heads, G = 2, 5, 12, 16, 4, 3
    q, k, v = (torch.randn((B, nc, L, C), generator=g) for _ in range(3))
    mask = torch.rand((nc, L, L), generator=g) < 0.5
    mask[2, 4] = False  # a fully masked query row
    bias = torch.randn((heads, L, L), generator=g)
    kv_g = (torch.randn((B, G, C), generator=g), torch.randn((B, G, C), generator=g))
    for extra in (None, kv_g):
        cpu = tct._masked_mha(q, k, v, heads, mask, bias, extra)
        card = tct._masked_mha(q.cuda(), k.cuda(), v.cuda(), heads, mask.cuda(), bias.cuda(),
                               None if extra is None else tuple(t.cuda() for t in extra))
        _close(card, cpu)
        if extra is None:
            assert not card[:, 2, 4].abs().sum()  # the masked row: zeros, not NaN or uniform weights
    layer = tct.CuboidSelfAttention(16, 4, (2, 4, 4), (1, 2, 2), use_global=True, generator=g)
    x, gv = torch.randn((2, 3, 6, 10, 16), generator=g), torch.randn((2, 2, 16), generator=g)
    y_cpu, g_cpu = layer(x, gv)
    card = copy.deepcopy(layer).to(cuda_device)
    y, gu = card(x.cuda(), gv.cuda())
    _close(y, y_cpu)
    _close(gu, g_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("style", tmoe.GATE_STYLES)
def test_moe_gating_card_matches_cpu(cuda_device, style):
    cfg = tmoe.default_moe_config(num_experts=10, out_planes=4, gate_style=style, importance_weight=0.5,
                                  load_weight=0.5)
    g = torch.Generator().manual_seed(1)
    gate = tmoe.GatingNet(cfg, (4, 6, 8), 16, generator=g)
    x = torch.randn((2, 4, 6, 8, 16), generator=g)
    noise = torch.randn((2, 4, 6, 8, 10), generator=g)
    cpu = gate(x, noise=noise)
    card = copy.deepcopy(gate).to(cuda_device)(x.cuda(), noise=noise.cuda())
    assert torch.equal(card[1].cpu(), cpu[1])
    _close(card[0], cpu[0])
    _close(card[2], cpu[2])


@pytest.mark.cuda
@pytest.mark.parametrize("moe", [False, True], ids=["earthformer", "extformer_moe"])
def test_enso_graphed_epoch_matches_eager_steps(cuda_device, moe):
    kw = dict(in_len=6, out_len=4, lat=12, lon=16, base_units=16, iters_per_epoch=4, epochs=1, output_dir=None,
              device="cuda")
    if moe:
        kw.update(model_cls=tct.ExtFormerMoECuboid, num_experts=4)
    runs = {}
    with deterministic_convs():
        for k in (4, 1):
            s = tenso.make_solver(**kw)
            s.train(num_fused_steps=k)
            runs[k] = torch.cat([p.detach().reshape(-1) for p in s.model.parameters()])
            if k == 4:
                assert s.graph_stats[4]["replays"] == 1
        torch.cuda.synchronize()
    rel = float((runs[4] - runs[1]).norm() / runs[1].norm())
    assert rel <= 1e-6, rel
