"""The Solver's per-step train generator, on the CPU (no JAX): models
with ``set_train_rng`` (the Earthformer family) get the solver's
generator in train steps, so dropout and the MoE gates' noise are active
there and off in eval and predict; two solvers of one seed give bitwise
equal losses; a resumed checkpoint's generator state repeats the next
step's draws; the dropout keeps 1 - rate of its inputs and their mean.
(The same inside CUDA-graph chunks: ``test_torch_earthformer_gpu.py``.)"""

import os

import pytest
import torch

from paddlescience_torch.arch import cuboid_transformer as tct
from paddlescience_torch.examples import earthformer_enso as tenso
from paddlescience_torch.utils import save_load

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch at one thread while this file runs (the runner's parallel
    workers would otherwise share the cores many times over)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


TINY = dict(in_len=4, out_len=2, lat=8, lon=8, base_units=8, enc_depth=(1,), dec_depth=(1,), num_global_vectors=2)


def _tiny_enso(output_dir=None, model_cls=tct.CuboidTransformer, **kw):
    return tenso.make_solver(model_cls, epochs=2, output_dir=output_dir, device="cpu", **{**TINY, **kw})


def _first_input(s):
    inp, _, _ = next(iter(s.constraint.values())).data_iter.__next__()
    return {"sst": torch.from_numpy(inp["sst"])}, inp


def _forwards_with(model, x, generators):
    with torch.no_grad():
        out = []
        for g in generators:
            model.set_train_rng(g)
            out.append(model(x)["target"])
        return out


def test_solver_dropout_is_active_in_train_steps_and_off_in_eval():
    s = _tiny_enso()
    x, inp = _first_input(s)
    a, b, c, d = _forwards_with(s.model, x, [None, None, torch.Generator().manual_seed(1),
                                             torch.Generator().manual_seed(2)])
    assert torch.equal(a, b)  # no generator: deterministic
    assert not torch.equal(c, a) and not torch.equal(c, d)  # dropout draws from the generator
    s.train_step()
    assert s.model._train_gen is s.generator  # the step installed the solver's generator
    s.eval()
    assert s.model._train_gen is None
    s.train_step()
    s.predict({"sst": inp["sst"]})
    assert s.model._train_gen is None


def test_solver_moe_gate_noise_draws_from_the_solver_generator():
    s = _tiny_enso(model_cls=tct.ExtFormerMoECuboid, drop=0.0, num_experts=3)
    x, _ = _first_input(s)
    a, b, c = _forwards_with(s.model, x, [None, torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)])
    assert not torch.equal(b, a) and not torch.equal(b, c)  # no dropout here: the gates' noise
    s.train_step()
    assert s.model.inner._train_gen is s.generator
    s.eval()
    assert s.model.inner._train_gen is None


def test_same_seed_solvers_are_bitwise_equal_and_resume_repeats_the_draws(tmp_path):
    a, b = _tiny_enso(), _tiny_enso(str(tmp_path))
    la = [float(a.train_step()["loss"]) for _ in range(3)]
    assert la == [float(b.train_step()["loss"]) for _ in range(3)]
    b._save("after3")
    nxt = float(b.train_step()["loss"])
    losses = {}
    for restore_generator in (True, False):
        c = _tiny_enso()
        state = save_load.load_checkpoint(os.path.join(str(tmp_path), "checkpoints", "after3"))
        state.pop("_metric", None)
        if not restore_generator:
            state["generator"] = c.generator.get_state()
        c._load_state(state)
        cst = next(iter(c.constraint.values()))
        for _ in range(3):  # the loader is not part of the state: c's to where b's was
            next(cst.data_iter)
        losses[restore_generator] = float(c.train_step()["loss"])
    assert losses[True] == nxt  # the restored generator: the resumed step draws what the uninterrupted one drew
    assert losses[False] != nxt  # (the draws matter: another generator state gives another loss)


def test_remat_replays_the_draws_in_the_recompute():
    """``remat=True`` checkpoints each block; its recompute restores the
    generator, so the gradient is the plain model's from the same state."""
    grads = []
    for remat in (False, True):
        m = tct.CuboidTransformer(("x",), ("y",), (4, 8, 8, 1), (2, 8, 8, 1), base_units=8, enc_depth=(1,),
                                  dec_depth=(1,), self_pattern="axial", cross_self_pattern="axial",
                                  cross_pattern="cross_1x1", attn_drop=0.1, proj_drop=0.1, ffn_drop=0.1,
                                  remat=remat, device="cpu")
        m.set_train_rng(torch.Generator().manual_seed(5))
        x = torch.randn((2, 4, 8, 8, 1), generator=torch.Generator().manual_seed(6))
        loss = m({"x": x})["y"].square().sum()
        grads.append(torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, list(m.parameters()))]))
    assert torch.equal(grads[0], grads[1])


def test_dropout_keeps_the_expected_share_and_the_mean():
    x = torch.ones(200_000)
    y = tct._dropout(x, 0.1, torch.Generator().manual_seed(3))
    assert abs(float((y != 0).float().mean()) - 0.9) < 0.005
    assert abs(float(y.mean()) - 1.0) < 0.01
    assert torch.equal(tct._dropout(x, 0.1, None), x)
