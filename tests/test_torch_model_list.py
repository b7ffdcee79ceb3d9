"""The port's ``ModelList``, ``Arch.freeze`` and frozen children in the
``Solver`` against paddlescience_tpu on the CPU, and the fused segments'
backward with frozen weights (no ``jet_wgrad``, None gradients).

The JAX solver zeroes a frozen child's updates after its optimizer's
transform; the port leaves the child's parameters out of the optimizer
(they require no gradient). Either way they never change: held bitwise.
Losses and the live child's parameters after three Adam steps: 1e-4
relative, as the other solver parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch import arch as tarch
from paddlescience_torch.autodiff import jet as tjet
from paddlescience_torch.constraint.constraints import SupervisedConstraint as TSup
from paddlescience_torch.loss.losses import MSELoss as TMSE
from paddlescience_torch.ops import jet_gated, jet_mlp
from paddlescience_torch.optimizer.optimizer import Adam as TAdam
from paddlescience_torch.solver.solver import Solver as TSolver
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

N = 16


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _data():
    rng = np.random.default_rng(0)
    inp = {"x": rng.random((N, 1), np.float32)}
    lab = {"u": np.ones((N, 1), np.float32), "k": np.ones((N, 1), np.float32)}
    return inp, lab


def _cfg(inp, lab):
    return {"dataset": {"name": "NamedArrayDataset", "input": inp, "label": lab}, "batch_size": N,
            "iters_per_epoch": 1, "sampler": {"name": "BatchSampler", "shuffle": False, "drop_last": False}}


def test_model_list_keys_forward_and_parameter_names_match_jax():
    jnets = [psci.arch.MLP(("x", "y"), ("u", "v"), 2, 8, rngs=Rngs(0)),
             psci.arch.MLP(("y", "z"), ("v", "w"), 2, 8, rngs=Rngs(1))]
    tnets = [tarch.MLP(("x", "y"), ("u", "v"), 2, 8, device="cpu"),
             tarch.MLP(("y", "z"), ("v", "w"), 2, 8, device="cpu")]
    jml, tml = psci.arch.ModelList(jnets), tarch.ModelList(tnets)
    assert tml.input_keys == jml.input_keys == ("x", "y", "z")
    assert tml.output_keys == jml.output_keys == ("u", "v", "w")
    params = flatten_tree(jax.tree.map(np.asarray, jml.param_tree()))
    assert set(params) == {n for n, _ in tml.named_parameters()}
    load_jax_params(tml, params)
    inp = {k: np.random.default_rng(1).random((5, 1), np.float32) for k in ("x", "y", "z")}
    jo = jml({k: jnp.asarray(v) for k, v in inp.items()})
    to = tml({k: torch.from_numpy(v) for k, v in inp.items()})
    assert list(to) == ["u", "v", "w"]
    for k in jo:  # "v" comes from the second child, as the JAX merge
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]), rtol=1e-6, atol=1e-7)


def test_freeze_and_unfreeze():
    net = tarch.MLP(("x",), ("u",), 2, 8, device="cpu")
    net.freeze()
    assert net.frozen and not any(p.requires_grad for p in net.parameters())
    live = tarch.MLP(("x",), ("k",), 2, 8, device="cpu")
    assert TAdam(1e-3)(tarch.ModelList((net, live))).params() == list(live.parameters())
    net.unfreeze()
    assert not net.frozen and all(p.requires_grad for p in net.parameters())


def test_frozen_model_params_stay_fixed():
    """The port's counterpart of ``tests/test_solver.py::test_frozen_model_params_stay_fixed``."""
    frozen = tarch.MLP(("x",), ("u",), 2, 8, device="cpu")
    live = tarch.MLP(("x",), ("k",), 2, 8, generator=torch.Generator().manual_seed(1), device="cpu")
    frozen.freeze()
    model = tarch.ModelList((frozen, live))
    inp, lab = _data()
    c = TSup(_cfg(inp, lab), TMSE("mean"), name="Sup")
    s = TSolver(model, {"Sup": c}, None, TAdam(1e-2)(model), epochs=2, iters_per_epoch=1, device="cpu")
    assert s.models == [frozen, live]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    s.train()
    for n, p in model.named_parameters():
        if n.startswith("model_list.0."):
            assert torch.equal(p, before[n]), n
    assert any(not torch.equal(p, before[n]) for n, p in model.named_parameters() if n.startswith("model_list.1."))


def test_three_steps_with_a_frozen_child_match_jax(tmp_path):
    """A frozen and a live MLP in a ModelList, one supervised constraint,
    Adam: three steps of the JAX solver and of the port's from the same
    weights give the same losses and live parameters; the frozen child's
    stay bitwise fixed in both."""
    frozen = psci.arch.MLP(("x",), ("u",), 2, 8, rngs=Rngs(0))
    live = psci.arch.MLP(("x",), ("k",), 2, 8, rngs=Rngs(1))
    frozen.freeze()
    jmodel = psci.arch.ModelList((frozen, live))
    inp, lab = _data()
    js = psci.solver.Solver(jmodel, {"Sup": psci.constraint.SupervisedConstraint(_cfg(inp, lab),
                                                                               psci.loss.MSELoss("mean"), name="Sup")},
                            str(tmp_path), psci.optimizer.Adam(1e-2)(jmodel), epochs=1, iters_per_epoch=3)
    p0 = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    step_fn = js._build_train_step()
    host = {"Sup": jax.tree.map(jnp.asarray, next(js.constraint["Sup"].data_iter))}
    j_losses = []
    for _ in range(3):
        js.state, logs = step_fn(js.state, host)
        j_losses.append(float(logs["loss"]))
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))

    tnets = [tarch.MLP(("x",), ("u",), 2, 8, device="cpu"), tarch.MLP(("x",), ("k",), 2, 8, device="cpu")]
    tnets[0].freeze()
    tmodel = tarch.ModelList(tnets)
    load_jax_params(tmodel, p0)
    ts = TSolver(tmodel, {"Sup": TSup(_cfg(inp, lab), TMSE("mean"), name="Sup")}, None, TAdam(1e-2)(tmodel),
                 epochs=1, iters_per_epoch=3, device="cpu")
    t_losses = [float(ts.train_step()["loss"]) for _ in range(3)]
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    for n, p in tmodel.named_parameters():
        if n.startswith("model_list.0."):
            np.testing.assert_array_equal(p.detach().numpy(), p0[n], err_msg=n)
            np.testing.assert_array_equal(j_params[n], p0[n], err_msg=n)
        else:
            np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=1e-4, atol=1e-6, err_msg=n)
            assert not np.array_equal(j_params[n], p0[n])


def _count_wgrad(monkeypatch):
    calls = []
    real = jet_mlp.jet_wgrad

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jet_mlp, "jet_wgrad", counted)
    return calls


@pytest.mark.parametrize("frozen", [True, False])
def test_mlp_segment_backward_skips_wgrad_for_frozen_weights(frozen, monkeypatch):
    """The segment's backward returns None for weights and biases that need
    no gradient, and then runs no jet_wgrad; the input streams' gradient
    is that of the unfrozen segment."""
    calls = _count_wgrad(monkeypatch)
    gen = torch.Generator().manual_seed(0)
    idx = tjet.build_index([(0,), (0, 0)])
    dims = (3, 8, 8)
    ws = [torch.randn(dims[l], dims[l + 1], generator=gen).requires_grad_(not frozen) for l in range(2)]
    bs = [torch.randn(dims[l + 1], generator=gen).requires_grad_(not frozen) for l in range(2)]
    xs = tuple(torch.randn(6, 3, generator=gen).requires_grad_() for _ in range(len(idx)))
    outs = jet_mlp._JetMLPSegment.apply(idx, False, 2, jet_mlp.TANH, *xs, *ws, *bs)
    grads = torch.autograd.grad(sum(o.square().sum() for o in outs), [*xs, *(p for p in ws + bs if p.requires_grad)])
    assert len(calls) == (0 if frozen else 1)
    ref = [t.detach().requires_grad_() for t in (*xs, *ws, *bs)]
    ro, _ = jet_mlp.jet_mlp_fwd_plain(ref[:3], ref[3:5], ref[5:], idx)
    rg = torch.autograd.grad(sum(o.square().sum() for o in ro), ref[:3])
    for g, r in zip(grads[:3], rg):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)


def test_gated_segment_backward_skips_wgrad_for_frozen_weights(monkeypatch):
    calls = _count_wgrad(monkeypatch)
    gen = torch.Generator().manual_seed(1)
    idx = tjet.build_index([(0,)])
    program = jet_gated.modified_mlp_program(2)
    W = 8
    ws = [torch.randn(W, W, generator=gen) for _ in range(2)]
    bs = [torch.randn(W, generator=gen) for _ in range(2)]
    y = tuple(torch.randn(5, W, generator=gen).requires_grad_() for _ in range(len(idx)))
    u = tuple(torch.randn(5, W, generator=gen) for _ in range(len(idx)))
    v = tuple(torch.randn(5, W, generator=gen) for _ in range(len(idx)))
    outs = jet_gated._JetGatedSegment.apply(idx, program, False, jet_mlp.TANH, *y, *u, *v, *ws, *bs)
    g = torch.autograd.grad(sum(o.sum() for o in outs), y)
    assert not calls and all(t.shape == (5, W) for t in g)


def test_kernel_candidates_stay_offered_when_one_child_is_eligible():
    """The autotuner offers the kernel candidates on CUDA where any of the
    solver's models is eligible for the fused segments: a ModelList of a
    weight-normed MLP 3 x 512 (eligible) and an MLP 3 x 32 with skip
    connections (which the segments do not take)."""
    import types

    from paddlescience_torch.autodiff import path as tpath
    from paddlescience_torch.solver import autotune

    wide = tarch.MLP(("x", "y"), ("u",), 3, 512, activation="silu", weight_norm=True, device="cpu")
    narrow = tarch.MLP(("x", "y"), ("k",), 3, 32, skip_connection=True, device="cpu")
    with tpath.override(tpath.CANDIDATES["jet_pallas"]):
        assert wide.jet_pallas_eligible() and not narrow.jet_pallas_eligible()
    fake = types.SimpleNamespace(models=[narrow, wide], device=torch.device("cuda"))
    assert autotune.candidate_names(fake) == ["jvp", "jet", *autotune._KERNEL_CANDIDATES]
    fake.models = [narrow]
    assert autotune.candidate_names(fake) == ["jvp", "jet"]
