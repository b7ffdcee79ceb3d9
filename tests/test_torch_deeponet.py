"""The port's DeepONet slice against paddlescience_tpu on the CPU: the MLP
options DeepONet needs (``input_dim``/``output_dim``, ``skip_connection``,
list-valued hidden sizes), the ``DeepONet`` arch, the solver over an
indexed ``NamedArrayDataset`` behind a ``BatchLoader``, and the example.

Both packages get the same parameters (``load_jax_params``) and the same
numpy-seeded inputs. Checked: forwards within 1e-6 and parameter gradients
within 1e-5 (relative to the largest magnitude); ``make_data`` bitwise
equal to the JAX example's; three train steps of the example (at
``n_train=1024``, shuffle off: the port's shuffled order comes from a
``torch.Generator``, the JAX loader's from numpy) against the JAX solver's
jitted step within 1e-4, and its L2Rel eval within 1e-5; the solver draws
a new batch each step, and ``train(num_fused_steps=K)`` equals K = 1
training bitwise.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import DeepONet as TDeepONet
from paddlescience_torch.arch.mlp import MLP as TMLP
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.examples import deeponet as tdeeponet
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import deeponet as jdeeponet  # noqa: E402  (the JAX example)

STEPS, N_TRAIN = 3, 1024


@pytest.fixture(autouse=True)
def _float32_and_paths():
    saved = tpath.get_default()
    with jax.default_matmul_precision("highest"):
        yield
    tpath.set_default(saved)


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _forward_and_grads(jm, tm, inputs, out_key):
    """Forward of both models and the gradients of sum(out * c) for a fixed
    cotangent c, per parameter name."""
    rng = np.random.default_rng(11)
    params, rest = jm.param_tree(), jm.buffer_tree()
    jout = np.asarray(jm({k: jnp.asarray(v) for k, v in inputs.items()})[out_key])
    cot = rng.standard_normal(jout.shape).astype(np.float32)

    def loss(p):
        with jm.bind(p, rest):
            return jnp.sum(jm({k: jnp.asarray(v) for k, v in inputs.items()})[out_key] * cot)

    j_grads = flatten_tree(jax.tree.map(np.asarray, jax.grad(loss)(params)))
    tout = tm({k: torch.from_numpy(v) for k, v in inputs.items()})[out_key]
    t_grads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(), list(tm.parameters()))
    return jout, tout, j_grads, dict(zip([n for n, _ in tm.named_parameters()], t_grads))


MLP_CASES = {
    "input_output_dims": dict(input_keys=("u",), output_keys=("b",), num_layers=2, hidden_size=24, input_dim=10,
                              output_dim=7),
    "skip_connection": dict(input_keys=("x", "y"), output_keys=("u", "v"), num_layers=5, hidden_size=16,
                            skip_connection=True),
    "list_widths": dict(input_keys=("x", "y"), output_keys=("u",), num_layers=None, hidden_size=[24, 12, 20],
                        activation="silu"),
    "all_three": dict(input_keys=("u",), output_keys=("b",), num_layers=None, hidden_size=[16, 16, 8, 8],
                      skip_connection=True, input_dim=6, output_dim=3, weight_norm=True),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_options_match_jax(case):
    kw = dict(MLP_CASES[case])
    jm = psci.arch.MLP(kw.pop("input_keys"), kw.pop("output_keys"), kw.pop("num_layers"), kw.pop("hidden_size"),
                       rngs=Rngs(3), **kw)
    kw = dict(MLP_CASES[case])
    tm = TMLP(kw.pop("input_keys"), kw.pop("output_keys"), kw.pop("num_layers"), kw.pop("hidden_size"),
              device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    rng = np.random.default_rng(5)
    width = MLP_CASES[case].get("input_dim", 1)
    inputs = {k: rng.uniform(-1, 1, (33, width)).astype(np.float32) for k in jm.input_keys}
    out_key = jm.output_keys[0]
    jout, tout, j_grads, t_grads = _forward_and_grads(jm, tm, inputs, out_key)
    _close(tout, jout, 1e-6)
    assert set(t_grads) == set(j_grads)
    for n, g in t_grads.items():
        _close(g, j_grads[n], 1e-5)


def test_mlp_options_take_the_plain_jet_where_jax_does():
    """``skip_connection`` keeps the MLP off the fused segments (and off
    the autotuner's kernel candidates), as ``jet_pallas_eligible`` does in
    JAX; list widths and explicit dims segment as usual."""
    tpath.set_default(tpath.CANDIDATES["jet_pallas_full"])
    skip = TMLP(("x", "y"), ("u",), 4, 16, skip_connection=True, device="cpu")
    assert not skip.jet_pallas_eligible() and skip.jet_segment_lengths() == []
    widths = TMLP(("x", "y"), ("u",), None, [24, 12, 20], device="cpu")
    assert widths.jet_pallas_eligible() and widths.jet_segment_lengths() == [3]
    with pytest.raises(ValueError, match="num_layers should be None"):
        TMLP(("x",), ("u",), 2, [8, 8], device="cpu")
    with pytest.raises(ValueError, match="num_layers should be an int"):
        TMLP(("x",), ("u",), None, 8, device="cpu")


def _deeponets(seed=2, act="relu", **kw):
    jm = psci.arch.DeepONet("u", "y", "G", 100, 40, 1, 1, 40, 40, branch_activation=act, trunk_activation=act,
                            rngs=Rngs(seed), **kw)
    tm = TDeepONet("u", "y", "G", 100, 40, 1, 1, 40, 40, branch_activation=act, trunk_activation=act,
                   device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    return jm, tm


@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_deeponet_forward_and_gradients_match_jax(act):
    jm, tm = _deeponets(act=act)
    inputs, _ = jdeeponet.make_data(64, seed=9)
    jout, tout, j_grads, t_grads = _forward_and_grads(jm, tm, inputs, "G")
    _close(tout, jout, 1e-6)
    assert tuple(tout.shape) == (64, 1) and set(t_grads) == set(j_grads)
    for n, g in t_grads.items():
        _close(g, j_grads[n], 1e-5)


def test_deeponet_options():
    """List widths and skip connections in branch and trunk, no bias."""
    kw = dict(branch_skip_connection=True, trunk_skip_connection=True, use_bias=False)
    jm = psci.arch.DeepONet("u", "y", "G", 20, 8, None, 3, [16, 16, 12], 16, rngs=Rngs(4), **kw)
    tm = TDeepONet("u", "y", "G", 20, 8, None, 3, [16, 16, 12], 16, device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()), jax.tree.map(np.asarray, jm.buffer_tree()))
    rng = np.random.default_rng(1)
    inputs = {"u": rng.standard_normal((17, 20)).astype(np.float32), "y": rng.uniform(size=(17, 1)).astype(np.float32)}
    jout, tout, j_grads, t_grads = _forward_and_grads(jm, tm, inputs, "G")
    _close(tout, jout, 1e-6)
    for n, g in t_grads.items():
        _close(g, j_grads[n], 1e-5)


def test_make_data_is_bitwise_the_jax_examples():
    for n, seed in ((N_TRAIN, 42), (2000, 7), (5, 0)):
        (ji, jl), (ti, tl) = jdeeponet.make_data(n, seed=seed), tdeeponet.make_data(n, seed=seed)
        for a, b in ((ji, ti), (jl, tl)):
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype == np.float32 and np.array_equal(a[k], b[k]), (n, k)


def _solvers(tmp_path, shuffle=False):
    js = jdeeponet.build_solver(epochs=1, iters_per_epoch=STEPS, output_dir=str(tmp_path / "jax"), n_train=N_TRAIN)
    loader = js.constraint["Sup"].data_loader
    loader.shuffle = shuffle
    js.constraint["Sup"].data_iter = iter(loader)
    ts = tdeeponet.build_solver(epochs=1, iters_per_epoch=STEPS, output_dir=str(tmp_path / "port"),
                                n_train=N_TRAIN, shuffle=shuffle, device="cpu")
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]), jax.tree.map(np.asarray, js.state["rest"]))
    return js, ts


def test_three_train_steps_match_jax_solver(tmp_path):
    js, ts = _solvers(tmp_path)
    assert len(ts.constraint["Sup"].data_loader) == len(js.constraint["Sup"].data_loader) == N_TRAIN // 312
    j_losses = []
    step_fn = js._build_train_step()
    for _ in range(STEPS):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        js.state, logs = step_fn(js.state, host)
        j_losses.append([float(logs[k]) for k in ("loss", "loss/Sup", "lr")])
    t_losses = [[float(v) for k, v in ts.train_step().items() if k in ("loss", "loss/Sup", "lr")]
                for _ in range(STEPS)]
    np.testing.assert_allclose(np.array(t_losses), np.array(j_losses), rtol=1e-4)
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    for n, p in ts.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), j_params[n], rtol=1e-4, atol=1e-6)


def test_l2rel_eval_matches_jax(tmp_path):
    js, ts = _solvers(tmp_path)
    j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    assert list(t_group) == list(j_group) == ["G_validator"]
    assert set(t_group["G_validator"]) == {"L2Rel.G"}
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-5)
    assert len(ts.validator["G_validator"].data_loader) == 4  # 2000 samples in batches of 500


def test_each_step_draws_a_new_batch(tmp_path):
    """A regression test: an indexed constraint's loader gives each step its
    next batch (a solver that staged one batch at build time would train
    on it forever)."""
    ts = tdeeponet.build_solver(epochs=1, iters_per_epoch=4, output_dir=None, n_train=N_TRAIN, device="cpu")
    seen = []
    real = ts._constraint_losses

    def spy(batches):
        seen.append(batches["Sup"][0]["y"].clone())
        return real(batches)

    ts._constraint_losses = spy
    for _ in range(3):
        ts.train_step()
    assert len(seen) == 3 and not torch.equal(seen[0], seen[1]) and not torch.equal(seen[1], seen[2])
    y_all = torch.from_numpy(ts.constraint["Sup"].dataset.input["y"])
    for b in seen:  # each a batch of the data set's rows
        assert b.shape == (312, 1) and bool(torch.isin(b, y_all).all())


@pytest.mark.parametrize("k", [2, 4])
def test_fused_chunks_equal_single_steps_bitwise(tmp_path, k):
    """``train(num_fused_steps=K)`` stages K host batches a chunk and reads
    slice i at step i: bitwise K = 1 training, with shuffling on."""
    runs = {}
    for fused in (1, k):
        ts = tdeeponet.build_solver(epochs=2, iters_per_epoch=4, output_dir=str(tmp_path / f"k{fused}"),
                                    n_train=N_TRAIN, device="cpu", log_freq=1)
        ts.train(num_fused_steps=fused)
        runs[fused] = ts
    assert runs[1].step == runs[k].step == 8
    assert [v for _, v in runs[1].loss_history][-1] == [v for _, v in runs[k].loss_history][-1]
    for (n, a), b in zip(runs[1].model.named_parameters(), runs[k].model.parameters()):
        assert torch.equal(a, b), n
    assert runs[k]._chunk_bufs[("Sup", k)][0]["u"].shape == (k, 312, 100)


def test_batches_of_two_shapes_raise(tmp_path):
    """``drop_last=False`` leaves a short last batch: a chunk that meets it
    raises instead of training on a ragged buffer."""
    from paddlescience_torch.constraint.constraints import SupervisedConstraint
    from paddlescience_torch.loss.losses import MSELoss
    from paddlescience_torch.optimizer.optimizer import Adam
    from paddlescience_torch.solver.solver import Solver

    inp, lab = tdeeponet.make_data(100, seed=1)
    sup = SupervisedConstraint({"dataset": {"name": "NamedArrayDataset", "input": inp, "label": lab},
                                "batch_size": 40, "sampler": {"drop_last": False}}, MSELoss(),
                               {"G": lambda out: out["G"]}, name="Sup")
    model = TDeepONet("u", "y", "G", 100, 8, 1, 1, 8, 8, device="cpu")
    ts = Solver(model, {"Sup": sup}, None, Adam(1e-3)(model), epochs=1, iters_per_epoch=3, device="cpu")
    with pytest.raises(ValueError, match="differ in shape"):
        ts.train(num_fused_steps=3)
