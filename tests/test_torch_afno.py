"""The port's AFNO slice against paddlescience_tpu on the CPU:
``AFNONet`` (hard thresholding, a rollout), ``PrecipNet``, dropout from
an explicit generator, the ERA5 windowing (an array against reading the
same array through h5py) and datasets, and the yinglong example (its fit
steps and rollout); the fourcastnet examples are
``test_torch_fourcastnet.py``'s.

Both packages get the same parameters (``load_jax_params``, conv kernels
transposed) and the same inputs; JAX runs at "highest" matmul precision
(``_operator_parity.py``). Tolerances (relative to the largest magnitude
of the JAX value): forwards 1e-5, parameter gradients 1e-4, fit losses and
rollout RMSEs 1e-4; datasets bitwise.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _operator_parity import arch_parity, highest_precision  # noqa: F401
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import afno as tafno
from paddlescience_torch.data.dataset import domain_dataset as tdd
from paddlescience_torch.data.dataset import science_dataset as tsd
from paddlescience_torch.examples import fourcastnet as tfcn
from paddlescience_torch.examples import fourcastnet_finetune as tfcn_ft
from paddlescience_torch.examples import yinglong as tyl
from paddlescience_torch.utils.jax_params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import fourcastnet as jfcn  # noqa: E402  (the JAX examples)
import yinglong as jyl  # noqa: E402


# ----------------------------------------------------------------- AFNO --

AFNO_KW = dict(img_size=(8, 16), patch_size=(2, 2), in_channels=3, out_channels=3, embed_dim=8, depth=2,
               num_blocks=2)


@pytest.mark.parametrize("frac,steps", [(1.0, 1), (0.5, 2)], ids=["all_modes", "half_modes_rollout"])
def test_afnonet_matches_jax(frac, steps):
    keys = tuple(f"y{i}" for i in range(steps))
    jm = psci.arch.AFNONet(("x",), keys, hard_thresholding_fraction=frac, num_timestamps=steps, rngs=Rngs(1),
                           **AFNO_KW)
    tm = tafno.AFNONet(("x",), keys, hard_thresholding_fraction=frac, num_timestamps=steps, device="cpu", **AFNO_KW)
    x = np.random.default_rng(2).standard_normal((2, 3, 8, 16)).astype(np.float32)
    arch_parity(jm, tm, {"x": x})


def test_precipnet_matches_jax():
    kw = dict(AFNO_KW, out_channels=1)
    jw = psci.arch.AFNONet(("x",), ("y",), rngs=Rngs(3), **AFNO_KW)
    jm = psci.arch.PrecipNet(("x",), ("p",), jw, rngs=Rngs(4), **kw)
    tw = tafno.AFNONet(("x",), ("y",), device="cpu", **AFNO_KW)
    tm = tafno.PrecipNet(("x",), ("p",), tw, device="cpu", **kw)
    x = np.random.default_rng(5).standard_normal((2, 3, 8, 16)).astype(np.float32)
    arch_parity(jm, tm, {"x": x})
    assert all(p.grad is None for p in tw.parameters())  # the wind model is frozen


def test_afno_dropout_draws_from_its_generator():
    """Off unless training with a generator; then two calls from one seed agree."""
    tm = tafno.AFNONet(("x",), ("y",), drop_rate=0.3, drop_path_rate=0.2, device="cpu", **AFNO_KW)
    x = {"x": torch.randn(2, 3, 8, 16, generator=torch.Generator().manual_seed(0))}
    plain = tm(x)["y"]
    tm.dropout_generator = torch.Generator().manual_seed(7)
    a = tm(x)["y"]
    tm.dropout_generator = torch.Generator().manual_seed(7)
    b = tm(x)["y"]
    assert torch.equal(a, b) and not torch.equal(a, plain)
    tm.eval()
    assert torch.equal(tm(x)["y"], plain)


# ----------------------------------------------------------------- ERA5 --

def test_era5_windowing_matches_reading_the_file(tmp_path):
    """``era5_windows`` on an array against the JAX ERA5Dataset reading the
    same array from an HDF5 file, and the port's reading of that file."""
    h5py = pytest.importorskip("h5py")
    from paddlescience_tpu.data.dataset.science_dataset import ERA5Dataset as JERA5

    data = np.random.default_rng(6).standard_normal((11, 3, 4, 8)).astype(np.float32)
    path = str(tmp_path / "era5.h5")
    with h5py.File(path, "w") as f:
        f["fields"] = data
    for kw in (dict(label_keys=("y",)), dict(label_keys=("y0", "y1"), num_label_timestamps=2, stride=2, size=4),
               dict(label_keys=("y",), vars_channel=(2, 0))):
        j = JERA5(path, ("x",), **kw)
        for t in (tsd.ERA5Dataset(None, ("x",), data=data, **kw), tsd.ERA5Dataset(path, ("x",), **kw)):
            assert set(t.input) == set(j.input) and set(t.label) == set(j.label)
            for k in j.input:
                assert np.array_equal(t.input[k], j.input[k])
            for k in j.label:
                assert np.array_equal(t.label[k], j.label[k])


def test_era5_sampled_dataset_is_bitwise_the_jax_packages():
    from paddlescience_tpu.data.dataset.domain_dataset import ERA5SampledDataset as JS

    j, t = JS(None, ("x",), ("y",), num_samples=3), tdd.ERA5SampledDataset(None, ("x",), ("y",), num_samples=3)
    assert np.array_equal(t.input["x"], j.input["x"]) and np.array_equal(t.label["y"], j.label["y"])


def test_fourcastnet_synthetic_fields_are_the_jax_examples(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = jfcn._make_synthetic_era5(str(tmp_path / "era5.h5"))
    with h5py.File(path, "r") as f:
        assert np.array_equal(tfcn.make_synthetic_era5(), np.asarray(f["fields"]))


def test_fourcastnet_finetune_warm_starts_from_the_pretrain_checkpoint(tmp_path):
    pre = tfcn.build_solver(epochs=1, output_dir=str(tmp_path / "pre"), device="cpu")
    pre.train_steps(1)
    pre._save("latest", print_log=False)
    ft = tfcn_ft.build_solver(str(tmp_path / "pre" / "checkpoints" / "latest"), epochs=1,
                              output_dir=str(tmp_path / "ft"), device="cpu")
    assert ft.model.output_keys == ("output_0", "output_1")
    for (n, a), (_, b) in zip(pre.model.named_parameters(), ft.model.named_parameters()):
        assert torch.equal(a, b), n


def test_yinglong_fit_and_rollout_match_jax():
    """Three fit steps of the JAX example's step (rebuilt from its source
    with the same network and data), then the four-step rollout's RMSEs."""
    import optax

    model = psci.arch.AFNONet(("input",), ("output",), img_size=(jyl.H, jyl.W), in_channels=jyl.C + 2,
                              out_channels=jyl.C, patch_size=(4, 4), embed_dim=96, depth=2, num_blocks=4)
    data = jyl.synth_fields()
    assert np.array_equal(tyl.synth_fields(), data)
    params = model.param_tree()
    yl = tyl.YingLong(device="cpu")
    load_jax_params(yl.model, jax.tree.map(np.asarray, params))
    x = jnp.asarray(np.concatenate([data[:, 0], np.broadcast_to(jyl.time_features(0), (len(data), jyl.H, jyl.W, 2))],
                                   -1))
    y = jnp.asarray(data[:, 1])
    tx = optax.adam(1e-3)
    opt = tx.init(params)

    @jax.jit
    def step(params, opt):
        def loss_fn(p):
            pred = model.apply(p, {"input": x.transpose(0, 3, 1, 2)})["output"]
            return jnp.mean((pred.transpose(0, 2, 3, 1) - y) ** 2)

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(g, opt)
        return optax.apply_updates(params, upd), opt, loss

    for _ in range(3):
        params, opt, loss = step(params, opt)
        np.testing.assert_allclose(yl.fit(1), float(loss), rtol=1e-4)
    frame, want = jnp.asarray(data[:, 0]), []
    for s in range(1, 5):
        inp = jnp.concatenate([frame, jnp.asarray(np.broadcast_to(jyl.time_features(s - 1), frame.shape[:-1] + (2,)))],
                              -1).transpose(0, 3, 1, 2)
        frame = model.apply(params, {"input": inp})["output"].transpose(0, 2, 3, 1)
        want.append(float(jnp.sqrt(jnp.mean((frame - jnp.asarray(data[:, s])) ** 2))))
    np.testing.assert_allclose(yl.rollout(4), want, rtol=1e-4)
