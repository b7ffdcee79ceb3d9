"""The port's UNO and FNO1d against paddlescience_tpu on the CPU: JAX's
resize and "SAME" strided convolution (the traps), ``UNONet``, ``FNO1d``,
``FWIDataset`` and the catheter example (the velocity GAN is
``test_torch_velocitygan.py``'s); the inverse real FFT of a spectrum that
is not Hermitian.

Both packages get the same parameters (``load_jax_params``, conv kernels
transposed) and the same numpy-seeded inputs; JAX runs at "highest"
matmul precision (``_operator_parity.py``). Tolerances (relative to the
largest magnitude of the JAX value): forwards 1e-5, parameter gradients of
a scalar loss 1e-4, the first three train steps of an example 1e-4;
resizes 1e-6; datasets bitwise.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _operator_parity import arch_parity, close, highest_precision, three_steps  # noqa: F401
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import geofno as tgeofno
from paddlescience_torch.arch import unonet as tuno
from paddlescience_torch.data.dataset import domain_dataset as tdd
from paddlescience_torch.examples import catheter as tcath
from paddlescience_torch.nn.layers import Conv
from paddlescience_torch.nn.resize import resize
from paddlescience_torch.utils.jax_params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import catheter as jcath  # noqa: E402  (the JAX examples)


# ------------------------------------------------------------- the traps --

@pytest.mark.parametrize("shape,out", [((2, 3, 16, 16), (2, 3, 8, 8)), ((2, 3, 8, 8), (2, 3, 16, 16)),
                                       ((2, 13, 4), (2, 6, 4)), ((2, 5, 7), (2, 11, 7)),
                                       ((1, 2, 9, 7), (1, 2, 4, 17))],
                         ids=["down_2x", "up_2x", "down_odd", "up_odd", "down_and_up"])
def test_linear_resize_is_jax_image_resize(shape, out):
    """A down-scaling antialiases (torch's bilinear interpolate does not);
    an up-scaling interpolates at half-pixel centres."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "linear"))
    close(resize(torch.from_numpy(x), out, "linear"), want, 1e-6)


@pytest.mark.parametrize("shape,out", [((1, 3, 4, 4), (1, 3, 8, 8)), ((1, 3, 5, 5), (1, 3, 10, 3))])
def test_nearest_resize_is_jax_image_resize(shape, out):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "nearest"))
    assert np.array_equal(resize(torch.from_numpy(x), out, "nearest").numpy(), want)


@pytest.mark.parametrize("shape,s,dim", [((3, 9, 4), (16,), (1,)), ((3, 8, 4), (15,), (1,)),
                                         ((2, 8, 5, 3), (8, 8), (1, 2))], ids=["1d_even", "1d_odd", "2d"])
def test_inverse_real_fft_of_a_non_hermitian_spectrum_is_jaxs(shape, s, dim):
    """The spectral layers hand the inverse real FFT spectra whose DC (and
    Nyquist) bins carry imaginary parts: torch reads them as JAX does."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
    want = jnp.fft.irfftn(jnp.asarray(x), s=s, axes=dim)
    close(torch.fft.irfftn(torch.from_numpy(x), s=s, dim=dim), want, 1e-5)


@pytest.mark.parametrize("size", [(8, 8), (9, 7), (5, 6)], ids=["even", "odd", "mixed"])
@pytest.mark.parametrize("k,s", [(3, 2), (4, 2), (3, 1)], ids=["k3s2", "k4s2", "k3s1"])
def test_same_strided_conv_is_xla_same(size, k, s):
    """XLA's "SAME" pads the extra row and column at the end."""
    jc = psci.nn.layers.Conv(3, 5, (k, k), strides=s, padding="SAME", rngs=Rngs(2))
    tc = Conv(3, 5, (k, k), strides=s, padding="SAME", generator=torch.Generator().manual_seed(0))
    load_jax_params(tc, jax.tree.map(np.asarray, jc.param_tree()))
    x = np.random.default_rng(3).standard_normal((2, 3) + size).astype(np.float32)
    with jc.bind(jc.param_tree(), jc.buffer_tree()):
        want = np.asarray(jc(jnp.asarray(x.transpose(0, 2, 3, 1)))).transpose(0, 3, 1, 2)
    close(tc(torch.from_numpy(x)), want, 1e-5)


# ------------------------------------------------------------------ UNO --

def test_unonet_matches_jax():
    kw = dict(in_channels=3, out_channels=1, hidden_channels=4, lifting_channels=6, projection_channels=6, n_layers=4,
              uno_out_channels=(4, 6, 6, 4), uno_n_modes=((6, 6), (4, 4), (4, 4), (6, 6)),
              uno_scalings=((1.0, 1.0), (0.5, 0.5), (2.0, 2.0), (1.0, 1.0)))
    jm = psci.arch.UNONet(("a",), ("u",), rngs=Rngs(4), **kw)
    tm = tuno.UNONet(("a",), ("u",), device="cpu", **kw)
    x = np.random.default_rng(5).standard_normal((2, 3, 8, 8)).astype(np.float32)
    arch_parity(jm, tm, {"a": x})


def test_unonet_odd_grid_and_skip_map_match_jax():
    """A 9 x 11 grid (half-scaled to round(4.5) x round(5.5) = 4 x 6 and
    doubled back to 8 x 12), a soft-gating
    horizontal skip and the default skip map of an odd layer count."""
    kw = dict(in_channels=2, out_channels=2, hidden_channels=4, lifting_channels=6, projection_channels=6,
              n_layers=3, uno_out_channels=(4, 6, 4), uno_n_modes=((4, 4), (4, 4), (4, 4)),
              uno_scalings=((0.5, 0.5), (1.0, 1.0), (2.0, 2.0)), horizontal_skip="soft-gating")
    jm = psci.arch.UNONet(("a",), ("u",), rngs=Rngs(6), **kw)
    tm = tuno.UNONet(("a",), ("u",), device="cpu", **kw)
    x = np.random.default_rng(7).standard_normal((2, 2, 9, 11)).astype(np.float32)
    jout = arch_parity(jm, tm, {"a": x})
    assert jout["u"].shape == (2, 2, 8, 12)


# ---------------------------------------------------------- FNO1d, VGAN --

@pytest.mark.parametrize("n,out_np", [(40, 40), (37, 52), (40, 21)], ids=["same", "up_odd", "down"])
def test_fno1d_matches_jax(n, out_np):
    kw = dict(modes=8, width=6, padding=7, input_channel=2, output_np=out_np)
    jm = psci.arch.FNO1d(("input",), ("output",), rngs=Rngs(8), **kw)
    tm = tgeofno.FNO1d(("input",), ("output",), device="cpu", **kw)
    x = np.random.default_rng(9).standard_normal((3, n, 2)).astype(np.float32)
    arch_parity(jm, tm, {"input": x})


def test_fwi_dataset_is_bitwise_the_jax_packages():
    from paddlescience_tpu.data.dataset.domain_dataset import FWIDataset as JFWI

    for kw in (dict(num_samples=5), dict(num_samples=3, H=20, W=12)):
        j, t = JFWI(("d",), ("v",), **kw), tdd.FWIDataset(("d",), ("v",), **kw)
        assert np.array_equal(t.input["d"], j.input["d"]) and np.array_equal(t.label["v"], j.label["v"])
    built = psci.data.build_dataset({"name": "FWIDataset", "input_keys": ("d",), "label_keys": ("v",),
                                     "num_samples": 4})
    from paddlescience_torch import data as tdata

    ported = tdata.build_dataset({"name": "FWIDataset", "input_keys": ("d",), "label_keys": ("v",), "num_samples": 4})
    assert np.array_equal(ported.input["d"], np.asarray(built.input["d"]))


# ------------------------------------------------------------- examples --

def test_catheter_data_are_the_jax_examples():
    for a, b in zip(tcath.synth_data(3, seed=2), jcath.synth_data(3, seed=2)):
        assert np.array_equal(a, b)


def test_catheter_three_train_steps_match_jax(tmp_path):
    """The example at n_train = 16, n_test = 8, batches of 8, modes 8,
    width 8 (S = 2001 points): three steps, then the eval."""
    kw = dict(epochs=4, n_train=16, n_test=8, batch_size=8, modes=8, width=8, data_dir=None)
    js = jcath.build_solver(output_dir=str(tmp_path / "jax"), **kw)
    ts = tcath.build_solver(output_dir=str(tmp_path / "port"), shuffle=False, device="cpu", **kw)
    three_steps(js, ts)
    j_metric, _ = js.eval()
    t_metric, _ = ts.eval()
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-4)
