"""The port's misc_nets and VAE nets and ChipHeatDataset against
paddlescience_tpu on the CPU: Embedding, Epnn, USCNN, HEDeepONets,
ChipDeepONets (swish branches) and the AutoEncoder with JAX's eps passed
in: outputs and parameter gradients within 1e-5 of their largest
magnitude (the whole gradient's, for a parameter), at narrow widths;
ChipHeatDataset's batches equal to JAX's on a product of three factors,
the composite ``u_one`` index included. The Transformer is in
``test_torch_transformer4sr.py``, the tempoGAN nets in
``test_torch_tempogan.py``. JAX modules are built from numpy draws and
their functions compiled at XLA's lowest optimisation level
(``_earthformer_parity.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddlescience_tpu as psci
from _earthformer_parity import numpy_init, one_torch_thread  # noqa: F401
from _graph_parity import grads_parity
from _operator_parity import highest_precision  # noqa: F401
from paddlescience_tpu.data.dataset.domain_dataset import ChipHeatDataset as JChipHeat
from paddlescience_tpu.nn import layers as jlayers
from paddlescience_tpu.nn.core import Param, Rngs
from paddlescience_torch import arch as tarch
from paddlescience_torch.data import build_dataset
from paddlescience_torch.nn.layers import Embedding

T = torch.from_numpy
RNG = np.random.default_rng


def _dict_parity(jm, tm, inputs):
    return grads_parity(jm, tm, lambda m: m({k: jnp.asarray(v) for k, v in inputs.items()}),
                        lambda m: m({k: T(v) for k, v in inputs.items()}))


def test_embedding_matches_jax():
    idx = RNG(0).integers(0, 9, (3, 5))
    with numpy_init():
        jm = jlayers.Embedding(9, 4, rngs=Rngs(0))
    tm = Embedding(9, 4, generator=torch.Generator().manual_seed(0))
    out = grads_parity(jm, tm, lambda m: {"e": m(jnp.asarray(idx))}, lambda m: {"e": m(T(idx))})
    assert out["e"].shape == (3, 5, 4)


def test_epnn_matches_jax():
    kw = dict(node_sizes=(3, 16, 16, 16, 1), activations=("leaky_relu", "tanh", "leaky_relu"), drop_p=0.1)
    with numpy_init():
        jm = psci.arch.Epnn(("state",), ("dstress",), **kw)
    tm = tarch.Epnn(("state",), ("dstress",), **kw, device="cpu")
    assert tm.layers[-1].bias is None
    _dict_parity(jm, tm, {"state": RNG(1).standard_normal((8, 3)).astype(np.float32)})


def test_uscnn_matches_jax():
    kw = dict(hidden_size=(4, 6, 4), h=0.01, nx=12, ny=7, nvar_in=2, nvar_out=1)
    with numpy_init():
        jm = psci.arch.USCNN(("coords",), ("v",), **kw)
    tm = tarch.USCNN(("coords",), ("v",), **kw, device="cpu")
    out = _dict_parity(jm, tm, {"coords": RNG(2).standard_normal((2, 2, 5, 9)).astype(np.float32)})
    assert out["v"].shape == (2, 1, 7, 12)


def test_he_deeponets_matches_jax():
    kw = dict(heat_num_loc=5, cold_num_loc=4, num_features=6, branch_num_layers=2, trunk_num_layers=2,
              branch_hidden_size=8, trunk_hidden_size=8)
    keys = (("qm_h",), ("qm_c",), ("x", "t"), ("T_h", "T_c", "T_w"))
    with numpy_init():
        jm = psci.arch.HEDeepONets(*keys, **kw)
    tm = tarch.HEDeepONets(*keys, **kw, device="cpu")
    jm.b = Param(jnp.asarray([0.1, -0.2, 0.3]))  # a non-zero bias, one entry per output key (carried across)
    rng = RNG(3)
    inputs = {"qm_h": rng.standard_normal((6, 5)), "qm_c": rng.standard_normal((6, 4)),
              "x": rng.standard_normal((6, 1)), "t": rng.standard_normal((6, 1))}
    _dict_parity(jm, tm, {k: v.astype(np.float32) for k, v in inputs.items()})


def test_chip_deeponets_matches_jax():
    kw = dict(num_loc=9, bctype_loc=1, BC_num_loc=7, num_features=5, branch_num_layers=2, BC_num_layers=2,
              trunk_num_layers=2, branch_hidden_size=8, BC_hidden_size=8, trunk_hidden_size=6)
    keys = (("u",), ("bc",), ("bc_data",), ("x", "y"), ("T",))
    with numpy_init():
        jm = psci.arch.ChipDeepONets(*keys, **kw)
    tm = tarch.ChipDeepONets(*keys, **kw, device="cpu")
    assert tm.b.shape == (1,)
    rng = RNG(4)
    inputs = {"u": rng.standard_normal((6, 9)), "bc": rng.integers(0, 4, (6, 1)).astype(float),
              "bc_data": rng.standard_normal((6, 7)), "x": rng.uniform(size=(6, 1)), "y": rng.uniform(size=(6, 1))}
    _dict_parity(jm, tm, {k: v.astype(np.float32) for k, v in inputs.items()})


def test_autoencoder_matches_jax_with_its_eps():
    with numpy_init():
        jm = psci.arch.AutoEncoder(("p",), ("mu", "log_sigma", "decoder_z"), input_dim=12, latent_dim=3,
                                   hidden_dim=8)
    tm = tarch.AutoEncoder(("p",), ("mu", "log_sigma", "decoder_z"), input_dim=12, latent_dim=3, hidden_dim=8,
                           device="cpu")
    x = RNG(6).standard_normal((5, 12)).astype(np.float32)
    eps = np.array(jax.random.normal(jm._rng, (5, 3)))  # what the JAX module draws at every call
    tm.set_noise(T(eps))
    _dict_parity(jm, tm, {"p": x})
    # the port's own eps: one draw per shape, the same at every call, and anew after set_rng
    mu = torch.zeros(5, 3)
    tm.set_rng(3)
    first = tm.noise(mu)
    assert tm.noise(mu) is first and torch.equal(first, torch.randn((5, 3), generator=torch.Generator().manual_seed(3)))
    tm.set_rng(4)
    assert not torch.equal(tm.noise(mu), first)


def test_chip_heat_dataset_batches_equal_jax():
    rng = RNG(9)
    cfg = {"input": {"x": rng.uniform(size=(5, 1)).astype(np.float32), "y": rng.uniform(size=(5, 1)).astype(np.float32),
                     "u": rng.standard_normal((3, 4)).astype(np.float32),
                     "bc": np.arange(4, dtype=np.float32)[:, None],
                     "u_one": rng.standard_normal((15, 1)).astype(np.float32),
                     "bc_data": rng.standard_normal((3, 6)).astype(np.float32)},
           "label": {"chip": np.zeros(1, np.float32)}, "weight": {"chip": np.array([100.0], np.float32)},
           "index": ("x", "u", "bc"), "data_type": "u"}
    jd = JChipHeat(**cfg)
    td = build_dataset({"name": "ChipHeatDataset", **cfg})
    assert len(td) == len(jd) == 60
    for idx in (np.arange(60), RNG(10).permutation(60)[:17], 37):
        for got, want in zip(td[idx], jd[idx]):
            assert sorted(got) == sorted(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), k
    inp, _, _ = td[np.arange(60)]
    flat = np.arange(60)
    # the first factor varies fastest; u_one reads len(u) * point + sample
    assert np.array_equal(inp["u_one"], cfg["input"]["u_one"][3 * (flat % 5) + (flat // 5) % 3])
