"""The port's ExtFormer-MoE against paddlescience_tpu on the CPU:
``GatingNet`` in every gate style (the two aux-loss styles in turn) with
JAX's noise fed in (gates, indices and the aux loss within 1e-5), the
deterministic eval gate, ``MixtureFFN`` and ``MixtureLinear``,
``ExtFormerMoECuboid``'s forward and ``aux_loss`` (1e-5), three steps of
the MoE ENSO example with the same gate noise on both sides (losses 1e-4),
and three steps of the SEVIR example; both examples' networks cut to one
level of base 8 with one full-volume attention layer a block, dropout 0.

JAX runs at "highest" matmul precision (``_operator_parity.py``)."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import fast_call, numpy_init, three_steps, one_torch_thread  # noqa: F401
from _operator_parity import close, highest_precision  # noqa: F401
from paddlescience_tpu.arch import cuboid_transformer as jct
from paddlescience_tpu.arch import extformer_moe as jmoe
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import cuboid_transformer as tct
from paddlescience_torch.arch import extformer_moe as tmoe
from paddlescience_torch.examples import earthformer_sevir as tsevir
from paddlescience_torch.examples import extformer_moe_enso as tmoe_enso
from paddlescience_torch.utils.jax_params import load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import earthformer_sevir as jsevir  # noqa: E402  (the JAX examples)
import extformer_moe_enso as jmoe_enso  # noqa: E402

SHAPE = (2, 3, 4, 4)  # (T, H, W) of the expert grid after the batch


@pytest.mark.parametrize("style,aux_style", [(s, ("all", "cell")[i % 2]) for i, s in enumerate(jmoe.GATE_STYLES)])
def test_gating_net_matches_jax_with_its_noise(style, aux_style):
    cfg = jmoe.default_moe_config(num_experts=5, out_planes=3, gate_style=style, aux_loss_style=aux_style,
                                  importance_weight=0.3, load_weight=0.7)
    with numpy_init():
        jg = jmoe.GatingNet(cfg, SHAPE[1:], 6, rngs=Rngs(1))
    tg = tmoe.GatingNet(cfg, SHAPE[1:], 6, generator=torch.Generator())
    load_jax_params(tg, jax.tree.map(np.asarray, jg.param_tree()))
    x = np.random.default_rng(2).standard_normal(SHAPE + (6,)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    gates, idx, aux = jg(jnp.asarray(x), key)
    noise = np.asarray(jax.random.normal(key, (SHAPE[0], *SHAPE[1:], 5)))  # the draw JAX's gate made
    t_gates, t_idx, t_aux = tg(torch.from_numpy(x), noise=torch.from_numpy(noise.copy()))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    close(t_gates, np.asarray(gates), 1e-5)
    assert float(aux) > 0
    np.testing.assert_allclose(float(t_aux.detach()), float(aux), rtol=1e-5)
    e_gates, e_idx, e_aux = jg(jnp.asarray(x))  # eval: deterministic, no aux loss
    te_gates, te_idx, te_aux = tg(torch.from_numpy(x))
    np.testing.assert_array_equal(te_idx.numpy(), np.asarray(e_idx))
    close(te_gates, np.asarray(e_gates), 1e-5)
    assert float(te_aux) == float(e_aux) == 0.0


@pytest.mark.parametrize("kind", ["ffn", "linear"])
def test_mixture_layers_match_jax(kind):
    cfg = jmoe.default_moe_config(num_experts=4, out_planes=2)
    with numpy_init():
        jm = (jmoe.MixtureFFN(6, 12, SHAPE[1:], cfg, rngs=Rngs(4)) if kind == "ffn"
              else jmoe.MixtureLinear(6, 9, SHAPE[1:], cfg, rngs=Rngs(4)))
    tm = (tmoe.MixtureFFN(6, 12, SHAPE[1:], cfg, generator=torch.Generator()) if kind == "ffn"
          else tmoe.MixtureLinear(6, 9, SHAPE[1:], cfg, generator=torch.Generator()))
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    x = np.random.default_rng(5).standard_normal(SHAPE + (6,)).astype(np.float32)

    def fwd(p, x):
        with jm.bind(p, {}):
            return jm(x)[0]

    close(tm(torch.from_numpy(x))[0], np.asarray(fast_call(fwd, jm.param_tree(), jnp.asarray(x))), 1e-5)


@pytest.fixture
def shared_gate_noise(monkeypatch):
    """The same standard-normal gate noise on both sides: JAX's draws (made
    while a step is traced) and the port's, one fixed numpy draw per
    shape."""
    draws = {}

    def draw(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in draws:
            draws[shape] = np.random.default_rng(len(draws) + 11).standard_normal(shape).astype(np.float32)
        return draws[shape]

    monkeypatch.setattr(jax.random, "normal", lambda key, shape=(), dtype=jnp.float32: jnp.asarray(draw(shape)))
    monkeypatch.setattr(tmoe, "gate_noise", lambda shape, generator, device: torch.from_numpy(draw(shape)))


def test_extformer_moe_forward_and_aux_loss_match_jax(shared_gate_noise):
    cfg = jmoe.default_moe_config(num_experts=4, out_planes=2, importance_weight=0.5, load_weight=0.5)
    kw = dict(base_units=8, num_heads=2, enc_depth=(1,), dec_depth=(1,), self_pattern="axial",
              cross_self_pattern="axial", cross_pattern="cross_1x1", num_global_vectors=0, moe_config=cfg)
    shapes = ((4, 4, 8, 1), (2, 4, 8, 1))
    with numpy_init():
        jm = jct.ExtFormerMoECuboid(("x",), ("y",), *shapes, rngs=Rngs(6), **kw)
    tm = tct.ExtFormerMoECuboid(("x",), ("y",), *shapes, device="cpu", **kw)
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))
    x = np.random.default_rng(7).standard_normal((2,) + shapes[0]).astype(np.float32)
    params = jm.param_tree()

    def fwd(p, x, key):
        jm.set_train_rng(key)
        try:
            with jm.bind(p, {}):
                return jm({"x": x})
        finally:
            jm.set_train_rng(None)

    want = fast_call(fwd, params, jnp.asarray(x), jax.random.PRNGKey(0))  # train mode: noisy gates, aux losses
    tm.set_train_rng(torch.Generator())
    got = tm({"x": torch.from_numpy(x)})
    close(got["y"], np.asarray(want["y"]), 1e-5)
    assert got["aux_loss"].shape == (1, 1) and float(got["aux_loss"]) > 0
    np.testing.assert_allclose(float(got["aux_loss"].detach()), float(want["aux_loss"][0, 0]), rtol=1e-5)
    tm.set_train_rng(None)  # eval: deterministic routing, no aux loss (the gates' eval path: above)
    assert float(tm({"x": torch.from_numpy(x)})["aux_loss"]) == 0.0


# ------------------------------------------------------------- examples --

CUT = dict(base_units=8, enc_depth=(1,), dec_depth=(1,), num_global_vectors=0, self_pattern="full",
           cross_self_pattern="full", attn_drop=0.0, proj_drop=0.0, ffn_drop=0.0)
PORT_CUT = {k: v for k, v in CUT.items() if not k.endswith("_drop")}


def test_extformer_moe_example_three_steps_match_jax(tmp_path, monkeypatch, shared_gate_noise):
    orig = psci.arch.ExtFormerMoECuboid
    monkeypatch.setattr(psci.arch, "ExtFormerMoECuboid", lambda *a, **kw: orig(*a, **{**kw, **CUT}))
    shapes = dict(in_len=4, out_len=2, lat=8, lon=16)
    for k, v in shapes.items():
        monkeypatch.setattr(jmoe_enso, k.upper(), v)
    with numpy_init():
        js = jmoe_enso.build_solver(epochs=2, output_dir=str(tmp_path / "jax"), base_units=8)
    ts = tmoe_enso.make_solver(tct.ExtFormerMoECuboid, epochs=2, output_dir=None, device="cpu", drop=0.0,
                               num_experts=4, **shapes, **PORT_CUT)
    three_steps(js, ts)


def test_sevir_example_three_steps_match_jax(tmp_path, monkeypatch):
    orig = psci.arch.CuboidTransformer
    monkeypatch.setattr(psci.arch, "CuboidTransformer", lambda *a, **kw: orig(*a, **{**kw, **CUT}))
    for k, v in dict(IN_LEN=4, OUT_LEN=2, H=8, W=16).items():
        monkeypatch.setattr(jsevir, k, v)
    with numpy_init():
        js = jsevir.build_solver(epochs=2, output_dir=str(tmp_path / "jax"))
    ts = tsevir.make_solver(epochs=2, output_dir=None, device="cpu", drop=0.0, in_len=4, out_len=2, height=8,
                            width=16, **PORT_CUT)
    three_steps(js, ts)
