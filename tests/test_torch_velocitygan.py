"""The port's velocity GAN against paddlescience_tpu on the CPU: the
generator (stride-2 "SAME" convs, JAX's linear and nearest resizes) and
the discriminator at two input sizes, then three step pairs of the
velocitygan_fwi example's hand loop.

Both packages get the same parameters (``load_jax_params``, conv kernels
transposed) and the same inputs; JAX runs at "highest" matmul precision
(``_operator_parity.py``). Tolerances (relative to the largest magnitude
of the JAX value): forwards 1e-5, parameter gradients 1e-4, the step
pairs' losses 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import paddlescience_tpu as psci
from _operator_parity import arch_parity, highest_precision  # noqa: F401
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import geofno as tgeofno
from paddlescience_torch.examples import velocitygan_fwi as tvgan
from paddlescience_torch.utils.jax_params import load_jax_params


@pytest.mark.parametrize("hw", [(16, 16), (15, 11)], ids=["16x16", "15x11"])
def test_velocity_generator_matches_jax(hw):
    kw = dict(in_channels=1, dim=4, out_size=(12, 12))  # the shapes of the GAN test's: JAX draws them once
    jm = psci.arch.VelocityGenerator(("data",), ("velocity",), rngs=Rngs(10), **kw)
    tm = tgeofno.VelocityGenerator(("data",), ("velocity",), device="cpu", **kw)
    x = np.random.default_rng(11).standard_normal((2, 1) + hw).astype(np.float32)
    arch_parity(jm, tm, {"data": x})


def test_velocity_discriminator_matches_jax():
    jm = psci.arch.VelocityDiscriminator(("velocity",), ("score",), in_channels=1, dim=4, rngs=Rngs(12))
    tm = tgeofno.VelocityDiscriminator(("velocity",), ("score",), in_channels=1, dim=4, device="cpu")
    x = np.random.default_rng(13).standard_normal((3, 1, 17, 16)).astype(np.float32)
    arch_parity(jm, tm, {"velocity": x})


def test_velocitygan_three_step_pairs_match_jax():
    """The JAX example's two step functions (rebuilt from its source with
    the same networks and data) against the port's step pair, dim 4."""
    import optax

    ds = psci.data.build_dataset({"name": "FWIDataset", "input_keys": ("data",), "label_keys": ("label",),
                                  "num_samples": 16})
    x = jnp.asarray(ds.input["data"])
    y = jnp.asarray(ds.label["label"])
    x = (x - x.mean()) / (x.std() + 1e-8)
    y = (y - y.mean()) / (y.std() + 1e-8)
    gen = psci.arch.VelocityGenerator(("data",), ("velocity",), in_channels=1, dim=4, out_size=(32, 32))
    disc = psci.arch.VelocityDiscriminator(("velocity",), ("score",), in_channels=1, dim=4)
    gp, dp = gen.param_tree(), disc.param_tree()
    gan = tvgan.build(dim=4, device="cpu")
    load_jax_params(gan.gen, jax.tree.map(np.asarray, gp))
    load_jax_params(gan.disc, jax.tree.map(np.asarray, dp))
    g_tx, d_tx = optax.adam(2e-4, b1=0.5), optax.adam(2e-4, b1=0.5)
    g_opt, d_opt = g_tx.init(gp), d_tx.init(dp)

    def d_loss(dp, gp):
        fake = jax.lax.stop_gradient(gen.apply(gp, {"data": x})["velocity"])
        s_real = disc.apply(dp, {"velocity": y})["score"]
        s_fake = disc.apply(dp, {"velocity": fake})["score"]
        return jnp.mean(jax.nn.relu(1.0 - s_real)) + jnp.mean(jax.nn.relu(1.0 + s_fake))

    def g_loss(gp, dp):
        fake = gen.apply(gp, {"data": x})["velocity"]
        s_fake = disc.apply(dp, {"velocity": fake})["score"]
        l1 = jnp.mean(jnp.abs(fake - y))
        return -jnp.mean(s_fake) + 100.0 * l1 + 100.0 * jnp.mean((fake - y) ** 2), l1

    d_vg, g_vg = jax.jit(jax.value_and_grad(d_loss)), jax.jit(jax.value_and_grad(g_loss, has_aux=True))
    for _ in range(3):
        dl, g = d_vg(dp, gp)
        upd, d_opt = d_tx.update(g, d_opt)
        dp = optax.apply_updates(dp, upd)
        (gl, l1), g = g_vg(gp, dp)
        upd, g_opt = g_tx.update(g, g_opt)
        gp = optax.apply_updates(gp, upd)
        t = gan.train_steps(1)
        np.testing.assert_allclose([t["d_loss"], t["g_loss"], t["l1"]], [float(dl), float(gl), float(l1)], rtol=1e-4)
