"""The port's Transformer and transformer4sr against paddlescience_tpu on
the CPU: the Transformer (float token ids, causal decoder,
cross-attention), outputs and parameter gradients within 1e-5 of their
largest magnitude (the whole gradient's, for a parameter), at narrow
widths; transformer4sr's tables and tokens bitwise the JAX example's,
then three train steps of the JAX solver's compiled step
(``_earthformer_parity.py``; shuffle off on both sides) and of the port's
from the same parameters (d_model 16, 2 heads, one layer a side, batch
8): losses within 1e-4, the parameters after them within 1e-4 of the
largest magnitude (``_misc_parity.py``). The JAX networks are built from
numpy draws."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

import paddlescience_tpu as psci
from _earthformer_parity import numpy_init, one_torch_thread  # noqa: F401
from _graph_parity import grads_parity
from _operator_parity import highest_precision  # noqa: F401
from _misc_parity import solver_steps
from paddlescience_torch import arch as tarch
from paddlescience_torch.examples import transformer4sr as tsr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import transformer4sr as jsr  # noqa: E402  (the JAX example)

T = torch.from_numpy
RNG = np.random.default_rng


def _dict_parity(jm, tm, inputs):
    return grads_parity(jm, tm, lambda m: m({k: jnp.asarray(v) for k, v in inputs.items()}),
                        lambda m: m({k: T(v) for k, v in inputs.items()}))


def test_transformer_matches_jax():
    kw = dict(src_vocab_size=11, tgt_vocab_size=7, d_model=16, num_heads=2, num_layers=2, d_ff=32, max_len=8)
    with numpy_init():
        jm = psci.arch.Transformer(("src", "tgt"), ("logits",), **kw)
    tm = tarch.Transformer(("src", "tgt"), ("logits",), **kw, device="cpu")
    rng = RNG(5)
    inputs = {"src": rng.integers(0, 11, (3, 6)).astype(np.float32),  # float ids: the solver's batches
              "tgt": rng.integers(0, 7, (3, 5)).astype(np.float32)}
    out = _dict_parity(jm, tm, inputs)
    assert out["logits"].shape == (3, 5, 7)
    # the decoder is causal: the first position's logits do not read later targets
    changed = dict(inputs, tgt=inputs["tgt"].copy())
    changed["tgt"][:, 3:] = (changed["tgt"][:, 3:] + 1) % 7
    with torch.no_grad():
        a = tm({k: T(v) for k, v in inputs.items()})["logits"]
        b = tm({k: T(v) for k, v in changed.items()})["logits"]
    assert torch.equal(a[:, :3], b[:, :3]) and not torch.equal(a[:, 3:], b[:, 3:])


def test_transformer4sr_data_and_three_steps_match_jax(tmp_path):
    for a, b in zip(jsr.make_dataset(40, seed=3), tsr.make_dataset(40, seed=3)):
        assert np.array_equal(a, b)
    kw = dict(epochs=1, n_train=64, n_test=16, batch_size=8, d_model=16, num_heads=2, num_layers=1)
    with numpy_init():
        js = jsr.build_solver(output_dir=str(tmp_path), **kw)
    solver_steps(js, tsr.build_solver(output_dir=None, device="cpu", **kw))
