"""The port's recurrent layers and the nets built on them against
paddlescience_tpu on the CPU: ``pixel_shuffle`` (channel order (i r + j)
C' + c, at C' = 1 and 2: equal), the LSTM (from zeros and from a given
state), both ConvLSTM cells (``nn/recurrent.py``'s "SAME" one, strided and
not; PhyCRNet's circular one with its output-gate bias), DeepPhyLSTM
types 2 and 3, PhyCRNet rolled out 1 and 3 steps (``second_last_state``
empty at 1, the step-1 state at 3) and its physics loss: outputs and
parameter gradients within 1e-5 of their largest magnitude (the whole
gradient's, for a parameter), T <= 8, grids <= 16^2. JAX modules are built
from numpy draws and their functions compiled at XLA's lowest
optimisation level (``_earthformer_parity.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddlescience_tpu as psci
from _earthformer_parity import fast_call, numpy_init, one_torch_thread  # noqa: F401
from _graph_parity import grads_parity
from _operator_parity import close, highest_precision  # noqa: F401
from paddlescience_tpu.arch import phycrnet as jphy
from paddlescience_tpu.nn import recurrent as jrec
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import phycrnet as tphy
from paddlescience_torch.arch.phylstm import DeepPhyLSTM
from paddlescience_torch.nn import recurrent as trec

T = torch.from_numpy
G = torch.Generator


def nchw(a):
    return jnp.transpose(a, (0, 3, 1, 2))


def nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


@pytest.mark.parametrize("c_out", [1, 2])
def test_pixel_shuffle_reads_the_jax_channel_order(c_out):
    r = 3
    x = np.random.default_rng(c_out).standard_normal((2, c_out * r * r, 4, 5)).astype(np.float32)
    want = np.asarray(nchw(jrec.pixel_shuffle(jnp.asarray(nhwc(x)), r)))
    got = trec.pixel_shuffle(T(x), r).numpy()
    assert np.array_equal(got, want)
    torch_order = torch.nn.functional.pixel_shuffle(T(x), r).numpy()
    assert np.array_equal(torch_order, want) == (c_out == 1)  # torch's own order agrees only at C' = 1


@pytest.mark.parametrize("given_state", [False, True], ids=["zeros", "state"])
def test_lstm_matches_jax(given_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 4)).astype(np.float32)
    s = [rng.standard_normal((3, 6)).astype(np.float32) for _ in range(2)] if given_state else None
    with numpy_init():
        jm = jrec.LSTM(4, 6, rngs=Rngs(0))
    tm = trec.LSTM(4, 6, generator=G().manual_seed(0))
    out = grads_parity(jm, tm, lambda m: {"h": m(jnp.asarray(x), None if s is None else tuple(map(jnp.asarray, s)))},
                       lambda m: {"h": m(T(x), None if s is None else tuple(map(T, s)))})
    assert out["h"].shape == (3, 7, 6)


@pytest.mark.parametrize("kernel,stride,padding", [(4, 2, 1), (3, 1, "SAME")], ids=["strided", "same"])
def test_conv_lstm_cell_matches_jax(kernel, stride, padding):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    hw = 8 // stride
    h0, c0 = (rng.standard_normal((2, 5, hw, hw)).astype(np.float32) for _ in range(2))
    with numpy_init():
        jm = jrec.ConvLSTMCell(3, 5, kernel, stride, padding, rngs=Rngs(0))
    tm = trec.ConvLSTMCell(3, 5, kernel, stride, padding, generator=G().manual_seed(0))

    def j_call(m):
        h, (_, c) = m(jnp.asarray(nhwc(x)), (jnp.asarray(nhwc(h0)), jnp.asarray(nhwc(c0))))
        return {"h": nchw(h), "c": nchw(c)}

    def t_call(m):
        h, (_, c) = m(T(x), (T(h0), T(c0)))
        return {"h": h, "c": c}

    grads_parity(jm, tm, j_call, t_call)
    assert [tuple(t.shape) for t in tm.init_state(x.shape)] == [(2, 5, hw, hw)] * 2


def test_phycrnet_conv_lstm_cell_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)
    h0, c0 = (rng.standard_normal((2, 3, 4, 4)).astype(np.float32) for _ in range(2))
    with numpy_init():
        jm = jphy.ConvLSTMCell(4, 3, 4, 2, 1, rngs=Rngs(0))
    tm = tphy.ConvLSTMCell(4, 3, 4, 2, 1, generator=G().manual_seed(0))
    assert tm.conv_x.bias.tolist() == [0.0] * 9 + [1.0] * 3  # the output gate's bias starts at 1

    def j_call(m):
        h, (_, c) = m(jnp.asarray(nhwc(x)), (jnp.asarray(nhwc(h0)), jnp.asarray(nhwc(c0))))
        return {"h": nchw(h), "c": nchw(c)}

    def t_call(m):
        h, (_, c) = m(T(x), (T(h0), T(c0)))
        return {"h": h, "c": c}

    grads_parity(jm, tm, j_call, t_call)


@pytest.mark.parametrize("model_type", [2, 3])
def test_deep_phylstm_matches_jax(model_type):
    rng = np.random.default_rng(3)
    Tn = 8
    inputs = {"ag": rng.standard_normal((2, Tn, 1)).astype(np.float32),
              "ag_c": rng.standard_normal((2, Tn, 1)).astype(np.float32),
              "phi": rng.standard_normal((1, Tn, Tn)).astype(np.float32)}
    with numpy_init():
        jm = psci.arch.DeepPhyLSTM(1, 1, hidden_size=8, model_type=model_type)
    tm = DeepPhyLSTM(1, 1, hidden_size=8, model_type=model_type, device="cpu")
    out = grads_parity(jm, tm, lambda m: m({k: jnp.asarray(v) for k, v in inputs.items()}),
                       lambda m: m({k: T(v) for k, v in inputs.items()}))
    assert set(out) == set(jm.output_keys) == set(tm.output_keys)


PHYCRNET = dict(input_channels=2, hidden_channels=(4, 8, 32), input_kernel_size=(4, 4, 3), input_stride=(2, 2, 1),
                input_padding=(1, 1, 1), dt=0.05, num_layers=(2, 1), upscale_factor=4)  # decoder C' = 32 / 16 = 2


def _flat_rollout(res, nchw_state=lambda a: a):
    out = {f"out{i}": o for i, o in enumerate(res["outputs"])}
    for i, (h, c) in enumerate(res["second_last_state"]):
        out[f"h{i}"], out[f"c{i}"] = nchw_state(h), nchw_state(c)
    return out


@pytest.mark.parametrize("step,given_state", [(1, False), (3, True)], ids=["step1", "step3_state"])
def test_phycrnet_matches_jax(step, given_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    state = [tuple(rng.standard_normal((2, 32, 4, 4)).astype(np.float32) for _ in range(2))] if given_state else None
    kw = dict(PHYCRNET, step=step, effective_step=tuple(range(step)))
    with numpy_init():
        jm = psci.arch.PhyCRNet(**kw)
    tm = tphy.PhyCRNet(**kw, device="cpu")
    out = grads_parity(
        jm, tm,
        lambda m: _flat_rollout(m({"initial_state": None if state is None else [tuple(map(jnp.asarray, s))
                                                                                 for s in state],
                                   "input": jnp.asarray(x)})),
        lambda m: _flat_rollout(m({"initial_state": None if state is None else [tuple(map(T, s)) for s in state],
                                   "input": T(x)})))
    assert sorted(out) == (["out0"] if step == 1 else ["c0", "h0", "out0", "out1", "out2"])
    assert out["out0"].shape == (2, 2, 16, 16)
    if step == 3:
        assert out["h0"].shape == (2, 32, 4, 4)


def test_phycrnet_weight_norm_starts_at_the_plain_kernel():
    tm = tphy.PhyCRNet(**PHYCRNET, device="cpu")
    conv = tm.encoder[0].conv
    norms = conv.weight.detach().reshape(conv.weight.shape[0], -1).norm(dim=1)
    assert torch.allclose(norms, torch.ones_like(norms), atol=1e-6)
    assert torch.allclose(conv._kernel(), conv.weight * conv.wn_g[:, None, None, None], atol=1e-7)


def test_phycrnet_loss_generator_matches_jax():
    roll = np.random.default_rng(5).standard_normal((5, 2, 12, 12)).astype(np.float32)
    jl, tl = jphy.loss_generator(0.01, 1 / 12), tphy.loss_generator(0.01, 1 / 12)
    want = fast_call(lambda r: jl.get_phy_loss(r, R=50.0), jnp.asarray(roll))
    got = tl.get_phy_loss(T(roll), R=50.0)
    for g, w in zip(got, want):
        close(g, np.asarray(w), 1e-5)
    assert got[0].shape == (3, 1, 8, 8)
