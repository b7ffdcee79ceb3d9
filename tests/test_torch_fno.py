"""The port's FNO slice against paddlescience_tpu on the CPU: ``SpectralConv``
(dense, CP, Tucker, separable; 1-D, 2-D, 3-D; grids smaller than the
modes), ``FNOBlocks`` with the channel MLP, ``DomainPadding``,
``TFNO2dNet``, the ``Step`` schedule, ``AdamW``, ``L2RelLoss``,
``FunctionalLoss``, the Darcy generator and the darcy_tfno example.

Both packages get the same parameters (``load_jax_params``) and the same
numpy-seeded inputs; JAX runs at "highest" matmul precision. Tolerances
(relative to the largest magnitude of the JAX value): forwards 1e-5,
parameter gradients 1e-4, losses 1e-6, the schedule 1e-7 (1e-6 in its
warmup), AdamW per step 1e-4 (parameters: Adam divides each gradient by
its own magnitude, so the gradients' last-bit differences show), three
train steps of the example: losses 1e-4, parameters 0.1 lr; the Darcy
data bitwise.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_tpu.arch import fno as jfno
from paddlescience_tpu.data.dataset.science_dataset import generate_darcy_dataset as j_darcy
from paddlescience_tpu.nn.core import Rngs
from paddlescience_torch.arch import fno as tfno
from paddlescience_torch.data.dataset.science_dataset import generate_darcy_dataset as t_darcy
from paddlescience_torch.examples import darcy_tfno as tdarcy
from paddlescience_torch.loss.losses import FunctionalLoss, L2RelLoss
from paddlescience_torch.optimizer.lr_scheduler import Step as TStep
from paddlescience_torch.optimizer.optimizer import AdamW as TAdamW
from paddlescience_torch.utils.jax_params import flatten_tree, load_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import darcy_tfno as jdarcy  # noqa: E402  (the JAX example)

G = torch.Generator().manual_seed(0)


@pytest.fixture(autouse=True)
def _highest():
    with jax.default_matmul_precision("highest"):
        yield


def _close(got, ref, rtol):
    got, ref = (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for v in (got, ref))
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _carry(jm, tm):
    load_jax_params(tm, jax.tree.map(np.asarray, jm.param_tree()))


def _module_forward_and_grads(jm, tm, x):
    """Forward of two plain modules on the tensor x and the gradients of
    sum(out * c) for a fixed cotangent c."""
    params, rest = jm.param_tree(), jm.buffer_tree()

    def fwd(p):
        with jm.bind(p, rest):
            return jm(jnp.asarray(x))

    jout = np.asarray(jax.jit(fwd)(params))
    cot = np.random.default_rng(11).standard_normal(jout.shape).astype(np.float32)
    j_grads = flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(lambda p: jnp.sum(fwd(p) * cot)))(params)))
    tout = tm(torch.from_numpy(x))
    t_grads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(), list(tm.parameters()), allow_unused=True)
    names = [n for n, _ in tm.named_parameters()]
    t_grads = {n: (g if g is not None else torch.zeros_like(p)) for n, g, p in zip(names, t_grads, tm.parameters())}
    return jout, tout, j_grads, t_grads


def _check(jm, tm, x):
    jout, tout, j_grads, t_grads = _module_forward_and_grads(jm, tm, x)
    _close(tout, jout, 1e-5)
    assert set(t_grads) == set(j_grads)
    for n, g in t_grads.items():
        _close(g, j_grads[n], 1e-4)


# (ndim, modes, grid, factorization, separable): grids at and below the modes
SPECTRAL = [
    (1, (8,), (12,), None, False), (1, (8,), (5,), "cp", False), (1, (6,), (16,), "tucker", False),
    (1, (8,), (12,), None, True),
    (2, (6, 6), (10, 9), None, False), (2, (8, 8), (5, 6), None, False), (2, (6, 4), (8, 8), "cp", False),
    (2, (6, 6), (4, 7), "tucker", False), (2, (4, 6), (9, 8), None, True),
    (3, (4, 4, 4), (6, 5, 6), None, False), (3, (4, 4, 6), (3, 4, 5), "cp", False),
    (3, (4, 4, 4), (6, 6, 4), "tucker", False), (3, (4, 4, 4), (5, 6, 7), None, True),
]


@pytest.mark.parametrize("ndim,modes,grid,fact,sep", SPECTRAL,
                         ids=[f"{d}d-{f or 'dense'}{'-sep' if s else ''}-{'x'.join(map(str, g))}"
                              for d, _, g, f, s in SPECTRAL])
def test_spectral_conv_matches_jax(ndim, modes, grid, fact, sep):
    cin, cout = 3, (3 if sep else 4)
    rank = 0.5 if fact else 1.0
    jm = jfno.SpectralConv(cin, cout, modes, sep, fact, rank, rngs=Rngs(ndim))
    tm = tfno.SpectralConv(cin, cout, modes, sep, fact, rank, generator=G)
    _carry(jm, tm)
    x = np.random.default_rng(ndim).standard_normal((2, cin) + grid).astype(np.float32)
    _check(jm, tm, x)


@pytest.mark.parametrize("use_mlp,skip", [(True, "linear"), (True, "identity"), (False, "soft-gating")])
def test_fno_blocks_match_jax(use_mlp, skip):
    kw = dict(n_layers=2, use_mlp=use_mlp, mlp={"expansion": 0.5}, fno_skip=skip, mlp_skip="soft-gating")
    jm = jfno.FNOBlocks(4, 4, (6, 6), rngs=Rngs(2), **kw)
    tm = tfno.FNOBlocks(4, 4, (6, 6), generator=G, **kw)
    _carry(jm, tm)
    x = np.random.default_rng(3).standard_normal((2, 4, 8, 8)).astype(np.float32)
    jout = np.asarray(jm(jm(jnp.asarray(x), 0), 1))  # both blocks in turn, as FNONet runs them
    tout = tm(tm(torch.from_numpy(x), 0), 1)
    _close(tout, jout, 1e-5)


@pytest.mark.parametrize("mode", ["one-sided", "symmetric"])
def test_domain_padding_and_padded_fno_match_jax(mode):
    x = np.random.default_rng(4).standard_normal((2, 3, 8, 6)).astype(np.float32)
    jp, tp = jfno.DomainPadding([0.25, 0.5], mode), tfno.DomainPadding([0.25, 0.5], mode)
    jpad, tpad = np.asarray(jp.pad(jnp.asarray(x))), tp.pad(torch.from_numpy(x))
    assert np.array_equal(tpad.numpy(), jpad)
    assert np.array_equal(tp.unpad(tpad).numpy(), x)
    kw = dict(in_channels=1, out_channels=1, lifting_channels=8, projection_channels=8, n_layers=2,
              domain_padding=0.25, domain_padding_mode=mode)
    jm = psci.arch.TFNO2dNet(("a",), ("u",), 4, 4, 4, rngs=Rngs(5), **kw)
    tm = tfno.TFNO2dNet(("a",), ("u",), 4, 4, 4, device="cpu", **kw)
    _carry(jm, tm)
    a = x[:, :1]
    _close(tm({"a": torch.from_numpy(a)})["u"], np.asarray(jm({"a": jnp.asarray(a)})["u"]), 1e-5)


def test_tfno2d_darcy_width_forward_and_gradients_match_jax():
    kw = dict(hidden_channels=32, in_channels=3, out_channels=1, lifting_channels=256, projection_channels=64,
              n_layers=4)
    jm = psci.arch.TFNO2dNet(("input",), ("output",), n_modes_height=16, n_modes_width=16, rngs=Rngs(6), **kw)
    tm = tfno.TFNO2dNet(("input",), ("output",), n_modes_height=16, n_modes_width=16, device="cpu", **kw)
    _carry(jm, tm)
    x = np.random.default_rng(6).standard_normal((3, 3, 16, 16)).astype(np.float32)
    params, rest = jm.param_tree(), jm.buffer_tree()

    def fwd(p):
        with jm.bind(p, rest):
            return jm({"input": jnp.asarray(x)})["output"]

    jout = np.asarray(jax.jit(fwd)(params))
    cot = np.random.default_rng(7).standard_normal(jout.shape).astype(np.float32)
    j_grads = flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(lambda p: jnp.sum(fwd(p) * cot)))(params)))
    tout = tm({"input": torch.from_numpy(x)})["output"]
    _close(tout, jout, 1e-5)
    grads = torch.autograd.grad((tout * torch.from_numpy(cot)).sum(), list(tm.parameters()))
    for (n, _), g in zip(tm.named_parameters(), grads):
        _close(g, j_grads[n], 1e-4)


def test_fno_1d_and_3d_nets_and_unknown_skip():
    jm = psci.arch.TFNO1dNet(("a",), ("u",), 8, 6, in_channels=1, lifting_channels=8, projection_channels=8,
                             n_layers=2, rngs=Rngs(1))
    tm = tfno.TFNO1dNet(("a",), ("u",), 8, 6, in_channels=1, lifting_channels=8, projection_channels=8, n_layers=2,
                        device="cpu")
    _carry(jm, tm)
    x = np.random.default_rng(1).standard_normal((2, 1, 12)).astype(np.float32)
    _close(tm({"a": torch.from_numpy(x)})["u"], np.asarray(jm({"a": jnp.asarray(x)})["u"]), 1e-5)
    kw = dict(in_channels=2, lifting_channels=8, projection_channels=8, n_layers=2, factorization="tucker", rank=0.5)
    jm = psci.arch.TFNO3dNet(("a", "b"), ("u",), 4, 4, 4, 4, rngs=Rngs(2), **kw)
    tm = tfno.TFNO3dNet(("a", "b"), ("u",), 4, 4, 4, 4, device="cpu", **kw)
    _carry(jm, tm)
    x = np.random.default_rng(2).standard_normal((2, 1, 6, 5, 4)).astype(np.float32)
    feed = {"a": x, "b": 2 * x}
    _close(tm({k: torch.from_numpy(v) for k, v in feed.items()})["u"],
           np.asarray(jm({k: jnp.asarray(v) for k, v in feed.items()})["u"]), 1e-5)
    with pytest.raises(ValueError, match="unknown skip type"):
        tfno.FNOBlocks(2, 2, (4,), fno_skip="bogus", generator=G)


@pytest.mark.parametrize("by_epoch", [True, False])
def test_step_schedule_matches_jax(by_epoch):
    kw = dict(epochs=10, iters_per_epoch=7, learning_rate=5e-3, step_size=3, gamma=0.5, by_epoch=by_epoch)
    j_fn, t_fn = psci.optimizer.lr_scheduler.Step(**kw)(), TStep(**kw)()
    for s in range(70):
        want = float(j_fn(jnp.asarray(s)))
        assert np.isclose(t_fn(s), want, rtol=1e-7, atol=0)
        assert np.isclose(float(t_fn(torch.tensor(float(s)))), want, rtol=1e-7, atol=0)
    warm = dict(kw, warmup_epoch=2, warmup_start_lr=1e-4)
    j_fn, t_fn = psci.optimizer.lr_scheduler.Step(**warm)(), TStep(**warm)()
    for s in range(0, 70, 3):
        np.testing.assert_allclose(t_fn(s), float(j_fn(jnp.asarray(s))), rtol=1e-6)


def test_adamw_matches_optax_per_step():
    """``AdamW`` (decay on every parameter: biases and both halves of the
    complex weights) against ``optax.adamw`` on the TFNO's parameters,
    five steps of the Step schedule."""
    kw = dict(hidden_channels=4, in_channels=1, lifting_channels=8, projection_channels=8, n_layers=2)
    jm = psci.arch.TFNO2dNet(("a",), ("u",), 4, 4, rngs=Rngs(8), **kw)
    tm = tfno.TFNO2dNet(("a",), ("u",), 4, 4, device="cpu", **kw)
    _carry(jm, tm)
    lr_kw = dict(epochs=5, iters_per_epoch=2, learning_rate=5e-2, step_size=1, gamma=0.5, by_epoch=True)
    j_opt = psci.optimizer.AdamW(psci.optimizer.lr_scheduler.Step(**lr_kw)(), weight_decay=0.1)(jm)
    t_opt = TAdamW(TStep(**lr_kw)(), weight_decay=0.1)(tm)
    params, rest = jm.param_tree(), jm.buffer_tree()
    state = j_opt.tx.init(params)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)

    @jax.jit
    def j_step(params, state, cot):
        def loss(p):
            with jm.bind(p, rest):
                return jnp.sum(jm({"a": jnp.asarray(x)})["u"] * cot)

        updates, state = j_opt.tx.update(jax.grad(loss)(params), state, params)
        return optax.apply_updates(params, updates), state

    for step in range(5):
        cot = rng.standard_normal((2, 1, 8, 8)).astype(np.float32)
        params, state = j_step(params, state, cot)
        t_opt.zero_grad()
        (tm({"a": torch.from_numpy(x)})["u"] * torch.from_numpy(cot)).sum().backward()
        lr = t_opt.step(step)
        assert np.isclose(lr, 5e-2 * 0.5 ** (step // 2), rtol=1e-7)
        flat = flatten_tree(jax.tree.map(np.asarray, params))
        for n, p in tm.named_parameters():
            _close(p, flat[n], 1e-4)


def test_l2rel_and_functional_losses_match_jax():
    rng = np.random.default_rng(10)
    out = {"u": rng.standard_normal((4, 3, 5)).astype(np.float32)}
    lab = {"u": rng.standard_normal((4, 3, 5)).astype(np.float32)}
    wgt = {"u": rng.uniform(size=(4,)).astype(np.float32)}
    j_ = lambda d: {k: jnp.asarray(v) for k, v in d.items()}
    t_ = lambda d: {k: torch.from_numpy(v) for k, v in d.items()}
    for red in ("mean", "sum"):
        for w in (None, wgt):
            want = psci.loss.L2RelLoss(red)(j_(out), j_(lab), j_(w) if w else None)["u"]
            got = L2RelLoss(red)(t_(out), t_(lab), t_(w) if w else None)["u"]
            _close(got, np.asarray(want), 1e-6)
    # the Darcy example's H1 loss through FunctionalLoss, and a bare scalar result
    dout = {"output": rng.standard_normal((3, 1, 8, 8)).astype(np.float32)}
    dlab = {"output": rng.standard_normal((3, 1, 8, 8)).astype(np.float32)}
    want = psci.loss.FunctionalLoss(jdarcy.h1_rel_loss)(j_(dout), j_(dlab))["output"]
    got = FunctionalLoss(tdarcy.h1_rel_loss)(t_(dout), t_(dlab))["output"]
    _close(got, np.asarray(want), 1e-6)
    assert set(FunctionalLoss(lambda o, l, w: (o["output"] - l["output"]).abs().sum())(t_(dout), t_(dlab))) == {"loss"}
    _close(tdarcy.l2_rel_metric(t_(dout), t_(dlab))["l2"], np.asarray(jdarcy.l2_rel_metric(j_(dout), j_(dlab))["l2"]),
           1e-6)


def test_darcy_generator_is_bitwise_the_jax_packages():
    for n, res, seed in ((3, 16, 0), (2, 9, 5)):
        (ja, ju), (ta, tu) = j_darcy(n, res, seed=seed), t_darcy(n, res, seed=seed)
        assert ta.dtype == tu.dtype == np.float32 and ta.shape == (n, 1, res, res)
        assert np.array_equal(ta, ja) and np.array_equal(tu, ju)
    a, _ = t_darcy(4, 16, seed=0)
    got, _ = tdarcy.make_data(4, 16)
    assert np.array_equal(got, jdarcy._with_grid((a - a.mean()) / a.std()))


def test_darcy_tfno_three_train_steps_match_jax(tmp_path):
    """The example at n_train = 48, n_eval = 16 (16 x 16, batches of 16,
    shuffle off in both): three train steps against the JAX solver's
    jitted step, then the eval."""
    js = jdarcy.build_solver(epochs=2, n_train=48, n_eval=16, output_dir=str(tmp_path / "jax"))
    loader = js.constraint["Sup"].data_loader
    loader.shuffle = False
    js.constraint["Sup"].data_iter = iter(loader)
    ts = tdarcy.build_solver(epochs=2, n_train=48, n_eval=16, output_dir=str(tmp_path / "port"), shuffle=False,
                             device="cpu")
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]))
    assert ts.iters_per_epoch == js.iters_per_epoch == 3
    j_logs, step_fn = [], js._build_train_step()
    for _ in range(3):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        js.state, logs = step_fn(js.state, host)
        j_logs.append([float(logs[k]) for k in ("loss", "lr")])
    t_logs = [[float(v) for k, v in ts.train_step().items() if k in ("loss", "lr")] for _ in range(3)]
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4)
    # AdamW moves a parameter whose gradient is near 0 by up to lr whichever sign its last bits give it:
    # parameters within 0.1 lr (and 1e-4 relative), the share of them off by more than 1e-4 relative < 0.5%
    j_params = flatten_tree(jax.tree.map(np.asarray, js.state["params"]))
    off = total = 0
    for n, p in ts.model.named_parameters():
        got, want = p.detach().numpy(), j_params[n]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.1 * 5e-3, err_msg=n)
        off += int((np.abs(got - want) > 1e-4 * np.abs(want).max()).sum())
        total += want.size
    assert off < 0.005 * total, (off, total)
    j_metric, j_group = js.eval()
    t_metric, t_group = ts.eval()
    assert list(t_group) == ["u_val"] and set(t_group["u_val"]) == {"l2.l2"} == set(j_group["u_val"])
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-4)


def test_darcy_uno_three_train_steps_match_jax(tmp_path):
    """``arch="uno"`` (hidden 32, stages (32, 64, 64, 32), scalings 1, 0.5,
    2, 1: one antialiased down-scaling and one up-scaling) at n_train =
    32, n_eval = 16, shuffle off in both: three train steps against the
    JAX solver's jitted step, then the eval."""
    js = jdarcy.build_solver(epochs=2, n_train=32, n_eval=16, arch="uno", output_dir=str(tmp_path / "jax"))
    loader = js.constraint["Sup"].data_loader
    loader.shuffle = False
    js.constraint["Sup"].data_iter = iter(loader)
    ts = tdarcy.build_solver(epochs=2, n_train=32, n_eval=16, arch="uno", output_dir=str(tmp_path / "port"),
                             shuffle=False, device="cpu")
    assert type(ts.model).__name__ == "UNONet"
    load_jax_params(ts.model, jax.tree.map(np.asarray, js.state["params"]))
    step_fn = js._build_train_step()
    j_logs = []
    for _ in range(3):
        host = {n: jax.tree.map(jnp.asarray, next(c.data_iter)) for n, c in js.constraint.items()}
        js.state, logs = step_fn(js.state, host)
        j_logs.append([float(logs[k]) for k in ("loss", "lr")])
    t_logs = [[float(v) for k, v in ts.train_step().items() if k in ("loss", "lr")] for _ in range(3)]
    np.testing.assert_allclose(np.array(t_logs), np.array(j_logs), rtol=1e-4)
    j_metric, _ = js.eval()
    t_metric, _ = ts.eval()
    np.testing.assert_allclose(t_metric, float(j_metric), rtol=1e-4)
