"""The port's optimizers and learning-rate schedules against the JAX
package's (optax) on the CPU.

Every optimizer and option (the three gradient clips, the coupled weight
decay, amsgrad, Nesterov momentum, RMSProp's eps) takes 5 steps from the
same parameters on the same numpy-seeded gradients: parameters within
1e-5 relative of optax's. Where torch's own rule differs from optax's
(RMSProp's eps, amsgrad's maximum, the per-array RMS clip), the test also
shows that ``torch.optim``'s rule would miss. Every schedule, in both
forms (a Python int step and a float32 tensor clock), at every step
across its boundaries: within 1e-6 of the JAX schedule at an int32 step
(the float64 int form within 1e-6 of the schedule's peak).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import paddlescience_tpu as psci
from paddlescience_torch import optimizer as topt
from paddlescience_torch.optimizer import lr_scheduler as tls

SHAPES = {"w": (4, 3), "b": (3,)}
STEPS = 5


def _grads(seed=0, shrink=False):
    """Per step, numpy-seeded gradients (``shrink``: each step's a tenth
    of the one before, so that a running maximum of nu_hat matters)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(STEPS):
        scale = 10.0 ** (-i) if shrink else 1.0
        out.append({k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()})
    return out


def _params(seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def _run_jax(factory, grads):
    params = {k: jnp.asarray(v) for k, v in _params().items()}
    tx = factory(None).tx
    state = tx.init(params)
    update = jax.jit(tx.update)
    for g in grads:
        updates, state = update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v) for k, v in params.items()}


class _Holder(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for k, v in _params().items():
            self.register_parameter(k, torch.nn.Parameter(torch.from_numpy(v.copy())))


def _run_port(factory, grads):
    m = _Holder()
    opt = factory(m)
    for i, g in enumerate(grads):
        for k, p in m.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(i)
    return {k: p.detach().numpy() for k, p in m.named_parameters()}


def _run_torch_optim(make, grads):
    m = _Holder()
    opt = make(m.parameters())
    for g in grads:
        for k, p in m.named_parameters():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    return {k: p.detach().numpy() for k, p in m.named_parameters()}


def _close(got, ref, rtol=1e-5):
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=rtol * np.abs(ref[k]).max(), err_msg=k)


def _far(got, ref, rtol=1e-3):
    return any(not np.allclose(got[k], ref[k], rtol=rtol, atol=rtol * np.abs(ref[k]).max()) for k in ref)


SCHED = lambda ls: ls.Piecewise(2, [1, 2], [0.1, 0.05, 0.02], epochs=3)
CASES = {
    "sgd": ("SGD", dict(learning_rate=0.1)),
    "sgd_wd_value_clip": ("SGD", dict(learning_rate=0.1, weight_decay=0.05,
                                       grad_clip={"name": "value", "clip_value": 0.5})),
    "momentum": ("Momentum", dict(learning_rate=0.05, momentum=0.8)),
    "momentum_nesterov_schedule": ("Momentum", dict(momentum=0.9, use_nesterov=True, weight_decay=0.01)),
    "adam": ("Adam", dict(learning_rate=0.01)),
    "adam_options": ("Adam", dict(learning_rate=0.01, beta1=0.8, beta2=0.95, epsilon=1e-3, weight_decay=0.1,
                                  grad_clip={"name": "global_norm", "clip_norm": 1.0})),
    "adam_amsgrad": ("Adam", dict(learning_rate=0.01, amsgrad=True, grad_clip={"name": "norm", "clip_norm": 0.5})),
    "adamw_clip": ("AdamW", dict(learning_rate=0.01, weight_decay=0.1,
                                 grad_clip={"name": "ClipGradByNorm", "clip_norm": 0.3})),
    "rmsprop": ("RMSProp", dict(learning_rate=0.01, rho=0.9, epsilon=0.1)),
    "rmsprop_momentum_clip": ("RMSProp", dict(learning_rate=0.01, momentum=0.5, weight_decay=0.02,
                                              grad_clip={"name": "ClipGradByGlobalNorm", "clip_norm": 2.0})),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax_over_five_steps(case):
    name, kw = CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if "learning_rate" not in kw:  # a schedule: the same on both sides
        jkw["learning_rate"], tkw["learning_rate"] = SCHED(psci.optimizer.lr_scheduler)(), SCHED(tls)()
    grads = _grads(shrink=case == "adam_amsgrad")
    ref = _run_jax(getattr(psci.optimizer, name)(**jkw), grads)
    got = _run_port(getattr(topt, name)(**tkw), grads)
    _close(got, ref)


def test_torch_rules_would_miss_optax():
    """RMSProp's eps inside the root, amsgrad's maximum of nu_hat and the
    per-array RMS clip: the port follows optax where torch.optim's rules
    (and ``clip_grad_norm_`` per array) give other parameters."""
    grads = _grads()
    kw = dict(learning_rate=0.01, rho=0.9, epsilon=0.1)
    ref = _run_jax(psci.optimizer.RMSProp(**kw), grads)
    _close(_run_port(topt.RMSProp(**kw), grads), ref)
    assert _far(_run_torch_optim(lambda ps: torch.optim.RMSprop(ps, lr=0.01, alpha=0.9, eps=0.1), grads), ref)

    grads = _grads(shrink=True)
    ref = _run_jax(psci.optimizer.Adam(learning_rate=0.01, amsgrad=True), grads)
    _close(_run_port(topt.Adam(learning_rate=0.01, amsgrad=True), grads), ref)
    assert _far(_run_torch_optim(lambda ps: torch.optim.Adam(ps, lr=0.01, amsgrad=True), grads), ref)

    grads = _grads()
    clip = {"name": "norm", "clip_norm": 0.3}
    ref = _run_jax(psci.optimizer.SGD(learning_rate=1.0, grad_clip=clip), grads[:1])
    _close(_run_port(topt.SGD(learning_rate=1.0, grad_clip=clip), grads[:1]), ref)

    def torch_clip(ps):
        ps = list(ps)
        sgd = torch.optim.SGD(ps, lr=1.0)

        class Clipped:
            def step(self):
                for p in ps:
                    torch.nn.utils.clip_grad_norm_([p], 0.3)
                sgd.step()

        return Clipped()

    assert _far(_run_torch_optim(torch_clip, grads[:1]), ref)


def test_optimizer_list_steps_each_group_with_its_rule():
    grads = _grads()
    a, b = _Holder(), _Holder()
    opt = topt.OptimizerList([topt.SGD(0.1)(a), topt.Adam(0.01)(b)])
    for i, g in enumerate(grads):
        for m in (a, b):
            for k, p in m.named_parameters():
                p.grad = torch.from_numpy(g[k].copy())
        opt.step(i)
    _close({k: p.detach().numpy() for k, p in a.named_parameters()}, _run_jax(psci.optimizer.SGD(0.1), grads))
    _close({k: p.detach().numpy() for k, p in b.named_parameters()}, _run_jax(psci.optimizer.Adam(0.01), grads))
    assert sorted(opt.state_tensors()) == ["0.0", "0.1", "1.0", "1.1"] and opt.lr_fn(0) == 0.1


def _sched_cases():
    E, I = 6, 4
    return {
        "linear": ("Linear", dict(epochs=E, iters_per_epoch=I, learning_rate=1e-2, end_lr=1e-4, power=2.0)),
        "linear_warmup_by_epoch": ("Linear", dict(epochs=E, iters_per_epoch=I, learning_rate=1e-2, warmup_epoch=2,
                                                  by_epoch=True)),
        "piecewise": ("Piecewise", dict(iters_per_epoch=I, decay_epochs=[1, 3, 4], values=[1e-3, 5e-4, 1e-4, 1e-5],
                                        epochs=E)),
        "piecewise_warmup": ("Piecewise", dict(iters_per_epoch=I, decay_epochs=[2, 4], values=[1e-3, 1e-4, 1e-5],
                                               warmup_epoch=1, warmup_start_lr=1e-5, epochs=E)),
        "multistep": ("MultiStepDecay", dict(epochs=E, iters_per_epoch=I, learning_rate=1e-2, milestones=[2, 3, 5],
                                             gamma=0.5)),
        "multistep_by_epoch": ("MultiStepDecay", dict(epochs=E, iters_per_epoch=I, learning_rate=1e-2,
                                                      milestones=[1, 4], by_epoch=True)),
        "warm_restarts": ("CosineWarmRestarts", dict(epochs=E, iters_per_epoch=I, learning_rate=1e-2, T_0=2,
                                                     eta_min=1e-4)),
        "warm_restarts_mult": ("CosineWarmRestarts", dict(epochs=E, iters_per_epoch=I, learning_rate=1e-2, T_0=1,
                                                          T_mult=2)),
        "one_cycle_cos": ("OneCycleLR", dict(epochs=E, iters_per_epoch=I, max_learning_rate=1e-2)),
        "one_cycle_linear": ("OneCycleLR", dict(epochs=E, iters_per_epoch=I, max_learning_rate=1e-2,
                                                anneal_strategy="linear", phase_pct=0.4, divide_factor=10.0)),
        "lambda": ("LambdaDecay", dict(epochs=E, iters_per_epoch=I, learning_rate=1e-2,
                                       lr_lambda=lambda t: 0.9**t)),
        "lambda_by_epoch_warmup": ("LambdaDecay", dict(epochs=E, iters_per_epoch=I, learning_rate=1e-2,
                                                       lr_lambda=lambda t: 1.0 / (1.0 + t), warmup_epoch=1,
                                                       by_epoch=True)),
    }


@pytest.mark.parametrize("case", list(_sched_cases()))
def test_schedule_both_forms_match_jax_at_every_step(case):
    name, kw = _sched_cases()[case]
    jf = getattr(psci.optimizer.lr_scheduler, name)(**kw)()
    tf = getattr(tls, name)(**kw)()
    steps = range(6 * 4 + 3)
    refs = [float(jf(jnp.asarray(step, jnp.int32))) for step in steps]
    peak = max(abs(r) for r in refs)
    for step, ref in zip(steps, refs):
        got_t = tf(torch.tensor(float(step)))
        assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.float32, case
        np.testing.assert_allclose(float(got_t), ref, rtol=1e-6, err_msg=f"{case} tensor form at step {step}")
        # the int form computes in float64: JAX's float32 rounding is absolute at the schedule's scale
        np.testing.assert_allclose(float(tf(step)), ref, rtol=1e-6, atol=1e-6 * peak,
                                   err_msg=f"{case} int form at step {step}")
    assert math.isfinite(float(tf(0)))


def test_scheduler_list_and_builders():
    lst = tls.SchedulerList([tls.Constant(0.1)(), tls.Constant(0.2)()])
    assert len(lst) == 2 and lst[1](3) == 0.2
    f = topt.build_lr_scheduler({"name": "Piecewise", "decay_epochs": [1], "values": [1.0, 0.5]}, 2, 3)
    assert f(2) == 1.0 and f(3) == 0.5
    opt = topt.build_optimizer({"name": "Momentum", "momentum": 0.5,
                                "lr_scheduler": {"name": "Constant", "learning_rate": 0.1}}, _Holder(), 2, 3)
    assert opt.name == "Momentum" and opt.lr_fn(0) == 0.1
