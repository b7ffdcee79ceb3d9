"""The PINN toolkit's optimizers, aggregators and weight averages captured in a
CUDA graph on the card, without JAX (tests marked ``cuda``, skipped
without a card).

Each runs on a small two-constraint problem (a fit and a first
derivative, one static batch): two chunks of K = 4 steps, each one replay
of the solver's captured graph, against 8 eager steps from the same
state: parameters, the aggregator's state and the averaged parameters
within 1e-6 relative.

Run where JAX is not installed:
``python -m pytest --noconftest -m cuda tests/test_torch_toolkit_gpu.py``.
"""

import numpy as np
import pytest
import torch

from paddlescience_torch import optimizer as topt
from paddlescience_torch.arch import MLP
from paddlescience_torch.autodiff import jacobian
from paddlescience_torch.autodiff import path as tpath
from paddlescience_torch.constraint import SupervisedConstraint
from paddlescience_torch.loss import MSELoss, mtl
from paddlescience_torch.optimizer import lr_scheduler
from paddlescience_torch.solver import Solver
from paddlescience_torch.utils import ema

K = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the captured graphs run on the card")
    saved = tpath.get_default()
    tpath.set_default(tpath.CANDIDATES["jet"])
    yield torch.device("cuda")
    tpath.set_default(saved)


def _solver(make_opt, aggregator=None, ema_avg=None):
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(-1, 1, (256, 1)).astype(np.float32) for _ in range(2))
    cfg = lambda lab: {"dataset": {"name": "IterableNamedArrayDataset", "input": {"x": x, "y": y}, "label": lab}}
    model = MLP(("x", "y"), ("u",), 2, 32, generator=torch.Generator().manual_seed(0), device="cuda")
    cst = {"A": SupervisedConstraint(cfg({"u": np.sin(3 * x) + y}), MSELoss(), {"u": lambda o: o["u"]}, name="A"),
           "B": SupervisedConstraint(cfg({"du": np.cos(3 * x)}), MSELoss(),
                                     {"du": lambda o: jacobian(o["u"], o["x"])}, name="B")}
    return Solver(model, cst, None, make_opt(model), epochs=1, iters_per_epoch=2 * K, loss_aggregator=aggregator,
                  ema_avg=ema_avg, device="cuda")


SCHED = lambda: lr_scheduler.OneCycleLR(epochs=1, iters_per_epoch=2 * K, max_learning_rate=1e-2)()
CASES = {
    "sgd_value_clip": dict(make_opt=lambda m: topt.SGD(0.05, weight_decay=0.01,
                                                       grad_clip={"name": "value", "clip_value": 0.5})(m)),
    "momentum_nesterov": dict(make_opt=lambda m: topt.Momentum(SCHED(), use_nesterov=True)(m)),
    "adam_amsgrad_norm_clip": dict(make_opt=lambda m: topt.Adam(
        lr_scheduler.Piecewise(2, [1, 2], [1e-2, 5e-3, 1e-3], epochs=4)(), amsgrad=True,
        grad_clip={"name": "norm", "clip_norm": 0.5})(m)),
    "adamw_global_clip": dict(make_opt=lambda m: topt.AdamW(1e-2, grad_clip={"name": "global_norm",
                                                                             "clip_norm": 0.1})(m)),
    "rmsprop_momentum": dict(make_opt=lambda m: topt.RMSProp(1e-3, momentum=0.5)(m)),
    "optimizer_list": dict(make_opt=lambda m: topt.OptimizerList([topt.SGD(
        lr_scheduler.LambdaDecay(1, 2 * K, 0.05, lambda t: 0.9**t)())(m)])),
    "relobralo": dict(make_opt=lambda m: topt.Adam(1e-2)(m), aggregator=mtl.Relobralo(None, 2, beta=0.5)),
    "pcgrad": dict(make_opt=lambda m: topt.Adam(1e-2)(m), aggregator=mtl.PCGrad(None, 2)),
    "agda": dict(make_opt=lambda m: topt.Adam(1e-2)(m), aggregator=mtl.AGDA(None, 2)),
    "ema": dict(make_opt=lambda m: topt.Adam(1e-2)(m), ema_avg=ema.ExponentialMovingAverage(decay=0.8, avg_freq=2)),
    "swa": dict(make_opt=lambda m: topt.Adam(1e-2)(m), ema_avg=ema.StochasticWeightAverage(avg_range=(2, 6))),
}


def _flat(solver):
    parts = [p.detach().reshape(-1) for p in solver.model.parameters()]
    parts += [v.reshape(-1) for v in solver.agg_state.values()] + [v.reshape(-1) for v in solver.avg_params.values()]
    return torch.cat(parts).clone()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_chunks_equal_eager_steps(cuda_device, case):
    solver = _solver(**CASES[case])
    snap = solver.state
    for _ in range(2):
        solver.train_chunk(K)
    torch.cuda.synchronize()
    assert solver.graph_stats[K]["replays"] == 2
    graphed = _flat(solver)
    solver._load_state(snap)
    solver.train_steps(2 * K)
    torch.cuda.synchronize()
    eager = _flat(solver)
    assert torch.isfinite(graphed).all()
    assert float((graphed - eager).norm() / eager.norm()) <= 1e-6
    assert not torch.equal(graphed, _flat_of_state(snap, solver))


def _flat_of_state(snap, solver):
    parts = [snap["params"][n].reshape(-1) for n, _ in solver.model.named_parameters()]
    parts += [snap["agg_state"][k].reshape(-1) for k in solver.agg_state]
    parts += [snap["avg_params"][n].reshape(-1) for n in solver.avg_params] if solver.avg_params else []
    return torch.cat(parts)
