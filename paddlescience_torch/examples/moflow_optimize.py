"""MoFlow property optimisation on the port (counterpart of
``examples/moflow_optimize.py``).

Three stages, as in the JAX example:

1. fit the flow on ``MOlFLOWDataset``'s molecules by maximum likelihood
   (``moflow_qm9.MoFlowFit``);
2. encode the molecules and fit ``MoFlowProp``'s regressor head (tanh
   hidden layer of 64) on (latent, property) pairs with Adam 1e-2, the
   flow frozen; the property is :func:`graph_property`, a differentiable
   stand-in for a drug-likeness score (atom-type diversity and bond
   density);
3. from the first ``n_opt`` molecules' latents, ``opt_steps`` steps of
   gradient ascent on the head's score (minus ``sim_weight`` times the
   squared distance to the start), then decode: the mean gain of the
   property of the decoded molecules.

Run on the GPU: ``python -m paddlescience_torch.examples.moflow_optimize``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from paddlescience_torch.arch.moflow_net import MoFlowNet, MoFlowProp
from paddlescience_torch.device import DeviceLike
from paddlescience_torch.examples.hand_loop import HandLoop
from paddlescience_torch.examples.moflow_qm9 import MoFlowFit
from paddlescience_torch.optimizer.optimizer import Adam

__all__ = ["graph_property", "PropertyFit", "ascend", "run"]


def graph_property(nodes: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """(B, 1): 1 - the squared distance of the atom-type fractions from
    uniform, plus 4 d (1 - d) for the bond density d (every channel but
    the first)."""
    type_frac = torch.mean(nodes, dim=1)
    diversity = 1.0 - torch.sum((type_frac - 1.0 / nodes.shape[-1]) ** 2, dim=-1)
    density = torch.mean(edges[:, 1:], dim=(1, 2, 3))
    return (diversity + 4.0 * density * (1.0 - density)).reshape(-1, 1)


class PropertyFit(HandLoop):
    """Stage 2: the head of ``prop`` fitted on (``z``, ``y``) by MSE with
    Adam, the flow untouched."""

    def __init__(self, prop: MoFlowProp, z: torch.Tensor, y: torch.Tensor, lr: float = 1e-2):
        self.prop, self.z, self.y = prop, z, y
        head = list(prop.hidden) + [prop.out]
        self.modules, self.optimizers = head, [Adam(lr)(*head)]
        self._start_loop(z.device)

    def loss(self) -> torch.Tensor:
        return torch.mean((self.prop.head(self.z) - self.y) ** 2)


def ascend(prop: MoFlowProp, z0: torch.Tensor, steps: int, lr: float, sim_weight: float = 0.0) -> torch.Tensor:
    """``steps`` steps z <- z + lr grad(sum(head(z)) - sim_weight |z -
    z0|^2) from ``z0``."""
    z = z0.detach()
    for _ in range(steps):
        zz = z.requires_grad_(True)
        score = prop.head(zz).sum() - sim_weight * torch.sum((zz - z0) ** 2)
        (g,) = torch.autograd.grad(score, zz)
        z = (zz + lr * g).detach()
    return z


def run(train_steps: int = 60, fit_steps: int = 200, opt_steps: int = 40, opt_lr: float = 0.5,
        sim_weight: float = 0.0, n_opt: int = 4, *, device: DeviceLike = None, fit: Optional[MoFlowFit] = None,
        prop: Optional[MoFlowProp] = None) -> Dict[str, float]:
    """The JAX ``run`` (``fit`` and ``prop``, when given, are stage 1's
    and stage 2's models to start from). Returns the stages' last losses,
    the property before and after, and ``"metric"``, the negated mean gain
    (the JAX run's return value)."""
    fit = fit if fit is not None else MoFlowFit(device=device)
    flow: MoFlowNet = fit.model
    nll = fit.train_steps(train_steps)["loss"] if train_steps else float("nan")
    print(f"flow NLL after {train_steps} steps: {nll:.3f}")
    for p in flow.parameters():
        p.requires_grad_(False)
    prop = prop if prop is not None else MoFlowProp(flow, hidden_size=(64,))
    with torch.no_grad():
        y = graph_property(fit.nodes, fit.edges)
        z_data = flow({"nodes": fit.nodes, "edges": fit.edges})["output"]
    head = PropertyFit(prop, z_data, y)
    mse = head.train_steps(fit_steps)["loss"] if fit_steps else float("nan")
    print(f"property head MSE after {fit_steps} steps: {mse:.4f}")
    seed_z = z_data[:n_opt]
    z_opt = ascend(prop, seed_z, opt_steps, opt_lr, sim_weight)
    with torch.no_grad():
        before = graph_property(*flow.reverse(seed_z))
        nodes_opt, edges_opt = flow.reverse(z_opt)
        after = graph_property(nodes_opt, edges_opt)
    imp = float(torch.mean(after - before))
    print(f"property before={float(torch.mean(before)):.4f} after={float(torch.mean(after)):.4f} "
          f"(mean improvement {imp:+.4f})")
    print("optimized molecules:", tuple(nodes_opt.shape), tuple(edges_opt.shape))
    return {"nll": nll, "mse": mse, "before": float(torch.mean(before)), "after": float(torch.mean(after)),
            "metric": -imp}


if __name__ == "__main__":
    run()
