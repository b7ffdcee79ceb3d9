"""MoFlow molecular generation on the port (counterpart of
``examples/moflow_qm9.py``).

Trains the flow over (atom one-hot, bond tensor) pairs of
``MOlFLOWDataset``'s 64 synthetic molecules (up to 9 atoms of 5 types, 4
bond types) by maximum likelihood: the loss is mean(|z|^2 / 2 - log-det),
Adam 5e-4 (optax's rule), all 64 molecules a step. Then generates 4
molecules from latents 0.5 N(0, 1) (an explicit generator, or the draw
given) and checks the round trip of two training molecules through the
flow and back within 1e-4. ``MoFlowNet`` at the example's configuration
(hidden 64, 2 bond and 2 atom blocks) unless given other widths. A hand
loop of one step an update (``examples/hand_loop.py``).

Run on the GPU: ``python -m paddlescience_torch.examples.moflow_qm9 [steps]``.
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from paddlescience_torch.arch.moflow_net import MoFlowNet
from paddlescience_torch.data.dataset.domain_dataset import MOlFLOWDataset
from paddlescience_torch.device import DeviceLike, resolve_device
from paddlescience_torch.examples.hand_loop import HandLoop, run_and_check
from paddlescience_torch.optimizer.optimizer import Adam

__all__ = ["MoFlowFit", "EXAMPLE", "generate", "roundtrip_error", "main"]

SEED = 0  # the JAX example's set_random_seed and PRNGKey
EXAMPLE = dict(b_n_type=4, a_n_node=9, a_n_type=5, b_hidden=64, a_hidden=64, b_n_blocks=2, a_n_blocks=2)


class MoFlowFit(HandLoop):
    """The molecules on the device, the flow, its Adam and the step loop
    on the negative log-likelihood; ``model`` replaces entries of
    :data:`EXAMPLE`."""

    def __init__(self, lr: float = 5e-4, num_samples: int = 64, *, device: DeviceLike = None, **model):
        self.device = device = resolve_device(device)
        ds = MOlFLOWDataset(num_samples=num_samples, max_atoms=9, n_types=5)
        self.nodes = torch.from_numpy(ds.input["nodes"]).to(device)
        self.edges = torch.from_numpy(ds.input["edges"]).to(device)
        self.model = MoFlowNet(**{**EXAMPLE, **model}, generator=torch.Generator().manual_seed(SEED), device=device)
        self.modules, self.optimizers = [self.model], [Adam(lr)(self.model)]
        self._start_loop(device)

    def latents(self, nodes: torch.Tensor, edges: torch.Tensor):
        out = self.model({"nodes": nodes, "edges": edges})
        return out["output"], out["sum_log_det"]

    def loss(self) -> torch.Tensor:
        z, logdet = self.latents(self.nodes, self.edges)
        return torch.mean(0.5 * torch.sum(z ** 2, dim=-1) - logdet)


@torch.no_grad()
def generate(model: MoFlowNet, z: torch.Tensor):
    """Molecules (nodes, edges) decoded from the latents 0.5 z."""
    return model.reverse(0.5 * z)


@torch.no_grad()
def roundtrip_error(fit: MoFlowFit, n: int = 2) -> float:
    """The largest |nodes - reverse(forward(nodes))| over the first ``n``
    molecules."""
    z, _ = fit.latents(fit.nodes[:n], fit.edges[:n])
    nodes, _ = fit.model.reverse(z)
    return float(torch.abs(nodes - fit.nodes[:n]).max())


def main(steps: int = 80, *, device: DeviceLike = None, fit: Optional[MoFlowFit] = None,
         z: Optional[torch.Tensor] = None) -> float:
    """The JAX ``main``: ``steps`` NLL steps (of ``fit``, when given), 4
    molecules from ``z`` (a (4, latent) standard normal draw; drawn from
    a generator seeded with :data:`SEED` when None) and the round trip;
    raises if the NLL did not fall or the round trip is off by 1e-4 or
    more. Returns the last NLL."""
    fit = fit if fit is not None else MoFlowFit(device=device)
    last = run_and_check(fit, steps, "MoFlow NLL", ".3f")
    if z is None:
        z = torch.randn((4, fit.model.latent_dim), generator=torch.Generator().manual_seed(SEED))
    gen_nodes, gen_edges = generate(fit.model, z.to(fit.device))
    print("generated molecules:", tuple(gen_nodes.shape), tuple(gen_edges.shape))
    err = roundtrip_error(fit)
    print(f"roundtrip max err: {err:.2e}")
    if not err < 1e-4:
        raise AssertionError(f"the flow's round trip is off by {err}")
    return last


if __name__ == "__main__":
    argv = sys.argv[1:]
    main(int(argv[0]) if argv else 80)
